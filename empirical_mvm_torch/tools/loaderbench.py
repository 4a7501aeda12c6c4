"""Input-pipeline bench and the on-disk layouts it reads (counterpart of
``tools/loaderbench.py``; ref data plane: dataset.py:136-195,
utils/tsv_file.py, main_pretrain.py:44-65).

:func:`build_pretrain` and :func:`build_downstream` write the reference's
layouts from the committed JPEG fixture (``tools/jpeg_fixture.py``), so
that a machine without a JPEG encoder can make them:

* pretrain: ``webvid2.5m_train_{part}.tsv`` (rows ``vid \\t 4 frames``),
  ``cc3m_train_0.tsv`` (1-frame rows) and ``txt_{ds}.json``;
* downstream: ``img_{ds}.tsv`` (rows ``vid \\t {} \\t 5 frames``) with
  ``img_{ds}.id2lineidx.pkl``, and the ``txt_{task}.json`` of
  msrvtt-retrieval, msrvtt-qa, tgif-action and msrvtt-caption, as
  ``tests/synth_data.py`` lays them out.

In each pretrain TSV, one row in every ``CORRUPT_EVERY`` has no frames and
the next one's vid is missing from ``txt``; each img TSV has one row with
no frames, and each task's ``txt`` one item whose video the img TSV lacks:
the ``corrupt`` paths run.

:func:`pretrain_meta_loader` wires a ``MetaLoader`` over the pretrain
layout as the JAX ``cli/pretrain.py:32-90`` wires it (one dataset and
loader per shard, weight 1 each). ``main`` times the loader alone, in
clips/s, through ``DevicePrefetcher`` on the card (nvJPEG), or with
``--device cpu`` and cv2 where cv2 is installed:

    python -m empirical_mvm_torch.tools.loaderbench [--batches 30] [--reader both]
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np
import torch

from empirical_mvm_torch.core.config import RunConfig, load_run_config
from empirical_mvm_torch.data import datasets as D
from empirical_mvm_torch.data.loader import DevicePrefetcher, MetaLoader, ShardedBatchLoader
from empirical_mvm_torch.data.tokenizer import load_tokenizer
from empirical_mvm_torch.tools.jpeg_fixture import load_fixture

WORDS = ("the", "a", "man", "woman", "dog", "cat", "runs", "sits", "on", "red", "blue",
         "green", "car", "street", "park", "ball", "plays", "with", "in", "water")
ANSWERS = ("dog", "cat", "car", "ball")
CORRUPT_EVERY = 24
WARM_BATCHES = 8          # batches a timing may draw before its first timed one


def _fields(frames: list[bytes], rs: np.random.RandomState, n: int) -> list[str]:
    return [base64.b64encode(frames[i]).decode() for i in rs.randint(0, len(frames), n)]


def _sentence(rs: np.random.RandomState, n: int) -> str:
    return " ".join(WORDS[i] for i in rs.randint(0, len(WORDS), n))


def build_pretrain(data_dir: str, *, videos_per_part: int = 48, parts: int = 2,
                   images: int = 48, seed: int = 0) -> None:
    """The pretrain layout of webvid2.5m (``parts`` shards) and cc3m."""
    os.makedirs(data_dir, exist_ok=True)
    frames = load_fixture()["frames"]
    rs = np.random.RandomState(seed)
    for ds, n_parts, rows, n_frames in (("webvid2.5m", parts, videos_per_part, 4),
                                        ("cc3m", 1, images, 1)):
        txt = {}
        for part in range(n_parts):
            with open(os.path.join(data_dir, f"{ds}_train_{part}.tsv"), "w") as f:
                for i in range(rows):
                    vid = f"{ds}_{part}_{i}"
                    if i % CORRUPT_EVERY == 1:  # a row with no frames
                        f.write(vid + "\n")
                    else:
                        f.write("\t".join([vid] + _fields(frames, rs, n_frames)) + "\n")
                    if i % CORRUPT_EVERY != 2:  # a vid that txt lacks
                        txt[vid] = [_sentence(rs, rs.randint(5, 30))]
        with open(os.path.join(data_dir, f"txt_{ds}.json"), "w") as f:
            json.dump({"train": txt, "val": {}}, f)


def build_downstream(data_dir: str, *, videos: int = 24, frames_per_video: int = 5,
                     options: int = 5, test: int = 0, seed: int = 0) -> None:
    """img_msrvtt / img_tgif and the txt of msrvtt-retrieval, msrvtt-qa,
    tgif-action and msrvtt-caption (tests/synth_data.py's schema: retrieval
    and caption captions, qaoe answers with answer_text and ans2label, qamc
    options); train and val splits, and a test split of ``test`` items
    where it is not 0."""
    os.makedirs(data_dir, exist_ok=True)
    frames = load_fixture()["frames"]
    rs = np.random.RandomState(seed)
    for ds in ("msrvtt", "tgif"):
        id2lineidx = {}
        with open(os.path.join(data_dir, f"img_{ds}.tsv"), "w") as f:
            for v in range(videos):
                vid = f"video{v}"
                id2lineidx[vid] = f.tell()
                row = [vid, "{}"] + ([] if v == 1 else _fields(frames, rs, frames_per_video))
                f.write("\t".join(row) + "\n")
        with open(os.path.join(data_dir, f"img_{ds}.id2lineidx.pkl"), "wb") as f:
            pickle.dump(id2lineidx, f)
    for task, kind in (("msrvtt-retrieval", "retrieval"), ("msrvtt-qa", "qaoe"),
                       ("tgif-action", "qamc"), ("msrvtt-caption", "caption")):
        txt: dict = {}
        splits = (("train", videos), ("val", videos // 2)) + ((("test", test),) if test else ())
        for split, n in splits:
            items = []
            for i in range(n + 1):
                video = f"video{i % videos}" if i < n else "missing_video"
                if kind in ("retrieval", "caption"):
                    items.append({"video": video, "caption": _sentence(rs, rs.randint(4, 40))})
                elif kind == "qaoe":
                    a = int(rs.randint(len(ANSWERS)))
                    items.append({"video": video,
                                  "question": "what " + _sentence(rs, rs.randint(3, 40)),
                                  "answer": a, "answer_text": ANSWERS[a]})
                else:
                    a = int(rs.randint(options))
                    item = {"video": video, "answer": a,
                            "question": "what does the " + _sentence(rs, rs.randint(2, 20))}
                    for o in range(options):
                        item[f"option_{o}"] = _sentence(rs, rs.randint(2, 12))
                    items.append(item)
            txt[split] = items
        if kind == "qaoe":
            txt["ans2label"] = {w: i for i, w in enumerate(ANSWERS)}
        with open(os.path.join(data_dir, f"txt_{task}.json"), "w") as f:
            json.dump(txt, f)


def pretrain_meta_loader(run: RunConfig, tokzr, *, reader: str = "native",
                         threads: int | None = None) -> MetaLoader:
    """``MetaLoader`` over ``run.data.dataset``'s shards under
    ``run.data.data_dir``, wired as the JAX ``cli/pretrain.py:32-90`` wires
    it on one host (raw TSV shards; one dataset and loader per shard,
    weight 1)."""
    tc, data = run.train, run.data
    loaders = {}
    for ds_name in data.dataset:
        with open(os.path.join(data.data_dir, f"txt_{ds_name}.json")) as f:
            txt = json.load(f)
        parts = [p for p in (os.path.join(data.data_dir, f"{ds_name}_train_{i}.tsv")
                             for i in range(data.size_part)) if os.path.exists(p)]
        if not parts:
            raise FileNotFoundError(f"no train shards for {ds_name} under {data.data_dir}")
        for i, p in enumerate(parts):
            ds = D.PretrainTsvDataset(run, "train", tokzr, p, txt.get("train", txt),
                                      dataset_name=ds_name, reader=reader)
            loaders[f"{ds_name}/{i}"] = (ShardedBatchLoader(
                ds, tc.size_batch, shuffle=True, seed=tc.seed,
                num_threads=threads or data.n_workers), 1)
    return MetaLoader(loaders, seed=tc.seed, accum_steps=tc.grad_accum)


# the datasets of the three fine-tune steps that chip_smoke feeds (the JAX
# cli/retrieval.py and cli/qa.py modes "qaoe-mlm" and "qamc-gen")
DOWNSTREAM = {"retrieval": D.RetrievalDataset, "qaoe-mlm": D.QAOEMLMDataset,
              "qamc-gen": D.QAMCGenDataset}


def downstream_dataset(run: RunConfig, kind: str, tokzr, split: str = "train",
                       reader: str = "native"):
    """The ``kind`` dataset of ``run`` over ``img_{dataset}.tsv`` and
    ``txt_{task}.json`` under ``run.data.data_dir`` (the JAX
    ``cli/common.py`` ``tsv_sources`` and ``cli/qa.py`` ``build``)."""
    data = run.data
    ds = data.dataset[0]
    img = D.TsvImageSource(os.path.join(data.data_dir, f"img_{ds}.tsv"),
                           os.path.join(data.data_dir, f"img_{ds}.id2lineidx.pkl"),
                           reader=reader)
    txt = D.load_txt_json(os.path.join(data.data_dir, f"txt_{run.task}.json"))
    return DOWNSTREAM[kind](run, split, tokzr, img, txt[split])


def shard_rows(size_batch: int, batches: int) -> int:
    """Rows a shard needs for one loader to deliver ``WARM_BATCHES`` +
    ``batches`` batches within its first epoch, were every batch drawn
    from it."""
    return size_batch * (WARM_BATCHES + batches) + 1


def warm_up(it, loaders, least: int = 1) -> list:
    """Draw ``(tag, batch)`` pairs from ``it`` until ``least`` have come and
    every name in ``loaders`` has delivered once (each loader's producer
    thread and pool started); return the tags drawn."""
    tags, left = [], set(loaders)
    while len(tags) < least or left:
        tag, _ = next(it)
        tags.append(tag)
        left.discard(tag)
    return tags


def loader_clips_per_s(prefetcher: DevicePrefetcher, batches: int, warm: int = 2) -> dict:
    """Clips/s of ``prefetcher`` alone over ``batches`` batches after
    ``warm`` and one of each of its ``MetaLoader``'s loaders (each batch's
    tensors waited for on the device). The shards must hold the timed
    batches within one epoch (``build_pretrain``'s sizes), or a new epoch's
    producer starts cold inside the timing."""
    loaders = getattr(prefetcher.source, "loaders", {})
    it = iter(prefetcher)
    warm_up(it, loaders, warm)
    n, t0 = 0, time.perf_counter()
    for _ in range(batches):
        _, b = next(it)
        if b["img"].is_cuda:
            torch.cuda.current_stream(b["img"].device).synchronize()
        n += b["img"].shape[0]
    dt = time.perf_counter() - t0
    it.close()
    return {"clips": n, "seconds": dt, "clips_per_s": n / dt,
            "epoch_restarts": sum(ld.epoch for ld in loaders.values())}


def with_data(run: RunConfig, **data) -> RunConfig:
    return dataclasses.replace(run, data=dataclasses.replace(run.data, **data))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/pretrain.json")
    ap.add_argument("--batches", type=int, default=30)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--reader", default="both", choices=["both", "native", "python"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    decode = None
    if torch.device(args.device).type == "cpu":
        import cv2

        def decode(b):
            a = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)
            return None if a is None else a[:, :, ::-1]
    elif not torch.cuda.is_available():
        raise SystemExit("loaderbench: no CUDA card; pass --device cpu to decode with cv2")
    tokzr = load_tokenizer()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        run = with_data(load_run_config(args.config), data_dir=tmp)
        rows = shard_rows(run.train.size_batch, args.batches)
        build_pretrain(tmp, videos_per_part=rows, images=rows)
        for reader in (["native", "python"] if args.reader == "both" else [args.reader]):
            meta = pretrain_meta_loader(run, tokzr, reader=reader, threads=args.threads)
            res = loader_clips_per_s(DevicePrefetcher(meta, args.device, decode),
                                     args.batches)
            meta.close()
            out[reader] = res["clips_per_s"]
            print(f"{reader:7s} {res['clips_per_s']:8.1f} clips/s ({args.threads} threads)",
                  file=sys.stderr)
    print(json.dumps({"metric": "loader_clips_per_sec", "unit": "clips/s",
                      "device": args.device, **out}))


if __name__ == "__main__":
    main()
