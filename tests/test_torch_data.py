"""The port's data layer (``empirical_mvm_torch/data``) against the JAX
package's on the CPU: the tokenizer, both TSV readers, the temporal picks,
the transforms, the manifest parser, every task dataset's items over
``tests/synth_data.py``'s layouts, the loaders' schedules, and batches that
do not depend on the loader's thread count.

The port's items carry clip plans; the tests run them through the loader's
device stage on the CPU (``loader.materialize``) with ``cv2.imdecode`` as
the decode function, the JAX package's decoder. Pixels the port resizes
are held within one uint8 step of cv2's fixed-point ``INTER_LINEAR`` (the
port's resize is bilinear in float, rounded); everything else is equal.
The JAX package draws three of its sites from the dataset's shared
``self.rng``; the tests set that instance's ``rng`` to ``item_rng(idx)``
before each such call (the port draws from ``item_rng(idx)`` itself).
"""

import base64
import dataclasses
import json
import os
import pickle
import random
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.data import composite as jcomp
from empirical_mvm_tpu.data import datasets as jds
from empirical_mvm_tpu.data import loader as jld
from empirical_mvm_tpu.data import tokenizer as jtok
from empirical_mvm_tpu.data import transforms as jtr
from empirical_mvm_tpu.data import tsv as jtsv
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.data import composite as tcomp
from empirical_mvm_torch.data import datasets as tds
from empirical_mvm_torch.data import jpeg as tjpeg
from empirical_mvm_torch.data import loader as tld
from empirical_mvm_torch.data import native_tsv as tnative
from empirical_mvm_torch.data import tokenizer as ttok
from empirical_mvm_torch.data import transforms as ttr
from empirical_mvm_torch.data import tsv as ttsv
from empirical_mvm_torch.ops.preprocess import IMAGENET_STD
from tests import synth_data

# one uint8 step: the port's float bilinear, rounded, against cv2's 11-bit
# fixed-point INTER_LINEAR
STEP = 1
# the same step after ImageNet normalization (the smallest std divides most)
NORM_STEP = 1.0 / 255.0 / min(IMAGENET_STD) + 1e-6


def cv2_decode(data: bytes):
    a = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if a is None else a[:, :, ::-1]


DECODER = tjpeg.HostDecoder(cv2_decode)


def device_stage(items):
    """The port's items through the loader's device stage on the CPU."""
    return tld.materialize(tld._collate(items), DECODER, "cpu")


def assert_pixels_close(got, want, normalized):
    assert got.shape == want.shape
    d = np.abs(got.astype(np.float64) - np.asarray(want, np.float64))
    assert d.max() <= (NORM_STEP if normalized else STEP), d.max()
    share = (d > 0).mean()
    print(f"pixels {got.shape}: {share:.4f} of values differ, largest {d.max():.4g}")
    return share


# ---------------------------------------------------------------------------
# the tokenizer


TEXTS = ["The cat sat on the mat.", "running cats, true false!!", "answer: 3",
         "Café naïve résumé — 東京 über Ünïcödé", "don't stop... (really) [MASK] ok [SEP] x",
         "a" * 120, "", "   \t\n", "mixed123numbers and-hyphens/slashes"]


@pytest.fixture(scope="module")
def tokenizers():
    path = str(ttok.FALLBACK_VOCAB)
    return jtok.WordPieceTokenizer.from_vocab_file(path), ttok.load_tokenizer(path)


def test_bundled_vocab_is_a_byte_identical_copy():
    with open(jtok.FALLBACK_VOCAB, "rb") as a, open(ttok.FALLBACK_VOCAB, "rb") as b:
        assert a.read() == b.read()
    tk = ttok.load_tokenizer()
    assert (tk.vocab_size, tk.pad_token_id, tk.unk_token_id, tk.cls_token_id,
            tk.sep_token_id, tk.mask_token_id) == (30522, 0, 100, 101, 102, 103)


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_matches_jax(tokenizers, text):
    jt, tt = tokenizers
    assert tt.tokenize(text) == jt.tokenize(text)
    assert tt.encode(text) == jt.encode(text)
    for got, want in zip(ttok.str2txt(tt, text, 16), jtok.str2txt(jt, text, 16)):
        np.testing.assert_array_equal(got, want)
    for pos in ("append", "prepend", "insert", "replace"):
        for n in (6, 12, 40):
            for got, want in zip(ttok.str2txt_with_mask_tok(tt, text, n, pos),
                                 jtok.str2txt_with_mask_tok(jt, text, n, pos)):
                np.testing.assert_array_equal(got, want, err_msg=f"{pos} {n}")
    assert ttok.concat_txt(tt, text, "b") == jtok.concat_txt(jt, text, "b")
    with pytest.raises(ValueError):
        ttok.str2txt_with_mask_tok(tt, text, 8, "middle")


# ---------------------------------------------------------------------------
# TSV readers


def test_tsv_readers_match_jax(tmp_path):
    rs = np.random.RandomState(0)
    rows = [[f"key{i}"] + [base64.b64encode(rs.bytes(rs.randint(1, 400))).decode()
                           for _ in range(rs.randint(0, 4))] for i in range(30)]
    path = str(tmp_path / "a.tsv")
    ttsv.tsv_writer(rows, path)
    jtsv.generate_lineidx(path, str(tmp_path / "j.lineidx"))
    assert ttsv.load_lineidx(str(tmp_path / "a.lineidx")) == \
        jtsv.load_lineidx(str(tmp_path / "j.lineidx"))
    want = jtsv.TSVFile(path)
    plain, native = tnative.open_tsv(path, "python"), tnative.open_tsv(path, "native")
    assert isinstance(native, tnative.NativeTSVFile) and isinstance(plain, ttsv.TSVFile)
    assert len(plain) == len(native) == len(want) == 30
    for i in range(30):
        assert plain[i] == native[i] == want[i]
        assert plain.get_key(i) == native.get_key(i) == want.get_key(i)
    pairs = [(i, f) for i, r in enumerate(rows) for f in range(1, len(r))]
    got = native.decode_fields(pairs, n_threads=3)
    assert got == [base64.b64decode(rows[i][f]) for i, f in pairs]
    assert [r for r in ttsv.tsv_reader(path)] == [r for r in jtsv.tsv_reader(path)]
    with pytest.raises(ValueError, match="reader"):
        tnative.open_tsv(path, "mmap")


def test_native_build_is_cached_by_content(monkeypatch):
    so = tnative.build()
    assert so == tnative.library_path() and so.exists()
    assert so.parent.name == "build" and "libemvm_tsv_" in so.name
    # the name follows the whole command, the compiler's path included
    monkeypatch.setenv("CXX", "/elsewhere/c++")
    assert tnative.library_path() != so


def test_failed_builds_raise(tmp_path, monkeypatch):
    """No fallback behind the caller's back: a compiler that fails, or a
    toolkit without nvJPEG, raises."""
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="tsv_reader.cpp"):
        tnative.build()
    monkeypatch.setattr(tjpeg._build, "_nvcc", lambda: str(tmp_path / "bin" / "nvcc"))
    with pytest.raises(RuntimeError, match="nvJPEG"):
        tjpeg.build()
    with pytest.raises(ValueError, match="CUDA device"):
        tjpeg.NvJpegDecoder("cpu")


# ---------------------------------------------------------------------------
# temporal picks and transforms


def test_temporal_and_multi_clip_indices_match_jax():
    for n_avail in range(1, 40):
        for sf in (1, 2, 4, 5, 8):
            assert ttr.multi_clip_indices(n_avail, sf) == jtr.multi_clip_indices(n_avail, sf)
            for train in (False, True):
                for seed in range(3):
                    ra, rb = random.Random(seed), random.Random(seed)
                    assert ttr.temporal_sample(n_avail, sf, train, ra) == \
                        jtr.temporal_sample(n_avail, sf, train, rb)
                    assert ra.getstate() == rb.getstate()
    for start, end, n in ((0, 9, 4), (0, 9, 1), (3, 17, 5), (0, 0, 3)):
        assert ttr.sampling(start, end, n) == jtr.sampling(start, end, n)
    for t in ttr.TRANSFORMS:
        for split in ("train", "val"):
            assert ttr.eval_transform(t, split) == jtr.eval_transform(t, split)


def _jpeg(rs, h, w):
    img = cv2.GaussianBlur((rs.rand(h, w, 3) * 255).astype(np.uint8), (0, 0), 2)
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("transform", ttr.TRANSFORMS)
@pytest.mark.parametrize("split", ["train", "val"])
def test_transforms_match_jax_within_one_step(transform, split):
    """Frames of several sizes (up- and downscaled, landscape and portrait,
    one that needs no resize) planned and run by the port against the JAX
    ``clip_from_images`` on the same decoded frames and draws."""
    rs = np.random.RandomState(len(transform) + len(split))
    shares = []
    for sizes in (((48, 64), (48, 64)), ((256, 340),) * 3, ((360, 640), (360, 640)),
                  ((300, 200), (300, 200)), ((224, 224),), ((100, 260), (90, 300))):
        if transform.startswith("vid") and len(set(sizes)) > 1:
            continue                            # one window over frames of one size
        frames = [_jpeg(rs, h, w) for h, w in sizes]
        imgs = [cv2_decode(f) for f in frames]
        assert [tjpeg.jpeg_size(f) for f in frames] == list(sizes)
        for normalize in (False, True):
            ra, rb = random.Random(7), random.Random(7)
            want = jtr.clip_from_images(imgs, 56, split=split, transform=transform, rng=ra,
                                        normalize=normalize)
            plan = ttr.plan_clip(frames, list(sizes), 56, split, transform, rb, normalize)
            assert ra.getstate() == rb.getstate()
            got = ttr.run_plans([plan], [[torch.from_numpy(i.copy()) for i in imgs]], "cpu")
            shares.append(assert_pixels_close(got[0].numpy(), want, normalize))
    print(f"{transform} {split}: largest share of differing values {max(shares):.4f}")


def test_jpeg_size_reads_the_frame_header():
    rs = np.random.RandomState(0)
    f = _jpeg(rs, 37, 91)
    assert tjpeg.jpeg_size(f) == (37, 91)
    assert tjpeg.jpeg_size(f[:2]) is None
    assert tjpeg.jpeg_size(b"\x89PNG\r\n\x1a\n....") is None
    # a stream cut before its frame header
    sof = f.index(b"\xff\xc0")
    assert tjpeg.jpeg_size(f[:sof]) is None
    # cut just after it: the header parses, the decode fails (cv2 as nvJPEG)
    cut = f[:sof + 2 + int.from_bytes(f[sof + 2:sof + 4], "big")]
    assert tjpeg.jpeg_size(cut) == (37, 91) and cv2_decode(cut) is None
    with pytest.raises(ValueError, match="decode function"):
        tjpeg.frame_decoder("cpu")


# ---------------------------------------------------------------------------
# the manifest parser


MANIFESTS = [
    "img: a_img.tsv\ncaption: a_cap.tsv\ncaption_linelist: a_linelist.tsv\n",
    "# a comment\ncomposite: true\nimg: 'shard list.txt'  # trailing\nlabel: \"x # y\"\n"
    "n: 12\nneg: -3\nbig: 1_000\nflag: no\nother: On\nempty_q: ''\npath: a/b:c\n",
    "a: it''s\nb: 'it''s'\nc: \"q\\\"uote\"\n\n   \nzero: 0\n",
]


@pytest.mark.parametrize("text", MANIFESTS)
def test_manifest_parser_matches_yaml(text):
    assert tcomp.parse_manifest(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "img:\n  nested: x\n", "img: [a, b]\n", "img: {a: 1}\n", "- a\n- b\n",
    "img: &anchor x\n", "img: *anchor\n", "img: !!str x\n", "img: |\n  a\n",
    "img: >\n  a\n", "img: 'open\n  more'\n", "img: ~\n", "img: null\n", "ratio: 0.5\n",
    "n: 0x10\n", "n: 010\n", "t: 1:30\n", "img: a: b\n", "img: x\nimg: y\n", "---\nimg: x\n",
    "  img: x\n", "img:\n",
])
def test_manifest_parser_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        tcomp.parse_manifest(text)


# ---------------------------------------------------------------------------
# the task datasets over tests/synth_data.py's layouts

RUN = dict(synth_data.TINY_RUN_OVERRIDES, size_frame=3, size_option=3)


def _configs(**over):
    raw = dict(RUN, **over)
    return jcfg.load_run_config(raw), tcfg.load_run_config(raw)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """Downstream layouts (one img TSV for each kind), a pretrain shard
    with every corrupt case, a 1-frame image shard, a composite manifest;
    and the tiny vocab both packages read."""
    d = str(tmp_path_factory.mktemp("data"))
    for ds, kind in (("ret", "retrieval"), ("mc", "qamc"), ("qa", "qaoe")):
        synth_data.make_downstream(d, ds, f"task-{ds}", kind=kind, n_videos=4, n_frames=7)
        path = os.path.join(d, f"txt_task-{ds}.json")
        with open(path) as f:
            txt = json.load(f)
        extra = dict(txt["train"][0], video="not_in_img")
        if kind == "retrieval":
            txt["train"].append(dict(txt["train"][1], caption=["the cat", "a dog", "red"]))
        txt["train"].append(extra)
        with open(path, "w") as f:
            json.dump(txt, f)
    synth_data.make_pretrain(d, n_videos=8, n_frames=5, n_parts=1, n_val=0)
    rs = np.random.RandomState(5)
    good = synth_data._jpeg_b64(rs)
    raw = base64.b64decode(good)
    sof = raw.index(b"\xff\xc0")
    cut = raw[:sof + 2 + int.from_bytes(raw[sof + 2:sof + 4], "big")]
    shard = os.path.join(d, "webvid2.5m_train_0.tsv")
    with open(shard, "a") as f:
        f.write("nofr\n")                                            # no frames
        f.write("\t".join(["badhdr", good, good, base64.b64encode(b"not a jpeg").decode()])
                + "\n")
        f.write("\t".join(["baddec", good, base64.b64encode(cut).decode(), good]) + "\n")
        f.write("\t".join(["notxt"] + [good] * 4) + "\n")          # vid txt lacks
    with open(os.path.join(d, "txt_webvid2.5m.json")) as f:
        txt = json.load(f)
    txt["train"].update(nofr=["x"], badhdr=["the cat"], baddec=["a dog"])
    with open(os.path.join(d, "txt_webvid2.5m.json"), "w") as f:
        json.dump(txt, f)
    with open(os.path.join(d, "cc3m_train_0.tsv"), "w") as f:
        for i in range(5):
            f.write("\t".join([f"im{i}", synth_data._jpeg_b64(rs)]) + "\n")
    yaml_path = synth_data.make_pretrain_yaml(d, n_videos=4, n_frames=3)
    vocab = synth_data.write_vocab(os.path.join(d, "vocab.txt"))
    return {"dir": d, "yaml": yaml_path, "jtok": jtok.WordPieceTokenizer.from_vocab_file(vocab),
            "ttok": ttok.load_tokenizer(vocab)}


def _src(layout, ds, reader="native"):
    d = layout["dir"]
    args = (os.path.join(d, f"img_{ds}.tsv"), os.path.join(d, f"img_{ds}.id2lineidx.pkl"))
    return jds.TsvImageSource(*args), tds.TsvImageSource(*args, reader=reader)


def _txt(layout, ds):
    with open(os.path.join(layout["dir"], f"txt_task-{ds}.json")) as f:
        return json.load(f)


def _hold_items(jset, tset, normalized=True, shared_rng=False, method="__getitem__"):
    n = len(jset)
    assert len(tset) == n
    titems, jitems = [], []
    for i in range(n):
        if shared_rng:
            jset.rng = jset.item_rng(i)
        jitems.append(getattr(jset, method)(i))
        titems.append(getattr(tset, method)(i))
    batch = device_stage(titems)
    for i, (j, t) in enumerate(zip(jitems, titems)):
        assert set(t) - set(j) <= {"corrupt", "on_corrupt"}, (set(t), set(j))
        for k in j:
            if k != "img":
                got = batch[k][i]
                np.testing.assert_array_equal(
                    got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got),
                    np.asarray(j[k]), err_msg=f"{k} of item {i}")
    assert_pixels_close(batch["img"].numpy(), np.stack([j["img"] for j in jitems]), normalized)
    return jitems, titems, batch["corrupt"].numpy()


@pytest.mark.parametrize("reader", ["native", "python"])
def test_retrieval_items_match_jax(layout, reader):
    jc, tc = _configs(img_transform=["img_rand_crop"], multi_clip_testing=True)
    js, ts = _src(layout, "ret", reader)
    txt = _txt(layout, "ret")
    jset = jds.RetrievalDataset(jc, "train", layout["jtok"], js, txt["train"])
    tset = tds.RetrievalDataset(tc, "train", layout["ttok"], ts, txt["train"])
    _, _, corrupt = _hold_items(jset, tset, shared_rng=True)
    assert not corrupt.any()            # a missing video is the zero clip, as in JAX
    jval = jds.RetrievalDataset(jc, "val", layout["jtok"], js, txt["val"])
    tval = tds.RetrievalDataset(tc, "val", layout["ttok"], ts, txt["val"])
    _hold_items(jval, tval, shared_rng=True, method="multi_clip_item")
    assert tval.multi_clip_item(0)["img"][0].shape == (3, 64, 64)


@pytest.mark.parametrize("name", ["qamc", "qamc_mlm", "qamc_gen"])
def test_multiple_choice_items_match_jax(layout, name):
    jc, tc = _configs(img_transform=["pad_resize" if name == "qamc_gen" else "img_rand_crop"],
                      mask_pos="insert" if name == "qamc_gen" else "append")
    cls = {"qamc": "QAMCDataset", "qamc_mlm": "QAMCMLMDataset", "qamc_gen": "QAMCGenDataset"}
    js, ts = _src(layout, "mc")
    txt = _txt(layout, "mc")
    for split in ("train", "val"):
        jset = getattr(jds, cls[name])(jc, split, layout["jtok"], js, txt[split])
        tset = getattr(tds, cls[name])(tc, split, layout["ttok"], ts, txt[split])
        _hold_items(jset, tset)


@pytest.mark.parametrize("fib", [False, True])
def test_open_ended_items_match_jax(layout, fib):
    jc, tc = _configs()
    js, ts = _src(layout, "qa")
    txt = _txt(layout, "qa")
    jset = jds.QAOEMLMDataset(jc, "train", layout["jtok"], js, txt["train"], fib=fib)
    tset = tds.QAOEMLMDataset(tc, "train", layout["ttok"], ts, txt["train"], fib=fib)
    _, titems, _ = _hold_items(jset, tset)
    assert titems[0]["txt"].shape == ((RUN["size_txt"],) if fib else (RUN["size_txt"] + 5,))
    assert (titems[-1]["mask_ans"] == -1).all()          # its video is missing
    jset = jds.QAOEDataset(jc, "val", layout["jtok"], js, txt["val"], txt["ans2label"])
    tset = tds.QAOEDataset(tc, "val", layout["ttok"], ts, txt["val"], txt["ans2label"])
    _hold_items(jset, tset)


@pytest.mark.parametrize("reader", ["native", "python"])
@pytest.mark.parametrize("name", ["webvid2.5m", "cc3m"])
def test_pretrain_items_match_jax(layout, reader, name):
    """Every corrupt case (no frames, a bad header, a frame that fails to
    decode, a vid its txt lacks, a vid the vq table lacks) as the JAX
    ``except``: zero clip, empty caption, vq -1, ``corrupt``."""
    jc, tc = _configs(img_transform=["vid_rand_crop"])
    d = layout["dir"]
    if name == "webvid2.5m":
        with open(os.path.join(d, f"txt_{name}.json")) as f:
            txt = json.load(f)["train"]
    else:
        txt = {f"im{i}": ["a cat"] for i in range(4)}
    path = os.path.join(d, f"{name}_train_0.tsv")
    vids = [r.split("\t")[0] for r in open(path).read().splitlines()]
    vq = {v: [np.full((2, 2), 5 + i)] * (1 if name == "cc3m" else 3)
          for i, v in enumerate(vids[1:])}
    for table in (None, vq):
        jset = jds.PretrainTsvDataset(jc, "train", layout["jtok"], path, txt, name, vq=table)
        tset = tds.PretrainTsvDataset(tc, "train", layout["ttok"], path, txt, name, vq=table,
                                      reader=reader)
        _, titems, corrupt = _hold_items(jset, tset, normalized=False, shared_rng=True)
        flags = np.array([bool(t["corrupt"]) for t in titems])
        if name == "webvid2.5m":
            want = {"nofr", "badhdr", "baddec", "notxt"} | ({vids[0]} if table else set())
            assert {v for v, c in zip(vids, corrupt) if c} == want
            # the failed decode is found in the device stage, not on the host
            assert corrupt[vids.index("baddec")] and not flags[vids.index("baddec")]
        else:
            assert titems[0]["img"].shape == (1, 64, 64)
            assert {v for v, c in zip(vids, corrupt) if c} == {"im4"} | (
                {vids[0]} if table else set())


def test_composite_items_match_jax(layout):
    jc, tc = _configs(img_transform=["img_rand_crop"])
    jset = jcomp.CompositeYamlDataset(jc, layout["yaml"], "train", layout["jtok"])
    tset = tcomp.CompositeYamlDataset(tc, layout["yaml"], "train", layout["ttok"])
    assert tset.manifest == jset.manifest
    _hold_items(jset, tset, shared_rng=True)
    assert tset.get_composite_source_idx() == jset.get_composite_source_idx()


def test_partial_txt_matches_jax():
    txt = [{"video": f"v{i % 7}", "caption": str(i)} for i in range(30)]
    for ratio in (0.4, 3, 1):
        jc, tc = _configs(data_ratio=ratio)
        for split in ("train", "val"):
            assert tds.DatasetBase(tc, split, None).partial_txt(txt) == \
                jds.DatasetBase(jc, split, None).partial_txt(txt)


# ---------------------------------------------------------------------------
# the loaders


class _Rows:
    def __init__(self, n, tag):
        self.n, self.tag = n, tag

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.array([i, self.tag], np.int32), "vid": f"{self.tag}-{i}"}


def test_meta_loader_schedule_and_shard_affinity_match_jax():
    for ratios in ({"a": 1, "b": 1}, {"a": 3, "b": 1, "c": 0.5}, {"a": 2.5, "b": 1 / 3}):
        def loaders(mod):
            return {k: (mod.ShardedBatchLoader(_Rows(7 + i, i), 2, shuffle=True, seed=i,
                                               num_threads=2), r)
                    for i, (k, r) in enumerate(ratios.items())}
        jm, tm = jld.MetaLoader(loaders(jld), seed=5, accum_steps=2), \
            tld.MetaLoader(loaders(tld), seed=5, accum_steps=2)
        assert tm.pool == jm.pool
        for (jt, jb), (tt, tb) in zip(*(_take(m, 25) for m in (jm, tm))):
            assert tt == jt
            np.testing.assert_array_equal(tb["x"], jb["x"])
            assert list(tb["vid"]) == list(jb["vid"])
        tm.close()
    src = [0] * 10 + [1] * 7 + [2] * 12 + [3] * 3 + [4] * 9
    for hosts in (1, 2, 3):
        for host in range(hosts):
            for shuffle in (False, True):
                np.testing.assert_array_equal(
                    tcomp.shard_affinity_indices(src, hosts, host, 7, shuffle),
                    jcomp.shard_affinity_indices(src, hosts, host, 7, shuffle))
    for kw in ({"num_hosts": 3, "host_index": 1}, {"limit_samples": 4},
               {"source_idx": src, "num_hosts": 2, "host_index": 1}):
        a = tld.ShardedBatchLoader(_Rows(len(src), 0), 3, shuffle=True, seed=2, **kw)
        b = jld.ShardedBatchLoader(_Rows(len(src), 0), 3, shuffle=True, seed=2, **kw)
        a.set_epoch(3), b.set_epoch(3)
        np.testing.assert_array_equal(a._indices(), b._indices())
        assert len(a) == len(b)


def _take(loader, n):
    out = []
    for item in loader:
        out.append(item)
        if len(out) == n:
            return out
    return out


def test_batches_do_not_depend_on_the_thread_count(layout):
    """Two epochs of the pretrain shard (every corrupt case in it) through
    the port's loader and its device stage, with 1 and with 6 threads and
    the interpreter switching threads 100x as often: equal batches."""
    _, tc = _configs(img_transform=["vid_rand_crop"])
    path = os.path.join(layout["dir"], "webvid2.5m_train_0.tsv")
    with open(os.path.join(layout["dir"], "txt_webvid2.5m.json")) as f:
        txt = json.load(f)["train"]
    runs = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(interval / 100)
    try:
        for threads in (1, 6):
            ds = tds.PretrainTsvDataset(tc, "train", layout["ttok"], path, txt)
            ld = tld.ShardedBatchLoader(ds, 4, shuffle=True, seed=3, num_threads=threads)
            meta = tld.MetaLoader({"w": (ld, 1)}, seed=3)
            pf = tld.DevicePrefetcher(meta, "cpu", cv2_decode, depth=2)
            batches = [b for _, b in _take(pf, 2 * len(ld))]
            meta.close()
            runs.append(batches)
    finally:
        sys.setswitchinterval(interval)
    assert len(runs[0]) == len(runs[1]) == 6
    for a, b in zip(*runs):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert any(b["corrupt"].any() for b in runs[0])


def test_prefetcher_needs_a_decode_function_on_the_cpu():
    with pytest.raises(ValueError, match="decode function"):
        tld.DevicePrefetcher([], "cpu")


def test_closing_the_loaders_stops_their_threads(layout):
    """A consumer that stops early, then closes its ``MetaLoader``: every
    producer thread (the loaders', the prefetcher's, the item pools') has
    ended when the calls return."""
    import threading
    _, tc = _configs(img_transform=["img_rand_crop"])
    path = os.path.join(layout["dir"], "webvid2.5m_train_0.tsv")
    with open(os.path.join(layout["dir"], "txt_webvid2.5m.json")) as f:
        txt = json.load(f)["train"]
    before = set(threading.enumerate())
    loaders = {f"w{i}": (tld.ShardedBatchLoader(
        tds.PretrainTsvDataset(tc, "train", layout["ttok"], path, txt), 2, shuffle=True,
        seed=i, num_threads=3), 1) for i in range(2)}
    meta = tld.MetaLoader(loaders, seed=0)
    it = iter(tld.DevicePrefetcher(meta, "cpu", cv2_decode, depth=1))
    assert [next(it)[1]["img"].shape[0] for _ in range(3)] == [2, 2, 2]
    it.close()
    meta.close()
    assert not set(threading.enumerate()) - before


# a process that closes its loaders and exits at once, as a script's last
# lines do: a producer still inside a torch call at exit aborts the process
_EXIT_RIGHT_AFTER_CLOSE = """
import sys, tempfile
import cv2, numpy as np
from empirical_mvm_torch.core.config import load_run_config
from empirical_mvm_torch.data.loader import DevicePrefetcher
from empirical_mvm_torch.data.tokenizer import load_tokenizer
from empirical_mvm_torch.tools import loaderbench as lb

def decode(b):
    a = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)
    return None if a is None else a[:, :, ::-1]

d = tempfile.mkdtemp(dir=sys.argv[1])
lb.build_pretrain(d, videos_per_part=201, images=201)
run = lb.with_data(load_run_config("configs/pretrain.json"), data_dir=d)
meta = lb.pretrain_meta_loader(run, load_tokenizer(), threads=4)
it = iter(DevicePrefetcher(meta, "cpu", decode))
for _ in range(10):
    next(it)
it.close()
meta.close()
"""


def test_a_process_may_exit_right_after_closing_the_loaders(tmp_path):
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _EXIT_RIGHT_AFTER_CLOSE, str(tmp_path)],
                         cwd=repo, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
