"""Task datasets over the TSV storage (counterpart of
``empirical_mvm_tpu/data/datasets.py``; ref: dataset.py:13-250,
main_pretrain.py:15-138, main_retrieval.py:10-55, main_qamc.py:22-37,
main_qamc_tsv_mlm_gen_ans_idx.py:8-81, main_qaoe.py:9-38,
main_qaoe_tsv_mlm_head.py:27-89, eval_retrieval.py:18-43).

Plain indexable objects: ``data/loader.py`` shards their indices and
collates their items. An item holds its text arrays and labels as the JAX
package's do, but its ``img`` is a :class:`~empirical_mvm_torch.data.
transforms.ClipPlan` (the compressed frames of the sampled clip and each
frame's pad, resize and crop; a tuple of them for the multi-clip eval), not
pixels: the loader's device stage decodes and transforms it
(``loader.materialize``). A frame whose header does not parse zeroes its
clip, as the JAX package's ``except`` does.

Every random draw of an item comes from :meth:`DatasetBase.item_rng`, a
``random.Random`` seeded from the run's seed and the item's index, so a
batch does not depend on which loader thread built which item. The JAX
package draws three of them from the dataset's shared ``self.rng`` instead
(the retrieval caption pick, the pretrain clip read, ``decode_clip``
without an index), whose draws then interleave across its loader's
threads. The draws of :meth:`~DatasetBase.partial_txt` at construction stay
on the seeded ``self.rng``, as in the JAX package: they run in one thread.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import json
import logging
import os
import pickle
import random
import threading
from typing import Any, Sequence

import numpy as np

from empirical_mvm_torch.data import tokenizer as tok
from empirical_mvm_torch.data.jpeg import jpeg_size
from empirical_mvm_torch.data.native_tsv import NativeTSVFile, open_tsv
from empirical_mvm_torch.data.transforms import (ClipPlan, multi_clip_indices, plan_clip,
                                                 temporal_sample, zero_plan)
from empirical_mvm_torch.data.tsv import load_lineidx

logger = logging.getLogger(__name__)


class DatasetBase:
    """(ref: dataset.py:13-218)"""

    # (ref: main_qaoe_lsmdc_fib.py:24-26 prompt_text)
    PROMPT_TEXT = "fill in the mask to complete the sentence."

    def __init__(self, cfg, split: str, tokzr, size_frame: int | None = None):
        self.cfg = cfg            # RunConfig
        self.split = split
        self.tokzr = tokzr
        self.size_frame = size_frame or cfg.model.size_frame
        self.size_img = cfg.model.size_img
        self.size_txt = cfg.model.size_txt
        self.transform = cfg.data.img_transform[0]
        self.rng = random.Random(cfg.train.seed)

    def str2txt(self, s: str):
        return tok.str2txt(self.tokzr, s, self.size_txt)

    def get_prompt(self, prompt_text: str | None = None):
        """Fixed-per-run text prompt as ([CLS] toks [SEP], mask) int32 arrays
        (ref: dataset.py:58-65 get_prompt)."""
        if prompt_text is None:
            prompt_text = self.cfg.data.prompt or self.PROMPT_TEXT
        ids = ([self.tokzr.cls_token_id]
               + self.tokzr.convert_tokens_to_ids(self.tokzr.tokenize(prompt_text))
               + [self.tokzr.sep_token_id])
        txt = np.asarray(ids, np.int32)
        mask = (txt != self.tokzr.pad_token_id).astype(np.int32)
        return txt, mask

    def item_rng(self, idx: int) -> random.Random:
        """The item's own deterministic draws (the JAX ``item_rng``)."""
        # int(): loader threads pass numpy int64 indices, which
        # random.Random rejects as a seed type
        return random.Random((self.cfg.train.seed * 1_000_003 + int(idx)) % (2 ** 31))

    def clip_plan(self, bufs: Sequence[str | bytes], rng: random.Random,
                  normalize: bool = True) -> tuple[ClipPlan, bool]:
        """(plan, corrupt) of the JAX ``decode_clip(bufs)``: the frames
        picked from the base64 fields ``bufs``, their sizes read from their
        headers, and the transform drawn from ``rng``. A field that does not
        decode or a frame whose header does not parse gives the zero clip,
        and ``corrupt``."""
        idx = temporal_sample(len(bufs), self.size_frame,
                              random_clip=self.split == "train", rng=rng)
        try:
            frames = [base64.b64decode(bufs[i]) for i in idx]
        except (binascii.Error, ValueError):
            return self.zero_plan(normalize), True
        return self.plan_frames(frames, rng, normalize)

    def plan_frames(self, frames: Sequence[bytes], rng: random.Random,
                    normalize: bool) -> tuple[ClipPlan, bool]:
        sizes = [jpeg_size(f) for f in frames]
        if not frames or None in sizes:
            return self.zero_plan(normalize), True
        plan = plan_clip(frames, sizes, self.size_img, self.split, self.transform, rng,
                         normalize)
        return dataclasses.replace(plan, failed_frames=self.size_frame), False

    def zero_plan(self, normalize: bool = True) -> ClipPlan:
        """The corrupt-sample zero clip (ref: main_pretrain.py:94-117),
        (size_frame, size_img, size_img). A uint8 clip is zeroed again on
        the device after normalization (the batch's ``corrupt`` flag), so
        that it matches the reference's normalized-space zeros."""
        return zero_plan(self.size_frame, self.size_img, normalize)

    def partial_txt(self, txt: list[dict]) -> list[dict]:
        """data_ratio subsetting, grouped by video (ref: dataset.py:40-52):
        a ratio < 1 keeps that fraction of videos; an integer >= 1 keeps that
        many videos. Train split only."""
        ratio = self.cfg.data.data_ratio
        if self.split != "train" or ratio == 1:
            return txt
        if ratio <= 0:
            raise ValueError(f"data_ratio must be > 0, not {ratio}")
        by_vid: dict[str, list[dict]] = {}
        for item in txt:
            by_vid.setdefault(item["video"], []).append(item)
        vids = list(by_vid)
        self.rng.shuffle(vids)
        n = (int(np.ceil(len(vids) * ratio)) if ratio < 1
             else min(int(ratio), len(vids)))
        out: list[dict] = []
        for v in vids[:n]:
            out.extend(by_vid[v])
        return out

    def video_item(self, video: str, idx: int) -> tuple[ClipPlan, bool]:
        """(plan, found): the clip plan of ``video``, drawn from the item's
        own rng, or the zero clip where it has no frames; ``found`` is
        whether the source has the video at all."""
        bufs = self.img_source.frames(video)
        if not bufs:
            return self.zero_plan(), bufs is not None
        return self.clip_plan(bufs, self.item_rng(idx))[0], True


class TsvImageSource:
    """An img TSV and its ``id2lineidx`` byte offsets (ref: dataset.py:232-246,
    main_retrieval_tsv.py seek_img_tsv). ``reader="native"`` reads rows
    through the C++ reader (the ``.lineidx`` sidecar generated once, rows
    found by their offsets), ``"python"`` seeks the file under a lock."""

    def __init__(self, img_tsv_path: str, id2lineidx_path: str, reader: str = "native"):
        self.tsv_path = img_tsv_path
        with open(id2lineidx_path, "rb") as f:
            self.id2lineidx: dict[str, int] = pickle.load(f)
        self._fp = None
        self._pid = None
        # loader threads share this source: seek + readline must be atomic
        self._lock = threading.Lock()
        self._native = None
        if reader == "native":
            self._native = open_tsv(img_tsv_path, reader)
            idx_path = os.path.splitext(img_tsv_path)[0] + ".lineidx"
            off2row = {o: i for i, o in enumerate(load_lineidx(idx_path))}
            self._vid2row = {v: off2row[o] for v, o in self.id2lineidx.items()}
        elif reader != "python":
            raise ValueError(f"reader must be 'native' or 'python', not {reader!r}")

    def frames(self, video_id: str) -> list[str] | None:
        if video_id not in self.id2lineidx:
            return None
        if self._native is not None:
            return self._native[self._vid2row[video_id]][2:]
        with self._lock:
            if self._fp is None or self._pid != os.getpid():
                self._fp = open(self.tsv_path, "r")
                self._pid = os.getpid()
            self._fp.seek(self.id2lineidx[video_id])
            row = [s.strip() for s in self._fp.readline().split("\t")]
        return row[2:]  # key, meta, frames...


def load_txt_json(path: str) -> dict[str, Any]:
    with open(path) as f:
        return json.load(f)


class RetrievalDataset(DatasetBase):
    """(ref: main_retrieval.py:10-55, main_retrieval_tsv.py:9-41)"""

    def __init__(self, cfg, split, tokzr, img_source: TsvImageSource, txt: list[dict]):
        super().__init__(cfg, split, tokzr)
        self.img_source = img_source
        self.txt = self.partial_txt(txt)
        self.gt_txt2vid = {i: item["video"] for i, item in enumerate(self.txt)}

    def __len__(self):
        return len(self.txt)

    def __getitem__(self, idx: int):
        item = self.txt[idx]
        raw_txt = item["caption"]
        if isinstance(raw_txt, list):
            if self.split == "train":
                rng = self.item_rng(idx)
                n = rng.randint(1, len(raw_txt))
                ids = rng.sample(range(len(raw_txt)), n)
                raw_txt = " ".join(raw_txt[i] for i in ids)
            else:
                raw_txt = " ".join(raw_txt)
        txt, mask = self.str2txt(raw_txt)
        img, _ = self.video_item(item["video"], idx)
        return {"img": img, "txt": txt, "mask": mask, "vid": item["video"]}

    def multi_clip_item(self, idx: int):
        """Eval stage-1: all temporal crops (ref: eval_retrieval.py:18-43),
        one rng for the clips in turn."""
        item = self.txt[idx]
        bufs = self.img_source.frames(item["video"]) or []
        clips_idx = (multi_clip_indices(len(bufs), self.size_frame)
                     if self.cfg.data.multi_clip_testing and bufs
                     else [list(range(min(len(bufs), self.size_frame)))])
        rng = self.item_rng(idx)
        clips = []
        for ci in clips_idx:
            sel = [bufs[i] for i in ci] if bufs else []
            clips.append(self.clip_plan(sel, rng)[0] if sel else self.zero_plan())
        txt, mask = self.str2txt(item["caption"]
                                 if not isinstance(item["caption"], list)
                                 else " ".join(item["caption"]))
        return {"img": tuple(clips), "txt": txt, "mask": mask,
                "vid": item["video"], "tid": idx}


class QAMCDataset(DatasetBase):
    """Score-head MC: question [SEP] option per row (ref: main_qamc.py:22-37)."""

    def __init__(self, cfg, split, tokzr, img_source: TsvImageSource, txt: list[dict]):
        super().__init__(cfg, split, tokzr)
        self.img_source = img_source
        self.txt = self.partial_txt(txt)
        self.size_option = cfg.model.size_option

    def __len__(self):
        return len(self.txt)

    def __getitem__(self, idx: int):
        item = self.txt[idx]
        q = item["question"]
        txts, masks = [], []
        for i in range(self.size_option):
            opt = item[f"option_{i}"]
            t, m = self.str2txt(tok.concat_txt(self.tokzr, q, opt) if q else opt)
            txts.append(t)
            masks.append(m)
        img, _ = self.video_item(item["video"], idx)
        return {"img": img, "txt": np.stack(txts), "mask": np.stack(masks),
                "ans": np.int32(item["answer"])}


class QAMCMLMDataset(DatasetBase):
    """MLM-head MC: per-option "question option [MASK]" rows with true/false
    answers at the mask (ref: main_qamc_tsv_mlm_head.py:9-54)."""

    def __init__(self, cfg, split, tokzr, img_source: TsvImageSource, txt: list[dict]):
        super().__init__(cfg, split, tokzr)
        self.img_source = img_source
        self.txt = self.partial_txt(txt)
        self.size_option = cfg.model.size_option
        self.true_token_id = tokzr.convert_tokens_to_ids(["true"])[0]
        self.false_token_id = tokzr.convert_tokens_to_ids(["false"])[0]

    def __len__(self):
        return len(self.txt)

    def __getitem__(self, idx: int):
        item = self.txt[idx]
        q = item["question"]
        ans_idx = int(item["answer"])
        txts, masks, mask_ans = [], [], []
        for i in range(self.size_option):
            opt = item[f"option_{i}"]
            # fixed-length encode, then [MASK] appended (ref :13-16)
            t, m = tok.str2txt_with_mask_tok(self.tokzr, f"{q} {opt}" if q else opt,
                                             self.size_txt, mask_pos="append")
            ma = np.full_like(t, -1)
            ma[t == self.tokzr.mask_token_id] = (self.true_token_id if i == ans_idx
                                                 else self.false_token_id)
            txts.append(t)
            masks.append(m)
            mask_ans.append(ma)
        img, _ = self.video_item(item["video"], idx)
        return {"img": img, "txt": np.stack(txts), "mask": np.stack(masks),
                "mask_ans": np.stack(mask_ans), "ans": np.int32(ans_idx)}


class QAMCGenDataset(DatasetBase):
    """Generative MC: options inside the prompt, [MASK] predicts the digit
    (ref: main_qamc_tsv_mlm_gen_ans_idx.py:8-81)."""

    def __init__(self, cfg, split, tokzr, img_source: TsvImageSource, txt: list[dict]):
        super().__init__(cfg, split, tokzr)
        self.img_source = img_source
        self.txt = self.partial_txt(txt)
        self.size_option = cfg.model.size_option
        self.ans_tok_ids = tokzr.convert_tokens_to_ids([f"{i}" for i in range(self.size_option)])

    def __len__(self):
        return len(self.txt)

    def __getitem__(self, idx: int):
        item = self.txt[idx]
        question = item["question"]
        for i in range(self.size_option):
            question = tok.concat_txt(self.tokzr, question,
                                      f"option {i}: " + item[f"option_{i}"])
        txt, mask = tok.str2txt_with_mask_tok(self.tokzr, question, self.size_txt,
                                              mask_pos=self.cfg.data.mask_pos)
        ans_idx = int(item["answer"])
        ans_tok = self.tokzr.convert_tokens_to_ids([f"{ans_idx}"])[0]
        mask_ans = np.where(txt == self.tokzr.mask_token_id, ans_tok, -1).astype(np.int32)
        img, _ = self.video_item(item["video"], idx)
        return {"img": img, "txt": txt, "mask": mask, "mask_ans": mask_ans,
                "ans_idx": np.int32(ans_idx)}


class QAOEDataset(DatasetBase):
    """Open-ended QA with an answer vocabulary (ref: main_qaoe.py:9-38)."""

    def __init__(self, cfg, split, tokzr, img_source: TsvImageSource, txt: list[dict],
                 ans2label: dict[str, int]):
        super().__init__(cfg, split, tokzr)
        self.img_source = img_source
        self.txt = self.partial_txt(txt)
        self.ans2label = ans2label
        self.label2ans = {v: k for k, v in ans2label.items()}

    def __len__(self):
        return len(self.txt)

    def __getitem__(self, idx: int):
        item = self.txt[idx]
        txt, mask = self.str2txt(item["question"])
        img, _ = self.video_item(item["video"], idx)
        return {"img": img, "txt": txt, "mask": mask, "ans": np.int32(item["answer"])}


class QAOEMLMDataset(DatasetBase):
    """Open-ended QA through the MLM head: 'answer: [MASK]' appended, label
    is the answer's token id (ref: main_qaoe_tsv_mlm_head.py:27-89);
    LSMDC-FiB replaces the inline [MASK] (ref: main_qaoe_lsmdc_fib.py:28-41).
    The appended rows are ``size_txt`` + 5 tokens long."""

    def __init__(self, cfg, split, tokzr, img_source: TsvImageSource, txt: list[dict],
                 fib: bool = False):
        super().__init__(cfg, split, tokzr)
        self.img_source = img_source
        self.txt = txt
        self.fib = fib
        n_bad = sum(1 for it in txt if self._ans_id(it) in (self.tokzr.unk_token_id, -1))
        if txt:
            logger.info("%s upper-bound %.2f%% (%d invalid / %d)", split,
                        (1 - n_bad / len(txt)) * 100, n_bad, len(txt))

    def _ans_id(self, item) -> int:
        ans = item.get("answer_text")
        if ans is None:
            return int(item["answer"])
        aid = self.tokzr.convert_tokens_to_ids([ans])[0]
        return -1 if aid == self.tokzr.unk_token_id else aid

    def __len__(self):
        return len(self.txt)

    def __getitem__(self, idx: int):
        item = self.txt[idx]
        q = item["question"]
        if self.fib:
            txt, mask = self.str2txt(q.replace("[MASK]", self.tokzr.mask_token))
        else:
            # append policy adds 'answer: [MASK]' (ref: qaoe_tsv_mlm_head:27-29)
            toks = self.tokzr.tokenize(q)[: self.size_txt - 1]
            pad_len = self.size_txt - len(toks)
            toks = ([self.tokzr.cls_token] + toks + self.tokzr.tokenize("answer: ")
                    + [self.tokzr.mask_token, self.tokzr.sep_token]
                    + [self.tokzr.pad_token] * pad_len)
            txt = np.asarray(self.tokzr.convert_tokens_to_ids(toks), np.int32)
            mask = (txt != self.tokzr.pad_token_id).astype(np.int32)
        mask_ans = np.where(txt == self.tokzr.mask_token_id, self._ans_id(item),
                            -1).astype(np.int32)
        img, found = self.video_item(item["video"], idx)
        if not found:
            mask_ans[:] = -1
        return {"img": img, "txt": txt, "mask": mask, "mask_ans": mask_ans}


class PretrainTsvDataset(DatasetBase):
    """Sharded raw-TSV pretrain dataset (ref: main_pretrain.py:15-138).

    Row format: ``vid \\t frame1_b64 \\t ... frameN_b64``; captions come from
    a per-split dict {vid: [caption, ...]}. Image datasets (cc3m etc.) use
    size_frame = 1 (ref: main_pretrain.py:19). Clips stay uint8; they are
    normalized on the device (``VioletPretrain.losses``), where the
    ``corrupt`` flag zeroes them after normalization.
    """

    IMAGE_DATASETS = ("cc3m", "coco", "vg", "cc12m", "sbu")

    def __init__(self, cfg, split, tokzr, tsv_path: str, txt: dict,
                 dataset_name: str = "webvid2.5m", vq: dict | None = None,
                 reader: str = "native"):
        size_frame = 1 if dataset_name in self.IMAGE_DATASETS else None
        super().__init__(cfg, split, tokzr, size_frame=size_frame)
        self.tsv = open_tsv(tsv_path, reader)
        self.txt = txt
        self.vq = vq
        self.dataset_name = dataset_name

    def __len__(self):
        return self.tsv.num_rows()

    def _read_clip(self, idx: int, rng: random.Random) -> tuple[str, ClipPlan, bool]:
        """(vid, uint8 clip plan, corrupt). The native reader base64-decodes
        only the sampled frames' fields, in one C++ call."""
        if isinstance(self.tsv, NativeTSVFile):
            rb = self.tsv.row_bytes(idx)
            tab = rb.find(b"\t")
            vid = (rb if tab < 0 else rb[:tab]).decode("utf-8")
            n_avail = rb.count(b"\t")
            if n_avail <= 0:
                return vid, self.zero_plan(False), True
            sel = temporal_sample(n_avail, self.size_frame,
                                  random_clip=self.split == "train", rng=rng)
            try:
                frames = self.tsv.decode_fields([(idx, 1 + i) for i in sel])
            except ValueError:
                return vid, self.zero_plan(False), True
            plan, corrupt = self.plan_frames(frames, rng, normalize=False)
            return vid, plan, corrupt
        row = self.tsv[idx]
        vid, bufs = row[0], row[1:]
        if not bufs:
            return vid, self.zero_plan(False), True
        plan, corrupt = self.clip_plan(bufs, rng, normalize=False)
        return vid, plan, corrupt

    def __getitem__(self, idx: int):
        vid, img, corrupt = self._read_clip(idx, self.item_rng(idx))
        raw_txt = ""
        if vid in self.txt:
            raw = self.txt[vid]
            raw_txt = raw[0] if isinstance(raw, list) else raw
        else:
            corrupt = True
        if self.vq is not None and vid not in self.vq:
            # the reference marks a row corrupt when its vid is absent from
            # the pre-extracted vq table (ref: main_pretrain.py:88-93)
            corrupt = True
        t = img.shape[0]
        h = w = self.size_img // self.cfg.model.size_patch
        lv = t * (1 + h * w)
        vq_arr = np.full((lv,), -1, np.int32)
        if self.vq is not None and vid in self.vq and not corrupt:
            flat = []
            for c in self.vq[vid]:
                flat.extend([-1] + list(np.asarray(c).flatten()))
            if len(flat) == lv:
                vq_arr = np.asarray(flat, np.int32)
        if corrupt:
            raw_txt = ""
            img = img.zeroed()
        txt, mask = self.str2txt(raw_txt)
        # a clip that fails on the device is corrupt too: the loader then
        # puts the empty caption and no vq in place of the item's
        blank_txt, blank_mask = self.str2txt("")
        on_corrupt = {"txt": blank_txt, "mask": blank_mask, "vq": np.full((lv,), -1, np.int32)}
        return {"img": img, "txt": txt, "mask": mask, "vq": vq_arr,
                "corrupt": np.bool_(corrupt), "on_corrupt": on_corrupt}


class CaptionDataset(DatasetBase):
    """Caption pairs over the img TSV (JAX ``cli/caption.py:28``; ref:
    main_caption.py:56-68): the caption's inner tokens each replaced by
    [MASK] with ``mask_prob`` for the seq2seq MLM step, the replaced ids in
    ``mask_ans`` (else -1). The corruption and then the clip draw from the
    item's own rng (the JAX item draws from the dataset's shared ``rng``,
    whose order depends on the loader's threads)."""

    def __init__(self, cfg, split, tokzr, img_source: TsvImageSource, txt: list[dict],
                 mask_prob: float = 0.15):
        super().__init__(cfg, split, tokzr)
        self.img_source = img_source
        self.txt = txt
        self.mask_prob = mask_prob

    def __len__(self):
        return len(self.txt)

    def __getitem__(self, idx: int):
        item = self.txt[idx]
        caption = item["caption"]
        if isinstance(caption, list):
            caption = caption[0]
        txt, mask = self.str2txt(caption)
        ans = np.full_like(txt, -1)
        rng = self.item_rng(idx)
        for i in range(1, int(mask.sum()) - 1):
            if rng.random() < self.mask_prob:
                ans[i] = txt[i]
                txt = txt.copy()
                txt[i] = self.tokzr.mask_token_id
        bufs = self.img_source.frames(item["video"])
        img = self.clip_plan(bufs, rng)[0] if bufs else self.zero_plan()
        return {"img": img, "txt": txt, "mask": mask, "mask_ans": ans,
                "vid": item["video"], "raw": caption}
