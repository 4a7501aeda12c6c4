"""Offline VQ-token extraction for the pre-extracted MVM-vq target
(counterpart of ``empirical_mvm_tpu/cli/extract_vq.py``; ref:
main_pretrain.py:27-30,87): the ``{vid: [per-frame (hv, wv) int32 token
grids]}`` dict that ``PretrainTsvDataset`` reads (``vq=``), from a raw
pretrain TSV.

Each frame's grid matches the visual-token grid the fusion sees, ``hv = wv
= size_img // size_patch``, so frames are decoded at ``hv * 8`` pixels (the
dVAE's stride-8 patch, ref: visbackbone/dalle/__init__.py:56-58) with the
deterministic eval transform (uniform temporal sample, center crop), on the
card by nvJPEG (on the CPU by the caller's decode function). A row whose
frames do not decode is skipped.

Usage:
  python -m empirical_mvm_torch.cli.extract_vq \
      --tsv webvid.tsv --dvae dvae_encoder.pt --out webvid.vq.pkl \
      [--size-img 224 --size-patch 32 --size-frame 4 --batch 32]
"""

from __future__ import annotations

import argparse
import base64
import binascii
import logging
import pickle
import random

import numpy as np
import torch

from empirical_mvm_torch.cli import common
from empirical_mvm_torch.data.jpeg import frame_decoder, jpeg_size
from empirical_mvm_torch.data.loader import materialize
from empirical_mvm_torch.data.native_tsv import open_tsv
from empirical_mvm_torch.data.transforms import plan_clip, temporal_sample
from empirical_mvm_torch.models.convert import dvae_state_dict
from empirical_mvm_torch.teachers.dvae import DvaeEncoder
from empirical_mvm_torch.train.checkpoint import TORCH_SUFFIXES, load_tree

logger = logging.getLogger(__name__)

VQ_PATCH = 8        # the dVAE's stride (ref: visbackbone/dalle/__init__.py:56-58)


def load_dvae_teacher(path: str, dtype=common.DTYPE, n_hid: int = 256,
                      vocab_size: int = 8192, n_blk_per_group: int = 2,
                      device="cuda") -> DvaeEncoder:
    """The dVAE encoder from a torch ``.pt`` state_dict (DALL-E names) or a
    flax ``.msgpack`` / ``.npz`` tree, frozen, on ``device``."""
    with torch.device(device):
        enc = DvaeEncoder(n_hid, n_blk_per_group, vocab_size, dtype)
    sd = (common.torch_state_dict(path) if path.endswith(TORCH_SUFFIXES)
          else dvae_state_dict(load_tree(path)))
    enc.load_state_dict(sd)
    enc.requires_grad_(False)
    return enc


def _clip_plan(bufs, dec_size: int, size_frame: int):
    """The eval-transform plan of a row's frames (the JAX ``decode_clip(...,
    split="val")``), or None where a frame does not parse."""
    idx = temporal_sample(len(bufs), size_frame, random_clip=False, rng=random.Random(0))
    try:
        frames = [base64.b64decode(bufs[i]) for i in idx]
    except (binascii.Error, ValueError):
        return None
    sizes = [jpeg_size(f) for f in frames]
    if None in sizes:
        return None
    return plan_clip(frames, sizes, dec_size, "val", "img_rand_crop", random.Random(0), True)


@torch.no_grad()
def extract_tsv(tsv_path: str, teacher: DvaeEncoder, *, size_img: int = 224,
                size_patch: int = 32, size_frame: int = 4, batch: int = 32,
                device="cuda", decode=None) -> dict[str, list[np.ndarray]]:
    """The dVAE over every row of a pretrain TSV (``vid \\t frame_b64
    ...``), ``batch`` clips at a time; returns the ``PretrainTsvDataset``
    ``vq`` dict."""
    hv = size_img // size_patch
    dec_size = hv * VQ_PATCH
    decoder = frame_decoder(device, decode)
    tsv = open_tsv(tsv_path)
    out: dict[str, list[np.ndarray]] = {}
    pending: list[tuple[str, object]] = []

    def flush():
        if not pending:
            return
        mat = materialize({"img": [p for _, p in pending]}, decoder, device)
        img, corrupt = mat["img"], mat["corrupt"].cpu().numpy()
        toks = teacher.extract_vq_tokens(img.reshape(-1, *img.shape[2:]))
        toks = toks.to(torch.int32).cpu().numpy().reshape(img.shape[0], img.shape[1], hv, hv)
        for (vid, _), t, bad in zip(pending, toks, corrupt):
            if bad:
                logger.warning("%s: decode failed, skipped", vid)
            else:
                out[vid] = list(t)
        pending.clear()

    for r in range(tsv.num_rows()):
        row = tsv[r]
        vid, bufs = row[0], [b for b in row[1:] if b]
        if not bufs:
            continue
        plan = _clip_plan(bufs, dec_size, size_frame)
        if plan is None:
            logger.warning("row %d (%s): decode failed, skipped", r, vid)
            continue
        pending.append((vid, plan))
        if len(pending) == batch:
            flush()
    flush()
    return out


def main(argv=None, *, device="cuda", decode=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tsv", required=True)
    ap.add_argument("--dvae", required=True,
                    help="dVAE encoder weights (.pt state_dict or .msgpack)")
    ap.add_argument("--out", required=True, help="output .pkl")
    ap.add_argument("--size-img", type=int, default=224)
    ap.add_argument("--size-patch", type=int, default=32)
    ap.add_argument("--size-frame", type=int, default=4)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n-hid", type=int, default=256)
    ap.add_argument("--vocab-size", type=int, default=8192)
    ap.add_argument("--n-blk-per-group", type=int, default=2)
    args = ap.parse_args(argv)
    device = common.run_device(device, decode)
    logging.basicConfig(level=logging.INFO)
    teacher = load_dvae_teacher(args.dvae, n_hid=args.n_hid, vocab_size=args.vocab_size,
                                n_blk_per_group=args.n_blk_per_group, device=device)
    vq = extract_tsv(args.tsv, teacher, size_img=args.size_img, size_patch=args.size_patch,
                     size_frame=args.size_frame, batch=args.batch, device=device,
                     decode=decode)
    with open(args.out, "wb") as f:
        pickle.dump(vq, f)
    logger.info("wrote %d videos to %s", len(vq), args.out)
    return {"out": args.out, "videos": len(vq)}


if __name__ == "__main__":
    main()
