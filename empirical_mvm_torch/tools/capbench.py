"""Caption-generation throughput of the port's decoders: the counterpart of
``tools/capbench.py``.

``--mode full`` times ``VioletCaptioning.generate`` (each position
re-encodes the caption through the fusion's kernels, the reference's
asymptotics), ``--mode cached`` ``generate_cached`` (the K/V cache), and
``--mode compare`` both, printing the share of their greedy tokens that
agree and, where they differ, the top-2 logit margin at the first
differing position; ``--beam-size`` above 1 times ``generate_beam`` (the
JAX CLI's ``num_beams``). Each decoder prints its line: ms a batch,
captions/s and tokens/s, the mean of ``--iters`` calls after a warm-up call
(host clock, ending in a synchronise), and the kernel launches of one call.
The model is the JAX tool's geometry (Video Swin-base on 4 frames of
224^2, BERT-base fusion, ``--max-len`` text tokens) with seeded random
weights in ``--dtype``, on seeded uint8 clips; ``--device cpu`` runs the
kernels' plain versions.

    python -m empirical_mvm_torch.tools.capbench --mode compare
    python -m empirical_mvm_torch.tools.capbench --mode full --beam-size 4
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from empirical_mvm_torch.core.config import ModelConfig
from empirical_mvm_torch.models.captioning import VioletCaptioning
from empirical_mvm_torch.ops import _build


def decoder(model, mode, max_len=20, decode="greedy", top_k=0, top_p=0.0, temperature=1.0,
            beam_size=1, seed=0):
    """``img -> tokens`` of one decoder: ``full`` (re-encoding), ``cached``,
    or beam search when ``beam_size`` > 1 (the re-encoding decoder's
    passes); sampling draws from a generator seeded ``seed`` at each call."""
    if beam_size > 1:
        return lambda img: model.generate_beam(img, max_len, beam_size=beam_size)
    if mode not in ("full", "cached"):
        raise ValueError(f"mode {mode!r} is not full or cached")

    generate = model.generate_cached if mode == "cached" else model.generate

    def run(img):
        gen = torch.Generator(img.device).manual_seed(seed)
        return generate(img, max_len, decode=decode, top_k=top_k, top_p=top_p,
                        temperature=temperature, generator=gen)

    return run


def bench(model, img, mode, iters=5, **kw):
    """Time ``decoder(model, mode, **kw)`` on ``img``: one warm-up call, then
    ``iters`` calls. Returns the record (ms a batch, captions/s, tokens/s,
    the launches of the first timed call) and the tokens on the CPU."""
    fn = decoder(model, mode, **kw)
    cuda = img.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(img.device)

    fn(img)
    sync()
    _build.launch_counts.clear()
    fn(img)
    sync()
    launches = dict(_build.launch_counts)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(img)
    tokens = out.cpu()
    dt = (time.perf_counter() - t0) / iters
    b, max_len = tokens.shape
    beam = kw.get("beam_size", 1)
    rec = dict(mode=f"beam{beam}" if beam > 1 else mode, decode=kw.get("decode", "greedy"),
               batch=b, max_len=max_len, iters=iters, device=str(img.device),
               ms_per_batch=dt * 1e3, captions_per_s=b / dt, tokens_per_s=b * (max_len - 1) / dt,
               launches=launches)
    return rec, tokens


def first_difference_margin(model, img, tokens, other):
    """Where two decoders' tokens (B, max_len) differ: the first differing
    (row, position) and the top-2 margin of the re-encoding decoder's fp32
    logits there, given ``tokens``' prefix; None where they agree."""
    diff = (tokens != other).nonzero()
    if len(diff) == 0:
        return None
    row, pos = (int(v) for v in diff[diff[:, 1].argmin()])
    with torch.no_grad():
        fi, mi = model.enc_img(img[row:row + 1])
        t = tokens[row:row + 1].to(img.device)
        done = torch.zeros(1, dtype=torch.bool, device=img.device)
        logits = model.next_logits(fi, mi, t, done, pos).float()[0]
    top2 = logits.topk(2).values
    return dict(row=row, position=pos, margin=(top2[0] - top2[1]).item())


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=20)
    ap.add_argument("--decode", default="greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--beam-size", type=int, default=1)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--mode", default="compare", choices=["full", "cached", "compare"])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = ModelConfig(vis_backbone_size="base", size_img=224, size_frame=4,
                      size_txt=args.max_len)
    model = VioletCaptioning(cfg, dtype=getattr(torch, args.dtype), device=dev)
    rs = np.random.RandomState(0)
    img = torch.from_numpy(rs.randint(0, 256, (args.batch, cfg.size_frame, cfg.size_img,
                                               cfg.size_img, 3)).astype(np.uint8)).to(dev)
    kw = dict(max_len=args.max_len, decode=args.decode, top_k=args.top_k, top_p=args.top_p,
              beam_size=args.beam_size)
    modes = ["full", "cached"] if args.mode == "compare" else [args.mode]
    records, tokens = [], {}
    for mode in modes:
        rec, tokens[mode] = bench(model, img, mode, args.iters, **kw)
        print(f"caption generation [{rec['mode']}]: batch={args.batch} max_len={args.max_len} "
              f"decode={args.decode} {args.dtype}  {rec['ms_per_batch']:.1f} ms/batch  "
              f"{rec['captions_per_s']:.2f} captions/s  {rec['tokens_per_s']:.1f} tokens/s  "
              f"launches {rec['launches']}", flush=True)
        records.append(rec)
    if args.mode == "compare":
        same = (tokens["full"] == tokens["cached"]).float().mean().item()
        diff = first_difference_margin(model, img, tokens["full"], tokens["cached"])
        print(f"identical tokens: {same:.4f}; first difference: {diff}; speedup "
              f"{records[0]['ms_per_batch'] / records[1]['ms_per_batch']:.2f}x", flush=True)
        records.append(dict(mode="compare", identical_share=same, first_difference=diff))
    return records


if __name__ == "__main__":
    main()
