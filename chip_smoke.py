#!/usr/bin/env python3
"""Drive the PyTorch port (empirical_mvm_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: a CUDA card must be present; prints its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them.
2. Build: compiles csrc/*.cu with nvcc for sm_90a into build/ and prints the
   build time and ptxas' register and shared-memory report.
3. Kernels against plain versions, at every shape the main path gives them:
   fp32 with TF32 off (atol 1e-4 attention, 1e-5 LayerNorm), and bf16 against
   the plain version on the same bf16 inputs, run in fp32 and run in bf16
   (the limits are ``BF16_*`` below). Every shape is checked and printed
   before the phase fails on any limit exceeded. Each kernel, its plain version and one PyTorch library call computing the same
   function (SDPA with bias + mask as ``attn_mask``; ``F.layer_norm``) are
   timed with CUDA events in the main path's dtype. Prints one ``kernels``
   JSON line and one ``kernel_shapes`` line with the per-shape numbers.
4. The slice at full width: VioletRetrieval at configs/msrvtt-retrieval.json
   (Swin-base, 5 frames of 224^2, 25 text tokens, 12-layer BERT-base fusion),
   seeded random weights, bf16, runs retrieval_two_stage_eval on 16 captions x
   16 videos of 2 clips (seeded uint8 clips). Launch counts are zeroed just
   before the first timed eval and read just after it; every kernel must have
   launched. The stage throughputs are the median and range over
   ``EVAL_REPEATS`` evals after one warm-up eval.
5. Whole model: encode + score_pairs on 2 videos x 1 clip, 4 pairs, on the
   card in fp32 (kernels) against the CPU in fp32 (plain versions), atol and
   rtol 1e-3; the bf16 run's difference is printed.
6. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from empirical_mvm_torch.core.config import load_run_config
from empirical_mvm_torch.models.tasks import VioletRetrieval
from empirical_mvm_torch.models.video_swin import _shift_attn_mask, get_window_size
from empirical_mvm_torch.ops import _build
from empirical_mvm_torch.ops import layernorm as ln
from empirical_mvm_torch.ops import window_attention as wa
from empirical_mvm_torch.train.evaluators import retrieval_two_stage_eval

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "msrvtt-retrieval.json"

# Main-path sizes of phase 4: one stage-1 encode batch of ITEMS captions with
# CLIPS clips each, and stage-2 chunks of CHUNK (text, video) pairs.
ITEMS, CLIPS, CHUNK = 16, 2, 64
EVAL_REPEATS = 7

# bf16 limits. Against the plain version in fp32 on the same bf16 inputs:
# attention within about 3.5x its largest reading (1.4e-3, see PERF.md), and
# LayerNorm within half a bf16 step of its output, the one rounding it adds.
# Against the plain version run in bf16, which repeats the kernels' roundings
# (q * scale and the probabilities rounded to bf16): one bf16 step of the
# output, and for attention at most BF16_MISMATCH of the elements may differ
# at all (a dropped inner rounding shows there first; LayerNorm rounds only
# its output, which the one-step limit covers).
BF16_VS_FP32 = {"attention": dict(atol=5e-3, rtol=0.0),
                "layer_norm": dict(atol=1e-5, rtol=2.0 ** -8)}
BF16_SAME_ROUNDING = dict(atol=1e-5, rtol=2.0 ** -7)
BF16_MISMATCH = 1e-3

# H100 SXM peaks (NVIDIA data sheet; at the full 700 W power limit)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16_tensor": 989e12, "fp32": 67e12}

KERNELS = {
    "direct_window_attention": dict(
        source="empirical_mvm_torch/csrc/window_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:1306"),
    "lane_self_attention": dict(
        source="empirical_mvm_torch/csrc/self_attention.cu",
        replaces="empirical_mvm_tpu/ops/window_attention.py:1089"),
    "fused_layer_norm": dict(
        source="empirical_mvm_torch/csrc/layer_norm.cu",
        replaces="empirical_mvm_tpu/ops/layernorm.py:55"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, window_ms: float = 20.0) -> float:
    """Mean device time of fn() over back-to-back calls filling about
    ``window_ms`` (5 to 500 calls), after one timed warm-up call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run(iters):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    iters = min(500, max(5, int(window_ms / max(run(1), 1e-3))))
    return run(iters)


# ---------------------------------------------------------------------------
# phase 3: one record per (kernel, main-path shape)
# ---------------------------------------------------------------------------

def _excess(diff, ref, atol, rtol):
    """Largest amount by which |diff| exceeds atol + rtol * |ref|."""
    return (diff - atol - rtol * ref.abs()).max().item()


def bf16_check(kernel, plain, act, kind):
    """Run ``kernel`` on ``act`` rounded to bf16 and hold it against ``plain``
    on the same bf16 inputs, run in fp32 and run in bf16 (``kind`` is
    "attention" or "layer_norm"). Returns the readings and the list of limits
    exceeded, empty when the kernel passes."""
    a16 = act.to(torch.bfloat16)
    out = kernel(a16).float()
    ref32, ref16 = plain(a16.float()), plain(a16).float()
    d32, d16 = (out - ref32).abs(), (out - ref16).abs()
    readings = {"max_abs_err_bf16": d32.max().item(),
                "max_abs_err_bf16_same_rounding": d16.max().item(),
                "mismatch_bf16": (d16 > 0).float().mean().item()}
    failures = []
    over = _excess(d32, ref32, **BF16_VS_FP32[kind])
    if over > 0:
        failures.append(f"bf16 vs plain fp32 exceeds {BF16_VS_FP32[kind]} by {over:.3g}")
    over = _excess(d16, ref16, **BF16_SAME_ROUNDING)
    if over > 0:
        failures.append(f"bf16 vs plain bf16 exceeds {BF16_SAME_ROUNDING} by {over:.3g}")
    if kind == "attention" and readings["mismatch_bf16"] > BF16_MISMATCH:
        failures.append(f"bf16: {readings['mismatch_bf16']:.3g} of the elements differ "
                        f"from plain bf16, above {BF16_MISMATCH}")
    return readings, failures


def measure(name, label, act, kernel, plain, library, work_dtype, atol_f32,
            ops, ops_peak, nbytes):
    """Check ``kernel(act)`` against ``plain(act)`` in fp32 and bf16, then
    time kernel, plain and library in ``work_dtype``. ``library(a)`` returns
    a zero-argument callable, its inputs prepared outside the timed call.
    The record's ``failures`` lists the limits exceeded."""
    out, ref = kernel(act), plain(act)
    err32 = (out - ref).abs().max().item()
    del out, ref
    failures = [] if err32 <= atol_f32 else [f"fp32 max err {err32} > {atol_f32}"]
    readings, bf16_failures = bf16_check(
        kernel, plain, act, "layer_norm" if name == "fused_layer_norm" else "attention")
    failures += bf16_failures
    a = act.to(work_dtype)
    lib_call = library(a)
    rec = dict(kernel=name, shape=label, dtype=str(work_dtype).replace("torch.", ""),
               max_abs_err=err32, **readings,
               ms=time_ms(lambda: kernel(a)), plain_ms=time_ms(lambda: plain(a)),
               library_ms=time_ms(lib_call))
    t_ops = ops / PEAK_OPS_S[ops_peak] * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    rec.update(bound_ms=max(t_ops, t_bytes),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               failures=[f"{name} [{label}] {f}" for f in failures])
    torch.cuda.empty_cache()
    return rec


def direct_cases(dev, gen):
    """Every swin stage of the student at msrvtt-retrieval (T=5, 224^2):
    the window clamps to (5, 7, 7), N = 245, hd = 32."""
    b = ITEMS * CLIPS
    recs = []
    for stage in range(4):
        hw, c, nh = 56 >> stage, 128 << stage, 4 << stage
        win, shift = get_window_size((5, hw, hw), (8, 7, 7), (4, 3, 3))
        n = win[0] * win[1] * win[2]
        hp = -(-hw // win[1]) * win[1]
        x3 = torch.randn(b, 5, hp, hp, 3 * c, device=dev, generator=gen) * 0.5
        bias = torch.randn(nh, n, n, device=dev, generator=gen) * 0.02
        masks = [None]
        if any(shift):
            masks.append(torch.from_numpy(_shift_attn_mask((5, hp, hp), win, shift)).to(dev))
        scale = (c // nh) ** -0.5
        for mask in masks:
            nw = (hp // win[1]) * (hp // win[2])

            def kernel(a, mask=mask):
                return wa.direct_window_attention(a, bias, mask, win, nh, scale)

            def plain(a, mask=mask):
                return wa.direct_window_attention_plain(a, bias, mask, win, nh, scale)

            def library(a, mask=mask):
                hd = c // nh
                qkv = wa.window_partition(a, win).reshape(b, nw, n, 3, nh, hd)
                q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).contiguous().unbind(0)
                m = bias[None] if mask is None else bias[None] + mask[:, None]
                m = m.to(a.dtype)
                return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                                              scale=scale)

            label = f"stage{stage} x3=({b},5,{hp},{hp},{3 * c}) nH={nh} " + (
                "shifted" if mask is not None else "unshifted")
            ops = 4 * b * nw * nh * n * n * (c // nh)
            nbytes = x3.numel() * 2 + b * 5 * hp * hp * c * 2 + bias.numel() * 4 + (
                0 if mask is None else mask.numel() * 4)
            recs.append(measure("direct_window_attention", label, x3, kernel, plain,
                                library, torch.bfloat16, 1e-4, ops, "bf16_tensor", nbytes))
            print(json.dumps(recs[-1]), flush=True)
    return recs


def lane_case(dev, gen):
    """Fusion attention of stage 2: CHUNK pairs of 275 tokens (5 x 50 video
    + 25 text), BERT-base heads; padding mask on the text tokens."""
    p, l, d, nh = CHUNK, 275, 768, 12
    x3 = torch.randn(p, l, 3 * d, device=dev, generator=gen) * 0.5
    keep = torch.ones(p, l, device=dev)
    lens = torch.randint(3, 26, (p,), device=dev, generator=gen)
    keep[:, 250:] = (torch.arange(25, device=dev)[None] < lens[:, None]).float()
    bias = (1.0 - keep) * torch.finfo(torch.float32).min
    mask = bias[:, None, :].expand(p, l, l)       # the view BertEncoder passes
    scale = (d // nh) ** -0.5

    def kernel(a):
        return wa.lane_self_attention(a, mask, nh, scale)

    def plain(a):
        return wa.lane_self_attention_plain(a, mask, nh, scale)

    def library(a):
        q, k, v = a.reshape(p, l, 3, nh, d // nh).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        m = bias[:, None, None, :].to(a.dtype)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)

    ops = 4 * p * nh * l * l * (d // nh)
    nbytes = x3.numel() * 2 + p * l * d * 2 + p * l * 4
    rec = measure("lane_self_attention", f"x3=({p},{l},{3 * d}) nH={nh}", x3, kernel,
                  plain, library, torch.bfloat16, 1e-4, ops, "bf16_tensor", nbytes)
    print(json.dumps(rec), flush=True)
    return [rec]


def ln_cases(dev, gen):
    """The three LayerNorm sites: fusion layers (CHUNK*275 rows, eps 1e-12,
    bf16), EncVideo.norm (clips*250 rows, eps 1e-5, bf16), text embeddings
    (ITEMS*25 rows, eps 1e-12, fp32: the embedding sum stays fp32)."""
    c = 768
    recs = []
    for label, rows, eps, work in (("fusion", CHUNK * 275, 1e-12, torch.bfloat16),
                                   ("enc_video", ITEMS * CLIPS * 250, 1e-5, torch.bfloat16),
                                   ("embeddings", ITEMS * 25, 1e-12, torch.float32)):
        x = torch.randn(rows, c, device=dev, generator=gen) * 2.0 + 0.5
        g = 1.0 + 0.1 * torch.randn(c, device=dev, generator=gen)
        bt = 0.1 * torch.randn(c, device=dev, generator=gen)

        def kernel(a, g=g, bt=bt, eps=eps):
            return ln.fused_layer_norm(a, g, bt, eps)

        def plain(a, g=g, bt=bt, eps=eps):
            return ln.layer_norm_reference(a, g, bt, eps)

        def library(a, g=g, bt=bt, eps=eps):
            gw, bw = g.to(a.dtype), bt.to(a.dtype)
            return lambda: F.layer_norm(a, (c,), gw, bw, eps)

        item = torch.finfo(work).bits // 8
        rec = measure("fused_layer_norm", f"{label} rows={rows} C={c} eps={eps}", x,
                      kernel, plain, library, work, 1e-5, 8 * rows * c, "fp32",
                      2 * rows * c * item + 2 * c * 4)
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# phase 4: the full-width slice
# ---------------------------------------------------------------------------

class SyntheticRetrievalDataset:
    """``n`` captions over ``n`` videos of ``clips`` seeded uint8 clips, the
    interface of data/datasets.py RetrievalDataset.multi_clip_item."""

    def __init__(self, n, clips, frames, size, size_txt, vocab, seed=0):
        rs = np.random.RandomState(seed)
        self.items, self.gt_txt2vid = [], {}
        for i in range(n):
            txt = np.zeros(size_txt, np.int32)
            length = rs.randint(6, size_txt + 1)
            txt[:length] = rs.randint(1000, vocab, length)
            txt[0], txt[length - 1] = 101, 102            # [CLS] ... [SEP]
            self.items.append({
                "img": rs.randint(0, 256, (clips, frames, size, size, 3)).astype(np.uint8),
                "txt": txt, "mask": (txt > 0).astype(np.int32),
                "vid": f"video{i}", "tid": i})
            self.gt_txt2vid[i] = f"video{i}"

    def __len__(self):
        return len(self.items)

    def multi_clip_item(self, i):
        return self.items[i]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's chip run needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    so = _build.build(verbose=True)
    _build.library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against plain versions, at the main-path shapes
    gen = torch.Generator(dev).manual_seed(0)
    recs = direct_cases(dev, gen) + lane_case(dev, gen) + ln_cases(dev, gen)
    failures = [f for r in recs for f in r.pop("failures")]
    require(not failures, "kernel checks failed:\n" + "\n".join(failures))

    # 4. the slice at full width
    cfg = load_run_config(str(CONFIG)).model
    model = VioletRetrieval(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    ds = SyntheticRetrievalDataset(ITEMS, CLIPS, cfg.size_frame, cfg.size_img,
                                   cfg.size_txt, cfg.text.vocab_size, seed=1)

    def run_eval():
        return retrieval_two_stage_eval(model, ds, chunk_size=CHUNK,
                                        encode_batch=ITEMS, device=dev)

    run_eval()                                  # warm-up: first launches, cuBLAS
    _build.launch_counts.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    metrics = run_eval()
    launches = dict(_build.launch_counts)
    runs = [metrics] + [run_eval() for _ in range(EVAL_REPEATS - 1)]
    clips_s = [m["_clips"] / m["_stage1_s"] for m in runs]
    pairs_s = [m["_pairs"] / m["_stage2_s"] for m in runs]
    print(f"launch counts on the main path: {launches}", flush=True)
    for name in KERNELS:
        require(launches.get(name, 0) > 0, f"{name} was never launched on the main path")
    for k in ("r1", "r5", "r10", "medr"):
        require(np.isfinite(metrics[k]), f"{k} is not finite: {metrics}")
        require(all(m[k] == metrics[k] for m in runs), f"{k} differs between evals")
    require(1.0 <= metrics["medr"] <= ITEMS and 0.0 <= metrics["r1"] <= 100.0,
            f"metrics out of range: {metrics}")
    print(json.dumps({
        "slice": "retrieval_two_stage_eval", "config": CONFIG.name, "dtype": "bfloat16",
        "captions": ITEMS, "videos": ITEMS, "clips_per_video": CLIPS,
        "encode_batch": ITEMS, "chunk_size": CHUNK, "evals": EVAL_REPEATS,
        "stage1_clips_per_s": float(np.median(clips_s)),
        "stage1_clips_per_s_range": [min(clips_s), max(clips_s)],
        "stage2_pairs_per_s": float(np.median(pairs_s)),
        "stage2_pairs_per_s_range": [min(pairs_s), max(pairs_s)],
        "stage1_clips_per_s_each": clips_s, "stage2_pairs_per_s_each": pairs_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        **{k: metrics[k] for k in ("r1", "r5", "r10", "medr")}}), flush=True)

    # 5. whole model: card fp32 (kernels) against CPU fp32 (plain versions)
    state = model.state_dict()
    rs = np.random.RandomState(2)
    img = torch.from_numpy(rs.randint(0, 256, (2, 1, cfg.size_frame, cfg.size_img,
                                               cfg.size_img, 3)).astype(np.uint8))
    txt = torch.from_numpy(np.stack([ds.items[i]["txt"] for i in range(2)]))
    mask = torch.from_numpy(np.stack([ds.items[i]["mask"] for i in range(2)]))
    vj, ti = [0, 1, 1, 0], [0, 0, 1, 1]

    def whole(m, device):
        with torch.inference_mode():
            fi, mi, ft, mt = m.encode(img.to(device), txt.to(device), mask.to(device))
            s = m.score_pairs(fi[vj], mi[vj], ft[ti], mt[ti])
        return [t.float().cpu() for t in (fi, ft, s)]

    bf16_out = whole(model, dev)
    del model
    torch.cuda.empty_cache()
    m32 = VioletRetrieval(cfg, dtype=torch.float32, device=dev)
    m32.load_state_dict(state)
    card = whole(m32, dev)
    del m32
    cpu = VioletRetrieval(cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict(state)
    ref = whole(cpu, "cpu")
    diffs = {}
    for name, a, b16, r in zip(("feat_img", "feat_txt", "scores"), card, bf16_out, ref):
        torch.testing.assert_close(a, r, atol=1e-3, rtol=1e-3,
                                   msg=lambda m, name=name: f"whole model {name}: {m}")
        diffs[name] = {"fp32_max_abs": (a - r).abs().max().item(),
                       "bf16_max_abs": (b16 - r).abs().max().item(),
                       "ref_max_abs": r.abs().max().item()}
    print(json.dumps({"whole_model_vs_cpu": diffs}), flush=True)

    # kernels line: per kernel, times summed over its main-path shapes (one
    # call of each), the largest fp32 error, and the main path's launches
    line = []
    for name, meta in KERNELS.items():
        mine = [r for r in recs if r["kernel"] == name]
        tot = {k: sum(r[k] for r in mine) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        ops_bound = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        line.append({"name": name, "route": "cuda", **meta, "launches": launches[name],
                     "max_abs_err": max(r["max_abs_err"] for r in mine),
                     **{k: max(r[k] for r in mine) for k in (
                         "max_abs_err_bf16", "max_abs_err_bf16_same_rounding",
                         "mismatch_bf16")},
                     "ms": tot["ms"], "kernel_ms": tot["ms"], "plain_ms": tot["plain_ms"],
                     "bound_ms": tot["bound_ms"],
                     "bound_by": "operations" if ops_bound > tot["bound_ms"] / 2 else "bytes",
                     "library_ms": tot["library_ms"], "shapes": len(mine)})
    print(json.dumps({"kernel_shapes": recs}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
