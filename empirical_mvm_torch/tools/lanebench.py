"""Window attention read straight from the qkv GEMM output, timed against
transpose + the packed kernel: the counterpart of ``tools/lanebench.py``.

At the Swin-base stage shapes (window 196 tokens, hd 32) it runs
:func:`lane_attention` (the ``_lane_kernel`` of the JAX tool, ported as a
CUDA kernel), :func:`packed_path` (the qkv transposed to (B_, 3nH, N, hd),
``packed_window_attention``, and back) and the fp32 :func:`oracle` on the
same seeded bf16 input, prints the JAX tool's line per stage (times, and
each path's largest error against the oracle) and, with ``--grad``, the
time of one forward + backward of ``lane_window_attention`` (the lane window
kernels, forward and backward) against that of :func:`packed_path`. Times
are CUDA-event means over 30 calls after a warm-up call; on the CPU
(``--device cpu``, the plain versions) they are host-clock means.

    python -m empirical_mvm_torch.tools.lanebench --stage -1 --grad
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from empirical_mvm_torch.ops import window_attention as wa

# the JAX tool's shapes (tools/lanebench.py:136-140); g is its windows per
# grid step, which the port's kernel does not have
SHAPES = {
    0: dict(b_=1024, n=196, c=128, nh=4, nw=64, g=16),
    1: dict(b_=256, n=196, c=256, nh=8, nw=16, g=16),
    2: dict(b_=64, n=196, c=512, nh=16, nw=4, g=4),
}


def lane_attention(x3, bias, mask, nh, scale, g):
    """x3: (B_, N, 3C) qkv GEMM output; returns (B_, N, C). ``g`` is checked
    as the JAX tool's BlockSpecs require it (g | B_, and g | nW unless the
    mask has one window) and otherwise unused."""
    nw = mask.shape[0]
    if x3.shape[0] % g or (nw > 1 and nw % g):
        raise ValueError(f"g={g} must divide B_={x3.shape[0]} and nW={nw} (or nW = 1)")
    return wa.lane_attention(x3, bias, mask, nh, scale)


def packed_path(x3, bias, mask, nh, scale):
    b_, n, c3 = x3.shape
    c = c3 // 3
    qkv = x3.reshape(b_, n, 3 * nh, c // nh).transpose(1, 2).contiguous()
    o = wa.packed_window_attention(qkv, bias, mask, mask.shape[0], nh, scale)
    return o.transpose(1, 2).reshape(b_, n, c)


def oracle(x3, bias, mask, nh, scale):
    b_, n, c3 = x3.shape
    c = c3 // 3
    qkv = x3.reshape(b_, n, 3, nh, c // nh).float()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]        # (B_, N, nH, hd)
    s = torch.einsum("bnhd,bmhd->bhnm", q * scale, k) + bias[None]
    nw = mask.shape[0]
    s = s.reshape(b_ // nw, nw, nh, n, n) + mask[None, :, None]
    p = torch.softmax(s.reshape(b_, nh, n, n), dim=-1)
    o = torch.einsum("bhnm,bmhd->bnhd", p, v)
    return o.reshape(b_, n, c)


def bench(fn, *args, iters=30):
    """Mean ms of ``fn(*args)`` over ``iters`` calls after one warm-up call:
    CUDA events on the card, the host clock on the CPU."""
    fn(*args)
    if not args[0].is_cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _grad(route):
    """d/d(x3, bias) of sum(route(x3, bias) ** 2) in fp32."""
    def call(x3, bias):
        return torch.autograd.grad(route(x3, bias).float().square().sum(), (x3, bias))
    return call


def main(argv=None) -> list[dict]:
    """Run the stages of ``argv`` (``--stage`` 0, 1, 2 or -1 for all,
    ``--grad``, ``--device``); print the JAX tool's lines and return one
    record per stage (times in ms, errors against the oracle)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", type=int, default=2)
    ap.add_argument("--grad", action="store_true",
                    help="also time the lane window forward + backward at each stage")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    clock = "" if dev.type == "cuda" else f"  [{dev.type}, host clock]"
    records = []
    for stage, sh in SHAPES.items():
        if args.stage >= 0 and stage != args.stage:
            continue
        b_, n, c, nh, nw, g = (sh[k] for k in ("b_", "n", "c", "nh", "nw", "g"))
        rs = np.random.RandomState(0)
        x3 = torch.from_numpy(rs.randn(b_, n, 3 * c).astype(np.float32) * 0.1).to(
            dev, torch.bfloat16)
        bias = torch.from_numpy(rs.randn(nh, n, n).astype(np.float32) * 0.1).to(dev)
        mask = torch.zeros((nw, n, n), dtype=torch.float32, device=dev)
        scale = (c // nh) ** -0.5

        def lane(*a):
            return lane_attention(*a, nh, scale, g)

        def packed(*a):
            return packed_path(*a, nh, scale)

        ol = oracle(x3, bias, mask, nh, scale)
        err_l = (lane(x3, bias, mask).float() - ol).abs().max().item()
        err_p = (packed(x3, bias, mask).float() - ol).abs().max().item()
        del ol
        t_l = bench(lane, x3, bias, mask)
        t_p = bench(packed, x3, bias, mask)
        print(f"stage{stage} B_={b_} N={n} C={c} nH={nh}: "
              f"lane {t_l:.3f} ms (err {err_l:.2e})  "
              f"transpose+packed {t_p:.3f} ms (err {err_p:.2e}){clock}", flush=True)
        rec = dict(stage=stage, b_=b_, n=n, c=c, nh=nh, nw=nw, device=str(dev), lane_ms=t_l,
                   packed_ms=t_p, err_lane=err_l, err_packed=err_p)
        if args.grad:
            xg, bg = x3.detach().requires_grad_(True), bias.detach().requires_grad_(True)
            gl = bench(_grad(lambda a, b: wa.lane_window_attention(a, b, mask, nw, nh, scale)),
                       xg, bg)
            gp = bench(_grad(lambda a, b: packed_path(a, b, mask, nh, scale)), xg, bg)
            print(f"  grad: lane {gl:.3f} ms  transpose+packed {gp:.3f} ms{clock}", flush=True)
            rec.update(grad_lane_ms=gl, grad_packed_ms=gp)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
