"""The port's tiled self-attention (``packed_self_attention``,
``fused_self_attention``) and BERT's route to it, against the JAX package on
the CPU; inputs from numpy with a seed.

* The plain versions (the path a CPU tensor takes), forward and backward,
  against the JAX Pallas kernels run in interpret mode (the backward through
  ``jax.vjp``) at p = 0: fp32 at atol 1e-5, an odd N, a padded per-row mask.
* ``lane_sa_attention_fits`` equal to the JAX rule on a grid of shapes, and
  BERT's attention taking the kernel that rule names in both packages.
* Dropout: the keep fraction at p = 0.1, and the autograd backward against
  the plain backward under the same (seed, offset).
* The tensor-core forward's arithmetic, emulated, against chip_smoke's
  ``sa`` limit at N = 577 and at the multiple-choice head shape; its planted
  fault against the mismatch limit; the rule that picks the body.
"""

import collections

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models import bert as jbert
from empirical_mvm_tpu.ops import window_attention as jwa
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import bert as tbert
from empirical_mvm_torch.ops import _build
from empirical_mvm_torch.ops import window_attention as twa

T = torch.from_numpy
# fp32: the same algebra in another summation order (both sides take D as
# rowsum(dp * p))
TOL = dict(atol=1e-5, rtol=0)


def _inputs(b, nh, n, hd, seed=0):
    """qkv (B, 3nH, N, hd), a (B, N, N) mask with each row's keys padded
    from its own length on, do (B, nH, N, hd)."""
    rs = np.random.RandomState(seed)
    qkv = (rs.randn(b, 3 * nh, n, hd) * 0.5).astype(np.float32)
    lens = rs.randint(n // 2, n + 1, b)
    lens[0] = n
    keep = (np.arange(n)[None] < lens[:, None]).astype(np.float32)
    mask = np.broadcast_to(((1.0 - keep) * np.finfo(np.float32).min)[:, None], (b, n, n)).copy()
    do = rs.randn(b, nh, n, hd).astype(np.float32)
    return qkv, mask, do


SHAPES = [(3, 2, 24, 16), (2, 3, 37, 8)]       # (B, nH, N, hd): N = 37 is odd


@pytest.mark.parametrize("b,nh,n,hd", SHAPES)
def test_packed_self_attention_matches_jax_kernel(b, nh, n, hd):
    qkv, mask, do = _inputs(b, nh, n, hd)
    scale = hd ** -0.5

    def run(a, g):
        out, back = jax.vjp(lambda a: jwa.packed_self_attention(
            a, jnp.asarray(mask), jnp.zeros((1,), jnp.int32), nh, scale, 0.0, True), a)
        return out, back(g)[0]

    want_out, want_dqkv = jax.jit(run)(jnp.asarray(qkv), jnp.asarray(do))
    out = twa.packed_self_attention_plain(T(qkv), T(mask), nh, scale)
    dqkv = twa.packed_self_attention_backward_plain(T(qkv), T(mask), T(do), nh, scale)
    assert out.shape == (b, nh, n, hd) and dqkv.shape == qkv.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(want_dqkv), **TOL)
    # through the autograd Function: the same gradient, and the broadcast
    # (B, 1, N) view BERT passes gives the same result
    view = T(np.ascontiguousarray(mask[:, :1])).expand(*mask.shape)
    xg = T(qkv).requires_grad_(True)
    twa.packed_self_attention(xg, view, nh, scale).backward(T(do))
    np.testing.assert_array_equal(xg.grad.numpy(), dqkv.numpy())


@pytest.mark.parametrize("b,nh,n,hd", SHAPES)
def test_fused_self_attention_matches_jax_kernel(b, nh, n, hd):
    qkv, mask, do = _inputs(b, nh, n, hd, seed=1)
    q, k, v = (qkv[:, s * nh:(s + 1) * nh] for s in range(3))
    scale = hd ** -0.5

    def run(q, k, v, g):
        out, back = jax.vjp(lambda q, k, v: jwa.fused_self_attention(
            q, k, v, jnp.asarray(mask), jnp.zeros((1,), jnp.int32), scale, 0.0, True), q, k, v)
        return (out, *back(g))

    want = jax.jit(run)(*(jnp.asarray(a) for a in (q, k, v, do)))
    tq, tk, tv = (T(np.ascontiguousarray(a)) for a in (q, k, v))
    got = (twa.fused_self_attention_plain(tq, tk, tv, T(mask), scale),
           *twa.fused_self_attention_backward_plain(tq, tk, tv, T(mask), T(do), scale))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    # the split and packed forms are one function
    np.testing.assert_array_equal(
        got[0].numpy(), twa.packed_self_attention_plain(T(qkv), T(mask), nh, scale).numpy())


def test_route_rule_matches_jax():
    """(b, l, c, nh) grid: the MC fusion (40 rows of 350) and DPT at 384^2
    (577 tokens) are refused, the pretrain (232) and retrieval (275) fusions
    fit, widths that are no multiple of 128 never do."""
    want = {(40, 350, 768, 12): False, (80, 232, 768, 12): True, (20, 275, 768, 12): True,
            (8, 577, 1024, 16): False, (4, 24, 32, 4): False}
    for shape, fits in want.items():
        assert twa.lane_sa_attention_fits(*shape) is fits, shape
    for b in (1, 8, 40):
        for l in (50, 197, 232, 275, 300, 313, 314, 350, 577):
            for c, nh in ((32, 4), (128, 4), (768, 12), (1024, 16)):
                assert twa.lane_sa_attention_fits(b, l, c, nh) == bool(
                    jwa.lane_sa_attention_fits(b, l, c, nh)), (b, l, c, nh)


@pytest.mark.parametrize("hidden,n,route", [(32, 12, "packed_self_attention"),
                                            (128, 12, "lane_self_attention")])
def test_bert_attention_takes_the_jax_route(monkeypatch, hidden, n, route):
    """BertSelfAttention calls the kernel the rule names in both packages
    (JAX with its Pallas kernels in interpret mode) and the two agree in
    fp32 on the same weights."""
    monkeypatch.setenv("EMVM_PALLAS_INTERPRET", "1")
    calls = {pkg: collections.Counter() for pkg in ("jax", "port")}
    for pkg, module in (("jax", jwa), ("port", tbert)):
        for name in ("lane_self_attention", "packed_self_attention"):
            fn = getattr(module, name)

            def counted(*a, _fn=fn, _name=name, _pkg=pkg, **kw):
                calls[_pkg][_name] += 1
                return _fn(*a, **kw)

            monkeypatch.setattr(module, name, counted)
    kw = dict(vocab_size=50, hidden_size=hidden, num_attention_heads=4,
              intermediate_size=2 * hidden)
    rs = np.random.RandomState(2)
    x = rs.randn(2, n, hidden).astype(np.float32)
    keep = np.ones((2, n), np.float32)
    keep[1, n - 3:] = 0
    bias = ((1.0 - keep) * np.finfo(np.float32).min)[:, None, None, :]
    jm = jbert.BertSelfAttention(jcfg.BertConfig(**kw))
    params = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                     jnp.asarray(bias))["params"])()
    calls["jax"].clear()                         # init traced the layer once
    want, _ = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(bias))
    tm = tbert.BertSelfAttention(tcfg.BertConfig(**kw))
    sd = {}
    for name in ("query", "key", "value"):
        sd[f"self.{name}.weight"] = T(np.asarray(params[name]["kernel"]).T.copy())
        sd[f"self.{name}.bias"] = T(np.array(params[name]["bias"]))
    sd["output.dense.weight"] = T(np.asarray(params["out"]["kernel"]).T.copy())
    sd["output.dense.bias"] = T(np.array(params["out"]["bias"]))
    sd["output.LayerNorm.weight"] = T(np.array(params["LayerNorm"]["scale"]))
    sd["output.LayerNorm.bias"] = T(np.array(params["LayerNorm"]["bias"]))
    tm.load_state_dict(sd)
    mask = T(np.ascontiguousarray(bias[:, 0])).expand(2, n, n)
    got = tm(T(x), mask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    assert calls["jax"] == calls["port"] == {route: 1}


def _seed(a, b):
    return torch.tensor([a, b], dtype=torch.int32)


def test_dropout_keep_fraction_and_backward_under_one_seed():
    """At p = 0.1 the kept share of the (B, nH, N, N) probabilities is 1 - p
    within 5 sigma; with the seed the wrapper drew, the autograd backward
    (packed and split) equals the plain backward, which regenerates the
    forward's keep mask; dropout changed the gradient."""
    b, nh, n, hd, p = 3, 2, 37, 8, 0.1
    qkv, mask, do = _inputs(b, nh, n, hd, seed=3)
    scale = hd ** -0.5
    keep = twa._sa_keep(T(qkv)[:, :nh], p, _seed(11, 4))
    frac, sigma = keep.float().mean().item(), (p * (1 - p) / keep.numel()) ** 0.5
    assert abs(frac - (1 - p)) < 5 * sigma, frac
    seed = twa.draw_dropout_seed(torch.Generator().manual_seed(6))
    xg = T(qkv).requires_grad_(True)
    twa.packed_self_attention(xg, T(mask), nh, scale, p,
                              torch.Generator().manual_seed(6)).backward(T(do))
    want = twa.packed_self_attention_backward_plain(T(qkv), T(mask), T(do), nh, scale, p, seed)
    np.testing.assert_array_equal(xg.grad.numpy(), want.numpy())
    qa = T(qkv).requires_grad_(True)
    twa.packed_self_attention_plain(qa, T(mask), nh, scale, p, seed).backward(T(do))
    np.testing.assert_allclose(want.numpy(), qa.grad.numpy(), atol=1e-5, rtol=1e-5)
    no_drop = twa.packed_self_attention_backward_plain(T(qkv), T(mask), T(do), nh, scale)
    assert (want - no_drop).abs().max() > 1e-2
    q, k, v = (T(qkv[:, s * nh:(s + 1) * nh].copy()).requires_grad_(True) for s in range(3))
    twa.fused_self_attention(q, k, v, T(mask), scale, p,
                             torch.Generator().manual_seed(6)).backward(T(do))
    np.testing.assert_array_equal(torch.cat([q.grad, k.grad, v.grad], 1).numpy(), want.numpy())


def test_wrappers_on_cpu_launch_nothing_and_refuse_bad_input():
    qkv, mask, do = (T(a) for a in _inputs(2, 2, 10, 8))
    before = dict(_build.launch_counts)
    xg, mg = qkv.clone().requires_grad_(True), mask.clone().requires_grad_(True)
    twa.packed_self_attention(xg, mg, 2, 0.3).backward(do)
    assert mg.grad is None and dict(_build.launch_counts) == before
    with pytest.raises(ValueError, match="qkv must be"):
        twa.packed_self_attention(qkv[:, :5], mask, 2, 0.3)
    with pytest.raises(ValueError, match="mask must be"):
        twa.packed_self_attention(qkv, mask[:, :4], 2, 0.3)
    with pytest.raises(ValueError, match="generator"):
        twa.packed_self_attention(qkv, mask, 2, 0.3, p_drop=0.1)
    with pytest.raises(ValueError, match="p_drop"):
        twa.packed_self_attention_plain(qkv, mask, 2, 0.3, 1.0, _seed(0, 0))
    with pytest.raises(ValueError, match="alike"):
        twa.fused_self_attention(*qkv[:, :4].chunk(2, dim=1), qkv[:, :1], mask, 0.3)


def _tensor_core_forward(qkv16, mask, nh, normalise_first=True):
    """The tensor-core forward's arithmetic (csrc/self_attention_mma.cuh),
    emulated in torch on bf16 qkv: q * scale rounded to bf16; the scores
    summed over d in 16-wide k-steps; per thread of a quad, a running max and
    sum over its keys (key % 8 // 2 == thread), chunk by chunk of 16 keys,
    the chunk's four terms added in the kernel's order; the quad's four
    combined as shfl_xor 1 then 2 combine them; p = exp(s - max) / sum
    rounded to bf16; P.V in fp32 over 16-key k-steps; out rounded to bf16.
    With ``normalise_first`` False, the planted fault: exp(s - max) rounded
    and the division moved after P.V."""
    q, k, v = qkv16.chunk(3, dim=1)
    b, _, n, hd = q.shape
    qs = (q * twa._scale_in(q.dtype, hd ** -0.5)).float()
    kf, vf = k.float(), v.float()
    s = torch.zeros(b, nh, n, n)
    for d0 in range(0, hd, 16):
        s = s + qs[..., d0:d0 + 16] @ kf[..., d0:d0 + 16].transpose(-1, -2)
    s = s + mask[:, None]
    padded = -(-n // 64) * 64
    sp = torch.nn.functional.pad(s, (0, padded - n), value=-float("inf"))
    # (..., n, chunk, nt, thread, u) -> (..., n, thread, chunk, (nt, u))
    sv = sp.view(b, nh, n, padded // 16, 2, 4, 2).permute(0, 1, 2, 5, 3, 4, 6)
    sv = sv.reshape(b, nh, n, 4, padded // 16, 4)
    mx = torch.full((b, nh, n, 4), -float("inf"))
    total = torch.zeros(b, nh, n, 4)
    for c in range(padded // 16):
        vals = sv[..., c, :]
        m = torch.maximum(mx, vals.max(-1).values)
        total = torch.where(m != mx, total * torch.exp(mx - m), total)
        mx = m
        for u in range(4):
            total = total + torch.where(m == -float("inf"), 0.0, torch.exp(vals[..., u] - m))
    row_max = mx.max(-1, keepdim=True).values
    part = torch.where(mx == row_max, total, total * torch.exp(mx - row_max))
    row_sum = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
    e = torch.exp(s - row_max)
    p = (e / row_sum[..., None] if normalise_first else e).to(torch.bfloat16).float()
    o = torch.zeros(b, nh, n, hd)
    for j0 in range(0, n, 16):
        o = o + p[..., j0:j0 + 16] @ vf[..., j0:j0 + 16, :]
    if not normalise_first:
        o = o / row_sum[..., None]
    return o.to(torch.bfloat16).float()


def _held_to_sa_limit(b, nh, n, hd, seed, normalise_first=True):
    """The emulated forward against the plain version run in bf16: the
    excess over the other attention kernels' one-step limit, over the
    ``sa`` limit, and the share of elements that differ."""
    from chip_smoke import BF16_LIMITS, _excess
    qkv, mask, _ = _inputs(b, nh, n, hd, seed=seed)
    a16 = T(qkv).to(torch.bfloat16)
    want = twa.packed_self_attention_plain(a16, T(mask), nh, hd ** -0.5).float()
    got = _tensor_core_forward(a16, T(mask), nh, normalise_first)
    d = (got - want).abs()
    _, same, _ = BF16_LIMITS["attention"]["out"]
    _, same_sa, _ = BF16_LIMITS["sa"]["out"]
    share = (d > 0).float().mean().item()
    print(f"one-step limit exceeded by {_excess(d, want, **same):.3g}; sa limit exceeded by "
          f"{_excess(d, want, **same_sa):.3g}; differing share {share:.3g}")
    return _excess(d, want, **same), _excess(d, want, **same_sa), share


def test_tiled_forward_arithmetic_fits_its_bf16_limit():
    """The tensor-core forward's arithmetic, emulated in torch at DPT's
    384^2 head shape (N = 577, hd = 64, bf16), against the plain version run
    in bf16: it breaks the one-step limit of the other attention kernels at
    a few cancelling outputs (a p that rounds the other way), and holds
    chip_smoke's ``sa`` limit, 1e-3 of the scale above it; its elements
    differ from plain less than SA_MISMATCH."""
    from chip_smoke import SA_MISMATCH
    over, over_sa, share = _held_to_sa_limit(2, 16, 577, 64, seed=11)
    assert over > 0 and over_sa < 0 and share < SA_MISMATCH


def test_tiled_forward_arithmetic_fits_its_bf16_limit_at_the_mc_shape():
    """The same at the multiple-choice fusion's head shape (N = 350, hd = 64,
    rows padded from their own lengths on)."""
    from chip_smoke import SA_MISMATCH
    _, over_sa, share = _held_to_sa_limit(4, 12, 350, 64, seed=12)
    assert over_sa < 0 and share < SA_MISMATCH


def test_planted_forward_fault_breaks_the_mismatch_limit():
    """chip_smoke's planted forward fault, emulated: with the division moved
    after P.V, the rounded probability is the unnormalised one, and far more
    elements than BF16_MISMATCH (and SA_MISMATCH) differ from plain bf16."""
    from chip_smoke import BF16_MISMATCH, SA_MISMATCH
    *_, share = _held_to_sa_limit(4, 12, 350, 64, seed=12, normalise_first=False)
    assert share > 10 * max(BF16_MISMATCH, SA_MISMATCH)


def test_body_rule():
    """bf16 at hd 32, 64, 128 runs the tensor-core body; fp32 at every hd
    and bf16 at any other hd the CUDA-core body (the C entry's rule)."""
    for hd in (8, 16, 24, 32, 48, 64, 96, 128):
        want = "tensor_core" if hd in (32, 64, 128) else "cuda_core"
        assert twa._sa_body(torch.bfloat16, hd) == want, hd
        assert twa._sa_body(torch.float32, hd) == "cuda_core", hd


def test_bf16_backward_needs_the_jax_rowsum():
    """Why the tiled backward sums D = rowsum(dp * p) in a pass of its own:
    FlashAttention's D = rowsum(dO * O), equal in exact arithmetic, taken
    from the bf16 output moves a large share of the bf16 gradient elements
    by a rounding against the JAX kernel's algebra (the plain backward), at
    the multiple-choice fusion's head shape (N = 350, hd = 64)."""
    b, nh, n, hd = 2, 4, 350, 64
    qkv, mask, do = _inputs(b, nh, n, hd, seed=4)
    q, k, v = T(qkv).to(torch.bfloat16).chunk(3, dim=1)
    do16, adds, scale = T(do).to(torch.bfloat16), [T(mask)[:, None]], hd ** -0.5
    want = torch.cat(twa._attend_backward(q, k, v, adds, scale, do16)[:3], 1).float()
    o = twa._attend(q, k, v, adds, scale)
    qs = (q * twa._scale_in(q.dtype, scale)).float()
    p = torch.softmax(qs @ k.float().transpose(-1, -2) + adds[0], dim=-1)
    dp = do16.float() @ v.float().transpose(-1, -2)
    ds = (p * (dp - (do16.float() * o.float()).sum(-1, keepdim=True))).to(torch.bfloat16).float()
    dq = ((ds @ k.float()) * twa._scale_f32(scale)).to(torch.bfloat16).float()
    dk = (ds.transpose(-1, -2) @ qs).to(torch.bfloat16).float()
    share = (torch.cat([dq, dk], 1) != want[:, :2 * nh]).float().mean().item()
    print(f"dq and dk elements moved by D from the bf16 output: {share:.3g}")
    assert share > 0.05
