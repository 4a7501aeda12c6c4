"""The port's training pieces against the JAX package, on the CPU: the plain
backward of each kernel module against ``jax.vjp`` of the JAX function (its
Pallas kernels in interpret mode) and against torch autograd of the port's
plain forward; the attention dropout on the port's own Philox generator;
masking; the optimizer. Inputs come from numpy with a seed; fp32.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp
import optax

from empirical_mvm_tpu.data import masking as jmask
from empirical_mvm_tpu.ops import layernorm as jln
from empirical_mvm_tpu.ops import window_attention as jwa
from empirical_mvm_tpu.train import optimizer as jopt
from empirical_mvm_torch.data import masking as tmask
from empirical_mvm_torch.models.common import dropout
from empirical_mvm_torch.models.video_swin import drop_path
from empirical_mvm_torch.ops import layernorm as tln
from empirical_mvm_torch.ops import window_attention as twa
from empirical_mvm_torch.ops.layernorm import FusedLayerNorm, LayerNorm
from empirical_mvm_torch.train import optimizer as topt

T = torch.from_numpy
# gradients through softmax attention: the JAX direct-kernel test's own
# tolerance (test_window_attention_kernel.py:568-570), fp32 summation order
GRAD_TOL = dict(atol=3e-4, rtol=1e-3)


def _grads_autograd(fn, inputs, do):
    """torch autograd of ``fn(*inputs)`` against cotangent ``do``."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    fn(*leaves).backward(do)
    return [t.grad for t in leaves]


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [1e-12, 1e-5])
def test_layer_norm_backward_matches_jax_kernel(eps):
    """21 rows (a multiple of no row block) x 256 channels."""
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 7, 256) * 2.0 + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rs.randn(256)).astype(np.float32)
    bt = (0.1 * rs.randn(256)).astype(np.float32)
    dy = rs.randn(3, 7, 256).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jln.fused_layer_norm(a, b, c, eps, True),
                     *(jnp.asarray(v) for v in (x, g, bt)))
    ref = vjp(jnp.asarray(dy))
    out = tln.layer_norm_backward_reference(T(x), T(g), T(dy), eps)
    auto = _grads_autograd(lambda a, b, c: tln.layer_norm_reference(a, b, c, eps),
                           (T(x), T(g), T(bt)), T(dy))
    via_fn = _grads_autograd(lambda a, b, c: tln.fused_layer_norm(a, b, c, eps),
                             (T(x), T(g), T(bt)), T(dy))
    for name, o, r, a, f in zip(("dx", "dgamma", "dbeta"), out, ref, auto, via_fn):
        # dx at 1e-5; the parameter sums over 21 rows at 1e-4
        tol = dict(atol=1e-5, rtol=1e-5) if name == "dx" else dict(atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name, **tol)
        np.testing.assert_allclose(o.numpy(), a.numpy(), err_msg=name, **tol)
        np.testing.assert_array_equal(f.numpy(), o.numpy(), err_msg=name)


# ---------------------------------------------------------------------------
# direct window attention
# ---------------------------------------------------------------------------

def _direct_inputs(seed=0):
    """The JAX direct-kernel test's shape (test_window_attention_kernel.py:524)."""
    rs = np.random.RandomState(seed)
    b, d, hp, wp, c, nh = 2, 2, 6, 9, 128, 4
    win = (2, 3, 3)
    n = 2 * 3 * 3
    nw = (hp // 3) * (wp // 3)
    x3 = (rs.randn(b, d, hp, wp, 3 * c) * 0.3).astype(np.float32)
    bias = (rs.randn(nh, n, n) * 0.1).astype(np.float32)
    mask = np.zeros((nw, n, n), np.float32)
    mask[1::2, : n // 2, n // 2:] = -100.0
    do = rs.randn(b, d, hp, wp, c).astype(np.float32)
    return x3, bias, mask, do, win, nh, (c // nh) ** -0.5


@pytest.mark.parametrize("has_mask", [True, False])
def test_direct_window_attention_backward_matches_jax_kernel(has_mask):
    x3, bias, mask, do, win, nh, scale = _direct_inputs()
    n = bias.shape[-1]
    jmask_ = jnp.asarray(mask if has_mask else np.zeros((1, n, n), np.float32))
    _, vjp = jax.vjp(lambda a, b: jwa.direct_window_attention(
        a, b, jmask_, win, nh, scale, True, has_mask), jnp.asarray(x3), jnp.asarray(bias))
    ref = vjp(jnp.asarray(do))
    m = T(mask) if has_mask else None
    out = twa.direct_window_attention_backward_plain(T(x3), T(bias), m, T(do), win, nh,
                                                     scale)
    auto = _grads_autograd(
        lambda a, b: twa.direct_window_attention_plain(a, b, m, win, nh, scale),
        (T(x3), T(bias)), T(do))
    via_fn = _grads_autograd(
        lambda a, b: twa.direct_window_attention(a, b, m, win, nh, scale),
        (T(x3), T(bias)), T(do))
    for name, o, r, a, f in zip(("dx3", "dbias"), out, ref, auto, via_fn):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(o.numpy(), a.numpy(), err_msg=name, **GRAD_TOL)
        np.testing.assert_array_equal(f.numpy(), o.numpy(), err_msg=name)


# ---------------------------------------------------------------------------
# lane self-attention and its dropout
# ---------------------------------------------------------------------------

def _lane_inputs(seed=0, b=4, l=24, c=128, nh=4):
    rs = np.random.RandomState(seed)
    x3 = (rs.randn(b, l, 3 * c) * 0.3).astype(np.float32)
    keep = np.ones((b, l), np.float32)
    keep[1, 17:] = 0
    keep[3, 5:] = 0
    bias1d = (1.0 - keep) * np.finfo(np.float32).min        # padded 1D mask
    mask = np.broadcast_to(bias1d[:, None, :], (b, l, l)).copy()
    do = rs.randn(b, l, c).astype(np.float32)
    return x3, mask, do, nh, (c // nh) ** -0.5


def test_lane_self_attention_backward_matches_jax_kernel():
    x3, mask, do, nh, scale = _lane_inputs()
    _, vjp = jax.vjp(lambda a: jwa.lane_self_attention(
        a, jnp.asarray(mask), jnp.zeros((1,), jnp.int32), nh, scale, 0.0, True),
        jnp.asarray(x3))
    (ref,) = vjp(jnp.asarray(do))
    out = twa.lane_self_attention_backward_plain(T(x3), T(mask), T(do), nh, scale)
    (auto,) = _grads_autograd(lambda a: twa.lane_self_attention_plain(a, T(mask), nh, scale),
                              (T(x3),), T(do))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GRAD_TOL)
    np.testing.assert_allclose(out.numpy(), auto.numpy(), **GRAD_TOL)


def test_philox_matches_the_published_answers():
    """Philox4x32-10 known-answer vectors of the Random123 distribution
    (counter, key -> output)."""
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = twa.philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
        assert tuple(int(w) for w in got) == want


def _seed(a, b):
    return torch.tensor([a, b], dtype=torch.int32)


def test_dropout_keep_mask_statistics_and_determinism():
    shape, p = (4, 3, 40, 37), 0.1
    keep = twa.dropout_keep(_seed(7, 0), shape, p)
    n = keep.numel()
    frac = keep.float().mean().item()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(frac - (1 - p)) < 5 * sigma, frac
    # the same (seed, offset) gives the same mask; a different one another
    assert torch.equal(keep, twa.dropout_keep(_seed(7, 0), shape, p))
    for other in (_seed(8, 0), _seed(7, 1)):
        diff = (keep != twa.dropout_keep(other, shape, p)).float().mean().item()
        assert abs(diff - 2 * p * (1 - p)) < 0.02, diff
    # a mask is a function of the element, not of the array's extent
    assert torch.equal(twa.dropout_keep(_seed(7, 0), (2, 3, 17, 9), p),
                       keep[:2, :, :17, :9])


def test_dropout_backward_uses_the_forward_mask():
    """At a fixed seed the plain backward (which regenerates the keep mask)
    equals torch autograd of the plain forward, and dropout changed the
    result."""
    x3, mask, do, nh, scale = _lane_inputs(1)
    seed, p = _seed(12345, 3), 0.3
    out = twa.lane_self_attention_backward_plain(T(x3), T(mask), T(do), nh, scale, p, seed)
    (auto,) = _grads_autograd(
        lambda a: twa.lane_self_attention_plain(a, T(mask), nh, scale, p, seed),
        (T(x3),), T(do))
    np.testing.assert_allclose(out.numpy(), auto.numpy(), atol=1e-5, rtol=1e-5)
    no_drop = twa.lane_self_attention_backward_plain(T(x3), T(mask), T(do), nh, scale)
    assert (out - no_drop).abs().max() > 1e-2
    # the wrapper draws its seed from the generator and keeps it for backward
    gen = torch.Generator().manual_seed(0)
    xt = T(x3).requires_grad_(True)
    twa.lane_self_attention(xt, T(mask), nh, scale, p, gen).backward(T(do))
    assert torch.isfinite(xt.grad).all()


def test_dropout_toward_zero_equals_no_dropout():
    x3, mask, do, nh, scale = _lane_inputs(2)
    seed = _seed(5, 6)
    for p in (1e-10, 0.0):
        out = twa.lane_self_attention_plain(T(x3), T(mask), nh, scale, p, seed)
        np.testing.assert_array_equal(
            out.numpy(), twa.lane_self_attention_plain(T(x3), T(mask), nh, scale).numpy())
        dx = twa.lane_self_attention_backward_plain(T(x3), T(mask), T(do), nh, scale, p,
                                                    seed)
        np.testing.assert_array_equal(
            dx.numpy(),
            twa.lane_self_attention_backward_plain(T(x3), T(mask), T(do), nh, scale).numpy())


def test_dropout_needs_a_generator_and_a_rate_below_one():
    x3, mask, _, nh, scale = _lane_inputs()
    with pytest.raises(ValueError, match="generator"):
        twa.lane_self_attention(T(x3), T(mask), nh, scale, 0.1)
    with pytest.raises(ValueError, match="p_drop"):
        twa.lane_self_attention_plain(T(x3), T(mask), nh, scale, 1.0, _seed(0, 0))


@pytest.mark.parametrize("kind", ["drop_path", "dropout"])
def test_stochastic_depth_and_dropout_draw_from_the_generator(kind):
    """Kept with probability 1 - p and scaled by 1 / (1 - p), per sample
    (stochastic depth) or per element (dropout); the same generator state
    gives the same draw; no generator is the deterministic pass."""
    fn = drop_path if kind == "drop_path" else dropout
    p = 0.2
    x = torch.ones(4000, 2, 3, 3, 4)
    y = fn(x, p, torch.Generator().manual_seed(1))
    assert set(torch.unique(y).tolist()) == {0.0, 1.0 / (1.0 - p)}
    kept = (y != 0).float()
    if kind == "drop_path":                    # whole samples
        assert torch.equal(kept.amin((1, 2, 3, 4)), kept.amax((1, 2, 3, 4)))
        kept = kept[:, 0, 0, 0, 0]
    assert abs(kept.mean().item() - (1 - p)) < 5 * (p * (1 - p) / kept.numel()) ** 0.5
    assert torch.equal(y, fn(x, p, torch.Generator().manual_seed(1)))
    assert fn(x, p, None) is x and fn(x, 0.0, torch.Generator()) is x


# ---------------------------------------------------------------------------
# masking
# ---------------------------------------------------------------------------

MASK_KW = dict(special_token_ids=(101, 102, 0), mask_token_id=103)


def _jax_draws(key, b, t, h, w, txt, p, mask_types):
    """The draws inside the JAX ``apply_masking``, by its own key schedule."""
    k_choice, k_txt, k_rm, k_bm, _ = jax.random.split(key, 5)
    choice = jax.random.randint(k_choice, (b,), 0, len(mask_types))
    spc = jnp.zeros(txt.shape, bool)
    for tok in (*MASK_KW["special_token_ids"], MASK_KW["mask_token_id"]):
        spc = spc | (txt == tok)
    sel = jmask._text_mask(k_txt, txt, spc, p)
    covs = [jmask._rm_video_cov(k_rm, b, t, h, w, p) if mt == "rm"
            else jmask._bm_video_cov(k_bm, b, t, h, w) for mt in mask_types]
    return tmask.MaskDraws(T(np.asarray(choice).astype(np.int64)),
                           T(np.stack([np.asarray(c) for c in covs])),
                           T(np.stack([np.array(sel)] * len(mask_types))))


def test_masking_apply_matches_jax_given_its_draws():
    rs = np.random.RandomState(0)
    b, t, hh = 6, 3, 96
    img = rs.rand(b, t, hh, hh, 3).astype(np.float32)
    txt = rs.randint(104, 500, (b, 12)).astype(np.int32)
    txt[:, 0], txt[:, 9], txt[:, 10:] = 101, 102, 0
    txt[2, 4] = 103
    key = jax.random.PRNGKey(3)
    ref = jmask.apply_masking(key, jnp.asarray(img), jnp.asarray(txt), None, patch_size=32,
                              p_mask=0.3, mask_types=("bm", "rm"), **MASK_KW)
    draws = _jax_draws(key, b, t, 3, 3, jnp.asarray(txt), 0.3, ("bm", "rm"))
    out = tmask.apply_masking(draws, T(img), T(txt), mask_token_id=103, patch_size=32)
    for name in ("img", "txt", "ans_mtm", "mvm_mask", "cov"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_masking_draws_have_the_reference_statistics():
    gen = torch.Generator().manual_seed(0)
    b, t, h, w, p = 64, 4, 7, 7, 0.15
    txt = torch.randint(104, 500, (b, 32), generator=gen)
    txt[:, 0], txt[:, 20:] = 101, 0
    d = tmask.draw_masks(gen, txt, t, h, w, p_mask=p, mask_types=("rm", "bm"), **MASK_KW)
    rm = d.covs[0]
    sigma = (p * (1 - p) / rm.numel()) ** 0.5
    assert abs(rm.mean().item() - p) < 5 * sigma
    assert torch.equal(d.txt_sel[0], d.txt_sel[1])         # rm and bm share k_txt's
    sel = d.txt_sel[0]
    assert not sel[:, 0].any() and not sel[:, 20:].any()
    free = sel[:, 1:20]
    assert abs(free.float().mean().item() - p) < 5 * (p * (1 - p) / free.numel()) ** 0.5
    assert set(d.choice.tolist()) == {0, 1}
    # bm: T tubes per sample inside the bounds of _bm_video_cov
    tubes = tmask.bm_tubes(gen, b, t, h, w, "cpu")
    t1, bt, h1, bh, w1, bw = tubes
    assert ((bt >= 1) & (bt < t)).all() and ((bh >= 1) & (bh < h * 2 // 3)).all()
    assert ((bw >= 1) & (bw < w * 2 // 3)).all()
    assert ((t1 >= 0) & (t1 + bt <= t) & (h1 >= 0) & (h1 + bh <= h)
            & (w1 >= 0) & (w1 + bw <= w)).all()
    cover = tmask.tube_cover(tubes, t, h, w)
    assert cover.shape == (b, t, h, w) and 0 < cover.mean() < 1
    vol = (bt * bh * bw).float()
    assert (cover.sum((1, 2, 3)) <= vol.sum(1)).all()
    assert (cover.sum((1, 2, 3)) >= vol.max(1).values).all()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _tiny_named_model():
    """A few parameters named as in the VIOLET tree, one per group rule."""
    m = torch.nn.Module()
    m.enc_img = torch.nn.Module()
    m.enc_img.swin = torch.nn.Module()
    blk = torch.nn.Module()
    blk.qkv = torch.nn.Linear(4, 6)
    blk.relative_position_bias_table = torch.nn.Parameter(torch.zeros(5, 2))
    blk.norm1 = LayerNorm(4)
    m.enc_img.swin.blk = blk
    m.enc_img.emb_cls = torch.nn.Parameter(torch.zeros(1, 4))
    m.trsfr = torch.nn.Module()
    m.trsfr.dense = torch.nn.Linear(4, 3)
    m.trsfr.LayerNorm = FusedLayerNorm(3)
    return m


# port name -> (JAX path, transposed?)
TINY_MAP = {
    "enc_img.swin.blk.qkv.weight": (("enc_img", "swin", "blk", "qkv", "kernel"), True),
    "enc_img.swin.blk.qkv.bias": (("enc_img", "swin", "blk", "qkv", "bias"), False),
    "enc_img.swin.blk.relative_position_bias_table": (
        ("enc_img", "swin", "blk", "relative_position_bias_table"), False),
    "enc_img.swin.blk.norm1.weight": (("enc_img", "swin", "blk", "norm1", "scale"), False),
    "enc_img.swin.blk.norm1.bias": (("enc_img", "swin", "blk", "norm1", "bias"), False),
    "enc_img.emb_cls": (("enc_img", "emb_cls"), False),
    "trsfr.dense.weight": (("trsfr", "dense", "kernel"), True),
    "trsfr.dense.bias": (("trsfr", "dense", "bias"), False),
    "trsfr.LayerNorm.weight": (("trsfr", "LayerNorm", "scale"), False),
    "trsfr.LayerNorm.bias": (("trsfr", "LayerNorm", "bias"), False),
}


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_optimizer_matches_optax_build_optimizer():
    rs = np.random.RandomState(0)
    model = _tiny_named_model()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(T(rs.randn(*p.shape).astype(np.float32)))
    params = dict(model.named_parameters())
    jnp_of = lambda name, a: a.T if TINY_MAP[name][1] else a        # noqa: E731
    jparams = _nest({TINY_MAP[n][0]: jnp.asarray(jnp_of(n, p.detach().numpy()))
                     for n, p in params.items()})
    kw = dict(weight_decay=0.1, betas=(0.9, 0.98), warmup_ratio=0.2, min_lr=1e-8,
              max_grad_norm=1.0, backbone_lr_mul=0.5)
    tx = jopt.build_optimizer(jparams, lr=1e-2, max_iter=10, **kw)
    jstate = tx.init(jparams)
    opt = topt.AdamW(model, 1e-2, 10, **kw)
    state = opt.init(params)

    for name, (path, _) in TINY_MAP.items():          # group labels
        assert opt.labels[name] == jopt.default_group_fn(path), name
    jsched = jopt.warmup_linear_schedule(1e-2 * 0.5, 10, 0.2, 1e-8)
    clipped = 0
    for step in range(5):
        assert opt.schedules["swin_decay"](step) == pytest.approx(float(jsched(step)),
                                                                  rel=1e-6)
        scale = 3.0 if step == 2 else 0.05              # step 2 triggers the clip
        grads = {n: T((rs.randn(*p.shape) * scale).astype(np.float32))
                 for n, p in params.items()}
        norm = float(torch.sqrt(sum((g ** 2).sum() for g in grads.values())))
        clipped += norm >= 1.0
        jgrads = _nest({TINY_MAP[n][0]: jnp.asarray(jnp_of(n, g.numpy()))
                        for n, g in grads.items()})
        updates, jstate = tx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        state = opt.update(params, grads, state)
        for n, p in params.items():
            want = np.asarray(_get(jparams, TINY_MAP[n][0]))
            np.testing.assert_allclose(p.detach().numpy(), jnp_of(n, want), atol=1e-6,
                                       rtol=0, err_msg=f"{n} at step {step}")
    assert clipped == 1
