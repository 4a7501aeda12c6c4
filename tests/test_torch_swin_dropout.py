"""The Video Swin's in-block dropouts (``drop_rate``, ``attn_drop_rate``)
against the JAX package at tiny widths, fp32 on the CPU.

Both rates are 0.1, a probe value: no shipped config sets them. The JAX
package sends every window attention to its XLA branch when
``attn_drop_rate`` is not 0; the port sends it to ``window_attention_xla``
then, and to its kernels' plain versions otherwise. Two geometries cover
the port's routes: two Video Swin stages at embed 64 (the packed kernel at
C = 64, the direct kernel at 128) and two 2D stages at embed 128 (the lane
window kernel). The weights are drawn on the host
(``jax.eval_shape`` of the JAX ``init``) and carried by ``convert``.

The training passes run with the same dropout masks on both sides: the
port's ``dropout`` at the Swin's sites is replaced by one that draws its
keep masks from a seeded numpy stream and records them, and inside this
file's fixture ``flax.linen.Dropout`` is replaced by a module that replays
them in the same order (the JAX package itself is unchanged). The
attention output's dropout sits after ``proj``, where the port's direct
and packed routes hold the (B, D, H, W, C) map and JAX's XLA branch the
(B_, N, C) windows: a recorded mask is partitioned into JAX's windows there.
Outputs within 1e-5 (atol, rtol 1e-4), gradients within atol 2e-4, rtol
1e-3 (fp32 summation order through the blocks).
"""

import dataclasses

import numpy as np
import pytest
import torch
from flax import linen as flax_nn

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models import video_swin as jswin
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import common as tcommon
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models import video_swin as tswin
from empirical_mvm_torch.ops.window_attention import window_partition
from tests.test_torch_pretrain import drawn_params

P = 0.1
FWD_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
KEEP_SIGMAS = 5
GEOMETRIES = {
    # the Video Swin: window (8, 7, 7) clamped to (2, 7, 7) over 2 frames,
    # 4 windows and a shifted block in stage 0 (C = 64: packed), one window
    # in stage 1 (C = 128: direct)
    "video": (dict(embed_dim=64, depths=(2, 1), num_heads=(2, 4), drop_path_rate=0.0),
              (1, 2, 56, 56, 3)),
    # the 2D geometry of EncImgSwin: one frame a window
    "2d": (dict(patch_size=(1, 4, 4), embed_dim=128, depths=(2, 1), num_heads=(4, 8),
                window_size=(1, 7, 7), drop_path_rate=0.0, final_norm=False),
           (1, 2, 56, 56, 3)),
}
ROUTES = {"video": {"packed", "direct"}, "2d": {"lane_window"}}


class Tape:
    """Keep masks drawn by the port's sites, replayed to JAX's in order.
    ``window`` is the window of the attention being run (None outside one)."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.masks = []
        self.window = None

    def port_dropout(self, x, p, generator):
        if generator is None or p == 0.0:
            return x
        keep = torch.from_numpy(self.rs.rand(*x.shape) >= p)
        self.masks.append((keep, self.window))
        return torch.where(keep, x / (1.0 - p), x.new_zeros(()))

    def jax_mask(self, shape):
        keep, window = self.masks.pop(0)
        if tuple(keep.shape) != tuple(shape):
            keep = window_partition(keep, window)
        assert tuple(keep.shape) == tuple(shape), (keep.shape, shape)
        return jnp.asarray(keep.numpy())


@pytest.fixture
def tape(monkeypatch):
    """The port's Swin dropouts recorded on a tape, and ``flax.linen.Dropout``
    replaying it, for one test."""
    t = Tape(11)
    monkeypatch.setattr(tswin, "dropout", t.port_dropout)
    forward = tswin.WindowAttention3D.forward

    def windowed(self, x, mask, window_eff, generator=None):
        t.window = window_eff
        try:
            return forward(self, x, mask, window_eff, generator)
        finally:
            t.window = None

    monkeypatch.setattr(tswin.WindowAttention3D, "forward", windowed)

    class TapeDropout(flax_nn.Module):
        rate: float
        deterministic: bool | None = None

        def __call__(self, inputs, deterministic=None, rng=None):
            det = self.deterministic if deterministic is None else deterministic
            if self.rate == 0.0 or det:
                return inputs
            keep = t.jax_mask(inputs.shape)
            return jnp.where(keep, inputs / (1.0 - self.rate), jnp.zeros_like(inputs))

    monkeypatch.setattr(flax_nn, "Dropout", TapeDropout)
    return t


def _build(geometry, drop, attn_drop, seed=0):
    """JAX ``SwinTransformer3D`` (its XLA attention on the CPU) and its
    params drawn on the host, the port's carrying them, and the input."""
    kw, shape = GEOMETRIES[geometry]
    kw = dict(kw, drop_rate=drop, attn_drop_rate=attn_drop)
    jm = jswin.SwinTransformer3D(config=jcfg.SwinConfig(**kw))
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    params = drawn_params(shapes, np.random.RandomState(seed + 1))
    tm = tswin.SwinTransformer3D(tcfg.SwinConfig(**kw))
    tm.load_state_dict(convert.swin3d_state_dict(params, kw["depths"]))
    return jm, params, tm, x


def _routes(tm, x):
    """The route each block's attention takes on input ``x``."""
    seen = []
    with torch.no_grad():
        h = tm.patch_embed(torch.from_numpy(x))
        for layer in tm.layers:
            window, _ = tswin.get_window_size(h.shape[1:4], layer.window_size,
                                             layer.window_size)
            dp = -(-h.shape[1] // window[0]) * window[0]
            seen += [blk.attn.route(dp, window[0]) for blk in layer.blocks]
            h = layer(h)
    return seen


def _pass(jm, params, tm, x, train):
    """Output and parameter gradients of sum(out * w) on both sides (the
    port's in its names, JAX's carried to them), fp32. The port runs first,
    so that JAX replays the masks it drew."""
    tm.zero_grad(set_to_none=True)
    out = tm(torch.from_numpy(x), torch.Generator().manual_seed(3) if train else None)
    w = np.random.RandomState(5).randn(*out.shape).astype(np.float32)
    (out * torch.from_numpy(w)).sum().backward()
    got = {n: p.grad for n, p in tm.named_parameters()}

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), deterministic=not train,
                       rngs={"dropout": jax.random.PRNGKey(3)})
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    depths = [len(layer.blocks) for layer in tm.layers]
    want = convert.swin3d_state_dict(jax.tree.map(np.asarray, jgrads), depths)
    return out.detach().numpy(), np.asarray(jout), got, want


def _assert_grads(got, want):
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("attn_drop", [0.0, P])
def test_deterministic_pass_with_the_rates_set_matches_jax(geometry, attn_drop):
    """Without a generator no dropout acts: the rates set, the port's output
    and gradients equal JAX's deterministic pass. With ``attn_drop_rate``
    every block takes ``window_attention_xla``, else the geometry's kernels
    (their plain versions here)."""
    jm, params, tm, x = _build(geometry, P, attn_drop)
    routes = set(_routes(tm, x))
    assert routes == ({"xla"} if attn_drop else ROUTES[geometry])
    out, jout, got, want = _pass(jm, params, tm, x, train=False)
    np.testing.assert_allclose(out, jout, **FWD_TOL)
    _assert_grads(got, want)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("attn_drop", [0.0, P])
def test_training_pass_with_the_same_masks_matches_jax(tape, geometry, attn_drop):
    """The training pass with ``drop_rate`` 0.1 (and ``attn_drop_rate`` 0 or
    0.1), the same keep masks on both sides: outputs and every gradient.
    Each site draws once a pass: the patch embedding, each block's
    attention probabilities (with ``attn_drop_rate``), its ``proj`` and its
    MLP twice; every mask the port drew is replayed."""
    jm, params, tm, x = _build(geometry, P, attn_drop)
    out, jout, got, want = _pass(jm, params, tm, x, train=True)
    n_blocks = sum(len(layer.blocks) for layer in tm.layers)
    assert not tape.masks                        # JAX replayed every one
    np.testing.assert_allclose(out, jout, **FWD_TOL)
    _assert_grads(got, want)
    with torch.no_grad():
        assert (tm(torch.from_numpy(x)) - torch.from_numpy(out)).abs().max() > 1e-3
    assert n_blocks == sum(GEOMETRIES[geometry][0]["depths"])


def test_the_dropout_sites_draw_at_their_rates(monkeypatch):
    """The port's own draws (``models/common.dropout``) at every site of a
    training pass with both rates 0.1: the patch embedding, the
    probabilities, ``proj`` and the MLP. The keep fraction over all of them
    lies within 5 sigma of 0.9, and every site's rate is 0.1."""
    counts = []

    def spy(x, p, generator):
        out = tcommon.dropout(x, p, generator)
        if generator is not None and p > 0.0:
            seen = x != 0
            counts.append((p, int((out != 0)[seen].sum()), int(seen.sum())))
        return out

    monkeypatch.setattr(tswin, "dropout", spy)
    _, _, tm, x = _build("video", P, P)
    with torch.no_grad():
        tm(torch.from_numpy(x), torch.Generator().manual_seed(9))
    n_blocks = sum(len(layer.blocks) for layer in tm.layers)
    assert len(counts) == 1 + 4 * n_blocks
    assert {p for p, _, _ in counts} == {P}
    kept, total = sum(c[1] for c in counts), sum(c[2] for c in counts)
    sigma = (P * (1 - P) / total) ** 0.5
    assert abs(kept / total - (1 - P)) <= KEEP_SIGMAS * sigma, (kept / total, sigma)


def test_attention_dropout_route_matches_the_jax_xla_branch(tape):
    """One ``WindowAttention3D`` with ``attn_drop`` 0.1 on a padded, rolled
    (2, 2, 14, 14, 64) map under the shift mask of its 4 windows: the
    port's ``window_attention_xla`` route against the JAX module's XLA
    branch, the deterministic pass and the training pass with the same
    masks (the probabilities' and ``proj``'s), outputs and gradients of
    the parameters and the input."""
    c, nh, window = 64, 2, (2, 7, 7)
    jm = jswin.WindowAttention3D(dim=c, window_size=(8, 7, 7), num_heads=nh, attn_drop=P,
                                 proj_drop=P)
    rs = np.random.RandomState(4)
    x = rs.randn(2, 2, 14, 14, c).astype(np.float32)
    mask = tswin._shift_attn_mask((2, 14, 14), window, (0, 3, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), mask=mask,
                                            window_eff=window))["params"]
    params = drawn_params(shapes, np.random.RandomState(6))
    tm = tswin.WindowAttention3D(c, (8, 7, 7), nh, attn_drop=P, proj_drop=P)
    tm.load_state_dict({
        "relative_position_bias_table": torch.from_numpy(
            np.asarray(params["relative_position_bias_table"])),
        **{f"{name}.{leaf}": torch.from_numpy(np.asarray(v if leaf == "bias" else v.T))
           for name in ("qkv", "proj")
           for leaf, v in (("weight", params[name]["kernel"]), ("bias", params[name]["bias"]))}})
    assert tm.route(2, 2) == "xla"
    w = rs.randn(*x.shape).astype(np.float32)
    for train in (False, True):
        xt = torch.from_numpy(x).requires_grad_()
        tm.zero_grad(set_to_none=True)
        out = tm(xt, torch.from_numpy(mask), window,
                 torch.Generator().manual_seed(1) if train else None)
        (out * torch.from_numpy(w)).sum().backward()
        assert len(tape.masks) == 2 * train

        def loss(p, xx):
            out = jm.apply({"params": p}, xx, mask=mask, deterministic=not train,
                           window_eff=window)
            return jnp.sum(out * w), out

        (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(x))
        assert not tape.masks
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD_TOL)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
        np.testing.assert_allclose(tm.relative_position_bias_table.grad.numpy(),
                                   np.asarray(jg["relative_position_bias_table"]), **GRAD_TOL)
        for name in ("qkv", "proj"):
            np.testing.assert_allclose(getattr(tm, name).weight.grad.numpy(),
                                       np.asarray(jg[name]["kernel"]).T, **GRAD_TOL)
            np.testing.assert_allclose(getattr(tm, name).bias.grad.numpy(),
                                       np.asarray(jg[name]["bias"]), **GRAD_TOL)


def test_swin_custom_rates_reach_the_backbone_through_the_run_config():
    """``swin_custom`` carries the rates from a run config into the model's
    Video Swin (``load_run_config``), which builds and routes the attention
    as JAX does; the 2D encoders take them the same way."""
    run = tcfg.load_run_config({"swin_custom": dict(GEOMETRIES["video"][0], drop_rate=P,
                                                    attn_drop_rate=P)})
    swin = tswin.SwinTransformer3D(run.model.swin)
    assert swin.drop_rate == P
    blk = swin.layers[0].blocks[0]
    assert (blk.attn.attn_drop, blk.attn.proj_drop, blk.mlp.drop) == (P, P, P)
    assert blk.attn.route(2, 2) == "xla"
    drop_only = tswin.SwinTransformer3D(dataclasses.replace(run.model.swin, attn_drop_rate=0.0))
    assert drop_only.layers[0].blocks[0].attn.route(2, 2) == "packed"
    assert drop_only.layers[1].blocks[0].attn.route(2, 2) == "direct"
