"""The port's packed window attention and the C = 96-style swins that run it,
against the JAX package on the CPU; inputs from numpy with a seed.

* ``packed_window_attention``'s plain versions (the path a CPU tensor
  takes), forward and backward, against the JAX Pallas kernel run in
  interpret mode (the backward through ``jax.vjp``), with a mask of 4
  windows, of 1 window, and without (``has_mask=False``); fp32 at atol 1e-6,
  and bf16 within one bf16 step. ``fused_window_attention`` (q, k, v as
  three arrays, the same kernel) likewise.
* ``SwinTransformer3D`` with widths that are no multiple of 128 in stages 0
  and 1 (embed 32) against the JAX one with ``EMVM_PALLAS_INTERPRET=1``:
  outputs and every parameter gradient; both packages take the packed
  kernel in stages 0-1 and the direct kernel in stages 2-3.
* ``EncImgSwin`` on the 2D geometry at embed 32: JAX folds the 4 frames into
  a block-diagonal superwindow for its packed kernel in stages 0-1, the port
  runs the packed kernel on each frame's windows; stages 2-3 take the lane
  window kernel.
* A tiny ``VioletPretrain`` on that Video Swin: weight carry, losses, every
  gradient, two steps of ``make_pretrain_train_step``, with the fixtures of
  test_torch_pretrain.py (JAX runs its XLA attention there).
* ``configs/pretrain.json`` with ``vis_backbone_size`` tiny, small and
  violet: the C = 96 swins, whose stage-0 and stage-1 blocks take the packed
  route.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models import encoders2d as jenc
from empirical_mvm_tpu.models.torch_import import violet_params_from_torch
from empirical_mvm_tpu.models.video_swin import SwinTransformer3D as JSwin
from empirical_mvm_tpu.ops import window_attention as jwa
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models import video_swin as tvs
from empirical_mvm_torch.models.encoders2d import EncImgSwin
from empirical_mvm_torch.models.pretrain import VioletPretrain
from empirical_mvm_torch.models.video_swin import SwinTransformer3D
from empirical_mvm_torch.ops import _build
from empirical_mvm_torch.ops import window_attention as twa
from tests.test_torch_pretrain import (BERT, GRAD_TOL, HEADS, LOSS_TOL, _np_tree,
                                       assert_two_steps_match, carried_slice, drawn_params,
                                       losses_and_grads)

T = torch.from_numpy
B_, NH, N, HD = 8, 2, 49, 32
SCALE = HD ** -0.5
BF16_STEP = 2.0 ** -7                    # one bf16 step, relative
MASKS = [(1, False), (1, True), (4, True)]   # (n_windows, has_mask)


def _inputs(n_windows, dtype=np.float32, seed=0):
    rs = np.random.RandomState(seed)
    qkv = (rs.randn(B_, 3 * NH, N, HD) * 0.5).astype(np.float32)
    bias = (rs.randn(NH, N, N) * 0.1).astype(np.float32)
    mask = np.where(rs.rand(n_windows, N, N) < 0.3, -100.0, 0.0).astype(np.float32)
    do = rs.randn(B_, NH, N, HD).astype(np.float32)
    return qkv.astype(dtype), bias, mask, do.astype(dtype)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax_packed(qkv, bias, mask, do, n_windows, has_mask):
    """Output, dqkv and dbias of the JAX kernel in interpret mode."""
    jmask = jnp.asarray(mask if has_mask else np.zeros((1, N, N), np.float32))

    def run(a, b, g):
        out, back = jax.vjp(lambda a, b: jwa.packed_window_attention(
            a, b, jmask, n_windows if has_mask else 1, NH, SCALE, True, has_mask), a, b)
        return (out, *back(g))

    out, dqkv, dbias = jax.jit(run)(jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(do))
    return _f32(out), _f32(dqkv), np.asarray(dbias)


def _port_packed(qkv, bias, mask, do, n_windows):
    out = twa.packed_window_attention_plain(qkv, bias, mask, n_windows, NH, SCALE)
    dqkv, dbias = twa.packed_window_attention_backward_plain(qkv, bias, mask, do, n_windows,
                                                             NH, SCALE)
    return out.float().numpy(), dqkv.float().numpy(), dbias.numpy()


@pytest.mark.parametrize("n_windows,has_mask", MASKS)
def test_packed_window_attention_matches_jax_kernel(n_windows, has_mask):
    """fp32: the output, dqkv and dbias at atol 1e-6."""
    qkv, bias, mask, do = _inputs(n_windows)
    want = _jax_packed(qkv, bias, mask, do, n_windows, has_mask)
    got = _port_packed(T(qkv), T(bias), T(mask) if has_mask else None, T(do), n_windows)
    assert got[0].shape == (B_, NH, N, HD) and got[1].shape == qkv.shape
    for name, g, w in zip(("out", "dqkv", "dbias"), got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=name)


def _hold_bf16(got, want, dk_one_step_only):
    """Each element within one bf16 step of itself or half a step of the
    largest value; at most 0.1 % of the elements different at all, except dk
    (see the test below)."""
    np.testing.assert_allclose(got, want, atol=BF16_STEP / 2 * np.abs(want).max(),
                               rtol=BF16_STEP)
    if not dk_one_step_only:
        assert (got != want).mean() <= 1e-3


@pytest.mark.parametrize("n_windows,has_mask", [(1, False), (4, True)])
def test_packed_window_attention_bf16_matches_jax_kernel(n_windows, has_mask):
    """The plain versions in bf16 repeat the JAX kernel's roundings (q *
    scale, p and ds rounded to bf16 before their products). dk = round(ds)^T
    . qs is held to the one-step limit only: XLA's CPU compiler rewrites the
    interpreted kernel's dot(ds, q * scale) as dot(ds, q) * scale, so the
    JAX reference skips the rounding of qs there that the kernel's text and
    the port make. dbias is fp32 from fp32 ds: summation order only."""
    qkv, bias, mask, do = _inputs(n_windows, jnp.bfloat16, seed=1)
    out_w, dqkv_w, dbias_w = _jax_packed(qkv, bias, mask, do, n_windows, has_mask)
    bf = lambda a: T(a.astype(np.float32)).to(torch.bfloat16)     # noqa: E731
    out, dqkv, dbias = _port_packed(bf(qkv), T(bias), T(mask) if has_mask else None, bf(do),
                                    n_windows)
    _hold_bf16(out, out_w, False)
    for seg in range(3):                                          # dq, dk, dv
        part = slice(seg * NH, (seg + 1) * NH)
        _hold_bf16(dqkv[:, part], dqkv_w[:, part], seg == 1)
    np.testing.assert_allclose(dbias, dbias_w, atol=1e-5 * np.abs(dbias_w).max(), rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("n_windows", [1, 4])
def test_fused_window_attention_matches_jax_kernel(dtype, n_windows):
    """Row 10: q, k, v as three arrays, the mask always added; the output,
    dq, dk, dv and dbias against the JAX ``fused_window_attention`` in
    interpret mode (fp32 at atol 1e-6, bf16 as the packed test)."""
    qkv, bias, mask, do = _inputs(n_windows, dtype, seed=2)
    q, k, v = (qkv[:, s * NH:(s + 1) * NH] for s in range(3))

    def run(q, k, v, b, g):
        out, back = jax.vjp(lambda q, k, v, b: jwa.fused_window_attention(
            q, k, v, b, jnp.asarray(mask), n_windows, SCALE, True), q, k, v, b)
        return (out, *back(g))

    want = jax.jit(run)(*(jnp.asarray(a) for a in (q, k, v, bias, do)))
    tt = (lambda a: T(a)) if dtype == np.float32 else (
        lambda a: T(a.astype(np.float32)).to(torch.bfloat16))
    tq, tk, tv = tt(q), tt(k), tt(v)
    got = (twa.fused_window_attention_plain(tq, tk, tv, T(bias), T(mask), n_windows, SCALE),
           *twa.fused_window_attention_backward_plain(tq, tk, tv, T(bias), T(mask), tt(do),
                                                      n_windows, SCALE))
    for i, (name, g, w) in enumerate(zip(("out", "dq", "dk", "dv", "dbias"), got, want)):
        g, w = g.float().numpy(), _f32(w)
        if dtype == np.float32:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=name)
        elif name == "dbias":
            np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(), rtol=0)
        else:
            _hold_bf16(g, w, name == "dk")


def test_packed_and_fused_wrappers_on_cpu():
    """CPU tensors take the plain versions, forward and backward, and launch
    nothing; the mask gets no gradient; refused shapes raise."""
    qkv, bias, mask, do = (T(a) for a in _inputs(4))
    before = dict(_build.launch_counts)
    xg, bg, mg = (t.clone().requires_grad_(True) for t in (qkv, bias, mask))
    twa.packed_window_attention(xg, bg, mg, 4, NH, SCALE).backward(do)
    dqkv, dbias = twa.packed_window_attention_backward_plain(qkv, bias, mask, do, 4, NH, SCALE)
    assert torch.equal(xg.grad, dqkv) and torch.equal(bg.grad, dbias) and mg.grad is None
    q, k, v = (t.clone().requires_grad_(True) for t in qkv.chunk(3, dim=1))
    bg.grad, mg.grad = None, None
    twa.fused_window_attention(q, k, v, bg, mg, 4, SCALE).backward(do)
    want = twa.fused_window_attention_backward_plain(*qkv.chunk(3, dim=1), bias, mask, do, 4,
                                                     SCALE)
    for g, w in zip((q.grad, k.grad, v.grad, bg.grad), want):
        assert torch.equal(g, w)
    assert mg.grad is None and dict(_build.launch_counts) == before
    with pytest.raises(ValueError, match="qkv must be"):
        twa.packed_window_attention(qkv[:, :5], bias, mask, 4, NH, SCALE)
    with pytest.raises(ValueError, match="multiple"):
        twa.packed_window_attention(qkv[:6], bias, mask, 4, NH, SCALE)
    with pytest.raises(ValueError, match="bias"):
        twa.packed_window_attention(qkv, bias[:1], None, 1, NH, SCALE)
    with pytest.raises(ValueError, match="always adds"):
        twa.fused_window_attention(*qkv.chunk(3, dim=1), bias, None, 1, SCALE)


# ---------------------------------------------------------------------------
# The swins that take the packed route
# ---------------------------------------------------------------------------

# Video Swin: C = 32, 64 (packed), 128, 256 (direct); hd = 32
SWIN = dict(embed_dim=32, depths=(2, 2, 1, 1), num_heads=(1, 2, 4, 8), drop_path_rate=0.0)
# the 2D geometry at the same widths: 128 and 256 take the lane window kernel
SWIN2D = dict(SWIN, patch_size=(1, 4, 4), window_size=(1, 7, 7), final_norm=False)
ENC_BERT = dict(BERT, hidden_size=128, num_attention_heads=4, intermediate_size=256)
ROUTES = ("packed_window_attention", "direct_window_attention", "lane_window_attention")


class _Routes:
    """Counts the window-attention entry points called in a package's swin
    (JAX: at trace time; the port: per call), through wrappers that pass
    every argument on."""

    def __init__(self, mp, module):
        self.calls = collections.Counter()
        for name in ROUTES:
            fn = getattr(module, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)

            mp.setattr(module, name, counted)


def _perturbed_init(jm, x, seed):
    """Parameters of ``jm``'s tree drawn on the host (``drawn_params``): the
    ``init`` is traced for its shapes, not compiled."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    return drawn_params(shapes, np.random.RandomState(seed))


def _jax_value_and_grads(jm, params, x, w):
    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        out = out[0] if isinstance(out, tuple) else out
        return jnp.sum(out * w), out

    grads, out = jax.jit(jax.grad(jloss, has_aux=True))(params)
    return np.asarray(out), _np_tree(grads)


def _hold_port(tm, x, w, ref, want_grads):
    out = tm(T(x))
    out = out[0] if isinstance(out, tuple) else out
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2e-4, rtol=1e-3)
    (out * T(w)).sum().backward()
    got = dict(tm.named_parameters())
    for name, p in got.items():
        if p.grad is None:                  # the frame-order embedding: unused
            assert name == "embeds.emb_odr" and not want_grads[name].any()
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), err_msg=name,
                                   **GRAD_TOL)
    return set(got)


def test_video_swin_packed_stages_match_jax(monkeypatch):
    """2 frames of 64^2 (window clamped to (2, 7, 7)): stage 0 (16 x 16,
    padded to 3 x 3 windows) and stage 1 (8 x 8, 2 x 2) run shifted and
    unshifted blocks on the packed kernel in both packages, stages 2 and 3
    (one clamped window) the direct kernel."""
    monkeypatch.setenv("EMVM_PALLAS_INTERPRET", "1")
    jroutes, troutes = _Routes(monkeypatch, jwa), _Routes(monkeypatch, tvs)
    jm = JSwin(config=jcfg.SwinConfig(**SWIN))
    rs = np.random.RandomState(3)
    x = rs.randn(2, 2, 64, 64, 3).astype(np.float32)
    params = _perturbed_init(jm, x, 4)
    w = rs.randn(2, 2, 2, 2, 256).astype(np.float32)
    jroutes.calls.clear()
    ref, jgrads = _jax_value_and_grads(jm, params, x, w)
    tm = SwinTransformer3D(tcfg.SwinConfig(**SWIN))
    tm.load_state_dict(convert.swin3d_state_dict(params, SWIN["depths"]))
    want = convert.swin3d_state_dict(jgrads, SWIN["depths"])
    assert _hold_port(tm, x, w, ref, want) == set(want)
    routes = {"packed_window_attention": 4, "direct_window_attention": 2}
    assert jroutes.calls == troutes.calls == routes


def test_enc_img_swin_packed_stages_match_jax(monkeypatch):
    """The 2D geometry, 4 frames of 64^2: JAX runs its packed kernel in
    stages 0 and 1 on the 4-frame block-diagonal superwindow (off-diagonal
    bias -1e9), the port on each frame's own windows, the same function;
    stages 2 and 3 take the t-sliced lane kernel in JAX and the lane window
    kernel in the port."""
    monkeypatch.setenv("EMVM_PALLAS_INTERPRET", "1")
    jroutes, troutes = _Routes(monkeypatch, jwa), _Routes(monkeypatch, tvs)

    def cfg(c):
        return c.ModelConfig(size_img=64, size_frame=4, vis_backbone="swin2d",
                             temporal_fusion="concat", fusion=c.BertConfig(**ENC_BERT),
                             text=c.BertConfig(**ENC_BERT), swin_custom=c.SwinConfig(**SWIN2D))

    jm = jenc.EncImgSwin(config=cfg(jcfg), fusion="concat")
    rs = np.random.RandomState(5)
    x = rs.randn(2, 4, 64, 64, 3).astype(np.float32)
    params = _perturbed_init(jm, x, 6)
    w = rs.randn(2, 4 * 5, 128).astype(np.float32)
    jroutes.calls.clear()
    ref, jgrads = _jax_value_and_grads(jm, params, x, w)
    tm = EncImgSwin(cfg(tcfg), "concat")
    tm.load_state_dict(convert.enc_img_state_dict(params, prefix=""))
    want = convert.enc_img_state_dict(jgrads, prefix="")
    assert _hold_port(tm, x, w, ref, want) == set(want)
    routes = {"packed_window_attention": 4, "lane_window_attention": 2}
    assert jroutes.calls == troutes.calls == routes


def _model_cfg(c):
    return c.ModelConfig(size_img=64, size_frame=2, size_txt=8, fusion=c.BertConfig(**BERT),
                         text=c.BertConfig(**BERT), swin_custom=c.SwinConfig(**SWIN))


@pytest.fixture(scope="module")
def slice_():
    """The tiny VioletPretrain on the packed-route Video Swin, carrying the
    JAX params, with test_torch_pretrain.py's batch and injected draws."""
    yield from carried_slice(_model_cfg)


@pytest.fixture(scope="module")
def grads(slice_):
    return losses_and_grads(slice_)


def test_weight_carry_round_trip_of_the_packed_swin_tree(slice_):
    params, tm = slice_["params"], slice_["tm"]
    sd = convert.state_dict_from_flax(params, tm.config, HEADS)
    assert set(sd) == set(tm.state_dict())
    back = violet_params_from_torch({k: v.numpy() for k, v in sd.items()},
                                    slice_["jm"].config, heads=HEADS)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_packed_swin_losses_and_gradients_match_jax(grads):
    ls, jls, got, want, no_grad = grads
    assert set(ls) == {"mtm", "vtm", "mvm_pixel", "total"} == set(jls)
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)
    assert set(got) == set(want)
    # the packed backward reaches the swin: only the unused frame-order
    # embedding has no gradient
    assert no_grad == {"enc_img.emb_odr"}
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_packed_swin_two_train_steps_match_make_pretrain_train_step(slice_, grads):
    """As ``test_two_train_steps_match_make_pretrain_train_step`` of
    test_torch_pretrain.py, on the packed-route swin. Its stages of 64 to
    256 channels hold about 1.4 million resolved elements, and a few whose
    step-1 gradient nearly cancels move by up to +-lr on either side
    whatever their step-0 gradient (27 read, 1e-5 at most): at most 1e-4 of
    the resolved elements may exceed 2e-6, as in test_torch_swin2d.py."""
    assert_two_steps_match(slice_, grads, HEADS, outliers=1e-4)


@pytest.mark.parametrize("size", ["tiny", "small", "violet"])
def test_c96_backbone_sizes_take_the_packed_route(monkeypatch, size):
    """configs/pretrain.json with ``vis_backbone_size`` replaced builds the
    reference's C = 96 Video Swin (violet: ``swin_violet.py``, embed 96,
    depths 2/2/18/2, heads 3/6/12/24, num_features 768, so EncVideo has no
    projection); its stage-0 and stage-1 blocks take the packed kernel and
    stages 2-3 the direct kernel (checked at the real widths with one block
    in stages 2-3 on 2 frames of 64^2)."""
    run = tcfg.load_run_config("configs/pretrain.json")
    model = dataclasses.replace(run.model, vis_backbone_size=size)
    swin = model.swin
    depths = {"tiny": (2, 2, 6, 2)}.get(size, (2, 2, 18, 2))
    assert (swin.embed_dim, swin.depths, swin.num_heads, swin.num_features,
            swin.window_size) == (96, depths, (3, 6, 12, 24), 768, (8, 7, 7))
    tiny_bert = tcfg.BertConfig(**BERT)
    cut = dataclasses.replace(model, fusion=dataclasses.replace(tiny_bert, hidden_size=768,
                                                                 num_attention_heads=12),
                              text=dataclasses.replace(tiny_bert, hidden_size=768,
                                                       num_attention_heads=12),
                              swin_custom=dataclasses.replace(swin, depths=(2, 2, 1, 1)))
    m = VioletPretrain.from_run_config(dataclasses.replace(run, model=cut), device="cpu")
    assert m.enc_img.fc is None and m.enc_img.swin.layers[0].blocks[0].attn.num_heads == 3
    routes = _Routes(monkeypatch, tvs)
    with torch.no_grad():
        out = m.enc_img.swin(torch.zeros(1, 2, 64, 64, 3))
    assert out.shape == (1, 2, 2, 2, 768)
    assert routes.calls == {"packed_window_attention": 4, "direct_window_attention": 2}
