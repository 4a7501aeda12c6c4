"""``am`` masking in the port against the JAX package on the CPU, fp32, inputs
from numpy with a seed: the attention rollout (``get_att``) of the tiny
pretrain slice of ``tests/test_torch_pretrain.py``, the ``am`` draw on the
JAX package's own Gumbel noise and ``apply_masking`` on its draws (exactly
equal), the draws' properties, and the ``am`` pretrain step's losses and
gradients under injected draws.

The JAX draws come from its own key schedule (``apply_masking`` splits its
key in five; ``am`` takes the fifth, ``jax.random.gumbel`` of the scores'
shape). Tolerances: the rollout within rtol 1e-5 (fp32 softmax sums over
2 layers and 18 queries); the losses, gradients and steps those of
``tests/test_torch_pretrain.py``.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from chip_smoke import AM_SPEARMAN, spearman
from empirical_mvm_tpu.data import masking as jmask
from empirical_mvm_torch.data import masking as tmask
from empirical_mvm_torch.ops.preprocess import maybe_normalize
from tests.test_torch_pretrain import (LOSS_TOL, _model_cfg, _t, carried_slice, drawn_params,
                                       losses_and_grads)

MASK_KW = dict(special_token_ids=(101, 102, 0), mask_token_id=103)
AM_MASKS = ("am", "rm")
T_, H_, W_ = 2, 3, 3                      # the draws' grid: 2 frames of 3 x 3 patches
DRAWS = 512                               # draws of one row for the selection frequencies


def _text(rs, b, x=12):
    txt = rs.randint(104, 500, (b, x)).astype(np.int32)
    txt[:, 0], txt[:, 9], txt[:, 10:] = 101, 102, 0
    txt[1, 4] = 103
    return txt


def _specials(txt, t, h, w, vq=None):
    spc = tmask.special_tokens(torch.from_numpy(txt), **MASK_KW)
    return tmask.am_special(spc, t, h, w, None if vq is None else torch.from_numpy(vq))


def _vq(rs, b, t, hw):
    vq = rs.randint(0, 100, (b, t * (1 + hw))).astype(np.int32)
    vq.reshape(b, t, 1 + hw)[:, :, 0] = -1
    vq[0, 3] = -1                         # a patch without a token is special too
    return vq


@pytest.mark.parametrize("with_vq", [False, True])
def test_am_draw_matches_jax_on_its_gumbel_noise(with_vq):
    """``am_cov_and_text`` given ``jax.random.gumbel``'s noise for the key
    JAX's ``_am_cov_and_text`` draws from: the cover and the text selection
    exactly equal; the special slots (each frame's CLS, or the vq tokens
    -1, the special and [MASK] text) never selected."""
    rs = np.random.RandomState(0)
    b, x = 5, 12
    l = T_ * (1 + H_ * W_) + x
    scores = np.exp(rs.randn(b, l)).astype(np.float32)
    txt = _text(rs, b, x)
    vq = _vq(rs, b, T_, H_ * W_) if with_vq else None
    spc = _specials(txt, T_, H_, W_, vq)
    key = jax.random.PRNGKey(4)
    cov, sel = jmask._am_cov_and_text(key, jnp.asarray(scores), jnp.asarray(spc.numpy()),
                                      T_, H_, W_, x, 0.3)
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(key, (b, l))))
    got_cov, got_sel = tmask.am_cov_and_text(torch.from_numpy(scores), spc, noise, T_, H_, W_,
                                             x, 0.3)
    np.testing.assert_array_equal(got_cov.numpy(), np.asarray(cov))
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(sel))
    assert not (got_sel & spc[:, T_ * (1 + H_ * W_):]).any()
    if with_vq:
        assert got_cov[0, 0].flatten()[2] == 0          # vq[0, 3] is -1: patch 2 of frame 0


@pytest.mark.parametrize("with_vq", [False, True])
def test_apply_masking_with_am_matches_jax_given_its_draws(with_vq):
    """The JAX ``apply_masking`` with ("am", "rm") against the port's on
    the draws of its own key schedule (a text selection per mask type, as
    ``MaskDraws`` holds it with ``am``): masked pixels, text, the MTM and
    vq answers, both covers, exactly equal."""
    rs = np.random.RandomState(1)
    b, hh = 6, 96
    img = rs.rand(b, T_, hh, hh, 3).astype(np.float32)
    txt = _text(rs, b)
    l = T_ * (1 + H_ * W_) + txt.shape[1]
    scores = np.exp(rs.randn(b, l)).astype(np.float32)
    vq = _vq(rs, b, T_, H_ * W_) if with_vq else None
    key = jax.random.PRNGKey(3)
    ref = jmask.apply_masking(key, jnp.asarray(img), jnp.asarray(txt),
                              None if vq is None else jnp.asarray(vq), patch_size=32,
                              p_mask=0.3, mask_types=AM_MASKS, att_scores=jnp.asarray(scores),
                              **MASK_KW)
    k_choice, k_txt, k_rm, _, k_am = jax.random.split(key, 5)
    choice = jax.random.randint(k_choice, (b,), 0, 2)
    spc_txt = tmask.special_tokens(torch.from_numpy(txt), **MASK_KW)
    shared = jmask._text_mask(k_txt, jnp.asarray(txt), jnp.asarray(spc_txt.numpy()), 0.3)
    rm = jmask._rm_video_cov(k_rm, b, T_, H_, W_, 0.3)
    noise = torch.from_numpy(np.asarray(jax.random.gumbel(k_am, (b, l))))
    am_cov, am_sel = tmask.am_cov_and_text(torch.from_numpy(scores),
                                           _specials(txt, T_, H_, W_, vq), noise, T_, H_, W_,
                                           txt.shape[1], 0.3)
    draws = tmask.MaskDraws(torch.from_numpy(np.asarray(choice).astype(np.int64)),
                            torch.stack([am_cov, torch.from_numpy(np.asarray(rm))]),
                            torch.stack([am_sel, torch.from_numpy(np.array(shared))]))
    out = tmask.apply_masking(draws, torch.from_numpy(img), torch.from_numpy(txt),
                              None if vq is None else torch.from_numpy(vq), mask_token_id=103,
                              patch_size=32)
    assert set(np.asarray(choice).tolist()) == {0, 1}
    for name in ("img", "txt", "ans_mtm", "ans_mvm", "mvm_mask", "cov"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_am_draws_mask_k_slots_none_special_and_follow_the_scores():
    """``draw_masks`` with ``am``: every row masks exactly k = max(floor(L
    p), 1) slots, none special; over ``DRAWS`` draws of one row on scores
    exp(U(-3, 3)), the non-special slots' selection frequency ranks as
    their scores (Spearman's rho at least chip_smoke.py's ``AM_SPEARMAN``,
    its limit for the same check on the card); ``am`` without scores
    raises."""
    gen = torch.Generator().manual_seed(0)
    b, t, h, w, p = 8, 4, 7, 7, 0.15
    txt = torch.randint(104, 500, (b, 32), generator=gen)
    txt[:, 0], txt[:, 20], txt[:, 21:] = 101, 102, 0
    l = t * (1 + h * w) + 32
    k = max(int(l * p), 1)
    scores = torch.exp(torch.empty(b, l).uniform_(-3, 3, generator=gen))
    d = tmask.draw_masks(gen, txt, t, h, w, p_mask=p, mask_types=("am",), att_scores=scores,
                         **MASK_KW)
    assert d.txt_sel.shape == (1, b, 32)
    spc = tmask.special_tokens(txt, **MASK_KW)
    assert (d.covs[0].sum((1, 2, 3)) + d.txt_sel[0].sum(1) == k).all()
    assert not (d.txt_sel[0] & spc).any()
    rows = scores[:1].expand(DRAWS, l)
    dr = tmask.draw_masks(gen, txt[:1].expand(DRAWS, -1), t, h, w, p_mask=p,
                          mask_types=("am",), att_scores=rows, **MASK_KW)
    video = torch.cat([torch.zeros(DRAWS, t, 1), dr.covs[0].reshape(DRAWS, t, -1)], 2)
    freq = torch.cat([video.reshape(DRAWS, -1), dr.txt_sel[0].float()], 1).mean(0).numpy()
    keep = ~tmask.am_special(spc[:1], t, h, w)[0].numpy()
    rho = spearman(freq[keep], scores[0].numpy()[keep])
    assert rho >= AM_SPEARMAN, rho
    with pytest.raises(ValueError, match="att_scores"):
        tmask.draw_masks(gen, txt, t, h, w, mask_types=("am", "rm"), **MASK_KW)


@pytest.fixture(scope="module")
def am_slice():
    """The tiny pixel slice with ``pretrain_masks`` ("am", "rm"), its draws
    (``am`` on seeded scores) injected on both sides, its weights drawn on
    the host (``drawn_params``)."""
    yield from carried_slice(_model_cfg, pretrain_masks=AM_MASKS,
                             drawn=lambda shapes: drawn_params(shapes, np.random.RandomState(2)))


def test_rollout_matches_jax_get_att(am_slice):
    """``get_att`` (the deterministic pass, every layer's probabilities out
    of the plain attention, mean over heads summed over layers and queries)
    against JAX's on the unmasked batch; the plain attention's output is the
    fusion's own."""
    jm, params, tm = am_slice["jm"], am_slice["params"], am_slice["tm"]
    args = am_slice["args"]
    want = jax.jit(lambda p: jm.apply({"params": p}, *args, method=jm.get_att))(params)
    b = _t(am_slice["batch"])
    got = tm.get_att(maybe_normalize(b["img"]), b["txt"], b["mask"])
    assert got.shape == (4, 2 * 5 + 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    feat = torch.randn(4, 18, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        x, probs = tm.trsfr(feat, output_attentions=True)
        assert len(probs) == 2 and probs[0].shape == (4, 4, 18, 18)
        torch.testing.assert_close(probs[1].sum(-1), torch.ones(4, 4, 18))
        torch.testing.assert_close(x, tm.trsfr(feat), atol=1e-6, rtol=1e-5)


def test_am_step_matches_jax_under_injected_draws(am_slice):
    """The ``am`` step's losses and every gradient against JAX's ``losses``
    (which runs its rollout, then the injected draws), held as in
    ``tests/test_torch_pretrain.py``; the update after them is every pixel
    slice's."""
    ls, jls, got, want, _ = losses_and_grads(am_slice)
    assert set(ls) == {"mtm", "vtm", "mvm_pixel", "total"} == set(jls)
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, atol=2e-4,
                                   rtol=1e-3)


def test_step_runs_the_rollout_only_to_draw(am_slice, monkeypatch):
    """Without injected draws the step's ``losses`` runs the rollout once
    (on the normalized, unmasked clip) and draws ``am`` and ``rm`` from the
    mask generator; with injected draws it runs none."""
    tm = am_slice["tm"]
    calls = []
    get_att = tm.get_att
    monkeypatch.setattr(tm, "get_att", lambda img, txt, mask: calls.append(img.dtype)
                        or get_att(img, txt, mask))
    b = _t(am_slice["batch"])
    with torch.no_grad():
        drawn = tm.losses(b["img"], b["txt"], b["mask"],
                          mask_generator=torch.Generator().manual_seed(5))
        assert calls == [torch.float32]
        tm.losses(b["img"], b["txt"], b["mask"], draws=am_slice["draws"],
                  neg_idx=am_slice["neg_idx"])
    assert calls == [torch.float32]
    assert all(np.isfinite(v.item()) for v in drawn.values())
