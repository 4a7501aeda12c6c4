"""Rematerialisation (``remat`` on ``SwinConfig`` and ``BertConfig``) on the
CPU in fp32: each swin block and BERT layer recomputed in the backward.

With dropout and drop path at 0.1, drawn from the step's explicit
generator, the pass with remat is the pass without it bit for bit: the
losses, every gradient, and the generator's state after the backward (the
recompute replays the block's draws from its entry state and then puts the
generator back). At rate 0, the tiny pixel slice with remat in both
packages (JAX ``nn.remat``) against JAX, at ``test_torch_pretrain.py``'s
tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models.pretrain import VioletPretrain
from empirical_mvm_torch.train.train_step import step_generators
from tests.test_torch_pretrain import (BERT, GRAD_TOL, LOSS_TOL, SWIN, _batch, _t,
                                       carried_slice, losses_and_grads)


def _cfg(c, remat=True, rate=0.0):
    bert = dict(BERT, hidden_dropout_prob=rate, attention_probs_dropout_prob=rate, remat=remat)
    return c.ModelConfig(size_img=64, size_frame=2, size_txt=8, fusion=c.BertConfig(**bert),
                         text=c.BertConfig(**bert),
                         swin_custom=c.SwinConfig(**dict(SWIN, drop_path_rate=rate, remat=remat)))


def _pass(remat: bool):
    """Losses, gradients and the dropout generator's state after one
    training pass at rates 0.1."""
    model = VioletPretrain(_cfg(tcfg, remat, 0.1), device="cpu", seed=1)
    assert model.trsfr.remat == remat and model.enc_img.swin.layers[0].remat == remat
    b = _t(_batch())
    drop, masks = step_generators(5, 0, "cpu")
    ls = model.losses(b["img"], b["txt"], b["mask"], generator=drop, mask_generator=masks)
    ls["total"].backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return {k: v.detach() for k, v in ls.items()}, grads, drop.get_state()


def test_remat_is_bit_equal_to_no_remat_with_dropout_on():
    (ls0, g0, s0), (ls1, g1, s1) = _pass(False), _pass(True)
    assert set(ls0) == set(ls1) and all(torch.equal(ls0[k], ls1[k]) for k in ls0)
    assert set(g0) == set(g1) and len(g0) > 50
    for name, g in g0.items():
        assert torch.equal(g, g1[name]), name
    assert torch.equal(s0, s1)
    assert not torch.equal(s0, step_generators(5, 0, "cpu")[0].get_state())


@pytest.fixture(scope="module")
def remat_slice():
    """The tiny pixel slice with remat in both packages, rates 0."""
    yield from carried_slice(_cfg)


def test_remat_matches_jax_remat(remat_slice):
    """The swin blocks and the BERT fusion's layers under remat in both
    packages: losses and every gradient against JAX."""
    assert remat_slice["jm"].config.swin.remat and remat_slice["jm"].config.fusion.remat
    ls, jls, got, want, _ = losses_and_grads(remat_slice)
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD_TOL)


def test_remat_reaches_the_blocks_from_the_config():
    """Off by default; on, every swin stage (of the Video Swin and of the
    trained 2D backbone, ``EncImgSwin``) and the fusion recompute."""
    assert not tcfg.SwinConfig().remat and not tcfg.BertConfig().remat
    for backbone in ("vidswin", "swin2d"):
        cfg = dataclasses.replace(_cfg(tcfg), vis_backbone=backbone,
                                  temporal_fusion="vidswin" if backbone == "vidswin"
                                  else "concat")
        model = VioletPretrain(cfg, device="cpu")
        assert all(layer.remat for layer in model.enc_img.swin.layers), backbone
        assert model.trsfr.remat
