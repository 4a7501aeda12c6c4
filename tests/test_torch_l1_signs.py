"""``chip_smoke.SameL1Signs``, the whole-step check's handling of the L1
losses, on the CPU: where one masked element's error pred - target lies on
the other side of 0 on the second side, that side's gradient differs from
the first's by 2 / (sum(mask) channel_div) at that element; under
``SameL1Signs`` it takes the first side's sign there, so the two gradients
are equal (exactly), its loss value is the real one (exactly), and the
flip is counted among the masked elements only."""

import pytest
import torch

from chip_smoke import SameL1Signs
from empirical_mvm_torch.models import pretrain as pretrain_module
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)


def _case(shape, mask_shape, seed=0):
    """Seeded pred and target, a {0, 1} mask covering about half the
    elements, and the second side's pred: the first's with one masked
    element's error turned from +1e-6 to -1e-6 and one unmasked element's
    error negated."""
    gen = torch.Generator().manual_seed(seed)
    target = torch.randn(shape, generator=gen)
    pred = torch.randn(shape, generator=gen)
    mask = (torch.rand(mask_shape, generator=gen) < 0.5).float()
    covered = torch.broadcast_to(mask > 0, shape).flatten()
    on = int(covered.nonzero()[0])
    off = int((~covered).nonzero()[0])
    flat_t, flat_p = target.flatten(), pred.flatten()
    flat_p[on] = flat_t[on] + 1e-6
    other = flat_p.clone()
    other[on] = flat_t[on] - 1e-6
    other[off] = 2 * flat_t[off] - flat_p[off]
    return (target, flat_p.reshape(shape), other.reshape(shape), mask,
            int(torch.broadcast_to(mask > 0, shape).sum()))


def _loss_and_grad(pred, target, mask, channel_div):
    leaf = pred.clone().requires_grad_(True)
    loss = pretrain_module.masked_l1(leaf, target, mask, channel_div=channel_div)
    loss.backward()
    return loss.item(), leaf.grad


@pytest.mark.parametrize("shape, mask_shape, channel_div", [
    ((2, 2, 4, 4, 3), (2, 2, 4, 4, 1), 3.0),    # the pixel target: a mask over pixels
    ((2, 2, 4, 4), (2, 2, 4, 4), 1.0),          # the hog target: a mask of its own shape
])
def test_same_l1_signs_gives_the_cpu_the_cards_sign(shape, mask_shape, channel_div):
    target, pred_card, pred_cpu, mask, masked = _case(shape, mask_shape)
    _, g_plain = _loss_and_grad(pred_cpu, target, mask, channel_div)
    signs = SameL1Signs()
    with signs.side("card"):
        _, g_card = _loss_and_grad(pred_card, target, mask, channel_div)
    with signs.side("cpu"):
        loss_cpu, g_cpu = _loss_and_grad(pred_cpu, target, mask, channel_div)
    real = pretrain_module.masked_l1(pred_cpu, target, mask, channel_div=channel_div).item()
    # without it, the flipped element's gradient is one sign step apart
    step = 2.0 / (mask.sum().item() + 1e-5) / channel_div
    assert (g_plain - g_card).abs().max().item() == pytest.approx(step, rel=1e-6)
    assert torch.equal(g_cpu, g_card)
    assert loss_cpu == real
    (call,) = signs.flips
    assert call["flips"] == 1 and call["masked"] == masked
    apart = ((pred_card - target) - (pred_cpu - target)).abs()
    assert call["apart_max"] == apart[torch.broadcast_to(mask > 0, shape)].max().item()
