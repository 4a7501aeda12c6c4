"""The port's HOG target (``empirical_mvm_torch/ops/hog.py``) against the
JAX ``ops/hog.py`` on the CPU, fp32.

A pixel whose gradient angle lies within rounding of a bin edge could fall
in the other bin in the other package (``atan2`` and the division may
differ in their last bit), which moves its cell's rendering by about
magnitude / 64, far above the 1e-5 limit here. On these seeded clips no
pixel does: the share of such pixels is 0, and the rendered images agree to
fp32 summation order.
"""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax.numpy as jnp

from empirical_mvm_tpu.ops import hog as jhog
from empirical_mvm_torch.ops import hog as thog
from empirical_mvm_torch.ops.preprocess import normalize_uint8


def test_line_templates_equal_jax():
    for cell, orientations in ((8, 9), (16, 9), (8, 6)):
        np.testing.assert_array_equal(thog._line_templates(cell, orientations),
                                      jhog._line_templates(cell, orientations))


@pytest.mark.parametrize("clips", ["uint8_normalized", "gaussian"])
def test_hog_image_matches_jax(clips):
    """(2, 2, 64, 64, 3) seeded clips: the ImageNet-normalized uint8 clips
    the pretrain step feeds it, and Gaussian noise."""
    rs = np.random.RandomState(0)
    if clips == "gaussian":
        x = torch.from_numpy(rs.randn(2, 2, 64, 64, 3).astype(np.float32))
    else:
        x = normalize_uint8(torch.from_numpy(rs.randint(0, 256, (2, 2, 64, 64, 3))
                                             .astype(np.uint8)))
    want = np.asarray(jhog.hog_image(jnp.asarray(x.numpy())))
    got = thog.hog_image(x).numpy()
    assert got.shape == want.shape == (2, 2, 64, 64) and got.dtype == np.float32
    diff = np.abs(got - want)
    assert (diff > 1e-5).mean() == 0.0, "pixels in another bin"
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    bins, mag = thog.hog_bins(x)
    assert bins.min() >= 0 and bins.max() <= 8 and (mag >= 0).all()


def test_hog_image_refuses_partial_cells():
    with pytest.raises(ValueError):
        thog.hog_image(torch.zeros(1, 60, 64, 3))
