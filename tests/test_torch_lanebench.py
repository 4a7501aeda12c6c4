"""The port's lanebench tool and its kernel's plain version (row 12,
``empirical_mvm_torch/tools/lanebench.py``, ``ops/window_attention.py``
``lane_attention``) against the JAX ``tools/lanebench.py`` on the CPU.

The JAX tool is loaded by path. Importing it points JAX's persistent
compilation cache at a directory of its own; the fixture puts both cache
settings back, so that later test files in the same worker see what they
saw before. The JAX ``lane_attention`` (a Pallas kernel) and
``packed_path`` (which passes ``interpret=False``) run inside
``pltpu.force_tpu_interpret_mode()``. Limits: fp32 atol 1e-5 (summation
order); bf16 one bf16 step of the JAX output (1e-5 + 2^-7 of it), the
kernel's roundings being the same.
"""

import importlib.util

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from empirical_mvm_torch.ops import window_attention as twa
from empirical_mvm_torch.tools import lanebench as tlb

CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
FP32 = dict(atol=1e-5, rtol=0)
BF16_STEP = dict(atol=1e-5, rtol=2.0 ** -7)
B_, N, C, NH, G = 8, 49, 64, 2, 2


@pytest.fixture(scope="module")
def jlb():
    before = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location("jax_lanebench", "tools/lanebench.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
    return mod


def _inputs(nw, seed=0):
    rs = np.random.RandomState(seed)
    x3 = (rs.randn(B_, N, 3 * C) * 0.5).astype(np.float32)
    bias = (rs.randn(NH, N, N) * 0.1).astype(np.float32)
    mask = np.where(rs.rand(nw, N, N) < 0.3, -100.0, 0.0).astype(np.float32)
    return x3, bias, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nw", [4, 1])
def test_lane_attention_matches_the_jax_kernel(jlb, dtype, nw):
    """(8, 49, 192), nH 2, a shift-like mask of nW = 4 windows or one mask
    for every window: the port's plain version against the JAX Pallas
    kernel in interpret mode."""
    x3, bias, mask = _inputs(nw)
    scale = (C // NH) ** -0.5
    jx = jnp.asarray(x3, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jlb.lane_attention(jx, jnp.asarray(bias), jnp.asarray(mask), NH,
                                             scale, G).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tlb.lane_attention(tx, torch.from_numpy(bias), torch.from_numpy(mask), NH, scale, G)
    assert got.dtype == tx.dtype and got.shape == (B_, N, C)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(FP32 if dtype == "float32" else BF16_STEP))


def test_lane_attention_scales_the_scores_not_q(jlb):
    """In bf16 row 12 (scale on the fp32 scores) and row 7 (q scaled in
    bf16) are different functions: the plain version of row 12 is the JAX
    kernel's and not lane_window_attention's."""
    x3, bias, mask = _inputs(4, seed=1)
    scale = (C // NH) ** -0.5
    xb = torch.from_numpy(x3).bfloat16()
    row12 = twa.lane_attention_reference(xb, torch.from_numpy(bias), torch.from_numpy(mask),
                                         NH, scale)
    row7 = twa.lane_window_attention_reference(xb, torch.from_numpy(bias),
                                               torch.from_numpy(mask), 4, NH, scale)
    assert not torch.equal(row12, row7)
    x32 = xb.float()
    np.testing.assert_allclose(
        twa.lane_attention_reference(x32, torch.from_numpy(bias), torch.from_numpy(mask), NH,
                                     scale).numpy(),
        twa.lane_window_attention_reference(x32, torch.from_numpy(bias),
                                            torch.from_numpy(mask), 4, NH, scale).numpy(),
        **FP32)


def test_packed_path_and_oracle_match_jax(jlb):
    x3, bias, mask = _inputs(4, seed=2)
    scale = (C // NH) ** -0.5
    jx, jb, jm = jnp.asarray(x3, jnp.bfloat16), jnp.asarray(bias), jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        want_p = np.asarray(jlb.packed_path(jx, jb, jm, NH, scale).astype(jnp.float32))
    want_o = np.asarray(jlb.oracle(jx, jb, jm, NH, scale))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    tb, tm = torch.from_numpy(bias), torch.from_numpy(mask)
    got_p = tlb.packed_path(tx, tb, tm, NH, scale)
    assert got_p.dtype == torch.bfloat16
    np.testing.assert_allclose(got_p.float().numpy(), want_p, **BF16_STEP)
    np.testing.assert_allclose(tlb.oracle(tx, tb, tm, NH, scale).numpy(), want_o,
                               atol=1e-6, rtol=1e-5)


def test_lane_attention_checks_the_tools_block_rule():
    x3, bias, mask = (torch.from_numpy(a) for a in _inputs(4))
    with pytest.raises(ValueError):
        tlb.lane_attention(x3, bias, mask, NH, 0.1, 3)          # 3 divides neither
    with pytest.raises(RuntimeError, match="forward only"):
        twa.lane_attention(x3.requires_grad_(True), bias, mask, NH, 0.1)


def test_main_runs_a_cut_stage_on_the_cpu(monkeypatch, capsys):
    """``main`` on the CPU at stage 0 cut to (8, 49, 192), nH 2, nW 4, with
    ``--grad``: the JAX tool's lines, and each path within the bf16
    attention limit of the oracle (chip_smoke's BF16_VS_FP32, 5e-3)."""
    monkeypatch.setitem(tlb.SHAPES, 0, dict(b_=B_, n=N, c=C, nh=NH, nw=4, g=G))
    recs = tlb.main(["--device", "cpu", "--stage", "0", "--grad"])
    out = capsys.readouterr().out
    assert f"stage0 B_={B_} N={N} C={C} nH={NH}: lane " in out and "  grad: lane " in out
    (rec,) = recs
    assert rec["err_lane"] < 5e-3 and rec["err_packed"] < 5e-3
    assert all(rec[k] > 0 for k in ("lane_ms", "packed_ms", "grad_lane_ms", "grad_packed_ms"))
