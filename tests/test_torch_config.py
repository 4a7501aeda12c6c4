"""The port's config loader against the JAX package's: every task file in
``configs/`` gives the same value for every field the port keeps, a key the
port does not know (such as a JAX-only switch) raises, and
``profile_n_steps`` loads as in JAX."""

import dataclasses
import glob
import os

import pytest

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_torch.core import config as tcfg

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                        "configs", "*.json")))


def _assert_same(port, ref, path):
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):
            _assert_same(got, want, f"{path}.{f.name}")
        else:
            assert got == want, f"{path}.{f.name}: {got!r} != {want!r}"


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_task_config_loads_as_in_the_jax_package(path):
    port, ref = tcfg.load_run_config(path), jcfg.load_run_config(path)
    _assert_same(port, ref, "run")
    _assert_same(port.model.swin, ref.model.swin, "run.model.swin")


@pytest.mark.parametrize("raw", [
    {"fusion": {"scan": True}},
    {"text": {"use_pallas_attention": False}},
    {"swin_custom": {"scan": True}},
    {"remat": True},
    {"grad_accum": 2},
], ids=["fusion.scan", "text.use_pallas_attention", "swin_custom.scan", "remat",
        "grad_accum"])
def test_unknown_key_raises(raw):
    with pytest.raises(ValueError, match="unknown"):
        tcfg.load_run_config(raw)


@pytest.mark.parametrize("raw", [
    {"fsdp": True},
    {"fsdp_min_size": 1024},
    {"swin_custom": {"remat": True}},
    {"fusion": {"remat": True}, "text": {"remat": True}},
], ids=["fsdp", "fsdp_min_size", "swin_custom.remat", "bert.remat"])
def test_parallel_keys_load_as_in_the_jax_package(raw):
    """The data-parallel and remat keys the JAX package accepts load into
    the same fields (``grad_accum`` is a key of neither package)."""
    port, ref = tcfg.load_run_config(raw), jcfg.load_run_config(raw)
    _assert_same(port.train, ref.train, "run.train")
    for name in ("fusion", "text", "swin"):
        assert getattr(port.model, name).remat == getattr(ref.model, name).remat, name


def test_profile_n_steps_loads_as_in_the_jax_package():
    """``profile_n_steps`` has a field again: the run loop's profiler window
    (``train/agent.py``)."""
    port, ref = (c.load_run_config({"profile_n_steps": 3}) for c in (tcfg, jcfg))
    assert port.train.profile_n_steps == ref.train.profile_n_steps == 3
