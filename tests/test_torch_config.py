"""The port's config loader against the JAX package's: every task file in
``configs/`` gives the same value for every field the port keeps, and a key
the port does not know (such as a JAX-only switch) raises."""

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
    {"fsdp": True},
    {"profile_n_steps": 3},
    {"fusion": {"scan": True}},
    {"text": {"use_pallas_attention": False}},
    {"swin_custom": {"remat": True}},
], ids=["fsdp", "profile_n_steps", "fusion.scan", "text.use_pallas_attention",
        "swin_custom.remat"])
def test_unknown_key_raises(raw):
    with pytest.raises(ValueError, match="unknown"):
        tcfg.load_run_config(raw)
