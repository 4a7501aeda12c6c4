"""Every module of the port, chip_smoke.py and the data-parallel tests'
rank worker (``tests/dp_worker.py``) import with ``jax`` and
the JAX package blocked, and leaves ``empirical_mvm_tpu`` out of
``sys.modules``; none imports msgpack, cv2, PIL, yaml or transformers when
it is imported (the port depends on none of them; its checkpoints go
through its own msgpack codec)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "empirical_mvm_tpu", "cv2", "PIL",
           "yaml", "transformers")

SCRIPT = """
import importlib, importlib.abc, json, pkgutil, sys
BLOCKED = %r

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import empirical_mvm_torch
names = ["empirical_mvm_torch"] + [m.name for m in pkgutil.walk_packages(
    empirical_mvm_torch.__path__, "empirical_mvm_torch.")]
failed = {}
for name in names + ["chip_smoke", "tests.dp_worker"]:
    try:
        importlib.import_module(name)
    except Exception as e:
        failed[name] = repr(e)
print(json.dumps({"modules": names, "failed": failed,
                  "loaded": sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)}))
"""


@pytest.fixture(scope="module")
def imported():
    res = subprocess.run([sys.executable, "-c", SCRIPT % (BLOCKED,)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_every_port_module_imports_without_jax(imported):
    assert not imported["failed"], imported["failed"]
    assert {"empirical_mvm_torch.data.loader", "empirical_mvm_torch.data.jpeg",
            "empirical_mvm_torch.data.datasets", "empirical_mvm_torch.data.composite",
            "empirical_mvm_torch.tools.loaderbench"} <= set(imported["modules"])


def test_no_blocked_package_enters_sys_modules(imported):
    assert imported["loaded"] == []


def test_the_parallel_layer_and_the_rank_worker_import_without_jax(imported):
    """The data-parallel layer and the worker the gloo tests spawn (which
    runs without the test suite's conftest) load with JAX blocked."""
    assert "empirical_mvm_torch.parallel.mesh" in imported["modules"]
    assert "tests.dp_worker" not in imported["failed"]
    assert not any(m.startswith("empirical_mvm_tpu") for m in imported["loaded"])
