"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names compared
whole (the program's name begins with the JAX package's)."""

import json
import subprocess
import sys

from portbench.harness import spec

JAX = {"jax", "jaxlib", "flax", "optax", "empirical_mvm_tpu"}


def loaded_top_names(code: str) -> set[str]:
    prog = (f"import sys, json; sys.path.insert(0, {str(spec.ROOT)!r}); {code}; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         check=True, cwd=spec.ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = loaded_top_names(
        "import portbench.run, portbench.control; "
        "from portbench.harness import measure, entries, check, inputs, work, trace; "
        "from portbench.harness.entries import ENTRIES; "
        "import empirical_mvm_torch.models.pretrain, empirical_mvm_torch.models.tasks, "
        "empirical_mvm_torch.train.train_step, empirical_mvm_torch.train.evaluators, "
        "empirical_mvm_torch.train.optimizer")
    assert not names & JAX
    assert "empirical_mvm_torch" in names


def test_reference_loads_no_program():
    names = loaded_top_names("import portbench.reference.model, portbench.reference.steps")
    assert not names & (JAX | {"empirical_mvm_torch"})
