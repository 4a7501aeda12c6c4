"""Every configuration, traffic mix, limit and metric file loads and names
real parts of the benchmark and of the program."""

import json

import pytest

from portbench.harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_parts_load(name):
    cell = spec.load_cell(name)
    assert cell.traffic["entry"] in ("pretrain_step", "supervised_step", "retrieval_eval")
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader(metric):
    assert callable(spec.reader(metric))


@pytest.mark.parametrize("metric", [m for m in BENCH["per_layer"]], ids=lambda m: m["name"])
def test_moves_a_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = e2e[metric["moves"]]
    for w in metric["workloads"]:
        assert "workloads" not in moved or w in moved["workloads"]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_the_programs(cfg):
    """The run configuration loads in the program, and the sizes the
    reference builds from are the ones the program builds."""
    from empirical_mvm_torch.core.config import load_run_config
    from empirical_mvm_torch.models.encoders2d import swin2d_config
    config = json.loads((spec.ROOT / cfg["file"]).read_text())
    assert config["name"] == cfg["name"] and config["reduced"] == cfg["reduced"]
    run = load_run_config(dict(config["run"]))
    dims = config["dims"]
    swin = run.model.swin
    for key in ("embed_dim", "drop_path_rate", "final_norm"):
        assert getattr(swin, key) == dims["swin"][key]
    for key in ("patch_size", "depths", "num_heads", "window_size"):
        assert list(getattr(swin, key)) == dims["swin"][key]
    for part in ("fusion", "text"):
        for key, value in dims[part].items():
            assert getattr(getattr(run.model, part), key) == value
    assert run.model.size_patch == dims["size_patch"]
    assert run.model.max_size_patch == dims["max_size_patch"]
    assert run.model.max_size_frame == dims["max_size_frame"]
    if "teacher" in dims:
        assert run.train.mvm_target == ("2d_feature",)
        t = swin2d_config("base")
        assert t.embed_dim == dims["teacher"]["embed_dim"]
        assert list(t.window_size) == dims["teacher"]["window_size"]
        assert list(t.patch_size) == dims["teacher"]["patch_size"]
        assert list(t.depths) == dims["teacher"]["depths"]
        assert t.final_norm == dims["teacher"]["final_norm"]


def test_paths_hold_only_the_benchmark():
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
