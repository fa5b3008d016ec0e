"""BENCHMARK.json and the files it names, against the benchmark's contract:
names, units, keys and bounds; every configuration, cell, entry and metric
found by name; every per-layer metric reported where its end-to-end
metric is; nothing loaded or imported from JAX or the JAX package."""
import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import core

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/")
    assert (ROOT / BENCH["command"][1]).is_file()


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for group in (BENCH["configs"], BENCH["workloads"],
                  BENCH["end_to_end"] + BENCH["per_layer"]):
        assert len({g["name"] for g in group}) == len(group)


def test_metric_keys_sources_and_bounds():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and LINE.match(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_has_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        cfg = configs[w["config"]]
        used.add(cfg["name"])
        assert (ROOT / cfg["file"]).is_file()
        assert cfg["file"].startswith(tuple(BENCH["paths"]))
        spec = json.loads((ROOT / "benchmark" / "workloads"
                           / f"{w['name']}.json").read_text())
        assert spec["traffic"]["name"] == w["traffic"]
        assert spec["config"] == w["config"]
        assert (ROOT / "benchmark" / "entries"
                / f"{spec['entry']}.py").is_file()
        assert spec["limits"]
    assert used == set(configs)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        reader = core.load_module(
            ROOT / "benchmark" / "metrics" / f"{m['name']}.py", "m")
        assert callable(reader.read)


def test_each_cell_reports_what_its_per_layer_metrics_move():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in core.metric_specs(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = core.metric_specs(BENCH, w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in e2e
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", []):
            assert m in core.metric_specs(BENCH, cell, True)


def test_layers_are_named_alike():
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert f"`{layer}`" in perf


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_configuration_file_is_what_the_presets_resolve_to(cell):
    from benchmark import programs
    ctx = core.Context(cell, 1, "cpu")
    programs.framework(ctx.config)
    bad = json.loads(json.dumps(ctx.config))
    bad["model"]["tower_filters"] += 1
    with pytest.raises(ValueError, match="tower_filters"):
        programs.framework(bad)


def test_guard_compares_whole_top_level_names():
    assert core.forbidden_modules(
        ["jax.numpy", "drl_tetris_tpu_torch.env", "drl_tetris_tpu.env",
         "jaxtyping", "flax", "optax.x", "orbax", "numpy"]) == [
        "drl_tetris_tpu", "flax", "jax", "optax", "orbax"]
    assert core.forbidden_modules(["drl_tetris_tpu_torch", "torch"]) == []


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_imports_jax_and_the_reference_nothing_of_the_program():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(core.FORBIDDEN), path
        if "reference" in path.parts:
            assert "drl_tetris_tpu_torch" not in tops, path


STUB_ENTRY = '''
def build(ctx):
    return {"n": ctx.workload["traffic"]["rows"], "done": 0}


def unit(s):
    s["done"] += s["n"]
    return {"env_steps": s["n"]}


def record(s):
    return s["done"]


def judge(rec, ctx):
    return {"rows_lost": float(rec % ctx.workload["traffic"]["rows"])}
'''
STUB_RATE = '''
def read(run):
    return sum(u["env_steps"] for u in run["units"]) / run["window_s"]
'''
STUB_UNITS = '''
def read(run):
    return float(len(run["units"]))
'''


def test_a_cell_added_by_files_alone_is_found(tmp_path):
    """A configuration, a cell with its entry, an end-to-end metric and a
    per-layer metric added as new files and BENCHMARK.json entries: the
    harness finds each by name and runs the cell, with no file that is
    there edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    (b / "configs/stub.json").write_text(json.dumps({"name": "stub"}))
    (b / "workloads/stub_cell.json").write_text(json.dumps({
        "name": "stub_cell", "config": "stub", "entry": "stub_entry",
        "traffic": {"name": "stub_mix", "rows": 3}, "why": "a test",
        "limits": {"rows_lost": 0}}))
    (b / "entries/stub_entry.py").write_text(STUB_ENTRY)
    (b / "metrics/stub_rate.py").write_text(STUB_RATE)
    (b / "metrics/stub_units.py").write_text(STUB_UNITS)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "stub", "source": "a test",
                             "file": "benchmark/configs/stub.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "stub_cell", "config": "stub",
                               "traffic": "stub_mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "stub_rate", "unit": "rows/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["stub_cell"]})
    bench["per_layer"].append({"name": "stub_units", "unit": "units",
                               "better": "higher", "source": "host_clock",
                               "layer": "stub", "moves": "stub_rate",
                               "workloads": ["stub_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = core.run_cell(core.Context("stub_cell", 5, "cpu", root=tmp_path),
                        0.0, False)
    assert out["correct"] and out["attempted"] >= 1
    assert set(out["metrics"]) == {"stub_rate", "setup_s"}
    traced = core.run_cell(core.Context("stub_cell", 5, "cpu",
                                        root=tmp_path), 0.0, True)
    assert set(traced["metrics"]) == {"stub_units"}
    assert core.metric_specs(bench, "ppo_act", True) == \
        core.metric_specs(BENCH, "ppo_act", True)


def test_context_refuses_a_traffic_name_that_differs(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = tmp_path / "benchmark/workloads/ppo_act.json"
    spec = json.loads(p.read_text())
    spec["traffic"]["name"] = "other"
    p.write_text(json.dumps(spec))
    with pytest.raises(SystemExit):
        core.Context("ppo_act", 1, "cpu", root=tmp_path)
