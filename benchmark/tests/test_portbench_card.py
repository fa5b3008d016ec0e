"""On the card: a run of each cell at its own size through ``run.py``'s
command line comes out correct, and the control at the cell's own size
does not.  Without a card the command exits non-zero and prints no
result, and so it does in a directory holding only the benchmark."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import core

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run(cwd, cell, seconds=2):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "3141592653", "--seconds", str(seconds), "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=900)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    res = run(ROOT, "ppo_act")
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = run(tmp_path, "ppo_act")
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = run(ROOT, cell)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ctx = core.Context(cell, 2718281828, "cuda")
    entry = ctx.entry()
    numbers = core.judge_numbers(entry, entry.control_record(ctx), ctx)
    assert not core.hold(numbers, ctx.workload["limits"])[0]
