"""Each entry against the plain reference at the test size on the CPU,
through the harness's run without its look for a card: the program's run
comes out correct; the control (the reference one precision step below
the configuration's, in the program's place) and every fault the entry
plants in the timed path come out not correct."""
import pytest
import torch

from benchmark import core
from helpers import ROOT, context

CELLS = ("ppo_act",)
ENTRIES = {"ppo_act": "worker_ppo"}


@pytest.fixture(scope="module")
def root():
    return ROOT


def faults(cell):
    e = ENTRIES[cell]
    return sorted(core.load_module(ROOT / "benchmark/entries" / f"{e}.py",
                                   f"entry_{e}").FAULTS)


@pytest.mark.parametrize("cell", CELLS)
def test_program_run_is_correct(cell, root):
    out = core.run_cell(context(cell, 2147483659, root), 0.0, False)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["numbers"]["engine_mismatches"] == 0
    assert out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("seed", [1, 2, 2147483659])
def test_drawn_weights_leave_the_values_unsaturated(seed):
    ctx = context("ppo_act", seed)
    entry = ctx.entry()
    system = entry.build(ctx)
    entry.unit(system)
    values = entry.record(system)["segments"][0]["values"]
    v = torch.cat([x.flatten() for x in values.values()])
    assert (v.abs() > 0.99).float().mean() < 0.05
    assert v.abs().mean() < 0.9 and v.std() > 0.05


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reduces_the_profile(cell, root):
    out = core.run_cell(context(cell, 7, root), 0.0, True)
    assert out["correct"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, root):
    ctx = context(cell, 3, root)
    entry = ctx.entry()
    numbers = core.judge_numbers(entry, entry.control_record(ctx), ctx)
    correct, checks = core.hold(numbers, ctx.workload["limits"])
    assert not correct, checks


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in faults(c)])
def test_fault_is_not_correct(cell, fault, root):
    ctx = context(cell, 4, root)
    out = core.run_cell(ctx, 0.0, False, fault=ctx.entry().FAULTS[fault])
    assert not out["correct"], out["checks"]


def test_fault_is_undone_after_the_run(root):
    from drl_tetris_tpu_torch.algos import distributions
    draw = distributions.action_distribution
    for cell in CELLS:
        for fault in context(cell, 5, root).entry().FAULTS.values():
            core.run_cell(context(cell, 5, root), 0.0, False, fault=fault)
    assert distributions.action_distribution is draw
