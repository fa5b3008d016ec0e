"""The readers of the program's spans (benchmark/spans.py and the six
``program_span`` metrics of ``ppo_act``): None without a card, without a
trace and without the program's tracing module; the right number from a
given summary."""
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import core, spans
from helpers import ROOT

READERS = ("observe_ms_per_tick.act", "forward_ms_per_tick.act",
           "sample_ms_per_tick.act", "env_step_ms_per_tick.act",
           "ship_ms_per_segment.act", "dispatch_ms_per_tick.act")


def span(count, host_ms, device_ms):
    return {"count": count, "host_ms": host_ms, "device_ms": device_ms}


# a 4-tick segment: the policy's spans once more for the bootstrap
SUMMARY = {"rollout": span(1, 60.0, 50.0), "tick": span(4, 40.0, 44.0),
           "observe": span(5, 5.0, 2.0), "forward": span(5, 20.0, 40.0),
           "sample": span(5, 6.0, 1.0), "env_step": span(4, 4.0, 0.5),
           "ship.gae": span(1, 3.0, 7.0), "ship.copy": span(1, 25.0, 20.0)}
EXPECTED = {"observe_ms_per_tick.act": 0.5, "forward_ms_per_tick.act": 10.0,
            "sample_ms_per_tick.act": 0.25,
            "env_step_ms_per_tick.act": 0.125,
            "ship_ms_per_segment.act": 32.0,
            "dispatch_ms_per_tick.act": 10.0}


def reader(name):
    return core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                            "metric_" + name.replace(".", "_"))


def run_on(device, trace=True):
    return {"ctx": SimpleNamespace(device=torch.device(device)),
            "trace": {} if trace else None}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_summary(name):
    assert reader(name).from_summary(SUMMARY) == pytest.approx(
        EXPECTED[name])
    assert reader(name).from_summary(None) is None
    assert reader(name).from_summary({"rollout": SUMMARY["rollout"]}) \
        is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_a_card_or_a_trace(name):
    assert reader(name).read(run_on("cpu")) is None
    assert reader(name).read(run_on("cuda", trace=False)) is None


def test_no_tracing_module_gives_none(monkeypatch):
    import drl_tetris_tpu_torch.utils as utils
    # a package that never had the module: no attribute, no import
    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "drl_tetris_tpu_torch.utils.tracing",
                        None)
    assert spans.traced_summary(run_on("cuda")) is None


def test_summary_of_the_latest_unit(monkeypatch):
    from drl_tetris_tpu_torch.utils import tracing
    tracing.clear()
    assert spans.traced_summary(run_on("cuda")) is None
    monkeypatch.setattr(tracing, "summary", lambda unit: dict(SUMMARY))
    assert spans.traced_summary(run_on("cuda")) == SUMMARY
