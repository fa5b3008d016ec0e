"""The ``sixten_train`` cell on the CPU at the configuration's widths with 2
games x 4 ticks, a replay of 4,096 rows (filled by 128 games) and an update
of 128 samples in two minibatches: the program's run, traced and not, comes
out correct; the fp8 control and every fault the entry plants come out not
correct, each fault on the check it is planted to fail; the
configuration's sections are held to the presets; the judge's choice
regret is what it says; the readers of the cell's new metrics read a
summary or a trace and give none without a card; the VNet's FLOPs are its
convs' multiply-adds."""
import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import core
from benchmark.work import vnet_flops
from helpers import ROOT

CELL = "sixten_train"
SMALL = {"experience_replay_size": 4096, "n_samples_each_update": 128,
         "minibatch_size": 64}


def shrink(ctx):
    """``ctx`` at the test size: the traffic's games, ticks and fill, and
    the replay and update sizes set through the presets' overrides and
    stated in the file's sections as they resolve."""
    ctx.workload["traffic"].update(n_envs=2, horizon=4, fill_games=128)
    ctx.config["set"] = dict(SMALL)
    ctx.config["replay"]["capacity"] = SMALL["experience_replay_size"]
    ctx.config["sixten"].update(
        n_samples_each_update=SMALL["n_samples_each_update"],
        minibatch_size=SMALL["minibatch_size"])
    return ctx


def context(seed):
    return shrink(core.Context(CELL, seed, "cpu"))


def entry():
    return core.load_module(ROOT / "benchmark/entries/trainer_sixten.py",
                            "entry_trainer_sixten")


FAULTS = sorted(entry().FAULTS)
# the check each fault is planted to fail
FAILS = {"state_unchanged": "engine_mismatches",
         "rotation_masked": "mask_mismatches",
         "half_minibatches": "adam_step_mismatch",
         "prios_kept": "prio_gap", "online_targets": "target_gap",
         "window_shifted": "target_gap", "worst_choice": "choice_regret",
         "add_skipped": "add_mismatches", "weights_unchanged": "step_gap"}


def test_trainer_setting_the_program_lacks_is_refused():
    """The file's trainer section reaches the program's trainer; a setting
    that the trainer has not (the CUDA graphs, in a program without them)
    refuses the run at build."""
    ctx = context(2147483671)
    assert ctx.config["trainer"] == {"cuda_graphs": True}
    ctx.config["trainer"]["no_such_setting"] = 1
    with pytest.raises(ValueError, match="no setting no_such_setting"):
        core.run_cell(ctx, 0.0, False)


@pytest.mark.parametrize("trace", [False, True])
def test_program_run_is_correct(trace):
    out = core.run_cell(context(2147483659 + trace), 0.0, trace)
    assert out["correct"], out["checks"]
    n = out["numbers"]
    assert n["engine_mismatches"] == n["mask_mismatches"] == 0
    assert n["sample_mismatches"] == 0 and n["adam_steps"] == 2
    if trace:
        # the readers read the card's spans and trace: none here
        assert out["metrics"] == {} and out["device"]["window_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert out["metrics"]["setup_s"]["value"] > 0


def test_control_is_not_correct():
    ctx = context(3)
    e = ctx.entry()
    numbers = core.judge_numbers(e, e.control_record(ctx), ctx)
    correct, checks = core.hold(numbers, ctx.workload["limits"])
    assert not correct, checks
    # the control is the reference itself below its precision: its engine,
    # masks, draws and sample are exact
    assert numbers["engine_mismatches"] == numbers["mask_mismatches"] == 0
    assert numbers["sample_mismatches"] == 0


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault):
    ctx = context(4)
    out = core.run_cell(ctx, 0.0, False, fault=ctx.entry().FAULTS[fault])
    assert not out["correct"], out["checks"]
    check = out["checks"][FAILS[fault]]
    assert check["value"] > check["limit"], out["checks"]


def test_faults_are_undone_after_the_run():
    from drl_tetris_tpu_torch.algos import sixten
    from drl_tetris_tpu_torch.engine import masks
    from drl_tetris_tpu_torch.runtime import standalone
    names = ("minibatch_indices", "replay_update_prios",
             "replay_gather_windows")

    def patched():
        return [getattr(sixten, n) for n in names] + [
            masks.placement_boards, standalone.replay_add_segment]
    before = patched()
    for fault in ("rotation_masked", "half_minibatches", "prios_kept",
                  "window_shifted", "add_skipped"):
        core.run_cell(context(5), 0.0, False,
                      fault=entry().FAULTS[fault])
    assert patched() == before


def test_sections_are_held_to_the_presets():
    e = entry()
    ctx = core.Context(CELL, 1, "cpu")
    e._resolved(ctx)
    for section, key in (("sixten", "minibatch_size"), ("replay",
                                                        "capacity")):
        bad = core.Context(CELL, 1, "cpu")
        bad.config[section][key] += 1
        with pytest.raises(ValueError, match=key):
            e._resolved(bad)


def test_drawn_weights_leave_the_values_unsaturated():
    """On the boards the set-up writes into the replay, at the drawn
    weights (the warm update's start), v of the used pieces stays off
    tanh's flat ends."""
    from drl_tetris_tpu_torch.algos.replay import replay_init
    from benchmark.reference.observations import field_grid
    from benchmark.reference.sixten import VNet
    e = entry()
    for seed in (1, 2147483659):
        ctx = context(seed)
        fw = e._resolved(ctx)
        m = ctx.config["model"]
        net = VNet(m, (22, 10))
        net.load_state_dict(e.draw_weights(ctx, net.state_dict()))
        ctx.key(), ctx.key()
        rep = replay_init(fw.replay, "cpu")
        e.fill_replay(ctx, fw.env, fw.replay, rep, ctx.workload["traffic"])
        occ, vec = rep.occ[:rep.size:8], rep.vec[:rep.size:8]
        grids = field_grid(fw.env.engine, occ)
        with torch.no_grad():
            v = net([vec[:, 0], vec[:, 1]],
                    [grids[:, 0, :, :, None], grids[:, 1, :, :, None]])
        v = v[:, list(m["used_pieces"])]
        assert (v.abs() > 0.99).float().mean() < 0.05
        assert v.abs().mean() < 0.8 and v.std() > 0.05


def span(count, device_ms):
    return {"count": count, "host_ms": 0.0, "device_ms": device_ms}


# a 4-tick iteration and its update of two minibatches
SUMMARY = {"tick": span(4, 4.0), "masks": span(4, 8.0),
           "forward": span(5, 20.0), "update.sample": span(1, 3.0),
           "update.targets": span(1, 12.0), "update.step": span(2, 5.0),
           "update.prios": span(1, 0.5)}
EXPECTED = {"masks_ms_per_tick.sixten": 2.0,
            "forward_ms_per_tick.sixten": 5.0,
            "sample_ms_per_update.sixten": 3.0,
            "targets_ms_per_update.sixten": 12.0,
            "step_ms_per_minibatch.sixten": 2.5}


def reader(name):
    return core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                            "metric_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_reader_reads_the_summary(name):
    assert reader(name).from_summary(SUMMARY) == pytest.approx(
        EXPECTED[name])
    assert reader(name).from_summary(None) is None
    assert reader(name).from_summary({"rollout": span(1, 1.0)}) is None
    cpu = {"ctx": SimpleNamespace(device=torch.device("cpu")), "trace": {}}
    assert reader(name).read(cpu) is None


def test_mfu_and_idle_readers():
    config = json.loads((ROOT / "benchmark/configs/sixten.json").read_text())
    fwd, fwd_bwd = vnet_flops.per_board(config)
    units = [{"successor_boards": 100, "target_boards": 50,
              "train_samples": 20}] * 3
    ctx = SimpleNamespace(device=torch.device("cuda"), config=config)
    run = {"ctx": ctx, "units": units, "window_s": 2.0,
           "trace": {"busy_s": 0.25, "window_s": 1.0}}
    want = 100.0 * 3 * (150 * fwd + 20 * fwd_bwd) / 2.0 / 989e12
    assert reader("sixten_mfu").read(run) == pytest.approx(want)
    assert reader("idle_share.sixten").read(run) == pytest.approx(75.0)
    run["ctx"] = SimpleNamespace(device=torch.device("cpu"), config=config)
    assert reader("sixten_mfu").read(run) is None
    assert reader("idle_share.sixten").read(run) is None


def test_engine_roofline_reader(monkeypatch):
    """The place entry's least time (bytes: the state read and written,
    actions, kind and y read, reward and done written) over its time a
    launch; none without a card or a launch.  The INT32 rate is the H100
    SXM's (it is read from the card)."""
    from benchmark.work import engine, peaks
    monkeypatch.setattr(peaks, "int32_ops_per_s", lambda: 132 * 64 * 1.98e9)
    config = json.loads((ROOT / "benchmark/configs/sixten.json").read_text())
    cfg = engine.env_config(config)
    unit = {"games": 16, "ticks": 32, "dones": 8}
    trace = {"kernels": [("void step_kernel<true>(int)", 2e-5)] * 32,
             "unit": unit}
    run = {"ctx": SimpleNamespace(device=torch.device("cuda"),
                                  config=config), "trace": trace}
    least = max((2 * engine.state_bytes(cfg, 16) + 16 * 21)
                / peaks.HBM_BYTES_PER_S,
                16 * engine.tick_int_ops(cfg, 8 / 512, False, "place")
                / peaks.int32_ops_per_s())
    assert reader("engine_roofline.sixten").read(run) == pytest.approx(
        100.0 * least / 2e-5)
    trace["kernels"] = [("void epilogue_kernel", 1e-5)]
    assert reader("engine_roofline.sixten").read(run) is None
    run["ctx"] = SimpleNamespace(device=torch.device("cpu"), config=config)
    assert reader("engine_roofline.sixten").read(run) is None


def test_choice_regret():
    """The chosen successors' regret over a uniform pick's; 0 on ties."""
    greedy = torch.tensor([
        [0.5, 0.5, 0.3],                # the best chosen
        [0.5, 0.1, 0.3],                # the worst chosen
        [0.5, 0.45, 0.4],
    ], dtype=torch.float64)
    assert entry()._choice_regret(greedy) == pytest.approx(
        (0.4 + 0.05) / (0.2 + 0.2 + 0.1))
    assert entry()._choice_regret(torch.full((2, 3), 0.5)) == 0.0


def test_vnet_flops_are_the_convs_multiply_adds():
    config = json.loads((ROOT / "benchmark/configs/sixten.json").read_text())
    m = config["model"]
    H, W = 24, 12
    f, k = m["tower_filters"], m["tower_filter_size"] ** 2
    total = 0

    def tower(c):
        nonlocal total
        for _ in range(m["tower_layers"]):
            total += 2 * c * f * k * H * W
            c = max(c, f)
        return c
    c_join = tower(12 + tower(1))
    tower(1)
    tower(12 + 64)
    c, h, w = 2 * c_join + 2, H, W
    for i in range(m["val_layers"]):
        last = i == m["val_layers"] - 1
        out = m["n_pieces"] + 1 if last else m["val_filters"]
        total += 2 * c * out * m["val_filter_size"] ** 2 * h * w
        c = out if last else max(c, out)
        h, w = h // min(3, h), w // min(2, w)
    fwd, fwd_bwd = vnet_flops.per_board(config)
    assert fwd == total
    assert 2 * fwd < fwd_bwd <= 3 * fwd
