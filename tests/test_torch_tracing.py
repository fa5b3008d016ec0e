"""The port's spans (utils/tracing.py) on the CPU at a tiny size: 2 games,
2 ticks, a float32 net of one layer of 4 filters.

* With tracing off, a rollout records nothing.
* Under ``torch.profiler`` a rollout records ``rollout`` -> ``tick`` ->
  observe, forward, sample and env_step, with nested host intervals on the
  profiler's clock; env_step once a tick, the policy's three once a tick
  and once more for the bootstrap.  The leaves are profiler events of
  their names, the enclosing spans are not.
* A PPO worker's ``ship`` records ``ship.gae`` and ``ship.copy`` in the
  rollout's unit.
* SIXten's and Sherlock's rollouts time ``masks``, ``forward`` and
  ``tick`` once a tick, and the segment's stack with the bootstrap as one
  more ``forward`` (so ``masks`` per tick is over the ticks alone);
  SIXten's update ``update.sample``, ``update.targets``, ``update.step``
  once a minibatch and ``update.prios``.
* ``StandaloneTrainer``'s ``phase_ms`` holds its phases without a
  profiler, the spans inside them (its ticks) do not record then, and
  nothing records once the iteration is over.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import dataclasses  # noqa: E402

import pytest  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from drl_tetris_tpu_torch import config  # noqa: E402
from drl_tetris_tpu_torch.algos import sherlock, sixten  # noqa: E402
from drl_tetris_tpu_torch.algos.replay import ReplayConfig  # noqa: E402
from drl_tetris_tpu_torch.algos.rollout import make_rollout_fn  # noqa: E402
from drl_tetris_tpu_torch.engine import rng  # noqa: E402
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv  # noqa: E402
from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet  # noqa: E402
from drl_tetris_tpu_torch.runtime.runner import make_worker_parts  # noqa: E402
from drl_tetris_tpu_torch.runtime.standalone import (  # noqa: E402
    StandaloneConfig, StandaloneSIXtenConfig, StandaloneSIXtenTrainer,
    StandaloneTrainer)
from drl_tetris_tpu_torch.utils import tracing  # noqa: E402

N, HORIZON = 2, 2
TINY = ModelConfig(compute_dtype="float32", tower_layers=1, tower_filters=4,
                   val_layers=1, val_filters=4)
LEAVES = ("observe", "forward", "sample", "env_step")


def acting():
    env = TetrisVectorEnv(EnvConfig(), N, device="cpu")
    net = PPONet(TINY, device="cpu").init_flax_(rng.prng_key(1, "cpu"))
    return env, make_rollout_fn(env, net, HORIZON), env.reset(2)


def profiled(fn):
    """fn() under the profiler on a cleared buffer: (its result, the
    spans, the profiler's events of the spans' names as (name, start
    ns))."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = {s.name for s in tracing.spans()}
    events = [(e.name(), e.start_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name() in names]
    return out, tracing.spans(), events


def test_rollout_records_nothing_when_off():
    _, rollout, st = acting()
    tracing.clear()
    rollout(st, rng.prng_key(3, "cpu"))
    assert tracing.spans() == []


def test_rollout_spans_nest_and_count_under_the_profiler():
    _, rollout, st = acting()
    _, spans, events = profiled(lambda: rollout(st, rng.prng_key(3, "cpu")))
    roll = [s for s in spans if s.name == "rollout"]
    assert len(roll) == 1 and roll[0].parent is None
    ticks = [s for s in spans if s.name == "tick"]
    assert len(ticks) == HORIZON
    assert all(t.parent is roll[0] for t in ticks)
    counts = {n: sum(s.name == n for s in spans) for n in LEAVES}
    assert counts == {"observe": HORIZON + 1, "forward": HORIZON + 1,
                      "sample": HORIZON + 1, "env_step": HORIZON}
    for s in spans:
        assert s.unit == roll[0].unit and s.device_ms is None
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns
        if s.name in LEAVES:
            # the bootstrap's policy call sits in the rollout, outside ticks
            assert s.parent.name in ("tick", "rollout")
    names = {n for n, _ in events}
    assert set(LEAVES) <= names and not {"rollout", "tick"} & names
    # the same clock: each leaf's host start beside its profiler event's
    starts = {n: sorted(a for m, a in events if m == n) for n in LEAVES}
    for n in LEAVES:
        mine = sorted(s.start_ns for s in spans if s.name == n)
        assert len(mine) == len(starts[n])
        assert max(abs(a - b) for a, b in zip(mine, starts[n])) < 5e8
    summ = tracing.summary(tracing.current_unit())
    assert summ["tick"]["count"] == HORIZON
    assert summ["tick"]["host_ms"] <= summ["rollout"]["host_ms"]


def test_ship_records_gae_and_copy_in_the_rollouts_unit():
    fw = config.load("r5_learning")
    cfg = StandaloneConfig(env=fw.env, model=TINY, ppo=fw.ppo, n_envs=N,
                           horizon=HORIZON)
    env = TetrisVectorEnv(cfg.env, N, device="cpu")
    nets, rollout, ship = make_worker_parts(cfg, env, "ppo")
    nets[0].init_flax_(rng.prng_key(1, "cpu"))

    def segment():
        st, seg, v_last = rollout(env.reset(2), rng.prng_key(3, "cpu"),
                                  None, None)
        return ship(seg, v_last, st)
    packet, spans, events = profiled(segment)
    assert packet["batch"]["advantage"].shape == (N * HORIZON,)
    summ = tracing.summary(tracing.current_unit())
    assert summ["ship.gae"]["count"] == summ["ship.copy"]["count"] == 1
    assert summ["rollout"]["count"] == 1
    assert {"ship.gae", "ship.copy"} <= {n for n, _ in events}
    assert [s.name for s in spans if s.parent is None] == [
        "rollout", "ship.gae", "ship.copy"]


@pytest.mark.parametrize("algo", ["sixten", "sherlock"])
def test_placement_rollout_phases(algo):
    env = TetrisVectorEnv(EnvConfig(), N, device="cpu")
    if algo == "sixten":
        net = sixten.VNet(TINY, device="cpu")
        rollout = sixten.make_sixten_rollout(env, net, HORIZON)
    else:
        net = sherlock.SherlockNet(TINY, device="cpu")
        rollout = sherlock.make_sherlock_rollout(env, net, HORIZON)
    _, spans, _ = profiled(lambda: rollout(env.reset(2),
                                           rng.prng_key(3, "cpu")))
    assert all(s.parent is None for s in spans)
    counts = {n: sum(s.name == n for s in spans)
              for n in ("masks", "forward", "tick")}
    assert counts == {"masks": HORIZON, "forward": HORIZON + 1,
                      "tick": HORIZON}
    assert [s.name for s in spans[-2:]] == ["tick", "forward"]
    if algo == "sixten":
        assert update_spans() == ["update.sample", "update.targets",
                                  "update.step", "update.step",
                                  "update.prios"]


def update_spans():
    """The spans of one update of a tiny SIXten trainer (8 samples in
    minibatches of 4) under an ``Iteration`` that records every span."""
    tr = StandaloneSIXtenTrainer(StandaloneSIXtenConfig(
        model=TINY, replay=ReplayConfig(capacity=64, sample_mode="rank"),
        n_envs=N, horizon=HORIZON), sixten.SixtenConfig(
            n_samples_each_update=8, minibatch_size=4), device="cpu")
    for _ in range(2):
        tr.train_iteration()
    tracing.clear()
    with tracing.Iteration("cpu", every_span=True):
        tr.update(tr.state, tr.replay, rng.prng_key(4, "cpu"), 0.7, 0.5)
    return [s.name for s in tracing.spans()]


def test_trainer_phase_ms_without_a_profiler():
    fw = config.load("r5_learning")
    ppo = dataclasses.replace(fw.ppo, minibatch_size=3, n_train_epochs=1)
    tr = StandaloneTrainer(StandaloneConfig(
        env=fw.env, model=TINY, ppo=ppo, n_envs=N, horizon=HORIZON, seed=1),
        device="cpu")
    tr.train_iteration()
    assert set(tr.phase_ms) == {"rollout", "gae", "update"}
    assert all(ms >= 0 for ms in tr.phase_ms.values())
    unit = [s for s in tracing.spans() if s.unit == tracing.current_unit()]
    assert [s.name for s in unit] == ["rollout", "gae", "update"]
    n = len(tracing.spans())
    tr.rollout(tr.env_state, rng.prng_key(3, "cpu"))
    assert len(tracing.spans()) == n
