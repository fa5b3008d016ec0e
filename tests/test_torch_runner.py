"""The port's process runtime (runtime/runner.py) on a tetrikv server at a
free port, with small float32 nets (2 layers of 8 filters), 4 games x 8
ticks:

* each of the five flavours (ppo, dual, dqn, sixten, sherlock): a worker
  and a trainer exchange through the store, the trainer updates once and
  publishes, and the worker adopts the published weights;
* the epsilon schedule evaluated per segment against the shared clock
  (the JAX package's tests/test_runtime.py case);
* persist and recover: a fresh worker and trainer recover the persisted
  state and validate its checksum, and continue as the original would; a
  tampered checksum raises.

tests/test_torch_runner_jax.py holds the runners against the JAX
package's.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu_torch.config import presets  # noqa: E402
from drl_tetris_tpu_torch.config.parameter import LinearParameter  # noqa: E402
from drl_tetris_tpu_torch.engine.core import tree_leaves  # noqa: E402
from drl_tetris_tpu_torch.runtime.kv import free_port, launch_server  # noqa: E402
from drl_tetris_tpu_torch.runtime.runner import (  # noqa: E402
    TrainerRunner, WorkerRunner, effective_flavour)
from drl_tetris_tpu_torch.runtime.standalone import StandaloneConfig  # noqa: E402
from drl_tetris_tpu_torch.runtime.training_state import TrainingState  # noqa: E402
from tests.test_torch_nets import SMALL  # noqa: E402

N, HORIZON, SEED = 4, 8, 5
PRESETS = {
    "ppo": ["default", "sventon", "sventon_ppo"],
    "dual": ["default", "sventon", "sventon_ppo"],
    "dqn": ["default", "sventon", "sventon_dqn"],
    "sixten": ["default", "sventon", "sventon_dqn", "experiment_sixten"],
    "sherlock": ["default", "sventon", "sherlock"],
}
OVERRIDES = dict(compute_dtype="float32", n_samples_each_update=32,
                 minibatch_size=8, n_train_epochs_per_update=1,
                 experience_replay_size=400, n_step_value_estimates=3,
                 **SMALL)


def settings(flavour, **extra):
    s = dict(OVERRIDES, **extra)
    if flavour == "dual":
        s["single_policy"] = False
    return s


def run_cfg(fw, module=None):
    """The StandaloneConfig (the port's, or ``module``'s) of a framework
    config at the test's shape."""
    cls = StandaloneConfig if module is None else module.StandaloneConfig
    return cls(env=fw.env, model=fw.model, ppo=fw.ppo, n_envs=N,
               horizon=HORIZON, seed=SEED)


@pytest.fixture(scope="module")
def port():
    p = free_port()
    proc = launch_server(p)
    yield p
    proc.kill()
    proc.wait()


def published_equal(worker, trainer):
    """The worker's nets hold exactly what the trainer published."""
    pub = trainer.core.publish_params()
    pub = pub if isinstance(pub, tuple) else (pub,)
    assert len(pub) == len(worker.nets)
    for net, weights in zip(worker.nets, pub):
        for k, v in net.state_dict().items():
            assert np.array_equal(v.numpy(), weights[k]), k


@pytest.mark.parametrize("flavour", sorted(PRESETS))
def test_worker_and_trainer_exchange(port, flavour):
    fw = presets.load(PRESETS[flavour], settings(flavour))
    assert effective_flavour(fw) == flavour
    cfg = run_cfg(fw)
    run_id = f"ex-{flavour}"
    worker = WorkerRunner(cfg, TrainingState(run_id, port=port), flavour,
                          fw, device="cpu")
    trainer = TrainerRunner(cfg, TrainingState(run_id, role="trainer",
                                               port=port),
                            min_samples=32, flavour=flavour, fw=fw,
                            device="cpu")
    before = [p.detach().clone() for p in trainer.net.parameters()]
    assert worker.run(max_steps=2 * N * HORIZON) == 2 * N * HORIZON
    assert trainer.ts.queue_len() == 2
    assert trainer.run(max_updates=1) == 1
    assert trainer.ts.queue_len() == 0
    assert max((p.detach() - b).abs().max().item()
               for p, b in zip(trainer.net.parameters(), before)) > 0.0
    assert worker.update_weights() == 2      # the update and the exit
    published_equal(worker, trainer)


def test_epsilon_schedule_per_segment(port):
    """Sampling schedules follow the shared workers' clock, segment by
    segment (tests/test_runtime.py's case)."""
    fw = SimpleNamespace(
        train_distribution="epsilon",
        epsilon=LinearParameter(1.0, final_val=0.0, time_horizon=320),
        action_temperature=1.0, tau_learning_rate=0.01, settings={})
    cfg = run_cfg(presets.load(PRESETS["dqn"], OVERRIDES))
    worker = WorkerRunner(cfg, TrainingState("epssched", port=port), "dqn",
                          fw, device="cpu")
    lines = []
    worker.run(max_steps=3 * N * HORIZON, logger=lines.append)
    eps = [float(line.split("epsilon=")[1].split()[0])
           for line in lines if "epsilon=" in line]
    assert eps == [0.9, 0.8, 0.7]              # at clocks 32, 64 and 96


def test_persist_recover_and_tamper(port):
    fw = presets.load(PRESETS["dqn"], settings("dqn"))
    cfg = run_cfg(fw)
    worker = WorkerRunner(cfg, TrainingState("rec", port=port), "dqn", fw,
                          device="cpu")
    worker.run(max_steps=N * HORIZON)               # persists on exit
    fresh = WorkerRunner(cfg, TrainingState("rec", role=worker.ts.me,
                                            port=port), "dqn", fw,
                         device="cpu")
    assert fresh.recover()
    for (name, a), (_, b) in zip(tree_leaves(worker.env_state),
                                 tree_leaves(fresh.env_state)):
        assert torch.equal(a, b), name
    assert torch.equal(fresh.key, worker.key)
    assert fresh.checksum() == worker.checksum()
    # the next segments of both are the same
    a, b = worker.collect(7), fresh.collect(7)
    for k in a["segment"]:
        assert np.array_equal(a["segment"][k], b["segment"][k]), k

    trainer = TrainerRunner(cfg, TrainingState("rec", role="trainer",
                                               port=port),
                            min_samples=32, flavour="dqn", fw=fw,
                            device="cpu")
    trainer.run(max_updates=1)
    again = TrainerRunner(cfg, TrainingState("rec", role="trainer",
                                             port=port),
                          min_samples=32, flavour="dqn", fw=fw, device="cpu")
    assert again.recover()
    assert again.checksum() == trainer.checksum()

    fresh.ts.store_validation(None, "0" * 32)
    with pytest.raises(RuntimeError, match="recovery validation failed"):
        WorkerRunner(cfg, fresh.ts, "dqn", fw, device="cpu").recover()
