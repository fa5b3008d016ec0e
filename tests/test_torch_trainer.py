"""The port's standalone trainer (runtime/standalone.py) and main-path
config (config/) against the JAX package's.

* The config: ``config.load()`` and ``config.load("r5_learning")`` equal
  what the JAX CLI's preset layering resolves to, PPOConfig field by field,
  and the raw lr schedule evaluates the same at t = 0, 5M and 20M.
* Two ``train_iteration``s of the JAX ``StandaloneTrainer`` and the port's
  (r5_learning PPO at minibatch 32 and 2 epochs, a small float32 net, 8
  games, horizon 16: 8 Adam steps per iteration), from the JAX trainer's
  initial weights converted, with JAX's gumbel draws injected.  After each
  iteration: the key chain and the env state bit-exact, the Adam lr equal
  to the schedule's value, the stats within STAT_TOL (relative, floor
  1e-6; saturations within one sample of a minibatch), the parameters
  within 2 x lr x steps + 1e-6 (see tests/test_torch_ppo.py for why Adam
  needs that form).  Before each iteration, the first minibatch step's
  gradients on that iteration's batch and key, each side at its own
  weights, within GRAD_TOL of each leaf's largest |g| (JAX's recorded by
  an optax stage before Adam).  Measured on the CPU: gradients 1.1e-5,
  stats 5.1e-7 relative, parameters 6.0e-7 absolute.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import (assert_state_equal, rekey_jax_cache)

rekey_jax_cache()

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.algos import ppo as jppo  # noqa: E402
from drl_tetris_tpu.config import parameter as jparameter  # noqa: E402
from drl_tetris_tpu.engine.core import EngineConfig as JEngineConfig  # noqa: E402
from drl_tetris_tpu.env.env import EnvConfig as JEnvConfig  # noqa: E402
from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu.runtime import standalone as jstandalone  # noqa: E402
from drl_tetris_tpu_torch import config  # noqa: E402
from drl_tetris_tpu_torch.algos.ppo import (first_step_gradients,  # noqa: E402
                                            segment_to_batch)
from drl_tetris_tpu_torch.config.parameter import param_eval  # noqa: E402
from drl_tetris_tpu_torch.engine import rng  # noqa: E402
from drl_tetris_tpu_torch.models.convert import params_from_flax  # noqa: E402
from drl_tetris_tpu_torch.models.nets import ModelConfig  # noqa: E402
from drl_tetris_tpu_torch.runtime.standalone import (  # noqa: E402
    StandaloneConfig, StandaloneTrainer)
from drl_tetris_tpu_torch.utils.metrics import fetch_stats  # noqa: E402
from tests.test_torch_nets import SMALL  # noqa: E402
from tests.test_torch_ppo import (GRAD_TOL, jax_ppo_config,  # noqa: E402
                                  recorder, relerr, to_jax_batch)

CLI_PRESETS = ["default", "sventon", "sventon_ppo", "resblock",
               "experiment_sventon_ppo"]
N, HORIZON, MB, EPOCHS, SEED = 8, 16, 32, 2, 3
STAT_TOL = 2e-5


@pytest.mark.parametrize("recipe", (None, "r5_learning"))
def test_main_path_config_matches_jax_presets(recipe):
    from drl_tetris_tpu.config.presets import merge_settings, resolve
    ref = resolve(merge_settings(CLI_PRESETS + ([recipe] if recipe else [])))
    got = config.load(recipe)
    assert dataclasses.asdict(got.ppo) == dataclasses.asdict(ref.ppo)
    assert dataclasses.asdict(got.env) == dataclasses.asdict(ref.env)
    assert dataclasses.asdict(got.model) == dataclasses.asdict(ref.model)
    assert got.n_envs == ref.n_envs
    schedule = ref.settings["value_lr"]
    for t in (0, 5_000_000, 20_000_000):
        assert param_eval(got.value_lr, t) == jparameter.param_eval(
            schedule, t), t


def test_fetch_stats_is_one_transfer_of_floats():
    stats = {"a": torch.tensor(1.5), "b": torch.tensor([2.0])[0],
             "c": torch.tensor(3, dtype=torch.int32)}
    assert fetch_stats(stats) == {"a": 1.5, "b": 2.0, "c": 3.0}
    assert fetch_stats({}) == {}


def test_unported_options_raise():
    """What the trainer still refuses, as the JAX package does: league-pool
    opponents with trainer-computed targets (pool training uses
    worker-side GAE), an unknown pool mode, and a horizon too short for
    the k-step windows."""
    small = StandaloneConfig(model=ModelConfig(compute_dtype="float32",
                                               **SMALL), n_envs=2, horizon=2)
    targets = dataclasses.replace(small.ppo, workers_computes_advantages=False,
                                  n_step_value_estimates=3)
    for kw in (dict(pool_prob=0.2, ppo=targets),
               dict(pool_prob=0.2, pool_mode="elo")):
        with pytest.raises(ValueError):
            StandaloneTrainer(dataclasses.replace(small, **kw), device="cpu")
    tr = StandaloneTrainer(dataclasses.replace(small, ppo=targets),
                           device="cpu")
    with pytest.raises(ValueError):
        tr.train_iteration()


def jax_gumbel(jtr):
    """The gumbel draws of the JAX trainer's next rollout: its key chain
    (key, kstep = split(key); kroll, kupd = split(kstep)), then one
    categorical per tick over split(kroll, horizon)."""
    _, kstep = jax.random.split(jtr.key)
    kroll, _ = jax.random.split(kstep)
    W = jtr.cfg.env.engine.width
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
        k, (N, 4 * W), jnp.float32)) for k in jax.random.split(kroll,
                                                                HORIZON)]))


@pytest.fixture(scope="module")
def two_iterations():
    mc = config.load("r5_learning")
    ppo = dataclasses.replace(mc.ppo, minibatch_size=MB,
                              n_train_epochs=EPOCHS)
    model = ModelConfig(compute_dtype="float32", **SMALL)
    cfg = StandaloneConfig(env=mc.env, model=model, ppo=ppo, n_envs=N,
                           horizon=HORIZON, seed=SEED,
                           lr_schedule=mc.value_lr)
    jschedule = jparameter.LinearParameter(**dataclasses.asdict(mc.value_lr))
    jtr = jstandalone.StandaloneTrainer(jstandalone.StandaloneConfig(
        env=JEnvConfig(), model=jnets.ModelConfig(**dataclasses.asdict(model)),
        ppo=jax_ppo_config(ppo), n_envs=N, horizon=HORIZON, seed=SEED,
        lr_schedule=jschedule))
    tr = StandaloneTrainer(cfg, device="cpu")
    tr.net.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jtr.state.params["params"])))
    assert_state_equal(jtr.env_state, tr.env_state, "reset")
    # the JAX update with a stage that records the first step's gradients
    # (before Adam: the lr does not matter)
    jinit, jupdate = jppo.make_ppo_update(
        JEngineConfig(), jtr.net, jax_ppo_config(ppo),
        optimizer=optax.chain(recorder(), optax.adam(1e-4)))

    out = []
    for it in range(2):
        t = tr.total_steps
        gumbel = jax_gumbel(jtr)
        # this iteration's batch and kupd, each side's first-step gradients
        _, kstep = rng.split(tr.key)
        _, kupd = rng.split(kstep)
        _, seg, last = tr.rollout(tr.env_state, None, gumbel)
        batch, _ = segment_to_batch(ppo, seg, last)
        grads, _ = first_step_gradients(cfg.env.engine, ppo, tr.net, batch,
                                        kupd)
        arrays = [a.numpy() for a in batch]
        arrays[0] = arrays[0].view(np.uint32)
        jstate, _ = jupdate(jinit(jtr.state.params), to_jax_batch(arrays),
                            jnp.asarray(kupd.numpy().astype(np.uint32)))
        jgrads = params_from_flax(
            jax.tree.map(np.asarray, jstate.opt_state[0][1]["params"]))
        jstats = jtr.train_iteration()
        stats = tr.train_iteration(gumbel=gumbel)
        out.append(dict(
            t=t, stats=stats, jstats=jstats, grads=grads, jgrads=jgrads,
            key=tr.key.numpy().astype(np.uint32),
            jkey=np.asarray(jax.random.key_data(jtr.key)),
            lr=tr.state.optimizer.param_groups[0]["lr"],
            jlr=float(jtr.state.opt_state.hyperparams["learning_rate"]),
            params={k: p.detach().clone()
                    for k, p in tr.net.named_parameters()},
            jparams=params_from_flax(jax.tree.map(
                np.asarray, jtr.state.params["params"])),
            jenv=jtr.env_state, env=tr.env_state))
    return cfg, out


def test_trainer_key_chain_env_and_lr(two_iterations):
    cfg, out = two_iterations
    for it, r in enumerate(out):
        assert_state_equal(r["jenv"], r["env"], f"after iteration {it}")
        assert (r["key"] == r["jkey"]).all(), it
        assert r["t"] == it * N * HORIZON
        assert r["lr"] == param_eval(cfg.lr_schedule, r["t"])
        assert r["jlr"] == float(np.float32(r["lr"]))
    assert out[1]["lr"] < out[0]["lr"]              # the schedule moved


def test_trainer_first_minibatch_gradients(two_iterations):
    _, out = two_iterations
    for it, r in enumerate(out):
        for k, g in r["grads"].items():
            jg = r["jgrads"][k]
            err = (g - jg).abs().max().item()
            assert err <= GRAD_TOL * jg.abs().max().item() + 1e-12, (it, k)


def test_trainer_stats(two_iterations):
    _, out = two_iterations
    for it, r in enumerate(out):
        assert set(r["stats"]) == set(r["jstats"])
        for k, v in r["jstats"].items():
            got = r["stats"][k]
            if "saturation" in k:
                assert abs(v - got) <= 1.0 / MB + 1e-6, (it, k, v, got)
            else:
                assert relerr(v, got) < STAT_TOL, (it, k, v, got)


def test_trainer_parameters(two_iterations):
    cfg, out = two_iterations
    steps = 0
    for it, r in enumerate(out):
        steps += EPOCHS * (N * HORIZON // MB)
        tol = 2 * cfg.ppo.lr * steps + 1e-6
        for k, p in r["params"].items():
            err = (p - r["jparams"][k]).abs().max().item()
            assert err <= tol, (it, k, err, tol)
    moved = max((out[1]["params"][k] - out[0]["params"][k]).abs().max().item()
                for k in out[0]["params"])
    assert moved > 1e-5
