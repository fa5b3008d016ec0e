"""The port's dual-policy training (algos/dual.py, runtime/standalone.py
``DualPolicyTrainer`` and ``DualPolicyDQNTrainer``) against the JAX
package's, on a small float32 net (``SMALL``) and the 22 x 10 board:

* ``merge_dual_transitions``, ``dual_policy_subsegment`` and
  ``split_dual_segment`` (GAE per policy with unsigned gamma) on a seeded
  segment whose players alternate from a random seat per game: integer
  and boolean leaves bit for bit, floats within 1e-6;
* the dual rollout (8 games, horizon 16) under ``argmax`` (PPONets),
  ``pi`` with JAX's gumbel draws injected (the tick key split (k0, k1),
  one categorical per policy) and ``epsilon`` (QNets; the draws follow
  JAX's keys, nothing injected): ints, boards and the final state equal,
  floats within 1e-5;
* two iterations of ``DualPolicyTrainer`` (r5_learning PPO at minibatch
  32 and 2 epochs, 8 games x horizon 16: 4 Adam steps per policy and
  iteration) from JAX's initial weights with JAX's pi noise, and of
  ``DualPolicyDQNTrainer`` (the DQN stack cut as in
  tests/test_torch_dqn.py, adaptive epsilon 0.3, 8 games x horizon 32)
  with nothing injected: after each, the key chain, the env state and the
  win-rate EMA equal, both replays' rows bit for bit and priorities
  within PRIO_TOL, the stats within STAT_TOL (relative; saturations
  within one sample of a minibatch), both policies' parameters within
  2 x lr x steps + 1e-6 (the Adam bound of tests/test_torch_ppo.py);
* the win-rate gate: a policy ahead by more than the tolerance keeps its
  parameters while the other trains, as tests/test_dual_dqn.py:57 holds
  the JAX package.

JAX's rollouts and trainer iterations are committed (tests/jax_fixtures/
dual_*.npz, tests/torch_jax_fixtures.py); a ``slow`` test runs them again
with JAX and holds them to the files.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import (assert_state_equal, jax_leaves,
                                      rekey_jax_cache)

rekey_jax_cache()

import dataclasses  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.algos import dual as jdual  # noqa: E402
from drl_tetris_tpu.env.env import (EnvConfig as JEnvConfig,  # noqa: E402
                                    TetrisVectorEnv as JEnv)
from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu.runtime import standalone as jstandalone  # noqa: E402
from drl_tetris_tpu_torch import config  # noqa: E402
from drl_tetris_tpu_torch.algos import dual, replay  # noqa: E402
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv  # noqa: E402
from drl_tetris_tpu_torch.models import nets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import params_from_flax  # noqa: E402
from drl_tetris_tpu_torch.runtime.standalone import (  # noqa: E402
    DualPolicyConfig, DualPolicyDQNConfig, DualPolicyDQNTrainer,
    DualPolicyTrainer)
from tests.test_torch_dqn import (DQN_PRESETS, OVERRIDES,  # noqa: E402
                                  PRIO_TOL, assert_replay_rows_equal,
                                  configs as dqn_configs)
from tests.test_torch_nets import SMALL, small_params  # noqa: E402
from tests.test_torch_ppo import jax_ppo_config, relerr  # noqa: E402
from tests.test_torch_replay import jseg, seg_arrays, tseg  # noqa: E402
from tests import torch_jax_fixtures as fixtures  # noqa: E402

N, HORIZON, MB, EPOCHS, SEED = 8, 16, 32, 2, 5
DQN_HORIZON = 32
STAT_TOL = 2e-5
FLOAT_TOL = 1e-5


def alternating_segment(seed, t=12, n=6):
    """A seeded (t, n) segment whose players alternate per game from a
    random first seat, as a dual rollout's do."""
    a = seg_arrays(seed, t=t, n=n)
    first = np.random.RandomState(seed + 100).randint(0, 2, n)
    a["player"] = ((first[None, :] + np.arange(t)[:, None]) % 2).astype(
        np.int32)
    return a


def assert_fields(jtuple, ttuple, names, tol=1e-6, where=""):
    for name in names:
        a = np.asarray(getattr(jtuple, name))
        b = getattr(ttuple, name).numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.shape == b.shape and a.dtype == b.dtype, (where, name)
        if a.dtype == np.float32:
            assert np.abs(a - b).max() <= tol, (where, name,
                                                np.abs(a - b).max())
        else:
            assert (a == b).all(), (where, name)


def test_merge_and_subsegment_match_jax():
    a = alternating_segment(1)
    jm = jdual.merge_dual_transitions(jseg(a))
    tm = dual.merge_dual_transitions(tseg(a))
    assert_fields(jm, tm, tm._fields, tol=0.0, where="merge")
    assert (tm.done.numpy() >= a["done"]).all()
    for p in (0, 1):
        js = jdual.dual_policy_subsegment(jm, p)
        ts = dual.dual_policy_subsegment(tm, p)
        assert_fields(js, ts, ts._fields, tol=0.0, where=f"policy {p}")
        assert (ts.player.numpy() == p).all()


def test_split_dual_segment_matches_jax():
    """GAE per policy with unsigned gamma: the batches and stats."""
    a = alternating_segment(2)
    ppo = dataclasses.replace(config.load("r5_learning").ppo,
                              single_policy=False)
    v_last = np.random.RandomState(7).randn(6).astype(np.float32)
    jb0, jb1, jstats = jdual.split_dual_segment(
        jax_ppo_config(ppo), jseg(a), jnp.asarray(v_last))
    b0, b1, stats = dual.split_dual_segment(ppo, tseg(a),
                                            torch.from_numpy(v_last))
    for p, (jb, b) in enumerate(zip((jb0, jb1), (b0, b1))):
        assert_fields(jb, b, b._fields, where=f"batch {p}")
    assert set(jstats) == set(stats)
    for k, v in jstats.items():
        assert abs(float(v) - float(stats[k])) <= 1e-6, k
    # unsigned gamma: a negated gamma gives other advantages on the same
    # ticks
    neg, _, _ = dual.split_dual_segment(
        dataclasses.replace(ppo, gamma=-ppo.gamma), tseg(a),
        torch.from_numpy(v_last))
    assert (neg.advantage - b0.advantage).abs().max() > 1e-3


def jax_dual_gumbel(key, horizon, n, width):
    """The pi noise of JAX's dual rollout under ``key``: per tick key k,
    (k0, k1) = split(k), one categorical each."""
    out = []
    for k in jax.random.split(key, horizon):
        out.append(np.stack([np.asarray(jax.random.gumbel(
            kp, (n, 4 * width), jnp.float32)) for kp in jax.random.split(k)]))
    return torch.from_numpy(np.stack(out))


DUAL_KEY = 9


def rollout_kw(distribution):
    return dict(compute_dtype="float32", **SMALL), (
        "QNet" if distribution == "epsilon" else "PPONet")


def rollout_params():
    return [small_params(s) for s in (11, 12)]


def jax_dual_rollout(distribution) -> dict:
    """JAX's dual rollout from seeded params: the env state after it as
    leaves, the segment, the last values and (under pi) its
    gumbel draws (tests/jax_fixtures/dual_rollout_DISTRIBUTION.npz)."""
    kw, cls = rollout_kw(distribution)
    params = rollout_params()
    jnet = getattr(jnets, cls)(jnets.ModelConfig(**kw))
    jenv = JEnv(JEnvConfig(), N)
    js0 = jenv.reset(jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(DUAL_KEY)
    hp = None
    if distribution == "epsilon":
        from drl_tetris_tpu.algos.rollout import HParams as JHParams
        hp = JHParams(epsilon=jnp.float32(0.4), temperature=jnp.float32(1.0),
                      avg_traj_len=jnp.float32(12.0))
    js, jseg_, jlast = jdual.make_dual_rollout_fn(
        jenv, jnet, HORIZON, distribution)({"params": params[0]},
                                     {"params": params[1]}, js0, key, hp)
    out = dict(js=jax_leaves(js), jseg=jseg_, jlast=jlast)
    if distribution == "pi":
        out["gumbel"] = jax_dual_gumbel(key, HORIZON, N, 10).numpy()
    return out


@pytest.mark.parametrize("distribution", ["argmax", "pi", "epsilon"])
def test_dual_rollout_matches_jax(distribution):
    ref = fixtures.load(f"dual_rollout_{distribution}")
    kw, cls = rollout_kw(distribution)
    env = TetrisVectorEnv(EnvConfig(), N, device="cpu")
    tnets = []
    for p in rollout_params():
        net = getattr(nets, cls)(nets.ModelConfig(**kw), device="cpu")
        net.load_state_dict(params_from_flax(p))
        tnets.append(net)
    gumbel = (torch.from_numpy(ref["gumbel"]) if distribution == "pi"
              else None)
    tkey = torch.from_numpy(np.asarray(jax.random.key_data(
        jax.random.PRNGKey(DUAL_KEY))).astype(np.int64))
    from drl_tetris_tpu_torch.algos.rollout import HParams
    ts, seg, last = dual.make_dual_rollout_fn(env, tnets, HORIZON,
                                              distribution)(
        env.reset(3), gumbel=gumbel, key=tkey,
        hp=HParams(epsilon=0.4) if distribution == "epsilon" else None)
    assert_state_equal(ref["js"], ts, "after the dual rollout")
    assert_fields(types.SimpleNamespace(**ref["jseg"]), seg, seg._fields,
                  tol=FLOAT_TOL)
    assert np.abs(ref["jlast"] - last.numpy()).max() < FLOAT_TOL
    # both policies acted, each on its own seat
    assert set(seg.player.flatten().tolist()) == {0, 1}
    assert len(set(seg.trans.flatten().tolist())) > 1


def assert_params_close(jparams, net, lr, steps, where=""):
    ref = params_from_flax(jax.tree.map(np.asarray, jparams))
    tol = 2 * lr * steps + 1e-6
    for k, p in net.named_parameters():
        err = (p.detach() - ref[k]).abs().max().item()
        assert err <= tol, (where, k, err, tol)


def assert_stats_close(jstats, stats, mb):
    assert set(jstats) == set(stats), set(jstats) ^ set(stats)
    for k, v in jstats.items():
        v, got = float(v), float(stats[k])
        if "saturation" in k:
            assert abs(v - got) <= 1.0 / mb + 1e-6, (k, v, got)
        else:
            assert relerr(v, got) < STAT_TOL, (k, v, got)


def jkey(jtr):
    return np.asarray(jax.random.key_data(jtr.key))


def ppo_configs():
    ppo = dataclasses.replace(config.load("r5_learning").ppo,
                              single_policy=False, minibatch_size=MB,
                              n_train_epochs=EPOCHS)
    model = nets.ModelConfig(compute_dtype="float32", **SMALL)
    cfg = DualPolicyConfig(env=EnvConfig(), model=model, ppo=ppo, n_envs=N,
                           horizon=HORIZON, seed=SEED)
    jcfg = jstandalone.DualPolicyConfig(
        env=JEnvConfig(), model=jnets.ModelConfig(**dataclasses.asdict(model)),
        ppo=jax_ppo_config(ppo), n_envs=N, horizon=HORIZON, seed=SEED)
    return cfg, jcfg


def winrate(tr):
    return np.asarray(tr.winrate.rate_0)


def jax_ppo_iterations() -> dict:
    """JAX's DualPolicyTrainer: its initial params, reset and key, then
    per iteration its pi noise, stats, env state, key, win rate and params
    (tests/jax_fixtures/dual_ppo_iterations.npz)."""
    jtr = jstandalone.DualPolicyTrainer(ppo_configs()[1])
    out = dict(params=[jax.tree.map(np.asarray, s.params)
                       for s in jtr.states],
               reset=jax_leaves(jtr.env_state), key=jkey(jtr), its=[])
    for _ in range(2):
        _, kroll, _, _ = jax.random.split(jtr.key, 4)
        gumbel = jax_dual_gumbel(kroll, HORIZON, N, 10).numpy()
        jstats = jtr.train_iteration()
        out["its"].append(dict(
            gumbel=gumbel, stats={k: float(v) for k, v in jstats.items()},
            env=jax_leaves(jtr.env_state), key=jkey(jtr), rate=winrate(jtr),
            params=[jax.tree.map(np.asarray, s.params) for s in jtr.states]))
    return out


@pytest.fixture(scope="module")
def ppo_iterations():
    ref = fixtures.load("dual_ppo_iterations")
    cfg = ppo_configs()[0]
    tr = DualPolicyTrainer(cfg, device="cpu")
    for net, p in zip(tr.nets, ref["params"]):
        net.load_state_dict(params_from_flax(p))
    assert_state_equal(ref["reset"], tr.env_state, "reset")
    assert (tr.key.numpy().astype(np.uint32) == ref["key"]).all()
    out = []
    for want in ref["its"]:
        stats = tr.train_iteration(gumbel=torch.from_numpy(want["gumbel"]))
        out.append(dict(
            jstats=want["stats"], stats=dict(stats), jenv=want["env"],
            env=tr.env_state, jkey=want["key"],
            key=tr.key.numpy().astype(np.uint32),
            jrate=want["rate"], rate=tr.winrate.rate_0,
            jparams=want["params"],
            params=[{k: p.detach().clone() for k, p in n.named_parameters()}
                    for n in tr.nets], phase=dict(tr.phase_ms)))
    return dict(cfg=cfg, tr=tr, out=out)


def test_dual_ppo_trainer_matches_jax(ppo_iterations):
    cfg = ppo_iterations["cfg"]
    steps = EPOCHS * (N * HORIZON // 2 // MB)
    for it, r in enumerate(ppo_iterations["out"]):
        assert (r["key"] == r["jkey"]).all(), it
        assert_state_equal(r["jenv"], r["env"], f"after iteration {it}")
        assert r["rate"] == r["jrate"], it
        assert_stats_close(r["jstats"], r["stats"], MB)
        assert any(k.startswith("policy_1/") for k in r["stats"])
        for p in (0, 1):
            net = nets.PPONet(cfg.model, device="cpu")
            net.load_state_dict(r["params"][p])
            assert_params_close(r["jparams"][p], net, cfg.ppo.lr,
                                (it + 1) * steps, f"iteration {it} policy {p}")
        assert set(r["phase"]) == {"rollout", "split", "update_0",
                                   "update_1"}
    tr = ppo_iterations["tr"]
    assert tr.total_steps == 2 * N * HORIZON
    assert [s.update_count for s in tr.states] == [2, 2]
    # the checkpoint view is policy 0 in the PPO trainer's form
    sd = tr.state_dict()
    assert set(sd) == {"params", "adam", "adv_comp", "vloss_comp",
                       "update_count", "total_steps", "key"}
    assert all(torch.equal(sd["params"][k], p) for k, p in
               tr.nets[0].state_dict().items())


def dqn_configs_kw():
    from drl_tetris_tpu_torch.config import presets
    from drl_tetris_tpu.config import presets as jpresets
    got = presets.load(DQN_PRESETS, OVERRIDES)
    ref = jpresets.resolve(jpresets.merge_settings(DQN_PRESETS, OVERRIDES))
    kw = dict(n_envs=N, horizon=DQN_HORIZON, epsilon=0.3, seed=SEED,
              train_distribution="adaptive_epsilon")
    return got, ref, kw


def replay_rows(jst) -> dict:
    return {f.name: np.asarray(getattr(jst, f.name))
            for f in dataclasses.fields(replay.ReplayState)}


def jax_dqn_iterations() -> dict:
    """JAX's DualPolicyDQNTrainer: its initial params and reference params,
    its reset, then per iteration both replays, the stats, env state, key,
    win rate, trajectory-length EMA and params
    (tests/jax_fixtures/dual_dqn_iterations.npz)."""
    _, ref, kw = dqn_configs_kw()
    jtr = jstandalone.DualPolicyDQNTrainer(jstandalone.DualPolicyDQNConfig(
        env=ref.env, model=ref.model, dqn=ref.dqn, replay=ref.replay, **kw))
    out = dict(params=[jax.tree.map(np.asarray, s.params)
                       for s in jtr.states],
               ref_params=[jax.tree.map(np.asarray, s.ref_params)
                           for s in jtr.states],
               reset=jax_leaves(jtr.env_state), its=[])
    for _ in range(2):
        jstats = jtr.train_iteration()
        out["its"].append(dict(
            replays=[replay_rows(r) for r in jtr.replays],
            stats={k: float(v) for k, v in jstats.items()},
            env=jax_leaves(jtr.env_state), key=jkey(jtr), rate=winrate(jtr),
            atl=float(jtr.avg_traj_len),
            params=[jax.tree.map(np.asarray, s.params) for s in jtr.states]))
    return out


@pytest.fixture(scope="module")
def dqn_iterations():
    ref = fixtures.load("dual_dqn_iterations")
    got, _, kw = dqn_configs_kw()
    cfg = DualPolicyDQNConfig(env=got.env, model=got.model, dqn=got.dqn,
                              replay=got.replay, **kw)
    tr = DualPolicyDQNTrainer(cfg, device="cpu")
    for net, p in zip(tr.nets, ref["params"]):
        net.load_state_dict(params_from_flax(p))
    for st, p in zip(tr.states, ref["ref_params"]):
        st.ref_net.load_state_dict(params_from_flax(p))
    assert_state_equal(ref["reset"], tr.env_state, "reset")
    out = []
    for want in ref["its"]:
        stats = tr.train_iteration()
        for p in (0, 1):
            assert_replay_rows_equal(
                types.SimpleNamespace(**want["replays"][p]), tr.replays[p])
        out.append(dict(
            jstats=want["stats"], stats=dict(stats), jenv=want["env"],
            env=tr.env_state, jkey=want["key"],
            key=tr.key.numpy().astype(np.uint32),
            jrate=want["rate"], rate=tr.winrate.rate_0,
            jatl=float(want["atl"]), atl=float(tr.avg_traj_len),
            jprio=[r["prio"] for r in want["replays"]],
            prio=[r.prio.clone() for r in tr.replays],
            jparams=want["params"],
            params=[{k: p.detach().clone() for k, p in n.named_parameters()}
                    for n in tr.nets], phase=dict(tr.phase_ms)))
    return dict(cfg=cfg, tr=tr, out=out)


# slow: JAX's dual rollouts and trainers, 100-150 s each cold
@pytest.mark.slow
@pytest.mark.parametrize("name, compute", [
    ("dual_rollout_argmax", lambda: jax_dual_rollout("argmax")),
    ("dual_rollout_pi", lambda: jax_dual_rollout("pi")),
    ("dual_rollout_epsilon", lambda: jax_dual_rollout("epsilon")),
    ("dual_ppo_iterations", jax_ppo_iterations),
    ("dual_dqn_iterations", jax_dqn_iterations)])
def test_dual_fixture_regenerates(name, compute):
    fixtures.regenerates(name, compute)


def test_dual_dqn_trainer_matches_jax(dqn_iterations):
    cfg = dqn_iterations["cfg"]
    steps = cfg.dqn.n_train_epochs * (cfg.dqn.n_samples_each_update
                                      // cfg.dqn.minibatch_size)
    for it, r in enumerate(dqn_iterations["out"]):
        assert (r["key"] == r["jkey"]).all(), it
        assert_state_equal(r["jenv"], r["env"], f"after iteration {it}")
        assert r["rate"] == r["jrate"], it
        assert abs(r["atl"] - r["jatl"]) <= 1e-5 * r["jatl"], it
        assert_stats_close(r["jstats"], r["stats"], cfg.dqn.minibatch_size)
        for p in (0, 1):
            assert np.abs(r["prio"][p].numpy() - r["jprio"][p]).max() \
                < PRIO_TOL, (it, p)
            net = nets.QNet(cfg.model, device="cpu")
            net.load_state_dict(r["params"][p])
            assert_params_close(r["jparams"][p], net, cfg.dqn.lr,
                                (it + 1) * steps, f"iteration {it} policy {p}")
        assert set(r["phase"]) == {"rollout", "replay_add", "targets_0",
                                   "update_0", "targets_1", "update_1"}
    tr = dqn_iterations["tr"]
    assert [s.update_count for s in tr.states] == [2, 2]
    assert [r.size for r in tr.replays] == [2 * N * DQN_HORIZON // 2] * 2
    # the estimator bootstraps with unsigned gamma
    assert not tr.dqn_cfg.estimator.single_policy
    assert set(tr.state_dict()) == {"params", "ref_params", "adam",
                                    "update_count", "total_steps", "key"}


def _tiny_ppo_trainer():
    ppo = dataclasses.replace(config.load().ppo, single_policy=False,
                              minibatch_size=16, n_train_epochs=1, lr=1e-3)
    return DualPolicyTrainer(DualPolicyConfig(
        model=nets.ModelConfig(compute_dtype="float32", **SMALL), ppo=ppo,
        n_envs=4, horizon=8, seed=2), device="cpu")


def _tiny_dqn_trainer():
    got, _ = dqn_configs()
    return DualPolicyDQNTrainer(DualPolicyDQNConfig(
        env=got.env, model=got.model, dqn=got.dqn, replay=got.replay,
        n_envs=8, horizon=DQN_HORIZON, seed=2), device="cpu")


@pytest.mark.parametrize("make", [_tiny_ppo_trainer, _tiny_dqn_trainer],
                         ids=["ppo", "dqn"])
def test_winrate_gate_keeps_the_leading_policy(make):
    tr = make()
    tr.train_iteration()           # the DQN replays fill past the sample
    tr.winrate.rate_0 = 0.95       # policy 0 far ahead
    assert not tr.winrate.should_train(0) and tr.winrate.should_train(1)
    before = [[p.detach().clone() for p in n.parameters()] for n in tr.nets]
    stats = tr.train_iteration()
    # from 0.95 the segment's winners cannot bring the EMA under 0.6
    assert not any(k.startswith("policy_0/") for k in stats)
    assert any(k.startswith("policy_1/") for k in stats)
    assert all(torch.equal(a, b) for a, b in
               zip(before[0], tr.nets[0].parameters()))
    assert any(not torch.equal(a, b) for a, b in
               zip(before[1], tr.nets[1].parameters()))
    assert stats["winrate/policy_0"] > 0.6


def test_dual_trainers_refuse_odd_horizons_and_single_policy():
    model = nets.ModelConfig(compute_dtype="float32", **SMALL)
    with pytest.raises(ValueError):
        DualPolicyTrainer(DualPolicyConfig(model=model, horizon=7, n_envs=2),
                          device="cpu")
    with pytest.raises(ValueError):
        DualPolicyTrainer(DualPolicyConfig(
            model=model, ppo=config.load().ppo, n_envs=2, horizon=4),
            device="cpu")
    with pytest.raises(ValueError):
        DualPolicyDQNTrainer(DualPolicyDQNConfig(model=model, horizon=5),
                             device="cpu")
