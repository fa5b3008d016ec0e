"""The port's SVENton-DQN (algos/dqn.py, runtime/standalone.py
``StandaloneDQNTrainer``, the QNet policy and the DQN state converters)
against the JAX package's, on a small float32 QNet (``SMALL``), the 22 x 10
board, 8 games x horizon 16, rank replay of 400 rows, k = 5 with the step
filter (2,), 64 samples per update in minibatches of 16 over 2 epochs (8
Adam steps, lr 1e-4):

* the DQN presets resolve to JAX's DQNConfig, ReplayConfig and sampling
  settings;
* the QNet rollout under ``pareto_distribution``, JAX's gumbel draws
  injected: ints and boards equal, floats within 1e-5;
* one ``make_dqn_update`` from the same replay, weights and key (the
  sample's noise follows JAX's key): the sampled rows in JAX's order, the
  targets within 1e-5, the new priorities within PRIO_TOL, the parameters
  within 2 x lr x steps + 1e-6 (Adam can step a weight whose gradient is
  ulps from zero either way, tests/test_torch_ppo.py), the reference net
  synced, the loss terms within STAT_TOL;
* two ``StandaloneDQNTrainer`` iterations under ``adaptive_epsilon``
  (epsilon 0.3) from JAX's initial weights: the epsilon draws and the
  replay sample follow JAX's keys with nothing injected; after each, the
  key, the env state and the replay's rows bit-exact, its priorities
  within PRIO_TOL, the EMA of trajectory lengths within 1e-5 relative,
  the stats within STAT_TOL and the parameters within the Adam bound;
* the trainer's state through ``state.pt`` bit for bit, and a JAX
  ``DQNState`` through ``dqn_state_from_flax`` and back bit for bit; the
  JAX checkpoint through tools/torch_import_flax_checkpoint.py, resumed
  into the port: its next update on the same replay matches JAX's next
  update within the same tolerances.
Measured on the CPU: targets 1.5e-7, priorities 2.4e-6, loss terms 5.5e-6
relative, parameters 6.8e-8 absolute; PRIO_TOL and STAT_TOL are about 4x
the gaps.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import assert_state_equal, rekey_jax_cache

rekey_jax_cache()

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.algos import dqn as jdqn  # noqa: E402
from drl_tetris_tpu.algos import replay as jreplay  # noqa: E402
from drl_tetris_tpu.algos import value_estimator as jve  # noqa: E402
from drl_tetris_tpu.algos.rollout import make_rollout_fn as j_rollout_fn  # noqa: E402
from drl_tetris_tpu.config import presets as jpresets  # noqa: E402
from drl_tetris_tpu.engine.core import EngineConfig as JEngineConfig  # noqa: E402
from drl_tetris_tpu.env.env import (EnvConfig as JEnvConfig,  # noqa: E402
                                    TetrisVectorEnv as JEnv)
from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu.runtime import checkpoint as jckpt  # noqa: E402
from drl_tetris_tpu.runtime import standalone as jstandalone  # noqa: E402
from drl_tetris_tpu_torch.algos import dqn  # noqa: E402
from drl_tetris_tpu_torch.algos import replay  # noqa: E402
from drl_tetris_tpu_torch.algos.rollout import make_rollout_fn  # noqa: E402
from drl_tetris_tpu_torch.config import presets  # noqa: E402
from drl_tetris_tpu_torch.engine.core import EngineConfig  # noqa: E402
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv  # noqa: E402
from drl_tetris_tpu_torch.models import nets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import (dqn_state_from_flax,  # noqa: E402
                                                 dqn_state_to_flax,
                                                 params_from_flax)
from drl_tetris_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from drl_tetris_tpu_torch.runtime.standalone import (  # noqa: E402
    StandaloneDQNConfig, StandaloneDQNTrainer)
from tests.test_torch_nets import SMALL, small_params  # noqa: E402
from tests.test_torch_ppo import relerr  # noqa: E402
from tests.test_torch_replay import (assert_replay_equal, jseg,  # noqa: E402
                                     seg_arrays, tseg)

DQN_PRESETS = ["default", "sventon", "sventon_dqn", "resblock",
               "experiment_sventon_dqn"]
N, HORIZON, SEED = 8, 16, 3
OVERRIDES = dict(compute_dtype="float32", n_step_value_estimates=5,
                 sparse_value_estimate_filter=[2], n_samples_each_update=64,
                 minibatch_size=16, n_train_epochs_per_update=2,
                 experience_replay_size=400, **SMALL)
STEPS = 2 * 64 // 16
PRIO_TOL = 1e-5
STAT_TOL = 2.5e-5


def configs():
    got = presets.load(DQN_PRESETS, OVERRIDES)
    ref = jpresets.resolve(jpresets.merge_settings(DQN_PRESETS, OVERRIDES))
    return got, ref


def test_dqn_presets_match_jax():
    got, ref = configs()
    assert dataclasses.asdict(got.dqn) == dataclasses.asdict(ref.dqn)
    assert dataclasses.asdict(got.replay) == dataclasses.asdict(ref.replay)
    assert dataclasses.asdict(got.model) == dataclasses.asdict(ref.model)
    for k in ("flavour", "train_distribution", "eval_distribution",
              "tau_learning_rate"):
        assert getattr(got, k) == getattr(ref, k), k
    from drl_tetris_tpu.config.parameter import param_eval as jparam_eval
    from drl_tetris_tpu_torch.config.parameter import param_eval
    for k in ("epsilon", "action_temperature"):
        for t in (0, 10**6):
            assert param_eval(getattr(got, k), t) == \
                jparam_eval(getattr(ref, k), t), k
    full = presets.load(DQN_PRESETS)
    assert full.replay.capacity == 2_000_000 and full.replay.k_step == 37
    assert full.replay.sample_mode == "rank"
    assert len(full.dqn.estimator.steps) == 13


def tkey(jkey):
    return torch.from_numpy(np.asarray(jax.random.key_data(jkey)).astype(
        np.int64))


def test_qnet_pareto_rollout_matches_jax():
    got, ref = configs()
    params = small_params(8)
    jnet = jnets.QNet(ref.model)
    jenv = JEnv(JEnvConfig(), N)
    js0 = jenv.reset(jax.random.PRNGKey(4))
    key = jax.random.PRNGKey(6)
    js, jseg_, jlast = j_rollout_fn(jenv, jnet, 8, "pareto_distribution")(
        {"params": params}, js0, key)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (N, 40), jnp.float32))
                       for k in jax.random.split(key, 8)])
    env = TetrisVectorEnv(EnvConfig(), N, device="cpu")
    net = nets.QNet(got.model, device="cpu")
    net.load_state_dict(params_from_flax(params))
    ts, seg, last = make_rollout_fn(env, net, 8, "pareto_distribution")(
        env.reset(4), gumbel=torch.from_numpy(gumbel))
    assert_state_equal(js, ts, "after the rollout")
    for name in seg._fields:
        a, b = np.asarray(getattr(jseg_, name)), getattr(seg, name).numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == np.float32:
            assert np.abs(a - b).max() < 1e-5, name
        else:
            assert (a == b).all(), name
    assert np.abs(np.asarray(jlast) - last.numpy()).max() < 1e-5
    assert len(set(seg.trans.flatten().tolist())) > 3


def both_replays(cfg, jcfg, n_segments=2):
    jst, st = jreplay.replay_init(jcfg), replay.replay_init(cfg, "cpu")
    for seed in range(n_segments):
        a = seg_arrays(seed, t=HORIZON, n=N)
        jst = jreplay.replay_add_segment(jcfg, jst, jseg(a), HORIZON)
        replay.replay_add_segment(cfg, st, tseg(a), HORIZON)
    assert_replay_equal(jst, st)
    return jst, st


def assert_params_close(jparams, net, lr, steps, where=""):
    ref = params_from_flax(jax.tree.map(np.asarray, jparams["params"]))
    tol = 2 * lr * steps + 1e-6
    worst = 0.0
    for k, p in net.named_parameters():
        err = (p.detach() - ref[k]).abs().max().item()
        assert err <= tol, (where, k, err, tol)
        worst = max(worst, err)
    return worst


def assert_stats_close(jstats, stats):
    jstats = {k: float(v) for k, v in jstats.items()}
    stats = {k: float(v) for k, v in stats.items()}
    assert set(jstats) == set(stats)
    for k, v in jstats.items():
        assert relerr(v, stats[k]) < STAT_TOL, (k, v, stats[k])


@pytest.fixture(scope="module")
def one_update():
    got, ref = configs()
    jst, st = both_replays(got.replay, ref.replay)
    params = small_params(6)
    key, alpha, beta = jax.random.PRNGKey(12), 0.7, 0.5
    jnet = jnets.QNet(ref.model)
    jinit, jupdate = jdqn.make_dqn_update(JEngineConfig(), jnet, ref.dqn,
                                          ref.replay)
    ks, _ = jax.random.split(key)
    jidx, _ = jreplay.replay_sample(ref.replay, jst, ks, 64,
                                    jnp.float32(alpha), jnp.float32(beta))
    jwin = jreplay.replay_gather_windows(ref.replay, jst, jidx)
    jtargets = jve.kstep_targets(JEngineConfig(), jnet, ref.dqn.estimator,
                                 {"params": params}, jwin)
    jstate, jst2, jstats = jupdate(jinit({"params": params}), jst, key,
                                   jnp.float32(alpha), jnp.float32(beta))

    net = nets.QNet(got.model, device="cpu")
    net.load_state_dict(params_from_flax(params))
    init_fn, update_fn = dqn.make_dqn_update(EngineConfig(), net, got.dqn,
                                             got.replay)
    state = init_fn()
    idx, _, samples, _ = dqn.sample_for_update(
        EngineConfig(), got.dqn, got.replay, state.ref_net, st, tkey(key),
        alpha, beta)
    state, st, stats = update_fn(state, st, tkey(key), alpha, beta)
    return dict(cfg=got, jidx=np.asarray(jidx), idx=idx.numpy(),
                jtargets=np.asarray(jtargets), targets=samples["target"],
                jstate=jstate, jst=jst2, jstats=jstats, state=state, st=st,
                stats=stats, params=params_from_flax(params))


def test_update_samples_and_targets(one_update):
    r = one_update
    assert (r["idx"] == r["jidx"]).all()
    assert np.abs(r["targets"].numpy() - r["jtargets"]).max() < 1e-5
    assert r["jtargets"].std() > 1e-3


def test_update_priorities_parameters_and_stats(one_update):
    r = one_update
    jprio, prio = np.asarray(r["jst"].prio), r["st"].prio.numpy()
    assert np.abs(jprio - prio).max() < PRIO_TOL
    untouched = np.setdiff1d(np.arange(len(prio)), r["idx"])
    assert (prio[untouched] == jprio[untouched]).all()
    assert (prio[r["idx"]] != 2.0).mean() > 0.9    # rewritten from 2.0
    cfg = r["cfg"].dqn
    assert_params_close(r["jstate"].params, r["state"].net, cfg.lr, STEPS)
    # time_to_reference_update 1: the reference is the updated net
    for (k, p), q in zip(r["state"].net.named_parameters(),
                         r["state"].ref_net.parameters()):
        assert torch.equal(p.detach(), q), k
    assert r["state"].update_count == int(r["jstate"].update_count) == 1
    assert_stats_close(r["jstats"], r["stats"])
    moved = max((p.detach() - r["params"][k]).abs().max().item()
                for k, p in r["state"].net.named_parameters())
    assert moved > 0.5 * cfg.lr


def trainer_configs():
    got, ref = configs()
    cfg = StandaloneDQNConfig(
        env=got.env, model=got.model, dqn=got.dqn, replay=got.replay,
        n_envs=N, horizon=HORIZON, train_distribution="adaptive_epsilon",
        epsilon=0.3, seed=SEED)
    jcfg = jstandalone.StandaloneDQNConfig(
        env=ref.env, model=ref.model, dqn=ref.dqn, replay=ref.replay,
        n_envs=N, horizon=HORIZON, train_distribution="adaptive_epsilon",
        epsilon=0.3, seed=SEED)
    return cfg, jcfg


@pytest.fixture(scope="module")
def two_iterations(tmp_path_factory):
    cfg, jcfg = trainer_configs()
    jtr = jstandalone.StandaloneDQNTrainer(jcfg)
    tr = StandaloneDQNTrainer(cfg, device="cpu")
    sd = params_from_flax(jax.tree.map(np.asarray,
                                       jtr.state.params["params"]))
    tr.net.load_state_dict(sd)
    tr.state.ref_net.load_state_dict(sd)
    assert_state_equal(jtr.env_state, tr.env_state, "reset")
    out = []
    for it in range(2):
        jstats = jtr.train_iteration()
        stats = tr.train_iteration()
        out.append(dict(
            jstats=dict(jstats), stats=dict(stats), jenv=jtr.env_state,
            env=tr.env_state, jkey=np.asarray(jax.random.key_data(jtr.key)),
            key=tr.key.numpy().astype(np.uint32),
            jatl=float(jtr.avg_traj_len), atl=float(tr.avg_traj_len),
            jprio=np.asarray(jtr.replay.prio), prio=tr.replay.prio.clone(),
            jparams=jtr.state.params, steps=tr.total_steps,
            params={k: p.detach().clone()
                    for k, p in tr.net.named_parameters()}))
        assert_replay_rows_equal(jtr.replay, tr.replay)
    d = str(tmp_path_factory.mktemp("dqn"))
    jckpt.save(d, jtr.total_steps, jtr.state)
    return dict(cfg=cfg, jcfg=jcfg, jtr=jtr, tr=tr, out=out, jax_dir=d,
                raw=jckpt.restore_raw(d))


def assert_replay_rows_equal(jst, st):
    for f in dataclasses.fields(replay.ReplayState):
        if f.name == "prio":
            continue
        a, b = np.asarray(getattr(jst, f.name)), getattr(st, f.name)
        if torch.is_tensor(b):
            b = b.numpy()
            if a.dtype == np.uint32:
                b = b.view(np.uint32)
        assert (a == b).all(), f.name


def test_trainer_key_env_and_ema(two_iterations):
    for it, r in enumerate(two_iterations["out"]):
        assert (r["key"] == r["jkey"]).all(), it
        assert_state_equal(r["jenv"], r["env"], f"after iteration {it}")
        assert abs(r["atl"] - r["jatl"]) <= 1e-5 * r["jatl"], it
        assert r["steps"] == (it + 1) * N * HORIZON
    assert two_iterations["out"][1]["atl"] != 12.0        # the EMA moved


def test_trainer_updates(two_iterations):
    cfg = two_iterations["cfg"]
    for it, r in enumerate(two_iterations["out"]):
        assert np.abs(r["prio"].numpy() - r["jprio"]).max() < PRIO_TOL, it
        assert_stats_close(r["jstats"], r["stats"])
        net = nets.QNet(cfg.model, device="cpu")
        net.load_state_dict(r["params"])
        assert_params_close(r["jparams"], net, cfg.dqn.lr,
                            (it + 1) * STEPS, f"iteration {it}")
    assert two_iterations["tr"].state.update_count == 2


def test_state_pt_round_trip(two_iterations, tmp_path):
    tr = two_iterations["tr"]
    want = ckpt.state_checksum(tr.state_dict())
    ckpt.save(str(tmp_path), tr.total_steps, tr.state_dict())
    fresh = StandaloneDQNTrainer(two_iterations["cfg"], device="cpu")
    ckpt.restore(str(tmp_path), fresh)
    assert ckpt.state_checksum(fresh.state_dict()) == want
    for a, b in zip(fresh.state.ref_net.parameters(),
                    tr.state.ref_net.parameters()):
        assert torch.equal(a, b)
    raw = ckpt.restore_raw(str(tmp_path))
    assert set(raw) == {"params", "ref_params", "adam", "update_count",
                        "total_steps", "key"}


def test_dqn_state_converters_round_trip(two_iterations):
    raw = two_iterations["raw"]
    back = dqn_state_to_flax(dqn_state_from_flax(raw))
    ja = jax.tree_util.tree_flatten_with_path(raw)[0]
    jb = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in ja] == [p for p, _ in jb]
    for (path, a), (_, b) in zip(ja, jb):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert (a == b).all(), path


def test_converted_jax_state_next_update(two_iterations, tmp_path):
    """A JAX DQNState checkpoint through tools/torch_import_flax_checkpoint
    (restore_raw, dqn_state_from_flax, the port's state.pt), resumed into
    a fresh port trainer; the next update from the same replay and key
    matches JAX's."""
    from tools.torch_import_flax_checkpoint import convert
    r = two_iterations
    jtr, cfg = r["jtr"], r["cfg"]
    step = convert(r["jax_dir"], str(tmp_path))
    assert step == jtr.total_steps
    tr = StandaloneDQNTrainer(cfg, device="cpu")
    tr.resume(ckpt.restore_raw(str(tmp_path), step), step)
    assert tr.state.update_count == 2 and tr.total_steps == jtr.total_steps
    st = replay.replay_init(cfg.replay, "cpu")
    for f in dataclasses.fields(replay.ReplayState):
        a = np.asarray(getattr(jtr.replay, f.name))
        if a.ndim:
            a = a.view(np.int32) if a.dtype == np.uint32 else a
            getattr(st, f.name).copy_(torch.from_numpy(a.copy()))
        else:
            setattr(st, f.name, int(a))
    key, alpha, beta = jax.random.PRNGKey(77), 0.7, 0.7
    jstate, jst, jstats = jtr.update(jtr.state, jtr.replay, key,
                                     jnp.float32(alpha), jnp.float32(beta))
    state, st, stats = tr.update(tr.state, st, tkey(key), alpha, beta)
    assert np.abs(st.prio.numpy() - np.asarray(jst.prio)).max() < PRIO_TOL
    assert_stats_close(jstats, stats)
    assert_params_close(jstate.params, state.net, cfg.dqn.lr, STEPS)
    assert state.update_count == int(jstate.update_count) == 3
    steps = {int(s["step"]) for s in state.optimizer.state.values()}
    assert steps == {3 * STEPS}
