"""The port's SIXten (algos/sixten.py, StandaloneSIXtenTrainer) against the
JAX package's, on a small float32 VNet and the 22 x 10 board:

* VNet with ``separate_piece_values`` on and off, the same weights through
  the converter: outputs within 1e-5 of the largest output (float32), the
  first-step gradients within GRAD_TOL of each leaf's largest;
  bfloat16 within BF16_TOL; the flax tree through the converter and back
  bit for bit;
* the world-model policy in the top-drop and the full space under each
  distribution (epsilon, adaptive_epsilon, argmax, boltzmann), every draw
  from JAX's key through the port's threefry: the same choice, probability
  and masks, the values within 1e-5;
* one update (the prioritized sample, make_target_fn's k-step targets,
  IS-weighted MSE, the new priorities, the reference sync) from the same
  replay, weights and key: the rows in JAX's order, targets within 1e-5,
  priorities within PRIO_TOL, parameters within Adam's bound
  (2 x lr x steps + 1e-6), the loss terms within STAT_TOL;
* two StandaloneSIXtenTrainer iterations from the same weights (redrawn
  so that no two successors' values tie; epsilon 0.3, an update in
  each): the key, the env state and the
  replay's rows bit-exact, priorities, parameters and stats as above.

JAX's policies and trainer iterations are committed (tests/jax_fixtures/
sixten_*.npz, tests/torch_jax_fixtures.py); ``slow`` tests run them again
with JAX and hold them to the files.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import (assert_state_equal, jax_leaves,
                                      rekey_jax_cache, to_torch_state)

rekey_jax_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.algos import replay as jreplay  # noqa: E402
from drl_tetris_tpu.algos import sixten as jsixten  # noqa: E402
from drl_tetris_tpu.algos import value_estimator as jve  # noqa: E402
from drl_tetris_tpu.algos.rollout import HParams as JHParams  # noqa: E402
from drl_tetris_tpu.engine.core import EngineConfig as JEngineConfig  # noqa: E402
from drl_tetris_tpu.env.env import (EnvConfig as JEnvConfig,  # noqa: E402
                                    TetrisVectorEnv as JEnv)
from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu.runtime import standalone as jstandalone  # noqa: E402

from drl_tetris_tpu_torch.algos import replay, sixten  # noqa: E402
from drl_tetris_tpu_torch.algos.rollout import HParams  # noqa: E402
from drl_tetris_tpu_torch.algos.value_estimator import EstimatorConfig  # noqa: E402
from drl_tetris_tpu_torch.engine import checks  # noqa: E402
from drl_tetris_tpu_torch.engine.core import EngineConfig  # noqa: E402
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv  # noqa: E402
from drl_tetris_tpu_torch.models.convert import (params_from_flax,  # noqa: E402
                                                 params_to_flax)
from drl_tetris_tpu_torch.models.nets import ModelConfig  # noqa: E402
from drl_tetris_tpu_torch.runtime.standalone import (  # noqa: E402
    StandaloneSIXtenConfig, StandaloneSIXtenTrainer)
from tests.test_torch_env_spaces import to_jax_state  # noqa: E402
from tests.test_torch_nets import make_inputs, randomize  # noqa: E402
from tests.test_torch_ppo import relerr  # noqa: E402
from tests.test_torch_replay import jseg, seg_arrays, tseg  # noqa: E402
from tests import torch_jax_fixtures as fixtures  # noqa: E402

TINY = dict(tower_layers=1, tower_filters=4, val_layers=2, val_filters=4)
BF16_TOL = 0.05
PRIO_TOL = 1e-5
STAT_TOL = 2.5e-5
N = 6


def jvnet_params(model, seed):
    """Redrawn VNet weights whose values stay off tanh's flat ends: the
    value stream carries the observation's x (3 at spawn) through the
    peepholes into the value channel, so its last bias cancels it; else
    the successors' values differ by less than the frameworks' float32
    gap."""
    vecs, viss = make_inputs(2, 0)
    net = jsixten.VNet(model)
    p = net.init(jax.random.PRNGKey(0), [jnp.asarray(v) for v in vecs],
                 [jnp.asarray(v) for v in viss])["params"]
    p = randomize(jax.tree.map(np.asarray, p), seed)
    last = f"Conv_{model.val_layers - 1}"
    p["ResidualBlock_4"][last]["bias"][0] -= 3.0
    return p


def port_vnet(model_kw, params):
    net = sixten.VNet(ModelConfig(**model_kw), device="cpu")
    net.load_state_dict(params_from_flax(params))
    return net


@pytest.mark.parametrize("separate", [True, False])
def test_vnet_matches_jax(separate):
    kw = dict(compute_dtype="float32", separate_piece_values=separate,
              **TINY)
    params = jvnet_params(jnets.ModelConfig(**kw), 3)
    back = params_to_flax(params_from_flax(params))["params"]
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb and a.dtype == b.dtype and (a == b).all(), pa
    vecs, viss = make_inputs(8, 5, unit_vec=True)
    ref = np.asarray(jsixten.VNet(jnets.ModelConfig(**kw)).apply(
        {"params": params}, [jnp.asarray(v) for v in vecs],
        [jnp.asarray(v) for v in viss]))
    with torch.no_grad():
        got = port_vnet(kw, params)([torch.from_numpy(v) for v in vecs],
                                    [torch.from_numpy(v) for v in viss])
    assert ref.shape == tuple(got.shape) == (8, 7 if separate else 1)
    scale = np.abs(ref).max()
    assert np.abs(ref - got.numpy()).max() <= 1e-5 * scale
    assert ref.std() > 1e-3
    assert_first_step_gradients(jsixten.VNet(jnets.ModelConfig(**kw)),
                                port_vnet(kw, params), params, vecs, viss)
    kw16 = dict(kw, compute_dtype="bfloat16")
    ref16 = np.asarray(jsixten.VNet(jnets.ModelConfig(**kw16)).apply(
        {"params": params}, [jnp.asarray(v) for v in vecs],
        [jnp.asarray(v) for v in viss]))
    with torch.no_grad():
        got16 = port_vnet(kw16, params)([torch.from_numpy(v) for v in vecs],
                                        [torch.from_numpy(v) for v in viss])
    assert np.abs(ref16 - got16.numpy()).max() <= BF16_TOL


GRAD_TOL = 1e-4       # tests/test_torch_ppo.py's, relative to each leaf


def assert_first_step_gradients(jnet, net, params, vecs, viss):
    """The gradient of a fixed random projection of the net's outputs,
    per parameter, within GRAD_TOL of that leaf's largest |g|."""
    rs = np.random.RandomState(0)

    def weights(outs):
        return [rs.standard_normal(np.shape(o)).astype(np.float32)
                for o in outs]
    jv, tv = [jnp.asarray(v) for v in vecs], [jnp.asarray(v) for v in viss]
    outs = jnet.apply({"params": params}, jv, tv)
    outs = outs if isinstance(outs, tuple) else (outs,)
    w = weights(outs)

    def loss(p):
        o = jnet.apply({"params": p}, jv, tv)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(a * b) for a, b in zip(o, w))
    ref = params_from_flax(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    o = net([torch.from_numpy(v) for v in vecs],
            [torch.from_numpy(v) for v in viss])
    o = o if isinstance(o, tuple) else (o,)
    names, leaves = zip(*net.named_parameters())
    # SherlockNet's trunk computes an action head its outputs do not read:
    # no gradient there (JAX's is zero)
    grads = torch.autograd.grad(sum(torch.sum(a * torch.from_numpy(b))
                                    for a, b in zip(o, w)), leaves,
                                allow_unused=True)
    assert set(names) == set(ref)
    # a leaf whose gradient vanishes analytically (the phi head's bias under
    # its spatial softmax: a sum of 220 cancelling terms) holds float noise
    # in both frameworks (2e-8 and 9e-8 here): its scale floors at 1e-3 of
    # the largest gradient of any leaf
    floor = 1e-3 * max(r.abs().max().item() for r in ref.values())
    for k, g in zip(names, grads):
        g = torch.zeros_like(ref[k]) if g is None else g
        scale = max(ref[k].abs().max().item(), floor)
        err = (g - ref[k]).abs().max().item()
        assert err <= GRAD_TOL * scale, (k, err, scale)


def crowded_states(reset_leaves):
    """The port's env state of N games on crowded boards from JAX's reset
    (as leaves), and its JAX twin."""
    jenv = JEnv(JEnvConfig(), N)
    tenv = TetrisVectorEnv(EnvConfig(), N, device="cpu")
    ts = checks.crowded(tenv.cfg, to_torch_state(reset_leaves,
                                                 tenv.reset(8)), seed=2)
    return jenv, tenv, ts


DISTS = ("epsilon", "adaptive_epsilon", "argmax", "boltzmann")
POLICY_KEY = 21


def jax_policy_run(space) -> dict:
    """JAX's world-model policy under each distribution on crowded boards
    from its key: JAX's reset as leaves, and each distribution's outputs
    (tests/jax_fixtures/sixten_policy_SPACE.npz)."""
    kw = dict(compute_dtype="float32", **TINY)
    js0 = JEnv(JEnvConfig(), N).reset(jax.random.PRNGKey(8))
    jenv, _, ts = crowded_states(jax_leaves(js0))
    js = to_jax_state(ts, js0)
    params = jvnet_params(jnets.ModelConfig(**kw), 4)
    jnet = jsixten.VNet(jnets.ModelConfig(**kw))
    jhp = JHParams(epsilon=jnp.float32(0.4), temperature=jnp.float32(1.0),
                   avg_traj_len=jnp.float32(0.8))
    jpols = [jsixten.make_sixten_policy(jenv, jnet, d, 0.4, space)
             for d in DISTS]
    refs = jax.jit(lambda p, s, k: [pol(p, s, k, jhp)[1:] for pol in jpols]
                   )({"params": params}, js, jax.random.PRNGKey(POLICY_KEY))
    return dict(reset=jax_leaves(js0), refs=[
        [np.asarray(a) for a in ref] for ref in refs])


@pytest.mark.parametrize("space", ["top_drop", "full"])
def test_policy_matches_jax(space):
    """Every distribution chooses JAX's action from JAX's key."""
    ref = fixtures.load(f"sixten_policy_{space}")
    _, tenv, ts = crowded_states(ref["reset"])
    kw = dict(compute_dtype="float32", **TINY)
    hp = HParams(epsilon=0.4, temperature=1.0, avg_traj_len=0.8)
    net = port_vnet(kw, jvnet_params(jnets.ModelConfig(**kw), 4))
    tkey = torch.from_numpy(np.asarray(jax.random.key_data(
        jax.random.PRNGKey(POLICY_KEY))).astype(np.int64))
    picks = set()
    assert len(ref["refs"]) == len(DISTS)
    for d, want in zip(DISTS, ref["refs"]):
        got = sixten.make_sixten_policy(tenv, net, d, 0.4, space)(
            ts, tkey, hp)[1:]
        assert len(want) == len(got)
        for a, b in zip(want, got):
            if a.dtype == np.float32:
                assert np.abs(a - b.numpy()).max() < 1e-5, d
            else:
                assert (a == b.numpy()).all(), (d, a, b.numpy())
        picks.add(tuple(got[1].tolist()))
    assert len(picks) > 1          # the distributions do choose differently


# slow: JAX's policies under jit, about 100 s cold in the full space
@pytest.mark.slow
@pytest.mark.parametrize("space", ["top_drop", "full"])
def test_policy_fixture_regenerates(space):
    fixtures.regenerates(f"sixten_policy_{space}",
                         lambda: jax_policy_run(space))


def estimator():
    return EstimatorConfig(k_step=3)


@pytest.fixture(scope="module")
def one_update():
    kw = dict(compute_dtype="float32", **TINY)
    params = jvnet_params(jnets.ModelConfig(**kw), 6)
    rcfg = replay.ReplayConfig(capacity=400, k_step=3, height=22,
                               sample_mode="rank")
    jrcfg = jreplay.ReplayConfig(capacity=400, k_step=3, height=22,
                                 sample_mode="rank")
    scfg = sixten.SixtenConfig(n_samples_each_update=64, minibatch_size=16,
                               n_train_epochs=2, time_to_reference_update=1,
                               estimator=estimator())
    jscfg = jsixten.SixtenConfig(
        n_samples_each_update=64, minibatch_size=16, n_train_epochs=2,
        time_to_reference_update=1,
        estimator=jve.EstimatorConfig(k_step=3))
    jst, st = jreplay.replay_init(jrcfg), replay.replay_init(rcfg, "cpu")
    for seed in range(2):
        a = seg_arrays(seed, t=16, n=8)
        jst = jreplay.replay_add_segment(jrcfg, jst, jseg(a), 16)
        replay.replay_add_segment(rcfg, st, tseg(a), 16)
    jnet = jsixten.VNet(jnets.ModelConfig(**kw))
    jinit, jupdate = jsixten.make_sixten_update(JEngineConfig(), jnet, jscfg,
                                                jrcfg)
    key, alpha, beta = jax.random.PRNGKey(12), 0.7, 0.5
    ks, _ = jax.random.split(key)
    jidx, _ = jreplay.replay_sample(jrcfg, jst, ks, 64, jnp.float32(alpha),
                                    jnp.float32(beta))
    jtargets = jve.make_target_fn(JEngineConfig(), jnet, jscfg.estimator)(
        {"params": params}, jreplay.replay_gather_windows(jrcfg, jst, jidx))
    jstate, jst2, jstats = jupdate(jinit({"params": params}), jst, key,
                                   jnp.float32(alpha), jnp.float32(beta))
    net = port_vnet(kw, params)
    init_fn, update_fn = sixten.make_sixten_update(EngineConfig(), net, scfg,
                                                   rcfg)
    state = init_fn()
    tk = torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(
        np.int64))
    idx, _, samples, _ = sixten.sample_for_update(
        EngineConfig(), scfg, rcfg,
        sixten.make_target_fn(EngineConfig(), None, scfg.estimator),
        state.ref_net, st, tk, alpha, beta)
    state, st, stats = update_fn(state, st, tk, alpha, beta)
    return dict(scfg=scfg, jidx=np.asarray(jidx), idx=idx.numpy(),
                jtargets=np.asarray(jtargets), targets=samples["target"],
                jstate=jstate, jst=jst2, jstats=jstats, state=state, st=st,
                stats=stats, params=params_from_flax(params))


def assert_params_close(jparams, net, lr, steps, where=""):
    ref = params_from_flax(jax.tree.map(np.asarray, jparams["params"]))
    tol = 2 * lr * steps + 1e-6
    for k, p in net.named_parameters():
        err = (p.detach() - ref[k]).abs().max().item()
        assert err <= tol, (where, k, err, tol)


def assert_stats_close(jstats, stats):
    jstats = {k: float(v) for k, v in jstats.items()}
    stats = {k: float(v) for k, v in stats.items()}
    assert set(jstats) == set(stats)
    for k, v in jstats.items():
        assert relerr(v, stats[k]) < STAT_TOL, (k, v, stats[k])


def test_update_matches_jax(one_update):
    r = one_update
    assert (r["idx"] == r["jidx"]).all()
    assert np.abs(r["targets"].numpy() - r["jtargets"]).max() < 1e-5
    assert r["jtargets"].std() > 1e-3
    jprio, prio = np.asarray(r["jst"].prio), r["st"].prio.numpy()
    assert np.abs(jprio - prio).max() < PRIO_TOL
    assert (prio[r["idx"]] != 2.0).mean() > 0.9
    cfg = r["scfg"]
    assert_params_close(r["jstate"].params, r["state"].net, cfg.lr,
                        2 * 64 // 16)
    for (k, p), q in zip(r["state"].net.named_parameters(),
                         r["state"].ref_net.parameters()):
        assert torch.equal(p.detach(), q), k
    assert r["state"].update_count == int(r["jstate"].update_count) == 1
    assert_stats_close(r["jstats"], r["stats"])
    moved = max((p.detach() - r["params"][k]).abs().max().item()
                for k, p in r["state"].net.named_parameters())
    assert moved > 0.5 * cfg.lr


TRAINER_KW = dict(compute_dtype="float32", **TINY)
TRAINER_REPLAY = dict(capacity=200, k_step=3, height=22)
TRAINER_COMMON = dict(n_envs=4, horizon=8, train_distribution="epsilon",
                      epsilon=0.3, seed=5)
REPLAY_FIELDS = ("occ", "vec", "piece", "rot", "trans", "reward", "done")


def trainer_params():
    # spread-out values: JAX's initial value head (normal(0.01)) leaves the
    # successors' values within float32 ulps of each other
    return jvnet_params(jnets.ModelConfig(**TRAINER_KW), 9)


def jax_two_iterations() -> dict:
    """JAX's StandaloneSIXtenTrainer from redrawn weights: its reset as
    leaves, then after each of two iterations the key, the env
    state, the replay's rows and priorities, the params and the stats
    (tests/jax_fixtures/sixten_two_iterations.npz)."""
    jscfg = jsixten.SixtenConfig(n_samples_each_update=16, minibatch_size=8,
                                 estimator=jve.EstimatorConfig(k_step=3))
    jtr = jstandalone.StandaloneSIXtenTrainer(
        jstandalone.StandaloneSIXtenConfig(
            env=JEnvConfig(), model=jnets.ModelConfig(**TRAINER_KW),
            replay=jreplay.ReplayConfig(**TRAINER_REPLAY), **TRAINER_COMMON),
        sixten_cfg=jscfg)
    jtr.state = jtr.init_opt({"params": trainer_params()})
    out = dict(reset=jax_leaves(jtr.env_state), its=[])
    for _ in range(2):
        stats = jtr.train_iteration()
        out["its"].append(dict(
            key=np.asarray(jax.random.key_data(jtr.key)),
            state=jax_leaves(jtr.env_state),
            replay={f: np.asarray(getattr(jtr.replay, f))
                    for f in REPLAY_FIELDS + ("prio",)},
            params=jax.tree.map(np.asarray, jtr.state.params),
            stats={k: float(v) for k, v in stats.items()}))
    return out


# slow: JAX's SIXten trainer, about 100 s cold
@pytest.mark.slow
def test_trainer_fixture_regenerates():
    fixtures.regenerates("sixten_two_iterations", jax_two_iterations)


def test_two_trainer_iterations_match_jax():
    ref = fixtures.load("sixten_two_iterations")
    scfg = sixten.SixtenConfig(n_samples_each_update=16, minibatch_size=8,
                               estimator=estimator())
    tr = StandaloneSIXtenTrainer(StandaloneSIXtenConfig(
        env=EnvConfig(), model=ModelConfig(**TRAINER_KW),
        replay=replay.ReplayConfig(**TRAINER_REPLAY), **TRAINER_COMMON),
        sixten_cfg=scfg, device="cpu")
    sd = params_from_flax(trainer_params())
    tr.net.load_state_dict(sd)
    tr.state.ref_net.load_state_dict(sd)
    assert_state_equal(ref["reset"], tr.env_state, "reset")
    assert len(ref["its"]) == 2
    for it, want in enumerate(ref["its"]):
        stats = tr.train_iteration()
        assert (want["key"] == tr.key.numpy()).all()
        assert_state_equal(want["state"], tr.env_state, f"iteration {it}")
        for f in REPLAY_FIELDS:
            a, b = want["replay"][f], getattr(tr.replay, f).numpy()
            assert (a == (b.view(np.uint32) if a.dtype == np.uint32
                          else b)).all(), (it, f)
        assert np.abs(want["replay"]["prio"]
                      - tr.replay.prio.numpy()).max() < PRIO_TOL
        assert_params_close(want["params"], tr.net, scfg.lr, 2 * (it + 1))
        assert_stats_close(want["stats"], stats)
    assert set(tr.phase_ms) >= {"masks", "forward", "tick", "replay",
                                "update"}
