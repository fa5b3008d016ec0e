"""The port's Sherlock (algos/sherlock.py, StandaloneSherlockTrainer)
against the JAX package's, on a small float32 SherlockNet and the 22 x 10
board:

* SherlockNet, the same weights through the converter: phi and v within
  1e-5 of their largest value (float32), the first-step gradients within
  GRAD_TOL of each leaf's largest, bfloat16 within BF16_TOL; the flax tree
  through the converter and back bit for bit;
* the placement deltas of the top-drop and the full space (deltas and
  masks bit-exact), and the evaluation policy under argmax, pi and
  epsilon: the same choice from JAX's key, its phi.delta probability and
  values within 1e-5;
* one update (PPO clip on the phi.delta probability, the impossibility
  loss, value MSE, L2) from the same batch, weights and key: parameters
  within Adam's bound (2 x lr x steps + 1e-6), the loss terms within
  STAT_TOL;
* two StandaloneSherlockTrainer iterations from the same weights: the key
  and the env state bit-exact (every sampled placement JAX's), parameters
  and stats as above.

JAX's deltas, policies and trainer iterations are committed
(tests/jax_fixtures/sherlock_*.npz, tests/torch_jax_fixtures.py);
``slow`` tests run them again with JAX and hold them to the files.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import (assert_state_equal, jax_leaves,
                                      rekey_jax_cache, to_torch_state)

rekey_jax_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.algos import sherlock as jsherlock  # noqa: E402
from drl_tetris_tpu.engine.core import EngineConfig as JEngineConfig  # noqa: E402
from drl_tetris_tpu.env.env import (EnvConfig as JEnvConfig,  # noqa: E402
                                    TetrisVectorEnv as JEnv)
from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu.runtime import standalone as jstandalone  # noqa: E402

from drl_tetris_tpu_torch.algos import sherlock  # noqa: E402
from drl_tetris_tpu_torch.engine import checks  # noqa: E402
from drl_tetris_tpu_torch.env.env import (EnvConfig, TetrisVectorEnv,  # noqa: E402
                                          take_player)
from drl_tetris_tpu_torch.models.convert import (params_from_flax,  # noqa: E402
                                                 params_to_flax)
from drl_tetris_tpu_torch.models.nets import ModelConfig  # noqa: E402
from drl_tetris_tpu_torch.runtime.standalone import (  # noqa: E402
    SherlockTrainerConfig, StandaloneSherlockTrainer)
from tests.test_torch_env_spaces import to_jax_state  # noqa: E402
from tests import torch_jax_fixtures as fixtures  # noqa: E402
from tests.test_torch_nets import make_inputs, randomize  # noqa: E402
from tests.test_torch_sixten import (  # noqa: E402
    TINY, assert_first_step_gradients, assert_params_close,
    assert_stats_close)

BF16_TOL = 0.05
N = 6
KW = dict(compute_dtype="float32", **TINY)


def jsherlock_params(model, seed):
    vecs, viss = make_inputs(2, 0)
    p = jsherlock.SherlockNet(model).init(
        jax.random.PRNGKey(0), [jnp.asarray(v) for v in vecs],
        [jnp.asarray(v) for v in viss])["params"]
    return randomize(jax.tree.map(np.asarray, p), seed)


def port_net(kw, params):
    net = sherlock.SherlockNet(ModelConfig(**kw), device="cpu")
    net.load_state_dict(params_from_flax(params))
    return net


def test_sherlock_net_matches_jax():
    params = jsherlock_params(jnets.ModelConfig(**KW), 3)
    back = params_to_flax(params_from_flax(params))["params"]
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb and (a == b).all(), pa
    vecs, viss = make_inputs(6, 5, unit_vec=True)
    for kw, tol in ((KW, 1e-5), (dict(KW, compute_dtype="bfloat16"),
                                 BF16_TOL)):
        jphi, jv = jsherlock.SherlockNet(jnets.ModelConfig(**kw)).apply(
            {"params": params}, [jnp.asarray(v) for v in vecs],
            [jnp.asarray(v) for v in viss])
        with torch.no_grad():
            phi, v = port_net(kw, params)(
                [torch.from_numpy(x) for x in vecs],
                [torch.from_numpy(x) for x in viss])
        assert tuple(phi.shape) == (6, 22, 10, 7)
        for a, b in ((jphi, phi), (jv, v)):
            a = np.asarray(a)
            rel = tol if tol == BF16_TOL else tol * np.abs(a).max()
            assert np.abs(a - b.numpy()).max() <= rel, kw
        assert np.asarray(jphi).std() > 1e-4
    assert_first_step_gradients(jsherlock.SherlockNet(jnets.ModelConfig(
        **KW)), port_net(KW, params), params, vecs, viss)


def crowded_states(reset_leaves):
    """The port's env state of N games on crowded boards from JAX's reset
    (as leaves)."""
    jenv = JEnv(JEnvConfig(), N)
    tenv = TetrisVectorEnv(EnvConfig(), N, device="cpu")
    ts = checks.crowded(tenv.cfg, to_torch_state(reset_leaves,
                                                 tenv.reset(4)), seed=6)
    return jenv, tenv, ts


DISTS = ("argmax", "pi", "epsilon")
POLICY_KEY = 13


def current_boards(ts):
    p = ts.current_player
    ps = ts.engine.players
    return [take_player(a, p) for a in (ps.occ, ps.piece, ps.rot)]


def jax_policy_run(space) -> dict:
    """JAX's placement deltas and Sherlock policy under each distribution
    on crowded boards from its key: JAX's reset as leaves, the masks and
    deltas and each distribution's outputs
    (tests/jax_fixtures/sherlock_policy_SPACE.npz)."""
    js0 = JEnv(JEnvConfig(), N).reset(jax.random.PRNGKey(4))
    jenv, _, ts = crowded_states(jax_leaves(js0))
    js = to_jax_state(ts, js0)
    occ, piece, rot = current_boards(ts)
    jfn = jsherlock.pose_deltas if space == "full" else \
        jsherlock.placement_deltas
    jmask, jdeltas = jax.jit(jax.vmap(lambda o, pc, r: jfn(
        JEngineConfig(), o, pc, r)))(occ.numpy().view(np.uint32),
                                     piece.numpy(), rot.numpy())
    params = jsherlock_params(jnets.ModelConfig(**KW), 8)
    jnet = jsherlock.SherlockNet(jnets.ModelConfig(**KW))
    jpols = [jsherlock.make_sherlock_policy(jenv, jnet, d, 0.5, space)
             for d in DISTS]
    refs = jax.jit(lambda prm, s, k: [pol(prm, s, k)[1:] for pol in jpols]
                   )({"params": params}, js, jax.random.PRNGKey(POLICY_KEY))
    return dict(reset=jax_leaves(js0), mask=jmask, deltas=jdeltas,
                refs=[[np.asarray(a) for a in ref] for ref in refs])


@pytest.mark.parametrize("space", ["top_drop", "full"])
def test_deltas_and_policy_match_jax(space):
    ref = fixtures.load(f"sherlock_policy_{space}")
    _, tenv, ts = crowded_states(ref["reset"])
    full = space == "full"
    occ, piece, rot = current_boards(ts)
    fn = sherlock.pose_deltas if full else sherlock.placement_deltas
    mask, deltas = fn(tenv.cfg.engine, occ, piece, rot)
    assert (ref["mask"] == mask.numpy()).all()
    assert (ref["deltas"] == deltas.numpy()).all()
    net = port_net(KW, jsherlock_params(jnets.ModelConfig(**KW), 8))
    tkey = torch.from_numpy(np.asarray(jax.random.key_data(
        jax.random.PRNGKey(POLICY_KEY))).astype(np.int64))
    assert len(ref["refs"]) == len(DISTS)
    for d, want in zip(DISTS, ref["refs"]):
        got = sherlock.make_sherlock_policy(tenv, net, d, 0.5, space)(
            ts, tkey)[1:]
        assert len(want) == len(got)
        for a, b in zip(want, got):
            if a.dtype == np.float32:
                assert np.abs(a - b.numpy()).max() < 1e-5, d
            else:
                assert (a == b.numpy()).all(), (d, a, b.numpy())


# slow: JAX's deltas and policies under jit, about 120 s cold in the full
# space
@pytest.mark.slow
@pytest.mark.parametrize("space", ["top_drop", "full"])
def test_policy_fixture_regenerates(space):
    fixtures.regenerates(f"sherlock_policy_{space}",
                         lambda: jax_policy_run(space))


TRAINER_SK = dict(minibatch_size=8, n_train_epochs=2, lr=1e-4)


def jax_trainer(seed=2):
    jtr = jstandalone.StandaloneSherlockTrainer(
        jstandalone.SherlockTrainerConfig(
            env=JEnvConfig(), model=jnets.ModelConfig(**KW), n_envs=4,
            horizon=8, seed=seed),
        sherlock_cfg=jsherlock.SherlockConfig(**TRAINER_SK))
    params = jsherlock_params(jnets.ModelConfig(**KW), 9)
    jtr.state = jtr.init_opt({"params": params})
    return jtr, params


def port_trainer(params, seed=2):
    scfg = sherlock.SherlockConfig(**TRAINER_SK)
    tr = StandaloneSherlockTrainer(SherlockTrainerConfig(
        env=EnvConfig(), model=ModelConfig(**KW), n_envs=4, horizon=8,
        seed=seed), sherlock_cfg=scfg, device="cpu")
    tr.net.load_state_dict(params_from_flax(params))
    return tr, scfg


def trainer_cfgs(seed=2):
    jtr, params = jax_trainer(seed)
    return (jtr, *port_trainer(params, seed))


def test_update_matches_jax():
    """One update on the port rollout's batch, from the same weights."""
    jtr, tr, scfg = trainer_cfgs(seed=7)
    _, seg, v_last = tr.rollout(tr.env_state, tr.key)
    batch, _ = sherlock.sherlock_segment_to_batch(scfg, seg, v_last)
    jbatch = jsherlock.SherlockBatch(*[
        jnp.asarray(a.numpy().view(np.uint32) if f == "occ" else a.numpy())
        for f, a in zip(batch._fields, batch)])
    key = jax.random.PRNGKey(31)
    jstate, jstats = jtr.update(jtr.state, jbatch, key)
    tk = torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(
        np.int64))
    state, stats = tr.update(tr.state, batch, tk)
    steps = scfg.n_train_epochs * (batch.piece.shape[0] // 8)
    assert_params_close(jstate.params, state.net, scfg.lr, steps)
    assert_stats_close(jstats, stats)
    assert float(stats["losses/impossibility_loss"]) > 0


def jax_two_iterations() -> dict:
    """JAX's StandaloneSherlockTrainer from seeded weights: its reset as
    leaves, then after each of two iterations the key, the env
    state, the params and the stats
    (tests/jax_fixtures/sherlock_two_iterations.npz)."""
    jtr, _ = jax_trainer()
    out = dict(reset=jax_leaves(jtr.env_state), its=[])
    for _ in range(2):
        stats = jtr.train_iteration()
        out["its"].append(dict(
            key=np.asarray(jax.random.key_data(jtr.key)),
            state=jax_leaves(jtr.env_state),
            params=jax.tree.map(np.asarray, jtr.state.params),
            stats={k: float(v) for k, v in stats.items()}))
    return out


# slow: JAX's Sherlock trainer, about 100 s cold
@pytest.mark.slow
def test_trainer_fixture_regenerates():
    fixtures.regenerates("sherlock_two_iterations", jax_two_iterations)


def test_two_trainer_iterations_match_jax():
    ref = fixtures.load("sherlock_two_iterations")
    tr, scfg = port_trainer(jsherlock_params(jnets.ModelConfig(**KW), 9))
    assert_state_equal(ref["reset"], tr.env_state, "reset")
    assert len(ref["its"]) == 2
    for it, want in enumerate(ref["its"]):
        stats = tr.train_iteration()
        assert (want["key"] == tr.key.numpy()).all()
        assert_state_equal(want["state"], tr.env_state, f"iteration {it}")
        steps = (it + 1) * scfg.n_train_epochs * (4 * 8 // 8)
        assert_params_close(want["params"], tr.net, scfg.lr, steps)
        assert_stats_close(want["stats"], stats)
    assert set(tr.phase_ms) >= {"masks", "forward", "tick", "gae",
                                "update"}
