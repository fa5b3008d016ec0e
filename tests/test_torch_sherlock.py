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
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import (assert_state_equal, rekey_jax_cache,
                                      to_torch_state)

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


@pytest.fixture(scope="module")
def states():
    jenv = JEnv(JEnvConfig(), N)
    tenv = TetrisVectorEnv(EnvConfig(), N, device="cpu")
    js = jenv.reset(jax.random.PRNGKey(4))
    ts = checks.crowded(tenv.cfg, to_torch_state(js, tenv.reset(4)), seed=6)
    return jenv, tenv, to_jax_state(ts, js), ts


DISTS = ("argmax", "pi", "epsilon")


@pytest.mark.parametrize("space", ["top_drop", "full"])
def test_deltas_and_policy_match_jax(states, space):
    jenv, tenv, js, ts = states
    full = space == "full"
    cfg = tenv.cfg.engine
    ps = ts.engine.players
    p = ts.current_player
    occ, piece, rot = (take_player(a, p) for a in (ps.occ, ps.piece,
                                                   ps.rot))
    jfn = jsherlock.pose_deltas if full else jsherlock.placement_deltas
    jmask, jdeltas = jax.jit(jax.vmap(lambda o, pc, r: jfn(
        JEngineConfig(), o, pc, r)))(occ.numpy().view(np.uint32),
                                     piece.numpy(), rot.numpy())
    fn = sherlock.pose_deltas if full else sherlock.placement_deltas
    mask, deltas = fn(cfg, occ, piece, rot)
    assert (np.asarray(jmask) == mask.numpy()).all()
    assert (np.asarray(jdeltas) == deltas.numpy()).all()
    params = jsherlock_params(jnets.ModelConfig(**KW), 8)
    jnet = jsherlock.SherlockNet(jnets.ModelConfig(**KW))
    net = port_net(KW, params)
    key = jax.random.PRNGKey(13)
    jpols = [jsherlock.make_sherlock_policy(jenv, jnet, d, 0.5, space)
             for d in DISTS]
    refs = jax.jit(lambda prm, s, k: [pol(prm, s, k)[1:] for pol in jpols]
                   )({"params": params}, js, key)
    tkey = torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(
        np.int64))
    for d, ref in zip(DISTS, refs):
        got = sherlock.make_sherlock_policy(tenv, net, d, 0.5, space)(
            ts, tkey)[1:]
        for a, b in zip(ref, got):
            a = np.asarray(a)
            if a.dtype == np.float32:
                assert np.abs(a - b.numpy()).max() < 1e-5, d
            else:
                assert (a == b.numpy()).all(), (d, a, b.numpy())


def trainer_cfgs(seed=2):
    common = dict(n_envs=4, horizon=8, seed=seed)
    scfg = sherlock.SherlockConfig(minibatch_size=8, n_train_epochs=2,
                                   lr=1e-4)
    jscfg = jsherlock.SherlockConfig(minibatch_size=8, n_train_epochs=2,
                                     lr=1e-4)
    jtr = jstandalone.StandaloneSherlockTrainer(
        jstandalone.SherlockTrainerConfig(
            env=JEnvConfig(), model=jnets.ModelConfig(**KW), **common),
        sherlock_cfg=jscfg)
    tr = StandaloneSherlockTrainer(SherlockTrainerConfig(
        env=EnvConfig(), model=ModelConfig(**KW), **common),
        sherlock_cfg=scfg, device="cpu")
    params = jsherlock_params(jnets.ModelConfig(**KW), 9)
    jtr.state = jtr.init_opt({"params": params})
    tr.net.load_state_dict(params_from_flax(params))
    return jtr, tr, scfg


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


def test_two_trainer_iterations_match_jax():
    jtr, tr, scfg = trainer_cfgs()
    assert_state_equal(jtr.env_state, tr.env_state, "reset")
    for it in range(2):
        jstats = jtr.train_iteration()
        stats = tr.train_iteration()
        assert (np.asarray(jax.random.key_data(jtr.key)) ==
                tr.key.numpy()).all()
        assert_state_equal(jtr.env_state, tr.env_state, f"iteration {it}")
        steps = (it + 1) * scfg.n_train_epochs * (4 * 8 // 8)
        assert_params_close(jtr.state.params, tr.net, scfg.lr, steps)
        assert_stats_close(jstats, stats)
    assert set(tr.phase_ms) >= {"masks", "forward", "tick", "gae",
                                "update"}
