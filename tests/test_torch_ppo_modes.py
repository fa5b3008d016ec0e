"""The PPO trainer's other modes in the port against the JAX package's, on
a small float32 net (``SMALL``) and the same seeded inputs:

* trainer-computed targets (``workers_computes_advantages=False``):
  ``segment_to_windows`` bit-exact; two ``update_fn`` calls (k = 3 with
  the step filter (2,), minibatch 32, 2 epochs, time_to_reference_update
  2), the reference net synced by the countdown rule (0 -> sync and
  reload, else tick down); after each, the first minibatch's gradients
  within GRAD_TOL of each leaf's largest |g| (JAX's recorded before Adam;
  the surrogate's gradient reaches the value stream, values not
  detached), the loss terms within STAT_TOL of max(|term|, 0.1), the
  parameters and the reference within 2 x lr x steps + 1e-6, the
  countdown equal;
* the league-pool rollout against a frozen opponent, JAX's gumbel draws
  injected (one JAX compile, the opponent first): the learner second
  field for field (ints and boards equal, floats within 1e-5); the
  learner first by swapping the roles, which plays JAX's game with the
  other net learning: the same actions and boards, and the learner's own
  values on every tick; ``pool_segment_to_batch`` for both parities
  within 1e-5 of JAX's (JAX's rollout is committed,
  tests/jax_fixtures/pool_rollout.npz; a ``slow`` test runs it again and
  holds it to the file);
* a JAX trainer-targets PPOState through the converters and back bit for
  bit, its reference net and countdown into the port's trainer;
* the PFSP opponent sequence: the port's ``_pick_opponent`` and the pool
  draw against JAX's on the same RandomState(seed + 7) and win rates:
  the same 200 picks, uniform and pfsp.
Measured on the CPU: gradients 1.6e-5 of the leaf's largest, parameters
2.4e-7 absolute; the loss terms 2.5e-4 relative, 1.9e-6 absolute: the
surrogate is a mean of terms of both signs (0.0076 here after the second
update), so its gap is ulps of its terms, hence the floor of 0.1 on the
scale.  GRAD_TOL and STAT_TOL are tests/test_torch_ppo.py's.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import (assert_state_equal, jax_leaves,
                                      rekey_jax_cache)

rekey_jax_cache()

import collections  # noqa: E402
import dataclasses  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.algos import ppo as jppo  # noqa: E402
from drl_tetris_tpu.algos.rollout import Segment as JSegment  # noqa: E402
from drl_tetris_tpu.algos.rollout import make_pool_rollout_fn as j_pool_fn  # noqa: E402
from drl_tetris_tpu.engine.core import EngineConfig as JEngineConfig  # noqa: E402
from drl_tetris_tpu.env.env import (EnvConfig as JEnvConfig,  # noqa: E402
                                    TetrisVectorEnv as JEnv)
from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu.runtime import standalone as jstandalone  # noqa: E402
from drl_tetris_tpu_torch import config  # noqa: E402
from drl_tetris_tpu_torch.algos import ppo  # noqa: E402
from drl_tetris_tpu_torch.algos.rollout import make_pool_rollout_fn  # noqa: E402
from drl_tetris_tpu_torch.engine import rng  # noqa: E402
from drl_tetris_tpu_torch.engine.core import EngineConfig  # noqa: E402
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv  # noqa: E402
from drl_tetris_tpu_torch.models import nets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import params_from_flax  # noqa: E402
from drl_tetris_tpu_torch.runtime import standalone  # noqa: E402
from tests.test_torch_nets import SMALL, small_params  # noqa: E402
from tests.test_torch_ppo import (GRAD_TOL, STAT_TOL,  # noqa: E402
                                  jax_ppo_config, recorder)
from tests.test_torch_replay import jseg, seg_arrays, tseg  # noqa: E402
from tests import torch_jax_fixtures as fixtures  # noqa: E402

MB, EPOCHS, T_SEG, N_SEG = 32, 2, 12, 8
N, HORIZON = 8, 8


def targets_config():
    return dataclasses.replace(
        config.load().ppo, workers_computes_advantages=False,
        n_step_value_estimates=3, sparse_value_estimate_filter=(2,),
        time_to_reference_update=2, minibatch_size=MB, n_train_epochs=EPOCHS,
        lr=1e-4)


@pytest.fixture(scope="module")
def targets_updates():
    cfg = targets_config()
    jcfg = jax_ppo_config(cfg)
    a = seg_arrays(3, t=T_SEG, n=N_SEG)
    jw = jppo.segment_to_windows(jcfg, jseg(a))
    w = ppo.segment_to_windows(cfg, tseg(a))
    params = small_params(5)
    net = nets.PPONet(nets.ModelConfig(compute_dtype="float32", **SMALL),
                      device="cpu")
    net.load_state_dict(params_from_flax(params))
    jnet = jnets.PPONet(jnets.ModelConfig(compute_dtype="float32", **SMALL))
    tx = optax.chain(recorder(), optax.adam(cfg.lr))
    jinit, jupdate = jppo.make_ppo_update(JEngineConfig(), jnet, jcfg,
                                          optimizer=tx)
    init_fn, update_fn = ppo.make_ppo_update(EngineConfig(), net, cfg)
    jstate, state = jinit({"params": params}), init_fn()
    out = []
    for i, seed in enumerate((17, 18)):
        key = rng.prng_key(seed)
        grads, _ = ppo.first_step_gradients(EngineConfig(), cfg, state.net,
                                            w, key, state.ref_net)
        # JAX's first step from this state: a fresh recorder and Adam on
        # the same params (the gradient does not depend on the moments)
        fresh = jinit(jstate.params).replace(ref_params=jstate.ref_params,
                                             ref_countdown=jstate.ref_countdown)
        rec, _ = jupdate(fresh, jw, jax.random.PRNGKey(seed))
        jgrads = params_from_flax(jax.tree.map(
            np.asarray, rec.opt_state[0][1]["params"]))
        jstate, jstats = jupdate(jstate, jw, jax.random.PRNGKey(seed))
        state, stats = update_fn(state, w, key)
        out.append(dict(grads=grads, jgrads=jgrads, jstats=jstats,
                        stats=stats, jstate=jstate,
                        params={k: p.detach().clone()
                                for k, p in state.net.named_parameters()},
                        ref={k: p.detach().clone()
                             for k, p in state.ref_net.named_parameters()},
                        countdown=state.ref_countdown))
    return dict(cfg=cfg, jw=jw, w=w, out=out)


def test_segment_to_windows_bit_exact(targets_updates):
    jw, w = targets_updates["jw"], targets_updates["w"]
    assert w.occ_w.shape == (N_SEG * (T_SEG - 3), 4, 2, 22)
    for name, a, b in zip(ppo.WindowBatch._fields, jw, w):
        a, b = np.asarray(a), b.numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert (a == b).all(), name


def test_trainer_targets_updates(targets_updates):
    cfg = targets_updates["cfg"]
    steps = 0
    for i, r in enumerate(targets_updates["out"]):
        for k, g in r["grads"].items():
            jg = r["jgrads"][k]
            err = (g - jg).abs().max().item()
            assert err <= GRAD_TOL * jg.abs().max().item() + 1e-12, (i, k)
        # the surrogate reaches the value stream: its gradient is not zero
        assert r["grads"]["trunk.value_tower.convs.0.weight"].abs().max() > 0
        stats = {k: v.item() for k, v in r["stats"].items()}
        for k, v in r["jstats"].items():
            v = float(v)
            if "saturation" in k:
                assert abs(v - stats[k]) <= 1.0 / MB + 1e-6, (i, k)
            else:
                assert abs(v - stats[k]) < STAT_TOL * max(abs(v), 0.1), \
                    (i, k, v, stats[k])
        steps += EPOCHS * (targets_updates["w"].piece.shape[0] // MB)
        tol = 2 * cfg.lr * steps + 1e-6
        jst = r["jstate"]
        for mine, theirs in ((r["params"], jst.params),
                             (r["ref"], jst.ref_params)):
            ref = params_from_flax(jax.tree.map(np.asarray,
                                                theirs["params"]))
            for k, p in mine.items():
                assert (p - ref[k]).abs().max().item() <= tol, (i, k)
        assert r["countdown"] == int(jst.ref_countdown)
    first, second = targets_updates["out"]
    # update 1 synced (countdown 0 -> 2), update 2 ticked (2 -> 1)
    assert (first["countdown"], second["countdown"]) == (2, 1)
    assert all(torch.equal(first["ref"][k], first["params"][k])
               for k in first["ref"])
    assert all(torch.equal(second["ref"][k], first["params"][k])
               for k in first["ref"])


def jax_pool_run() -> dict:
    """JAX's pool rollout with learner A (small_params(4)) against
    opponent B (small_params(9)), the opponent first (one compile), with
    its gumbel draws, the env state after it as leaves, the segment and
    the last values (tests/jax_fixtures/pool_rollout.npz)."""
    params, opp_params = small_params(4), small_params(9)
    jnet = jnets.PPONet(jnets.ModelConfig(compute_dtype="float32", **SMALL))
    jenv = JEnv(JEnvConfig(), N)
    js0 = jenv.reset(jax.random.PRNGKey(21))
    key = jax.random.PRNGKey(5)
    js, jseg_, jlast = j_pool_fn(jenv, jnet, HORIZON)(
        {"params": params}, {"params": opp_params}, js0, key,
        learner_first=False)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (N, 40), jnp.float32))
                       for k in jax.random.split(key, HORIZON)])
    return dict(js=jax_leaves(js), jseg=jseg_, jlast=jlast, gumbel=gumbel)


# slow: JAX's pool rollout, about 320 s cold
@pytest.mark.slow
def test_pool_rollout_fixture_regenerates():
    fixtures.regenerates("pool_rollout", jax_pool_run)


@pytest.fixture(scope="module")
def jax_pool_rollout():
    """JAX's pool rollout (the fixture): the segment as JAX's Segment, the
    gumbel draws as a tensor; and both params."""
    r = fixtures.load("pool_rollout")
    r.update(a=small_params(4), b=small_params(9))
    r["jseg"] = JSegment(**{k: jnp.asarray(v) for k, v in r["jseg"].items()})
    r["jlast"] = jnp.asarray(r["jlast"])
    r["gumbel"] = torch.from_numpy(r["gumbel"])
    return r


def port_pool_rollout(r, learner, opponent, learner_first):
    model = dict(compute_dtype="float32", **SMALL)
    env = TetrisVectorEnv(EnvConfig(), N, device="cpu")
    net, opp = [nets.PPONet(nets.ModelConfig(**model), device="cpu")
                for _ in range(2)]
    net.load_state_dict(params_from_flax(learner))
    opp.load_state_dict(params_from_flax(opponent))
    ts, seg, last = make_pool_rollout_fn(env, net, HORIZON)(
        opp, env.reset(21), gumbel=r["gumbel"], learner_first=learner_first)
    return net, ts, seg, last


def assert_pool_batch(jseg_, jlast, seg, last, lp):
    cfg = config.load().ppo
    jb, _ = jppo.pool_segment_to_batch(jax_ppo_config(cfg), jseg_, jlast,
                                       learner_parity=lp)
    b, _ = ppo.pool_segment_to_batch(cfg, seg, last, learner_parity=lp)
    assert b.piece.shape == (HORIZON // 2 * N,)
    for name, x, y in zip(ppo.Batch._fields, jb, b):
        x, y = np.asarray(x), y.numpy()
        if x.dtype == np.uint32:
            y = y.view(np.uint32)
        assert x.shape == y.shape and np.abs(
            x.astype(np.float64) - y.astype(np.float64)).max() < 1e-5, name


ACTING = ("occ", "vec", "piece", "rot", "trans", "prob", "reward", "done",
          "player")


def test_pool_rollout_learner_second(jax_pool_rollout):
    """Learner A, opponent B acting first: the JAX rollout field for
    field, and ``pool_segment_to_batch`` on the learner's parity 1."""
    r = jax_pool_rollout
    _, ts, seg, last = port_pool_rollout(r, r["a"], r["b"], False)
    assert_state_equal(r["js"], ts, "after the pool rollout")
    for name in seg._fields:
        a, b = np.asarray(getattr(r["jseg"], name)), \
            getattr(seg, name).numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == np.float32:
            assert np.abs(a - b).max() < 1e-5, name
        else:
            assert (a == b).all(), name
    assert np.abs(np.asarray(r["jlast"]) - last.numpy()).max() < 1e-5
    assert_pool_batch(r["jseg"], r["jlast"], seg, last, 1)


def test_pool_rollout_learner_first(jax_pool_rollout):
    """The other seat with the roles swapped: learner B first against
    opponent A plays the same game as JAX's run (the same actions and
    boards), and records B's values on every tick, A's ticks included;
    ``pool_segment_to_batch`` on parity 0 matches JAX's on that segment."""
    r = jax_pool_rollout
    net, ts, seg, last = port_pool_rollout(r, r["b"], r["a"], True)
    assert_state_equal(r["js"], ts, "after the pool rollout")
    for name in ACTING:
        a, b = np.asarray(getattr(r["jseg"], name)), \
            getattr(seg, name).numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert np.abs(a.astype(np.float64) - b).max() < 1e-5, name
    grids = seg.occ.reshape(-1, 2, 22)
    from drl_tetris_tpu_torch.env.observations import field_grid
    g = field_grid(EngineConfig(), grids)
    vec = seg.vec.reshape(-1, 2, 12)
    with torch.no_grad():
        _, v = net([vec[:, 0], vec[:, 1]], [g[:, 0, ..., None],
                                            g[:, 1, ..., None]])
    piece = seg.piece.reshape(-1).long()
    want = v[torch.arange(len(piece)), piece].reshape(HORIZON, N)
    assert (want - seg.v_piece).abs().max().item() < 1e-5
    assert (v.mean(-1).reshape(HORIZON, N) - seg.v_mean).abs().max() < 1e-5
    jseg_b = r["jseg"]._replace(v_piece=jnp.asarray(seg.v_piece.numpy()),
                                v_mean=jnp.asarray(seg.v_mean.numpy()))
    assert_pool_batch(jseg_b, jnp.asarray(last.numpy()), seg, last, 0)


def fake_trainer(module, mode, n_pool=4):
    """The attributes ``_pick_opponent`` reads, for either package."""
    t = types.SimpleNamespace(
        cfg=types.SimpleNamespace(pool_mode=mode),
        _pool=collections.deque(range(n_pool)),
        _pool_wr=collections.deque([0.5] * n_pool),
        _host_rng=np.random.RandomState(3 + 7))
    t.pick = lambda: module.StandaloneTrainer._pick_opponent(t)
    return t


@pytest.mark.parametrize("mode", ("uniform", "pfsp"))
def test_pfsp_opponent_sequence(mode):
    ours, theirs = fake_trainer(standalone, mode), \
        fake_trainer(jstandalone, mode)
    wr = np.random.RandomState(1)
    picks = []
    for _ in range(200):
        drew = [t._host_rng.rand() < 0.6 for t in (ours, theirs)]
        assert drew[0] == drew[1]
        if not drew[0]:
            continue
        a, b = ours.pick(), theirs.pick()
        assert a == b
        picks.append(a)
        w = float(wr.rand())
        for t in (ours, theirs):
            t._pool_wr[a] = 0.95 * t._pool_wr[a] + 0.05 * w
    assert len(set(picks)) == 4 and len(picks) > 80


def test_trainer_targets_state_converts(targets_updates, tmp_path):
    """A JAX trainer-targets PPOState (reference params and countdown)
    saved with the JAX checkpoint, through ``ppo_state_from_flax`` and
    back bit for bit, and into the port's trainer."""
    from drl_tetris_tpu.runtime import checkpoint as jckpt
    from drl_tetris_tpu_torch.models.convert import (ppo_state_from_flax,
                                                     ppo_state_to_flax)
    from drl_tetris_tpu_torch.runtime.standalone import (StandaloneConfig,
                                                         StandaloneTrainer)
    cfg = targets_updates["cfg"]
    jnet = jnets.PPONet(jnets.ModelConfig(compute_dtype="float32", **SMALL))
    jinit, jupdate = jppo.make_ppo_update(JEngineConfig(), jnet,
                                          jax_ppo_config(cfg))
    jstate, _ = jupdate(jinit({"params": small_params(5)}),
                        targets_updates["jw"], jax.random.PRNGKey(3))
    jckpt.save(str(tmp_path), 1, jstate)
    raw = jckpt.restore_raw(str(tmp_path))
    state = ppo_state_from_flax(raw)
    assert state["ref_countdown"] == int(jstate.ref_countdown) == 2
    back = ppo_state_to_flax(state)
    ja = jax.tree_util.tree_flatten_with_path(raw)[0]
    jb = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in ja] == [p for p, _ in jb]
    for (path, a), (_, b) in zip(ja, jb):
        assert (np.asarray(a) == np.asarray(b)).all(), path
    tr = StandaloneTrainer(StandaloneConfig(
        model=nets.ModelConfig(compute_dtype="float32", **SMALL), ppo=cfg,
        n_envs=2, horizon=8), device="cpu")
    tr.load_ppo_state(state)
    assert tr.state.ref_countdown == 2
    ref = params_from_flax(jax.tree.map(np.asarray,
                                        jstate.ref_params["params"]))
    for k, p in tr.state.ref_net.named_parameters():
        assert torch.equal(p, ref[k]), k
    assert set(tr.ppo_state_dict()) == set(state)
