"""The port's prioritized replay (algos/replay.py), k-step targets
(algos/value_estimator.py) and QNet (models/nets.py) against the JAX
package's on the same numpy-seeded inputs:

* ``replay_add_segment`` three times into a small ring (the third wraps at
  M - k): every row, priority, cursor and size equal.
* ``replay_sample`` in both modes over priorities with ties, with JAX's
  gumbel draws injected: the sampled set equal, the IS weights within
  1e-6; the key-following draw (``rng.gumbel``) within 1e-6 of
  ``jax.random.gumbel`` and picking the same set.
* ``replay_gather_windows`` and ``replay_update_prios``: exact.
* ``kstep_targets`` through a QNet and a PPONet reference, step filter on
  and off, truncated aggregation on and off: within 1e-5 at float32.
* QNet outputs (Q, V, A) from converted weights: a small net and the demo
  weights at float32 within 1e-4; the demo weights in bfloat16 within
  QNET_BF16_TOL, 1.5x the largest gaps measured on the CPU over input
  seeds 0..7: Q 0.278, V 0.017, A 0.278.  A is tanh of the centred
  keyboard logits, and bfloat16 moves those logits by up to about 0.4 (the
  PPONet test's log-pi gap is the same quantity: 0.397, tests/
  test_torch_nets.py); V is the piece-mean of each piece's best Q and
  averages much of that out.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.algos import replay as jreplay  # noqa: E402
from drl_tetris_tpu.algos import rollout as jrollout  # noqa: E402
from drl_tetris_tpu.algos import value_estimator as jve  # noqa: E402
from drl_tetris_tpu.engine.core import EngineConfig as JEngineConfig  # noqa: E402
from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu_torch.algos import replay  # noqa: E402
from drl_tetris_tpu_torch.algos import rollout  # noqa: E402
from drl_tetris_tpu_torch.algos import value_estimator as ve  # noqa: E402
from drl_tetris_tpu_torch.engine import rng  # noqa: E402
from drl_tetris_tpu_torch.engine.core import EngineConfig  # noqa: E402
from drl_tetris_tpu_torch.models import nets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import params_from_flax  # noqa: E402
from tests.test_torch_nets import (SMALL, make_inputs,  # noqa: E402
                                   small_params)

H, W = 22, 10
M, K, N_ENV, T = 60, 3, 3, 8
QNET_BF16_TOL = {"q": 0.42, "v": 0.026, "a": 0.42}


def seg_arrays(seed, t=T, n=N_ENV):
    """A (t, n) segment as numpy arrays in Segment field order (occ as
    uint32)."""
    rs = np.random.RandomState(seed)
    occ = rs.randint(0, 1 << W, (t, n, 2, H)).astype(np.uint32)
    occ[..., : H // 2] = 0
    done = rs.rand(t, n) < 0.2
    return dict(
        occ=occ, vec=rs.rand(t, n, 2, 12).astype(np.float32),
        piece=rs.randint(0, 7, (t, n)).astype(np.int32),
        rot=rs.randint(0, 4, (t, n)).astype(np.int32),
        trans=rs.randint(0, W, (t, n)).astype(np.int32),
        prob=rs.rand(t, n).astype(np.float32),
        v_piece=rs.randn(t, n).astype(np.float32),
        v_mean=rs.randn(t, n).astype(np.float32),
        reward=np.where(done, rs.choice([-1.0, 1.0], (t, n)), 0.0
                        ).astype(np.float32),
        done=done, player=rs.randint(0, 2, (t, n)).astype(np.int32))


def jseg(a):
    return jrollout.Segment(**{k: jnp.asarray(v) for k, v in a.items()})


def tseg(a):
    return rollout.Segment(**{k: torch.from_numpy(
        v.view(np.int32) if v.dtype == np.uint32 else v)
        for k, v in a.items()})


def assert_replay_equal(jst, st):
    for f in dataclasses.fields(replay.ReplayState):
        a, b = np.asarray(getattr(jst, f.name)), getattr(st, f.name)
        if torch.is_tensor(b):
            b = b.numpy()
            if a.dtype == np.uint32:
                b = b.view(np.uint32)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert (a == b).all(), f.name


def filled(mode):
    """JAX's and the port's replay after three adds (the third wraps),
    with some priorities rewritten to make ranks with ties."""
    cfg = replay.ReplayConfig(capacity=M, k_step=K, height=H,
                              sample_mode=mode)
    jcfg = jreplay.ReplayConfig(**dataclasses.asdict(cfg))
    jst, st = jreplay.replay_init(jcfg), replay.replay_init(cfg, "cpu")
    cursors = []
    for seed in range(3):
        a = seg_arrays(seed)
        jst = jreplay.replay_add_segment(jcfg, jst, jseg(a), T)
        replay.replay_add_segment(cfg, st, tseg(a), T)
        assert_replay_equal(jst, st)
        cursors.append(st.cursor)
    assert cursors == [24, 48, 24]          # the third add wrapped to 0
    rs = np.random.RandomState(9)
    idx = rs.choice(M - K, 12, replace=False)
    new = np.round(rs.rand(12) * 4).astype(np.float32) / 4   # ties
    jst = jreplay.replay_update_prios(jst, jnp.asarray(idx),
                                      jnp.asarray(new))
    replay.replay_update_prios(st, torch.from_numpy(idx),
                               torch.from_numpy(new))
    assert_replay_equal(jst, st)
    return cfg, jcfg, jst, st


def test_add_wraps_at_capacity_minus_k():
    cfg, _, jst, st = filled("rank")
    # 3 x 24 rows into max_size M - K = 57: the third write wrapped to 0
    assert (st.cursor, st.size, st.total_samples) == (24, 48, 72)
    assert int(jst.size) == st.size and int(jst.cursor) == st.cursor
    assert (st.prio[48:] == -1).all()


@pytest.mark.parametrize("mode", ("rank", "proportional"))
def test_sample_matches_jax(mode):
    cfg, jcfg, jst, st = filled(mode)
    n, alpha, beta = 16, 0.7, 0.5
    key = jax.random.PRNGKey(3)
    jidx, jiw = jreplay.replay_sample(jcfg, jst, key, n, jnp.float32(alpha),
                                      jnp.float32(beta))
    jidx, jiw = np.asarray(jidx), np.asarray(jiw)
    g = np.array(jax.random.gumbel(key, (M,), jnp.float32))
    tk = torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(
        np.int64))
    idx, iw = replay.replay_sample(cfg, st, n, alpha, beta, tk,
                                   gumbel=torch.from_numpy(g))
    assert set(idx.tolist()) == set(jidx.tolist())
    order = np.argsort(jidx)
    got = dict(zip(idx.tolist(), iw.tolist()))
    assert np.abs(np.array([got[i] for i in jidx[order]])
                  - jiw[order]).max() < 1e-6
    assert (idx < st.size).all() and len(set(idx.tolist())) == n
    # the key-following draw: JAX's bits, the logs within an ulp or so
    assert np.abs(rng.gumbel(tk, (M,)).numpy() - g).max() < 1e-6
    idx2, iw2 = replay.replay_sample(cfg, st, n, alpha, beta, tk)
    assert set(idx2.tolist()) == set(jidx.tolist())


def test_windows_and_prios_exact():
    cfg, jcfg, jst, st = filled("rank")
    idx = np.array([0, 5, 23, 44, 46, 47], np.int64)
    jw = jreplay.replay_gather_windows(jcfg, jst, jnp.asarray(idx))
    w = replay.replay_gather_windows(cfg, st, torch.from_numpy(idx))
    assert set(jw) == set(w)
    for k in jw:
        a, b = np.asarray(jw[k]), w[k].numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.shape == b.shape and (a == b).all(), k
    assert w["occ"].shape == (6, K + 1, 2, H)


def windows(seed, n=32, k=7):
    rs = np.random.RandomState(seed)
    occ = rs.randint(0, 1 << W, (n, k + 1, 2, H)).astype(np.uint32)
    occ[..., : H // 2] = 0
    done = (rs.rand(n, k + 1) < 0.15).astype(np.int32)
    return dict(occ=occ, vec=rs.rand(n, k + 1, 2, 12).astype(np.float32),
                reward=np.where(done, rs.choice([-1.0, 1.0], (n, k + 1)),
                                0.1 * rs.randn(n, k + 1)).astype(np.float32),
                done=done)


@pytest.mark.parametrize("kind,filt,trunc", [
    ("qnet", (2, 3), True), ("qnet", (), True), ("qnet", (2, 3), False),
    ("qnet", (), False), ("ppo", (2, 3), True)])
def test_kstep_targets_match_jax(kind, filt, trunc):
    params = small_params(4)
    jcls, cls = {"qnet": (jnets.QNet, nets.QNet),
                 "ppo": (jnets.PPONet, nets.PPONet)}[kind]
    model = dict(compute_dtype="float32", **SMALL)
    jnet = jcls(jnets.ModelConfig(**model))
    net = cls(nets.ModelConfig(**model), device="cpu")
    net.load_state_dict(params_from_flax(params))
    cfg = ve.EstimatorConfig(k_step=7, step_filter=filt,
                             truncate_aggregation=trunc)
    jcfg = jve.EstimatorConfig(**dataclasses.asdict(cfg))
    assert cfg.steps == jcfg.steps
    w = windows(5)
    want = np.asarray(jve.kstep_targets(
        JEngineConfig(), jnet, jcfg, {"params": params},
        {k: jnp.asarray(v) for k, v in w.items()}))
    tw = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                              else v) for k, v in w.items()}
    got = ve.kstep_targets(EngineConfig(), net, cfg, tw)
    assert got.dtype == torch.float32 and not got.requires_grad
    assert np.abs(want - got.numpy()).max() < 1e-5
    assert want.std() > 1e-3


def test_create_steps_matches_jax():
    for k, f in ((37, (2, 3)), (5, ()), (12, (5,))):
        assert ve.create_steps(k, f) == jve.create_steps(k, f)
    assert len(ve.create_steps(37, (2, 3))) == 13


def run_qnet(cfg_kw, params, seed):
    vecs, viss = make_inputs(4, seed)
    variables = params if "params" in params else {"params": params}
    jq = jnets.QNet(jnets.ModelConfig(**cfg_kw)).apply(
        variables, [jnp.asarray(v) for v in vecs],
        [jnp.asarray(v) for v in viss])
    net = nets.QNet(nets.ModelConfig(**cfg_kw), device="cpu")
    net.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        tq = net([torch.from_numpy(v) for v in vecs],
                 [torch.from_numpy(v) for v in viss])
    out = {}
    for name, a, b in zip("qva", jq, tq):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, name
        out[name] = np.abs(np.asarray(a) - b.numpy()).max()
    return out, [np.asarray(a) for a in jq]


def test_qnet_small_f32():
    err, (q, v, a) = run_qnet(dict(compute_dtype="float32", **SMALL),
                              small_params(2), 3)
    assert max(err.values()) < 1e-4, err
    assert q.shape == (4, 4, W, 7) and v.shape == (4, 1)
    assert q.std() > 1e-3 and np.abs(a).max() <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qnet_demo_weights(demo_params, dtype):
    err, _ = run_qnet(dict(compute_dtype=dtype), demo_params, 9)
    tol = {"q": 1e-4, "v": 1e-4, "a": 1e-4} if dtype == "float32" \
        else QNET_BF16_TOL
    for name in "qva":
        assert err[name] < tol[name], (name, err)


@pytest.fixture(scope="module")
def demo_params():
    from drl_tetris_tpu.runtime.checkpoint import restore_raw
    from tests.test_torch_nets import DEMO_DIR, DEMO_STEP
    return restore_raw(DEMO_DIR, DEMO_STEP)["params"]


def test_worker_view_shares_the_trunk():
    net = nets.PPONet(nets.ModelConfig(compute_dtype="float32", **SMALL),
                      device="cpu")
    view = net.worker_view()
    shared = {id(p) for p in view.parameters()}
    assert shared <= {id(p) for p in net.parameters()}
    assert not any("value_tower" in k for k in view.state_dict())
    vecs, viss = make_inputs(3, 1, unit_vec=True)
    vec = [torch.from_numpy(v) for v in vecs]
    vis = [torch.from_numpy(v) for v in viss]
    with torch.no_grad():
        (pi, v), (vpi, vv) = net(vec, vis), view(vec, vis)
    assert torch.equal(pi, vpi) and vv.shape == (3, 1) and (vv == 0).all()
