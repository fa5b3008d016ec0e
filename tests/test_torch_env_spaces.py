"""The env's placement action spaces against the JAX package, bit for bit
on every state leaf, reward and done flag: step_place, step_pose and the
three step_mixed variants (through the plain version, and through the g++
host build of the engine kernel's per-kind one-tick entry), get_actions,
the mirrored observation, and the engine's step_keys replaying the key
macros of placement_keys.

Games start from crowded boards (engine/checks.py) so that rounds end
within the replayed ticks.  JAX's step_place and step_pose are its
step_mixed and step_mixed_pose with every game of one kind (the same make
phase and finish phase), which keeps the JAX side at three compiles.  JAX's ticks of each
variant are committed (tests/jax_fixtures/env_spaces_*.npz,
tests/torch_jax_fixtures.py); a ``slow`` test steps JAX again and holds
it to the files.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import (assert_state_equal, jax_leaves,
                                      rekey_jax_cache, to_torch_state)

rekey_jax_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.engine import step as JS  # noqa: E402
from drl_tetris_tpu.env.env import (EnvConfig as JEnvConfig,  # noqa: E402
                                    TetrisVectorEnv as JEnv)

from drl_tetris_tpu_torch.engine import checks, cuda_tick  # noqa: E402
from drl_tetris_tpu_torch.engine import masks as M  # noqa: E402
from drl_tetris_tpu_torch.engine import step as S  # noqa: E402
from drl_tetris_tpu_torch.engine.core import tree_leaves  # noqa: E402
from drl_tetris_tpu_torch.env.env import (EnvConfig, TetrisVectorEnv,  # noqa: E402
                                          take_player)
from tests import torch_jax_fixtures as fixtures  # noqa: E402
from tests.test_torch_engine import (assert_torch_states_equal,  # noqa: E402
                                     host_kernel_lib)

N = 8
T = 14
H, W = 22, 10


def to_jax_state(tstate, jlike):
    """The port's state as a JAX pytree shaped like ``jlike``."""
    jl, tdef = jax.tree_util.tree_flatten(jlike)
    leaves = []
    for a, (_, b) in zip(jl, tree_leaves(tstate)):
        b = b.numpy()
        leaves.append(jnp.asarray(b.view(np.uint32) if a.dtype == np.uint32
                                  else b))
    return jax.tree_util.tree_unflatten(tdef, leaves)


@pytest.fixture(scope="module")
def envs():
    jenv = JEnv(JEnvConfig(), N)
    tenv = TetrisVectorEnv(EnvConfig(), N, device="cpu")
    js = jenv.reset(jax.random.PRNGKey(3))
    ts = checks.crowded(tenv.cfg, to_torch_state(js, tenv.reset(3)), seed=9)
    js = to_jax_state(ts, js)
    jfns = {"mixed": jenv.step_mixed, "mixed_pose": jenv.step_mixed_pose,
            "mixed_place_pose": jax.jit(jenv.step_mixed_place_pose)}
    return jenv, tenv, js, ts, jfns


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def pose_actions(env, st, rs):
    """(rot, col, y) per game: a top-drop rest, a free pose above it (the
    hard drop moves it), or a random pose (mostly not possible: the piece
    drops from where it is)."""
    ps = st.engine.players
    p = st.current_player
    mask, rest = M.top_drop(env.cfg.engine, take_player(ps.occ, p),
                            take_player(ps.piece, p), take_player(ps.rot, p))
    rot, col, y = [], [], []
    for n in range(N):
        cells = np.argwhere(mask[n].numpy())
        u = rs.rand()
        if len(cells) and u < 0.8:
            r, c = cells[rs.randint(len(cells))]
            yy = int(rest[n, r, c]) - (rs.randint(0, 3) if u < 0.3 else 0)
        else:
            r, c, yy = rs.randint(0, 4), rs.randint(-1, W + 1), \
                rs.randint(-2, H + 1)
        rot.append(r)
        col.append(c)
        y.append(yy)
    return _i32(rot), _i32(col), _i32(y)


def make_actions(variant, env, st, rs):
    """(port call, JAX call) for one tick of ``variant``."""
    r_place = _i32(rs.randint(0, 4, N))
    x_place = _i32(rs.randint(-3, W + 2, N))
    r_macro = _i32(rs.randint(0, 4, N))
    t_macro = _i32(rs.randint(0, W, N))
    rot, col, y = pose_actions(env, st, rs)
    which = torch.from_numpy(rs.rand(N) < 0.5)
    if variant == "place":
        return ((env.step_place, (r_place, x_place)),
                ("mixed", (torch.ones(N, dtype=torch.bool), r_place,
                           x_place)))
    if variant == "pose":
        return ((env.step_pose, (rot, col, y)),
                ("mixed_pose", (torch.ones(N, dtype=torch.bool), rot, col,
                                y)))
    if variant == "mixed":
        r = torch.where(which, r_place, r_macro)
        t = torch.where(which, x_place, t_macro)
        return ((env.step_mixed, (which, r, t)), ("mixed", (which, r, t)))
    if variant == "mixed_pose":
        r = torch.where(which, rot, r_macro)
        t = torch.where(which, col, t_macro)
        return ((env.step_mixed_pose, (which, r, t, y)),
                ("mixed_pose", (which, r, t, y)))
    r = torch.where(which, rot, r_place)
    t = torch.where(which, col, x_place)
    return ((env.step_mixed_place_pose, (which, r, t, y)),
            ("mixed_place_pose", (which, r, t, y)))


def host_step(lib):
    """cuda_tick.step through the g++ build of the kernel's tick."""
    def step(cfg, state, r, t, kind=None, y=None):
        args, keep, (outs, rew, done) = cuda_tick.step_args(
            cfg, state, r.to(torch.int32).contiguous(),
            t.to(torch.int32).contiguous(),
            None if kind is None else kind.to(torch.int32).contiguous(),
            None if y is None else y.to(torch.int32).contiguous())
        assert lib.engine_tick_host_step(*args) == 0
        del keep
        return cuda_tick.unflatten(outs), rew, done
    return step


VARIANTS = ["place", "pose", "mixed", "mixed_pose", "mixed_place_pose"]


def jax_variant_run(envs, variant) -> dict:
    """T ticks of JAX's step for ``variant`` from the crowded boards, the
    actions drawn as the test draws them from JAX's states: each tick's
    leaf digests, reward and done, and the final state as leaves
    (tests/jax_fixtures/env_spaces_VARIANT.npz)."""
    _, tenv, js, ts, jfns = envs
    rs = np.random.RandomState(len(variant))
    ticks = []
    for _ in range(T):
        _, (jname, jargs) = make_actions(variant, tenv,
                                         to_torch_state(js, ts), rs)
        js, jrew, jdone = jfns[jname](js, *[jnp.asarray(a.numpy())
                                            for a in jargs])
        ticks.append(dict(digests=fixtures.digests(jax_leaves(js)),
                          rew=jrew, done=jdone))
    return dict(ticks=ticks, final=jax_leaves(js))


@pytest.mark.parametrize("variant", VARIANTS)
def test_step_variant_matches_jax(envs, variant, monkeypatch):
    """T ticks of one variant from crowded boards: the port's plain tick
    equals JAX's every tick, and the host build of the kernel's per-kind
    entry equals the plain tick from the same state."""
    ref = fixtures.load(f"env_spaces_{variant}")
    _, tenv, _, ts, _ = envs
    lib = host_kernel_lib()
    rs = np.random.RandomState(len(variant))
    plain_step = cuda_tick.step
    n_done = 0
    assert len(ref["ticks"]) == T
    for tick, want in enumerate(ref["ticks"]):
        (fn, targs), _ = make_actions(variant, tenv, ts, rs)
        before = ts
        ts, rew, done = fn(ts, *targs)
        fixtures.assert_digests(want["digests"], ts, f"{variant} tick {tick}")
        assert (want["rew"] == rew.numpy()).all(), tick
        assert (want["done"] == done.numpy()).all(), tick
        n_done += int(done.sum())
        if lib is not None:
            monkeypatch.setattr(cuda_tick, "step", host_step(lib))
            hs, hrew, hdone = fn(before, *targs)
            monkeypatch.setattr(cuda_tick, "step", plain_step)
            assert torch.equal(hrew, rew) and torch.equal(hdone, done), tick
            assert_torch_states_equal(hs, ts, f"host {variant} {tick}")
    assert_state_equal(ref["final"], ts, f"{variant} final")
    assert n_done > 0


# slow: a JAX program each, 105-135 s cold
@pytest.mark.slow
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_fixture_regenerates(envs, variant):
    fixtures.regenerates(f"env_spaces_{variant}",
                         lambda: jax_variant_run(envs, variant))


def test_get_actions_and_mirrored_observe(envs):
    jenv, tenv, js, ts, _ = envs
    got = tenv.get_actions(ts)
    ref = np.asarray(jenv.get_actions(js))
    assert (ref == got.numpy()).all()
    assert int(got.sum()) > N
    for mirrored in (False, True):
        jo = jenv.observe(js, mirrored=mirrored)
        to = tenv.observe(ts, mirrored=mirrored)
        for a, b in zip(jo, to):
            assert (np.asarray(a) == b.numpy()).all(), mirrored


def test_step_keys_replays_placement_macros(envs):
    """The key macro of a legal rest (placement_keys from the spawn pose),
    pressed through step_keys, against JAX's step_keys; the locked board
    equals the pose lock of the same rest."""
    _, tenv, js, ts, _ = envs
    cfg = tenv.cfg.engine
    ps = ts.engine.players
    p = ts.current_player
    occ, piece, rot = (take_player(a, p) for a in (ps.occ, ps.piece, ps.rot))
    legal = M.legal_rests(cfg, occ, piece, rot)
    rs = np.random.RandomState(1)
    tgt = []
    for n in range(N):
        cells = np.argwhere(legal[n].numpy())
        tgt.append(cells[rs.randint(len(cells))])
    tgt = _i32(tgt)
    r_abs = torch.where(piece == 6, rot, tgt[:, 0])
    start = (rot, take_player(ps.px, p), take_player(ps.py, p))
    keys, ok = M.placement_keys(cfg, occ, piece, rot, start, r_abs,
                                tgt[:, 1], tgt[:, 2])
    assert int(ok.sum()) > N // 2
    both = torch.zeros(N, 2, keys.shape[1], dtype=torch.int32)
    both[torch.arange(N), p.long()] = keys
    dt = tenv.cfg.time_elapsed_each_action
    got = S.step_keys(cfg, ts.engine, both, dt)
    ref = jax.jit(jax.vmap(lambda e, k: JS.step_keys(
        JS_CFG, e, k, jnp.int32(dt))))(js.engine, jnp.asarray(both.numpy()))
    assert_state_equal(ref, got, "step_keys")
    use = torch.arange(2)[None, :] == p[:, None]
    posed = S.step_pose(cfg, ts.engine, use, r_abs[:, None].expand(N, 2),
                        tgt[:, 1, None].expand(N, 2),
                        tgt[:, 2, None].expand(N, 2), dt)
    same = ok & ~ts.engine.round_over
    assert torch.equal(take_player(got.players.occ, p)[same],
                       take_player(posed.players.occ, p)[same])


JS_CFG = JEnvConfig().engine
