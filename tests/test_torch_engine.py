"""The port's engine and env (plain PyTorch, on the CPU) against the JAX
package, bit for bit on every state leaf, reward and done flag.

The JAX side of the engine kernel's function is the XLA ``env.step``
(tests/test_pallas_tick.py holds the Pallas kernel equal to it).  Actions
are replayed from a line-clearing policy so that line clears, combos,
garbage sent and received, deaths and round resets all occur; the test
asserts that each did.  A host (g++) build of the CUDA kernel's tick is
held against the plain version on the same trajectory.  JAX's
trajectories are committed (tests/jax_fixtures/engine_width*.npz: the
reset and final states, and each tick's leaf digests, rewards and dones;
tests/torch_jax_fixtures.py); a ``slow`` test steps JAX again and holds
it to the files.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import (assert_state_equal, jax_leaves,
                                      rekey_jax_cache, to_torch_state, REPO)

rekey_jax_cache()

import ctypes  # noqa: E402
import functools  # noqa: E402
import hashlib  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.engine import pieces as jpieces  # noqa: E402
from drl_tetris_tpu.engine.core import EngineConfig as JEngineConfig  # noqa: E402
from drl_tetris_tpu.env.env import (EnvConfig as JEnvConfig,  # noqa: E402
                                    TetrisVectorEnv as JEnv)

from drl_tetris_tpu_torch.engine import cuda_tick  # noqa: E402
from drl_tetris_tpu_torch.engine import kernels as K  # noqa: E402
from drl_tetris_tpu_torch.engine import pieces as tpieces  # noqa: E402
from drl_tetris_tpu_torch.engine import step as S  # noqa: E402
from drl_tetris_tpu_torch.engine.core import (EngineConfig,  # noqa: E402
                                              tree_map)
from drl_tetris_tpu_torch.env.env import (EnvConfig, TetrisVectorEnv,  # noqa: E402
                                          step_plain)
from tests import torch_jax_fixtures as fixtures  # noqa: E402

N_GAMES = 64
N_TICKS = 64


def test_piece_tables_equal_jax_package():
    for name in ("ROW_MASKS", "SPAWN_ROT", "N_SYM_ROT", "TILE", "GRIDS",
                 "LPIECE"):
        a, b = getattr(jpieces, name), getattr(tpieces, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert (a == b).all(), name
    from drl_tetris_tpu.env.observations import PIECE_SWAP_NP as j_swap
    from drl_tetris_tpu_torch.env.observations import PIECE_SWAP_NP
    assert (j_swap == PIECE_SWAP_NP).all()


def test_combo_pow_table_is_jax_power():
    """The payout table holds JAX's own float32 power(cc, 1.4 + cc*0.01)
    (compiled as the engine compiles it), cc = 0..255."""
    cc = np.arange(len(S.COMBO_POW_BITS), dtype=np.float32)
    ref = np.asarray(jax.jit(
        lambda c: jnp.power(c, jnp.float32(1.4) + c * jnp.float32(0.01)))(cc))
    assert (ref.view(np.uint32) == S.COMBO_POW_BITS).all()


def test_combo_payout_matches_jax():
    """The whole payout, (pow * (1 + t/60000*0.1)) truncated, against the
    JAX engine's _combo_check over combo counts 1..40 and times to 1.2M ms
    (where float32 pow libraries disagree in the last ulp)."""
    from drl_tetris_tpu.engine import step as JS
    from drl_tetris_tpu.engine.core import zeros_player_state as jzeros
    jcfg = JEngineConfig()
    cc = np.repeat(np.arange(1, 41, dtype=np.int32), 3001)
    t = np.tile(np.arange(0, 1_200_400, 400, dtype=np.int32), 40)
    view = jax.tree.map(lambda a: a[0], jzeros(jcfg))

    def one(c, tm):
        v = view.replace(combo_count=c, time_ms=tm, combo_start=jnp.int32(0),
                         combo_time=jnp.int32(-1))
        return JS._combo_check(jcfg, v)[1]
    ref = np.asarray(jax.jit(jax.vmap(one))(cc, t))

    tcfg = EngineConfig()
    z = torch.zeros(len(cc), 2, dtype=torch.int32)
    ps = S.zeros_player_state(tcfg, len(cc))
    v = S._get(ps, 0).replace(combo_count=torch.from_numpy(cc),
                              time_ms=torch.from_numpy(t),
                              combo_start=z[:, 0], combo_time=z[:, 0] - 1)
    got = S._combo_check(tcfg, v)[1].numpy()
    assert (got == ref).all(), np.argwhere(got != ref)[:5]


# ---------------------------------------------------------------------------
# Trajectories
# ---------------------------------------------------------------------------

def greedy_actions(cfg, state, random_rows, gen):
    """(r, t) per game: the acting player's macro that maximises a
    line-clearing score (lines, heights, holes, bumpiness), tried for all
    4 x W macros with the port's plain engine; games whose acting player
    is marked in ``random_rows`` (N, 2) play a uniform random macro, so
    that rounds end."""
    e = cfg.engine
    H, W = e.height, e.width
    ps = state.engine.players
    n = ps.piece.shape[0]
    p = state.current_player.long()
    view = S._widen(tree_map(lambda a: a[torch.arange(n), p], ps))
    C = 4 * W
    rep = tree_map(lambda a: a.repeat_interleave(C, dim=0), view)
    rr = torch.arange(4, dtype=torch.int32).repeat_interleave(W).repeat(n)
    tt = torch.arange(W, dtype=torch.int32).repeat(4).repeat(n)
    v2 = S.apply_macro(e, rep, rr, tt)
    occ, _, ncl, _ = K.clear_lines(e, v2.occ, v2.garb, v2.py)
    cols = torch.arange(W, dtype=torch.int64)
    filled = ((occ[..., None] >> cols) & 1).bool()              # (M, H, W)
    top = torch.where(filled.any(1), filled.int().argmax(1), H)
    height = (H - top).float()
    holes = (height - filled.sum(1).float()).sum(-1)
    bump = (height[:, 1:] - height[:, :-1]).abs().sum(-1)
    score = (0.76 * ncl.float() - 0.51 * height.sum(-1) - 0.36 * holes
             - 0.18 * bump).reshape(n, C)
    best = score.argmax(-1)
    r, t = (best // W).to(torch.int32), (best % W).to(torch.int32)
    rnd = random_rows[torch.arange(n), p]
    r = torch.where(rnd, torch.randint(0, 4, (n,), generator=gen,
                                       dtype=torch.int32), r)
    t = torch.where(rnd, torch.randint(0, W, (n,), generator=gen,
                                       dtype=torch.int32), t)
    return r, t


_JENVS = {}


def jax_env(width):
    """One JAX env per width for the module (its jitted methods are keyed
    on the instance, so reuse keeps JAX at one compile per shape)."""
    if width not in _JENVS:
        _JENVS[width] = JEnv(JEnvConfig(engine=JEngineConfig(width=width)),
                             N_GAMES)
    return _JENVS[width]


def actions_source(seed):
    """The generator and random rows of a parity run's actions."""
    gen = torch.Generator().manual_seed(seed)
    return gen, torch.rand(N_GAMES, 2, generator=gen) < 0.35


def jax_parity_run(width, n_ticks, seed) -> dict:
    """JAX env.step for n_ticks along the actions the greedy policy picks
    on JAX's states: the reset and the final state as leaves, and each
    tick's leaf digests, rewards and dones
    (tests/jax_fixtures/engine_widthW.npz)."""
    jenv = jax_env(width)
    tenv = TetrisVectorEnv(port_cfg(width), N_GAMES, device="cpu")
    like = tenv.reset(seed)
    js = jenv.reset(jax.random.PRNGKey(seed))
    gen, random_rows = actions_source(seed)
    out = dict(reset=jax_leaves(js), ticks=[])
    for _ in range(n_ticks):
        r, t = greedy_actions(tenv.cfg, to_torch_state(js, like),
                              random_rows, gen)
        js, rew, done = jenv.step(js, jnp.asarray(r.numpy()),
                                  jnp.asarray(t.numpy()))
        out["ticks"].append(dict(digests=fixtures.digests(jax_leaves(js)),
                                 rew=rew, done=done))
    out["final"] = jax_leaves(js)
    return out


def run_parity(width, n_ticks, seed):
    """Drive the port's plain step with the actions JAX's run took
    (tests/jax_fixtures/engine_widthW.npz) for n_ticks; compare every
    leaf, reward and done each tick.  Returns (actions (T, N) x2, the
    port's start state, its final state, event counts)."""
    ref = fixtures.load(f"engine_width{width}")
    assert len(ref["ticks"]) == n_ticks
    tenv = TetrisVectorEnv(port_cfg(width), N_GAMES, device="cpu")
    ts = tenv.reset(seed)
    assert_state_equal(ref["reset"], ts, "reset")
    start = ts
    gen, random_rows = actions_source(seed)
    ev = dict(done=0, clears=0, combos=0, sent=0, received=0,
              combo_sent=0, blocked=0, wins=0)
    ars, ats = [], []
    for tick, want in enumerate(ref["ticks"]):
        r, t = greedy_actions(tenv.cfg, ts, random_rows, gen)
        ars.append(r)
        ats.append(t)
        prev = ts.engine.players
        ts, trew, tdone = tenv.step(ts, r, t)
        fixtures.assert_digests(want["digests"], ts, f"tick {tick}")
        assert (want["rew"] == trew.numpy()).all(), tick
        assert (want["done"] == tdone.numpy()).all(), tick
        ps = ts.engine.players
        live = ~tdone[:, None]
        ev["done"] += int(tdone.sum())
        ev["wins"] += int((trew == 1).sum())
        ev["clears"] += int(((ps.lines_cleared > prev.lines_cleared)
                             & live).sum())
        ev["combos"] += int(((ps.max_combo >= 2) & live).sum())
        ev["sent"] += int(((ps.lines_sent > prev.lines_sent) & live).sum())
        ev["received"] += int(((ps.garb != 0).any(-1) & live).sum())
        ev["blocked"] += int(((ps.lines_blocked > prev.lines_blocked)
                              & live).sum())
        ev["combo_sent"] += int(((prev.combo_count > 0)
                                 & (ps.combo_count == 0)
                                 & (ps.lines_sent > prev.lines_sent)
                                 & live).sum())
    assert_state_equal(ref["final"], ts, "final")
    return (torch.stack(ars), torch.stack(ats)), start, ts, ev


@pytest.fixture(scope="module")
def trajectory():
    return run_parity(10, N_TICKS, seed=7)


# slow: JAX's env step, about 150 s cold at each width
@pytest.mark.slow
@pytest.mark.parametrize("width, n_ticks, seed", [(10, N_TICKS, 7),
                                                  (25, 60, 3)])
def test_engine_fixture_regenerates(width, n_ticks, seed):
    fixtures.regenerates(f"engine_width{width}",
                         lambda: jax_parity_run(width, n_ticks, seed))


def port_cfg(width):
    return EnvConfig(engine=EngineConfig(width=width))


def test_reset_matches_jax():
    jenv = jax_env(10)
    for seed in (0, 123):
        js = jenv.reset(jax.random.PRNGKey(seed))
        ts = TetrisVectorEnv(port_cfg(10), N_GAMES, device="cpu").reset(seed)
        assert_state_equal(js, ts, f"reset {seed}")


def test_env_step_matches_jax(trajectory):
    """N_TICKS ticks at N = 64, every leaf/reward/done equal each tick,
    with every kind of engine event on the way."""
    _, _, final, ev = trajectory
    for k in ("done", "wins", "clears", "combos", "sent", "received",
              "combo_sent", "blocked"):
        assert ev[k] > 0, (k, ev)
    assert int(final.rounds_played.sum()) > N_GAMES


# ---------------------------------------------------------------------------
# The CUDA kernel's per-game code, built for the host
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def host_kernel_lib():
    """Build csrc/engine_tick_host.cpp (which includes the kernel source
    without __CUDACC__, a warp's lanes as arrays) with g++, once per source:
    the library goes to build/torch_kernels/ under the digest of both
    files, so the test modules and workers of a run share one build.  None
    when no g++ is installed."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    csrc = os.path.join(REPO, "drl_tetris_tpu_torch", "csrc")
    src = os.path.join(csrc, "engine_tick_host.cpp")
    digest = hashlib.sha1()
    for name in ("engine_tick.cu", "engine_tick_host.cpp"):
        with open(os.path.join(csrc, name), "rb") as f:
            digest.update(f.read())
    out = (cuda_tick.BUILD_DIR /
           f"libengine_tick_host-{digest.hexdigest()[:12]}.so")
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                              "-shared", "-fPIC", "-o", str(tmp), src],
                             capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    cuda_tick.declare(lib.engine_tick_host_step, lib.engine_tick_host_rollout,
                      with_stream=False)
    assert lib.engine_tick_host_n_leaves() == len(cuda_tick.LEAF_NAMES)
    return lib


def host_step(lib, cfg, state, r, t):
    args, keep, (outs, reward, done) = cuda_tick.step_args(cfg, state, r, t)
    assert lib.engine_tick_host_step(*args) == 0
    del keep
    return cuda_tick.unflatten(outs), reward, done


def host_rollout(lib, cfg, state, n_ticks, actions=None, base_key=None,
                 block_games=16):
    if base_key is not None:
        base_key = [int(v) for v in base_key]
    args, keep, outs = cuda_tick.rollout_args(cfg, state, n_ticks, actions,
                                              base_key, block_games)
    assert lib.engine_tick_host_rollout(*args) == 0
    del keep
    return cuda_tick.unflatten(outs)


def assert_torch_states_equal(a, b, where=""):
    from drl_tetris_tpu_torch.engine.core import tree_leaves
    for (name, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape, (where, name)
        assert torch.equal(x, y), (where, name,
                                   torch.nonzero(x != y)[:5].tolist())


def test_host_kernel_matches_plain(trajectory):
    """The kernel's tick (one warp's work, its lanes run on the host)
    against the plain PyTorch tick: the one-tick entry tick by tick with
    reward and done, and the T-tick entry with replayed and with in-kernel
    random actions."""
    lib = host_kernel_lib()
    if lib is None:
        pytest.skip("no g++ to build the kernel's host form")
    (ar, at), start, final, _ = trajectory
    cfg = port_cfg(10)
    hs, ps = start, start
    for tick in range(ar.shape[0]):
        hs, hr, hd = host_step(lib, cfg, hs, ar[tick], at[tick])
        ps, pr, pd = step_plain(cfg, ps, ar[tick], at[tick])
        assert torch.equal(hr, pr) and torch.equal(hd, pd), tick
        assert_torch_states_equal(hs, ps, f"step {tick}")
    assert_torch_states_equal(hs, final, "step end")
    ro = host_rollout(lib, cfg, start, ar.shape[0],
                      actions=(ar.contiguous(), at.contiguous()))
    assert_torch_states_equal(ro, final, "rollout replayed")
    base = torch.tensor([123, 456789], dtype=torch.int64)
    ro = host_rollout(lib, cfg, start, 30, base_key=base, block_games=16)
    ref = cuda_tick.rollout_plain(cfg, start, 30, base_key=base,
                                  block_games=16)
    assert_torch_states_equal(ro, ref, "rollout random")
    assert int(ro.rounds_played.sum()) > N_GAMES
