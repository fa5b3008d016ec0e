"""The port's placement masks (drl_tetris_tpu_torch/engine/masks.py)
against the JAX package's, bit for bit: top-drop masks, the successor
boards, the finesse replica, the full legal set, and the key-press BFS with
its key macros, on the 22 x 10 board for every piece (and the O piece at
every rotation), over boards from random play, the crowded boards of
engine/checks.py and hand-made stacks: tall stacks, wells at both walls and
overhangs for tucks and kicks.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.engine import masks as JM  # noqa: E402
from drl_tetris_tpu.engine.core import EngineConfig as JEngineConfig  # noqa: E402

from drl_tetris_tpu_torch.engine import checks  # noqa: E402
from drl_tetris_tpu_torch.engine import masks as M  # noqa: E402
from drl_tetris_tpu_torch.engine.core import EngineConfig  # noqa: E402
from drl_tetris_tpu_torch.engine.pieces import SPAWN_ROT  # noqa: E402
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv  # noqa: E402

H, W = 22, 10
CFG = EngineConfig()
JCFG = JEngineConfig()


def hand_boards(rs):
    """Tall stacks, wells at both walls, overhangs (rows with a roof over
    an open gap) and a few random rows."""
    full = (1 << W) - 1
    out = []
    for k in range(8):
        b = np.zeros(H, np.int64)
        h = rs.randint(3, 18)
        well = (0, W - 1, rs.randint(0, W))[k % 3]
        for y in range(H - h, H):
            b[y] = full & ~(1 << well)
            if rs.rand() < 0.4:
                b[y] &= ~(1 << rs.randint(0, W))
        for y in range(max(0, H - h - 4), H - h):     # overhang roofs
            if rs.rand() < 0.5:
                lo = rs.randint(0, W - 3)
                b[y] = ((1 << rs.randint(2, 5)) - 1) << lo
        out.append(b)
    return np.stack(out)


def play_boards():
    """Both players' boards after random macro play (the port's plain
    engine, held equal to JAX's elsewhere), and crowded boards."""
    env = TetrisVectorEnv(EnvConfig(), 8, device="cpu")
    st = env.reset(5)
    rs = np.random.RandomState(2)
    boards = []
    for tick in range(24):
        r = torch.from_numpy(rs.randint(0, 4, 8).astype(np.int32))
        t = torch.from_numpy(rs.randint(0, W, 8).astype(np.int32))
        st, _, _ = env.step(st, r, t)
        if tick in (11, 23):
            boards.append(st.engine.players.occ.reshape(-1, H).numpy())
    crowded = checks.crowded(env.cfg, st, seed=3).engine.players.occ
    boards.append(crowded.reshape(-1, H)[:8].numpy())
    return np.concatenate(boards).view(np.uint32).astype(np.int64)


@pytest.fixture(scope="module")
def cases():
    """(occ (B, H) uint32, garb, piece, rot): every board with every piece
    at its spawn rotation, and with the O piece at each rotation."""
    rs = np.random.RandomState(0)
    boards = np.concatenate([hand_boards(rs), play_boards()])
    boards = boards[np.argsort(-np.count_nonzero(boards, 1))][:9]
    nb = len(boards)
    occ = np.repeat(boards, 10, 0).astype(np.uint32)
    piece = np.tile(np.array([0, 1, 2, 3, 4, 5, 6, 6, 6, 6]), nb)
    rot = np.tile(np.concatenate([SPAWN_ROT, [1, 2, 3]]), nb)
    garb = occ & rs.randint(0, 1 << W, occ.shape).astype(np.uint32)
    return occ, garb, piece.astype(np.int32), rot.astype(np.int32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a.copy())


def _eq(ref, got, what):
    ref = np.asarray(ref)
    got = got.numpy()
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    bad = np.argwhere(ref != got)
    assert not len(bad), (what, bad[:5])


@pytest.fixture(scope="module")
def jax_masks(cases):
    """Every JAX mask output of the cases, one compile."""
    def one(o, g, p, r):
        return (JM.top_drop(JCFG, o, p, r),
                JM.placement_boards(JCFG, o, g, p, r),
                JM.finesse_rests(JCFG, o, p, r),
                JM.pose_boards(JCFG, o, g, p, r))
    return jax.jit(jax.vmap(one))(*cases)


def test_row_tables_match_jax():
    """lookup_rows_all and select_rot, every piece and rotation (and ids
    out of range)."""
    from drl_tetris_tpu.engine import kernels as JK
    from drl_tetris_tpu_torch.engine import kernels as K
    piece = np.repeat(np.arange(-1, 8, dtype=np.int32), 6)
    rot = np.tile(np.arange(-1, 5, dtype=np.int32), 9)
    ref_all = np.asarray(jax.vmap(JK.lookup_rows_all)(piece))
    got_all = K.lookup_rows_all(torch.from_numpy(piece))
    _eq(ref_all, got_all.to(torch.int32), "rows_all")
    ref = np.asarray(jax.vmap(JK.select_rot)(ref_all, rot))
    got = K.select_rot(got_all, torch.from_numpy(rot))
    _eq(ref, got.to(torch.int32), "select_rot")


def test_top_drop_and_placement_boards(cases, jax_masks):
    occ, garb, piece, rot = map(_t, cases)
    (jmask, jrest), jpb, _, _ = jax_masks
    mask, rest = M.top_drop(CFG, occ, piece, rot)
    _eq(jmask, mask, "mask")
    _eq(jrest, rest, "rest_y")
    for a, b, name in zip(jpb, M.placement_boards(CFG, occ, garb, piece,
                                                  rot),
                          ("mask", "occ_after", "cleared")):
        _eq(a, b, name)
    assert np.asarray(jpb[2]).sum() > 0          # some placements clear


def test_finesse_legal_and_pose_boards(cases, jax_masks):
    occ, garb, piece, rot = map(_t, cases)
    _, _, jfin, jpose = jax_masks
    fin = M.finesse_rests(CFG, occ, piece, rot)
    _eq(jfin, fin, "finesse_rests")
    assert int(fin.sum()) > 20                   # tucks, slides and kicks
    # pose_boards' rests are legal_rests' (the same function)
    for a, b, name in zip(jpose, M.pose_boards(CFG, occ, garb, piece, rot),
                          ("legal_rests", "occ_after", "cleared")):
        _eq(a, b, name)


def test_reachable_and_placement_keys(cases, jax_masks):
    """The BFS rests and, for one legal rest per case, the key macro that
    reaches it (tests/test_torch_env_spaces.py replays such macros through
    step_keys)."""
    occ, _, piece, rot = (np.asarray(c)[::3] for c in cases)
    n = len(piece)
    start = (rot, np.full(n, (W - 4) // 2, np.int32), np.zeros(n, np.int32))
    fin = np.asarray(jax_masks[3][0])[::3]       # JAX's legal rests
    rs = np.random.RandomState(4)
    tgt = []
    for i in range(n):
        cells = np.argwhere(fin[i])
        tgt.append(cells[rs.randint(len(cells))] if len(cells) else (0, 0, 0))
    tgt = np.asarray(tgt, np.int32)

    @jax.jit
    def jax_side(o, p, r, s, ra, c, y):
        rest = jax.vmap(lambda *a: JM.reachable(JCFG, *a[:3], a[3:]))(
            o, p, r, *s)
        keys, ok = jax.vmap(lambda o, p, r, s0, s1, s2, ra, c, y:
                            JM.placement_keys(JCFG, o, p, r, (s0, s1, s2),
                                              ra, c, y))(o, p, r, *s, ra, c, y)
        return rest, keys, ok

    # the O piece's enumerated row is its current rotation
    r_abs = np.where(piece == 6, rot, tgt[:, 0]).astype(np.int32)
    jrest, jkeys, jok = jax_side(occ, piece, rot, start, r_abs, tgt[:, 1],
                                 tgt[:, 2])
    t_start = tuple(map(_t, start))
    _eq(jrest, M.reachable(CFG, _t(occ), _t(piece), _t(rot), t_start),
        "reachable")
    keys, ok = M.placement_keys(CFG, _t(occ), _t(piece), _t(rot), t_start,
                                _t(r_abs), _t(tgt[:, 1]), _t(tgt[:, 2]))
    _eq(jkeys, keys, "placement_keys")
    _eq(jok, ok, "placement_keys ok")
    assert int(ok.sum()) > n // 2 and int((keys != 0).sum()) > n
