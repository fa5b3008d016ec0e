"""Legal-placement enumeration: the top-drop and full (top-drop and finesse)
placement action spaces, their successor boards, and the key-press BFS.

Counterpart of ``drl_tetris_tpu/engine/masks.py`` (reference: TestField.cpp,
the reference's action-mask generator; semantics and the bug-compatible
quirks of its finesse search are documented there).  Each function takes
a batch of N boards, ``occ`` (N, H) as int32 bit patterns (or int64 uint32
values), ``piece`` and ``cur_rot`` (N,), and works on every candidate of
every game at once: the (rotation, column) grid (4, W), the pose grid
(4, W, H) or the BFS state grid (4, W + 4, H + 4).  The JAX package vmaps
over games and the grid; here each primitive takes one board per game
(``board``: the walled rows and a table of hit words) and candidate
tensors (N, M) (rows (N, M, 4)), so no board is copied per candidate.  Column c of a grid is posX = c - 1; pieces with one
enumerated rotation (O) keep their current rotation.

  top_drop          spawn-row placement mask and rest rows, (4, W)
  placement_boards  the board after each top-drop placement locks and
                    lines clear (the world model of SIXten and Sherlock)
  finesse_rests     the bug-compatible replica of TestField's finesse
                    emission set, (4, W, H)
  legal_rests       top-drop rests and finesse rests (get_actions)
  pose_boards       the board after each legal pose locks
  reachable         the rests reachable by key presses (BFS)
  reachable_paths   the BFS with parent pointers and the key of each move
  placement_keys    the key macro that reaches a rest

The finesse search's walks have fixed iteration counts (W + 4 steps), run
as unrolled selects; the walks and wall-kick probes of one call are
batched into one candidate axis (two walk passes per call), so a call is
a fixed sequence of tensor operations with no host read.  ``reachable``,
``reachable_paths`` and ``placement_keys`` are used by tests only.
"""
from __future__ import annotations

import torch

from drl_tetris_tpu_torch.engine import kernels as K
from drl_tetris_tpu_torch.engine.core import (N_SYM_ROT, ROW_MASKS,
                                              EngineConfig)
from drl_tetris_tpu_torch.engine.rng import to_i32, u32

I64 = torch.int64
_BIG = 1 << 20
# doWallKick's reverse probe sequence (TestField.cpp:304-309), in order
_REV_PROBES = ((0, -1), (-1, 0), (1, 0), (-1, -1), (1, -1), (-2, 0), (2, 0))
_KEY_HARD_DROP = 7
_CACHE = {}


def _tables(device):
    """(ROW_MASKS (7, 4, 4) int64, N_SYM_ROT (7,) int64) on ``device``."""
    t = _CACHE.get(device)
    if t is None:
        t = (torch.as_tensor(ROW_MASKS.astype("int64"), device=device),
             torch.as_tensor(N_SYM_ROT.astype("int64"), device=device))
        _CACHE[device] = t
    return t


def _rows(piece, rot):
    """Row masks (..., 4) of per-game ``piece`` (N,) at rotations ``rot``
    (N, ...) in [0, 3]."""
    table, _ = _tables(piece.device)
    p = piece.long().clamp(0, 6).reshape((-1,) + (1,) * (rot.ndim - 1))
    return table[p.expand(rot.shape), rot.long()]


def _flat(*xs):
    """(N, ...) tensors as (N, M)."""
    return [x.reshape(x.shape[0], -1) for x in xs]


# ---------------------------------------------------------------------------
# Primitives.  A board is (ext (N, H), words (N, 32 * 16)): word [s, m] has
# bit y set where board row y meets the 4-bit piece row m shifted by s (the
# piece's px + 4), so a candidate's collisions with the board are four
# gathered words, not four rows of H tests.  Candidates are (N, M) tensors
# (piece rows (N, M, 4)).
# ---------------------------------------------------------------------------

def _ar(n, device):
    return torch.arange(n, dtype=I64, device=device)


def _shifted_masks(device):
    t = _CACHE.get(("shm", device))
    if t is None:
        s = _ar(32, device)[:, None]
        m = _ar(16, device)[None, :]
        t = _CACHE[("shm", device)] = (m << s) & 0xFFFFFFFF
    return t


def board(cfg: EngineConfig, occ):
    """(ext, words) of (N, H) boards of uint32 rows."""
    ext = K.ext_board(cfg, occ)
    hit = (ext[:, None, None, :] & _shifted_masks(ext.device)[..., None]) \
        != 0                                                 # (N, 32, 16, H)
    words = (hit.to(I64) << _ar(cfg.height, ext.device)).sum(-1)
    return ext, words.reshape(ext.shape[0], -1)


def _words(bd, rows, px):
    """(N, M, 4) hit words of the piece rows at posX px (0 for a shift
    outside [0, 31], which moves every bit out)."""
    words = bd[1]
    s = (px + 4)[..., None]
    idx = s.clamp(0, 31) * 16 + rows
    w = words.gather(1, idx.reshape(words.shape[0], -1)).reshape(idx.shape)
    return torch.where((s >= 0) & (s < 32), w, 0)


def _min4(x):
    """Minimum over a last axis of 4 (elementwise: a reduction over so
    short an axis is slow)."""
    return torch.minimum(torch.minimum(x[..., 0], x[..., 1]),
                         torch.minimum(x[..., 2], x[..., 3]))


def _any4(x):
    return (x[..., 0] | x[..., 1]) | (x[..., 2] | x[..., 3])


def _high_bit(x):
    """Index of the highest set bit of x >= 0 (< 2**53), -BIG for 0."""
    e = torch.frexp(x.to(torch.float64)).exponent.to(I64)
    return torch.where(x > 0, e - 1, -_BIG)


def _possible_w(cfg, w, rows, py):
    ys = py[..., None] + _ar(4, w.device)                    # (N, M, 4)
    inr = (ys >= 0) & (ys < cfg.height)
    hit = _any4(inr & (((w >> ys.clamp(0, 62)) & 1) != 0))
    oob = _any4((rows != 0) & ~inr)
    return ~(oob | hit)


def possible(cfg: EngineConfig, bd, rows, px, py):
    """BasicField::possible of every candidate."""
    return _possible_w(cfg, _words(bd, rows, px), rows, py)


def drop_distance(cfg: EngineConfig, bd, rows, px, py):
    """Rows each candidate can fall before the first collision."""
    w = _words(bd, rows, px)
    base = py[..., None] + _ar(4, w.device)
    above = w & ~((1 << (base + 1).clamp(0, 62)) - 1)       # rows > base
    d_hit = torch.where(above != 0, _high_bit(above & -above) - base, _BIG)
    d_i = torch.minimum(d_hit, cfg.height - base)
    first = _min4(torch.where(rows == 0, _BIG, d_i))
    return (first - 1).clamp(min=0)


def _climb_w(w, rows, py):
    """moveUp's climb (TestField.cpp:392-410) from hit words: the posY
    after moving up while possible."""
    base = py[..., None] + _ar(4, w.device)
    maxhit = _high_bit(w & ((1 << base.clamp(0, 62)) - 1))   # rows < base
    u = torch.minimum(base - maxhit, base + 1)
    first = _min4(torch.where(rows == 0, _BIG, u))
    return py - (first - 1).clamp(min=0)


def _climb_to(cfg, bd, rows, px, py):
    return _climb_w(_words(bd, rows, px), rows, py)


def _walk(cfg, bd, rows, px, py, direction):
    """tryLeft/tryRight (TestField.cpp:202-238) for every candidate, each
    with its own direction (-1 or +1): step sideways, climb after each
    step, succeed at posY 0; W + 4 steps.  Returns (px', py', success),
    the pose where the walk stopped."""
    success = torch.zeros_like(px, dtype=torch.bool)
    active = torch.ones_like(success)
    for _ in range(cfg.width + 4):
        px2 = px + direction
        w = _words(bd, rows, px2)
        ok = active & _possible_w(cfg, w, rows, py)
        py2 = _climb_w(w, rows, py)
        px = torch.where(ok, px2, px)
        py = torch.where(ok, py2, py)
        success = success | (ok & (py == 0))
        active = ok & ~success
    return px, py, success


def try_rotate(cfg: EngineConfig, bd, piece, rot, px, py, turns):
    """rcw/rccw/r180 with the kick probes (K.try_rotate) for every
    candidate; ``turns`` an int or (N, M).  Returns (rot', px', py')."""
    new_rot = torch.remainder(rot + turns, 4)
    rows = _rows(piece, new_rot)                            # (N, M, 4)
    kx = torch.tensor([k[0] for k in K.KICKS], device=px.device)
    ky = torch.tensor([k[1] for k in K.KICKS], device=px.device)
    n, m = px.shape
    ok = possible(cfg, bd, rows[:, :, None, :].expand(n, m, 8, 4
                                                        ).reshape(n, -1, 4),
                  (px[..., None] + kx).reshape(n, -1),
                  (py[..., None] + ky).reshape(n, -1)).reshape(n, m, 8)
    found = ok.any(-1)
    k = torch.argmax(ok.to(torch.int8), dim=-1)             # first free kick
    return (torch.where(found, new_rot, rot),
            torch.where(found, px + kx[k], px),
            torch.where(found, py + ky[k], py))


# ---------------------------------------------------------------------------
# The grids
# ---------------------------------------------------------------------------

def _prepare(occ, piece, cur_rot):
    return (u32(occ), piece.to(I64), cur_rot.to(I64))


def grid_coords(cfg: EngineConfig, piece, cur_rot):
    """(eff_rot (N, 4, W), posX (N, 4, W), enum_ok (N, 4, W)): the (rot,
    column) grid, column c at posX c - 1; one-rotation pieces keep
    cur_rot, the others enumerate rotations 0 .. n_sym - 1."""
    dev = piece.device
    n, W = piece.shape[0], cfg.width
    _, n_sym = _tables(dev)
    rots = _ar(4, dev)[None, :, None].expand(n, 4, W)
    xs = (_ar(W, dev) - 1)[None, None, :].expand(n, 4, W)
    ns = n_sym[piece.clamp(0, 6)][:, None, None]
    eff = torch.where(ns == 1, cur_rot[:, None, None], rots)
    return eff, xs, rots < ns


def _top_drop(cfg, bd, piece, cur_rot):
    eff, xs, enum_ok = grid_coords(cfg, piece, cur_rot)
    rows, x = _rows(piece, eff).reshape(bd[0].shape[0], -1, 4), *_flat(xs)
    y0 = torch.zeros_like(x)
    ok = possible(cfg, bd, rows, x, y0).reshape(eff.shape) & enum_ok
    d = drop_distance(cfg, bd, rows, x, y0).reshape(eff.shape)
    return ok, torch.where(ok, d, -1), eff, xs


def top_drop(cfg: EngineConfig, occ, piece, cur_rot):
    """(mask (N, 4, W) bool, rest_y (N, 4, W) int32): the placements that
    fit at the spawn row and the row each rests at (-1 where illegal)."""
    occ, piece, cur_rot = _prepare(occ, piece, cur_rot)
    mask, rest, _, _ = _top_drop(cfg, board(cfg, occ), piece, cur_rot)
    return mask, rest.to(torch.int32)


def _lock_boards(cfg, occ, garb, piece, rot, x, y, keep):
    """Boards after locking each candidate (rot, x, y) of every game and
    clearing lines: (occ' (N, ..., H) int32 bits, cleared (N, ...) int32),
    the board unchanged and 0 where ``keep`` is false."""
    shape = rot.shape
    n, m = shape[0], rot[0].numel()
    H = cfg.height
    rows = _rows(piece, rot).reshape(n * m, 4)
    o = occ[:, None, :].expand(n, m, H).reshape(n * m, H)
    g = u32(garb)[:, None, :].expand(n, m, H).reshape(n * m, H)
    yy = y.reshape(-1)
    o2 = K.add_piece(cfg, o, rows, x.reshape(-1), yy)
    o3, _, n_cl, _ = K.clear_lines(cfg, o2, g, yy)
    k = keep.reshape(-1)
    o3 = torch.where(k[:, None], o3, o)
    n_cl = torch.where(k, n_cl, 0)
    return (to_i32(o3).reshape(shape + (H,)),
            n_cl.to(torch.int32).reshape(shape))


def placement_boards(cfg: EngineConfig, occ, garb, piece, cur_rot):
    """For every top-drop placement, the board after the piece locks and
    lines clear: (mask (N, 4, W), occ_after (N, 4, W, H) int32 bits,
    cleared (N, 4, W))."""
    occ, piece, cur_rot = _prepare(occ, piece, cur_rot)
    mask, rest, eff, xs = _top_drop(cfg, board(cfg, occ), piece,
                                    cur_rot)
    occ_after, cleared = _lock_boards(cfg, occ, garb, piece, eff, xs,
                                      rest.clamp(min=0), mask)
    return mask, occ_after, cleared


# ---------------------------------------------------------------------------
# The finesse replica (TestField.cpp:174-410), batched
# ---------------------------------------------------------------------------

def _wallkick_choice(cfg, bd, piece, rot0, px, py):
    """doWallKick's scan (TestField.cpp:280-316): the first rotation r2 !=
    rot0 that fits at the same pose or at one of the reverse probes.
    Returns (taken, is_same, rows (N, M, 4), r2, dx, dy)."""
    n, m = px.shape
    dev = bd[0].device
    offs = ((0, 0),) + _REV_PROBES
    ox = torch.tensor([o[0] for o in offs], device=dev)
    oy = torch.tensor([o[1] for o in offs], device=dev)
    all_rows = _rows(piece, _ar(4, dev)[None, :].expand(n, 4))   # (N, 4, 4)
    rows = all_rows[:, None, :, None, :].expand(n, m, 4, 8, 4)
    ok = possible(cfg, bd, rows.reshape(n, -1, 4),
                  (px[..., None, None] + ox).expand(n, m, 4, 8
                                                    ).reshape(n, -1),
                  (py[..., None, None] + oy).expand(n, m, 4, 8
                                                    ).reshape(n, -1)
                  ).reshape(n, m, 4, 8)
    taken = torch.zeros_like(px, dtype=torch.bool)
    s_same = torch.zeros_like(taken)
    s_r2 = torch.zeros_like(px)
    s_dx = torch.zeros_like(px)
    s_dy = torch.zeros_like(px)
    for r2 in range(4):
        same_ok = ok[:, :, r2, 0]
        probes = ok[:, :, r2, 1:]
        dfound = probes.any(-1)
        j = torch.argmax(probes.to(torch.int8), dim=-1)     # first probe hit
        ddx = torch.where(dfound, ox[1:][j], 0)
        ddy = torch.where(dfound, oy[1:][j], 0)
        cand = (rot0 != r2) & (same_ok | dfound)
        take = cand & ~taken
        s_same = torch.where(take, same_ok, s_same)
        s_r2 = torch.where(take, r2, s_r2)
        s_dx = torch.where(take, ddx, s_dx)
        s_dy = torch.where(take, ddy, s_dy)
        taken = taken | cand
    s_rows = all_rows.gather(1, s_r2[..., None].expand(n, m, 4))
    return taken, s_same, s_rows, s_r2, s_dx, s_dy


def finesse_possible(cfg: EngineConfig, bd, piece, rot, px, py):
    """finesseIsPossible (TestField.cpp:189-200) of every candidate rest
    pose (N, M): the continuous left-then-right walk, or, for a piece
    locked sideways, reverseWallkick (two doWallKick scans, the second
    after r180KeepPos' flip for S/Z/I).  The walks of both scans and of the
    pose itself run as one batch of 9M walks, then 5M continuations."""
    n, m = px.shape
    rows = _rows(piece, rot)
    h_locked = ~possible(cfg, bd, rows, px - 1, py) & \
        ~possible(cfg, bd, rows, px + 1, py)
    # reverseWallkick's second scan starts from the flipped pose
    rot2 = torch.remainder(rot + 2, 4)
    dx34 = torch.where(rot2 == 0, 1, torch.where(rot2 == 2, -1, 0))
    dy34 = torch.where(rot2 == 1, 1, torch.where(rot2 == 3, -1, 0))
    is2 = (piece == 2)[:, None]
    r0 = torch.cat([rot, rot2], 1)                          # (N, 2M)
    x0 = torch.cat([px, px + torch.where(is2, -dx34, dx34)], 1)
    y0 = torch.cat([py, py + torch.where(is2, -dy34, dy34)], 1)
    taken, same, s_rows, s_r2, s_dx, s_dy = _wallkick_choice(
        cfg, bd, piece, r0, x0, y0)
    dpx, dpy = x0 + s_dx, y0 + s_dy
    fx, fy = try_rotate(cfg, bd, piece, s_r2, dpx, dpy,
                        torch.remainder(r0 - s_r2, 4))[1:]
    valid = (fx == x0) & (fy == y0)      # the round-trip check (:332)
    py1 = _climb_to(cfg, bd, s_rows, x0, y0)                # tryUp, same
    dpy1 = _climb_to(cfg, bd, s_rows, dpx, dpy)             # tryUp, kicked
    # stage 1: every leftward walk and the kicked pose's two single walks
    w_rows = torch.cat([s_rows, s_rows, s_rows, s_rows, rows], 1)
    w_x = torch.cat([x0, dpx, dpx, dpx, px], 1)
    w_y = torch.cat([py1, dpy1, dpy, dpy, py], 1)
    left = torch.full_like(x0, -1)
    w_d = torch.cat([left, left, left, -left, left[:, :m]], 1)
    ex, ey, ok1 = _walk(cfg, bd, w_rows, w_x, w_y, w_d)
    # stage 2: the rightward walks continue from where the left ones stopped
    cont = torch.cat([torch.arange(0, 4 * m, device=px.device),
                      torch.arange(8 * m, 9 * m, device=px.device)])
    _, _, ok2 = _walk(cfg, bd, w_rows[:, cont], ex[:, cont], ey[:, cont],
                      torch.ones_like(ex[:, cont]))
    same_res = (py1 == 0) | ok1[:, :2 * m] | ok2[:, :2 * m]
    up = (dpy1 == 0) | ok1[:, 2 * m:4 * m] | ok2[:, 2 * m:4 * m]
    disp_res = valid & (up | ok1[:, 4 * m:6 * m] | ok1[:, 6 * m:8 * m])
    kick = taken & torch.where(same, same_res, disp_res)
    p = piece[:, None]
    eligible2 = (p == 2) | (p == 3) | (p == 4)
    wk = (p != 6) & (kick[:, :m] | (eligible2 & kick[:, m:]))
    walk = ok1[:, 8 * m:] | ok2[:, 4 * m:]
    return torch.where(h_locked, wk, walk)


def _finesse(cfg, bd, piece, cur_rot, mask_td, rest_td, eff, xs):
    """finesse_rests from a top-drop grid: every free pose at y in
    [top_rest + 2, H - 2] of an enumerated top-drop candidate drops to its
    rest, and the rest is emitted if finesse_possible."""
    n, H = bd[0].shape[0], cfg.height
    _, _, enum_ok = grid_coords(cfg, piece, cur_rot)
    ys = _ar(H, bd[0].device)
    shape = eff.shape + (H,)
    r = eff[..., None].expand(shape)
    x = xs[..., None].expand(shape)
    y = ys.expand(shape)
    rows = _rows(piece, r).reshape(n, -1, 4)
    fr, fx, fy = _flat(r, x, y)
    free = possible(cfg, bd, rows, fx, fy).reshape(shape)
    yr = (fy + drop_distance(cfg, bd, rows, fx, fy)).reshape(shape)
    cand = mask_td[..., None] & free & (y >= rest_td[..., None] + 2) & \
        (y <= H - 2)
    # the rest reached from y0 is yr; rest y is emitted if some candidate
    # y0 drops to it and the pose (r, x, y) passes finesseIsPossible
    reached = (cand[..., :, None] & (yr[..., :, None] == ys)).any(-2)
    fp = finesse_possible(cfg, bd, piece, fr, fx, fy).reshape(shape)
    return reached & fp & (enum_ok & mask_td)[..., None]


def finesse_rests(cfg: EngineConfig, occ, piece, cur_rot):
    """The finesse emission rests of TestField's search: (N, 4, W, H) bool
    indexed [rot, posX + 1, posY]."""
    occ, piece, cur_rot = _prepare(occ, piece, cur_rot)
    bd = board(cfg, occ)
    mask, rest, eff, xs = _top_drop(cfg, bd, piece, cur_rot)
    return _finesse(cfg, bd, piece, cur_rot, mask, rest, eff, xs)


def _legal(cfg, bd, piece, cur_rot):
    mask, rest, eff, xs = _top_drop(cfg, bd, piece, cur_rot)
    td = (_ar(cfg.height, bd[0].device) == rest[..., None]) & mask[..., None]
    return td | _finesse(cfg, bd, piece, cur_rot, mask, rest, eff, xs), \
        eff, xs


def legal_rests(cfg: EngineConfig, occ, piece, cur_rot):
    """The full legal placement set (top-drop rests and finesse rests):
    (N, 4, W, H) bool indexed [rot, posX + 1, posY]; execute a cell with
    the env's step_pose."""
    occ, piece, cur_rot = _prepare(occ, piece, cur_rot)
    return _legal(cfg, board(cfg, occ), piece, cur_rot)[0]


def pose_boards(cfg: EngineConfig, occ, garb, piece, cur_rot):
    """World-model successors over the full legal set: (rest (N, 4, W, H),
    occ_after (N, 4, W, H, H) int32 bits, cleared (N, 4, W, H))."""
    occ, piece, cur_rot = _prepare(occ, piece, cur_rot)
    rest, eff, xs = _legal(cfg, board(cfg, occ), piece, cur_rot)
    shape = rest.shape
    y = _ar(cfg.height, occ.device).expand(shape)
    occ_after, cleared = _lock_boards(
        cfg, occ, garb, piece, eff[..., None].expand(shape),
        xs[..., None].expand(shape), y, rest)
    return rest, occ_after, cleared


# ---------------------------------------------------------------------------
# Reachability by key presses: BFS over the (rot, x, y) grid
# ---------------------------------------------------------------------------

_XOFF, _YOFF = 2, 1      # grid origin: posX = ix - 2, posY = iy - 1


def _bfs_grid(cfg, occ, piece, cur_rot):
    """(bd, ok (N, 4, NX, NY), rotation targets [(flat index, valid)] for
    cw, ccw, flip, enc (4, NX, NY))."""
    occ, piece, _ = _prepare(occ, piece, cur_rot)
    bd = board(cfg, occ)
    dev = occ.device
    n = occ.shape[0]
    NX, NY = cfg.width + 4, cfg.height + 4
    shape = (n, 4, NX, NY)
    r = _ar(4, dev)[None, :, None, None].expand(shape)
    x = (_ar(NX, dev) - _XOFF)[None, None, :, None].expand(shape)
    y = (_ar(NY, dev) - _YOFF)[None, None, None, :].expand(shape)
    fr, fx, fy = _flat(r, x, y)
    ok = possible(cfg, bd, _rows(piece, fr), fx, fy).reshape(shape)
    targets = []
    for turns in (1, 3, 2):
        r2, x2, y2 = try_rotate(cfg, bd, piece, fr, fx, fy, turns)
        ix, iy = x2 + _XOFF, y2 + _YOFF
        valid = (ix >= 0) & (ix < NX) & (iy >= 0) & (iy < NY)
        targets.append(((r2 * NX + ix) * NY + iy, valid))
    enc = _ar(4 * NX * NY, dev).reshape(4, NX, NY)
    return ok, targets, enc


def _seed(ok, start):
    """The spawn pose (rot0, x0, y0) per game, where it is free."""
    n = ok.shape[0]
    r0, x0, y0 = (s.long() for s in start)
    seed = torch.zeros_like(ok)
    seed[torch.arange(n, device=ok.device), r0, x0 + _XOFF, y0 + _YOFF] = True
    return seed & ok


def _scatter_max(values, targets, fill):
    """out[target[s]] = max over s of values[s] (N, S), ``fill`` where no
    valid source lands; sources past the grid are dropped."""
    idx, valid = targets
    n, S = values.shape
    out = torch.full((n, S + 1), fill, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(1, torch.where(valid, idx, S), values, reduce="amax")
    return out[:, :S]


def _rests(cfg, reach, ok):
    below_free = torch.roll(ok, -1, dims=3)
    rest = reach & ~below_free
    return rest[:, :, _XOFF - 1:_XOFF - 1 + cfg.width,
                _YOFF:_YOFF + cfg.height]


def reachable(cfg: EngineConfig, occ, piece, cur_rot, start,
              max_iters: int = 0):
    """The rests (N, 4, W, H) reachable from the spawn pose ``start`` =
    (rot0, x0, y0) (each (N,)) by left, right, down, cw, ccw and flip with
    kicks: BFS as iterated relaxation over the (4, W+4, H+4) grid."""
    ok, targets, _ = _bfs_grid(cfg, occ, piece, cur_rot)
    shape = ok.shape
    reach = _seed(ok, start)
    iters = max_iters or (shape[2] + shape[3] + 8)
    for _ in range(iters):
        new = reach
        for dx, dy in ((-1, 0), (1, 0), (0, 1)):
            new = new | (torch.roll(reach, (dx, dy), dims=(2, 3)) & ok)
        flat = reach.reshape(shape[0], -1).to(torch.uint8)
        for t in targets:
            scat = _scatter_max(flat, t, 0).reshape(shape) != 0
            new = new | (scat & ok)
        reach = new
    return _rests(cfg, reach, ok)


def reachable_paths(cfg: EngineConfig, occ, piece, cur_rot, start,
                    max_iters: int = 0):
    """``reachable`` with parents: (rest (N, 4, W, H), parent (N, S),
    move (N, S)) over the S = 4 (W+4) (H+4) flat states enc = (r (W+4) +
    ix) (H+4) + iy; parent -1 for the spawn pose and unreached states,
    move the key code that enters a state from its parent."""
    ok, targets, enc = _bfs_grid(cfg, occ, piece, cur_rot)
    shape = ok.shape
    n = shape[0]
    enc = enc.expand(shape)
    reach = _seed(ok, start)
    parent = torch.full(shape, -1, dtype=I64, device=ok.device)
    move = torch.full_like(parent, -1)
    iters = max_iters or 2 * (shape[2] + shape[3])
    for _ in range(iters):
        cand_p = torch.full_like(parent, -1)
        cand_m = torch.full_like(parent, -1)
        for dx, dy, key in ((-1, 0, 1), (1, 0, 3), (0, 1, 5)):
            c = torch.roll(reach, (dx, dy), dims=(2, 3)) & ok & ~reach
            src = torch.roll(enc, (dx, dy), dims=(2, 3))
            take = c & (cand_p < 0)
            cand_p = torch.where(take, src, cand_p)
            cand_m = torch.where(take, key, cand_m)
        src = torch.where(reach, enc, -1).reshape(n, -1)
        for t, key in zip(targets, (8, 9, 10)):
            scat = _scatter_max(src, t, -1).reshape(shape)
            take = (scat >= 0) & ok & ~reach & (cand_p < 0)
            cand_p = torch.where(take, scat, cand_p)
            cand_m = torch.where(take, key, cand_m)
        newly = cand_p >= 0
        parent = torch.where(newly, cand_p, parent)
        move = torch.where(newly, cand_m, move)
        reach = reach | newly
    return (_rests(cfg, reach, ok), parent.reshape(n, -1),
            move.reshape(n, -1))


def placement_keys(cfg: EngineConfig, occ, piece, cur_rot, start, rot_abs,
                   col, y):
    """The key macro reaching rest pose (rot_abs, posX = col - 1, posY = y)
    from ``start``: (keys (N, 2 (W+H) + 17) int32, 0-padded and ending in
    hard drop, ok (N,) False where the pose is out of reach), replayable
    through step.step_keys."""
    NX, NY = cfg.width + 4, cfg.height + 4
    L = 2 * (NX + NY)
    _, parent, move = reachable_paths(cfg, occ, piece, cur_rot, start)
    col, y = col.long(), y.long()
    t_enc = (rot_abs.long().clamp(0, 3) * NX + (col - 1) + _XOFF) * NY + \
        y + _YOFF
    in_range = (col - 1 >= -_XOFF) & (col - 1 < cfg.width + 2) & \
        (y >= -_YOFF) & (y < cfg.height + 3)
    t_enc = torch.where(in_range, t_enc, 0)
    r0, x0, y0 = (s.long() for s in start)
    spawn = (r0 * NX + x0 + _XOFF) * NY + y0 + _YOFF
    ok = in_range & ((parent.gather(1, t_enc[:, None])[:, 0] >= 0)
                     | (t_enc == spawn))
    t = torch.where(ok, t_enc, -1)
    mvs = []
    for _ in range(L):
        tc = t.clamp(min=0)[:, None]
        mvs.append(torch.where(t >= 0, move.gather(1, tc)[:, 0], -1))
        t = torch.where(t >= 0, parent.gather(1, tc)[:, 0], -1)
    fwd = torch.stack(mvs[::-1], 1).clamp(min=0)
    keys = torch.cat([fwd, torch.where(ok, _KEY_HARD_DROP, 0)[:, None]], 1)
    return keys.to(torch.int32), ok
