# Frozen copy of drl_tetris_tpu_torch/engine/kernels.py at commit
# 0522b5deacbf29e64a07f002c2407ff1530df4d8, part of the
# benchmark's plain reference; only the imports are rewritten.
"""Bitboard primitives, batched over games: collision, movement, rotation
kicks, line clear, garbage rows.

Counterpart of ``drl_tetris_tpu/engine/kernels.py`` (semantics references
there: gameField.cpp / gamePlay.cpp).  One player view per call: boards
``(N, H)`` int64 holding uint32 rows (``u32``), piece rows ``(N, 4)``,
positions ``(N,)`` int32.  Shifts follow XLA's uint32 semantics: a shift by
an amount outside [0, 31] (including a negative amount cast to uint32)
gives 0.
"""
from __future__ import annotations

import torch

from benchmark.reference.core import EngineConfig, ROW_MASKS
from benchmark.reference import shifts
from benchmark.reference.rng import M32, u32

_BIG = 1 << 20
_TABLES = {}


def _row_masks(device) -> torch.Tensor:
    t = _TABLES.get(device)
    if t is None:
        t = torch.as_tensor(ROW_MASKS.astype("int64"), device=device)
        _TABLES[device] = t
    return t


def shl32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    s = s.to(torch.int64)
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, (x << s.clamp(0, 31)) & M32, 0)


def shr32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    s = s.to(torch.int64)
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, x >> s.clamp(0, 31), 0)


def ext_board(cfg: EngineConfig, occ: torch.Tensor) -> torch.Tensor:
    """Extended rows: playfield shifted left 4 bits, walls solid (bits 0..3
    and >= width + 4, so bit 31 is set)."""
    return ((occ << 4) & M32) | cfg.wall_mask


def lookup_rows(piece: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """(N, 4) row masks of (piece, rot); zeros for ids out of range, as the
    JAX select chain gives."""
    ok = (piece >= 0) & (piece < 7) & (rot >= 0) & (rot < 4)
    t = _row_masks(piece.device)
    rows = t[piece.long().clamp(0, 6), rot.long().clamp(0, 3)]
    return torch.where(ok[:, None], rows, 0)


def lookup_rows_all(piece: torch.Tensor) -> torch.Tensor:
    """(N, 4, 4) row masks of every rotation of ``piece`` (rotation,
    row); zeros for ids out of range."""
    ok = (piece >= 0) & (piece < 7)
    rows = _row_masks(piece.device)[piece.long().clamp(0, 6)]
    return torch.where(ok[:, None, None], rows, 0)


def select_rot(all_rows: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """(N, 4) row masks of rotation ``rot`` out of a lookup_rows_all
    table; rotation 0's for ids outside [1, 3], as JAX's select chain."""
    r = torch.where((rot >= 1) & (rot <= 3), rot, 0).long()
    return all_rows.gather(1, r[:, None, None].expand(-1, 1, 4))[:, 0]


def _piece_column(cfg: EngineConfig, rows4, py):
    """Paint the 4 piece rows into an (N, H) column at rows py..py+3, plus
    a flag for occupied rows outside [0, H-1]."""
    H = cfg.height
    ys = torch.arange(H, dtype=torch.int32, device=rows4.device)
    col = torch.zeros(rows4.shape[0], H, dtype=torch.int64,
                      device=rows4.device)
    oob = torch.zeros(rows4.shape[0], dtype=torch.bool, device=rows4.device)
    for i in range(4):
        yi = py + i
        col = col | torch.where(ys[None, :] == yi[:, None],
                                rows4[:, i, None], 0)
        oob = oob | ((rows4[:, i] != 0) & ((yi < 0) | (yi > H - 1)))
    return col, oob


def _hits(ext, col, shift):
    return ((ext & shl32(col, shift[:, None])) != 0).any(-1)


def possible(cfg: EngineConfig, ext, rows4, px, py) -> torch.Tensor:
    """BasicField::possible."""
    col, oob = _piece_column(cfg, rows4, py)
    return ~oob & ~_hits(ext, col, px + 4)


def drop_distance(cfg: EngineConfig, ext, rows4, px, py) -> torch.Tensor:
    """Rows the piece can fall from (px, py) before the first collision."""
    H = cfg.height
    ys = torch.arange(H, dtype=torch.int32, device=ext.device)[None, :]
    first = torch.full_like(px, _BIG)
    for i in range(4):
        sh = shl32(rows4[:, i], px + 4)
        hit = (ext & sh[:, None]) != 0
        base = (py + i)[:, None]
        d_hit = torch.where(hit & (ys >= base + 1), ys - base,
                            _BIG).amin(-1).to(torch.int32)
        d_i = torch.minimum(d_hit, H - (py + i))
        first = torch.minimum(first, torch.where(rows4[:, i] == 0, _BIG, d_i))
    return torch.clamp(first - 1, min=0)


def slide_distance(cfg: EngineConfig, ext, rows4, px, py,
                   direction: int) -> torch.Tensor:
    """Single steps left (-1) or right (+1) before the first obstruction."""
    col, _ = _piece_column(cfg, rows4, py)
    first = torch.full_like(px, _BIG)
    for s in range(1, cfg.width + 4):
        shift = px + 4 + direction * s
        bad = (shift < 0) | (shift > 27)
        coll = bad | _hits(ext, col, shift.clamp(0, 27))
        first = torch.minimum(first, torch.where(coll, s, _BIG))
    return first - 1


def try_move(cfg: EngineConfig, ext, rows4, px, py, dx: int, dy: int):
    """mLeft/mRight/mDown: (moved?, px', py')."""
    nx, ny = px + dx, py + dy
    ok = possible(cfg, ext, rows4, nx, ny)
    return ok, torch.where(ok, nx, px), torch.where(ok, ny, py)


# Rotation kick candidates in probe order (gameField.cpp:55-65, 93-103).
KICKS = ((0, 0), (0, 1), (-1, 0), (1, 0), (-1, 1), (1, 1), (-2, 0), (2, 0))


def try_rotate(cfg: EngineConfig, ext, piece, rot, px, py, turns: int,
               cur_rows):
    """rcw/rccw/r180 with the kick probes: (rotated?, rot', px', py',
    rows')."""
    new_rot = torch.remainder(rot + turns, 4)
    new_rows = lookup_rows(piece, new_rot)
    cols = [_piece_column(cfg, new_rows, py),
            _piece_column(cfg, new_rows, py + 1)]
    found = torch.zeros_like(px, dtype=torch.bool)
    bx, by = px, py
    for dx, dy in KICKS:
        col, oob = cols[dy]
        ok = ~oob & ~_hits(ext, col, px + dx + 4)
        take = ok & ~found
        bx = torch.where(take, px + dx, bx)
        by = torch.where(take, py + dy, by)
        found = found | ok
    return (found,
            torch.where(found, new_rot, rot),
            torch.where(found, bx, px),
            torch.where(found, by, py),
            torch.where(found[:, None], new_rows, cur_rows))


def add_piece(cfg: EngineConfig, occ, rows4, px, py) -> torch.Tensor:
    """BasicField::addPiece: OR the piece rows into the board."""
    col, _ = _piece_column(cfg, rows4, py)
    pxc = px[:, None]
    sh = torch.where(pxc >= 0, shl32(col, pxc), shr32(col, -pxc))
    return occ | sh


def clear_lines(cfg: EngineConfig, occ, garb, py):
    """BasicField::clearlines over the scan window [py, py+H-1]: returns
    (occ', garb', n_cleared, n_garbage_rows).  Kept rows fall by the number
    of full rows below them (at most 4)."""
    H = cfg.height
    rs = torch.arange(H, dtype=torch.int32, device=occ.device)[None, :]
    in_scan = (rs >= py[:, None]) & (rs <= py[:, None] + H - 1)
    full = (occ == cfg.full_row) & in_scan
    n_cleared = full.sum(-1).to(torch.int32)
    n_garb = (full & (garb != 0)).sum(-1).to(torch.int32)
    fi = full.to(torch.int32)
    full_below = shifts.suffix_sum(fi) - fi
    occ2 = torch.zeros_like(occ)
    garb2 = torch.zeros_like(garb)
    for k in range(5):
        m = ~full & (full_below == k)
        occ2 = occ2 | shifts.shift_down(torch.where(m, occ, 0), k)
        garb2 = garb2 | shifts.shift_down(torch.where(m, garb, 0), k)
    return occ2, garb2, n_cleared, n_garb


def add_garbage_line(cfg: EngineConfig, occ, garb, hole):
    """Shift the field up one row; the new bottom row is garbage with one
    hole at column ``hole``."""
    row = cfg.full_row & ~shl32(torch.ones_like(hole, dtype=torch.int64),
                                hole) & M32
    occ2 = torch.cat([occ[:, 1:], row[:, None]], dim=-1)
    garb2 = torch.cat([garb[:, 1:], row[:, None]], dim=-1)
    return occ2, garb2


__all__ = ["u32", "shl32", "shr32", "ext_board", "lookup_rows",
           "lookup_rows_all", "select_rot", "possible",
           "drop_distance", "slide_distance", "try_move", "try_rotate",
           "add_piece", "clear_lines", "add_garbage_line", "KICKS"]
