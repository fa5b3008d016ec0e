# Frozen copy of drl_tetris_tpu_torch/engine/pieces.py at commit
# 0522b5deacbf29e64a07f002c2407ff1530df4d8, part of the
# benchmark's plain reference; only the imports are rewritten.
"""Piece shape tables for the PyTorch/CUDA Tetris engine.

This is the port's own copy of ``drl_tetris_tpu/engine/pieces.py`` (the
port imports nothing of the JAX package); a test holds the two equal.

The reference engine stores each piece as a mutable 4x4 grid that is rotated
in place (reference: environment/game_backend/source/gamePlay.cpp:124-158
``initBasePieces``/``setPieceOrientation``, pieces.cpp:5-52 ``rcw``/``rccw``).
The rotation group is cyclic of order 4, so every (piece, absolute_rotation)
pair maps to a fixed 4x4 occupancy pattern.  The patterns are precomputed
once on the host (numpy) by replaying the exact reference construction; the
plain engine indexes them as tensors and the CUDA kernel reads them from a
device table (engine/cuda_tick.py).

Table layout (all numpy):

  ROW_MASKS[piece, rot, row]  uint32  -- 4-bit mask of occupied cells in that
                                         grid row (bit x == grid column x)
  SPAWN_ROT[piece]            int32   -- ``rotation`` field: the absolute
                                         rotation a freshly spawned piece has
                                         (gamePlay.cpp:117 ``piecerotation``)
  TILE[piece]                 int32   -- tile value written into the board
                                         (piece + 1, gamePlay.cpp:146)
  N_SYM_ROT[piece]            int32   -- number of distinct rotations the mask
                                         generator enumerates (TestField.cpp:
                                         71-108: O->1, I/S/Z->2, else 4)

Internal piece ids (decoded from the grids in gamePlay.cpp:125-137):
  0 = J (tile 4)   1 = L (tile 3)   2 = S (tile 5)   3 = Z (tile 7)
  4 = I (tile 2)   5 = T (tile 1)   6 = O (tile 6)
Pieces 4 (I) and 6 (O) rotate in the full 4x4 box ("lpiece",
gamePlay.cpp:154-155); the rest rotate in the upper-left 3x3 box.

The observation layer re-codes pieces via the tile value
(environment/env_utils/state_processors.py:24 ``col_code``); see
env/observations.py.
"""
from __future__ import annotations

import numpy as np

N_PIECES = 7
N_ROT = 4

# Raw spawn-grid values, row-major (y, x), exactly as laid out in
# gamePlay.cpp:125-137.  Nonzero value == tile id of the piece.
_RAW = {
    0: [0, 4, 0, 0,
        0, 4, 0, 0,
        0, 4, 4, 0,
        0, 0, 0, 0],
    1: [0, 3, 0, 0,
        0, 3, 0, 0,
        3, 3, 0, 0,
        0, 0, 0, 0],
    2: [0, 5, 0, 0,
        0, 5, 5, 0,
        0, 0, 5, 0,
        0, 0, 0, 0],
    3: [0, 7, 0, 0,
        7, 7, 0, 0,
        7, 0, 0, 0,
        0, 0, 0, 0],
    4: [0, 2, 0, 0,
        0, 2, 0, 0,
        0, 2, 0, 0,
        0, 2, 0, 0],
    5: [0, 0, 0, 0,
        1, 1, 1, 0,
        0, 1, 0, 0,
        0, 0, 0, 0],
    6: [0, 0, 0, 0,
        0, 6, 6, 0,
        0, 6, 6, 0,
        0, 0, 0, 0],
}

# gamePlay.cpp:117 piecerotation = {3, 1, 3, 1, 1, 2, 0}
SPAWN_ROT = np.array([3, 1, 3, 1, 1, 2, 0], dtype=np.int32)
# gamePlay.cpp:154-155: I and O rotate in the 4x4 box.
LPIECE = np.array([0, 0, 0, 0, 1, 0, 1], dtype=np.int32)
TILE = np.arange(1, 8, dtype=np.int32)  # gamePlay.cpp:146 tile = p + 1
# TestField.cpp:71-108 symmetry-aware rotation counts.
N_SYM_ROT = np.array([4, 4, 2, 2, 2, 4, 1], dtype=np.int32)


def _rcw(grid: np.ndarray, lpiece: bool) -> np.ndarray:
    """Clockwise rotation, replicating pieces.cpp:5-28 exactly."""
    out = grid.copy()
    n = 4 if lpiece else 3
    # pieces.cpp: grid[x][3-y] = tmp[y][x]  (4x4)  /  grid[x][2-y] = tmp[y][x]
    for x in range(n):
        for y in range(n):
            out[x][n - 1 - y] = grid[y][x]
    return out


def _build_tables():
    """Replay initBasePieces + setPieceOrientation to get each piece's grid at
    every absolute rotation value (``current_rotation``)."""
    row_masks = np.zeros((N_PIECES, N_ROT, 4), dtype=np.uint32)
    grids = np.zeros((N_PIECES, N_ROT, 4, 4), dtype=np.uint8)
    for p in range(N_PIECES):
        grid = np.array(_RAW[p], dtype=np.uint8).reshape(4, 4)
        cur = 0
        # setPieceOrientation (gamePlay.cpp:116-122): rotate cw until
        # current_rotation == piecerotation[p].  That defines the grid at
        # rotation value SPAWN_ROT[p]; keep rotating to fill all 4 entries.
        by_rot = {}
        for _ in range(N_ROT + 4):
            if cur not in by_rot:
                by_rot[cur] = grid.copy()
            if len(by_rot) == N_ROT:
                break
            grid = _rcw(grid, bool(LPIECE[p]))
            cur = (cur + 1) % 4
        for r in range(N_ROT):
            g = by_rot[r]
            grids[p, r] = g
            for y in range(4):
                m = 0
                for x in range(4):
                    if g[y][x]:
                        m |= 1 << x
                row_masks[p, r, y] = m
    return row_masks, grids


ROW_MASKS, GRIDS = _build_tables()

# Sanity: every piece/rotation has exactly 4 cells.
assert (np.vectorize(lambda m: bin(int(m)).count("1"))(ROW_MASKS).sum(-1) == 4).all()
