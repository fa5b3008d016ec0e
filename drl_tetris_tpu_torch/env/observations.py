"""Observation builder: engine state -> network inputs.

Counterpart of ``drl_tetris_tpu/env/observations.py`` (the 'separate'
unpacker layout of the reference, state_processors.py:23-54 and
state_unpack.py).  Per player the vector observation is
``[x, y, incoming_lines, combo_time, combo_count, nextpiece(7)]``; the field
is the visual input; the perspective stack for player p is [p, 1-p].

Mirror augmentation of training batches is ``algos/ppo.augment_batch``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from drl_tetris_tpu_torch.engine.core import EngineConfig, EngineState
from drl_tetris_tpu_torch.engine.rng import u32

# L<->J, S<->Z under horizontal reflection (trajectory.py:89); the port's
# own copy, used by the mirror augmentation (algos/ppo.augment_batch).
PIECE_SWAP_NP = np.asarray([1, 0, 3, 2, 4, 5, 6], dtype=np.int32)


class Obs(NamedTuple):
    """Network inputs from one player's perspective ([me, opponent])."""
    vec: torch.Tensor    # (N, 2, 12) float32
    vis: torch.Tensor    # (N, 2, H, W, 1) float32
    piece: torch.Tensor  # (N, 2) int32


def field_grid(cfg: EngineConfig, occ: torch.Tensor) -> torch.Tensor:
    """(..., H) bitboard (int32 bits) -> (..., H, W) float32 binary grid."""
    cols = torch.arange(cfg.width, dtype=torch.int64, device=occ.device)
    return ((u32(occ)[..., None] >> cols) & 1).to(torch.float32)


def _take(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """a[n, p[n]] for (N, P, ...) leaves."""
    idx = p.long().reshape(p.shape + (1,) * (a.ndim - 1))
    idx = idx.expand((a.shape[0], 1) + a.shape[2:])
    return a.gather(1, idx)[:, 0]


def player_vector(cfg: EngineConfig, state: EngineState, p) -> torch.Tensor:
    """(N, 12) scalar observation of player index array p (N,)."""
    ps = state.players
    f32 = torch.float32
    x = (_take(ps.px, p) & 0xFF).to(f32)
    y = (_take(ps.py, p) & 0xFF).to(f32)
    inc = _take(ps.incoming_count, p).to(f32)
    ct = torch.div(torch.clamp(_take(ps.combo_remaining, p) + 50, max=25000),
                   100, rounding_mode="floor").to(f32)
    cc = _take(ps.combo_count, p).to(f32)
    nxt = _take(ps.nextpiece, p)
    nxt1h = (nxt[:, None] == torch.arange(7, device=nxt.device)).to(f32)
    return torch.cat([x[:, None], y[:, None], inc[:, None], ct[:, None],
                      cc[:, None], nxt1h], dim=-1)


def observe(cfg: EngineConfig, state: EngineState, player) -> Obs:
    """The two-perspective observation for ``player`` (N,) int."""
    ps = state.players
    me = player.to(torch.int32)
    order = (me, 1 - me)
    vec = torch.stack([player_vector(cfg, state, o) for o in order], dim=1)
    grids = field_grid(cfg, ps.occ)                       # (N, P, H, W)
    vis = torch.stack([_take(grids, o) for o in order], dim=1)[..., None]
    piece = torch.stack([_take(ps.piece, o) for o in order], dim=1)
    return Obs(vec=vec, vis=vis, piece=piece)
