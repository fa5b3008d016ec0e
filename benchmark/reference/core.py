# Frozen copy of drl_tetris_tpu_torch/engine/core.py at commit
# 0522b5deacbf29e64a07f002c2407ff1530df4d8, part of the
# benchmark's plain reference; only the imports are rewritten.
"""Engine configuration and batched game state as dataclasses of tensors.

Counterpart of ``drl_tetris_tpu/engine/core.py``.  The JAX package keeps one
game per pytree and vmaps; here every leaf carries the game batch first:
player leaves are ``(N, P, ...)``, engine scalars ``(N,)``.

Boards are bitboards, one 32-bit word per row with bit x == column x.  The
JAX package stores them as uint32; PyTorch's uint32 support is thin (shifts,
comparisons), so the port stores every uint32 leaf (``occ``, ``garb``,
``cur_rows``, ``piece_key``, ``hole_key`` and the env ``key``) as int32
holding the same bit pattern.  The plain engine widens them to int64 masked
to 32 bits before any shift or comparison (engine/kernels.py ``u32``), so an
arithmetic right shift never sees bit 31; the CUDA kernel reads the same
words as ``uint32_t``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from benchmark.reference import pieces as P


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration (same fields and defaults as the JAX
    package's EngineConfig, drl_tetris_tpu/engine/core.py:33-83)."""
    height: int = 22
    width: int = 10
    n_players: int = 2
    piece_map: Tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6)
    garbage_cap: int = 32
    garbage_initial_delay: int = 1000
    garbage_add_delay: int = 450
    garbage_freeze_delay: int = 450
    combo_line_mult: int = 1000
    combo_static_mult: int = 800
    lockdown_ms: int = 400
    max_seed_rerolls: int = 12

    def __post_init__(self):
        if not 4 <= self.width <= 25:
            raise ValueError("bitboard layout supports width 4..25")
        if self.height < 4 or self.n_players < 1 or len(self.piece_map) != 7:
            raise ValueError(f"invalid engine config {self}")

    @property
    def only_zs(self) -> bool:
        return all(v in (2, 3) for v in self.piece_map)

    @property
    def full_row(self) -> int:
        return (1 << self.width) - 1

    @property
    def wall_mask(self) -> int:
        """Bits outside the playfield in the 4-bit-left-shifted 'extended'
        row: bits 0..3 (left wall) and >= width+4 (right wall)."""
        return 0xF | ((0xFFFFFFFF << (self.width + 4)) & 0xFFFFFFFF)


# getPiece's initial bag weights: 1000/7 in INTEGER division (142.0).
COGP_INIT = float(1000 // 7)

# Leaves that hold uint32 bit patterns in int32 tensors.
U32_FIELDS = ("occ", "garb", "cur_rows", "piece_key", "hole_key", "key")


class _Tree:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class PlayerState(_Tree):
    """Per-player state.  In an EngineState every field is ``(N, P, ...)``;
    inside the plain tick a "player view" of the same class drops the P
    axis (``(N, ...)``).  Field order is the leaf order the CUDA kernel
    reads (csrc/engine_tick.cu ``enum Leaf``)."""
    occ: torch.Tensor               # (N, P, H) int32 (uint32 bits)
    garb: torch.Tensor              # (N, P, H) int32 (uint32 bits)
    piece: torch.Tensor             # (N, P) int32
    rot: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    cur_rows: torch.Tensor          # (N, P, 4) int32 (uint32 bits)
    nextpiece: torch.Tensor
    time_ms: torch.Tensor
    drop_delay: torch.Tensor
    drop_delay_time: torch.Tensor
    incr_dd_time: torch.Tensor
    lockdown: torch.Tensor          # (N, P) bool
    lockdown_time: torch.Tensor
    combo_start: torch.Tensor
    combo_time: torch.Tensor
    combo_count: torch.Tensor
    combo_line_count: torch.Tensor
    combo_remaining: torch.Tensor
    g_count: torch.Tensor           # (N, P, CAP) int32
    g_delay: torch.Tensor           # (N, P, CAP) int32
    g_size: torch.Tensor
    g_min_remaining: torch.Tensor
    incoming_lines: torch.Tensor    # (N, P) float32
    incoming_count: torch.Tensor
    lines_sent: torch.Tensor
    lines_recv: torch.Tensor
    garbage_cleared: torch.Tensor
    lines_cleared: torch.Tensor
    lines_blocked: torch.Tensor
    max_combo: torch.Tensor
    lines_cleared_snap: torch.Tensor
    reward: torch.Tensor
    dead: torch.Tensor              # (N, P) bool
    cogp: torch.Tensor              # (N, P, 7) float32
    lasthole: torch.Tensor
    piece_key: torch.Tensor         # (N, P, 2) int32 (uint32 bits)
    hole_key: torch.Tensor          # (N, P, 2) int32 (uint32 bits)
    piece_draws: torch.Tensor
    hole_draws: torch.Tensor


@dataclasses.dataclass
class EngineState(_Tree):
    players: PlayerState
    round_over: torch.Tensor        # (N,) bool
    last_winner: torch.Tensor       # (N,) int32, -1 = none / draw


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over dataclass trees of tensors."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree, prefix: str = ""):
    """[(dotted name, tensor)] in field order."""
    if dataclasses.is_dataclass(tree):
        out = []
        for f in dataclasses.fields(tree):
            out += tree_leaves(getattr(tree, f.name), prefix + f.name + ".")
        return out
    return [(prefix[:-1], tree)]


def zeros_player_state(cfg: EngineConfig, n_games: int,
                       device="cpu") -> PlayerState:
    """The JAX package's zeros_player_state, batched over ``n_games``."""
    N, Pn, H, CAP = n_games, cfg.n_players, cfg.height, cfg.garbage_cap

    def full(shape, value, dtype=torch.int32):
        return torch.full((N, Pn) + shape, value, dtype=dtype, device=device)

    z = lambda *s: full(s, 0)
    return PlayerState(
        occ=z(H), garb=z(H),
        piece=z(), rot=z(), px=z(), py=z(), cur_rows=z(4), nextpiece=z(),
        time_ms=z(), drop_delay=full((), 1000), drop_delay_time=z(),
        incr_dd_time=z(), lockdown=full((), False, torch.bool),
        lockdown_time=z(),
        combo_start=z(), combo_time=z(), combo_count=z(),
        combo_line_count=z(), combo_remaining=z(),
        g_count=z(CAP), g_delay=z(CAP), g_size=z(),
        g_min_remaining=full((), cfg.garbage_initial_delay),
        incoming_lines=full((), 0.0, torch.float32), incoming_count=z(),
        lines_sent=z(), lines_recv=z(), garbage_cleared=z(),
        lines_cleared=z(), lines_blocked=z(), max_combo=z(),
        lines_cleared_snap=z(), reward=z(),
        dead=full((), False, torch.bool),
        cogp=full((7,), COGP_INIT, torch.float32),
        lasthole=full((), 20),
        piece_key=z(2), hole_key=z(2),
        piece_draws=z(), hole_draws=z(),
    )


ROW_MASKS = P.ROW_MASKS        # (7, 4, 4) uint32
SPAWN_ROT = P.SPAWN_ROT        # (7,) int32
N_SYM_ROT = P.N_SYM_ROT        # (7,) int32
TILE = P.TILE                  # (7,) int32
GRIDS = P.GRIDS                # (7, 4, 4, 4) uint8
