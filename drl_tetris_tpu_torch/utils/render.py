"""Board rendering.

Counterpart of ``drl_tetris_tpu/utils/render.py`` (reference: the pygame
singleton of environment/env_utils/draw_tetris.py:8-143, a grid of fields
with auto-rescaling and a colour theme).  Headless first: the renderer
emits ANSI terminal frames (the same grid-of-fields layout, an xterm-256
theme); the pygame window (utils/render_pygame.py) opens only when the
caller asks for it.  The frames are built on the host from the engine
state's tensors, whatever device they are on.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from drl_tetris_tpu_torch.engine.core import GRIDS, EngineConfig, EngineState

# Default colour theme, one entry per tile value 1..8 (presets.py:164-174's
# hex theme, mapped to xterm-256 approximations).
_TILE_COLORS = [129, 208, 93, 199, 201, 202, 57, 240]
_RESET = "\x1b[0m"


def progress_bar(current, total, length: int = 30, start: str = "[",
                 stop: str = "]", done: str = "|", remaining: str = "-"
                 ) -> str:
    """The reference's textual bar (tools/utils.py:103-107), used by the
    eval-time NN entropy visualization (scripts/eval.py:17-28)."""
    progress = 0.0 if total <= 0 else min(max(current / total, 0.0), 1.0)
    done_ticks = round(progress * length)
    return start + done * done_ticks + remaining * (length - done_ticks) + stop


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def field_arrays(cfg: EngineConfig, state: EngineState,
                 with_piece: bool = True) -> np.ndarray:
    """(N, P, H, W) uint8 tile arrays of a batched engine state (or one
    game's, without the N axis): 1 for stack cells, 8 for garbage cells,
    the piece's tile for the falling piece."""
    ps = state.players
    occ, garb = _host(ps.occ).view(np.uint32), _host(ps.garb).view(np.uint32)
    piece, rot = _host(ps.piece), _host(ps.rot)
    px, py = _host(ps.px), _host(ps.py)
    if occ.ndim == 2:                                  # one game
        occ, garb = occ[None], garb[None]
        piece, rot, px, py = piece[None], rot[None], px[None], py[None]
    N, P = occ.shape[:2]
    H, W = cfg.height, cfg.width
    bits = (occ[..., None] >> np.arange(W, dtype=np.uint32)) & 1
    gbits = (garb[..., None] >> np.arange(W, dtype=np.uint32)) & 1
    out = bits.astype(np.uint8)
    out[gbits.astype(bool)] = 8
    if with_piece:
        for n in range(N):
            for p in range(P):
                g = GRIDS[piece[n, p], rot[n, p]]
                for yy in range(4):
                    for xx in range(4):
                        if g[yy, xx]:
                            y, x = py[n, p] + yy, px[n, p] + xx
                            if 0 <= y < H and 0 <= x < W:
                                out[n, p, y, x] = piece[n, p] + 1
    return out


def ansi_field(field: np.ndarray) -> List[str]:
    """One field -> its text rows in coloured half-blocks."""
    H, W = field.shape
    rows = []
    for y in range(H):
        row = "|"
        for x in range(W):
            v = int(field[y, x])
            if v == 0:
                row += "  "
            else:
                c = _TILE_COLORS[min(v, 8) - 1]
                row += f"\x1b[48;5;{c}m  {_RESET}"
        rows.append(row + "|")
    rows.append("+" + "--" * W + "+")
    return rows


def render_ansi(cfg: EngineConfig, state: EngineState, max_games: int = 4,
                titles: Optional[Sequence[str]] = None) -> str:
    """Grid layout like drawAllFields (draw_tetris.py:103-143): one row per
    game, the players side by side."""
    fields = field_arrays(cfg, state)
    N = min(fields.shape[0], max_games)
    blocks = []
    for n in range(N):
        cols = [ansi_field(fields[n, p]) for p in range(fields.shape[1])]
        header = ""
        if titles:
            header = "   ".join(t.ljust(2 * cfg.width + 2)
                                for t in titles) + "\n"
        rows = ["   ".join(col[i] for col in cols)
                for i in range(len(cols[0]))]
        blocks.append(header + "\n".join(rows))
    return "\n\n".join(blocks)


def get_pygame_renderer(*args, **kwargs):
    """The pygame window (the reference's draw_tetris singleton).  Raises
    when pygame is not installed: the caller asked for the window."""
    try:
        import pygame  # noqa: F401
    except ImportError as e:
        raise RuntimeError("the pygame window needs the pygame package, "
                           "which is not installed here; the ANSI frames "
                           "need nothing") from e
    from drl_tetris_tpu_torch.utils import render_pygame
    return render_pygame.Renderer(*args, **kwargs)
