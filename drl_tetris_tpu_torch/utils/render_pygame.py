"""The pygame window renderer.

Counterpart of ``drl_tetris_tpu/utils/render_pygame.py`` (reference:
draw_tetris.py): the grid-of-fields layout with auto-rescaling
(draw_tetris.py:103-143) and the hex colour theme (presets.py:164-174),
pausing on a key press.  ``pygame`` is imported when a window is made,
never with this module; the ANSI frames of utils/render.py are the
default and need nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

_DEFAULT_THEME = [
    "171717", "d900ff", "ff9400", "9b00ff", "ff00a4",
    "ff00ed", "ff5c00", "7900ff", "400080",
]


def _hex_rgb(h: str) -> Tuple[int, int, int]:
    return tuple(int(h[i:i + 2], 16) for i in (0, 2, 4))


class Renderer:
    def __init__(self, resolution=(1280, 720), color_theme: Optional[Sequence[str]] = None):
        import pygame
        self.pygame = pygame
        pygame.init()
        self.screen = pygame.display.set_mode(resolution)
        pygame.display.set_caption("drl-tetris-tpu (PyTorch port)")
        theme = list(color_theme or _DEFAULT_THEME)
        self.colors = [_hex_rgb(c) for c in theme]

    def draw_all_fields(self, fields: np.ndarray, pause_on_event: bool = False):
        """fields: (n_rows, n_cols, H, W) uint8 tile arrays."""
        pg = self.pygame
        self.screen.fill((10, 10, 10))
        n_rows, n_cols, H, W = fields.shape
        sw, sh = self.screen.get_size()
        cell = max(2, min((sw - 20) // (n_cols * (W + 1)),
                          (sh - 20) // (n_rows * (H + 1))))
        for r in range(n_rows):
            for c in range(n_cols):
                ox = 10 + c * (W + 1) * cell
                oy = 10 + r * (H + 1) * cell
                pg.draw.rect(self.screen, (60, 60, 60),
                             (ox - 1, oy - 1, W * cell + 2, H * cell + 2), 1)
                f = fields[r, c]
                for y in range(H):
                    for x in range(W):
                        v = int(f[y, x])
                        if v:
                            col = self.colors[min(v, len(self.colors) - 1)]
                            pg.draw.rect(self.screen, col,
                                         (ox + x * cell, oy + y * cell,
                                          cell - 1, cell - 1))
        pg.display.flip()
        for event in pg.event.get():
            if event.type == pg.QUIT:
                raise KeyboardInterrupt
            if pause_on_event and event.type == pg.KEYDOWN:
                self._pause()

    def close(self):
        """Close the window and shut pygame down."""
        self.pygame.quit()

    def _pause(self):
        pg = self.pygame
        while True:
            event = pg.event.wait()
            if event.type in (pg.KEYDOWN, pg.QUIT):
                return
