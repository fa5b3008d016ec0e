# Written after drl_tetris_tpu_torch/engine/masks.py (``top_drop``,
# ``placement_boards``) and drl_tetris_tpu_torch/env/env.py (``step_plain``
# with every game a placement, ``step_place``) at commit
# 19b7261806ffa5740b75ff89fdfc53fa8692c191, part of the benchmark's plain
# reference.  The masks are not a copy: the port tests a candidate against
# a table of hit words per board; here each candidate is tested cell by cell
# with the reference engine's own ``possible`` and ``drop_distance``.
"""The top-drop placement action space in plain PyTorch: for every game the
(rotation, column) grid (4, W), each candidate legal where the acting piece
fits at the spawn row (column c at posX c - 1; a piece with one enumerated
rotation keeps its current rotation and only grid row 0 is legal), the
board after it drops, locks and lines clear, and the env tick that plays a
placement for every game."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference import kernels as K
from benchmark.reference import rng
from benchmark.reference import step as S
from benchmark.reference.core import N_SYM_ROT, EngineConfig, tree_map
from benchmark.reference.env import EnvConfig, EnvState, _reward
from benchmark.reference.observations import observe
from benchmark.reference.rng import to_i32, u32


def _acting(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """a[n, p[n]] of an (N, P, ...) leaf."""
    idx = p.long().reshape((-1,) + (1,) * (a.ndim - 1))
    return a.gather(1, idx.expand((a.shape[0], 1) + a.shape[2:]))[:, 0]


def acting_player(state: EnvState) -> Dict[str, torch.Tensor]:
    """The acting player's occ, garb, piece, rot and next piece."""
    ps, p = state.engine.players, state.current_player
    return {k: _acting(getattr(ps, k), p)
            for k in ("occ", "garb", "piece", "rot", "nextpiece")}


def top_drop_boards(cfg: EngineConfig, occ, garb, piece, cur_rot
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask (N, 4, W) bool, occ_after (N, 4, W, H) int32 bits): the legal
    top-drop placements of (N, H) boards and the board after each; the
    board unchanged where a candidate is illegal."""
    n, H, W = occ.shape[0], cfg.height, cfg.width
    dev = occ.device
    piece = piece.long()
    n_sym = torch.as_tensor(N_SYM_ROT, device=dev).long()[piece.clamp(0, 6)]
    rots = torch.arange(4, device=dev)[None, :, None].expand(n, 4, W)
    cols = torch.arange(W, device=dev)[None, None, :].expand(n, 4, W)
    eff = torch.where(n_sym[:, None, None] == 1, cur_rot.long()[:, None, None],
                      rots)
    m = 4 * W
    o = u32(occ)[:, None, :].expand(n, m, H).reshape(n * m, H)
    g = u32(garb)[:, None, :].expand(n, m, H).reshape(n * m, H)
    rows = K.lookup_rows(piece[:, None].expand(n, m).reshape(-1),
                         eff.reshape(-1))
    px = (cols - 1).reshape(-1).to(torch.int32)
    y0 = torch.zeros_like(px)
    ext = K.ext_board(cfg, o)
    ok = K.possible(cfg, ext, rows, px, y0) & \
        (rots < n_sym[:, None, None]).reshape(-1)
    y = K.drop_distance(cfg, ext, rows, px, y0).to(torch.int32)
    after, _, _, _ = K.clear_lines(cfg, K.add_piece(cfg, o, rows, px, y), g,
                                   y)
    after = torch.where(ok[:, None], after, o)
    return ok.reshape(n, 4, W), to_i32(after).reshape(n, 4, W, H)


def step_place(cfg: EnvConfig, state: EnvState, r_rel, x_target
               ) -> Tuple[EnvState, torch.Tensor, torch.Tensor]:
    """One env tick with the acting player's column-targeted placement
    (r_rel clockwise turns, x_target in posX units), the opponent's null
    action, time advance and auto-reset.  reward and done are the acting
    player's, taken before the reset."""
    player = state.current_player
    use = torch.arange(2, device=player.device)[None, :] == player[:, None]
    r2 = torch.where(use, r_rel.to(torch.int32)[:, None], 0)
    x2 = torch.where(use, x_target.to(torch.int32)[:, None], 0)
    eng = S.step_place(cfg.engine, state.engine, use, r2, x2,
                       cfg.time_elapsed_each_action)
    done = eng.round_over
    reward = _reward(cfg, eng, player, done)
    both = rng.split2(rng.u32(state.key))
    key, reset_keys = both[:, 0], both[:, 1]
    eng_reset = S.reset(cfg.engine, eng, reset_keys)
    eng = tree_map(lambda a, b: S._sel(done, b, a), eng, eng_reset)
    return EnvState(engine=eng, current_player=1 - player,
                    key=rng.to_i32(key),
                    rounds_played=state.rounds_played + done.to(torch.int32)
                    ), reward, done


def perspective_occ(state: EnvState) -> torch.Tensor:
    """(N, 2, H) boards ordered [acting player, opponent]."""
    occ = state.engine.players.occ
    p = state.current_player
    idx = torch.stack([p, 1 - p], dim=1).long()
    return occ.gather(1, idx[:, :, None].expand(-1, -1, occ.shape[2]))


def replay_place(cfg: EnvConfig, state: EnvState, r_rel, x_target):
    """Step ``state`` through (T, N) placements.  Returns (end state, the
    state each tick acted on, the ticks' views stacked (T, N, ...): occ,
    vec, piece, reward and done)."""
    states: List[EnvState] = []
    views = []
    for r, x in zip(r_rel, x_target):
        obs = observe(cfg.engine, state.engine, state.current_player)
        view = {"occ": perspective_occ(state), "vec": obs.vec,
                "piece": obs.piece[:, 0]}
        states.append(state)
        state, view["reward"], view["done"] = step_place(cfg, state, r, x)
        views.append(view)
    return state, states, {k: torch.stack([v[k] for v in views])
                           for k in views[0]}
