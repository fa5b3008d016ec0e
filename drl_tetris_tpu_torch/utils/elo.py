"""Elo ratings for evaluation tournaments and training-time leagues.

The port's copy of ``drl_tetris_tpu/utils/elo.py``.

The reference only ships a raw win/loss cross-table (tools/scoreboard.py:45-63)
and its README asks the reader to eyeball progress from eval matches.  For the
10M-step reference-parity learning benchmark we need a scalar skill curve, so
this module adds two standard estimators on top of the Scoreboard:

  * ``EloTracker`` — incremental (online) Elo with the usual logistic
    expectation and K-factor update; order-dependent, cheap, good for
    streaming match results during training.
  * ``fit_elo`` — order-independent maximum-likelihood fit of a
    Bradley-Terry model to a finished cross-table via the classic MM
    (minorization-maximization) iteration, reported on the Elo scale.
    This is what the ``eval`` CLI prints and what league snapshots use.

Draws are counted as half a win for each side (the standard convention).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional

from drl_tetris_tpu_torch.utils.scoreboard import Scoreboard

ELO_SCALE = 400.0 / math.log(10.0)   # rating points per nat


class EloTracker:
    """Online Elo: rating updates after every match result."""

    def __init__(self, k_factor: float = 24.0, initial: float = 1000.0):
        self.k = k_factor
        self.initial = initial
        self.ratings: Dict[str, float] = {}
        self.n_games: Dict[str, int] = {}

    def rating(self, name: str) -> float:
        return self.ratings.get(name, self.initial)

    def expected(self, a: str, b: str) -> float:
        return 1.0 / (1.0 + 10.0 ** ((self.rating(b) - self.rating(a)) / 400.0))

    def _bump(self, name: str, delta: float):
        self.ratings[name] = self.rating(name) + delta
        self.n_games[name] = self.n_games.get(name, 0) + 1

    def record(self, winner: str, loser: str):
        e = self.expected(winner, loser)
        self._bump(winner, self.k * (1.0 - e))
        self._bump(loser, -self.k * (1.0 - e))

    def record_draw(self, a: str, b: str):
        e = self.expected(a, b)
        self._bump(a, self.k * (0.5 - e))
        self._bump(b, -self.k * (0.5 - e))

    def record_scoreboard(self, board: Scoreboard):
        """Feed a finished cross-table through the online update (pairwise
        results are replayed in table order)."""
        for a in board.players:
            for b in board.players:
                if a >= b:
                    continue
                wins_a = board.wins[(a, b)]
                wins_b = board.wins[(b, a)]
                draws = board.games[(a, b)] - wins_a - wins_b
                for _ in range(wins_a):
                    self.record(a, b)
                for _ in range(wins_b):
                    self.record(b, a)
                for _ in range(draws):
                    self.record_draw(a, b)

    def table(self) -> str:
        rows = sorted(self.ratings.items(), key=lambda kv: -kv[1])
        width = max([7] + [len(n) for n, _ in rows]) + 2
        out = ["ELO".rjust(width + 7)]
        for name, r in rows:
            out.append(name.ljust(width) + f"{r:7.1f}"
                       + f"  ({self.n_games.get(name, 0)} games)")
        return "\n".join(out)


def fit_elo(board: Scoreboard, n_iters: int = 200, tol: float = 1e-9,
            mean_rating: float = 1000.0,
            regularize: float = 0.1) -> Dict[str, float]:
    """Bradley-Terry MLE from a win/loss cross-table, on the Elo scale.

    MM iteration (Hunter 2004): with strengths ``p_i``,
    ``p_i' = W_i / sum_j (n_ij / (p_i + p_j))`` where ``W_i`` is player i's
    total wins and ``n_ij`` the games between i and j.  ``regularize`` adds a
    phantom draw between every pair so undefeated/never-winning players get
    finite ratings.  Draws count half for each side.  The mean rating is
    anchored at ``mean_rating`` (Elo is translation-invariant).
    """
    names = list(board.players)
    n = len(names)
    if n == 0:
        return {}
    if n == 1:
        return {names[0]: mean_rating}
    idx = {name: i for i, name in enumerate(names)}
    wins = [[0.0] * n for _ in range(n)]
    games = [[0.0] * n for _ in range(n)]
    for a in names:
        for b in names:
            if a == b:
                continue
            i, j = idx[a], idx[b]
            g = board.games[(a, b)]
            w_a = board.wins[(a, b)]
            w_b = board.wins[(b, a)]
            draws = g - w_a - w_b
            wins[i][j] += w_a + 0.5 * draws + regularize * 0.5
            games[i][j] += g + regularize

    p = [1.0] * n
    for _ in range(n_iters):
        newp = []
        for i in range(n):
            w_i = sum(wins[i][j] for j in range(n) if j != i)
            denom = sum(games[i][j] / (p[i] + p[j])
                        for j in range(n) if j != i and games[i][j] > 0)
            newp.append(w_i / denom if denom > 0 else p[i])
        # renormalize (geometric mean = 1) for numerical stability
        log_gm = sum(math.log(x) for x in newp) / n
        newp = [x / math.exp(log_gm) for x in newp]
        delta = max(abs(a - b) for a, b in zip(newp, p))
        p = newp
        if delta < tol:
            break

    ratings = {name: ELO_SCALE * math.log(p[idx[name]]) for name in names}
    shift = mean_rating - sum(ratings.values()) / n
    return {k: v + shift for k, v in ratings.items()}


def elo_table(ratings: Dict[str, float]) -> str:
    rows = sorted(ratings.items(), key=lambda kv: -kv[1])
    width = max([7] + [len(n) for n, _ in rows]) + 2
    return "\n".join(name.ljust(width) + f"{r:8.1f}" for name, r in rows)


@dataclasses.dataclass
class LeagueEntry:
    step: int
    name: str
    rating: float


class LeagueHistory:
    """Elo-over-training bookkeeping: each evaluation round-robin between the
    current snapshot and past snapshots (plus fixed baselines like 'random')
    is folded into one cumulative cross-table; ratings are re-fit by MLE after
    every round so old snapshots' ratings stay consistent as evidence
    accumulates.  Appends one JSON line per fit to ``<dir>/elo_history.jsonl``
    for plotting the 10M-step learning benchmark."""

    def __init__(self, out_dir: Optional[str] = None, anchor: str = "random",
                 anchor_rating: float = 1000.0):
        self.board = Scoreboard()
        self.steps: Dict[str, int] = {}
        self.out_dir = out_dir
        self.anchor = anchor
        self.anchor_rating = anchor_rating
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    def add_result(self, board: Scoreboard, step: int, snapshot_name: str):
        """Merge a finished round-robin involving ``snapshot_name`` (taken at
        training step ``step``) into the league and re-fit ratings."""
        self.steps[snapshot_name] = step
        for a in board.players:
            self.board.add_player(a)
        for key, w in board.wins.items():
            self.board.wins[key] += w
        for key, g in board.games.items():
            self.board.games[key] += g
        ratings = self.ratings()
        if self.out_dir:
            path = os.path.join(self.out_dir, "elo_history.jsonl")
            with open(path, "a") as f:
                f.write(json.dumps({
                    "step": step, "snapshot": snapshot_name,
                    "ratings": ratings,
                }) + "\n")
        return ratings

    def ratings(self) -> Dict[str, float]:
        r = fit_elo(self.board)
        # pin the anchor (e.g. the random policy) so curves are comparable
        # across runs
        if self.anchor in r:
            shift = self.anchor_rating - r[self.anchor]
            r = {k: v + shift for k, v in r.items()}
        return r

    def curve(self) -> List[LeagueEntry]:
        """(step, snapshot, rating) sorted by step — the learning curve."""
        r = self.ratings()
        return sorted(
            (LeagueEntry(self.steps[n], n, r[n]) for n in self.steps if n in r),
            key=lambda e: e.step)
