"""Pairwise win/loss cross-tables for evaluation tournaments.

The port's copy of ``drl_tetris_tpu/utils/scoreboard.py`` (reference:
tools/scoreboard.py:8-69, declare_winner / score_table), which also
counts the draws of each pair."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


class Scoreboard:
    def __init__(self, players: Sequence[str] = ()):
        self.players: List[str] = list(players)
        self.wins: Dict[Tuple[str, str], int] = defaultdict(int)
        self.games: Dict[Tuple[str, str], int] = defaultdict(int)
        self.draws: Dict[Tuple[str, str], int] = defaultdict(int)

    def add_player(self, name: str):
        if name not in self.players:
            self.players.append(name)

    def declare_winner(self, winner: str, loser: str):
        """tools/scoreboard.py:22."""
        self.add_player(winner)
        self.add_player(loser)
        self.wins[(winner, loser)] += 1
        self.games[(winner, loser)] += 1
        self.games[(loser, winner)] += 1

    def declare_draw(self, a: str, b: str):
        self.add_player(a)
        self.add_player(b)
        self.games[(a, b)] += 1
        self.games[(b, a)] += 1
        self.draws[(a, b)] += 1
        self.draws[(b, a)] += 1

    def win_rate(self, a: str, b: str) -> Optional[float]:
        g = self.games[(a, b)]
        return None if g == 0 else self.wins[(a, b)] / g

    def total_score(self, a: str) -> int:
        return sum(self.wins[(a, b)] for b in self.players)

    def score_table(self) -> str:
        """tools/scoreboard.py:45-63: rows = player, cols = opponent,
        cell = wins/games."""
        names = self.players
        width = max([7] + [len(n) for n in names]) + 2
        out = ["".ljust(width) + "".join(n.ljust(width) for n in names)
               + "TOTAL".rjust(7)]
        for a in names:
            row = [a.ljust(width)]
            for b in names:
                if a == b:
                    row.append("-".ljust(width))
                else:
                    row.append(f"{self.wins[(a, b)]}/{self.games[(a, b)]}".ljust(width))
            row.append(str(self.total_score(a)).rjust(7))
            out.append("".join(row))
        return "\n".join(out)
