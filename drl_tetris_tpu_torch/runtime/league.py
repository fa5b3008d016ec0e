"""Training-time league: Elo tracking over the course of a run.

Counterpart of ``drl_tetris_tpu/runtime/league.py``: periodically snapshot
the learner's net, play a round-robin against a pool of past snapshots, a
random-policy anchor and any fixed external anchors, and refit
Bradley-Terry/Elo ratings over the cumulative cross-table
(utils/elo.py), appending each fit to ``elo_history.jsonl``.
"""
from __future__ import annotations

import collections
import copy
from typing import Deque, Dict, Optional, Sequence, Tuple

import torch

from drl_tetris_tpu_torch.env.env import EnvConfig
from drl_tetris_tpu_torch.runtime.evaluate import EvalAgent, round_robin
from drl_tetris_tpu_torch.utils.elo import LeagueHistory


def random_anchor(net: torch.nn.Module, seed: int = 0xE10
                  ) -> torch.nn.Module:
    """The league's random anchor for a run of ``net``: a full net of its
    class (PPONet or QNet), model and board, on its device, with fresh
    flax-distributed weights from ``torch.Generator().manual_seed(seed)``
    (the JAX package inits its anchor from ``PRNGKey(0xE10)``)."""
    dev = next(net.parameters()).device
    rnd = type(net)(net.cfg, net.board, full_network=True, device=dev)
    return rnd.init_flax_(torch.Generator().manual_seed(seed))


class TrainingLeague:
    """Maintains a rolling opponent pool and an Elo history.

    The pool keeps the ``max_pool`` most recent snapshots (older ones are
    dropped from play but keep their fitted rating: their games stay in the
    cumulative table).  The random anchor (``random_net``, a net with
    fresh weights that samples from pi) pins the scale at 1000.
    """

    def __init__(self, env_cfg: EnvConfig, random_net: torch.nn.Module,
                 out_dir: Optional[str] = None, games_per_pair: int = 16,
                 max_pool: int = 4, distribution: str = "argmax",
                 kind: str = "macro", fixed_anchors: Sequence = ()):
        self.env_cfg = env_cfg
        self.distribution = distribution
        self.kind = kind
        self.games_per_pair = games_per_pair
        self.pool: Deque[EvalAgent] = collections.deque(maxlen=max_pool)
        self.history = LeagueHistory(out_dir=out_dir, anchor="random")
        # the anchor plays at maximum entropy: "pi" sampling for macro
        # agents
        self.anchor = EvalAgent(name="random", net=random_net,
                                distribution="pi", kind=kind)
        self.history.steps["random"] = 0
        # External fixed anchors (e.g. a strong reference checkpoint):
        # permanent entrants that every snapshot plays, which makes ratings
        # comparable across runs.
        self.fixed_anchors = list(fixed_anchors)
        for a in self.fixed_anchors:
            self.history.steps[a.name] = 0

    def snapshot(self, net: torch.nn.Module, step: int) -> EvalAgent:
        """A frozen copy of ``net`` as the league entrant of ``step``."""
        snap = copy.deepcopy(net).eval()
        snap.requires_grad_(False)
        return EvalAgent(name=f"step_{step}", net=snap,
                         distribution=self.distribution, kind=self.kind)

    def evaluate(self, net: torch.nn.Module, step: int,
                 seed: int = 0) -> Dict[str, float]:
        """Snapshot ``net`` at ``step``, play it against the pool and the
        anchors, fold the results into the league, return the refit
        ratings."""
        snap = self.snapshot(net, step)
        opponents = list(self.pool) + [self.anchor] + self.fixed_anchors
        board = round_robin(self.env_cfg, [snap] + opponents,
                            games_per_pair=self.games_per_pair, seed=seed)
        ratings = self.history.add_result(board, step, snap.name)
        self.pool.append(snap)
        return ratings

    def rating_of_latest(self) -> Tuple[int, float]:
        curve = self.history.curve()
        if not curve:
            return 0, 0.0
        last = curve[-1]
        return last.step, last.rating
