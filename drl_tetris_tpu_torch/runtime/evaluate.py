"""Round-robin evaluation: checkpoints play each other head to head.

Counterpart of ``drl_tetris_tpu/runtime/evaluate.py`` (reference:
scripts/eval.py:70-208): pair agents, alternate turns in the two-player
env, record winners on a scoreboard.  Every pair plays n_games matches in
lockstep with the seats swapped halfway.

The JAX package's choices that decide which winner is recorded are kept,
so ``argmax`` agents play the same games as there: the games reset from
``PRNGKey(seed)``; both policies act on every game each tick and the
acting player's action is taken; the winner is read once after each
chunk of 8 ticks and recorded only for newly finished games; each
pairing's seed is ``seed + 97 * p0 + p1``.  Each tick's env step is one
launch of the engine kernel's one-tick entry on the card.  Every agent
that draws follows JAX's key chain (``PRNGKey(seed + 1)``, one split per
chunk of 8 ticks, one per tick, one per seat), so its games are JAX's:
epsilon-greedy agents split their seat's key, ``pi`` and pareto agents
sample its categorical, whose noise is drawn for the whole chunk at once.

Agents of every kind meet: ``macro`` (PPONet and QNet, the (r, t) macro),
``world_model`` and ``world_model_full`` (SIXten's VNet, one-ply search
over the top-drop or the full placement set), ``sherlock`` and
``sherlock_full`` (SherlockNet's phi.delta placements).  Each tick, each
game takes the acting agent's make phase: one launch of the one-tick
entry, its macro-only instantiation when both agents are macro agents,
else its per-kind one (the JAX package's step, step_place, step_pose and
step_mixed* dispatch).  World-model and Sherlock agents draw from JAX's
key chain whatever their distribution (``pi`` is SIXten's ``boltzmann``),
so their games are JAX's.

``render=True`` (``play``, ``eval --render``) reads the winner every
tick, as the JAX package does there, and prints each tick's frame of the
first game (utils/render.py) with, for each agent with a probability map,
the probe (scripts/eval.py:17-28): the policy's entropy over the acting
piece's (r, t) plane against its maximum, as a bar, and the piece's
value.  ``pygame=True`` also draws the frames in a pygame window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Sequence, Tuple

import numpy as np
import torch

from drl_tetris_tpu_torch.algos.rollout import (SAMPLED_DISTRIBUTIONS,
                                                action_size, make_policy_fn,
                                                policy_inputs)
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.engine import step as S
from drl_tetris_tpu_torch.engine.core import tree_map
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
from drl_tetris_tpu_torch.utils import render as R
from drl_tetris_tpu_torch.utils import tracing
from drl_tetris_tpu_torch.utils.scoreboard import Scoreboard

CHUNK = 8    # ticks between winner reads (evaluate.py:172-186)
KINDS = ("macro", "world_model", "world_model_full", "sherlock",
         "sherlock_full")


@dataclasses.dataclass
class EvalAgent:
    """An entrant: ``net`` holds the agent's weights (on the device the
    matches run on): a PPONet or QNet for ``kind="macro"``, a VNet for
    "world_model"/"world_model_full", a SherlockNet for
    "sherlock"/"sherlock_full" (the "_full" kinds act on the top-drop and
    finesse placements through pose locks, the others on the top-drop
    grid)."""
    name: str
    net: torch.nn.Module
    distribution: str = "argmax"   # eval_distribution (presets.py:128)
    kind: str = "macro"
    epsilon: float = 0.05          # for the epsilon distributions


def _agent_policy(env, agent: EvalAgent):
    """(policy(st, key, gumbel) -> (r, t, y), its make phase, whether it
    reads the key, the size of its categorical's noise per game or None).
    ``gumbel`` is the noise of a ``pi`` or pareto agent's categorical
    from ``key``, drawn ahead."""
    if agent.kind not in KINDS:
        raise ValueError(f"{agent.name}: unknown kind {agent.kind!r}")
    full = agent.kind.endswith("_full")
    space = "full" if full else "top_drop"
    if agent.kind == "macro":
        pol = make_policy_fn(env, agent.net, agent.distribution,
                             epsilon=agent.epsilon)

        def act(st, key, gumbel):
            _, _, r, t, *_ = pol(st, gumbel, key)
            return r, t, torch.zeros_like(r)
        sampled = agent.distribution in SAMPLED_DISTRIBUTIONS
        return (act, S.MACRO, agent.distribution != "argmax",
                action_size(agent.net) if sampled else None)
    if agent.kind.startswith("world_model"):
        from drl_tetris_tpu_torch.algos.sixten import make_sixten_policy
        d = {"pi": "boltzmann"}.get(agent.distribution, agent.distribution)
        pol = make_sixten_policy(env, agent.net, d, agent.epsilon, space)
    else:
        from drl_tetris_tpu_torch.algos.sherlock import make_sherlock_policy
        pol = make_sherlock_policy(env, agent.net, agent.distribution,
                                   agent.epsilon, space)

    def act(st, key, gumbel):
        out = pol(st, key)
        if full:
            return out[2], out[3], out[4]
        return out[2], out[3], torch.zeros_like(out[2])
    return (act, (S.POSE if full else S.PLACE),
            agent.distribution != "argmax", None)


def make_probe(env, agent: EvalAgent):
    """The eval-time NN visualization (scripts/eval.py:17-28):
    probe(st) -> (entropy, its maximum, value) of game 0's acting piece,
    the entropy over the piece's (r, t) plane of the policy; None for
    agents without a probability map (value, Q and placement agents)."""
    if agent.kind != "macro":
        return None

    @torch.no_grad()
    def probe(st):
        obs = env.observe(st)
        out = agent.net(*policy_inputs(obs))
        if len(out) != 2:
            return None
        pi, v = out                             # (N, 4, W, 7), (N, 7)
        piece = obs.piece[0, 0]
        ppi = pi[0, :, :, piece]
        p = ppi / torch.clamp(ppi.sum(), min=1e-8)
        ent = -torch.sum(p * torch.log(p + 1e-8))
        max_ent = torch.log(torch.tensor(float(ppi.numel()),
                                         dtype=torch.float32,
                                         device=ppi.device))
        v_p = v[0, piece] if v.shape[-1] > 1 else v[0, 0]
        return ent, max_ent, v_p
    return probe


def render_frame(env_cfg: EnvConfig, st, agents, probes) -> str:
    """The text ``play`` prints for a tick: the first game's fields and a
    probe line per agent with a probability map, indented by seat like the
    reference's per-player columns."""
    frame = R.render_ansi(env_cfg.engine, tree_map(lambda a: a[:1],
                                                   st.engine),
                          max_games=1, titles=[a.name for a in agents])
    lines = []
    for seat, (agent, probe) in enumerate(zip(agents, probes)):
        res = None if probe is None else probe(st)
        if res is None:
            continue
        ent, max_ent, v_p = torch.stack(res).tolist()
        lines.append(" " * (30 * seat) + R.progress_bar(ent, max_ent)
                     + f" H={ent:.2f} v={v_p:+.3f} {agent.name}")
    return "\x1b[2J\x1b[H" + frame + ("\n" + "\n".join(lines)
                                      if lines else "")


def play_match(env_cfg: EnvConfig, agents: Tuple[EvalAgent, EvalAgent],
               n_games: int = 16, max_ticks: int = 2000, seed: int = 0,
               render: bool = False, pygame: bool = False
               ) -> Tuple[int, int, int]:
    """agents[0] sits as player 0 in every game.  Returns (wins0, wins1,
    unfinished).  The games run on agents[0]'s device.  ``render`` prints
    every tick's frame (``render_frame``); ``pygame`` also draws it in a
    window, pausing on a key press (draw_tetris.py:103-143)."""
    pg_renderer = None
    if pygame:
        pg_renderer = R.get_pygame_renderer()
        render = True
    dev = next(agents[0].net.parameters()).device
    env = TetrisVectorEnv(env_cfg, n_games, device=dev)
    (act0, kind0, keyed0, noise0), (act1, kind1, keyed1, noise1) = [
        _agent_policy(env, a) for a in agents]
    st = env.reset(seed)
    keyed = keyed0 or keyed1
    key = rng.prng_key(seed + 1, dev)
    seat_keys = (None, None)
    gumbel = (None, None)
    finished = np.zeros(n_games, bool)
    winner = np.full(n_games, -1)
    # a rendered match reads the winner every tick (one key a tick);
    # headless, every CHUNK ticks (one key a chunk, split per tick)
    chunk = 1 if render else CHUNK
    probes = [make_probe(env, a) for a in agents] if render else None
    with torch.no_grad(), contextlib.ExitStack() as stack:
        if pg_renderer is not None:
            stack.callback(pg_renderer.close)
        for _ in range(0, max_ticks, chunk):
            done_any = torch.zeros(n_games, dtype=torch.bool, device=dev)
            if keyed:
                key, k = rng.split(key)
                keys = rng.split(k[None] if chunk == 1 else rng.split(
                    k, CHUNK))                          # (chunk, seat, 2)
                noise = [None if m is None else
                         rng.gumbel(keys[:, seat], (n_games, m))
                         for seat, m in enumerate((noise0, noise1))]
            for i in range(chunk):
                if keyed:
                    seat_keys = keys[i]
                    gumbel = [None if g is None else g[i] for g in noise]
                with tracing.span("tick"):
                    (r0, t0, y0), (r1, t1, y1) = (
                        act0(st, seat_keys[0], gumbel[0]),
                        act1(st, seat_keys[1], gumbel[1]))
                    with tracing.leaf("env_step"):
                        mine = st.current_player == 0
                        r = torch.where(mine, r0, r1)
                        t = torch.where(mine, t0, t1)
                        if kind0 == kind1 == S.MACRO:
                            st, _, done = env.step(st, r, t)
                        else:
                            st, _, done = env.step_kinds(
                                st, torch.where(mine, kind0, kind1), r, t,
                                torch.where(mine, y0, y1))
                done_any |= done
            d, w = torch.stack([done_any.to(torch.int32),
                                env.get_winner(st).to(torch.int32)]
                               ).cpu().numpy()
            newly = d.astype(bool) & ~finished
            winner[newly] = w[newly]
            finished |= d.astype(bool)
            if render:
                print(render_frame(env_cfg, st, agents, probes), flush=True)
                if pg_renderer is not None:
                    pg_renderer.draw_all_fields(
                        R.field_arrays(env_cfg.engine, tree_map(
                            lambda a: a[0], st.engine)),
                        pause_on_event=True)
            if finished.all():
                break
    wins0 = int((winner == 0).sum())
    wins1 = int((winner == 1).sum())
    return wins0, wins1, int((~finished).sum())


def round_robin(env_cfg: EnvConfig, agents: Sequence[EvalAgent],
                games_per_pair: int = 16, seed: int = 0,
                render: bool = False) -> Scoreboard:
    """All-pairs tournament with seat sides swapped halfway."""
    board = Scoreboard([a.name for a in agents])
    half = max(games_per_pair // 2, 1)
    for a, b in itertools.combinations(range(len(agents)), 2):
        for (p0, p1) in ((a, b), (b, a)):
            w0, w1, undecided = play_match(
                env_cfg, (agents[p0], agents[p1]), n_games=half,
                seed=seed + 97 * p0 + p1, render=render)
            for _ in range(w0):
                board.declare_winner(agents[p0].name, agents[p1].name)
            for _ in range(w1):
                board.declare_winner(agents[p1].name, agents[p0].name)
            for _ in range(undecided):
                board.declare_draw(agents[p0].name, agents[p1].name)
    return board
