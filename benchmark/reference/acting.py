"""The acting loop in plain PyTorch, after the port's algos/rollout.py at
commit 0522b5deacbf29e64a07f002c2407ff1530df4d8 (``make_policy_fn`` with
``pi``, ``_tick``, ``_finish``, ``rollout_gumbel``) and
``segment_to_batch`` of algos/ppo.py: per tick observe, the net's pi over
the acting piece's (rotation, translation) plane, the categorical
``argmax(log p + gumbel)``, the env step with auto-reset; then GAE over the
segment and the flattened batch.

The engine runs on the state's device (the CPU in the benchmark), the net
on its own; the observations cross over once a tick.  ``replay`` drives
the engine alone with given actions; ``policy`` judges given actions or
chooses its own."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from benchmark.reference import rng
from benchmark.reference.env import EnvConfig, EnvState, step_plain
from benchmark.reference.gae import sventon_gae
from benchmark.reference.observations import field_grid, observe


class Batch(NamedTuple):
    """A worker's shipped batch, flattened tick-major."""
    occ: torch.Tensor       # (B, 2, H) int32 bits
    vec: torch.Tensor       # (B, 2, 12) float32
    piece: torch.Tensor     # (B,) int32
    rot: torch.Tensor       # (B,) int32
    trans: torch.Tensor     # (B,) int32
    old_prob: torch.Tensor  # (B,) float32
    advantage: torch.Tensor
    target_v: torch.Tensor


def rollout_noise(key, horizon: int, n: int, n_actions: int):
    """The categorical noise of a rollout's ticks, (horizon, n, n_actions):
    JAX's gumbel draw from each tick's key of split(key, horizon)."""
    return rng.gumbel(rng.split(rng.u32(key), horizon), (n, n_actions))


def perspective_occ(state: EnvState) -> torch.Tensor:
    """(N, 2, H) boards ordered [acting player, opponent]."""
    occ = state.engine.players.occ
    p = state.current_player
    idx = torch.stack([p, 1 - p], dim=1).long()
    return occ.gather(1, idx[:, :, None].expand(-1, -1, occ.shape[2]))


def tick_view(cfg: EnvConfig, state: EnvState) -> Dict[str, torch.Tensor]:
    """What a tick records of the state it acts on."""
    obs = observe(cfg.engine, state.engine, state.current_player)
    return {"occ": perspective_occ(state), "vec": obs.vec,
            "piece": obs.piece[:, 0], "player": state.current_player}


def replay(cfg: EnvConfig, state: EnvState, rot, trans):
    """Step ``state`` through (T, N) actions.  Returns (end state, the
    ticks' views stacked (T, N, ...) with reward and done)."""
    ticks = []
    for r, t in zip(rot, trans):
        view = tick_view(cfg, state)
        state, view["reward"], view["done"] = step_plain(cfg, state, r, t)
        ticks.append(view)
    return state, {k: torch.stack([v[k] for v in ticks]) for k in ticks[0]}


@torch.no_grad()
def policy(cfg: EnvConfig, net, occ, vec, piece, noise=None, chosen=None,
           chunk: int = 8192):
    """The net over (B, ...) observations, in chunks of ``chunk`` rows.
    Returns probabilities over the acting piece's plane (B, R*W), the
    values v(s|piece) and v(s), and, with ``noise`` (B, R*W): the argmax of
    log p + noise and the gap by which ``chosen`` (B,) flat actions lie
    below it."""
    dev = next(net.parameters()).device
    out = {"p": [], "v_piece": [], "v_mean": [], "best": [], "gap": []}
    for s in range(0, occ.shape[0], chunk):
        o, vc = occ[s:s + chunk].to(dev), vec[s:s + chunk].to(dev)
        pc = piece[s:s + chunk].to(dev).long()
        grids = field_grid(cfg.engine, o)
        pi, v = net([vc[:, 0], vc[:, 1]],
                    [grids[:, 0, :, :, None], grids[:, 1, :, :, None]])
        b, R, W, _ = pi.shape
        idx = torch.arange(b, device=dev)
        p = pi[idx, :, :, pc].reshape(b, R * W).float()
        out["p"].append(p)
        out["v_piece"].append(v[idx, pc])
        out["v_mean"].append(v.mean(-1))
        if noise is not None:
            score = noise[s:s + chunk].to(dev) + torch.log(
                torch.clamp(p, min=1e-20))
            best = score.argmax(-1)
            out["best"].append(best)
            if chosen is not None:
                c = chosen[s:s + chunk].to(dev).long()
                out["gap"].append(score.max(-1).values
                                  - score[idx, c])
    return {k: torch.cat(v) for k, v in out.items() if v}


def act(cfg: EnvConfig, net, state: EnvState, noise):
    """A segment chosen by ``net`` itself (the control in the program's
    place): per tick the view, the policy's sample, the step.  Returns
    (end state, (T, N) rot and trans, and the ticks' views)."""
    W = cfg.engine.width
    rots, transes, ticks = [], [], []
    for k in range(noise.shape[0]):
        view = tick_view(cfg, state)
        best = policy(cfg, net, view["occ"], view["vec"], view["piece"],
                      noise[k])["best"].to(state.current_player.device)
        r, t = (best // W).to(torch.int32), (best % W).to(torch.int32)
        state, view["reward"], view["done"] = step_plain(cfg, state, r, t)
        rots.append(r)
        transes.append(t)
        ticks.append(view)
    views = {k: torch.stack([v[k] for v in ticks]) for k in ticks[0]}
    return state, torch.stack(rots), torch.stack(transes), views


def segment_batch(cfg: EnvConfig, gamma: float, gae_lambda: float,
                  gve_lambda: float, net, views, rot, trans, end_state,
                  noise: Optional[torch.Tensor] = None,
                  gae_dtype=torch.float32):
    """The worker's batch of a replayed (T, N) segment: the net's
    probabilities of the taken actions and values, GAE (gamma negated in
    single-policy self-play) in ``gae_dtype``, flattened tick-major; with
    ``noise`` also the widest action gap.  Returns (Batch on the net's
    device, gap or None, the values {v_piece, v_mean: (T, N), v_last})."""
    T, N = rot.shape
    W = cfg.engine.width
    flat = {k: v.reshape((T * N,) + v.shape[2:]) for k, v in views.items()}
    chosen = (rot.long() * W + trans.long()).reshape(-1)
    out = policy(cfg, net, flat["occ"], flat["vec"], flat["piece"],
                 None if noise is None else noise.reshape(T * N, -1),
                 chosen)
    last = tick_view(cfg, end_state)
    values = {"v_piece": out["v_piece"].reshape(T, N),
              "v_mean": out["v_mean"].reshape(T, N),
              "v_last": policy(cfg, net, last["occ"], last["vec"],
                               last["piece"])["v_piece"]}
    dev = values["v_last"].device
    idx = torch.arange(T * N, device=dev)
    prob = out["p"][idx, chosen.to(dev)]
    adv, tgt, _ = sventon_gae(
        views["reward"].to(dev), views["done"].to(dev), values["v_piece"],
        values["v_mean"], values["v_last"], gamma=gamma,
        gae_lambda=gae_lambda, gve_lambda=gve_lambda, dtype=gae_dtype)
    batch = Batch(occ=flat["occ"].to(dev), vec=flat["vec"].to(dev),
                  piece=flat["piece"].to(dev), rot=rot.reshape(-1).to(dev),
                  trans=trans.reshape(-1).to(dev), old_prob=prob,
                  advantage=adv.reshape(-1).float(),
                  target_v=tgt.reshape(-1).float())
    gap = float(out["gap"].max()) if "gap" in out else None
    return batch, gap, values
