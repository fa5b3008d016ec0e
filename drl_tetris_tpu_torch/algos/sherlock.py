"""Sherlock: the delta-PPO agent family.

Counterpart of ``drl_tetris_tpu/algos/sherlock.py`` (reference:
agents/sherlock_agent/* and agents/networks/delta_ppo_nets.py).  The policy
is a spatial field phi over the board per piece (spatial softmax, clipped
to [1e-6, 1]); an action's probability is the phi mass over the cells its
placement fills:

  delta_a   = the 4 cells the piece rests in under action a
  p(a|s)    ~ sum_cells delta_a * phi
  loss      = PPO clip on p + value MSE + entropy + the impossibility loss
              (phi mass on cells no action covers)

The deltas come from the placement enumeration (engine/masks.py): the
top-drop grid (4, W) or the full top-drop and finesse pose grid
(4, W, H).  Every draw follows JAX's keys through the port's threefry
(``distributions.categorical``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn as nn

from drl_tetris_tpu_torch import resolve_device
from drl_tetris_tpu_torch.algos.distributions import categorical
from drl_tetris_tpu_torch.algos.gae import sventon_gae
from drl_tetris_tpu_torch.algos.rollout import (_perspective_occ,
                                                _tick_keys, policy_inputs)
from drl_tetris_tpu_torch.engine import kernels as K
from drl_tetris_tpu_torch.engine import masks as M
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.engine.core import SPAWN_ROT, EngineConfig
from drl_tetris_tpu_torch.env.env import take_player
from drl_tetris_tpu_torch.env.observations import field_grid
from drl_tetris_tpu_torch.models.flax_init import FlaxInit
from drl_tetris_tpu_torch.models.nets import (VEC_DIM, ModelConfig,
                                              ResidualBlock, SventonNet,
                                              apply_visual_pad)

DISTRIBUTIONS = ("argmax", "pi", "boltzmann", "epsilon")


class SherlockNet(nn.Module):
    """delta_ppo_nets' network: the 'silver' SventonNet trunk for the
    per-piece tanh values, and a phi head: its own float32 tower over the
    padded field and the tiled vector, a 3x3 conv to one map per piece,
    cropped to the board and softmaxed over it.  Returns (phi (B, H, W, P),
    v (B, P | 1))."""

    def __init__(self, cfg: ModelConfig, board=(22, 10),
                 full_network: bool = True, device=None):
        super().__init__()
        self.cfg, self.board = cfg, tuple(board)
        self.full_network = full_network
        self.trunk = SventonNet(cfg, board, full_network)
        self.phi_tower = ResidualBlock(
            VEC_DIM + 1, n_layers=cfg.tower_layers,
            n_filters=cfg.tower_filters,
            filter_size=(cfg.tower_filter_size,) * 2)
        self.phi_conv = nn.Conv2d(self.phi_tower.out_channels, cfg.n_pieces,
                                  3, padding=1)
        self.to(resolve_device(device))

    def init_flax_(self, key) -> "SherlockNet":
        """Fresh weights from the init key ``key``: what the JAX
        SherlockNet's ``init(key, ...)`` gives (models/flax_init.py): the
        trunk's, glorot-uniform for the phi tower, normal(0.01) for the
        phi conv."""
        init = FlaxInit(self, key)
        self.trunk.init_flax_(init)
        self.phi_tower.init_flax_(init)
        init.normal(self.phi_conv.weight, 0.01)
        init.zeros(self.phi_conv.bias)
        return self

    def load_params_(self, params) -> "SherlockNet":
        self.load_state_dict({k: torch.as_tensor(v)
                              for k, v in params.items()})
        return self

    def forward(self, vec, vis):
        raw_v, _ = self.trunk(vec, vis)
        v0 = apply_visual_pad(vis[0].float()).permute(0, 3, 1, 2)
        b, _, h, w = v0.shape
        x = torch.cat([vec[0].float()[:, :, None, None].expand(
            b, VEC_DIM, h, w), v0], dim=1)
        x = self.phi_conv(self.phi_tower(x))[:, :, 1:-1, 1:-1]
        m = torch.amax(x, dim=(2, 3), keepdim=True)
        e = torch.exp(x - m)
        phi = torch.clamp(e / torch.sum(e, dim=(2, 3), keepdim=True),
                          1e-6, 1.0)
        return phi.permute(0, 2, 3, 1), raw_v.reshape(raw_v.shape[0], -1)


def _cells(cfg, piece, rot, x, y):
    """(N, ..., H, W) float32 grids of the cells a piece fills at each
    candidate (rot, posX x, posY y) of its game."""
    shape = rot.shape
    n, m = shape[0], rot[0].numel()
    rows = M._rows(piece.to(torch.int64), rot).reshape(n * m, 4)
    zero = torch.zeros(n * m, cfg.height, dtype=torch.int64,
                       device=rot.device)
    sh = K.add_piece(cfg, zero, rows, x.reshape(-1).to(torch.int64),
                     y.reshape(-1).to(torch.int64))
    return field_grid(cfg, sh).reshape(shape + (cfg.height, cfg.width))


def placement_deltas(cfg: EngineConfig, occ, piece, rot):
    """(mask (N, 4, W), deltas (N, 4, W, H, W) float32): the resting piece
    cells of each legal top-drop placement."""
    mask, rest = M.top_drop(cfg, occ, piece, rot)
    eff, xs, _ = M.grid_coords(cfg, piece.to(torch.int64),
                               rot.to(torch.int64))
    cells = _cells(cfg, piece, eff, xs, rest.clamp(min=0))
    return mask, torch.where(mask[..., None, None], cells, 0.0)


def pose_deltas(cfg: EngineConfig, occ, piece, rot):
    """(rest (N, 4, W, H), deltas (N, 4, W, H, H, W)) over the full legal
    set (top-drop and finesse rests)."""
    rest = M.legal_rests(cfg, occ, piece, rot)
    eff, xs, _ = M.grid_coords(cfg, piece.to(torch.int64),
                               rot.to(torch.int64))
    shape = rest.shape
    y = torch.arange(cfg.height, device=rest.device).expand(shape)
    cells = _cells(cfg, piece, eff[..., None].expand(shape),
                   xs[..., None].expand(shape), y)
    return rest, torch.where(rest[..., None, None], cells, 0.0)


def action_probabilities(phi_p, deltas, mask):
    """p (N, ...) over each game's candidates: the phi mass of each legal
    candidate's cells, normalised over the legal ones; phi_p (N, H, W),
    deltas (N, ..., H, W), mask (N, ...)."""
    extra = (1,) * (mask.ndim - 1)
    scores = torch.sum(deltas * phi_p.reshape(phi_p.shape[:1] + extra
                                              + phi_p.shape[1:]),
                       dim=(-2, -1))
    scores = torch.where(mask, scores, 0.0)
    total = scores.reshape(scores.shape[0], -1).sum(-1)
    total = torch.where(total == 0, 1.0, total)     # the p_sum == 0 guard
    return scores / total.reshape((-1,) + extra)


def sherlock_candidate_probs(cfg: EngineConfig, net, obs, env_state,
                             full: bool, mark=None):
    """The phi.delta probability of every legal placement of the acting
    piece: (p, mask, deltas, piece, v_piece, v_mean), p and mask (N, 4, W
    [, H])."""
    piece = obs.piece[:, 0]
    p = env_state.current_player
    ps = env_state.engine.players
    fn = pose_deltas if full else placement_deltas
    mask, deltas = fn(cfg, take_player(ps.occ, p), piece,
                      take_player(ps.rot, p))
    if mark is not None:
        mark("masks")
    vec, vis = policy_inputs(obs)
    phi, v = net(vec, vis)                       # (N, H, W, P), (N, P)
    idx = torch.arange(phi.shape[0], device=phi.device)
    phi_p = phi[idx, :, :, piece.long()]
    probs = action_probabilities(phi_p, deltas, mask)
    v_piece = v[idx, piece.long()] if v.shape[-1] > 1 else v[:, 0]
    return probs, mask, deltas, piece, v_piece, v.mean(-1)


_SPAWN = {}


def _spawn_rot(piece):
    dev = piece.device
    if dev not in _SPAWN:
        _SPAWN[dev] = torch.as_tensor(SPAWN_ROT.astype("int64"), device=dev)
    return _SPAWN[dev][piece.long()]


def _action(cfg, a_idx, piece, full):
    """The step arguments of flat candidate indices: (rot, col, y) on the
    pose grid, (r_rel, posX) on the top-drop grid (rotations relative to
    the spawn rotation)."""
    W, H = cfg.width, cfg.height
    if full:
        return ((a_idx // (W * H)).to(torch.int32),
                ((a_idx // H) % W).to(torch.int32),
                (a_idx % H).to(torch.int32))
    r_rel = torch.remainder(a_idx // W - _spawn_rot(piece), 4)
    return r_rel.to(torch.int32), (a_idx % W - 1).to(torch.int32)


def make_sherlock_policy(env, net: SherlockNet, distribution: str = "argmax",
                         epsilon: float = 0.05,
                         action_space: str = "top_drop"):
    """Evaluation policy over the phi.delta candidate distribution:
    policy(env_state, key=None) -> (obs, piece, r_rel, col, prob, v_piece,
    v_mean) for env.step_place, or with "full" (obs, piece, rot, col, y,
    prob, v_piece, v_mean) for env.step_pose.  "argmax" takes the most
    probable placement, "pi"/"boltzmann" sample it, "epsilon" explores
    uniformly over the legal ones with probability epsilon (1.0: the
    league's random anchor); the draws follow JAX's key."""
    if distribution not in DISTRIBUTIONS:
        raise ValueError(distribution)
    cfg = env.cfg.engine
    full = action_space == "full"

    @torch.no_grad()
    def policy(env_state, key=None, hp=None, mark=None):
        obs = env.observe(env_state)
        p, mask, _, piece, v_piece, v_mean = sherlock_candidate_probs(
            cfg, net, obs, env_state, full, mark)
        n = p.shape[0]
        pf, mf = p.reshape(n, -1), mask.reshape(n, -1)
        greedy = torch.argmax(torch.where(mf, pf, -1.0), dim=-1)
        if distribution in ("pi", "boltzmann"):
            logits = torch.where(mf, torch.log(torch.clamp(pf, min=1e-20)),
                                 -torch.inf)
            a_idx = categorical(key, logits)
        elif distribution == "epsilon":
            ke, ku = rng.split(key.to(pf.device))
            uni = categorical(ku, torch.where(mf, 0.0, -torch.inf))
            explore = rng.uniform01(ke, (n,)) < torch.tensor(
                epsilon, dtype=torch.float32)
            a_idx = torch.where(explore, uni, greedy)
        else:
            a_idx = greedy
        prob = pf[torch.arange(n, device=pf.device), a_idx]
        if mark is not None:
            mark("forward")
        return (obs, piece, *_action(cfg, a_idx, piece, full), prob,
                v_piece, v_mean)

    return policy


class SherlockSegment(NamedTuple):
    occ: torch.Tensor        # (T, N, 2, H) int32 bits
    vec: torch.Tensor        # (T, N, 2, 12)
    piece: torch.Tensor      # (T, N)
    delta: torch.Tensor      # (T, N, H, W) the chosen action's cells
    delta_sum: torch.Tensor  # (T, N, H, W) coverage of the legal actions
    prob: torch.Tensor       # (T, N)
    v_piece: torch.Tensor    # (T, N)
    v_mean: torch.Tensor     # (T, N)
    reward: torch.Tensor     # (T, N)
    done: torch.Tensor       # (T, N)


def make_sherlock_rollout(env, net: SherlockNet, horizon: int,
                          action_space: str = "top_drop"):
    """Self-play with the phi.delta distribution sampled (the logits are
    log max(p, 1e-20) over every candidate, as in JAX): rollout(env_state,
    key, mark=None) -> (env_state', SherlockSegment, v_last).  Placements
    step with env.step_place (rotations from the spawn rotation) or, with
    "full", env.step_pose; the keys are JAX's (split(key, horizon) per
    tick, fold_in(key, horizon) for the bootstrap)."""
    cfg = env.cfg.engine
    H, W = cfg.height, cfg.width
    full = action_space == "full"

    def acting(env_state, key, mark=None):
        obs = env.observe(env_state)
        p, mask, deltas, piece, v_piece, v_mean = sherlock_candidate_probs(
            cfg, net, obs, env_state, full, mark)
        n = p.shape[0]
        idx = torch.arange(n, device=p.device)
        pf = p.reshape(n, -1)
        a_idx = categorical(key, torch.log(torch.clamp(pf, min=1e-20)))
        flat = deltas.reshape(n, -1, H, W)
        if mark is not None:
            mark("forward")
        return (obs, piece, _action(cfg, a_idx, piece, full), pf[idx, a_idx],
                flat[idx, a_idx], flat.sum(1), v_piece, v_mean)

    @torch.no_grad()
    def rollout(env_state, key, mark: Optional[Callable[[str], None]] = None):
        keys, last_key = _tick_keys(key, horizon, "epsilon")
        ticks = []
        for t in range(horizon):
            player = env_state.current_player
            (obs, piece, act, prob, delta, delta_sum, v_piece,
             v_mean) = acting(env_state, keys[t], mark)
            occ = _perspective_occ(env_state, player)
            if full:
                env_state, reward, done = env.step_pose(env_state, *act)
            else:
                env_state, reward, done = env.step_place(env_state, *act)
            if mark is not None:
                mark("tick")
            ticks.append(SherlockSegment(
                occ=occ, vec=obs.vec, piece=piece, delta=delta,
                delta_sum=delta_sum, prob=prob, v_piece=v_piece,
                v_mean=v_mean, reward=reward, done=done))
        seg = SherlockSegment(*[torch.stack(xs) for xs in zip(*ticks)])
        v_last = acting(env_state, last_key)[-2]
        if mark is not None:
            mark("forward")
        return env_state, seg, v_last

    return rollout


@dataclasses.dataclass(frozen=True)
class SherlockConfig:
    clipping_parameter: float = 0.15
    value_loss: float = 0.01
    policy_loss: float = 0.9
    entropy_loss: float = 0.0
    impossibility_loss: float = 0.1   # c4 (delta_ppo_nets)
    nn_regularizer: float = 1e-5
    lr: float = 1e-5
    gamma: float = 0.98
    gae_lambda: float = 0.7
    n_train_epochs: int = 2
    minibatch_size: int = 64


class SherlockBatch(NamedTuple):
    occ: torch.Tensor        # (B, 2, H) int32 bits
    vec: torch.Tensor        # (B, 2, 12)
    piece: torch.Tensor      # (B,)
    delta: torch.Tensor      # (B, H, W)
    delta_sum: torch.Tensor  # (B, H, W)
    old_prob: torch.Tensor   # (B,)
    advantage: torch.Tensor  # (B,)
    target_v: torch.Tensor   # (B,)


def sherlock_segment_to_batch(cfg: SherlockConfig, seg: SherlockSegment,
                              v_last, single_policy: bool = True):
    """GAE (sventon semantics; gamma negated for single-policy self-play)
    then flatten: (SherlockBatch, stats)."""
    gamma = -cfg.gamma if single_policy else cfg.gamma
    adv, tgt, stats = sventon_gae(seg.reward, seg.done, seg.v_piece,
                                  seg.v_mean, v_last, gamma=gamma,
                                  gae_lambda=cfg.gae_lambda)

    def flat(a):
        return a.reshape((-1,) + tuple(a.shape[2:]))
    return SherlockBatch(
        occ=flat(seg.occ), vec=flat(seg.vec), piece=flat(seg.piece),
        delta=flat(seg.delta), delta_sum=flat(seg.delta_sum),
        old_prob=flat(seg.prob), advantage=flat(adv), target_v=flat(tgt),
    ), stats


@dataclasses.dataclass
class SherlockState:
    net: torch.nn.Module
    optimizer: torch.optim.Adam
    update_count: int = 0


def sherlock_loss(engine_cfg: EngineConfig, cfg: SherlockConfig, net,
                  mb: SherlockBatch):
    """(loss, stats) of one minibatch: PPO clip on the phi.delta
    probability, value MSE, entropy of the coverage-weighted field, the
    impossibility loss and L2."""
    e = 1e-6
    grids = field_grid(engine_cfg, mb.occ)
    phi_all, v = net([mb.vec[:, 0, :], mb.vec[:, 1, :]],
                     [grids[:, 0, :, :, None], grids[:, 1, :, :, None]])
    idx = torch.arange(phi_all.shape[0], device=phi_all.device)
    piece = mb.piece.long()
    phi = phi_all[idx, :, :, piece]                     # (B, H, W)
    values = v[idx, piece] if v.shape[-1] > 1 else v[:, 0]
    num = torch.sum(phi * mb.delta, dim=(1, 2)) + e
    den = torch.sum(phi * mb.delta_sum, dim=(1, 2)) + e
    ratio = torch.clamp(num / den, min=e) / torch.clamp(mb.old_prob, min=e)
    clipped = torch.clamp(ratio, 1 - cfg.clipping_parameter,
                          1 + cfg.clipping_parameter)
    policy_obj = torch.minimum(ratio * mb.advantage, clipped * mb.advantage)
    imp = phi * (1.0 - torch.clamp(mb.delta_sum, max=1.0))
    dn = phi * mb.delta_sum
    dn = dn / (torch.sum(mb.delta_sum, dim=(1, 2), keepdim=True) + e) + e
    ent = -torch.sum(dn * torch.log(torch.clamp(dn, min=e)), dim=(1, 2))
    value_loss = cfg.value_loss * torch.mean((values - mb.target_v) ** 2)
    policy_loss = -cfg.policy_loss * torch.mean(policy_obj)
    entropy_loss = -cfg.entropy_loss * torch.mean(ent)
    imp_loss = cfg.impossibility_loss * torch.mean(imp)
    reg = cfg.nn_regularizer * 0.5 * sum(
        torch.sum(torch.square(w)) for w in net.parameters())
    loss = value_loss + policy_loss + entropy_loss + imp_loss + reg
    stats = {k: x.detach() for k, x in {
        "losses/total_loss": loss, "losses/value_loss": value_loss,
        "losses/policy_loss": -policy_loss,
        "losses/impossibility_loss": imp_loss,
        "entropy/entropy": torch.mean(ent)}.items()}
    return loss, stats


def sherlock_minibatches(cfg: SherlockConfig, n: int, key) -> torch.Tensor:
    """(epochs, n_mb, mb) indices: epoch k shuffles with JAX's
    permutation(split(key, epochs)[k], n); n_mb = max(n // mb, 1), mb =
    min(minibatch_size, n)."""
    mbs = min(cfg.minibatch_size, n)
    n_mb = max(n // cfg.minibatch_size, 1)
    return torch.stack([rng.permutation(k, n)[:n_mb * mbs].reshape(n_mb, mbs)
                        for k in rng.split(key, cfg.n_train_epochs)])


def make_sherlock_update(engine_cfg: EngineConfig, net: SherlockNet,
                         cfg: SherlockConfig):
    """Returns (init_fn(net) -> SherlockState, update_fn(state, batch, key)
    -> (state, stats)): epochs x minibatches of ``sherlock_loss`` with
    torch.optim.Adam (optax.adam's defaults)."""

    def init_fn(net=net) -> SherlockState:
        opt = torch.optim.Adam(net.parameters(), lr=cfg.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        return SherlockState(net=net, optimizer=opt)

    def update_fn(state: SherlockState, batch: SherlockBatch, key):
        stats = None
        for epoch in sherlock_minibatches(cfg, batch.piece.shape[0], key):
            for mi in epoch:
                mb = SherlockBatch(*[a.index_select(0, mi) for a in batch])
                loss, stats = sherlock_loss(engine_cfg, cfg, state.net, mb)
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                state.optimizer.step()
        state.update_count += 1
        return state, stats

    return init_fn, update_fn

