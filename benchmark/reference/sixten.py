# Frozen copy of ``VNet``, the top-drop ``choose`` of ``_sixten_stages``,
# ``v_of`` and ``sixten_loss`` of drl_tetris_tpu_torch/algos/sixten.py at
# commit 19b7261806ffa5740b75ff89fdfc53fa8692c191, part of the benchmark's
# plain reference.  Changed from the copy: no flax initialisers (the
# benchmark makes the weights), the towers' compute is a ``precision``
# (benchmark/reference/nets.py), the choice is split into the successors'
# values, the explore draw and the gap of a given choice, and the
# gradient and Adam's step are written out.
"""SIXten in plain PyTorch: the value net (the 'silver' trunk without its
action head, per-piece tanh values), V over every top-drop successor of the
acting piece, the epsilon draw, and the update's loss (IS-weighted MSE on
V(s | piece) plus L2), its gradient, the new priorities |v - target| and
one Adam step (torch.optim.Adam's update with its defaults)."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn

from benchmark.reference import rng
from benchmark.reference.core import EngineConfig
from benchmark.reference.env import EnvState
from benchmark.reference.nets import (PRECISIONS, VEC_DIM, ResidualBlock,
                                      apply_visual_pad)
from benchmark.reference.observations import field_grid, observe
from benchmark.reference.placement import acting_player, top_drop_boards


class VNet(nn.Module):
    """v (B, P) of the 'silver' trunk's value tower; ``model`` is the
    configuration file's "model" object.  The parameter names are the
    port's ``state_dict`` names, in the same order."""

    def __init__(self, model: dict, board, precision: str = "float32"):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}")
        if model["architecture"] != "silver" or model["visual_stack"] \
                or not model["separate_piece_values"]:
            raise ValueError("the reference holds the 'silver' trunk with "
                             "separate piece values and no visual stack")
        self.precision = precision
        tower = dict(n_layers=model["tower_layers"],
                     n_filters=model["tower_filters"],
                     filter_size=(model["tower_filter_size"],) * 2,
                     precision=precision)
        self.vis_tower = nn.ModuleList(
            [ResidualBlock(1, **tower) for _ in range(2)])
        c_join = VEC_DIM + self.vis_tower[0].out_channels
        self.join_tower = nn.ModuleList(
            [ResidualBlock(c_join, **tower) for _ in range(2)])
        self.value_tower = ResidualBlock(
            2 * self.join_tower[0].out_channels + 2,
            n_layers=model["val_layers"], n_filters=model["val_filters"],
            filter_size=(model["val_filter_size"],) * 2, pools=True,
            output_n_filters=model["n_pieces"] + 1, output_activation=None,
            output_layer=True, normalization="layer", precision=precision)
        mask = torch.tensor([1.0 if p in model["used_pieces"] else 0.0
                             for p in range(7)])
        self.register_buffer("piece_mask", mask, persistent=False)

    def forward(self, vec, vis):
        dt = torch.bfloat16 if self.precision == "fp8" else torch.float32
        vis = [apply_visual_pad(v).permute(0, 3, 1, 2).to(dt) for v in vis]
        vec = [v.to(dt) for v in vec]
        hidden = [t(v) for t, v in zip(self.vis_tower, vis)]
        h, w = hidden[0].shape[2:]
        joined = [t(torch.cat([v[:, :, None, None].expand(
            v.shape[0], v.shape[1], h, w), hv], dim=1))
            for t, v, hv in zip(self.join_tower, vec, hidden)]
        v = self.value_tower(torch.cat(joined + vis, dim=1))
        v = v.float().mean(dim=(2, 3))
        base, offs = v[:, :1], v[:, 1:]
        mask = self.piece_mask[None, :]
        mean = (offs.mean(-1, keepdim=True) * mask).sum(
            -1, keepdim=True) / mask.sum()
        return torch.tanh(base + (offs - mean))


def values(net, vec, vis, chunk: int) -> torch.Tensor:
    """The net over (B, ...) inputs in chunks of ``chunk`` rows on the
    net's device, without autograd: (B, P) float32."""
    dev = next(net.parameters()).device
    out = []
    with torch.no_grad():
        for s in range(0, vec[0].shape[0], chunk):
            out.append(net([v[s:s + chunk].to(dev) for v in vec],
                           [v[s:s + chunk].to(dev) for v in vis]).float())
    return torch.cat(out)


def successors(cfg: EngineConfig, state: EnvState):
    """(mask (N, 4W), the successors' inputs ([vec_me, vec_opp], [grid_me,
    grid_opp]) flat (N * 4W, ...), the next piece (N,)) of the acting
    player's top-drop placements: the acting board replaced by the board
    after the placement, the next-piece one-hot zeroed (not drawn yet)."""
    a = acting_player(state)
    mask, after = top_drop_boards(cfg, a["occ"], a["garb"], a["piece"],
                                  a["rot"])
    obs = observe(cfg, state.engine, state.current_player)
    n, k = mask.shape[0], mask[0].numel()
    vec_me = obs.vec[:, 0:1, :].expand(n, k, VEC_DIM).clone()
    vec_me[:, :, 5:] = 0.0
    vec_opp = obs.vec[:, 1:2, :].expand(n, k, VEC_DIM)
    vis_opp = obs.vis[:, 1:2].expand((n, k) + obs.vis.shape[2:])
    grid = field_grid(cfg, after.reshape(n * k, cfg.height))[..., None]
    return (mask.reshape(n, k),
            ([vec_me.reshape(n * k, VEC_DIM), vec_opp.reshape(n * k, VEC_DIM)],
             [grid, vis_opp.reshape((n * k,) + obs.vis.shape[2:])]),
            a["nextpiece"])


def successor_values(cfg: EngineConfig, net, state: EnvState,
                     chunk: int = 4096):
    """(mask (N, K), V of each successor for the piece that acts in it
    (N, K), the successors' piece-mean V (N, K)), K = 4W."""
    mask, (vec, vis), nxt = successors(cfg, state)
    n, k = mask.shape
    v = values(net, vec, vis, chunk).reshape(n, k, -1)
    nxt = nxt.to(v.device).long()
    v_next = v.gather(2, nxt[:, None, None].expand(n, k, 1))[..., 0]
    return mask.to(v.device), v_next, v.mean(-1)


def explore(key: torch.Tensor, mask: torch.Tensor, epsilon: float):
    """(explores (N,), the uniform legal pick (N,)) of epsilon's draw from
    a tick's key: split into (kexp, kpick), u = uniform(kexp) < epsilon
    in float32, the pick the argmax of log(legal) plus gumbel(kpick)."""
    kexp, kpick = rng.split(rng.u32(key).to(mask.device))
    n = mask.shape[0]
    u = rng.uniform01(kexp, (n,))
    eps = torch.tensor(epsilon, dtype=torch.float32, device=u.device)
    g = rng.gumbel(kpick, tuple(mask.shape))
    return u < eps, torch.argmax(g + torch.log(mask.float()), dim=-1)


def choose(mask, v_next, explores, pick) -> torch.Tensor:
    """The policy's choice: the best legal successor, or the uniform pick
    where it explores; 0 where nothing is legal."""
    greedy = torch.argmax(torch.where(mask, v_next, -torch.inf), dim=1)
    choice = torch.where(explores, pick, greedy)
    return torch.where(mask.any(1), choice, 0)


def legal_prob(mask: torch.Tensor) -> torch.Tensor:
    """1 / the number of legal placements, 1 where there is none."""
    count = mask.sum(1)
    return torch.where(count > 0, 1.0 / torch.clamp(count, min=1), 1.0
                       ).to(torch.float32)


def v_of(cfg: EngineConfig, net, occ, vec, piece) -> torch.Tensor:
    """V(s | piece) (B,) of stored states (occ (B, 2, H), vec (B, 2, 12))."""
    grids = field_grid(cfg, occ)
    v = net([vec[:, 0, :], vec[:, 1, :]],
            [grids[:, 0, :, :, None], grids[:, 1, :, :, None]])
    return v[torch.arange(v.shape[0], device=v.device), piece.long()]


def loss_and_prios(cfg: EngineConfig, nn_regularizer: float, net, occ, vec,
                   piece, target, weights) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(loss, new priorities |v - target|) of one minibatch: mean(w (v -
    target)^2) + nn_regularizer / 2 * the sum of every parameter's
    square."""
    v = v_of(cfg, net, occ, vec, piece)
    err = v - target
    reg = nn_regularizer * 0.5 * sum(torch.sum(torch.square(w))
                                     for w in net.parameters())
    return torch.mean(weights * err ** 2) + reg, err.detach().abs()


def gradient(cfg: EngineConfig, nn_regularizer: float, net, occ, vec,
             piece, target, weights
             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """({parameter name: d loss / d parameter}, new priorities) of one
    minibatch at the net's weights."""
    net.zero_grad(set_to_none=True)
    loss, prios = loss_and_prios(cfg, nn_regularizer, net, occ, vec, piece,
                                 target, weights)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
    net.zero_grad(set_to_none=True)
    return grads, prios


def adam_step(param, grad, exp_avg, exp_avg_sq, step: int, lr: float,
              betas=(0.9, 0.999), eps: float = 1e-8):
    """One Adam step of one tensor (torch.optim.Adam, no weight decay, not
    amsgrad): the moments updated in place, step the count after it;
    returns the new parameter."""
    b1, b2 = betas
    exp_avg.mul_(b1).add_(grad, alpha=1 - b1)
    exp_avg_sq.mul_(b2).addcmul_(grad, grad, value=1 - b2)
    bias1 = 1 - b1 ** step
    bias2 = 1 - b2 ** step
    denom = (exp_avg_sq.sqrt() / math.sqrt(bias2)).add_(eps)
    return param - (lr / bias1) * exp_avg / denom
