# Frozen copy of the 'silver' PPONet of drl_tetris_tpu_torch/models/nets.py at
# commit 0522b5deacbf29e64a07f002c2407ff1530df4d8 (ResidualBlock, KeyboardConv,
# SventonNet, PPONet and their helpers), part of the benchmark's plain
# reference.  Changed from the copy: no flax initialisers (the benchmark makes
# the weights), and the towers' compute is a ``precision`` instead of the
# config's dtype, so that one module serves as the float32 reference and as
# the lower-precision control.
"""PPONet over the 'silver' SventonNet trunk in plain PyTorch: pi is the
softmax over the (rotation, translation) plane per piece (B, 4, W, 7), v the
per-piece tanh values (B, 7).  The parameter names are the port's
``state_dict`` names, so one set of weights loads into both.

``precision``: "float32" computes everything in IEEE float32 (the
reference; TF32 must be off, ``ieee_float32``).  "fp8" is the control: every
tower conv takes its input and kernel rounded to float8 e4m3 (per-tensor
scale, amax at 448) and the towers carry bfloat16 between convs, one step
below the configuration's bfloat16 towers."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

VEC_DIM = 12
PRECISIONS = ("float32", "fp8")
FP8_MAX = 448.0


def ieee_float32() -> None:
    """Float32 convolutions and matmuls without TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448),
    returned in float32."""
    x = x.float()
    scale = (x.abs().amax() / FP8_MAX).clamp(min=1e-30)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def apply_visual_pad(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H+2, W+2, C): zero ceiling, one-valued walls and
    floor."""
    x = F.pad(x, (0, 0, 0, 0, 1, 0), value=0.0)
    return F.pad(x, (0, 0, 1, 1, 0, 1), value=1.0)


def peephole_join(x, y, mode: str = "concat", dim: int = -1):
    if mode in ("add", "truncate_add"):
        nx, ny = x.shape[dim], y.shape[dim]
        larger, smaller = (x, y) if nx > ny else (y, x)
        n = smaller.shape[dim]
        a = larger.narrow(dim, 0, n) + smaller
        if mode == "truncate_add":
            return a
        return torch.cat([a, larger.narrow(dim, n, larger.shape[dim] - n)],
                         dim=dim)
    return torch.cat([x, y], dim=dim)


def join_channels(c_conv: int, c_in: int, mode: str) -> int:
    if mode == "add":
        return max(c_conv, c_in)
    if mode == "truncate_add":
        return min(c_conv, c_in)
    return c_conv + c_in


def action_softmax(x: torch.Tensor) -> torch.Tensor:
    m = torch.amax(x, dim=(1, 2), keepdim=True)
    e = torch.exp(x - m)
    return e / torch.sum(e, dim=(1, 2), keepdim=True)


class ResidualBlock(nn.Module):
    """Layer i: conv (same padding) -> peephole join with the layer input
    -> [LayerNorm on a truncate_add output layer] -> activation ->
    [avg-pool, window clamped to the map size]."""

    def __init__(self, in_channels: int, n_layers: int, n_filters: int,
                 filter_size, precision: str, pools: bool = False,
                 pool_size=(3, 2), output_n_filters: Optional[int] = None,
                 output_activation: Optional[str] = "elu",
                 normalization: Optional[str] = None,
                 output_layer: bool = False):
        super().__init__()
        self.precision = precision
        self.pools, self.pool_size = pools, tuple(pool_size)
        self.convs = nn.ModuleList()
        self.modes, self.acts = [], []
        self.norm = None
        c = in_channels
        for i in range(n_layers):
            n, act, mode, normalize = n_filters, "elu", "add", False
            if i == n_layers - 1:
                act = output_activation
                if output_n_filters is not None:
                    n, mode = output_n_filters, "truncate_add"
                    normalize = normalization is not None
                if output_layer:
                    normalize = False
            fh, fw = filter_size
            self.convs.append(nn.Conv2d(c, n, (fh, fw),
                                        padding=(fh // 2, fw // 2)))
            c = join_channels(n, c, mode)
            if normalize:
                self.norm = nn.LayerNorm(c, eps=1e-6)
            self.modes.append(mode)
            self.acts.append(act)
        self.out_channels = c

    def _conv(self, x, conv):
        if self.precision == "fp8":
            y = F.conv2d(fp8_round(x), fp8_round(conv.weight), None, 1,
                         conv.padding).to(torch.bfloat16)
            return y + conv.bias.to(torch.bfloat16)[None, :, None, None]
        return F.conv2d(x, conv.weight, conv.bias, 1, conv.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            y = x
            x = peephole_join(self._conv(x, conv), y, self.modes[i], dim=1)
            if i == last and self.norm is not None:
                x = self.norm(x.float().permute(0, 2, 3, 1)).permute(
                    0, 3, 1, 2)
            if self.acts[i] == "elu":
                x = F.elu(x)
            elif self.acts[i] == "tanh":
                x = torch.tanh(x)
            if self.pools:
                h, w = x.shape[2:]
                ph, pw = min(self.pool_size[0], h), min(self.pool_size[1], w)
                x = F.avg_pool2d(x, (ph, pw), stride=(ph, pw))
        return x


class KeyboardConv(nn.Module):
    """A full-height, 3-wide VALID conv whose output channels are
    (rotation x piece) maps aligned to board columns; (B, R, W, P)."""

    def __init__(self, in_channels: int, height: int, n_rot: int,
                 n_pieces: int):
        super().__init__()
        self.n_rot, self.n_pieces = n_rot, n_pieces
        self.conv = nn.Conv2d(in_channels, n_rot * n_pieces, (height, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        b, _, _, w = x.shape
        return x.reshape(b, self.n_rot, self.n_pieces, w).permute(0, 1, 3, 2)


class SventonNet(nn.Module):
    """Per-perspective visual towers, vector planes joined in, a second
    tower, the advantage tower with the keyboard head and the pooled value
    tower.  Returns raw (V (B, P+1 centred and tanh'd -> (B, P)), A)."""

    def __init__(self, m: dict, board, precision: str):
        super().__init__()
        tower = dict(n_layers=m["tower_layers"], n_filters=m["tower_filters"],
                     filter_size=(m["tower_filter_size"],) * 2,
                     precision=precision)
        self.precision = precision
        self.vis_tower = nn.ModuleList(
            [ResidualBlock(1, **tower) for _ in range(2)])
        c_join = VEC_DIM + self.vis_tower[0].out_channels
        self.join_tower = nn.ModuleList(
            [ResidualBlock(c_join, **tower) for _ in range(2)])
        c_joined = self.join_tower[0].out_channels
        self.adv_tower = ResidualBlock(
            join_channels(VEC_DIM, c_joined, "add"), output_activation=None,
            **tower)
        h, w = board
        self.kbd = KeyboardConv(self.adv_tower.out_channels, h + 2,
                                m["n_rotations"], m["n_pieces"])
        self.value_tower = ResidualBlock(
            2 * c_joined + 2, n_layers=m["val_layers"],
            n_filters=m["val_filters"],
            filter_size=(m["val_filter_size"],) * 2, pools=True,
            output_n_filters=m["n_pieces"] + 1, output_activation=None,
            output_layer=True, normalization="layer", precision=precision)
        mask = torch.tensor([1.0 if p in m["used_pieces"] else 0.0
                             for p in range(7)])
        self.register_buffer("piece_mask", mask, persistent=False)

    def forward(self, vec, vis):
        dt = torch.bfloat16 if self.precision == "fp8" else torch.float32
        vis = [apply_visual_pad(v).permute(0, 3, 1, 2).to(dt) for v in vis]
        vec = [v.to(dt) for v in vec]
        hidden = [t(v) for t, v in zip(self.vis_tower, vis)]
        h, w = hidden[0].shape[2:]
        vecp = [v[:, :, None, None].expand(v.shape[0], v.shape[1], h, w)
                for v in vec]
        joined = [t(torch.cat([vp, hv], dim=1))
                  for t, vp, hv in zip(self.join_tower, vecp, hidden)]
        a = self.adv_tower(peephole_join(joined[0], vecp[1], "add", dim=1))
        raw_a = self.kbd(a.float())
        v = self.value_tower(torch.cat(joined + vis, dim=1))
        v = v.float().mean(dim=(2, 3))
        base, offs = v[:, :1], v[:, 1:]
        mask = self.piece_mask[None, :]
        mean = (offs.mean(-1, keepdim=True) * mask).sum(
            -1, keepdim=True) / mask.sum()
        return torch.tanh(base + (offs - mean)), raw_a


class PPONet(nn.Module):
    """pi (B, R, W, P) and v (B, P) of the 'silver' trunk; ``model`` is the
    configuration file's "model" object."""

    def __init__(self, model: dict, board, precision: str = "float32"):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}")
        if model["architecture"] != "silver" or model["visual_stack"] \
                or not model["separate_piece_values"]:
            raise ValueError("the reference holds the 'silver' trunk with "
                             "separate piece values and no visual stack")
        self.trunk = SventonNet(model, tuple(board), precision)

    def forward(self, vec, vis):
        v, raw_a = self.trunk(vec, vis)
        return action_softmax(raw_a), v
