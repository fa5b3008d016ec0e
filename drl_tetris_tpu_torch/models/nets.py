"""PPONet (policy softmax, per-piece tanh values) and QNet (the dueling Q
head) over the four trunks of the architecture registry, as PyTorch
modules.

Counterpart of ``drl_tetris_tpu/models/nets.py`` (reference: build_blocks.py,
sventon_architectures.py, network_utils.py of the TF1 original).  Public
functions keep the JAX package's layout: ``vis`` is ``(B, H, W, 1)``,
``pi`` is ``(B, 4, W, 7)``; the modules run NCHW inside and permute at the
boundary.  Convolutions are plain ``F.conv2d`` (cuDNN on the card), as the
JAX package left them to XLA.

Compute dtype: with ``compute_dtype='bfloat16'`` (the default) the towers
run in bfloat16 with float32 parameters cast at each conv, as flax does
(``promote_dtype``: input, kernel and bias in bf16, bias added after the
conv), and the heads run in float32.  The cast is explicit; no autocast.

The registry (``make_trunk``, network.py:25-32): 'silver' is SventonNet
with the keyboard-conv head; 'dreamer' the same trunk with a dense action
head over the flattened advantage stream; 'vanilla' ConvThenDense and
'keyboard' ConvKeyboard, small conv encoders with dense heads, which run
in float32 whatever ``compute_dtype`` says (their flax modules take no
dtype).  The residual blocks accept a dropout rate and do not apply it:
every path of the port (rollouts, updates, targets, evaluation) runs the
nets deterministically, as the JAX package's trainers do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from drl_tetris_tpu_torch import resolve_device
from drl_tetris_tpu_torch.models.flax_init import FlaxInit

ARCHITECTURES = ("silver", "vanilla", "keyboard", "dreamer")
VEC_DIM = 12          # per-perspective scalar observation (env/observations)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """resblock_kbd settings (experiments/sventon_ppo.py:46-58 defaults),
    the JAX package's ModelConfig; ``architecture`` picks the trunk."""
    compute_dtype: str = "bfloat16"
    architecture: str = "silver"
    n_rotations: int = 4
    n_pieces: int = 7
    tower_layers: int = 5
    tower_filters: int = 64
    tower_filter_size: int = 3
    val_layers: int = 6
    val_filters: int = 128
    val_filter_size: int = 5
    dropout: float = 0.0
    separate_piece_values: bool = True
    visual_stack: Tuple[str, ...] = ()
    used_pieces: Tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6)

    def __post_init__(self):
        if self.architecture not in ARCHITECTURES:
            raise ValueError(
                f"unknown architecture {self.architecture!r}; "
                f"expected one of {ARCHITECTURES} (network.py:25-32)")

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32

    @property
    def piece_mask(self) -> torch.Tensor:
        return torch.tensor([1.0 if p in self.used_pieces else 0.0
                             for p in range(7)])


# ---------------------------------------------------------------------------
# Utility layers (network_utils.py); ``dim`` is the channel axis, -1 in the
# JAX layout, 1 inside the modules
# ---------------------------------------------------------------------------

def apply_visual_pad(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H+2, W+2, C): zero ceiling, one-valued walls and
    floor."""
    x = F.pad(x, (0, 0, 0, 0, 1, 0), value=0.0)
    return F.pad(x, (0, 0, 1, 1, 0, 1), value=1.0)


def visual_stack(x: torch.Tensor, items: Sequence[str]) -> torch.Tensor:
    """Feature planes derived from an NCHW field (network_utils.py:79-93)."""
    cumsum = torch.cumsum(x, dim=2)
    shadow = torch.clamp(cumsum, max=1.0)
    height = torch.arange(x.shape[2], dtype=x.dtype, device=x.device
                          ).reshape(1, 1, -1, 1).expand(x.shape)
    table = {"cumsum": cumsum, "shadow": shadow, "height": height,
             "holes": shadow - x}
    return torch.cat([x] + [table[k] for k in items], dim=1)


def peephole_join(x, y, mode: str = "concat", dim: int = -1):
    """network_utils.py:52-64: 'add' adds the smaller tensor onto the
    leading channels of the larger and keeps the rest, 'truncate_add' keeps
    only the sum, 'concat' concatenates."""
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
    """Channels out of peephole_join(conv(c_in -> c_conv), input)."""
    if mode == "add":
        return max(c_conv, c_in)
    if mode == "truncate_add":
        return min(c_conv, c_in)
    return c_conv + c_in


def conv_shape_vector(vec: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Tile (B, K) into (B, h, w, K) planes (JAX layout)."""
    return vec[:, None, None, :].expand(vec.shape[0], h, w, vec.shape[1])


def _init_layer(layer: nn.Module, init: FlaxInit, kernel: str =
                "lecun_normal"):
    """A Linear or Conv2d as flax initialises it: ``kernel``
    (lecun_normal, flax's default, or glorot_uniform) and a zero bias."""
    getattr(init, kernel)(layer.weight)
    init.zeros(layer.bias)


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W*C) in flax's (h, w, c) order, so that a
    dense layer's rows line up with the JAX package's."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def action_softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the (rotation, translation) plane per piece; x is
    (B, R, T, P)."""
    m = torch.amax(x, dim=(1, 2), keepdim=True)
    e = torch.exp(x - m)
    return e / torch.sum(e, dim=(1, 2), keepdim=True)


def normalize_advantages(a: torch.Tensor, piece_mask=None,
                         mode: str = "mean",
                         separate_piece_values: bool = True,
                         activation=None) -> torch.Tensor:
    """Dueling normalization over the action plane (network_utils.py:8-35);
    a is (B, R, T, P), piece_mask (P,) or None."""
    n_used = 7.0 if piece_mask is None else piece_mask.sum()
    mask = 1.0 if piece_mask is None else piece_mask.reshape(1, 1, 1, -1)
    if mode == "max":
        all_min = torch.amin(a, dim=(1, 2, 3), keepdim=True)
        am = mask * a + (1.0 - mask) * all_min
        mx = torch.amax(am, dim=(1, 2), keepdim=True)
        if not separate_piece_values:
            mx = torch.sum(mx * mask, dim=3, keepdim=True) / n_used
        a = a - mx
    elif mode == "mean":
        mean = torch.mean(a, dim=(1, 2), keepdim=True)
        mean = torch.sum(mean * mask, dim=3, keepdim=True) / n_used
        a = a - mean
    if activation is not None:
        a = activation(a)
    return a


def q_to_v(q: torch.Tensor, piece_mask=None) -> torch.Tensor:
    """network_utils.py:95-98: the piece-mean of each piece's best Q,
    (B, 1)."""
    n_used = 7.0 if piece_mask is None else piece_mask.sum()
    mask = 1.0 if piece_mask is None else piece_mask.reshape(1, 1, 1, -1)
    qp = torch.amax(q, dim=(1, 2), keepdim=True)
    v = torch.sum(qp * mask, dim=3, keepdim=True) / n_used
    return v.reshape(-1, 1)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

class ResidualBlock(nn.Module):
    """build_blocks.py:8-64, layer for layer, NCHW.  Layer i: conv (same
    padding) -> peephole join with the layer input -> [LayerNorm on a
    truncate_add output layer] -> activation -> [spatial dropout] ->
    [avg-pool, window clamped to the map size].  The dropout rate is
    checked and not applied: every path runs the block deterministically,
    as the JAX package's trainers run flax's ``Dropout``."""

    def __init__(self, in_channels: int, n_layers: int = 3,
                 n_filters: int = 128, filter_size=(3, 3),
                 peepholes: bool = True, pools: bool = False,
                 pool_size=(3, 2), output_n_filters: Optional[int] = None,
                 output_activation: Optional[str] = "elu",
                 normalization: Optional[str] = None,
                 output_layer: bool = False, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout rate {dropout} outside [0, 1)")
        self.peepholes, self.pools = peepholes, pools
        self.output_layer = output_layer
        self.pool_size = tuple(pool_size)
        self.dtype = dtype
        self.convs = nn.ModuleList()
        self.modes, self.acts = [], []
        self.norm = None
        c = in_channels
        for i in range(n_layers):
            n, act, mode, normalize = n_filters, "elu", "add", False
            last = i == n_layers - 1
            if last:
                act = output_activation
                if output_n_filters is not None:
                    n, mode = output_n_filters, "truncate_add"
                    normalize = normalization is not None
                if output_layer:
                    normalize = False
            fh, fw = filter_size
            self.convs.append(nn.Conv2d(c, n, (fh, fw),
                                        padding=(fh // 2, fw // 2)))
            c = join_channels(n, c, mode) if peepholes else n
            if normalize:
                self.norm = nn.LayerNorm(c, eps=1e-6)
            self.modes.append(mode)
            self.acts.append(act)
        self.out_channels = c

    def init_flax_(self, init: FlaxInit):
        """flax's initialisers (drl_tetris_tpu/models/nets.py:149-166):
        glorot_uniform kernels, normal(0.01) on the last two of an output
        block, zero biases, LayerNorm weight 1 and bias 0."""
        n = len(self.convs)
        for i, conv in enumerate(self.convs):
            if self.output_layer and i >= n - 2:
                init.normal(conv.weight, 0.01)
            else:
                init.glorot_uniform(conv.weight)
            init.zeros(conv.bias)
        if self.norm is not None:
            init.ones(self.norm.weight)
            init.zeros(self.norm.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            y = x
            x = F.conv2d(x.to(dt), conv.weight.to(dt), None, 1, conv.padding)
            x = x + conv.bias.to(dt)[None, :, None, None]
            if self.peepholes:
                x = peephole_join(x, y, self.modes[i], dim=1)
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
    """build_blocks.py:68-83: a full-height, 3-wide VALID conv whose output
    channels are (rotation x piece) maps aligned to board columns; returns
    (B, R, W, P)."""

    def __init__(self, in_channels: int, height: int, n_rot: int = 4,
                 n_pieces: int = 7):
        super().__init__()
        self.n_rot, self.n_pieces = n_rot, n_pieces
        self.conv = nn.Conv2d(in_channels, n_rot * n_pieces, (height, 3))

    def init_flax_(self, init: FlaxInit):
        """A zero kernel and a normal(1e-5) bias, as flax's KeyboardConv:
        the policy starts uniform."""
        init.zeros(self.conv.weight)
        init.normal(self.conv.bias, 1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)                            # (B, R*P, 1, W)
        b, _, _, w = x.shape
        return x.reshape(b, self.n_rot, self.n_pieces, w).permute(0, 1, 3, 2)


# ---------------------------------------------------------------------------
# The architecture
# ---------------------------------------------------------------------------

class SventonNet(nn.Module):
    """resblock_kbd (sventon_architectures.py:23-73): per-perspective
    visual towers, vector planes joined in, a second tower, the advantage
    tower with the keyboard head and (trainer side) the pooled value
    tower.  Returns raw (V (B,1,1,P|1), A (B,R,W,P)).

    ``kbd_head=False`` is 'dreamer': a dense action head (glorot-uniform
    kernel) over the flattened float32 advantage stream in place of the
    keyboard conv (drl_tetris_tpu/models/nets.py:302-310)."""

    def __init__(self, cfg: ModelConfig, board=(22, 10),
                 full_network: bool = True, kbd_head: bool = True):
        super().__init__()
        self.cfg, self.full_network = cfg, full_network
        self.kbd_head = kbd_head
        dt = cfg.torch_dtype
        tower = dict(n_layers=cfg.tower_layers, n_filters=cfg.tower_filters,
                     filter_size=(cfg.tower_filter_size,) * 2,
                     dropout=cfg.dropout, dtype=dt)
        c_vis = 1 + len(cfg.visual_stack)
        self.vis_tower = nn.ModuleList(
            [ResidualBlock(c_vis, **tower) for _ in range(2)])
        c_join = VEC_DIM + self.vis_tower[0].out_channels
        self.join_tower = nn.ModuleList(
            [ResidualBlock(c_join, **tower) for _ in range(2)])
        c_joined = self.join_tower[0].out_channels
        self.adv_tower = ResidualBlock(
            join_channels(VEC_DIM, c_joined, "add"),
            output_activation=None, **tower)
        c_adv = self.adv_tower.out_channels
        h, w = board
        if kbd_head:
            self.kbd = KeyboardConv(c_adv, h + 2, cfg.n_rotations,
                                    cfg.n_pieces)
        else:
            self.a_dense = nn.Linear((h + 2) * (w + 2) * c_adv,
                                     cfg.n_rotations * w * cfg.n_pieces)
        self.acting = ("vis_tower", "join_tower", "adv_tower",
                       "kbd" if kbd_head else "a_dense")
        if full_network:
            self.value_tower = ResidualBlock(
                2 * c_joined + 2 * c_vis, n_layers=cfg.val_layers,
                n_filters=cfg.val_filters,
                filter_size=(cfg.val_filter_size,) * 2, pools=True,
                output_n_filters=(cfg.n_pieces + 1
                                  if cfg.separate_piece_values else 1),
                output_activation=None, output_layer=True,
                normalization="layer", dropout=cfg.dropout, dtype=dt)
        # a buffer, not a parameter (the L2 term sees exactly the flax
        # leaves), and not in the state_dict; it moves with the module, so
        # the forward copies nothing from the host
        self.register_buffer("piece_mask", cfg.piece_mask, persistent=False)

    def init_flax_(self, init: FlaxInit):
        for m in self.modules():
            if isinstance(m, (ResidualBlock, KeyboardConv)):
                m.init_flax_(init)
        if not self.kbd_head:
            _init_layer(self.a_dense, init, "glorot_uniform")

    def forward(self, vec, vis):
        c = self.cfg
        dt = c.torch_dtype
        vis = [apply_visual_pad(v).permute(0, 3, 1, 2) for v in vis]
        if c.visual_stack:
            vis = [visual_stack(v, c.visual_stack) for v in vis]
        vis = [v.to(dt) for v in vis]
        vec = [v.to(dt) for v in vec]
        hidden = [t(v) for t, v in zip(self.vis_tower, vis)]
        h, w = hidden[0].shape[2:]
        vecp = [v[:, :, None, None].expand(v.shape[0], v.shape[1], h, w)
                for v in vec]
        joined = [t(torch.cat([vp, hv], dim=1))
                  for t, vp, hv in zip(self.join_tower, vecp, hidden)]
        a = self.adv_tower(peephole_join(joined[0], vecp[1], "add", dim=1))
        a = a.float()
        if self.kbd_head:
            raw_a = self.kbd(a)
        else:
            raw_a = self.a_dense(_flatten_nhwc(a)).reshape(
                a.shape[0], c.n_rotations, w - 2, c.n_pieces)
        if not self.full_network:
            return torch.zeros(vec[0].shape[0], 1, 1, 1,
                               device=raw_a.device), raw_a
        v = self.value_tower(torch.cat(joined + vis, dim=1))
        v = v.float().mean(dim=(2, 3))                   # (B, P+1 | 1)
        if v.shape[-1] > 1:
            base, offs = v[:, :1], v[:, 1:]
            mask = self.piece_mask[None, :]
            mean = (offs.mean(-1, keepdim=True) * mask).sum(
                -1, keepdim=True) / mask.sum()
            v = torch.tanh(base + (offs - mean))
        else:
            v = torch.tanh(v)
        return v[:, None, None, :], raw_a


# the legacy trunks' widths, fixed as in JAX (its module fields' defaults,
# which nothing there overrides)
VEC_HIDDEN, VEC_OUT = 256, 32      # dense encoder of the 12 scalars
CONV_FILTERS = (16, 32, 32, 4)     # the field's convs: 7x7, then 3x3
VALUE_HIDDEN = 256
N_TRANSLATIONS = 10                # 'vanilla''s action plane columns


class _DenseEncoders(nn.Module):
    """What ConvThenDense and ConvKeyboard share: per perspective a
    two-layer dense encoder of the 12 scalars and a four-conv encoder of
    the padded field (CONV_FILTERS, kernels 7x7 then 3x3, same padding,
    elu, ``conv_in`` input channels each), and the trunk's dense layers,
    all float32 with flax's default initialisers (lecun-normal kernels,
    zero biases)."""

    def __init__(self, conv_in):
        super().__init__()
        self.vec_enc = nn.ModuleList(
            [nn.ModuleList([nn.Linear(VEC_DIM, VEC_HIDDEN),
                            nn.Linear(VEC_HIDDEN, VEC_OUT)])
             for _ in range(2)])
        self.vis_enc = nn.ModuleList(
            [nn.ModuleList([nn.Conv2d(ci, co, 7 if i == 0 else 3,
                                      padding=3 if i == 0 else 1)
                            for i, (ci, co) in enumerate(zip(conv_in,
                                                             CONV_FILTERS))])
             for _ in range(2)])

    def init_flax_(self, init: FlaxInit):
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                _init_layer(m, init)


class ConvThenDense(_DenseEncoders):
    """'vanilla', the legacy convthendense (sventon_architectures.py:
    95-118, repaired as in drl_tetris_tpu/models/nets.py:341-385): dense
    vector encoders (relu), conv encoders with a 2x2 max-pool after the
    first conv, everything flattened and joined; a dense value head (tanh,
    piece offsets centred) and a dense (R * 10 * P) advantage head.  The
    action plane has N_TRANSLATIONS = 10 columns whatever the board's
    width, as in JAX."""

    def __init__(self, cfg: ModelConfig, board=(22, 10),
                 full_network: bool = True):
        super().__init__((1,) + CONV_FILTERS[:-1])
        self.cfg, self.full_network = cfg, full_network
        h, w = math.ceil((board[0] + 2) / 2), math.ceil((board[1] + 2) / 2)
        n_flat = 2 * VEC_OUT + 2 * h * w * CONV_FILTERS[-1]
        if full_network:
            self.value_hidden = nn.Linear(n_flat, VALUE_HIDDEN)
            self.value_out = nn.Linear(
                VALUE_HIDDEN,
                cfg.n_pieces + 1 if cfg.separate_piece_values else 1)
        self.a_dense = nn.Linear(
            n_flat, cfg.n_rotations * N_TRANSLATIONS * cfg.n_pieces)
        self.acting = ("vec_enc", "vis_enc", "a_dense")

    def init_flax_(self, init: FlaxInit):
        """The A head is glorot-uniform."""
        super().init_flax_(init)
        _init_layer(self.a_dense, init, "glorot_uniform")

    def forward(self, vec, vis):
        c = self.cfg
        hidden = [l1(F.relu(l0(v.float())))
                  for (l0, l1), v in zip(self.vec_enc, vec)]
        for convs, v in zip(self.vis_enc, vis):
            x = apply_visual_pad(v.float()).permute(0, 3, 1, 2)
            for i, conv in enumerate(convs):
                x = F.elu(conv(x))
                if i == 0:          # flax's SAME max-pool: partial windows
                    x = F.max_pool2d(x, 2, 2, ceil_mode=True)
            hidden.append(_flatten_nhwc(x))
        x = torch.cat(hidden, dim=-1)
        if self.full_network:
            v = torch.tanh(self.value_out(F.elu(self.value_hidden(x))))
        else:
            v = torch.zeros(x.shape[0], 1, device=x.device)
        raw_v = v.reshape(v.shape[0], 1, 1, -1)
        if raw_v.shape[-1] > 1:
            base, offs = raw_v[..., :1], raw_v[..., 1:]
            raw_v = base + (offs - offs.mean(dim=3, keepdim=True))
        raw_a = self.a_dense(x).reshape(-1, c.n_rotations, N_TRANSLATIONS,
                                        c.n_pieces)
        return raw_v, raw_a


def advantage_activation_sqrt(x: torch.Tensor) -> torch.Tensor:
    """network_utils.advantage_activation_sqrt: sign-preserving sqrt."""
    return torch.sign(x) * torch.sqrt(torch.abs(x) + 1e-12)


class ConvKeyboard(_DenseEncoders):
    """'keyboard', the legacy convkeyboard (sventon_architectures.py:75-93,
    repaired as in drl_tetris_tpu/models/nets.py:393-447): dense vector
    encoders (elu, tanh out), conv encoders whose first three layers
    concatenate their input (peepholes) with a (2, 1) max-pool after the
    third, a keyboard-conv action head on my encoding, and a dense value
    head (tanh value plus centred, sqrt-activated piece offsets)."""

    PEEPHOLE_LAYERS = (0, 1, 2)
    POOL_AFTER = 2

    def __init__(self, cfg: ModelConfig, board=(22, 10),
                 full_network: bool = True):
        c, conv_in = 1, []
        for i, f in enumerate(CONV_FILTERS):
            conv_in.append(c)
            c = c + f if i in self.PEEPHOLE_LAYERS else f
        super().__init__(conv_in)
        self.cfg, self.full_network = cfg, full_network
        h, w = math.ceil((board[0] + 2) / 2), board[1] + 2
        self.kbd = KeyboardConv(c, h, cfg.n_rotations, cfg.n_pieces)
        n_flat = 2 * VEC_OUT + 2 * h * w * c
        if full_network:
            self.value_hidden = nn.Linear(n_flat, VALUE_HIDDEN)
            self.value_out = nn.Linear(VALUE_HIDDEN, 1)
            if cfg.separate_piece_values:
                self.value_pieces = nn.Linear(VALUE_HIDDEN, 7)
        self.acting = ("vec_enc", "vis_enc", "kbd")

    def init_flax_(self, init: FlaxInit):
        super().init_flax_(init)
        self.kbd.init_flax_(init)

    def forward(self, vec, vis):
        hidden = [torch.tanh(l1(F.elu(l0(v.float()))))
                  for (l0, l1), v in zip(self.vec_enc, vec)]
        encoded = []
        for convs, v in zip(self.vis_enc, vis):
            x = apply_visual_pad(v.float()).permute(0, 3, 1, 2)
            for i, conv in enumerate(convs):
                y = F.elu(conv(x))
                x = torch.cat([x, y], dim=1) if i in self.PEEPHOLE_LAYERS \
                    else y
                if i == self.POOL_AFTER:
                    x = F.max_pool2d(x, (2, 1), (2, 1), ceil_mode=True)
            encoded.append(x)
        raw_a = self.kbd(encoded[0])
        x = torch.cat(hidden + [_flatten_nhwc(e) for e in encoded], dim=-1)
        if self.full_network:
            h = F.elu(self.value_hidden(x))
            v = torch.tanh(self.value_out(h))
            if self.cfg.separate_piece_values:
                vp = self.value_pieces(h)
                v = v + 0.5 * advantage_activation_sqrt(
                    vp - vp.mean(dim=1, keepdim=True))
        else:
            v = torch.zeros(x.shape[0], 1, device=x.device)
        return v.reshape(v.shape[0], 1, 1, -1), raw_a


def make_trunk(cfg: ModelConfig, board=(22, 10),
               full_network: bool = True) -> nn.Module:
    """The architecture registry (network.py:25-32), resolved from
    ``cfg.architecture``; unknown names raise when the ModelConfig is
    made.  Each trunk returns raw (V (B,1,1,P|1), A (B,R,T,P)), and names
    in ``acting`` the modules the worker-side net shares."""
    if cfg.architecture == "silver":
        return SventonNet(cfg, board, full_network)
    if cfg.architecture == "dreamer":
        return SventonNet(cfg, board, full_network, kbd_head=False)
    if cfg.architecture == "vanilla":
        return ConvThenDense(cfg, board, full_network)
    if cfg.architecture == "keyboard":
        return ConvKeyboard(cfg, board, full_network)
    raise ValueError(cfg.architecture)


class PPONet(nn.Module):
    """ppo_nets' network function: pi = the softmaxed action head
    (B, R, T, P), v = per-piece tanh values (B, P) (or (B, 1) zeros with
    ``full_network=False``, the worker-side net), over the trunk that
    ``cfg.architecture`` names.  The weights live on ``device`` (default
    "cuda"; raises with no card)."""

    def __init__(self, cfg: ModelConfig, board=(22, 10),
                 full_network: bool = True, device=None):
        super().__init__()
        self.cfg, self.board = cfg, tuple(board)
        self.full_network = full_network
        self.trunk = make_trunk(cfg, board, full_network)
        self.register_buffer("piece_mask", cfg.piece_mask, persistent=False)
        self.to(resolve_device(device))

    @property
    def action_columns(self) -> int:
        """The action plane's columns: the board's width, or
        N_TRANSLATIONS for 'vanilla'."""
        return N_TRANSLATIONS if self.cfg.architecture == "vanilla" \
            else self.board[1]

    def worker_view(self) -> "PPONet":
        """The worker-side net (``full_network=False``) holding this net's
        acting modules: the same parameter tensors, no value head.  The
        JAX package applies the full param dict to its partial net; the
        view needs no copy."""
        view = type(self)(self.cfg, self.board, full_network=False,
                          device=next(self.parameters()).device)
        for name in self.trunk.acting:
            setattr(view.trunk, name, getattr(self.trunk, name))
        return view

    def init_flax_(self, key) -> "PPONet":
        """Fresh weights from the init key ``key`` ((2,) threefry words):
        exactly what the JAX package's ``net.init(key, ...)`` gives
        (models/flax_init.py)."""
        self.trunk.init_flax_(FlaxInit(self, key))
        return self

    def load_params_(self, params) -> "PPONet":
        """Weights from a tree of tensors or numpy arrays under this net's
        ``state_dict`` names (a checkpoint's ``params``)."""
        self.load_state_dict({k: torch.as_tensor(v)
                              for k, v in params.items()})
        return self

    def forward(self, vec, vis):
        raw_v, raw_a = self.trunk(vec, vis)
        return action_softmax(raw_a), raw_v.reshape(raw_v.shape[0], -1)


class QNet(PPONet):
    """prio_qnet's network function, dueling Q (qva_from_raw_streams,
    network_utils.py:100-104) on the same trunks: A = tanh of the
    mean-normalised action head, Q = raw V + A (B, R, T, P), V =
    ``q_to_v(Q)`` (B, 1).  Returns (Q, V, A).  The parameters and their
    names are PPONet's, so ``init_flax_``, ``load_params_`` and the flax
    converter serve both."""

    def __init__(self, cfg: ModelConfig, board=(22, 10),
                 full_network: bool = True, device=None,
                 advantage_mode: str = "mean"):
        super().__init__(cfg, board, full_network, device)
        self.advantage_mode = advantage_mode

    def forward(self, vec, vis):
        raw_v, raw_a = self.trunk(vec, vis)
        a = normalize_advantages(
            raw_a, piece_mask=self.piece_mask, mode=self.advantage_mode,
            separate_piece_values=self.cfg.separate_piece_values,
            activation=torch.tanh)
        q = raw_v + a
        return q, q_to_v(q, piece_mask=self.piece_mask), a
