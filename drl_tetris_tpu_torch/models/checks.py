"""Inputs and comparisons that hold the residual layers' epilogue kernel
(models/epilogue.py) against its plain version, and the net's NHWC path
against its NCHW path.  ``chip_smoke.py`` and the card tests share them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from drl_tetris_tpu_torch.models import epilogue as E

BOARDS, MAP = 1024, (24, 12)      # the main path's batch and padded board


class Layer(NamedTuple):
    """One layer's epilogue: input channels, conv channels, join mode,
    activation, dtype, the avg-pool window after it (or None), and its
    map size."""
    cin: int
    n: int
    mode: str = "add"
    act: Optional[str] = "elu"
    dtype: torch.dtype = torch.bfloat16
    pool: Optional[Tuple[int, int]] = None
    hw: Tuple[int, int] = MAP


# the 'silver' net's layers at the main path's shapes ...
MAIN_PATH = {
    "vis_first 1->64": Layer(1, 64),
    "tower 64->64": Layer(64, 64),
    "join 76->64": Layer(76, 64),
    "adv_last 76->64": Layer(76, 64, act=None),
    "value_first 154->128 +pool": Layer(154, 128, pool=(3, 2)),
}
# ... and every other instantiation the registry reaches, smaller
OTHERS = {
    "value_last 154->8 truncate_add": Layer(154, 8, "truncate_add", None,
                                            hw=(1, 1)),
    "value_mid 154->128 2x3": Layer(154, 128, pool=(2, 2), hw=(2, 3)),
    "tanh 64->64": Layer(64, 64, act="tanh"),
    "phi_first f32 13->64": Layer(13, 64, dtype=torch.float32),
    "phi f32 64->64": Layer(64, 64, dtype=torch.float32),
    "no peephole 0->64": Layer(0, 64),
}


def layer_inputs(layer: Layer, boards: int, device, seed: int = 0):
    """(c, bias, y): channels-last c and y of the layer's shapes, drawn
    normal (so that elu's and tanh's both branches are taken), and a
    float32 bias."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    h, w = layer.hw

    def draw(ch, scale):
        t = scale * torch.randn(boards, h, w, ch, generator=g)
        return t.to(device=device, dtype=layer.dtype).permute(0, 3, 1, 2)

    c = draw(layer.n, 1.5)
    y = draw(layer.cin, 1.0) if layer.cin else None
    bias = (0.1 * torch.randn(layer.n, generator=g)).to(device)
    return c, bias, y


def pooled(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    if layer.pool is None:
        return x
    ph, pw = (min(a, b) for a, b in zip(layer.pool, x.shape[2:]))
    return F.avg_pool2d(x, (ph, pw), stride=(ph, pw))


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and the same bits element for element, whatever the
    layouts."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(view), b.view(view))


def kernel_vs_plain(layer: Layer, boards: int = BOARDS, device="cuda",
                    seed: int = 0) -> Dict[str, float]:
    """The kernel on channels-last inputs (y's rows padded with zero
    channels to a multiple of 8, as the blocks hand them over) against
    the plain version on the same values in NCHW, each followed by the
    layer's pool: whether the join's channels agree bit for bit and the
    row's padding is zero, the widest gap, and the kernel's launches."""
    c, bias, y = layer_inputs(layer, boards, device, seed)
    rows = None if y is None else pad_rows(y)
    before = E.LAUNCHES["epilogue"]
    out = E.epilogue(c, bias, rows, layer.mode, layer.act, layer.cin or None)
    launches = E.LAUNCHES["epilogue"] - before
    ref = pooled(E.epilogue_plain(
        c.contiguous(), bias, None if y is None else y.contiguous(),
        layer.mode, layer.act), layer)
    got = pooled(out, layer)
    cout = ref.shape[1]
    pad = got.narrow(1, cout, got.shape[1] - cout)
    got = got.narrow(1, 0, cout)
    gap = (got.double() - ref.double()).abs().nan_to_num(float("inf"))
    return {"bit_exact": bits_equal(got, ref) and not pad.any().item(),
            "max_abs": float(gap.max()) if gap.numel() else 0.0,
            "launches": launches,
            "channels_last": out.is_contiguous(
                memory_format=torch.channels_last)}


def pad_rows(x: torch.Tensor) -> torch.Tensor:
    """x in channels-last rows padded with zero channels to a multiple of
    8, as ``nets.nhwc_rows`` writes them."""
    b, ch, h, w = x.shape
    out = torch.empty((b, E.padded(ch), h, w), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last
                      ).zero_()
    out.narrow(1, 0, ch).copy_(x)
    return out


def layer_bytes(layer: Layer, boards: int = BOARDS) -> int:
    """Bytes the epilogue moves on the NHWC path: c, and y's rows padded
    to a multiple of 8 channels, read once; out's padded rows written
    once."""
    h, w = layer.hw
    cout = E.join_channels(layer.n, layer.cin, layer.mode) \
        if layer.cin else layer.n
    rows = layer.n + E.padded(layer.cin) + E.padded(cout)
    return boards * h * w * rows * (torch.finfo(layer.dtype).bits // 8)


def board_inputs(n: int, seed: int, device, h: int = 22, w: int = 10):
    """Per-perspective vec (n, 12) and vis (n, h, w, 1) from a numpy seed:
    stacked random boards and observation-like scalars."""
    rs = np.random.RandomState(seed)
    vecs, viss = [], []
    for _ in range(2):
        tops = rs.randint(2, h, size=(n, 1, w))
        vis = (np.arange(h)[None, :, None] >= tops) & (rs.rand(n, h, w)
                                                        < 0.85)
        viss.append(torch.from_numpy(vis[..., None].astype(np.float32)))
        vec = np.concatenate([rs.randint(0, 8, (n, 2)),
                              rs.randint(0, 5, (n, 1)),
                              rs.rand(n, 1), rs.randint(0, 4, (n, 1)),
                              np.eye(7)[rs.randint(0, 7, n)]], axis=1)
        vecs.append(torch.from_numpy(vec.astype(np.float32)))
    return [v.to(device) for v in vecs], [v.to(device) for v in viss]


def forward_paths(net, vec, vis) -> Dict[str, float]:
    """The net's forward on the NHWC path (no grad) against its NCHW path
    (the same call with autograd recording) on the same inputs: the
    widest |d pi| and |d v|, whether every output agrees bit for bit, and
    the epilogue's launches in the NHWC forward."""
    before = E.LAUNCHES["epilogue"]
    with torch.no_grad():
        fast = net(vec, vis)
    launches = E.LAUNCHES["epilogue"] - before
    with torch.enable_grad():
        slow = [t.detach() for t in net(vec, vis)]
    if E.LAUNCHES["epilogue"] - before != launches:
        raise AssertionError("the NCHW path launched the epilogue kernel")
    gaps = [float((a.double() - b.double()).abs().max())
            for a, b in zip(fast, slow)]
    return {"pi_gap": gaps[0], "v_gap": gaps[1],
            "bit_exact": all(bits_equal(a, b) for a, b in zip(fast, slow)),
            "launches": launches}


# widest gap allowed between the two paths' outputs on the card: none,
# since cuDNN runs the same engine on the padded channels-last rows as on
# NCHW tensors (which it transposes and pads itself), and the epilogue
# rounds where the eager chain rounds (H100, cuDNN of torch 2.11+cu128)
PATH_TOL = {"pi": 0.0, "v": 0.0}


def silver_forward_paths(boards: int, seed: int, full_network: bool = True,
                         device="cuda") -> Dict[str, float]:
    """``forward_paths`` for the 'silver' PPONet at the main path's widths
    (bfloat16 towers), weights and boards drawn from ``seed``; the
    worker-side net with ``full_network=False``."""
    from drl_tetris_tpu_torch.models.convert import seeded_state_dict
    from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet
    net = PPONet(ModelConfig(), device=device)
    net.load_state_dict(seeded_state_dict(net, seed))
    if not full_network:
        net = net.worker_view()
    vec, vis = board_inputs(boards, seed, device)
    return forward_paths(net, vec, vis)
