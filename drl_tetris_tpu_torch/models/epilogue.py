"""The residual layer's epilogue: the bias add, the peephole join with the
layer input and the activation after a convolution of
``models/nets.py`` ``ResidualBlock``, and its hand-written CUDA kernel
(csrc/net_epilogue.cu).

``epilogue(c, bias, y, mode, act, cin=None) -> out``: ``c`` (B, n, H, W)
is the conv's output without its bias, ``y`` (B, >= c_in, H, W) the
layer's input, of which the first ``cin`` channels (all, by default) are
read (None: a block without peepholes), and ``out`` fresh, with the
join's join_channels(n, c_in, mode) channels first; ``mode`` 'add' or
'truncate_add', ``act`` 'elu', 'tanh' or None.  CPU tensors take the plain
version, the eager chain ``c + bias`` -> ``peephole_join`` -> activation,
and ``out`` holds the join's channels alone.  CUDA tensors, bfloat16 or
float32 and channels-last, launch the kernel, which rounds where that
chain rounds and so gives its output bit for bit, and ``out`` is
channels-last with its rows padded by zero channels to a multiple of 8
(``padded``): the layout cuDNN's tensor-core convolutions read without a
padding pass of their own.  Anything else raises.

The kernel is built with nvcc on first use into ``build/torch_kernels/``
(``utils/nvcc.py``) and loaded with ctypes; it runs on PyTorch's current
stream.  ``LAUNCHES`` counts its launches (the plain path never counts):
31 a full 'silver' forward on the card, 25 a worker-side one.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from drl_tetris_tpu_torch.utils import nvcc

LAUNCHES = {"epilogue": 0}

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "net_epilogue.cu"
# PyTorch's kernels are compiled with nvcc's default --fmad=true; so is
# this one, so that expm1f and tanhf give theirs
NVCC_FLAGS = nvcc.TARGET
ACTIVATIONS = {None: 0, "elu": 1, "tanh": 2}
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_INVALID_DEVICE = 101           # cudaErrorInvalidDevice
_CL = torch.channels_last


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


def activation(x: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "elu":
        return F.elu(x)
    if act == "tanh":
        return torch.tanh(x)
    return x


def epilogue_plain(c: torch.Tensor, bias: torch.Tensor,
                   y: Optional[torch.Tensor], mode: str,
                   act: Optional[str]) -> torch.Tensor:
    """The eager chain on NCHW-indexed tensors of any layout: the bias in
    the conv's dtype, the peephole join along the channel axis, the
    activation."""
    x = c + bias.to(c.dtype)[None, :, None, None]
    if y is not None:
        x = peephole_join(x, y, mode, dim=1)
    return activation(x, act)


_LIB = None


def load():
    """The library built from csrc/net_epilogue.cu."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE, NVCC_FLAGS)[0]))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.net_epilogue.argtypes = [I, I, I, I, P, P, P, P,
                                     ctypes.c_longlong, I, I, I, I, I, I, P]
        lib.net_epilogue.restype = I
        _LIB = lib
    return _LIB


def padded(channels: int) -> int:
    """Channels a row holds on the card's NHWC path: a multiple of 8."""
    return -(-channels // 8) * 8


def epilogue(c: torch.Tensor, bias: torch.Tensor,
             y: Optional[torch.Tensor], mode: str, act: Optional[str],
             cin: Optional[int] = None) -> torch.Tensor:
    """act(join(c + bias, y[:, :cin])); see the module's docstring.  The
    host side is kept short (31 calls a forward): checks that cost a
    C call each, the vector width from the alignment of every row length
    and pointer at once, the stream's raw handle, the current device
    checked by the C entry."""
    dev = c.device
    if y is None:
        cin = 0
    elif cin is None:
        cin = y.shape[1]
    elif not 0 < cin <= y.shape[1]:
        raise ValueError(f"cin {cin} of a {y.shape[1]}-channel input")
    if dev.type == "cpu":
        return epilogue_plain(c, bias, None if y is None else
                              y.narrow(1, 0, cin), mode, act)
    if dev.type != "cuda":
        raise ValueError(f"no epilogue path for device {dev}")
    if mode not in ("add", "truncate_add") or act not in ACTIVATIONS:
        raise ValueError(f"epilogue: mode {mode!r}, activation {act!r}")
    b, n, h, w = c.shape
    y_stride = 0 if y is None else y.shape[1]
    cout = n if y is None else join_channels(n, cin, mode)
    dtype = _DTYPES.get(c.dtype)
    if dtype is None or not c.is_contiguous(memory_format=_CL) or (
            y is not None and (
                y.dtype != c.dtype or y.device != dev
                or y.shape != (b, y_stride, h, w)
                or not y.is_contiguous(memory_format=_CL))):
        raise ValueError(
            f"epilogue takes bfloat16 or float32 channels-last c and y of "
            f"one dtype, device and map size; got c {c.dtype} "
            f"{tuple(c.shape)}, y "
            f"{None if y is None else (y.dtype, tuple(y.shape))}")
    if bias.dtype != torch.float32 or bias.device != dev \
            or bias.shape != (n,) or not bias.is_contiguous():
        raise ValueError(f"bias: contiguous float32 ({n},) on {dev}; got "
                         f"{bias.dtype} {tuple(bias.shape)} on "
                         f"{bias.device}")
    out_stride = padded(cout)
    out = torch.empty((b, out_stride, h, w), dtype=c.dtype, device=dev,
                      memory_format=_CL)
    pixels = b * h * w
    if pixels == 0:
        return out
    elem = c.element_size()
    c_ptr, out_ptr = c.data_ptr(), out.data_ptr()
    vec = _vector(elem, n * elem | out_stride * elem | c_ptr | out_ptr)
    y_ptr = None
    y_vec = False
    if y is not None:
        y_ptr = y.data_ptr()
        y_vec = _vector(elem, vec * elem | y_stride * elem | y_ptr) == vec
    rc = (_LIB or load()).net_epilogue(
        dtype, vec, ACTIVATIONS[act], y_vec, c_ptr, bias.data_ptr(), y_ptr,
        out_ptr, pixels, n, cin, y_stride, cout, out_stride, dev.index,
        # the current stream's handle; torch.cuda.current_stream() costs
        # 30 times as much host time
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc == _INVALID_DEVICE:
        raise ValueError(f"epilogue on {dev}: make it the current device")
    nvcc.check(rc, "net_epilogue")
    LAUNCHES["epilogue"] += 1
    return out


def _vector(elem: int, bits: int) -> int:
    """Elements of ``elem`` bytes per access: the most that fit 16 bytes
    and divide ``bits``, the OR of every byte count and address the
    accesses must keep aligned."""
    return min(16, bits & -bits) // elem or 1
