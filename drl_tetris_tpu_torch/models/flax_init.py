"""flax's initialisation of the port's nets, drawn from a JAX key.

``FlaxInit(net, key)`` gives each parameter of a PPONet, QNet, VNet or
SherlockNet exactly the value that the JAX package's ``net.init(key,
dummy_vec, dummy_vis)`` gives the matching flax leaf (flax 0.12, JAX 0.9,
partitionable threefry); the nets' ``init_flax_(key)`` say which
initialiser each parameter takes, as the flax modules do.

* Keys (flax/core/scope.py ``make_rng``, ``_fold_in_static``): a module
  scope's 'params' stream is the init key with the scope's path folded in
  lazily, and each ``param`` call takes the next counter of the scope (1,
  2, ...): kernel or scale first, then bias.  The key of a leaf is
  ``fold_in(key, h)``, h the first 4 bytes (big-endian) of the sha1 of the
  path's names (utf-8) and the counter (its minimal big-endian bytes),
  with no separators.  The paths are the converter's
  (``models/convert.flax_paths``): auto-named modules (``Conv_0``,
  ``ResidualBlock_4``) under the root module, which adds no name.
* Draws (jax/_src/random.py, jax/_src/nn/initializers.py), in float32 on
  the CPU with the port's int64 threefry, in flax's layout (HWIO and (in,
  out) kernels), then moved to the parameter's layout and device, so every
  device gets the same weights: ``uniform`` is JAX's mantissa fill, scaled
  and shifted, so glorot_uniform is bit-exact; ``normal`` is sqrt(2)
  erfinv(u) and ``truncated_normal`` (lecun_normal) sqrt(2) erfinv(u) of a
  uniform between erf(-sqrt 2) and erf(sqrt 2), clipped; the erfinv is
  XLA's polynomial, within 2 ulps of XLA:CPU's (its log1p differs).
"""
from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.models.convert import flax_paths

F32 = torch.float32
_SQRT2 = float(np.float32(np.sqrt(2)))
_TRUNC_STD = float(np.float32(.87962566103423978))   # of N(0,1) on (-2, 2)


def static_hash(data: Sequence) -> int:
    """flax's hash of a scope path and counter: the first 4 bytes of the
    sha1 of each element (strings utf-8, ints big-endian), big-endian."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return int.from_bytes(m.digest()[:4], "big")


def param_key(key: torch.Tensor, path: Tuple[str, ...], counter: int
              ) -> torch.Tensor:
    """The key ``make_rng('params')`` gives the ``counter``-th parameter of
    the module at ``path`` under an init with ``key``."""
    return rng.fold_in(key, static_hash((*path, counter)))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, as XLA:CPU contracts it (the
    float32 product is exact in float64)."""
    return (a.double() * b.double() + c.double()).to(F32)


def uniform(key, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    lo = torch.as_tensor(minval, dtype=F32)
    hi = torch.as_tensor(maxval, dtype=F32)
    u = rng.uniform01(key, tuple(shape))
    return torch.maximum(lo, _fma(u, hi - lo, lo))


# XLA's float32 erf_inv (M. Giles' approximation): a degree-8 polynomial
# in w - 2.5 for w = -log1p(-x^2) < 5, else in sqrt(w) - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """erfinv of float32 x in (-1, 1) as XLA computes it (Horner steps
    fused): within 2 ulps of XLA:CPU's, mostly equal; torch.erfinv is
    exact and differs from it by up to 51 ulps in the tails."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, a, b).to(F32))
    return p * x


def normal(key, shape) -> torch.Tensor:
    """jax.random.normal(key, shape, float32)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return _SQRT2 * _erfinv(uniform(key, shape, lo, 1.0))


def truncated_normal(key, shape, lower: float, upper: float
                     ) -> torch.Tensor:
    """jax.random.truncated_normal(key, lower, upper, shape, float32)."""
    sqrt2 = torch.tensor(_SQRT2, dtype=F32)
    lo = torch.tensor(lower, dtype=F32)
    hi = torch.tensor(upper, dtype=F32)
    a, b = torch.erf(lo / sqrt2), torch.erf(hi / sqrt2)
    out = sqrt2 * _erfinv(uniform(key, shape, a, b))
    return torch.clamp(out, torch.nextafter(lo, torch.tensor(math.inf)),
                       torch.nextafter(hi, torch.tensor(-math.inf)))


def _fans(shape) -> Tuple[int, int]:
    """(fan_in, fan_out) of a flax kernel: in axis -2, out axis -1."""
    field = math.prod(shape[:-2])
    return shape[-2] * field, shape[-1] * field


def _variance(value: float) -> torch.Tensor:
    return torch.tensor(value, dtype=F32)


def _flax_shape(shape) -> Tuple[int, ...]:
    """A port parameter's shape in flax's layout: OIHW -> HWIO, (out, in)
    -> (in, out)."""
    if len(shape) == 4:
        o, i, h, w = shape
        return (h, w, i, o)
    if len(shape) == 2:
        return (shape[1], shape[0])
    return tuple(shape)


def _port_layout(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 4:
        return x.permute(3, 2, 0, 1)
    if x.ndim == 2:
        return x.T
    return x


class FlaxInit:
    """The flax key of every parameter of ``net`` under the init key
    ``key`` ((2,) uint32 words, JAX's ``kinit``), and flax's initialisers
    drawn from them into the parameters."""

    def __init__(self, net: torch.nn.Module, key):
        key = torch.as_tensor(key).to("cpu", torch.int64)
        named = list(net.named_parameters())
        paths = flax_paths([n for n, _ in named])
        self._keys = {}
        for name, p in named:
            path = paths[name]
            counter = 2 if path[-1] == "bias" else 1
            self._keys[id(p)] = param_key(key, path[:-1], counter)

    @torch.no_grad()
    def _fill(self, p: torch.nn.Parameter, draw):
        shape = _flax_shape(p.shape)
        p.copy_(_port_layout(draw(self._keys[id(p)], shape)).to(p.device))

    def glorot_uniform(self, p):
        def draw(key, shape):
            fan_in, fan_out = _fans(shape)
            var = _variance(1.0 / ((fan_in + fan_out) / 2))
            return uniform(key, shape, -1.0) * torch.sqrt(3 * var)
        self._fill(p, draw)

    def lecun_normal(self, p):
        def draw(key, shape):
            var = _variance(1.0 / _fans(shape)[0])
            std = torch.sqrt(var) / torch.tensor(_TRUNC_STD, dtype=F32)
            return truncated_normal(key, shape, -2.0, 2.0) * std
        self._fill(p, draw)

    def normal(self, p, stddev: float):
        self._fill(p, lambda key, shape: normal(key, shape)
                   * torch.tensor(stddev, dtype=F32))

    @torch.no_grad()
    def zeros(self, p):
        p.zero_()

    @torch.no_grad()
    def ones(self, p):
        p.fill_(1.0)
