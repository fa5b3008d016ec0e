"""Threefry-2x32 and the jax.random compositions the engine and env use,
bit-exact with partitionable ``jax.random`` (``jax_threefry_partitionable``).

Counterpart of ``drl_tetris_tpu/engine/rng.py`` plus the ``jax.random``
calls of ``env.reset`` (``PRNGKey``, ``split``, ``randint``) and of the
PPO update (``permutation``).  Keys are
``(..., 2)`` tensors of uint32 words; every function here takes and returns
int64 tensors holding values in [0, 2**32) (``u32``), because PyTorch has no
full uint32 arithmetic.  The CUDA kernel carries the same functions as
``__device__`` code (csrc/engine_tick.cu).
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def u32(x) -> torch.Tensor:
    """int32 bit patterns (or any int tensor) -> int64 in [0, 2**32)."""
    return x.to(torch.int64) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bit pattern."""
    x = x & M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on broadcastable int64
    tensors of uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + k1) & M32
    x2 = (x2 + k2) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """== key_data(jax.random.PRNGKey(seed)) for 0 <= seed < 2**32."""
    if not 0 <= seed < 1 << 32:
        raise ValueError(f"seed {seed} out of the 32-bit range")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """== key_data(jax.random.fold_in(key, data)); key (..., 2), data an
    int or an int tensor broadcastable to key[..., 0]."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & M32
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o1, o2), dim=-1)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """== key_data(jax.random.split(key, n)): (..., n, 2)."""
    c = torch.arange(n, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(c), c)
    return torch.stack([o1, o2], dim=-1)


def split2(key: torch.Tensor) -> torch.Tensor:
    """== key_data(jax.random.split(key)): (..., 2, 2)."""
    return split(key, 2)


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """== jax.random.bits(key, shape, uint32) for one key (2,): element i
    (row-major) is the xor of the two threefry words of counter (0, i)."""
    n = 1
    for d in shape:
        n *= d
    c = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(c), c)
    return (b1 ^ b2).reshape(shape)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1) by jax's mantissa fill."""
    fb = (bits >> 9) | 0x3F800000
    return to_i32(fb).view(torch.float32) - 1.0


def uniform01(key: torch.Tensor, shape=()) -> torch.Tensor:
    """== jax.random.uniform(key, shape, float32) for one key (2,)."""
    return bits_to_uniform(random_bits(key, shape))


def key_uniform(keys: torch.Tensor) -> torch.Tensor:
    """== uniform01(k) for each key of a batch (..., 2): the scalar draw,
    counter (0, 0)."""
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], 0, 0)
    return bits_to_uniform(b1 ^ b2)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """== jax.random.permutation(key, n) for one key (2,): rounds of a
    stable sort of arange(n) by fresh 32-bit keys, ceil(3 ln n / ln(2**32
    - 1)) rounds (jax's _shuffle); int64 indices on the key's device."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key, 2)
        x = x[torch.sort(random_bits(sub, (n,)), stable=True).indices]
    return x


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """== jax.random.randint(key, shape, minval, maxval) (int32) for one key
    and minval < maxval within int32: two 32-bit draws folded mod span."""
    k1, k2 = split(key, 2)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & M32
    mult = (1 << 16) % span
    mult = (mult * mult) % span
    off = (((hi % span) * mult & M32) + (lo % span)) & M32
    return (minval + off % span).to(torch.int32)
