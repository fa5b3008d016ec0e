# Frozen copy of drl_tetris_tpu_torch/engine/shifts.py at commit
# 0522b5deacbf29e64a07f002c2407ff1530df4d8, part of the
# benchmark's plain reference; only the imports are rewritten.
"""Static shifts and inclusive scans along the last axis (the board's H rows
or the garbage FIFO's CAP slots of a ``(N, L)`` batch).

Counterpart of ``drl_tetris_tpu/engine/shifts.py``.  Only the plain form is
ported.  The JAX package's second lowering (``_matmul_apply``,
``_shift_mat``, ``mxu_shifts``, ``require_f32_exact``) expressed each shift
as a 0/1 float32 matmul because Mosaic could not lower sliced-operand
concatenates inside the Pallas kernel; it is dropped here.  With it goes its
width <= 24 guard: the CUDA kernel shifts rows in registers, so every width
EngineConfig allows (4..25) runs on both paths.
"""
from __future__ import annotations

import torch


def shift_down(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i] = x[..., i - k] for i >= k, zero below."""
    n = x.shape[-1]
    if k == 0:
        return x
    if k >= n:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[..., :k]), x[..., :-k]], dim=-1)


def shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[..., i] = x[..., i + k] for i < n - k, zero above."""
    n = x.shape[-1]
    if k == 0:
        return x
    if k >= n:
        return torch.zeros_like(x)
    return torch.cat([x[..., k:], torch.zeros_like(x[..., :k])], dim=-1)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum (integer-exact)."""
    return torch.cumsum(x, dim=-1).to(x.dtype)


def suffix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sum (integer-exact)."""
    return torch.flip(torch.cumsum(torch.flip(x, [-1]), dim=-1),
                      [-1]).to(x.dtype)
