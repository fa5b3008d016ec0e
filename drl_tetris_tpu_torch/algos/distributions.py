"""Action selection over the (rotation, translation) plane.

Counterpart of ``drl_tetris_tpu/algos/distributions.py`` (reference:
sventon_utils.py:15-65).  Each function takes A: (N, R, T) scores for the
acting piece and returns ((r, t), entropy) with (N,) index tensors.

``jax.random.categorical`` samples ``argmax(log p + gumbel)``; the port does
the same with gumbel noise drawn from an explicit ``torch.Generator``, or
taken as given (``gumbel``, (N, R*T)) so that a test can replay JAX's draws.
Epsilon-greedy and pareto sampling wait for the slices that use them.
"""
from __future__ import annotations

from typing import Optional

import torch

_TINY = torch.finfo(torch.float32).tiny


def _unravel(idx, T):
    return idx // T, idx % T


def action_argmax(A: torch.Tensor):
    N, R, T = A.shape
    idx = torch.argmax(A.reshape(N, -1), dim=-1)
    return _unravel(idx, T), torch.zeros(N, device=A.device)


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """-log(-log(u)), u uniform on [tiny, 1) (jax.random.gumbel's form)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp(u, min=_TINY)))


def action_distribution(A: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        gumbel: Optional[torch.Tensor] = None):
    """Sample (r, t) ~ A, a probability map (the PPO policy)."""
    N, R, T = A.shape
    p = A.reshape(N, -1)
    logp = torch.log(torch.clamp(p, min=1e-20))
    if gumbel is None:
        gumbel = gumbel_noise(p.shape, generator, p.device)
    idx = torch.argmax(gumbel.to(p.device) + logp, dim=-1)
    ent = -torch.sum(p * torch.log(p + 1e-6), dim=-1)
    return _unravel(idx, T), ent
