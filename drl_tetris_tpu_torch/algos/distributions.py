"""Action selection over the (rotation, translation) plane.

Counterpart of ``drl_tetris_tpu/algos/distributions.py`` (reference:
sventon_utils.py:15-65).  Each function takes A: (N, R, T) scores for the
acting piece and returns ((r, t), entropy) with (N,) index tensors.

``jax.random.categorical`` samples ``argmax(log p + gumbel)``; the port does
the same with gumbel noise drawn from an explicit ``torch.Generator``, or
taken as given (``gumbel``, (N, R*T)) so that a test can replay JAX's draws.
Pareto sampling is such a categorical too.  Epsilon-greedy follows JAX's
key exactly: ``split(key, 3)``, two ``randint`` and one ``uniform`` through
the port's threefry (engine/rng.py), which is bit-exact with those.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from drl_tetris_tpu_torch.engine import rng

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


def action_epsilongreedy(A: torch.Tensor, key: torch.Tensor, epsilon):
    """Greedy (r, t), replaced by a uniform random (r, t) where a uniform
    draw falls below ``epsilon`` (a float or a 0-d tensor, compared in
    float32).  ``key`` is one (2,) threefry key: ku, kr, kt = split(key, 3)
    as in JAX.  The entropy is that of the map JAX reports: e/n everywhere
    plus 1-e on one action, e = min(1, epsilon)."""
    N, R, T = A.shape
    n = R * T
    ku, kr, kt = rng.split(key.to(A.device), 3)
    gr, gt = _unravel(torch.argmax(A.reshape(N, -1), dim=-1), T)
    rand_r = rng.randint(kr, (N,), 0, R).long()
    rand_t = rng.randint(kt, (N,), 0, T).long()
    if torch.is_tensor(epsilon):
        eps = epsilon.to(torch.float32)
        e = torch.clamp(eps, max=1.0)
        p = torch.full((n,), 1.0, device=A.device) * (e / n)
        p[0] += 1.0 - e
        ent = (-torch.sum(p * torch.log(p + 1e-12))).expand(N)
    else:
        eps = float(np.float32(epsilon))
        e = np.minimum(np.float32(1.0), np.float32(epsilon))
        p = np.full((n,), e / np.float32(n), np.float32)
        p[0] += np.float32(1.0) - e
        ent = torch.full((N,), float(-np.sum(p * np.log(p + np.float32(
            1e-12)))), device=A.device)
    explore = rng.uniform01(ku, (N,)) < eps
    r = torch.where(explore, rand_r, gr)
    t = torch.where(explore, rand_t, gt)
    return (r, t), ent


def pareto(x: torch.Tensor, temperature) -> torch.Tensor:
    """tools/utils.py:88-91: p ~ 1/rank^temperature over the last axis,
    rank 1 the largest; ties rank in index order (a stable sort, as
    JAX's argsort)."""
    order = torch.argsort(-x, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ar = torch.arange(1, x.shape[-1] + 1, device=x.device).expand_as(order)
    ranks.scatter_(-1, order, ar)
    p = 1.0 / ranks.to(torch.float32) ** float(np.float32(temperature))
    return p / torch.sum(p, dim=-1, keepdim=True)


def action_pareto(A: torch.Tensor, temperature,
                  generator: Optional[torch.Generator] = None,
                  gumbel: Optional[torch.Tensor] = None):
    """Sample (r, t) from the pareto map of A's scores."""
    N, R, T = A.shape
    p = pareto(A.reshape(N, -1), temperature)
    if gumbel is None:
        gumbel = gumbel_noise(p.shape, generator, p.device)
    idx = torch.argmax(gumbel.to(p.device) + torch.log(p), dim=-1)
    ent = -torch.sum(p * torch.log(p + 1e-12), dim=-1)
    return _unravel(idx, T), ent
