"""Action selection over the (rotation, translation) plane.

Counterpart of ``drl_tetris_tpu/algos/distributions.py`` (reference:
sventon_utils.py:15-65).  Each function takes A: (N, R, T) scores for the
acting piece and returns ((r, t), entropy) with (N,) index tensors.

``jax.random.categorical(key, logits)`` is ``argmax(gumbel + logits)``
with ``jax.random.gumbel(key, logits.shape)`` (mode 'low' in JAX 0.9);
``categorical`` draws that noise from the key through the port's threefry
(engine/rng.py ``gumbel``: the bits are JAX's, the logs within an ulp of
XLA's).  ``action_distribution`` and ``action_pareto`` take the noise as a
tensor (``gumbel``, (N, R*T)), which a rollout draws for all its ticks at
once from their keys (``rng.gumbel`` over a batch of keys) or a test
gives.  Epsilon-greedy
follows JAX's key exactly: ``split(key, 3)``, two ``randint`` and one
``uniform``.
"""
from __future__ import annotations

import numpy as np
import torch

from drl_tetris_tpu_torch.engine import rng

def _unravel(idx, T):
    return idx // T, idx % T


def action_argmax(A: torch.Tensor):
    N, R, T = A.shape
    idx = torch.argmax(A.reshape(N, -1), dim=-1)
    return _unravel(idx, T), torch.zeros(N, device=A.device)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical(key, logits, axis=-1) of (N, K) logits: the
    argmax of logits plus JAX's gumbel draw from the (2,) key."""
    g = rng.gumbel(key.to(logits.device), tuple(logits.shape))
    return torch.argmax(g + logits, dim=-1)


def action_distribution(A: torch.Tensor, gumbel: torch.Tensor):
    """Sample (r, t) ~ A, a probability map (the PPO policy), with the
    categorical's noise ``gumbel`` (N, R*T)."""
    N, R, T = A.shape
    p = A.reshape(N, -1)
    logp = torch.log(torch.clamp(p, min=1e-20))
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


def action_pareto(A: torch.Tensor, temperature, gumbel: torch.Tensor):
    """Sample (r, t) from the pareto map of A's scores, with the
    categorical's noise ``gumbel`` (N, R*T)."""
    N, R, T = A.shape
    p = pareto(A.reshape(N, -1), temperature)
    idx = torch.argmax(gumbel.to(p.device) + torch.log(p), dim=-1)
    ent = -torch.sum(p * torch.log(p + 1e-12), dim=-1)
    return _unravel(idx, T), ent
