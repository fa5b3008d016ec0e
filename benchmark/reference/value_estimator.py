# Frozen copy of ``integer_pow``, ``v_ref`` and ``kstep_targets`` of
# drl_tetris_tpu_torch/algos/value_estimator.py at commit
# 19b7261806ffa5740b75ff89fdfc53fa8692c191, part of the benchmark's plain
# reference.  Changed from the copy: the estimator's settings are given as
# values, and the reference net's forwards run in chunks (``chunk`` rows)
# so that a sample of 16,384 windows fits in float32.
"""k-step / TD(lambda) value targets over sampled windows:

  done_time = the number of not-yet-done steps in the window
  e_k       = sum_{t<k} r_t [done_time >= t] gamma^t
              + V_ref(s_k) [done_time >= k] gamma^k
  target    = sum_k e_k lam_k^k / sum_k lam_k^k
  lam_k     = lambda * [done_time >= k-1]  (truncated aggregation)

with gamma negated for single-policy self-play; V_ref(s_k) is the
reference net's piece-mean value."""
from __future__ import annotations

from typing import Sequence

import torch

from benchmark.reference.core import EngineConfig
from benchmark.reference.observations import field_grid


def integer_pow(x: torch.Tensor, k: int) -> torch.Tensor:
    """x ** k for an int k >= 1 by square-and-multiply in XLA's order."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def v_ref(cfg: EngineConfig, ref_net, occ_t: torch.Tensor,
          vec_t: torch.Tensor, chunk: int) -> torch.Tensor:
    """The reference net's piece-mean value of (n,) states, (n,)
    float32."""
    out = []
    for s in range(0, occ_t.shape[0], chunk):
        grids = field_grid(cfg, occ_t[s:s + chunk])
        v = ref_net([vec_t[s:s + chunk, 0, :], vec_t[s:s + chunk, 1, :]],
                    [grids[:, 0, :, :, None], grids[:, 1, :, :, None]])
        out.append(torch.mean(v, dim=-1))
    return torch.cat(out).reshape(-1).to(torch.float32)


def kstep_targets(cfg: EngineConfig, ref_net, windows, steps: Sequence[int],
                  gamma: float, lam: float, truncate: bool = True,
                  chunk: int = 4096) -> torch.Tensor:
    """(n,) float32 targets, no gradient; ``gamma`` as the estimator uses
    it (negated in single-policy self-play); ``windows`` on the net's
    device."""
    with torch.no_grad():
        r = windows["reward"].to(torch.float32)
        d = windows["done"].to(torch.int32)
        dmask = torch.clamp(torch.cumsum(d, dim=1), max=1)
        done_time = torch.sum(1 - dmask, dim=1).to(torch.float32)
        est_sum = 0.0
        weight = 0.0
        for k in steps:
            e = torch.zeros_like(done_time)
            for t in range(k):
                e = e + r[:, t] * (done_time >= t) * (gamma ** t)
            vk = v_ref(cfg, ref_net, windows["occ"][:, k],
                       windows["vec"][:, k], chunk)
            e = e + vk * (done_time >= k) * (gamma ** k)
            if truncate:
                lam_k = lam * (done_time >= k - 1).to(torch.float32)
            else:
                lam_k = torch.full_like(done_time, lam)
            lam_kk = integer_pow(lam_k, k)
            est_sum = est_sum + e * lam_kk
            weight = weight + lam_kk
        return est_sum / weight
