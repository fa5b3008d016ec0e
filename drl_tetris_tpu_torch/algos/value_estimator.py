"""k-step / TD(lambda) targets over sampled windows.

Counterpart of ``drl_tetris_tpu/algos/value_estimator.py`` (reference:
agents/networks/value_estimator.py:4-103):

  done_time = number of not-yet-done steps in the window (cumsum mask,
              value_estimator.py:52-53)
  e_k       = sum_{t<k} r_t [done_time >= t] gamma^t
              + V_ref(s_k) [done_time >= k] gamma^k        (:69-76)
  target    = sum_k e_k lam_k^k / sum_k lam_k^k            (:80-88)
  lam_k     = lambda * [done_time >= k-1]  if truncate_aggregation

with gamma negated for single-policy self-play and the optional sparse step
filter (steps not divisible by any filter entry, :90-99).  V_ref(s_k) is
the reference net's piece-mean value (:63-64).  The reference-net forwards
run under ``torch.no_grad()``, one per kept step, each batched over the
whole sample.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from drl_tetris_tpu_torch.engine.core import EngineConfig
from drl_tetris_tpu_torch.env.observations import field_grid


def create_steps(k: int, filt: Optional[Sequence[int]] = None
                 ) -> Tuple[int, ...]:
    """value_estimator._create_steps (:90-99)."""
    steps = list(range(1, k + 1))
    if filt:
        f = np.asarray(filt).reshape(1, -1)
        s = np.asarray(steps).reshape(-1, 1)
        keep = np.prod(s % f, axis=1) != 0
        steps = s[np.where(keep)].ravel().tolist()
    return tuple(int(s) for s in steps)


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    k_step: int = 5
    gamma: float = 0.98              # before the single-policy negation
    lam: float = 0.95                # the lambda aggregation weight
    single_policy: bool = True
    truncate_aggregation: bool = True
    step_filter: Tuple[int, ...] = ()

    @property
    def steps(self) -> Tuple[int, ...]:
        return create_steps(self.k_step, self.step_filter or None)

    @property
    def effective_gamma(self) -> float:
        return -self.gamma if self.single_policy else self.gamma


def integer_pow(x: torch.Tensor, k: int) -> torch.Tensor:
    """x ** k for an int k >= 1 by square-and-multiply in XLA's order
    (lax.integer_pow), so the float32 result is bit-exact with JAX's."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def v_ref(engine_cfg: EngineConfig, ref_net, occ_t: torch.Tensor,
          vec_t: torch.Tensor) -> torch.Tensor:
    """The reference net's value of (n,) states, (n,) float32: ``out[1]``
    of a PPONet or QNet, averaged over pieces when it is (n, P)."""
    grids = field_grid(engine_cfg, occ_t)                     # (n, 2, H, W)
    vis = [grids[:, 0, :, :, None], grids[:, 1, :, :, None]]
    vec = [vec_t[:, 0, :], vec_t[:, 1, :]]
    out = ref_net(vec, vis)
    v = out if torch.is_tensor(out) else out[1]
    if v.ndim == 2 and v.shape[-1] > 1:
        v = torch.mean(v, dim=-1, keepdim=True)
    return v.reshape(-1).to(torch.float32)


def kstep_targets(engine_cfg: EngineConfig, ref_net, cfg: EstimatorConfig,
                  windows) -> torch.Tensor:
    """(n,) float32 targets, no gradient.  ``windows``: occ (n, k+1, 2, H)
    int32 bits, vec (n, k+1, 2, 12), reward (n, k+1), done (n, k+1);
    ``ref_net`` holds the reference weights."""
    gamma = cfg.effective_gamma
    with torch.no_grad():
        r = windows["reward"].to(torch.float32)
        d = windows["done"].to(torch.int32)
        dmask = torch.clamp(torch.cumsum(d, dim=1), max=1)
        done_time = torch.sum(1 - dmask, dim=1).to(torch.float32)   # (n,)

        est_sum = 0.0
        weight = 0.0
        for k in cfg.steps:
            e = torch.zeros_like(done_time)
            for t in range(k):
                e = e + r[:, t] * (done_time >= t) * (gamma ** t)
            vk = v_ref(engine_cfg, ref_net, windows["occ"][:, k],
                       windows["vec"][:, k])
            e = e + vk * (done_time >= k) * (gamma ** k)
            if cfg.truncate_aggregation:
                lam_k = cfg.lam * (done_time >= k - 1).to(torch.float32)
            else:
                lam_k = torch.full_like(done_time, cfg.lam)
            lam_kk = integer_pow(lam_k, k)
            est_sum = est_sum + e * lam_kk
            weight = weight + lam_kk
        return est_sum / weight


def make_target_fn(engine_cfg: EngineConfig, ref_net,
                   cfg: EstimatorConfig):
    """Returns targets(net, windows) -> (n,) float32: ``kstep_targets``
    through ``net`` (the reference weights), or through ``ref_net`` when
    ``net`` is None."""

    def targets(net, windows):
        return kstep_targets(engine_cfg, ref_net if net is None else net,
                             cfg, windows)

    return targets
