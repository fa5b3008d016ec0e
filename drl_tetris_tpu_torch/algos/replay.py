"""On-device prioritized experience replay with k-step windows.

Counterpart of ``drl_tetris_tpu/algos/replay.py`` (reference:
agents/agent_utils/experience_replay.py): ring buffers that live on the
device, and sampling on the device:

  * k-step windows: sample i reads rows [i .. i+k] with a gather (the
    reference's ``k_step_view``, agents/agent_utils/fcns.py:4-10);
  * 'proportional' mode: p ~ (prio + eps)^alpha (experience_replay.py:54);
  * 'rank' mode: p ~ (1/rank)^alpha over the ordinal ranking of the
    priorities (experience_replay.py:47-51), by a stable argsort of -prio,
    as JAX's argsort is stable: new rows all carry prio 2.0 and tie;
  * sampling without replacement by Gumbel-top-k (``torch.topk`` over
    log p + g), with importance weights (n p)^-beta, max-normalised
    (experience_replay.py:58-59).  The gumbel noise follows JAX's key
    (``engine/rng.gumbel``: the port's threefry uniform, then
    -log(-log u)), or is given.

A (T, N) segment is written env-major so each env's run is contiguous in
time; the last k rows of every run get priority 0 so that no sampled
window crosses an env boundary.  Rows hold ``occ`` as int32 bit patterns,
as the rollout's segment does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from drl_tetris_tpu_torch.algos.rollout import Segment
from drl_tetris_tpu_torch.engine import rng

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    capacity: int = 200_000       # experience_replay_size
    k_step: int = 5               # n_step_value_estimates (presets.py:140)
    height: int = 22
    sample_mode: str = "proportional"   # 'rank' | 'proportional'
    eps: float = 1e-4


@dataclasses.dataclass
class ReplayState:
    occ: torch.Tensor      # (M, 2, H) int32 bits
    vec: torch.Tensor      # (M, 2, 12) float32
    piece: torch.Tensor    # (M,) int32
    rot: torch.Tensor      # (M,) int32
    trans: torch.Tensor    # (M,) int32
    reward: torch.Tensor   # (M,) float32
    done: torch.Tensor     # (M,) int32
    prio: torch.Tensor     # (M,) float32; -1 = never written
    cursor: int = 0
    size: int = 0
    total_samples: int = 0

    def nbytes(self) -> int:
        return sum(getattr(self, f.name).numel()
                   * getattr(self, f.name).element_size()
                   for f in dataclasses.fields(self)
                   if torch.is_tensor(getattr(self, f.name)))


def replay_init(cfg: ReplayConfig, device=None) -> ReplayState:
    M, H = cfg.capacity, cfg.height

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return ReplayState(
        occ=z(M, 2, H), vec=z(M, 2, 12, dtype=F32), piece=z(M), rot=z(M),
        trans=z(M), reward=z(M, dtype=F32), done=z(M),
        prio=torch.full((M,), -1.0, dtype=F32, device=device))


def replay_add_segment(cfg: ReplayConfig, st: ReplayState, seg: Segment,
                       horizon: int) -> ReplayState:
    """Insert a (T, N) segment in place.  As add_indices'
    ring (experience_replay.py:130-138): when the write would cross
    max_size = M - k, the cursor wraps to 0 first.  The cursor and size
    are host ints: the segment's size is known without the device."""
    T = horizon
    N = seg.reward.shape[1]
    n = N * T
    max_size = cfg.capacity - cfg.k_step
    if n > max_size:
        raise ValueError(f"a segment of {n} rows exceeds the replay's "
                         f"{max_size}")
    wrap = st.cursor + n > max_size
    start = 0 if wrap else st.cursor
    size0 = max(st.size, st.cursor) if wrap else st.size

    def sw(a):
        return a.transpose(0, 1).reshape((n,) + tuple(a.shape[2:]))
    rows = slice(start, start + n)
    st.occ[rows] = sw(seg.occ)
    st.vec[rows] = sw(seg.vec)
    st.piece[rows] = sw(seg.piece)
    st.rot[rows] = sw(seg.rot)
    st.trans[rows] = sw(seg.trans)
    st.reward[rows] = sw(seg.reward)
    st.done[rows] = sw(seg.done).to(I32)
    # prio 2 ('very large', trajectory.py:82); the last k of each run 0
    pos = torch.arange(T, device=st.prio.device).repeat(N)
    st.prio[rows] = torch.where(pos >= T - cfg.k_step, 0.0, 2.0)
    st.cursor = start + n
    st.size = max(size0, start + n)
    st.total_samples += n
    return st


def sampling_probs(cfg: ReplayConfig, st: ReplayState, alpha
                   ) -> torch.Tensor:
    """(M,) sampling probabilities, 0 past ``size``."""
    M = cfg.capacity
    dev = st.prio.device
    valid = torch.arange(M, device=dev) < st.size
    alpha = float(np.float32(alpha))
    if cfg.sample_mode == "proportional":
        prio = torch.where(valid, torch.clamp(st.prio, min=0.0), 0.0)
        p_un = (prio + cfg.eps) ** alpha
    else:
        # 1-indexed ordinal rank of descending priority; never-written
        # rows (-1) sort last
        order = torch.argsort(-st.prio, stable=True)
        rank = torch.empty(M, dtype=I32, device=dev)
        rank[order] = torch.arange(1, M + 1, dtype=I32, device=dev)
        p_un = (1.0 / rank.to(F32)) ** alpha
    p_un = torch.where(valid, p_un, 0.0)
    return p_un / torch.sum(p_un)


def replay_sample(cfg: ReplayConfig, st: ReplayState, n_samples: int,
                  alpha, beta, key: torch.Tensor,
                  gumbel: Optional[torch.Tensor] = None):
    """Prioritized sample of ``n_samples`` distinct rows and their
    importance weights: (idx (n,) int64, is_weights (n,) float32).  The
    noise is ``gumbel`` (M,) if given, else JAX's draw from ``key``."""
    p = sampling_probs(cfg, st, alpha)
    M = p.shape[0]
    if gumbel is None:
        gumbel = rng.gumbel(key.to(p.device), (M,))
    scores = torch.where(p > 0, torch.log(p) + gumbel.to(p.device),
                         -torch.inf)
    idx = torch.topk(scores, n_samples, sorted=True).indices
    beta = float(np.float32(beta))
    n_eff = float(max(st.size, 1))
    iw_all = (n_eff * torch.clamp(p, min=1e-30)) ** (-beta)
    iw_all = torch.where(p > 0, iw_all, 0.0)
    iw = iw_all[idx] / torch.clamp(torch.max(iw_all), min=1e-30)
    return idx, iw


def replay_gather_windows(cfg: ReplayConfig, st: ReplayState,
                          idx: torch.Tensor) -> dict:
    """The k-step windows [i .. i+k] of the sampled rows, clipped to the
    buffer: occ (n, k+1, 2, H), vec (n, k+1, 2, 12), reward and done
    (n, k+1); piece, rot and trans of row i (n,)."""
    k = cfg.k_step
    win = idx[:, None] + torch.arange(k + 1, device=idx.device)[None, :]
    win = torch.clamp(win, 0, cfg.capacity - 1)
    return dict(occ=st.occ[win], vec=st.vec[win], piece=st.piece[idx],
                rot=st.rot[idx], trans=st.trans[idx],
                reward=st.reward[win], done=st.done[win])


def replay_update_prios(st: ReplayState, idx: torch.Tensor,
                        new_prios: torch.Tensor) -> ReplayState:
    st.prio[idx] = new_prios.to(F32)
    return st
