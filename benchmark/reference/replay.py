# Frozen copy of ``replay_add_segment``, ``sampling_probs``,
# ``replay_sample`` and ``replay_gather_windows`` of
# drl_tetris_tpu_torch/algos/replay.py at commit
# 19b7261806ffa5740b75ff89fdfc53fa8692c191, part of the benchmark's plain
# reference.  Changed from the copy: the replay is a dict of tensors with
# its cursor and size, the configuration is given as values, a segment is
# a dict of (T, N) tensors, the add is split into the rows it writes and
# where it writes them (``add_rows``, ``add_place``), and the sample's
# gumbel noise is drawn by the reference's threefry (``noise``).
"""The prioritized replay's add, rank sample and k-step windows in plain
PyTorch.  Rank mode: p ~ (1 / rank)^alpha over the ordinal ranking of the
priorities (a stable argsort of -prio, so ties keep row order); sampling
without replacement by Gumbel-top-k over log p + g, importance weights
(n p)^-beta over their largest.  A (T, N) segment is written env-major at
the cursor (wrapping to 0 first when it would cross capacity - k), new rows
at priority 2 and the last k of each game's run at 0."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import rng

I32 = torch.int32
F32 = torch.float32
FIELDS = ("occ", "vec", "piece", "rot", "trans", "reward", "done")


def add_rows(seg: Dict[str, torch.Tensor], k_step: int
             ) -> Dict[str, torch.Tensor]:
    """The rows a (T, N) segment adds, env-major: the FIELDS and prio."""
    T, N = seg["reward"].shape
    n = N * T
    rows = {f: seg[f].transpose(0, 1).reshape((n,) + tuple(seg[f].shape[2:]))
            for f in FIELDS}
    pos = torch.arange(T, device=seg["reward"].device).repeat(N)
    rows["prio"] = torch.where(pos >= T - k_step, 0.0, 2.0)
    return rows


def add_place(cursor: int, size: int, n: int, capacity: int, k_step: int):
    """(first row written, cursor, size) of an add of n rows."""
    wrap = cursor + n > capacity - k_step
    start = 0 if wrap else cursor
    size0 = max(size, cursor) if wrap else size
    return start, start + n, max(size0, start + n)


def add_segment(replay: Dict, seg: Dict[str, torch.Tensor], capacity: int,
                k_step: int) -> Dict:
    """Insert a (T, N) segment in place; ``replay`` holds the FIELDS, prio,
    cursor and size."""
    rows = add_rows(seg, k_step)
    n = rows["prio"].shape[0]
    start, replay["cursor"], replay["size"] = add_place(
        replay["cursor"], replay["size"], n, capacity, k_step)
    for f, v in rows.items():
        replay[f][start:start + n] = v.to(replay[f].device, replay[f].dtype)
    return replay


def noise(key: torch.Tensor, capacity: int) -> torch.Tensor:
    """The sample's gumbel noise (capacity,) from the key ks of the
    update's split(key): JAX's draw."""
    return rng.gumbel(rng.u32(key), (capacity,))


def sampling_probs(prio: torch.Tensor, size: int, alpha,
                   mode: str = "rank", eps: float = 1e-4) -> torch.Tensor:
    """(M,) sampling probabilities, 0 past ``size``."""
    M = prio.shape[0]
    dev = prio.device
    valid = torch.arange(M, device=dev) < size
    alpha = float(np.float32(alpha))
    if mode == "proportional":
        p = torch.where(valid, torch.clamp(prio, min=0.0), 0.0)
        p_un = (p + eps) ** alpha
    else:
        order = torch.argsort(-prio, stable=True)
        rank = torch.empty(M, dtype=I32, device=dev)
        rank[order] = torch.arange(1, M + 1, dtype=I32, device=dev)
        p_un = (1.0 / rank.to(F32)) ** alpha
    p_un = torch.where(valid, p_un, 0.0)
    return p_un / torch.sum(p_un)


def sample(prio: torch.Tensor, size: int, n_samples: int, alpha, beta,
           gumbel: torch.Tensor, mode: str = "rank"):
    """(idx (n,) int64, is_weights (n,) float32) of the prioritized sample
    with the given noise (M,)."""
    p = sampling_probs(prio, size, alpha, mode)
    scores = torch.where(p > 0, torch.log(p) + gumbel.to(p.device),
                         -torch.inf)
    idx = torch.topk(scores, n_samples, sorted=True).indices
    beta = float(np.float32(beta))
    n_eff = float(max(size, 1))
    iw_all = (n_eff * torch.clamp(p, min=1e-30)) ** (-beta)
    iw_all = torch.where(p > 0, iw_all, 0.0)
    iw = iw_all[idx] / torch.clamp(torch.max(iw_all), min=1e-30)
    return idx, iw


def gather_windows(replay: Dict, idx: torch.Tensor, capacity: int,
                   k_step: int) -> Dict[str, torch.Tensor]:
    """The k-step windows [i .. i+k] of the sampled rows, clipped to the
    buffer: occ (n, k+1, 2, H), vec (n, k+1, 2, 12), reward and done
    (n, k+1); piece of row i (n,)."""
    win = idx[:, None] + torch.arange(k_step + 1, device=idx.device)[None, :]
    win = torch.clamp(win, 0, capacity - 1)
    return dict(occ=replay["occ"][win], vec=replay["vec"][win],
                piece=replay["piece"][idx], reward=replay["reward"][win],
                done=replay["done"][win])
