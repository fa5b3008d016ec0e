"""Data-parallel actor-learner over a ``torch.distributed`` process group.

Counterpart of ``drl_tetris_tpu/parallel/mesh.py``: the JAX package runs
the whole training system as one program over a mesh 'data' axis (the
games sharded, the parameters replicated, the gradients all-reduced);
here each rank is one process on one device, and the axis is the process
group:

  * actors: each rank steps its ``n_envs / world_size`` games with its
    own net replica (one launch of the engine kernel's one-tick entry per
    tick on the card), its keys folded by its rank as ``lax.axis_index``
    folds them;
  * learner: each rank turns its segment into its own batch (GAE) and
    runs the PPO update on it with ``make_ppo_update(group=...)``, which
    averages the gradients before every Adam step and makes the value
    MSE and the compressors' statistics global, so the replicas stay
    identical with no weight broadcast;
  * the stats are averaged over the ranks.

The backend is NCCL on the card and gloo on the CPU.  NCCL takes one rank
per GPU, so one H100 runs world size 1; world size 2 runs on the CPU.
The mesh path trains single-policy PPO only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from drl_tetris_tpu_torch import resolve_device
from drl_tetris_tpu_torch.algos.ppo import (PPOConfig, make_ppo_update,
                                            mean_over, segment_to_batch)
from drl_tetris_tpu_torch.algos.rollout import make_rollout_fn
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet
from drl_tetris_tpu_torch.runtime.standalone import ppo_state_dict


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    env: EnvConfig = EnvConfig()
    model: ModelConfig = ModelConfig()
    ppo: PPOConfig = PPOConfig()
    n_envs: int = 4096            # global game count, split over the ranks
    horizon: int = 32
    seed: int = 0


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(device, init_method: str, world_size: int = 1,
              rank: int = 0):
    """The process group the data axis runs over (``make_mesh``'s
    counterpart): initialises torch.distributed's default group at
    ``init_method`` (``tcp://host:port``; the caller gives the address,
    the world size and its rank) with NCCL on the card or gloo on the
    CPU, unless it is initialised already, and returns it."""
    if not dist.is_initialized():
        dev = torch.device(device)
        kw = {}
        if dev.type == "cuda":
            kw["device_id"] = torch.device(
                "cuda", torch.cuda.current_device() if dev.index is None
                else dev.index)
        dist.init_process_group(backend_for(dev), init_method=init_method,
                                world_size=world_size, rank=rank, **kw)
    return dist.group.WORLD


class DistributedTrainer:
    """Sharded self-play training: each ``train_iteration`` is a rollout
    segment of this rank's games and a data-parallel PPO update with the
    gradients averaged over ``group``.  The initial weights are flax's
    initialisers from a ``torch.Generator`` seeded with ``seed`` on every
    rank (so the replicas start equal); the games reset from
    ``fold_in(ke, rank)`` with ``_, ke = split(PRNGKey(seed))``; each
    iteration takes ``key, k = split(key)`` from ``PRNGKey(seed + 1)``
    (the JAX CLI's chain), then ``kroll, kupd = split(fold_in(k,
    rank))``.  The pi noise comes from a device generator of the rank or
    is given (``gumbel``)."""

    def __init__(self, cfg: DistributedConfig, group=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = group or dist.group.WORLD
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        if cfg.n_envs % self.world:
            raise ValueError(f"n_envs {cfg.n_envs} does not divide over "
                             f"{self.world} ranks")
        self.n_local = cfg.n_envs // self.world
        e = cfg.env.engine
        self.env = TetrisVectorEnv(cfg.env, self.n_local, device=self.device)
        self.net = PPONet(cfg.model, board=(e.height, e.width),
                          full_network=True, device=self.device)
        self.net.init_flax_(torch.Generator().manual_seed(cfg.seed))
        self.rollout = make_rollout_fn(self.env, self.net, cfg.horizon)
        init_opt, self.update = make_ppo_update(e, self.net, cfg.ppo,
                                                group=self.group)
        self.state = init_opt(self.net)
        _kp, ke = rng.split(rng.prng_key(cfg.seed, self.device))
        self.env_state = self.env.reset(rng.fold_in(ke, self.rank))
        self.key = rng.prng_key(cfg.seed + 1, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            (cfg.seed << 16) + self.rank)
        self.total_steps = 0

    def state_dict(self) -> dict:
        """``StandaloneTrainer.state_dict``'s form (this rank's replica),
        so ``eval`` and ``train --init-from`` read its checkpoints."""
        return {**ppo_state_dict(self.state),
                "total_steps": int(self.total_steps), "key": self.key}

    def train_iteration(self, gumbel: Optional[torch.Tensor] = None):
        """One segment of this rank's games and one data-parallel update
        (``gumbel``: (horizon, n_local, 4 * width) pi noise).  Returns the
        stats averaged over the ranks, as host floats."""
        self.key, k = rng.split(self.key)
        kroll, kupd = rng.split(rng.fold_in(k, self.rank))
        self.env_state, seg, v_last = self.rollout(
            self.env_state, self.generator, gumbel, kroll)
        batch, _ = segment_to_batch(self.cfg.ppo, seg, v_last)
        self.state, stats = self.update(self.state, batch, kupd)
        names = list(stats)
        mean = mean_over(torch.stack([stats[k].to(torch.float32)
                                      for k in names]), self.group)
        self.total_steps += self.cfg.n_envs * self.cfg.horizon
        return dict(zip(names, mean.tolist()))
