"""Standalone single-process self-play training (SVENton-PPO, one card).

Counterpart of ``drl_tetris_tpu/runtime/standalone.py`` (``StandaloneConfig``,
``StandaloneTrainer``; the reference's run_standalone mode, presets.py:157,
sventon_agent.py:42-47, 140-144): worker and trainer in one process, one
module for both, so the worker's weights are the learner's.  An iteration
is the rollout segment (one launch of the engine kernel's one-tick entry
per tick), GAE, and the PPO update with ``torch.optim.Adam``; the stats
come back to the host in one transfer at its end.

The key chain is the JAX package's, through the port's threefry
(``engine/rng.py``): ``PRNGKey(seed) -> split 3`` (key, kinit, kenv), then
per iteration ``key, kstep = split(key)`` and ``kroll, kupd = split(kstep)``;
``kupd`` shuffles the minibatches exactly as JAX does.  Two streams differ
from JAX: the initial weights are drawn with flax's initialisers from a
``torch.Generator`` seeded with ``seed`` (kinit is unused), and the
rollout's sampling noise comes from a ``torch.Generator`` on the device
seeded with ``seed`` (kroll is unused); ``train_iteration(gumbel=...)``
takes given noise instead, so a test can replay JAX's draws.

``state_dict()``/``load_state_dict()`` carry the whole trainer state (the
net, Adam's moments, steps and lr, the compressors, ``update_count``,
``total_steps`` and the key) through ``runtime/checkpoint.py``;
``resume`` and ``init_params`` are the CLI's ``--resume`` and
``--init-from`` (drl_tetris_tpu/cli/main.py:315-362).  The env state is
not saved: a resumed run resets its games, as the JAX package's does.

League-pool opponents and reward shapers wait for a later slice (ROADMAP
item 9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from drl_tetris_tpu_torch import resolve_device
from drl_tetris_tpu_torch.algos.ppo import (CompressorState, PPOConfig,
                                            make_ppo_update,
                                            segment_to_batch,
                                            set_learning_rate)
from drl_tetris_tpu_torch.algos.rollout import make_rollout_fn
from drl_tetris_tpu_torch.config.parameter import param_eval
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet
from drl_tetris_tpu_torch.utils.metrics import fetch_stats


@dataclasses.dataclass(frozen=True)
class StandaloneConfig:
    env: EnvConfig = EnvConfig()
    model: ModelConfig = ModelConfig()
    ppo: PPOConfig = PPOConfig()
    n_envs: int = 30              # n_envs_per_thread (sventon_ppo.py:64)
    horizon: int = 72             # ticks per segment
    seed: int = 0
    # value_lr as a Parameter(t) schedule, re-evaluated at the env-steps
    # trained so far before each iteration; None keeps ppo.lr
    lr_schedule: Any = None
    pool_prob: float = 0.0        # league-pool opponents: not ported yet
    reward_shaper: Any = None     # not ported yet


class _PhaseClock:
    """Times the phases of an iteration without waiting for the device:
    CUDA events on the card (read after the iteration's one sync), the
    host clock on the CPU, where every operation has finished on return."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self, name: str):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def spans_ms(self) -> dict:
        """{phase: ms} between consecutive marks (the device is synced)."""
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out


class StandaloneTrainer:
    def __init__(self, cfg: StandaloneConfig, device=None):
        if cfg.pool_prob > 0:
            raise NotImplementedError(
                "league-pool opponents wait for a later slice (ROADMAP 9)")
        if cfg.reward_shaper is not None:
            raise NotImplementedError(
                "reward shapers wait for a later slice (ROADMAP 9)")
        self.cfg = cfg
        self.device = resolve_device(device)
        e = cfg.env.engine
        self.env = TetrisVectorEnv(cfg.env, cfg.n_envs, device=self.device)
        self.net = PPONet(cfg.model, board=(e.height, e.width),
                          full_network=True, device=self.device)
        self.net.init_flax_(torch.Generator().manual_seed(cfg.seed))
        self.rollout = make_rollout_fn(self.env, self.net, cfg.horizon)
        self.init_opt, self.update = make_ppo_update(e, self.net, cfg.ppo)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)

        key = rng.prng_key(cfg.seed, self.device)
        self.key, _kinit, kenv = rng.split(key, 3)
        self.state = self.init_opt(self.net)
        self.env_state = self.env.reset(kenv)
        self.total_steps = 0
        self.stats = {}
        self.phase_ms = {}

    def ppo_state_dict(self) -> dict:
        """The learner's state as a nested dict of tensors under the net's
        parameter names (the form of ``models/convert.ppo_state_from_flax``):
        ``params``; ``adam`` (``lr``, ``betas``, ``eps`` and per parameter
        ``step``, ``exp_avg``, ``exp_avg_sq``; zeros at step 0 before the
        first update); ``adv_comp``, ``vloss_comp``; ``update_count``.
        The tensors are the live ones, not copies."""
        opt = self.state.optimizer
        group = opt.param_groups[0]
        adam = {"lr": float(group["lr"]),
                "betas": tuple(float(b) for b in group["betas"]),
                "eps": float(group["eps"]),
                "step": {}, "exp_avg": {}, "exp_avg_sq": {}}
        for name, p in self.net.named_parameters():
            st = opt.state.get(p)
            adam["step"][name] = st["step"] if st else torch.zeros(())
            for k in ("exp_avg", "exp_avg_sq"):
                adam[k][name] = st[k] if st else torch.zeros_like(p)
        return {"params": self.net.state_dict(), "adam": adam,
                "adv_comp": self.state.adv_comp._asdict(),
                "vloss_comp": self.state.vloss_comp._asdict(),
                "update_count": int(self.state.update_count)}

    def load_ppo_state(self, sd: dict):
        """Set the learner's state from ``ppo_state_dict``'s form (tensors
        or numpy arrays, on any device)."""
        dev = self.device
        self.net.load_params_(sd["params"])
        opt = self.state.optimizer
        adam = sd["adam"]
        for group in opt.param_groups:
            group["lr"] = float(adam["lr"])
            group["betas"] = tuple(float(b) for b in adam["betas"])
            group["eps"] = float(adam["eps"])
        for name, p in self.net.named_parameters():
            # torch keeps Adam's step as a float32 host tensor
            opt.state[p] = {
                "step": torch.as_tensor(adam["step"][name]).to(
                    "cpu", torch.float32).clone(),
                **{k: torch.as_tensor(adam[k][name]).to(dev, p.dtype).clone()
                   for k in ("exp_avg", "exp_avg_sq")}}

        def comp(c):
            return CompressorState(*[torch.as_tensor(c[k]).to(
                dev, torch.float32).clone() for k in CompressorState._fields])
        self.state.adv_comp = comp(sd["adv_comp"])
        self.state.vloss_comp = comp(sd["vloss_comp"])
        self.state.update_count = int(sd["update_count"])

    def state_dict(self) -> dict:
        """``ppo_state_dict`` plus ``total_steps`` and the key."""
        return {**self.ppo_state_dict(), "total_steps": int(self.total_steps),
                "key": self.key}

    def load_state_dict(self, sd: dict):
        """The whole trainer state back, as ``state_dict`` gave it."""
        self.load_ppo_state(sd)
        self.total_steps = int(sd["total_steps"])
        self.key = torch.as_tensor(sd["key"]).to(self.device, torch.int64)

    def resume(self, state: dict, step: int):
        """``train --resume`` on a fresh trainer (cli/main.py:315-345):
        the learner's state from ``state`` (a checkpoint of this run, or a
        converted JAX ``PPOState``), ``total_steps = step``, and the key
        chain moved past the first segment with ``fold_in(key, step)``.
        The games keep their fresh reset."""
        self.load_ppo_state(state)
        self.total_steps = int(step)
        self.key = rng.fold_in(self.key, int(step))

    def init_params(self, params: dict):
        """``train --init-from`` (cli/main.py:346-362): a checkpoint's net
        weights into this trainer; Adam and the compressors stay fresh."""
        self.net.load_params_(params)

    def train_iteration(self, gumbel: Optional[torch.Tensor] = None):
        """One worker segment and one PPO update (trainer.py:71-75);
        ``gumbel`` ((horizon, n_envs, 4 * width)) replaces the rollout's
        sampling noise.  Returns the stats as host floats; ``phase_ms``
        then holds the rollout, GAE and update times in ms."""
        cfg = self.cfg
        if cfg.lr_schedule is not None:
            set_learning_rate(self.state,
                              param_eval(cfg.lr_schedule, self.total_steps))
        self.key, kstep = rng.split(self.key)
        _kroll, kupd = rng.split(kstep)
        clock = _PhaseClock(self.device)
        clock.mark("start")
        self.env_state, seg, v_last = self.rollout(
            self.env_state, self.generator, gumbel)
        clock.mark("rollout")
        batch, gae_stats = segment_to_batch(cfg.ppo, seg, v_last)
        clock.mark("gae")
        self.state, stats = self.update(self.state, batch, kupd)
        clock.mark("update")
        stats.update(gae_stats)
        self.total_steps += cfg.n_envs * cfg.horizon
        self.stats = fetch_stats(stats)           # the iteration's one sync
        self.phase_ms = clock.spans_ms()
        return self.stats

    def run(self, n_iterations: int, log_every: int = 1, logger=print):
        for it in range(n_iterations):
            t0 = time.time()
            stats = self.train_iteration()
            dt = time.time() - t0
            if it % log_every == 0:
                sps = self.cfg.n_envs * self.cfg.horizon / dt
                logger(f"iter {it}: {sps:,.0f} env-steps/s  "
                       f"loss={stats['losses/total_loss']:.4f}  "
                       f"entropy={stats['entropy/entropy']:.3f}  "
                       f"clip_sat={stats['misc/clip_saturation']:.3f}")
        return self.stats
