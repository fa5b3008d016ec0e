"""Standalone single-process self-play training (SVENton-PPO and
SVENton-DQN, one card).

Counterpart of ``drl_tetris_tpu/runtime/standalone.py`` (``StandaloneConfig``,
``StandaloneTrainer``, ``StandaloneDQNConfig``, ``StandaloneDQNTrainer``;
the reference's run_standalone mode, presets.py:157, sventon_agent.py:42-47,
140-144): worker and trainer in one process, one module for both, so the
worker's weights are the learner's.  A PPO iteration is the rollout
segment (one launch of the engine kernel's one-tick entry per tick), the
optional reward shaper, GAE (or the k-step windows when the trainer
computes targets), and the PPO update with ``torch.optim.Adam``; the stats
come back to the host in one transfer at its end.

The key chain is the JAX package's, through the port's threefry
(``engine/rng.py``): ``PRNGKey(seed) -> split 3`` (key, kinit, kenv), then
per iteration ``key, kstep = split(key)`` and ``kroll, kupd = split(kstep)``.
Every stream is JAX's, so a seed gives the JAX trainer's run: ``kinit``
draws the initial weights as flax's ``net.init`` does
(models/flax_init.py), ``kroll`` the rollout's sampling noise (one
categorical per tick, drawn for all ticks at once), and ``kupd`` shuffles
the minibatches.  ``train_iteration(gumbel=...)`` takes given noise
instead.

``state_dict()``/``load_state_dict()`` carry the whole trainer state (the
net, Adam's moments, steps and lr, the compressors, ``update_count``,
``total_steps`` and the key) through ``runtime/checkpoint.py``;
``resume`` and ``init_params`` are the CLI's ``--resume`` and
``--init-from`` (drl_tetris_tpu/cli/main.py:315-362).  The env state is
not saved: a resumed run resets its games, as the JAX package's does.

League-pool opponents (``pool_prob > 0``): with that probability an
iteration plays a frozen past snapshot instead of itself, the learner on
alternating seats, and trains on its own ticks only; snapshots join the
pool every ``pool_every`` iterations or through ``seed_pool`` (the CLI's
``--pool-seed``).  Opponents are drawn uniformly or by PFSP weights
w(1-w) (floor 0.02) from each entry's win-rate EMA, with
``np.random.RandomState(seed + 7)`` as in JAX, so the opponent sequence is
JAX's.

The DQN trainer acts with epsilon-greedy or pareto sampling into the
on-device prioritized replay, and updates once the replay holds
``n_samples_each_update`` rows: the sample follows JAX's key, the targets
go through the reference net, then IS-weighted Q steps with Adam.  Its
rollout key chain is JAX's (``key, kroll, kupd = split(key, 3)``): the
epsilon draws and pareto's gumbel noise follow ``kroll`` (or the noise is
given).  The replay is not saved: a resumed run starts
it empty, as the JAX CLI's does.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from drl_tetris_tpu_torch import resolve_device
from drl_tetris_tpu_torch.algos.dqn import (DQNConfig, DQNState,
                                            make_dqn_update)
from drl_tetris_tpu_torch.algos.dual import (WinRateTracker,
                                             dual_policy_subsegment,
                                             make_dual_rollout_fn,
                                             merge_dual_transitions,
                                             split_dual_segment)
from drl_tetris_tpu_torch.algos.ppo import (CompressorState, PPOConfig,
                                            PPOState, frozen_copy,
                                            make_ppo_update,
                                            pool_segment_to_batch,
                                            segment_to_batch,
                                            segment_to_windows,
                                            set_learning_rate)
from drl_tetris_tpu_torch.algos.replay import (ReplayConfig,
                                               replay_add_segment,
                                               replay_init)
from drl_tetris_tpu_torch.algos.rollout import (HParams,
                                                make_pool_rollout_fn,
                                                make_rollout_fn)
from drl_tetris_tpu_torch.config.parameter import param_eval
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet, QNet
from drl_tetris_tpu_torch.utils.metrics import fetch_stats


def _traj_len_ema(done_tn: torch.Tensor, ep_len: torch.Tensor, atl,
                  tau: float):
    """Fold a segment's done flags into the average-trajectory-length EMA
    (sherlock_agent.py:173: atl <- (1-tau) atl + tau len, one step per
    finished round, in (tick, env) order; ep_len carries partial lengths
    across segments).  On the device with no host sync: each round's
    length from a running max of the done ticks, and the K folds in closed
    form, atl (1-tau)^K + sum_k tau (1-tau)^(K-k) len_k, in float64.
    Returns (ep_len' (N,) int32, atl' () float32)."""
    d = done_tn.to(torch.bool)
    T, N = d.shape
    dev = d.device
    ticks = torch.arange(1, T + 1, device=dev)[:, None]      # t + 1
    mark = torch.where(d, ticks, 0)
    # (t + 1) of the last done strictly before tick t, 0 if none
    prev = torch.cummax(torch.cat([torch.zeros_like(mark[:1]), mark[:-1]]),
                        dim=0).values
    length = ticks - prev + torch.where(prev == 0, ep_len.to(torch.int64),
                                        0)
    new_ep_len = torch.where(d[-1], 0, length[-1]).to(torch.int32)
    flat = d.reshape(-1)
    k = torch.cumsum(flat.to(torch.int64), 0)                # 1-based
    K = k[-1]
    decay = torch.tensor(1.0 - tau, dtype=torch.float64, device=dev)
    w = torch.where(flat, tau * decay ** (K - k).to(torch.float64), 0.0)
    atl = torch.as_tensor(atl, dtype=torch.float64, device=dev)
    out = atl * decay ** K.to(torch.float64) + torch.sum(
        w * length.reshape(-1).to(torch.float64))
    return new_ep_len, out.to(torch.float32)


def _traj_len_ema_host(done_tn, ep_len, atl, tau):
    """The same fold as a host double loop (the JAX package's host form),
    for holding the device form against it."""
    d = np.asarray(done_tn)
    ep_len = np.asarray(ep_len).copy()
    for t in range(d.shape[0]):
        ep_len += 1
        fin = np.flatnonzero(d[t])
        for length in ep_len[fin]:
            atl = (1.0 - tau) * atl + tau * float(length)
        ep_len[fin] = 0
    return ep_len, atl


def adam_state_dict(net: torch.nn.Module, opt: torch.optim.Adam) -> dict:
    """Adam's state under the net's parameter names: ``lr``, ``betas``,
    ``eps`` and per parameter ``step``, ``exp_avg``, ``exp_avg_sq`` (zeros
    at step 0 before the first step).  The tensors are the live ones."""
    group = opt.param_groups[0]
    adam = {"lr": float(group["lr"]),
            "betas": tuple(float(b) for b in group["betas"]),
            "eps": float(group["eps"]),
            "step": {}, "exp_avg": {}, "exp_avg_sq": {}}
    for name, p in net.named_parameters():
        st = opt.state.get(p)
        adam["step"][name] = st["step"] if st else torch.zeros(())
        for k in ("exp_avg", "exp_avg_sq"):
            adam[k][name] = st[k] if st else torch.zeros_like(p)
    return adam


def load_adam_state(net: torch.nn.Module, opt: torch.optim.Adam,
                    adam: dict):
    """Set Adam's state from ``adam_state_dict``'s form (tensors or numpy
    arrays, on any device)."""
    for group in opt.param_groups:
        group["lr"] = float(adam["lr"])
        group["betas"] = tuple(float(b) for b in adam["betas"])
        group["eps"] = float(adam["eps"])
    for name, p in net.named_parameters():
        # torch keeps Adam's step as a float32 host tensor
        opt.state[p] = {
            "step": torch.as_tensor(adam["step"][name]).to(
                "cpu", torch.float32).clone(),
            **{k: torch.as_tensor(adam[k][name]).to(p.device, p.dtype).clone()
               for k in ("exp_avg", "exp_avg_sq")}}


def ppo_state_dict(st: PPOState) -> dict:
    """A PPO learner's state as a nested dict of tensors under the net's
    parameter names (the form of ``models/convert.ppo_state_from_flax``):
    ``params``; ``adam`` (``adam_state_dict``); ``adv_comp``,
    ``vloss_comp``; ``update_count``; with trainer-computed targets also
    ``ref_params`` and ``ref_countdown``.  The tensors are the live ones,
    not copies."""
    out = {"params": st.net.state_dict(),
           "adam": adam_state_dict(st.net, st.optimizer),
           "adv_comp": st.adv_comp._asdict(),
           "vloss_comp": st.vloss_comp._asdict(),
           "update_count": int(st.update_count)}
    if st.ref_net is not None:
        out["ref_params"] = st.ref_net.state_dict()
        out["ref_countdown"] = int(st.ref_countdown)
    return out


def load_ppo_state(st: PPOState, sd: dict):
    """Set a PPO learner's state from ``ppo_state_dict``'s form (tensors
    or numpy arrays, on any device)."""
    dev = next(st.net.parameters()).device
    st.net.load_params_(sd["params"])
    load_adam_state(st.net, st.optimizer, sd["adam"])

    def comp(c):
        return CompressorState(*[torch.as_tensor(c[k]).to(
            dev, torch.float32).clone() for k in CompressorState._fields])
    st.adv_comp = comp(sd["adv_comp"])
    st.vloss_comp = comp(sd["vloss_comp"])
    st.update_count = int(sd["update_count"])
    if st.ref_net is not None:
        if sd.get("ref_params") is None:
            raise ValueError("the state has no reference net, and this "
                             "trainer computes targets through one")
        st.ref_net.load_params_(sd["ref_params"])
        st.ref_countdown = int(sd["ref_countdown"])


def dqn_state_dict(st: DQNState) -> dict:
    """A DQN learner's state (the form of
    ``models/convert.dqn_state_from_flax``): ``params``, ``ref_params``,
    ``adam`` and ``update_count``; live tensors."""
    return {"params": st.net.state_dict(),
            "ref_params": st.ref_net.state_dict(),
            "adam": adam_state_dict(st.net, st.optimizer),
            "update_count": int(st.update_count)}


def load_dqn_state(st, sd: dict):
    """Set a learner with a reference net (``DQNState``, ``SixtenState``)
    from ``dqn_state_dict``'s form."""
    st.net.load_params_(sd["params"])
    st.ref_net.load_params_(sd["ref_params"])
    load_adam_state(st.net, st.optimizer, sd["adam"])
    st.update_count = int(sd["update_count"])


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
    # league-pool opponents: with probability pool_prob an iteration plays
    # a frozen past snapshot; a snapshot joins every pool_every iterations
    # (0 = never); "uniform" or "pfsp" (w(1-w) weights from each entry's
    # learner win-rate EMA, step pool_wr_lr per pool iteration)
    pool_prob: float = 0.0
    pool_size: int = 4
    pool_every: int = 0
    pool_mode: str = "uniform"
    pool_wr_lr: float = 0.05
    # shape(rewards, dones) applied to segments before GAE
    # (algos/reward_shapers.make_shaper; trajectory.py:59)
    reward_shaper: Any = None


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
        """{phase: ms} between consecutive marks, summed over the spans
        that end in the same name (the device is synced)."""
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out


class StandaloneTrainer:
    def __init__(self, cfg: StandaloneConfig, device=None):
        wca = cfg.ppo.workers_computes_advantages
        if cfg.pool_prob > 0 and not wca:
            raise ValueError("pool training uses worker-side GAE "
                             "(workers_computes_advantages=True)")
        if cfg.pool_mode not in ("uniform", "pfsp"):
            raise ValueError(f"pool_mode {cfg.pool_mode!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        e = cfg.env.engine
        self.env = TetrisVectorEnv(cfg.env, cfg.n_envs, device=self.device)
        key = rng.prng_key(cfg.seed, self.device)
        self.key, kinit, kenv = rng.split(key, 3)
        self.net = PPONet(cfg.model, board=(e.height, e.width),
                          full_network=True, device=self.device)
        self.net.init_flax_(kinit)
        # workers run the value-stream-free net when the trainer computes
        # targets (ppo_nets.py:28): the value tower is skipped on every
        # rollout tick; the view shares the net's trunk tensors
        self.worker_net = self.net if wca else self.net.worker_view()
        self.rollout = make_rollout_fn(self.env, self.worker_net, cfg.horizon)
        self.init_opt, self.update = make_ppo_update(e, self.net, cfg.ppo)

        # league-pool opponents: frozen nets and their learner win-rate
        # EMAs, in lockstep (deque eviction keeps them aligned)
        self._pool = collections.deque(maxlen=cfg.pool_size)
        self._pool_wr = collections.deque(maxlen=cfg.pool_size)
        self._iter = 0
        if cfg.pool_prob > 0:
            self._host_rng = np.random.RandomState(cfg.seed + 7)
            self.pool_rollout = make_pool_rollout_fn(
                self.env, self.worker_net, cfg.horizon)

        self.state = self.init_opt(self.net)
        self.env_state = self.env.reset(kenv)
        self.total_steps = 0
        self.stats = {}
        self.phase_ms = {}

    def ppo_state_dict(self) -> dict:
        """``ppo_state_dict(self.state)``."""
        return ppo_state_dict(self.state)

    def load_ppo_state(self, sd: dict):
        """``load_ppo_state(self.state, sd)``."""
        load_ppo_state(self.state, sd)

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
        The games keep their fresh reset; the pool starts empty."""
        self.load_ppo_state(state)
        self.total_steps = int(step)
        self.key = rng.fold_in(self.key, int(step))

    def init_params(self, params: dict):
        """``train --init-from`` (cli/main.py:346-362): a checkpoint's net
        weights into this trainer; Adam and the compressors stay fresh."""
        self.net.load_params_(params)

    def _snapshot(self) -> torch.nn.Module:
        return frozen_copy(self.net).eval()

    def seed_pool(self, params: dict) -> None:
        """Add a frozen opponent with ``params`` (a checkpoint's net
        weights) to the pool: the CLI's ``--pool-seed``."""
        snap = self._snapshot()
        snap.load_params_(params)
        self._pool.append(snap)
        self._pool_wr.append(0.5)

    def _pick_opponent(self) -> int:
        """A uniform draw, or PFSP weights w(1-w) with a floor of 0.02:
        even matches carry the most signal, and the floor keeps every
        entry in play."""
        if self.cfg.pool_mode != "pfsp" or len(self._pool) == 1:
            return int(self._host_rng.randint(len(self._pool)))
        wr = np.asarray(self._pool_wr, np.float64)
        wgt = np.maximum(wr * (1.0 - wr), 0.02)
        return int(self._host_rng.choice(len(self._pool), p=wgt / wgt.sum()))

    def train_iteration(self, gumbel: Optional[torch.Tensor] = None):
        """One worker segment and one PPO update (trainer.py:71-75),
        against a pool opponent with probability ``pool_prob``; ``gumbel``
        ((horizon, n_envs, 4 * width)) replaces the rollout's sampling
        noise.  Returns the stats as host floats; ``phase_ms`` then holds
        the rollout, batch (GAE or windows) and update times in ms."""
        cfg = self.cfg
        if cfg.lr_schedule is not None:
            set_learning_rate(self.state,
                              param_eval(cfg.lr_schedule, self.total_steps))
        self.key, kstep = rng.split(self.key)
        use_pool = (len(self._pool) > 0
                    and self._host_rng.rand() < cfg.pool_prob)
        kroll, kupd = rng.split(kstep)
        clock = _PhaseClock(self.device)
        clock.mark("start")
        if use_pool:
            idx = self._pick_opponent()
            learner_first = self._iter % 2 == 0
            self.env_state, seg, v_last = self.pool_rollout(
                self._pool[idx], self.env_state, kroll, gumbel,
                learner_first=learner_first)
        else:
            self.env_state, seg, v_last = self.rollout(
                self.env_state, kroll, gumbel)
        clock.mark("rollout")
        if cfg.reward_shaper is not None:
            seg = seg._replace(reward=cfg.reward_shaper(seg.reward, seg.done))
        if use_pool:
            lp = 0 if learner_first else 1
            batch, batch_stats = pool_segment_to_batch(cfg.ppo, seg, v_last,
                                                       learner_parity=lp)
            # the learner's outcomes against this opponent: at a done tick
            # the acting player's reward is +-1 zero-sum, so the learner's
            # is the reward on its parity and the negation elsewhere
            parity = (torch.arange(seg.done.shape[0],
                                   device=self.device) % 2)[:, None]
            lrew = torch.where(parity == lp, seg.reward, -seg.reward)
            batch_stats["pool/wins"] = (seg.done & (lrew > 0)).sum()
            batch_stats["pool/losses"] = (seg.done & (lrew < 0)).sum()
        elif cfg.ppo.workers_computes_advantages:
            batch, batch_stats = segment_to_batch(cfg.ppo, seg, v_last)
        else:
            batch, batch_stats = segment_to_windows(cfg.ppo, seg), {}
        clock.mark("gae")
        self.state, stats = self.update(self.state, batch, kupd)
        clock.mark("update")
        stats.update(batch_stats)
        stats = fetch_stats(stats)                # the iteration's one sync
        if use_pool:
            # fold this segment's finished rounds into the opponent's
            # win-rate EMA
            w, lost = stats.pop("pool/wins"), stats.pop("pool/losses")
            if w + lost > 0:
                self._pool_wr[idx] = ((1 - cfg.pool_wr_lr) * self._pool_wr[idx]
                                      + cfg.pool_wr_lr * w / (w + lost))
            stats["pool/opponent_winrate_ema"] = self._pool_wr[idx]
        self._iter += 1
        if cfg.pool_every and self._iter % cfg.pool_every == 0:
            self._pool.append(self._snapshot())
            self._pool_wr.append(0.5)
        self.total_steps += cfg.n_envs * cfg.horizon
        self.stats = stats
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


class _DQNActing:
    """What both DQN trainers share: epsilon and temperature at the
    env-steps trained so far, adaptive_epsilon's trajectory-length EMA
    (sherlock_agent.py:39, 173) and the replay's alpha and beta.  Needs
    ``cfg`` (n_envs, epsilon, action_temperature, tau_learning_rate,
    train_distribution, dqn), ``device`` and ``total_steps``."""

    def _init_acting(self):
        self._ep_len = torch.zeros(self.cfg.n_envs, dtype=torch.int32,
                                   device=self.device)
        self.avg_traj_len = 12.0      # sherlock_agent.py:39 init

    def _hparams(self) -> HParams:
        t = self.total_steps
        return HParams(epsilon=param_eval(self.cfg.epsilon, t),
                       temperature=param_eval(self.cfg.action_temperature, t),
                       avg_traj_len=self.avg_traj_len)

    def _track_traj_len(self, done: torch.Tensor):
        """Fold a segment's (T, N) dones into the EMA (adaptive_epsilon
        only)."""
        if self.cfg.train_distribution == "adaptive_epsilon":
            self._ep_len, self.avg_traj_len = _traj_len_ema(
                done, self._ep_len, self.avg_traj_len,
                self.cfg.tau_learning_rate)

    def _alpha_beta(self):
        t = self.total_steps
        return (param_eval(self.cfg.dqn.alpha, t),
                param_eval(self.cfg.dqn.beta, t))


@dataclasses.dataclass(frozen=True)
class StandaloneDQNConfig:
    env: EnvConfig = EnvConfig()
    model: ModelConfig = ModelConfig()
    dqn: DQNConfig = DQNConfig()
    replay: ReplayConfig = ReplayConfig()
    n_envs: int = 80              # legacy DQN shape (sventon_base.py:80)
    horizon: int = 32
    train_distribution: str = "epsilon"   # presets.py:80
    epsilon: Any = 0.05           # ParamLike: evaluated per iteration
    action_temperature: Any = 1.0
    tau_learning_rate: float = 0.01
    seed: int = 0


class _RefNetLearner:
    """State handling shared by the learners with a reference net (the
    DQN and SIXten trainers; ``state`` has net, ref_net, optimizer and
    update_count): checkpoints, ``--resume`` and ``--init-from``.  The
    replay is not saved: a resumed run starts it empty."""

    def dqn_state_dict(self) -> dict:
        """``dqn_state_dict(self.state)``."""
        return dqn_state_dict(self.state)

    def load_dqn_state(self, sd: dict):
        """``load_dqn_state(self.state, sd)``."""
        load_dqn_state(self.state, sd)

    def state_dict(self) -> dict:
        """``dqn_state_dict`` plus ``total_steps`` and the key (not the
        replay)."""
        return {**self.dqn_state_dict(), "total_steps": int(self.total_steps),
                "key": self.key}

    def load_state_dict(self, sd: dict):
        self.load_dqn_state(sd)
        self.total_steps = int(sd["total_steps"])
        self.key = torch.as_tensor(sd["key"]).to(self.device, torch.int64)

    def resume(self, state: dict, step: int):
        """``train --resume``: the learner's state, ``total_steps = step``,
        ``fold_in(key, step)``; the games reset and the replay is empty."""
        self.load_dqn_state(state)
        self.total_steps = int(step)
        self.key = rng.fold_in(self.key, int(step))

    def init_params(self, params: dict):
        """``train --init-from``: the weights into the net and the
        reference net; Adam stays fresh."""
        self.net.load_params_(params)
        self.state.ref_net.load_params_(params)


class StandaloneDQNTrainer(_RefNetLearner, _DQNActing):
    """SVENton-DQN in one process: epsilon-greedy (or pareto) rollouts into
    the on-device prioritized replay, k-step lambda targets through the
    reference net, IS-weighted Q updates (sventon_agent_dqn_trainer.py).
    The key chain is JAX's (``key, kinit, kenv = split(PRNGKey(seed), 3)``,
    then ``key, kroll, kupd = split(key, 3)`` per iteration) and every
    draw follows it, the initial weights included."""

    def __init__(self, cfg: StandaloneDQNConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        e = cfg.env.engine
        self.env = TetrisVectorEnv(cfg.env, cfg.n_envs, device=self.device)
        key = rng.prng_key(cfg.seed, self.device)
        self.key, kinit, kenv = rng.split(key, 3)
        self.net = QNet(cfg.model, board=(e.height, e.width),
                        full_network=True, device=self.device)
        self.net.init_flax_(kinit)
        self.rollout = make_rollout_fn(
            self.env, self.net, cfg.horizon,
            distribution=cfg.train_distribution,
            epsilon=param_eval(cfg.epsilon))
        self.init_opt, self.update = make_dqn_update(e, self.net, cfg.dqn,
                                                     cfg.replay)
        self.state = self.init_opt(self.net)
        self.replay = replay_init(cfg.replay, self.device)
        self.env_state = self.env.reset(kenv)
        self.total_steps = 0
        self.stats = {}
        self.phase_ms = {}
        self._init_acting()

    def train_iteration(self, gumbel: Optional[torch.Tensor] = None,
                        replay_gumbel: Optional[torch.Tensor] = None):
        """One segment into the replay, then one update once the replay
        holds ``n_samples_each_update`` rows.  ``gumbel`` replaces the
        rollout's pareto or pi noise ((horizon, n_envs, 4 * width)),
        ``replay_gumbel`` the sample's ((capacity,)).  Returns the latest
        update's stats; ``phase_ms`` holds the rollout, replay add, targets
        and update times in ms (the last two once an update ran)."""
        cfg = self.cfg
        self.key, kroll, kupd = rng.split(self.key, 3)
        clock = _PhaseClock(self.device)
        clock.mark("start")
        self.env_state, seg, _ = self.rollout(
            self.env_state, kroll, gumbel, hp=self._hparams())
        clock.mark("rollout")
        self._track_traj_len(seg.done)
        replay_add_segment(cfg.replay, self.replay, seg, cfg.horizon)
        clock.mark("replay_add")
        self.total_steps += cfg.n_envs * cfg.horizon
        # the trainer waits for enough samples
        # (sventon_agent_dqn_trainer.py:22)
        if self.replay.size >= cfg.dqn.n_samples_each_update:
            self.state, self.replay, stats = self.update(
                self.state, self.replay, kupd, *self._alpha_beta(),
                replay_gumbel, clock.mark)
            clock.mark("update")
            self.stats = fetch_stats(stats)       # the update's one sync
        self.phase_ms = clock.spans_ms()
        return self.stats


@dataclasses.dataclass(frozen=True)
class DualPolicyConfig:
    env: EnvConfig = EnvConfig()
    model: ModelConfig = ModelConfig()
    ppo: PPOConfig = PPOConfig(single_policy=False)
    n_envs: int = 30
    horizon: int = 72
    seed: int = 0
    winrate_lr: float = 0.02        # presets.py:179
    winrate_tolerance: float = 0.1  # presets.py:180


class _DualTrainer:
    """What both dual trainers share: the games, JAX's key chain
    (``PRNGKey(seed) -> split 4``: key, k0, k1, kenv), two nets of
    ``net_cls`` initialised from k0 and k1 as JAX's are, the win-rate gate,
    and policy 0 as ``state`` and ``net``."""

    def _init_dual(self, cfg, device, net_cls):
        if cfg.horizon % 2:
            raise ValueError(f"the dual horizon {cfg.horizon} is odd")
        self.cfg = cfg
        self.device = resolve_device(device)
        e = cfg.env.engine
        self.env = TetrisVectorEnv(cfg.env, cfg.n_envs, device=self.device)
        self.key, k0, k1, kenv = rng.split(rng.prng_key(cfg.seed,
                                                        self.device), 4)
        self.nets = [net_cls(cfg.model, board=(e.height, e.width),
                             device=self.device).init_flax_(k)
                     for k in (k0, k1)]
        self.winrate = WinRateTracker(cfg.winrate_lr, cfg.winrate_tolerance)
        self.env_state = self.env.reset(kenv)
        self.total_steps = 0
        self.stats = {}
        self.phase_ms = {}

    @property
    def state(self):
        return self.states[0]

    @property
    def net(self):
        return self.nets[0]

    def _finish_iteration(self, stats: dict, clock: _PhaseClock) -> dict:
        stats = fetch_stats(stats)                # the iteration's one sync
        self.total_steps += self.cfg.n_envs * self.cfg.horizon
        stats["winrate/policy_0"] = float(self.winrate.rate_0)
        self.stats = stats
        self.phase_ms = clock.spans_ms()
        return stats


class DualPolicyTrainer(_DualTrainer):
    """Two PPO policies in one process, trained against each other
    (single_policy=False; worker.py:157-192, sventon_agent_base.py:96-111).
    Each iteration: one dual rollout (both nets act, one one-tick launch
    per tick), the merge and split into one batch per policy with
    unsigned-gamma GAE, and a PPO update of each policy that the win-rate
    gate lets train.  Every draw is JAX's: the initial weights from k0
    and k1, each tick's pi noise from (k0, k1) = split of its key
    (or given, ``gumbel``).

    ``state``, ``net`` and ``state_dict()`` are policy 0 in the PPO
    trainer's form, which the CLI saves and the league reads, as the JAX
    CLI keeps policy 0 (its ``state`` property); there is no dual
    resume."""

    def __init__(self, cfg: DualPolicyConfig, device=None):
        if cfg.ppo.single_policy:
            raise ValueError("DualPolicyTrainer needs single_policy=False")
        if not cfg.ppo.workers_computes_advantages:
            raise ValueError("dual-policy training uses worker-side GAE "
                             "(workers_computes_advantages=True)")
        self._init_dual(cfg, device, PPONet)
        self.rollout = make_dual_rollout_fn(self.env, self.nets, cfg.horizon)
        init_opt, self.update = make_ppo_update(cfg.env.engine, self.nets[0],
                                                cfg.ppo)
        self.states = [init_opt(net) for net in self.nets]

    def state_dict(self) -> dict:
        """Policy 0's learner state, ``total_steps`` and the key: what
        ``StandaloneTrainer.state_dict`` holds."""
        return {**ppo_state_dict(self.states[0]),
                "total_steps": int(self.total_steps), "key": self.key}

    def train_iteration(self, gumbel: Optional[torch.Tensor] = None):
        """One dual segment and an update of each policy the gate lets
        train (``gumbel``: (horizon, 2, n_envs, 4 * width) pi noise).
        Returns the stats as host floats (``policy_p/...`` and
        ``winrate/policy_0``); ``phase_ms`` holds the rollout, split (merge
        and GAE) and per-policy update times."""
        cfg = self.cfg
        self.key, kroll, ku0, ku1 = rng.split(self.key, 4)
        clock = _PhaseClock(self.device)
        clock.mark("start")
        self.env_state, seg, v_last = self.rollout(
            self.env_state, kroll, gumbel)
        clock.mark("rollout")
        self.winrate.update(self.env.get_winner(self.env_state))
        b0, b1, _ = split_dual_segment(cfg.ppo, seg, v_last)
        clock.mark("split")
        stats = {}
        for p, (batch, kupd) in enumerate(((b0, ku0), (b1, ku1))):
            if not self.winrate.should_train(p):
                continue
            self.states[p], s = self.update(self.states[p], batch, kupd)
            stats.update({f"policy_{p}/{k}": v for k, v in s.items()})
            clock.mark(f"update_{p}")
        return self._finish_iteration(stats, clock)


@dataclasses.dataclass(frozen=True)
class DualPolicyDQNConfig:
    env: EnvConfig = EnvConfig()
    model: ModelConfig = ModelConfig()
    dqn: DQNConfig = DQNConfig()
    replay: ReplayConfig = ReplayConfig()
    n_envs: int = 80
    horizon: int = 32             # ticks; each policy gets horizon / 2
    train_distribution: str = "epsilon"
    epsilon: Any = 0.05
    action_temperature: Any = 1.0
    tau_learning_rate: float = 0.01
    seed: int = 0
    winrate_lr: float = 0.02        # winrate_learningrate (presets.py:179)
    winrate_tolerance: float = 0.1  # presets.py:180


class DualPolicyDQNTrainer(_DQNActing, _DualTrainer):
    """Dual-policy SVENton-DQN: two QNets trained against each other, one
    on-device prioritized replay each (``horizon / 2`` rows per game and
    iteration), the estimator at unsigned gamma
    (``single_policy=False``) and the win-rate gate
    (sventon_agent_dqn_trainer.py:16-18).  Every draw follows JAX's keys
    (the pareto noise may be given instead).
    ``state``, ``net`` and ``state_dict()`` are policy 0 in the DQN
    trainer's form; the replays are not saved."""

    def __init__(self, cfg: DualPolicyDQNConfig, device=None):
        est = dataclasses.replace(cfg.dqn.estimator, single_policy=False)
        self.dqn_cfg = dataclasses.replace(cfg.dqn, estimator=est)
        self._init_dual(cfg, device, QNet)
        self.rollout = make_dual_rollout_fn(
            self.env, self.nets, cfg.horizon,
            distribution=cfg.train_distribution)
        init_opt, self.update = make_dqn_update(
            cfg.env.engine, self.nets[0], self.dqn_cfg, cfg.replay)
        self.states = [init_opt(net) for net in self.nets]
        self.replays = [replay_init(cfg.replay, self.device)
                        for _ in range(2)]
        self._init_acting()

    def state_dict(self) -> dict:
        """Policy 0's learner state, ``total_steps`` and the key."""
        return {**dqn_state_dict(self.states[0]),
                "total_steps": int(self.total_steps), "key": self.key}

    def train_iteration(self, gumbel: Optional[torch.Tensor] = None,
                        replay_gumbel=None):
        """One dual segment into the two replays, then an update of each
        policy whose replay holds ``n_samples_each_update`` rows and that
        the gate lets train.  ``gumbel`` ((horizon, 2, n_envs, 4 * width))
        replaces the rollout's pareto or pi noise, ``replay_gumbel`` (a
        pair of (capacity,) tensors) the samples'.  Returns the stats
        (``policy_p/...``, ``winrate/policy_0``); ``phase_ms`` holds the
        rollout, replay add (merge, split and both adds) and per-policy
        targets and update times."""
        cfg = self.cfg
        self.key, kroll, ku0, ku1 = rng.split(self.key, 4)
        clock = _PhaseClock(self.device)
        clock.mark("start")
        self.env_state, seg, _ = self.rollout(
            self.env_state, kroll, gumbel, hp=self._hparams())
        clock.mark("rollout")
        self.winrate.update(self.env.get_winner(self.env_state))
        self._track_traj_len(seg.done)
        merged = merge_dual_transitions(seg)
        for p in (0, 1):
            replay_add_segment(cfg.replay, self.replays[p],
                               dual_policy_subsegment(merged, p),
                               cfg.horizon // 2)
        clock.mark("replay_add")
        alpha, beta = self._alpha_beta()
        stats = {}
        for p, kupd in ((0, ku0), (1, ku1)):
            if self.replays[p].size < cfg.dqn.n_samples_each_update:
                continue
            # win-rate gate: the policy that is ahead waits
            if not self.winrate.should_train(p):
                continue
            self.states[p], self.replays[p], s = self.update(
                self.states[p], self.replays[p], kupd, alpha, beta,
                None if replay_gumbel is None else replay_gumbel[p],
                lambda name, p=p: clock.mark(f"{name}_{p}"))
            stats.update({f"policy_{p}/{k}": v for k, v in s.items()})
            clock.mark(f"update_{p}")
        return self._finish_iteration(stats, clock)


@dataclasses.dataclass(frozen=True)
class StandaloneSIXtenConfig:
    env: EnvConfig = EnvConfig()
    model: ModelConfig = ModelConfig()
    replay: ReplayConfig = ReplayConfig()
    n_envs: int = 16              # SIXten shape (sixten_base.py:29)
    horizon: int = 32
    train_distribution: str = "epsilon"
    epsilon: Any = 0.05           # ParamLike: evaluated per iteration
    action_temperature: Any = 1.0
    tau_learning_rate: float = 0.01
    # "top_drop": the (4, W) mask grid through step_place; "full": the
    # top-drop and finesse rests through step_pose
    action_space: str = "top_drop"
    seed: int = 0


class StandaloneSIXtenTrainer(_RefNetLearner, _DQNActing):
    """SIXten in one process: world-model one-ply search rollouts (V over
    the successor boards of every legal placement) into the prioritized
    replay, k-step lambda V-targets through the reference net.  The key
    chain is JAX's (``key, kroll, kupd = split(key, 3)`` per iteration),
    and every draw follows it: the initial weights (kinit), the rollout
    and the replay sample.  ``phase_ms`` holds the
    iteration's masks, forward, tick, replay and update times."""

    def __init__(self, cfg: StandaloneSIXtenConfig, sixten_cfg=None,
                 device=None):
        from drl_tetris_tpu_torch.algos.sixten import (SixtenConfig, VNet,
                                                       make_sixten_rollout,
                                                       make_sixten_update)
        self.cfg = cfg
        self.scfg = sixten_cfg or SixtenConfig()
        self.device = resolve_device(device)
        e = cfg.env.engine
        self.env = TetrisVectorEnv(cfg.env, cfg.n_envs, device=self.device)
        key = rng.prng_key(cfg.seed, self.device)
        self.key, kinit, kenv = rng.split(key, 3)
        self.net = VNet(cfg.model, board=(e.height, e.width),
                        device=self.device).init_flax_(kinit)
        self.rollout = make_sixten_rollout(
            self.env, self.net, cfg.horizon,
            distribution=cfg.train_distribution,
            epsilon=param_eval(cfg.epsilon), action_space=cfg.action_space)
        self.init_opt, self.update = make_sixten_update(e, self.net,
                                                        self.scfg, cfg.replay)
        self.state = self.init_opt(self.net)
        self.replay = replay_init(cfg.replay, self.device)
        self.env_state = self.env.reset(kenv)
        self.total_steps = 0
        self.stats = {}
        self.phase_ms = {}
        self._init_acting()

    def _alpha_beta(self):
        t = self.total_steps
        return (param_eval(self.scfg.alpha, t), param_eval(self.scfg.beta, t))

    def train_iteration(self, replay_gumbel: Optional[torch.Tensor] = None):
        """One segment into the replay, then one update once the replay
        holds ``n_samples_each_update`` rows (``replay_gumbel`` (capacity,)
        replaces the sample's noise).  Returns the latest update's
        stats."""
        cfg = self.cfg
        self.key, kroll, kupd = rng.split(self.key, 3)
        clock = _PhaseClock(self.device)
        clock.mark("start")
        self.env_state, seg, _ = self.rollout(
            self.env_state, kroll, hp=self._hparams(), mark=clock.mark)
        self._track_traj_len(seg.done)
        replay_add_segment(cfg.replay, self.replay, seg, cfg.horizon)
        clock.mark("replay")
        self.total_steps += cfg.n_envs * cfg.horizon
        if self.replay.size >= self.scfg.n_samples_each_update:
            self.state, self.replay, stats = self.update(
                self.state, self.replay, kupd, *self._alpha_beta(),
                replay_gumbel)
            clock.mark("update")
            self.stats = fetch_stats(stats)
        self.phase_ms = clock.spans_ms()
        return self.stats


@dataclasses.dataclass(frozen=True)
class SherlockTrainerConfig:
    env: EnvConfig = EnvConfig()
    model: ModelConfig = ModelConfig()
    n_envs: int = 16
    horizon: int = 32
    action_space: str = "top_drop"   # or "full" (top-drop and finesse)
    seed: int = 0


class StandaloneSherlockTrainer:
    """Sherlock (delta-PPO) self-play in one process: the phi.delta
    rollout (one launch of the engine kernel's per-kind entry per tick),
    GAE, and the delta-PPO update with torch.optim.Adam.  The key chain
    and every draw are JAX's, the initial weights included.  ``phase_ms``
    holds
    the masks, forward, tick, gae and update times."""

    def __init__(self, cfg: SherlockTrainerConfig, sherlock_cfg=None,
                 device=None):
        from drl_tetris_tpu_torch.algos.sherlock import (
            SherlockConfig, SherlockNet, make_sherlock_rollout,
            make_sherlock_update)
        self.cfg = cfg
        self.scfg = sherlock_cfg or SherlockConfig()
        self.device = resolve_device(device)
        e = cfg.env.engine
        self.env = TetrisVectorEnv(cfg.env, cfg.n_envs, device=self.device)
        key = rng.prng_key(cfg.seed, self.device)
        self.key, kinit, kenv = rng.split(key, 3)
        self.net = SherlockNet(cfg.model, board=(e.height, e.width),
                               device=self.device).init_flax_(kinit)
        self.rollout = make_sherlock_rollout(self.env, self.net, cfg.horizon,
                                             action_space=cfg.action_space)
        self.init_opt, self.update = make_sherlock_update(e, self.net,
                                                          self.scfg)
        self.state = self.init_opt(self.net)
        self.env_state = self.env.reset(kenv)
        self.total_steps = 0
        self.stats = {}
        self.phase_ms = {}

    def state_dict(self) -> dict:
        """The net, Adam, ``update_count``, ``total_steps`` and the key."""
        return {"params": self.net.state_dict(),
                "adam": adam_state_dict(self.net, self.state.optimizer),
                "update_count": int(self.state.update_count),
                "total_steps": int(self.total_steps), "key": self.key}

    def _load_learner(self, sd: dict):
        self.net.load_params_(sd["params"])
        load_adam_state(self.net, self.state.optimizer, sd["adam"])
        self.state.update_count = int(sd["update_count"])

    def load_state_dict(self, sd: dict):
        self._load_learner(sd)
        self.total_steps = int(sd["total_steps"])
        self.key = torch.as_tensor(sd["key"]).to(self.device, torch.int64)

    def resume(self, state: dict, step: int):
        """``train --resume``: the learner's state, ``total_steps = step``,
        ``fold_in(key, step)``; the games reset."""
        self._load_learner(state)
        self.total_steps = int(step)
        self.key = rng.fold_in(self.key, int(step))

    def init_params(self, params: dict):
        """``train --init-from``: the weights; Adam stays fresh."""
        self.net.load_params_(params)

    def train_iteration(self):
        from drl_tetris_tpu_torch.algos.sherlock import \
            sherlock_segment_to_batch
        self.key, kroll, kupd = rng.split(self.key, 3)
        clock = _PhaseClock(self.device)
        clock.mark("start")
        self.env_state, seg, v_last = self.rollout(self.env_state, kroll,
                                                   mark=clock.mark)
        batch, _ = sherlock_segment_to_batch(self.scfg, seg, v_last)
        clock.mark("gae")
        self.state, stats = self.update(self.state, batch, kupd)
        clock.mark("update")
        self.total_steps += self.cfg.n_envs * self.cfg.horizon
        self.stats = fetch_stats(stats)
        self.phase_ms = clock.spans_ms()
        return self.stats
