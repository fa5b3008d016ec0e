"""SVENton-DQN: prioritized k-step double-dueling Q-learning.

Counterpart of ``drl_tetris_tpu/algos/dqn.py`` (reference: prio_qnet's
training graph, agents/networks/prio_qnet.py:102-124, and the DQN trainer
loop, sventon_agent_dqn_trainer.py):

  1. a prioritized sample (alpha, beta as given per update) from the
     replay,
  2. k-step lambda targets through the reference net (value_estimator),
  3. epochs x minibatches of IS-weighted MSE on Q(s, r, t, piece) plus L2,
     each one forward, one backward and one ``torch.optim.Adam`` step,
  4. new priorities |q - target| (+ the optimistic term) written back
     into the replay: each row's from the last epoch whose minibatches
     held it, 0 for a row none held (n not a multiple of the minibatch),
     as in JAX,
  5. the reference sync when (update_count + 1) % time_to_reference_update
     == 0 (network.py:51-60).  PPO's trainer-targets mode counts down
     instead (algos/ppo.py); both rules are the reference's.

Each epoch shuffles with ``rng.permutation``, bit-exact with JAX's.  No
value is read back to the host inside the update: the trainer fetches the
stats once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from drl_tetris_tpu_torch.algos.ppo import (frozen_copy, minibatch_indices,
                                            sync_reference)
from drl_tetris_tpu_torch.algos.replay import (ReplayConfig, ReplayState,
                                               replay_gather_windows,
                                               replay_sample,
                                               replay_update_prios)
from drl_tetris_tpu_torch.algos.value_estimator import (EstimatorConfig,
                                                        kstep_targets)
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.engine.core import EngineConfig
from drl_tetris_tpu_torch.env.observations import field_grid
from drl_tetris_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    lr: float = 1e-4                      # value_lr (presets.py:49)
    nn_regularizer: float = 1e-4
    n_samples_each_update: int = 8192     # presets.py:41
    minibatch_size: int = 32
    n_train_epochs: int = 3
    # ParamLike: schedules over training time
    # (sventon_agent_dqn_trainer.py:34-39), evaluated by the trainer
    alpha: Any = 0.7                      # prioritized_replay_alpha
    beta: Any = 0.7                       # prioritized_replay_beta
    optimistic_prios: float = 0.0
    time_to_reference_update: int = 1     # presets.py:147
    estimator: EstimatorConfig = EstimatorConfig()


@dataclasses.dataclass
class DQNState:
    """``net`` holds the parameters, ``ref_net`` the reference copy the
    targets bootstrap through, ``optimizer`` Adam's state."""
    net: torch.nn.Module
    ref_net: torch.nn.Module
    optimizer: torch.optim.Adam
    update_count: int = 0


def dqn_loss(engine_cfg: EngineConfig, cfg: DQNConfig, net, mb: dict,
             weights: torch.Tensor):
    """(loss, new priorities (B,), stats) of one minibatch."""
    grids = field_grid(engine_cfg, mb["occ0"])
    vis = [grids[:, 0, :, :, None], grids[:, 1, :, :, None]]
    vec = [mb["vec0"][:, 0, :], mb["vec0"][:, 1, :]]
    q, _, _ = net(vec, vis)
    b = torch.arange(q.shape[0], device=q.device)
    q_rtp = q[b, mb["rot"].long(), mb["trans"].long(), mb["piece"].long()]
    err = q_rtp - mb["target"]
    prios = err.detach().abs()
    if cfg.optimistic_prios != 0.0:
        prios = prios + cfg.optimistic_prios * F.relu(prios)
    value_loss = torch.mean(weights * err ** 2)
    reg = cfg.nn_regularizer * 0.5 * sum(
        torch.sum(torch.square(w)) for w in net.parameters())
    loss = value_loss + reg
    stats = {k: v.detach() for k, v in {
        "q_val": torch.mean(q_rtp), "q_target": torch.mean(mb["target"]),
        "value_loss": value_loss, "reg_loss": reg, "tot_loss": loss}.items()}
    return loss, prios, stats


def sample_for_update(engine_cfg: EngineConfig, cfg: DQNConfig,
                      replay_cfg: ReplayConfig, ref_net,
                      replay: ReplayState, key: torch.Tensor, alpha, beta,
                      gumbel: Optional[torch.Tensor] = None):
    """The first half of an update: (idx, is_weights, samples, kp).  The
    sample's noise follows JAX's key (ks of split(key)) unless ``gumbel``
    (M,) is given; ``samples`` holds the rows' states, actions and their
    k-step targets through ``ref_net``."""
    ks, kp = rng.split(key)
    idx, iw = replay_sample(replay_cfg, replay, cfg.n_samples_each_update,
                            alpha, beta, ks, gumbel)
    win = replay_gather_windows(replay_cfg, replay, idx)
    targets = kstep_targets(engine_cfg, ref_net, cfg.estimator, win)
    samples = {"occ0": win["occ"][:, 0], "vec0": win["vec"][:, 0],
               "rot": win["rot"], "trans": win["trans"],
               "piece": win["piece"], "target": targets}
    return idx, iw, samples, kp


def first_step_gradients(engine_cfg: EngineConfig, cfg: DQNConfig, net,
                         samples: dict, iw: torch.Tensor, kp: torch.Tensor):
    """({name: gradient}, prios, stats) of the first minibatch step an
    update with these samples takes at the net's weights; nothing is
    stepped.  For holding one update against another."""
    mi = minibatch_indices(cfg, samples["target"].shape[0], kp)[0, 0]
    mb = {k: v.index_select(0, mi) for k, v in samples.items()}
    loss, prios, stats = dqn_loss(engine_cfg, cfg, net, mb,
                                  iw.index_select(0, mi))
    names, params = zip(*net.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params))), prios, stats


def make_dqn_update(engine_cfg: EngineConfig, net, cfg: DQNConfig,
                    replay_cfg: ReplayConfig):
    """Returns (init_fn(net) -> DQNState, update_fn(state, replay, key,
    alpha, beta, gumbel=None) -> (state, replay, stats)).  ``key`` is a
    (2,) key on the net's device; ``alpha`` and ``beta`` are the
    schedules' values for this update.  Spans: ``targets`` (the sample and
    its targets), then ``update`` (the Q steps, priorities and reference
    sync)."""

    def init_fn(net=net) -> DQNState:
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the sqrt
        opt = torch.optim.Adam(net.parameters(), lr=cfg.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        return DQNState(net=net, ref_net=frozen_copy(net), optimizer=opt)

    def update_fn(state: DQNState, replay: ReplayState, key: torch.Tensor,
                  alpha: float, beta: float, gumbel=None):
        with tracing.span("targets"):
            idx, iw, samples, kp = sample_for_update(
                engine_cfg, cfg, replay_cfg, state.ref_net, replay, key,
                alpha, beta, gumbel)
        with tracing.span("update"):
            n = cfg.n_samples_each_update
            prio_buf = torch.zeros(n, dtype=torch.float32, device=iw.device)
            stats = None
            for epoch in minibatch_indices(cfg, n, kp):
                for mi in epoch:
                    mb = {k: v.index_select(0, mi)
                          for k, v in samples.items()}
                    loss, prios, stats = dqn_loss(engine_cfg, cfg, state.net,
                                                  mb, iw.index_select(0, mi))
                    state.optimizer.zero_grad(set_to_none=True)
                    loss.backward()
                    state.optimizer.step()
                    prio_buf[mi] = prios
            replay_update_prios(replay, idx, prio_buf)
            state.update_count += 1
            if state.update_count % cfg.time_to_reference_update == 0:
                sync_reference(state)
        return state, replay, stats

    return init_fn, update_fn
