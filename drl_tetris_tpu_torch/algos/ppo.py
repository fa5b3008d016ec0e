"""SVENton-PPO: the learner update.

Counterpart of ``drl_tetris_tpu/algos/ppo.py`` (reference:
agents/networks/ppo_nets.py:141-257, the trainer loop
sventon_agent_ppo_trainer.py:10-77), on both of its paths: the workers
compute the advantages (GAE, ``segment_to_batch``, and
``pool_segment_to_batch`` for league-pool rollouts), or the trainer
computes k-step targets through a reference net (``segment_to_windows``,
``workers_computes_advantages=False``).  The JAX package
compiles epochs x reshuffled minibatches as nested ``lax.scan``s; here they
are Python loops of eager steps, each one forward, one backward and one
``torch.optim.Adam`` step on the net's float32 parameters.  Nothing in the
loop reads a value back to the host: the compressor states and the stats
stay device tensors, and the learning rate is a host float.

Loss terms (ppo_nets.create_training_ops): the clipped surrogate on
pi(r, t | s, piece), the per-piece value MSE, the entropy bonus with the
optional entropy-floor and rescaled-entropy shaping, the standalone floor
penalty, the L2 regularizer (tf.nn.l2_loss over every parameter), and the
'compressor' running-abs-mean normalizers on the advantages and on the
value loss (agents/networks/compressor.py).

Each epoch shuffles the batch with ``rng.permutation``, bit-exact with
``jax.random.permutation``, so the same key gives the JAX package's
minibatches.

Trainer-computed targets (ppo_nets.create_targets, :227-257): each
minibatch's targets come from ``value_estimator.kstep_targets`` through
the reference net, and the advantage is ``values - targets`` with the
values not detached, so the surrogate's gradient reaches the value stream
(a faithful quirk of the reference, :256).  After each update the
reference net syncs when its countdown is at 0 and the countdown reloads
to ``time_to_reference_update``, else it ticks down
(sventon_agent_ppo_trainer.py:70-74).  The DQN update syncs by another
rule (algos/dqn.py); both are the reference's.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from drl_tetris_tpu_torch.algos.gae import sventon_gae
from drl_tetris_tpu_torch.algos.rollout import Segment
from drl_tetris_tpu_torch.algos.value_estimator import (EstimatorConfig,
                                                        kstep_targets)
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.engine.core import EngineConfig
from drl_tetris_tpu_torch.env.observations import PIECE_SWAP_NP, field_grid


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    """agents/networks/compressor.py defaults / sventon_ppo.py:11-12."""
    lr: float = 0.005
    clip_val: float = 8.0
    safety: float = 3.0
    cautious: bool = False


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """experiments/sventon_ppo.py:16-36 + presets; the JAX package's
    PPOConfig field for field."""
    clipping_parameter: float = 0.15
    value_loss: float = 0.01          # c1
    policy_loss: float = 0.9          # c2
    entropy_loss: float = 0.0         # c3
    entropy_floor_loss: float = 0.0
    rescaled_entropy: float = 0.0
    # entropy_floor_standalone * mean(relu(floor - H)) added to the loss
    # directly (floor = eps-noise entropy at ppo_epsilon); the JAX
    # package's extension beyond the reference, which scales the floor
    # term by c3 only
    entropy_floor_standalone: float = 0.0
    ppo_epsilon: float = 0.0
    nn_regularizer: float = 1e-5
    lr: float = 1e-7                  # value_lr at t = 0
    gamma: float = 0.98
    gae_lambda: float = 0.7
    gve_lambda: float = 0.95
    single_policy: bool = True        # gamma sign flip (sventon_agent_base.py:76)
    n_train_epochs: int = 4
    minibatch_size: int = 64
    compress_advantages: Optional[CompressorConfig] = CompressorConfig()
    compress_value_loss: Optional[CompressorConfig] = CompressorConfig()
    augment_data: bool = False        # mirror augmentation (presets.py:181)
    # False: workers run the value-stream-free net and ship k-step
    # windows; the trainer computes targets through a reference net
    workers_computes_advantages: bool = True
    n_step_value_estimates: int = 1
    time_to_reference_update: int = 1
    truncate_aggregation: bool = True
    sparse_value_estimate_filter: Tuple[int, ...] = ()

    @property
    def effective_gamma(self) -> float:
        return -self.gamma if self.single_policy else self.gamma

    @property
    def estimator(self) -> EstimatorConfig:
        """The trainer-targets estimator: gamma, and lambda = gae_lambda
        (ppo_nets.py:241-252, network.py:21-23)."""
        return EstimatorConfig(
            k_step=self.n_step_value_estimates, gamma=self.gamma,
            lam=self.gae_lambda, single_policy=self.single_policy,
            truncate_aggregation=self.truncate_aggregation,
            step_filter=self.sparse_value_estimate_filter)


class CompressorState(NamedTuple):
    x_mean: torch.Tensor   # () float32
    x_max: torch.Tensor    # () float32


def compressor_init(device=None) -> CompressorState:
    one = torch.ones((), dtype=torch.float32, device=device)
    return CompressorState(one, one.clone())


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    """A detached copy of ``x`` reduced over ``group`` with ``op``."""
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` averaged over ``group`` (sum, then divide: ``lax.pmean``),
    without a gradient."""
    return _all_reduce(x, group, dist.ReduceOp.SUM) / dist.get_world_size(
        group)


class _GlobalMean(torch.autograd.Function):
    """Forward: ``x`` averaged over a process group.  Backward: the
    cotangent passes through unchanged, as ``lax.pmean``'s transpose gives
    each replica when the cotangents agree; the gradients are averaged
    afterwards."""

    @staticmethod
    def forward(ctx, x, group):
        return mean_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def compressor_apply(cfg: CompressorConfig, st: CompressorState, x,
                     group=None):
    """One call of compressor.__call__ and its update op: (y, state',
    saturation).  The batch statistics only feed the running means, so
    they carry no gradient.  Data-parallel over ``group``, they are the
    global ones (the mean averaged, the max max-reduced), so the state
    stays replicated."""
    eps = 1e-6
    ax = x.detach().abs()
    batch_mean, batch_max = ax.mean(), ax.max()
    if group is not None:
        batch_mean = mean_over(batch_mean, group)
        batch_max = _all_reduce(batch_max, group, dist.ReduceOp.MAX)
    if cfg.cautious:
        norm = torch.maximum(st.x_mean, torch.clamp(batch_mean, min=eps))
    else:
        norm = torch.clamp(st.x_mean, min=eps)
    clip = torch.clamp(cfg.safety * st.x_max / st.x_mean, max=cfg.clip_val)
    y = torch.clamp(x / norm, -clip, clip)
    new = CompressorState(
        (1 - cfg.lr) * st.x_mean + cfg.lr * batch_mean,
        (1 - cfg.lr) * st.x_max + cfg.lr * batch_max,
    )
    sat = (x.detach() / norm != y.detach()).to(torch.float32).mean()
    return y, new, sat


class Batch(NamedTuple):
    """Flattened training samples."""
    occ: torch.Tensor       # (B, 2, H) int32 bits
    vec: torch.Tensor       # (B, 2, 12) float32
    piece: torch.Tensor     # (B,) int32
    rot: torch.Tensor       # (B,) int32
    trans: torch.Tensor     # (B,) int32
    old_prob: torch.Tensor  # (B,) float32
    advantage: torch.Tensor # (B,) float32
    target_v: torch.Tensor  # (B,) float32


@dataclasses.dataclass
class PPOState:
    """The learner's state.  ``net`` holds the parameters (the worker acts
    with the same module); ``optimizer`` holds Adam's moments, step counts
    and learning rate.  The update advances all of it in place."""
    net: torch.nn.Module
    optimizer: torch.optim.Adam
    adv_comp: CompressorState
    vloss_comp: CompressorState
    update_count: int = 0
    # trainer-computed targets only: the reference net the estimator
    # bootstraps through (ppo_nets.py:233-240) and the countdown to its
    # next sync (sventon_agent_ppo_trainer.py:70-74)
    ref_net: Optional[torch.nn.Module] = None
    ref_countdown: Optional[int] = None


def frozen_copy(net: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``net`` for a reference net: its own tensors, no grad."""
    ref = copy.deepcopy(net)
    ref.requires_grad_(False)
    return ref


def sync_reference(state) -> None:
    """Copy ``state.net``'s parameters into ``state.ref_net``."""
    with torch.no_grad():
        for r, p in zip(state.ref_net.parameters(), state.net.parameters()):
            r.copy_(p)


def augment_batch(engine_cfg: EngineConfig, batch: Batch) -> Batch:
    """Mirror augmentation (trajectory.augment_data, trajectory.py:88-109):
    append a horizontally reflected copy of every sample: fields flipped,
    translation t -> W-1-t, piece ids through the L<->J / S<->Z swap.  As
    in the reference, the rotation and the x/y scalars are not mirrored."""
    W = engine_cfg.width
    occ = rng.u32(batch.occ)
    rev = torch.zeros_like(occ)
    for x in range(W):
        rev = rev | (((occ >> x) & 1) << (W - 1 - x))
    swap = torch.as_tensor(PIECE_SWAP_NP, device=occ.device).long()
    vec_m = torch.cat([batch.vec[..., :5], batch.vec[..., 5:][..., swap]],
                      dim=-1)
    mirrored = Batch(
        occ=rng.to_i32(rev), vec=vec_m,
        piece=swap[batch.piece.long()].to(torch.int32), rot=batch.rot,
        trans=W - 1 - batch.trans, old_prob=batch.old_prob,
        advantage=batch.advantage, target_v=batch.target_v)
    return Batch(*[torch.cat([a, b]) for a, b in zip(batch, mirrored)])


def segment_to_batch(cfg: PPOConfig, seg: Segment, v_piece_last
                     ) -> Tuple[Batch, dict]:
    """Worker-side processing (ready_for_new_round + process_trajectory):
    GAE over the segment, then flatten (T, N) -> (T*N,), tick-major."""
    adv, tgt, stats = sventon_gae(
        seg.reward, seg.done, seg.v_piece, seg.v_mean, v_piece_last,
        gamma=cfg.effective_gamma, gae_lambda=cfg.gae_lambda,
        gve_lambda=cfg.gve_lambda)

    def flat(a):
        return a.reshape((-1,) + tuple(a.shape[2:]))
    return Batch(
        occ=flat(seg.occ), vec=flat(seg.vec), piece=flat(seg.piece),
        rot=flat(seg.rot), trans=flat(seg.trans), old_prob=flat(seg.prob),
        advantage=flat(adv), target_v=flat(tgt),
    ), stats


def pool_segment_to_batch(cfg: PPOConfig, seg: Segment, v_piece_last,
                          learner_parity: int = 0) -> Tuple[Batch, dict]:
    """segment_to_batch for a league-pool rollout: GAE over the whole
    alternating segment (the learner's values at every tick, gamma
    negated as always), then only the learner's ticks (every second,
    from ``learner_parity``) are kept."""
    adv, tgt, stats = sventon_gae(
        seg.reward, seg.done, seg.v_piece, seg.v_mean, v_piece_last,
        gamma=cfg.effective_gamma, gae_lambda=cfg.gae_lambda,
        gve_lambda=cfg.gve_lambda)

    def flat(a):
        a = a[learner_parity::2]
        return a.reshape((-1,) + tuple(a.shape[2:]))
    return Batch(
        occ=flat(seg.occ), vec=flat(seg.vec), piece=flat(seg.piece),
        rot=flat(seg.rot), trans=flat(seg.trans), old_prob=flat(seg.prob),
        advantage=flat(adv), target_v=flat(tgt),
    ), stats


class WindowBatch(NamedTuple):
    """Samples of the trainer-computes-targets mode: each carries its
    k-step window of states, rewards and dones (the reference ships these
    through its k-step replay, ppo_nets.py:35-39)."""
    occ_w: torch.Tensor     # (B, K+1, 2, H) int32 bits; [:, 0] is trained
    vec_w: torch.Tensor     # (B, K+1, 2, 12) float32
    piece: torch.Tensor     # (B,) int32
    rot: torch.Tensor       # (B,) int32
    trans: torch.Tensor     # (B,) int32
    old_prob: torch.Tensor  # (B,) float32
    reward_w: torch.Tensor  # (B, K+1) float32
    done_w: torch.Tensor    # (B, K+1) int32


def segment_to_windows(cfg: PPOConfig, seg: Segment) -> WindowBatch:
    """Worker-side packing when the trainer computes targets: raw k-step
    windows, no GAE.  Windows slide within the segment (t in [0, T-K));
    the estimator's done mask stops them at a trajectory's end; the
    segment's last K ticks are not trained on."""
    K = cfg.n_step_value_estimates
    T = seg.piece.shape[0]
    n_t = T - K
    if n_t <= 0:
        raise ValueError(f"horizon {T} leaves no {K}-step window")

    def flat(a):
        return a.reshape((-1,) + tuple(a.shape[2:]))

    def fw(x):                      # (T, N, ...) -> (n_t*N, K+1, ...)
        return flat(torch.stack([x[j:j + n_t] for j in range(K + 1)], 2))
    return WindowBatch(
        occ_w=fw(seg.occ), vec_w=fw(seg.vec),
        piece=flat(seg.piece[:n_t]), rot=flat(seg.rot[:n_t]),
        trans=flat(seg.trans[:n_t]), old_prob=flat(seg.prob[:n_t]),
        reward_w=fw(seg.reward.to(torch.float32)),
        done_w=fw(seg.done.to(torch.int32)))


def set_learning_rate(state: PPOState, lr: float) -> PPOState:
    """Set Adam's learning rate (the Parameter(t) schedule path,
    tools/parameter.py:8-66; the trainer calls this each iteration with
    param_eval(value_lr, t))."""
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def entropy_floor(cfg: PPOConfig, n_actions: int) -> float:
    """Entropy of eps-noise over n_actions, eps = ppo_epsilon, computed in
    float32 on the host (a Python float, so the loss needs no transfer)."""
    eps = torch.tensor(max(cfg.ppo_epsilon, 1e-8), dtype=torch.float32)
    return float(-eps * torch.log(eps / (n_actions - 1))
                 - (1 - eps) * torch.log(1 - eps))


def ppo_loss(engine_cfg: EngineConfig, cfg: PPOConfig, net, mb,
             adv_comp: CompressorState, vloss_comp: CompressorState,
             ref_net=None, group=None):
    """(loss, adv_comp', vloss_comp', stats) of one minibatch (a Batch, or
    a WindowBatch with ``ref_net`` when the trainer computes targets); the
    loss carries the graph to the net's parameters, the rest is
    detached.  With a process ``group`` (data-parallel), the value MSE and
    the compressors' batch statistics are the global ones."""
    e = 1e-6
    trainer_targets = isinstance(mb, WindowBatch)
    occ_t, vec_t = (mb.occ_w[:, 0], mb.vec_w[:, 0]) if trainer_targets \
        else (mb.occ, mb.vec)
    grids = field_grid(engine_cfg, occ_t)                    # (B, 2, H, W)
    vis = [grids[:, 0, :, :, None], grids[:, 1, :, :, None]]
    vec = [vec_t[:, 0, :], vec_t[:, 1, :]]
    pi, v = net(vec, vis)                                    # (B,4,W,7), (B,7)
    B = pi.shape[0]
    dev = pi.device
    idx = torch.arange(B, device=dev)
    piece = mb.piece.long()
    prob = pi[idx, mb.rot.long(), mb.trans.long(), piece]
    values = v[idx, piece] if v.shape[-1] > 1 else v[:, 0]
    if trainer_targets:
        target_v = kstep_targets(engine_cfg, ref_net, cfg.estimator, {
            "occ": mb.occ_w, "vec": mb.vec_w, "reward": mb.reward_w,
            "done": mb.done_w})
        advantage_in = values - target_v             # not detached (:256)
    else:
        target_v, advantage_in = mb.target_v, mb.advantage

    ratio = torch.clamp(prob, min=e) / torch.clamp(mb.old_prob, min=e)
    clipped = torch.clamp(ratio, 1 - cfg.clipping_parameter,
                          1 + cfg.clipping_parameter)
    clip_sat = (ratio != clipped).to(torch.float32).mean()

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    adv, adv_sat = advantage_in, zero
    if cfg.compress_advantages is not None:
        adv, adv_comp, adv_sat = compressor_apply(
            cfg.compress_advantages, adv_comp, adv, group)
    policy_obj = torch.minimum(ratio * adv, clipped * adv)

    # entropy of the acting piece's action plane (ppo_nets.py:174-185)
    pie = pi + e
    ent_map = -torch.sum(pie * torch.log(torch.clamp(pie, min=e)),
                         dim=(1, 2))                         # (B, 7)
    action_entropy = ent_map[idx, piece]
    entropy_bonus = action_entropy
    n_actions = pi.shape[1] * pi.shape[2]
    if cfg.entropy_floor_loss or cfg.entropy_floor_standalone:
        floor = entropy_floor(cfg, n_actions)
    if cfg.entropy_floor_loss:
        entropy_bonus = entropy_bonus + cfg.entropy_floor_loss * (
            -F.relu(floor - action_entropy))
    if cfg.rescaled_entropy:
        max_entropy = float(torch.log(torch.tensor(float(n_actions),
                                                   dtype=torch.float32)))
        entropy_bonus = entropy_bonus + cfg.rescaled_entropy * (
            max_entropy - entropy_bonus)

    value_mse = torch.mean((values - target_v) ** 2)
    if group is not None:
        value_mse = _GlobalMean.apply(value_mse, group)
    value_loss = cfg.value_loss * value_mse
    vloss_sat = zero
    if cfg.compress_value_loss is not None:
        value_loss, vloss_comp, vloss_sat = compressor_apply(
            cfg.compress_value_loss, vloss_comp, value_loss, group)
    policy_loss = -cfg.policy_loss * torch.mean(policy_obj)
    entropy_loss = -cfg.entropy_loss * torch.mean(entropy_bonus)
    floor_pen = zero
    if cfg.entropy_floor_standalone:
        floor_pen = cfg.entropy_floor_standalone * torch.mean(
            F.relu(floor - action_entropy))
    # tf.nn.l2_loss = sum(w^2)/2 over all variables (ppo_nets.py:191)
    reg = cfg.nn_regularizer * 0.5 * sum(
        torch.sum(torch.square(w)) for w in net.parameters())
    loss = value_loss + policy_loss + entropy_loss + floor_pen + reg
    stats = {k: x.detach() for k, x in {
        "losses/entropy_floor_penalty": floor_pen,
        "losses/total_loss": loss,
        "losses/value_loss": value_loss,
        "losses/policy_loss": -policy_loss,
        "losses/entropy_loss": -entropy_loss,
        "losses/regularizer_loss": reg,
        "entropy/entropy": torch.mean(action_entropy),
        "misc/values": torch.mean(values),
        "misc/target_values": torch.mean(target_v),
        "misc/clip_saturation": clip_sat,
        "compressors/advantage/saturation": adv_sat,
        "compressors/valueloss/saturation": vloss_sat,
    }.items()}
    return loss, adv_comp, vloss_comp, stats


def minibatch_indices(cfg: PPOConfig, n: int, key: torch.Tensor
                      ) -> torch.Tensor:
    """(epochs, n // mb, mb) sample indices: epoch k shuffles with
    permutation(split(key, epochs)[k], n) and drops the remainder."""
    mb = cfg.minibatch_size
    n_mb = n // mb
    if n_mb == 0:
        raise ValueError(f"{n} samples make no minibatch of {mb}")
    return torch.stack([rng.permutation(k, n)[:n_mb * mb].reshape(n_mb, mb)
                        for k in rng.split(key, cfg.n_train_epochs)])


def _rows(batch, idx):
    return type(batch)(*[a.index_select(0, idx) for a in batch])


def first_step_gradients(engine_cfg: EngineConfig, cfg: PPOConfig, net,
                         batch, key: torch.Tensor, ref_net=None):
    """({name: gradient}, stats) of the first minibatch step that
    ``update_fn(state, batch, key)`` takes from fresh compressors at the
    net's current weights (``ref_net``: the reference net of a
    WindowBatch); nothing is stepped.  For holding one update against
    another (the JAX package's, the CPU's)."""
    if cfg.augment_data:
        batch = augment_batch(engine_cfg, batch)
    idx = minibatch_indices(cfg, batch.piece.shape[0], key)[0, 0]
    dev = next(net.parameters()).device
    loss, _, _, stats = ppo_loss(
        engine_cfg, cfg, net, _rows(batch, idx), compressor_init(dev),
        compressor_init(dev), ref_net)
    names, params = zip(*net.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params))), stats


def average_gradients_(params, group) -> None:
    """Each parameter's gradient averaged over ``group``, in place: one
    all-reduce of all of them flattened into one buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_ppo_update(engine_cfg: EngineConfig, net, cfg: PPOConfig,
                    group=None):
    """Returns (init_fn(net) -> PPOState, update_fn(state, batch, key) ->
    (state, stats)), the stats those of the last minibatch of the last
    epoch.  ``key`` is a (2,) key on the net's device.  With
    ``workers_computes_advantages=False`` the batch is a WindowBatch and the
    state carries the reference net.

    ``group``: a ``torch.distributed`` process group; the update then runs
    data-parallel over it (the JAX package's ``axis_name``), each rank on
    its own shard of the batch: the gradients are averaged before each
    Adam step, the value MSE and the compressors' batch statistics are
    global, so the parameters, Adam's state and the compressors stay
    replicated.  The other stats are the rank's own."""
    trainer_targets = not cfg.workers_computes_advantages
    if trainer_targets and cfg.augment_data:
        raise ValueError("mirror augmentation is a worker-computes-"
                         "advantages feature")

    def init_fn(net=net) -> PPOState:
        dev = next(net.parameters()).device
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the sqrt
        opt = torch.optim.Adam(net.parameters(), lr=cfg.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        # the countdown starts at 0: the first update syncs the reference
        # (sventon_agent_trainer_base.py:42)
        return PPOState(net=net, optimizer=opt,
                        adv_comp=compressor_init(dev),
                        vloss_comp=compressor_init(dev),
                        ref_net=frozen_copy(net) if trainer_targets else None,
                        ref_countdown=0 if trainer_targets else None)

    def update_fn(state: PPOState, batch, key: torch.Tensor):
        if cfg.augment_data:
            batch = augment_batch(engine_cfg, batch)
        idxs = minibatch_indices(cfg, batch.piece.shape[0], key)
        stats = None
        for epoch in idxs:
            for mb_idx in epoch:
                loss, state.adv_comp, state.vloss_comp, stats = ppo_loss(
                    engine_cfg, cfg, state.net, _rows(batch, mb_idx),
                    state.adv_comp, state.vloss_comp, state.ref_net, group)
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                if group is not None:
                    average_gradients_(state.net.parameters(), group)
                state.optimizer.step()
        state.update_count += 1
        if trainer_targets:
            if state.ref_countdown == 0:
                sync_reference(state)
                state.ref_countdown = cfg.time_to_reference_update
            else:
                state.ref_countdown -= 1
        return state, stats

    return init_fn, update_fn
