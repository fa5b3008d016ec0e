"""SIXten: k-step value learning, prioritized replay and a one-ply
world-model search over legal placements.

Counterpart of ``drl_tetris_tpu/algos/sixten.py`` (reference: prio_vnet,
agents/networks/prio_vnet.py:8-305, and the environment's world-model
interface, tetris_environment.py:77-100).  Acting: enumerate the acting
piece's legal placements (``engine/masks.placement_boards`` for the
top-drop grid, ``pose_boards`` for the full top-drop and finesse set),
evaluate V on every successor board in one batched forward, pick the best
(or explore).  Training: a prioritized sample, k-step lambda targets
through the reference net (``value_estimator.make_target_fn``), IS-weighted
MSE on V(s | piece) with Adam, new priorities |v - target|.

Every draw follows JAX's keys through the port's threefry: the policy
splits its key into (kexp, kpick); ``jax.random.categorical`` is the
argmax of logits plus JAX's gumbel noise (``distributions.categorical``),
and the explore draw a uniform.  The initial weights are JAX's
(``VNet.init_flax_``).  A top-drop tick evaluates 4 W successor boards per game, a full-space tick
4 W H.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.nn as nn

from drl_tetris_tpu_torch import resolve_device
from drl_tetris_tpu_torch.algos.ppo import (frozen_copy, minibatch_indices,
                                            sync_reference)
from drl_tetris_tpu_torch.algos.distributions import categorical
from drl_tetris_tpu_torch.algos.replay import (ReplayConfig, ReplayState,
                                               replay_gather_windows,
                                               replay_sample,
                                               replay_update_prios)
from drl_tetris_tpu_torch.algos.rollout import (HParams, Segment,
                                                _perspective_occ, _tick_keys)
from drl_tetris_tpu_torch.algos.value_estimator import (EstimatorConfig,
                                                        make_target_fn)
from drl_tetris_tpu_torch.engine import masks as M
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.engine.core import EngineConfig
from drl_tetris_tpu_torch.env.env import TetrisVectorEnv, take_player
from drl_tetris_tpu_torch.env.observations import field_grid
from drl_tetris_tpu_torch.models.flax_init import FlaxInit
from drl_tetris_tpu_torch.models.nets import (VEC_DIM, ModelConfig,
                                              ResidualBlock, apply_visual_pad)

DISTRIBUTIONS = ("epsilon", "adaptive_epsilon", "argmax", "boltzmann")


class VNet(nn.Module):
    """prio_vnet's network: the SventonNet trunk without its action head,
    ending in per-piece tanh values (B, P) ((B, 1) without
    ``separate_piece_values``).  The weights live on ``device`` (default
    the card)."""

    def __init__(self, cfg: ModelConfig, board=(22, 10),
                 full_network: bool = True, device=None):
        super().__init__()
        self.cfg, self.board = cfg, tuple(board)
        self.full_network = full_network
        dt = cfg.torch_dtype
        tower = dict(n_layers=cfg.tower_layers, n_filters=cfg.tower_filters,
                     filter_size=(cfg.tower_filter_size,) * 2,
                     dropout=cfg.dropout, dtype=dt)
        self.vis_tower = nn.ModuleList(
            [ResidualBlock(1, **tower) for _ in range(2)])
        c_join = VEC_DIM + self.vis_tower[0].out_channels
        self.join_tower = nn.ModuleList(
            [ResidualBlock(c_join, **tower) for _ in range(2)])
        self.value_tower = ResidualBlock(
            2 * self.join_tower[0].out_channels + 2,
            n_layers=cfg.val_layers, n_filters=cfg.val_filters,
            filter_size=(cfg.val_filter_size,) * 2, pools=True,
            output_n_filters=(cfg.n_pieces + 1
                              if cfg.separate_piece_values else 1),
            output_activation=None, output_layer=True,
            normalization="layer", dropout=cfg.dropout, dtype=dt)
        self.register_buffer("piece_mask", cfg.piece_mask, persistent=False)
        self.to(resolve_device(device))

    def init_flax_(self, key) -> "VNet":
        """Fresh weights from the init key ``key``: what the JAX VNet's
        ``init(key, ...)`` gives (models/flax_init.py)."""
        init = FlaxInit(self, key)
        for m in self.modules():
            if isinstance(m, ResidualBlock):
                m.init_flax_(init)
        return self

    def load_params_(self, params) -> "VNet":
        self.load_state_dict({k: torch.as_tensor(v)
                              for k, v in params.items()})
        return self

    def forward(self, vec, vis):
        dt = self.cfg.torch_dtype
        vis = [apply_visual_pad(v).permute(0, 3, 1, 2).to(dt) for v in vis]
        vec = [v.to(dt) for v in vec]
        hidden = [t(v) for t, v in zip(self.vis_tower, vis)]
        h, w = hidden[0].shape[2:]
        joined = [t(torch.cat([v[:, :, None, None].expand(
            v.shape[0], v.shape[1], h, w), hv], dim=1))
            for t, v, hv in zip(self.join_tower, vec, hidden)]
        v = self.value_tower(torch.cat(joined + vis, dim=1))
        v = v.float().mean(dim=(2, 3))                   # (B, P+1 | 1)
        if v.shape[-1] > 1:
            base, offs = v[:, :1], v[:, 1:]
            mask = self.piece_mask[None, :]
            mean = (offs.mean(-1, keepdim=True) * mask).sum(
                -1, keepdim=True) / mask.sum()
            return torch.tanh(base + (offs - mean))
        return torch.tanh(v)


# ---------------------------------------------------------------------------
# Acting: one-ply world-model search over legal placements
# ---------------------------------------------------------------------------

def _explore_eps(distribution: str, hp: HParams):
    """The explore probability of the epsilon distributions, float32 as
    JAX computes it (adaptive: epsilon / max(avg_traj_len, 1e-6))."""
    eps = torch.as_tensor(hp.epsilon, dtype=torch.float32)
    if distribution == "adaptive_epsilon":
        atl = torch.as_tensor(hp.avg_traj_len, dtype=torch.float32)
        eps = eps.to(atl.device) / torch.clamp(atl, min=1e-6)
    return eps


def make_sixten_policy(env: TetrisVectorEnv, net: VNet,
                       distribution: str = "epsilon", epsilon: float = 0.05,
                       action_space: str = "top_drop"):
    """Returns policy(env_state, key, hp=None, mark=None) -> (obs, piece,
    r_rel, x, prob, v_sel, v_mean) for env.step_place, or with
    action_space "full" (obs, piece, rot, col, y, prob, v_sel, v_mean) for
    env.step_pose.  Each successor observation replaces the acting
    player's board by the candidate board and zeroes the next-piece
    one-hot (not drawn yet); V is read for the piece that acts in the
    successor (the current next piece).  ``key`` is the tick's (2,) key
    (unused by argmax); ``mark(name)`` is called after the masks and after
    the forward and choice (phase timing)."""
    if distribution not in DISTRIBUTIONS:
        raise ValueError(distribution)
    cfg = env.cfg.engine
    W, H = cfg.width, cfg.height
    full = action_space == "full"

    @torch.no_grad()
    def policy(env_state, key=None, hp: Optional[HParams] = None,
               mark: Optional[Callable[[str], None]] = None):
        if hp is None:
            hp = HParams(epsilon=epsilon)
        obs = env.observe(env_state)
        p = env_state.current_player
        ps = env_state.engine.players
        occ, garb, piece, rot, nxt = (take_player(a, p) for a in (
            ps.occ, ps.garb, ps.piece, ps.rot, ps.nextpiece))
        fn = M.pose_boards if full else M.placement_boards
        mask, occ_after, _ = fn(cfg, occ, garb, piece, rot)
        if mark is not None:
            mark("masks")
        n = p.shape[0]
        k = mask[0].numel()
        my_grid = field_grid(cfg, occ_after.reshape(n * k, H))
        vec_me = obs.vec[:, 0:1, :].expand(n, k, VEC_DIM).clone()
        vec_me[:, :, 5:] = 0.0
        vec_opp = obs.vec[:, 1:2, :].expand(n, k, VEC_DIM)
        vis_opp = obs.vis[:, 1:2].expand((n, k) + obs.vis.shape[2:])
        v = net([vec_me.reshape(n * k, VEC_DIM),
                 vec_opp.reshape(n * k, VEC_DIM)],
                [my_grid[..., None],
                 vis_opp.reshape((n * k,) + obs.vis.shape[2:])])
        v = v.reshape(n, k, -1)
        if v.shape[-1] > 1:
            v_next = v.gather(2, nxt.long()[:, None, None].expand(n, k, 1)
                              )[..., 0]
            v_mean_next = v.mean(-1)
        else:
            v_next = v_mean_next = v[..., 0]
        legal = mask.reshape(n, k)
        scores = torch.where(legal, v_next, -torch.inf)
        greedy = torch.argmax(scores, dim=1)
        if distribution == "argmax":
            choice = greedy
        else:
            kexp, kpick = rng.split(key.to(occ.device))
            if distribution == "boltzmann":
                choice = categorical(kpick, scores)
            else:
                rand_pick = categorical(kpick, torch.log(legal.float()))
                u = rng.uniform01(kexp, (n,))
                eps = _explore_eps(distribution, hp).to(u.device)
                choice = torch.where(u < eps, rand_pick, greedy)
        count = legal.sum(1)
        choice = torch.where(count > 0, choice, 0)
        idx = torch.arange(n, device=choice.device)
        v_sel = scores[idx, choice]
        v_sel = torch.where(torch.isfinite(v_sel), v_sel, 0.0)
        prob = torch.where(count > 0, 1.0 / torch.clamp(count, min=1), 1.0
                           ).to(torch.float32)
        v_mean = torch.where(legal, v_mean_next, 0.0).mean(1)
        if mark is not None:
            mark("forward")
        if full:
            return (obs, piece, (choice // (W * H)).to(torch.int32),
                    ((choice // H) % W).to(torch.int32),
                    (choice % H).to(torch.int32), prob, v_sel, v_mean)
        r_abs = choice // W
        x = (choice % W - 1).to(torch.int32)
        r_rel = torch.remainder(r_abs - rot, 4).to(torch.int32)
        return obs, piece, r_rel, x, prob, v_sel, v_mean

    return policy


KEYED = ("epsilon", "adaptive_epsilon", "boltzmann")


def make_sixten_rollout(env: TetrisVectorEnv, net: VNet, horizon: int,
                        distribution: str = "epsilon", epsilon: float = 0.05,
                        action_space: str = "top_drop"):
    """Returns rollout(env_state, key, hp=None, mark=None) -> (env_state',
    Segment, v_last): ``horizon`` ticks of the world-model policy, each
    stepped with env.step_place (top-drop) or env.step_pose (full), one
    launch of the engine kernel's per-kind entry on the card.  The keys
    are JAX's: split(key, horizon) per tick, fold_in(key, horizon) for the
    bootstrap.  ``mark`` gets "masks", "forward" and "tick" each tick."""
    full = action_space == "full"
    policy = make_sixten_policy(env, net, distribution, epsilon,
                                action_space)
    keyed = "epsilon" if distribution in KEYED else distribution

    @torch.no_grad()
    def rollout(env_state, key=None, hp: Optional[HParams] = None,
                mark: Optional[Callable[[str], None]] = None):
        keys, last_key = _tick_keys(key, horizon, keyed)
        ticks = []
        for t in range(horizon):
            player = env_state.current_player
            obs, piece, *act, prob, v_sel, v_mean = policy(
                env_state, keys[t], hp, mark)
            occ = _perspective_occ(env_state, player)
            if full:
                r, c, y = act
                env_state, reward, done = env.step_pose(env_state, r, c, y)
                rec_rot, rec_tr = r, c
            else:
                r, x = act
                env_state, reward, done = env.step_place(env_state, r, x)
                rec_rot, rec_tr = r, torch.clamp(x, min=0)
            if mark is not None:
                mark("tick")
            ticks.append(Segment(occ=occ, vec=obs.vec, piece=piece,
                                 rot=rec_rot, trans=rec_tr, prob=prob,
                                 v_piece=v_sel, v_mean=v_mean, reward=reward,
                                 done=done, player=player))
        seg = Segment(*[torch.stack(xs) for xs in zip(*ticks)])
        out = policy(env_state, last_key, hp)
        if mark is not None:
            mark("forward")
        return env_state, seg, out[-2]

    return rollout


# ---------------------------------------------------------------------------
# Training: prio_vnet's update (prio_vnet.py:176-232)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SixtenConfig:
    lr: float = 1e-4
    nn_regularizer: float = 1e-4
    n_samples_each_update: int = 4096
    minibatch_size: int = 32
    n_train_epochs: int = 1
    alpha: Any = 0.7                      # prioritized_replay_alpha
    beta: Any = 0.7                       # (scheduled per update)
    time_to_reference_update: int = 3
    estimator: EstimatorConfig = EstimatorConfig()


@dataclasses.dataclass
class SixtenState:
    """``net`` holds the parameters, ``ref_net`` the reference copy the
    targets bootstrap through, ``optimizer`` Adam's state."""
    net: torch.nn.Module
    ref_net: torch.nn.Module
    optimizer: torch.optim.Adam
    update_count: int = 0


def v_of(engine_cfg: EngineConfig, net, occ, vec, piece) -> torch.Tensor:
    """V(s | piece) (B,) of stored states."""
    grids = field_grid(engine_cfg, occ)
    v = net([vec[:, 0, :], vec[:, 1, :]],
            [grids[:, 0, :, :, None], grids[:, 1, :, :, None]])
    if v.shape[-1] > 1:
        return v[torch.arange(v.shape[0], device=v.device), piece.long()]
    return v[:, 0]


def sixten_loss(engine_cfg: EngineConfig, cfg: SixtenConfig, net, mb: dict,
                weights: torch.Tensor):
    """(loss, new priorities (B,), stats) of one minibatch."""
    v = v_of(engine_cfg, net, mb["occ0"], mb["vec0"], mb["piece"])
    err = v - mb["target"]
    value_loss = torch.mean(weights * err ** 2)
    reg = cfg.nn_regularizer * 0.5 * sum(
        torch.sum(torch.square(w)) for w in net.parameters())
    loss = value_loss + reg
    stats = {k: x.detach() for k, x in {
        "v_val": torch.mean(v), "v_target": torch.mean(mb["target"]),
        "value_loss": value_loss, "reg_loss": reg, "tot_loss": loss}.items()}
    return loss, err.detach().abs(), stats


def sample_for_update(engine_cfg: EngineConfig, cfg: SixtenConfig,
                      replay_cfg: ReplayConfig, target_fn, ref_net,
                      replay: ReplayState, key, alpha, beta, gumbel=None):
    """(idx, is_weights, samples, kp): the prioritized sample (JAX's key
    ks of split(key), or the given gumbel noise) with its k-step
    targets."""
    ks, kp = rng.split(key)
    idx, iw = replay_sample(replay_cfg, replay, cfg.n_samples_each_update,
                            alpha, beta, ks, gumbel)
    win = replay_gather_windows(replay_cfg, replay, idx)
    samples = {"occ0": win["occ"][:, 0], "vec0": win["vec"][:, 0],
               "piece": win["piece"], "target": target_fn(ref_net, win)}
    return idx, iw, samples, kp


def make_sixten_update(engine_cfg: EngineConfig, net: VNet,
                       cfg: SixtenConfig, replay_cfg: ReplayConfig):
    """Returns (init_fn(net) -> SixtenState, update_fn(state, replay, key,
    alpha, beta, gumbel=None, mark=None) -> (state, replay, stats)):
    prioritized k-step V-learning; epochs shuffle with JAX's permutation,
    each row's new priority is from the last epoch whose minibatches held
    it, and the reference net syncs every ``time_to_reference_update``
    updates."""
    target_fn = make_target_fn(engine_cfg, None, cfg.estimator)

    def init_fn(net=net) -> SixtenState:
        opt = torch.optim.Adam(net.parameters(), lr=cfg.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        return SixtenState(net=net, ref_net=frozen_copy(net), optimizer=opt)

    def update_fn(state: SixtenState, replay: ReplayState, key, alpha, beta,
                  gumbel=None, mark: Optional[Callable[[str], None]] = None):
        idx, iw, samples, kp = sample_for_update(
            engine_cfg, cfg, replay_cfg, target_fn, state.ref_net, replay,
            key, alpha, beta, gumbel)
        if mark is not None:
            mark("targets")
        n = cfg.n_samples_each_update
        prio_buf = torch.zeros(n, dtype=torch.float32, device=iw.device)
        stats = None
        for epoch in minibatch_indices(cfg, n, kp):
            for mi in epoch:
                mb = {k: v.index_select(0, mi) for k, v in samples.items()}
                loss, prios, stats = sixten_loss(engine_cfg, cfg, state.net,
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
