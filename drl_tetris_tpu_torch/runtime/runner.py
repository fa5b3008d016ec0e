"""Process runners: the actor-learner runtime of worker and trainer
processes that meet in the control-plane store.

Counterpart of ``drl_tetris_tpu/runtime/runner.py`` (reference:
drl_tetris/runner.py, worker.py, trainer.py): a runner base with
signal-triggered state persistence and checksum-validated recovery; a
worker that streams rollout segments (or their processed batches) to the
store's queue while polling versioned weights; a trainer that drains the
queue into updates and publishes weights.  On one card the trainer and
the workers are processes that share it; every env step of a worker is
one launch of the engine kernel's one-tick entry, as in the standalone
trainers.

Five flavours run through the same two runners, as the reference runs
any agent through its worker and trainer scripts: ``ppo``, ``dual``
(``single_policy=False``: both policies in one worker, one batch each),
``dqn`` and ``sixten`` (the worker ships raw segments, the trainer owns
the prioritized replay) and ``sherlock``.

Every draw follows the JAX package's key chain through the port's
threefry: a worker draws ``PRNGKey(seed) -> split(2 + policies)`` (key,
kenv, then each policy's init key) and ``key, kroll = split(key)`` per
segment, so its initial weights and every sampling draw are JAX's (the
``pi`` or pareto noise may be given instead, ``gumbel``).  A trainer core
draws ``PRNGKey(seed + 7) -> split(1 + policies)`` (key, then each
policy's init key) and one ``split`` per update, so its weights,
minibatches and replay samples are JAX's.

Everything that crosses the store is numpy arrays and plain Python
values (training_state.py): packets, published weights (a state dict, or
a pair of them for ``dual``) and the runners' persisted state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pickle
import signal
import time
from typing import Any, Optional

import numpy as np
import torch

from drl_tetris_tpu_torch import resolve_device
from drl_tetris_tpu_torch.algos.ppo import Batch, make_ppo_update
from drl_tetris_tpu_torch.algos.rollout import (HParams, Segment,
                                                make_rollout_fn,
                                                policy_inputs)
from drl_tetris_tpu_torch.config.parameter import param_eval
from drl_tetris_tpu_torch.engine import rng
from drl_tetris_tpu_torch.engine.core import tree_leaves, tree_map
from drl_tetris_tpu_torch.env.env import TetrisVectorEnv
from drl_tetris_tpu_torch.models.nets import PPONet, QNet
from drl_tetris_tpu_torch.runtime.checkpoint import state_checksum
from drl_tetris_tpu_torch.runtime.standalone import (StandaloneConfig,
                                                     _traj_len_ema,
                                                     adam_state_dict,
                                                     dqn_state_dict,
                                                     load_adam_state,
                                                     load_dqn_state,
                                                     load_ppo_state,
                                                     ppo_state_dict)
from drl_tetris_tpu_torch.runtime.training_state import TrainingState
from drl_tetris_tpu_torch.utils import tracing
from drl_tetris_tpu_torch.utils.metrics import fetch_stats

def effective_flavour(fw) -> str:
    """The reference selects dual-policy training with
    ``single_policy=False`` and the flavour unchanged (worker.py:157-192):
    that combination is the runners' 'dual' flavour."""
    flavour = getattr(fw, "flavour", "ppo")
    if flavour == "ppo" and not fw.ppo.single_policy:
        return "dual"
    return flavour


def to_host(tree):
    """Tensors -> numpy arrays through dicts, lists, tuples and named
    tuples (a named tuple becomes a dict of its fields); other leaves as
    they are."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: to_host(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def to_device(fields: dict, cls, device):
    """A named tuple ``cls`` of tensors on ``device`` from a dict of numpy
    arrays (``to_host``'s form)."""
    return cls(**{k: torch.from_numpy(np.ascontiguousarray(fields[k])).to(
        device) for k in cls._fields})


def _board(cfg: StandaloneConfig):
    return cfg.env.engine.height, cfg.env.engine.width


def _settings(fw) -> dict:
    return getattr(fw, "settings", None) or {}


def make_worker_parts(cfg: StandaloneConfig, env: TetrisVectorEnv,
                      flavour: str = "ppo", fw=None):
    """(nets, rollout, process) of a flavour's worker on ``env``'s device.

    ``nets`` holds one net per policy (two for 'dual'), their weights
    uninitialised; ``rollout(env_state, key, hp, gumbel) ->
    (env_state', segment, v_last)``; ``process(segment, v_last,
    env_state)`` is the packet's payload as numpy: on-policy flavours
    ship processed batches and their GAE stats (spans ``ship.gae``, the
    batch, and ``ship.copy``, its copy to the host), replay flavours raw
    segments (the trainer owns the replay,
    sventon_agent_trainer_base.py:35-42).  Every rollout takes the
    HParams the runner evaluates per segment against the workers' clock
    (sventon_agent.py:87-89); flavours whose sampling ignores them (pi,
    Sherlock's phi.delta) drop them."""
    dev = env.device
    board = _board(cfg)
    dist = getattr(fw, "train_distribution", "pi") if fw else "pi"
    explore = dist if dist != "pi" else "epsilon"
    settings = _settings(fw)
    if flavour in ("ppo", "dual") and not cfg.ppo.workers_computes_advantages:
        raise ValueError("process mode ships worker-side GAE batches "
                         "(workers_computes_advantages=True)")
    if flavour == "ppo":
        net = PPONet(cfg.model, board=board, full_network=True, device=dev)
        rollout = _sampling(make_rollout_fn(env, net, cfg.horizon))
        from drl_tetris_tpu_torch.algos.ppo import segment_to_batch

        def ship(seg, v, env_state):
            with tracing.leaf("ship.gae"):
                b, gae_stats = segment_to_batch(cfg.ppo, seg, v)
            with tracing.leaf("ship.copy"):
                return {"batch": to_host(b), "stats": fetch_stats(gae_stats)}
        return [net], rollout, ship
    if flavour == "dual":
        from drl_tetris_tpu_torch.algos.dual import (make_dual_rollout_fn,
                                                     split_dual_segment)
        nets = [PPONet(cfg.model, board=board, full_network=True, device=dev)
                for _ in range(2)]
        ppo_cfg = dataclasses.replace(cfg.ppo, single_policy=False)
        rollout = _sampling(make_dual_rollout_fn(env, nets, cfg.horizon))

        def ship(seg, v, env_state):
            with tracing.leaf("ship.gae"):
                b0, b1, stats = split_dual_segment(ppo_cfg, seg, v)
            with tracing.leaf("ship.copy"):
                return {"batch0": to_host(b0), "batch1": to_host(b1),
                        "winners": to_host(env.get_winner(env_state)),
                        "stats": fetch_stats(stats)}
        return nets, rollout, ship
    if flavour == "dqn":
        net = QNet(cfg.model, board=board, full_network=True, device=dev)
        rollout = _sampling(make_rollout_fn(env, net, cfg.horizon,
                                            distribution=explore))
        return [net], rollout, _ship_segment
    if flavour == "sixten":
        from drl_tetris_tpu_torch.algos.sixten import (VNet,
                                                       make_sixten_rollout)
        net = VNet(cfg.model, board=board, device=dev)
        roll = make_sixten_rollout(
            env, net, cfg.horizon, distribution=explore,
            action_space=settings.get("sixten_action_space", "top_drop"))

        def rollout(env_state, key, hp, gumbel):
            return roll(env_state, key, hp)
        return [net], rollout, _ship_segment
    if flavour == "sherlock":
        from drl_tetris_tpu_torch.algos.sherlock import (
            SherlockNet, make_sherlock_rollout, sherlock_segment_to_batch)
        net = SherlockNet(cfg.model, board=board, device=dev)
        scfg = _sherlock_cfg(fw)
        roll = make_sherlock_rollout(
            env, net, cfg.horizon,
            action_space=settings.get("sherlock_action_space", "top_drop"))

        def ship(seg, v, env_state):
            return {"batch": to_host(sherlock_segment_to_batch(scfg, seg,
                                                               v)[0])}

        def rollout(env_state, key, hp, gumbel):
            return roll(env_state, key)
        return [net], rollout, ship
    raise ValueError(f"unknown flavour {flavour!r}")


def _sampling(roll):
    """The runner's form of a rollout that may take given noise
    (``make_rollout_fn``, ``make_dual_rollout_fn``)."""
    def rollout(env_state, key, hp, gumbel):
        return roll(env_state, key, gumbel, hp)
    return rollout


def _ship_segment(seg, v, env_state):
    return {"segment": to_host(seg)}


def _sherlock_cfg(fw):
    from drl_tetris_tpu_torch.algos.sherlock import SherlockConfig
    return getattr(fw, "sherlock", None) or SherlockConfig()


def learner_state_dict(st) -> dict:
    """A learner's state as a nested dict of live tensors: the PPO form
    (``ppo_state_dict``), the reference-net form (``dqn_state_dict``) or,
    for Sherlock, params, adam and update_count."""
    if hasattr(st, "adv_comp"):
        return ppo_state_dict(st)
    if hasattr(st, "ref_net"):
        return dqn_state_dict(st)
    return {"params": st.net.state_dict(),
            "adam": adam_state_dict(st.net, st.optimizer),
            "update_count": int(st.update_count)}


def load_learner_state(st, sd: dict):
    """``learner_state_dict``'s form back into ``st``."""
    if hasattr(st, "adv_comp"):
        load_ppo_state(st, sd)
    elif hasattr(st, "ref_net"):
        load_dqn_state(st, sd)
    else:
        st.net.load_params_(sd["params"])
        load_adam_state(st.net, st.optimizer, sd["adam"])
        st.update_count = int(sd["update_count"])


class _Core:
    """What the trainer cores share: the device and JAX's key chain
    ``PRNGKey(seed + 7) -> split(1 + policies)``: the key, then each
    policy's init key (``init_keys``)."""

    def _init_core(self, cfg: StandaloneConfig, device, n_policies=1):
        self.cfg = cfg
        self.device = device
        self.key, *self.init_keys = rng.split(
            rng.prng_key(cfg.seed + 7, device), 1 + n_policies)

    def _next_key(self):
        self.key, kupd = rng.split(self.key)
        return kupd

    def publish_params(self):
        """The weights the workers act with, as numpy."""
        return to_host(self.net.state_dict())

    def state_dict(self) -> dict:
        return {**learner_state_dict(self.state), "key": self.key}

    def load_state_dict(self, sd: dict):
        load_learner_state(self.state, sd)
        self.key = torch.as_tensor(sd["key"]).to(self.device, torch.int64)


class _OnPolicyCore(_Core):
    """PPO and Sherlock: accumulate the workers' batches, train on all of
    them once at least ``min_samples`` arrived, then clear
    (sventon_agent_ppo_trainer.py:22-67)."""

    def __init__(self, cfg, flavour, fw, min_samples, device):
        self._init_core(cfg, device)
        if flavour == "sherlock":
            from drl_tetris_tpu_torch.algos.sherlock import (
                SherlockBatch, SherlockNet, make_sherlock_update)
            self.net = SherlockNet(cfg.model, board=_board(cfg),
                                   device=device)
            init_opt, self.update = make_sherlock_update(
                cfg.env.engine, self.net, _sherlock_cfg(fw))
            self.Batch = SherlockBatch
        else:
            self.net = PPONet(cfg.model, board=_board(cfg),
                              full_network=True, device=device)
            init_opt, self.update = make_ppo_update(cfg.env.engine, self.net,
                                                    cfg.ppo)
            self.Batch = Batch
        self.net.init_flax_(self.init_keys[0])
        self.state = init_opt(self.net)
        self.min_samples = min_samples
        self.pending = []
        self.pending_n = 0

    def add(self, packet):
        self.pending.append(packet["batch"])
        self.pending_n += len(packet["batch"]["piece"])

    def maybe_train(self):
        if self.pending_n < self.min_samples:
            return None
        cat = to_device({f: np.concatenate([b[f] for b in self.pending])
                         for f in self.Batch._fields}, self.Batch,
                        self.device)
        self.pending, self.pending_n = [], 0
        self.state, stats = self.update(self.state, cat, self._next_key())
        return fetch_stats(stats)


class _ReplayCore(_Core):
    """DQN and SIXten: the workers' segments feed the trainer's
    prioritized replay; updates sample from it
    (sventon_agent_dqn_trainer.py:34-81), with alpha and beta evaluated
    at the samples received so far."""

    def __init__(self, cfg, flavour, fw, device):
        from drl_tetris_tpu_torch.algos.replay import (ReplayConfig,
                                                       replay_init)
        self._init_core(cfg, device)
        self.replay_cfg = getattr(fw, "replay", None) or ReplayConfig()
        if flavour == "sixten":
            from drl_tetris_tpu_torch.algos.sixten import (
                SixtenConfig, VNet, make_sixten_update)
            self.net = VNet(cfg.model, board=_board(cfg), device=device)
            ucfg = getattr(fw, "sixten", None) or SixtenConfig()
            init_opt, self.update = make_sixten_update(
                cfg.env.engine, self.net, ucfg, self.replay_cfg)
        else:
            from drl_tetris_tpu_torch.algos.dqn import (DQNConfig,
                                                        make_dqn_update)
            self.net = QNet(cfg.model, board=_board(cfg), full_network=True,
                            device=device)
            ucfg = getattr(fw, "dqn", None) or DQNConfig()
            init_opt, self.update = make_dqn_update(
                cfg.env.engine, self.net, ucfg, self.replay_cfg)
        self.n_needed = ucfg.n_samples_each_update
        self.alpha, self.beta = ucfg.alpha, ucfg.beta
        self.net.init_flax_(self.init_keys[0])
        self.state = init_opt(self.net)
        self.replay = replay_init(self.replay_cfg, device)
        self.t = 0

    def add(self, packet):
        from drl_tetris_tpu_torch.algos.replay import replay_add_segment
        seg = to_device(packet["segment"], Segment, self.device)
        replay_add_segment(self.replay_cfg, self.replay, seg,
                           seg.piece.shape[0])
        self.t += seg.piece.shape[0] * seg.piece.shape[1]

    def maybe_train(self):
        if self.replay.size < self.n_needed:
            return None
        kupd = self._next_key()
        self.state, self.replay, stats = self.update(
            self.state, self.replay, kupd, param_eval(self.alpha, self.t),
            param_eval(self.beta, self.t))
        return fetch_stats(stats)


class _DualCore(_Core):
    """Dual-policy PPO (``single_policy=False`` in process mode): a
    learner per policy, batches accumulated per policy, and the win-rate
    gate: a policy that wins more than 0.5 + tolerance waits until the
    other catches up (sventon_agent_dqn_trainer.py:16-18,
    presets.py:179-180).  Each policy's weights come from its init key."""

    def __init__(self, cfg, fw, min_samples, device):
        from drl_tetris_tpu_torch.algos.dual import WinRateTracker
        self._init_core(cfg, device, n_policies=2)
        self.nets = [PPONet(cfg.model, board=_board(cfg), full_network=True,
                            device=device).init_flax_(k)
                     for k in self.init_keys]
        init_opt, self.update = make_ppo_update(
            cfg.env.engine, self.nets[0],
            dataclasses.replace(cfg.ppo, single_policy=False))
        self.states = [init_opt(net) for net in self.nets]
        s = _settings(fw)
        self.winrate = WinRateTracker(
            lr=float(s.get("winrate_learningrate", 0.02)),
            tolerance=float(s.get("winrate_tolerance", 0.1)))
        self.min_samples = min_samples
        self.pending = ([], [])
        self.pending_n = 0

    @property
    def net(self):
        return self.nets[0]

    def publish_params(self):
        """Both policies' weights, (policy_0, policy_1)
        (sventon_agent_base.py:96-111)."""
        return tuple(to_host(net.state_dict()) for net in self.nets)

    def state_dict(self) -> dict:
        """Policy 0 in the single learners' form (what ``eval`` and the
        league read), policy 1 under ``policy_1``, the key and the gate's
        rate."""
        return {**learner_state_dict(self.states[0]),
                "policy_1": learner_state_dict(self.states[1]),
                "winrate_0": float(self.winrate.rate_0), "key": self.key}

    def load_state_dict(self, sd: dict):
        load_learner_state(self.states[0], sd)
        load_learner_state(self.states[1], sd["policy_1"])
        self.winrate.rate_0 = float(sd["winrate_0"])
        self.key = torch.as_tensor(sd["key"]).to(self.device, torch.int64)

    def add(self, packet):
        for p, k in enumerate(("batch0", "batch1")):
            self.pending[p].append(packet[k])
        self.winrate.update(np.asarray(packet.get("winners", ())))
        self.pending_n += len(packet["batch0"]["piece"])

    def maybe_train(self):
        if self.pending_n < self.min_samples:
            return None
        stats = {}
        for p in (0, 1):
            cat = to_device({f: np.concatenate([b[f] for b in self.pending[p]])
                             for f in Batch._fields}, Batch, self.device)
            if not self.winrate.should_train(p):
                continue
            self.states[p], s = self.update(self.states[p], cat,
                                            self._next_key())
            stats.update({f"policy_{p}/{k}": v for k, v in s.items()})
        self.pending = ([], [])
        self.pending_n = 0
        stats = fetch_stats(stats)
        stats["winrate/policy_0"] = float(self.winrate.rate_0)
        return stats


def make_trainer_core(cfg: StandaloneConfig, flavour: str = "ppo", fw=None,
                      min_samples: int = 2048, device=None):
    """The trainer's learner of ``flavour`` on ``device``."""
    dev = resolve_device(device)
    if flavour in ("ppo", "sherlock"):
        return _OnPolicyCore(cfg, flavour, fw, min_samples, dev)
    if flavour in ("dqn", "sixten"):
        return _ReplayCore(cfg, flavour, fw, dev)
    if flavour == "dual":
        return _DualCore(cfg, fw, min_samples, dev)
    raise ValueError(f"unknown flavour {flavour!r}")


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN restricted to deterministic algorithms and no autotuning
    inside the block (restored after), so a forward's output is a
    property of its inputs, not of the process that ran it."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


class Runner:
    """The runner base (runner.py:26-120): SIGINT or SIGTERM during
    ``run`` only sets ``received_interrupt``; the loop then persists the
    state and a validation checksum to the store and exits.  ``recover``
    restores a persisted state and requires the validation computation to
    reproduce its checksum bit for bit."""

    def __init__(self, ts: TrainingState, device):
        self.ts = ts
        self.device = device
        self.received_interrupt = False

    def _on_signal(self, signum, frame):
        self.received_interrupt = True

    @contextlib.contextmanager
    def _signals(self):
        """The handlers, installed for the duration of ``run`` and the
        previous ones restored after."""
        saved = {s: signal.signal(s, self._on_signal)
                 for s in (signal.SIGINT, signal.SIGTERM)}
        try:
            yield
        finally:
            for s, h in saved.items():
                signal.signal(s, h)

    # subclasses provide these
    def get_runner_state(self) -> Any: ...
    def set_runner_state(self, state: Any): ...
    def validation_computation(self) -> Any: ...
    def graceful_exit(self): ...

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def checksum(self) -> str:
        with deterministic_algorithms():
            return state_checksum(self.validation_computation())

    def persist(self):
        """store_runner_state_and_exit (runner.py:69-80)."""
        self._sync()
        self.ts.store_runner_state(pickle.dumps(self.get_runner_state()))
        self.ts.store_validation(None, self.checksum())
        self.graceful_exit()

    def recover(self) -> bool:
        """recover_runner_state and validate_runner (runner.py:82-104)."""
        blob = self.ts.load_runner_state()
        if blob is None:
            return False
        self.set_runner_state(pickle.loads(blob))
        val = self.ts.load_validation()
        if val is not None:
            _, expected = val
            got = self.checksum()
            if got != expected:
                raise RuntimeError(
                    f"recovery validation failed: {got} != {expected}")
        return True


class WorkerRunner(Runner):
    """drl_tetris/worker.py: rollout segments to the queue, weights from
    the store."""

    def __init__(self, cfg: StandaloneConfig, ts: TrainingState,
                 flavour: str = "ppo", fw=None, device=None):
        super().__init__(ts, resolve_device(device))
        self.cfg = cfg
        self.flavour = flavour
        self.env = TetrisVectorEnv(cfg.env, cfg.n_envs, device=self.device)
        self.nets, self.rollout, self._process = make_worker_parts(
            cfg, self.env, flavour, fw)
        # sampling schedules, evaluated per segment against the shared
        # workers' clock (sventon_agent.py:87-89)
        self._sched_eps = getattr(fw, "epsilon", 0.05) if fw else 0.05
        self._sched_temp = (getattr(fw, "action_temperature", 1.0)
                            if fw else 1.0)
        self._tau = getattr(fw, "tau_learning_rate", 0.01) if fw else 0.01
        self._dist = getattr(fw, "train_distribution", "pi") if fw else "pi"
        self.avg_traj_len = 12.0          # sherlock_agent.py:39 init
        self._ep_len = torch.zeros(cfg.n_envs, dtype=torch.int32,
                                   device=self.device)
        self.key, kenv, *kinit = rng.split(
            rng.prng_key(cfg.seed, self.device), 2 + len(self.nets))
        for net, k in zip(self.nets, kinit):
            net.init_flax_(k)
        self.env_state = self.env.reset(kenv)
        self.weights_index = 0

    def hparams(self, clock: int) -> HParams:
        return HParams(epsilon=param_eval(self._sched_eps, clock),
                       temperature=param_eval(self._sched_temp, clock),
                       avg_traj_len=self.avg_traj_len)

    def get_runner_state(self):
        return {"env_state": {name: t.cpu().numpy() for name, t in
                              tree_leaves(self.env_state)},
                "params": [to_host(net.state_dict()) for net in self.nets],
                "weights_index": int(self.weights_index),
                "key": to_host(self.key),
                "avg_traj_len": float(self.avg_traj_len),
                "ep_len": to_host(self._ep_len)}

    def set_runner_state(self, state):
        dev = self.device
        leaves = iter([state["env_state"][name]
                       for name, _ in tree_leaves(self.env_state)])
        self.env_state = tree_map(
            lambda _: torch.from_numpy(next(leaves)).to(dev), self.env_state)
        for net, params in zip(self.nets, state["params"]):
            net.load_params_(params)
        self.weights_index = int(state["weights_index"])
        self.key = torch.from_numpy(state["key"]).to(dev)
        self.avg_traj_len = float(state["avg_traj_len"])
        self._ep_len = torch.from_numpy(state["ep_len"]).to(dev)

    @torch.no_grad()
    def validation_computation(self):
        """A recovered worker must reproduce bit-identical policy output
        (worker.py:62-69); the dual flavour checks policy 0's."""
        vec, vis = policy_inputs(self.env.observe(self.env_state))
        out = self.nets[0](vec, vis)
        return to_host(out if isinstance(out, tuple) else (out,))

    def graceful_exit(self):
        self.ts.unset_alive()

    def update_weights(self) -> int:
        """worker.py:131-140: poll the version index, pull on change."""
        idx = self.ts.weights_index()
        if idx > self.weights_index:
            _, weights = self.ts.fetch_weights()
            if weights is not None:
                if len(self.nets) == 1:
                    weights = (weights,)
                for net, w in zip(self.nets, weights):
                    net.load_params_(w)
            self.weights_index = idx
        return idx

    def collect(self, clock: int, gumbel: Optional[torch.Tensor] = None
                ) -> dict:
        """One segment at the schedules' values for ``clock``, processed
        into a packet (numpy).  ``gumbel`` replaces the rollout's pi or
        pareto noise."""
        self.key, kroll = rng.split(self.key)
        hp = self.hparams(clock)
        self.env_state, seg, v_last = self.rollout(
            self.env_state, kroll, hp, gumbel)
        if self._dist == "adaptive_epsilon":
            self._ep_len, self.avg_traj_len = _traj_len_ema(
                seg.done, self._ep_len, self.avg_traj_len, self._tau)
        return {"worker": self.ts.me, "weights_index": self.weights_index,
                **self._process(seg, v_last, self.env_state)}

    def run(self, max_steps: Optional[int] = None, logger=None):
        steps = 0
        with self._signals():
            recovered = self.recover()
            if logger and recovered:
                logger(f"{self.ts.me}: recovered state from store "
                       f"(weights_index={self.weights_index})")
            n = self.cfg.n_envs * self.cfg.horizon
            while not self.received_interrupt:
                t0 = time.perf_counter()
                self.ts.heartbeat()
                clock = self.ts.tick_clock(n)
                self.update_weights()
                packet = self.collect(clock)
                self.ts.push_data(packet)
                steps += n
                if logger:
                    eps = param_eval(self._sched_eps, clock)
                    logger(f"{self.ts.me}: segment pushed  steps={steps:,}  "
                           f"weights_index={self.weights_index}  "
                           f"epsilon={eps:.4f}  "
                           f"queue={self.ts.queue_len()}  "
                           f"{n / (time.perf_counter() - t0):.1f} "
                           f"env-steps/s")
                if max_steps is not None and steps >= max_steps:
                    break
            self.persist()
        if logger:
            how = " on a signal" if self.received_interrupt else ""
            logger(f"{self.ts.me}: state persisted{how}, exiting "
                   f"({steps:,} steps)")
        return steps


class TrainerRunner(Runner):
    """drl_tetris/trainer.py: drain the queue, update, publish weights.
    A numbered checkpoint (the port's ``state.pt`` beside the JAX-identical
    ``settings.json``) every ``NUMBERED_EVERY`` publishes and one at
    exit, at the workers' clock."""

    def __init__(self, cfg: StandaloneConfig, ts: TrainingState,
                 min_samples: int = 2048, ckpt_dir: Optional[str] = None,
                 settings: Optional[dict] = None, flavour: str = "ppo",
                 fw=None, device=None):
        super().__init__(ts, resolve_device(device))
        self.cfg = cfg
        self.ckpt_dir = ckpt_dir
        self.settings = settings
        self.core = make_trainer_core(cfg, flavour, fw, min_samples,
                                      self.device)
        self.net = self.core.net
        self.update_s = []

    def get_runner_state(self):
        return to_host(self.core.state_dict())

    def set_runner_state(self, state):
        self.core.load_state_dict(state)

    def validation_computation(self):
        return self.core.publish_params()

    def graceful_exit(self):
        """trainer.py:47-50: publish the final weights."""
        self.ts.publish_weights(self.core.publish_params())
        self.ts.unset_alive()

    def drain(self):
        """load_worker_data (trainer.py:83-87)."""
        for packet in self.ts.pop_data_iter():
            self.core.add(packet)

    def maybe_train(self):
        """do_training: on-policy flavours wait for their samples, then
        clear; replay flavours sample their replay."""
        return self.core.maybe_train()

    def _save_ckpt(self, step: int):
        if self.ckpt_dir is not None:
            from drl_tetris_tpu_torch.runtime import checkpoint as ckpt
            self._sync()
            ckpt.save(self.ckpt_dir, step,
                      {**self.core.state_dict(), "total_steps": int(step)},
                      settings=self.settings)

    def run(self, max_updates: Optional[int] = None, logger=None,
            log_every: int = 1):
        from drl_tetris_tpu_torch.runtime.checkpoint import NUMBERED_EVERY
        updates = 0
        with self._signals():
            if self.recover() and logger:
                logger("trainer: recovered state from store")
            while not self.received_interrupt:
                self.ts.heartbeat()
                self.drain()
                t0 = time.perf_counter()
                stats = self.maybe_train()
                if stats is None:
                    time.sleep(0.01)
                    continue
                self.update_s.append(time.perf_counter() - t0)
                updates += 1
                idx = self.ts.publish_weights(self.core.publish_params())
                for k, v in stats.items():
                    self.ts.stats_set(k, v)
                if logger and updates % log_every == 0:
                    head = {k: stats[k] for k in
                            ("losses/total_loss", "entropy/entropy")
                            if k in stats}
                    logger(f"trainer: update {updates}  weights_index={idx}  "
                           f"clock={self.ts.clock():,}  "
                           f"update_s={self.update_s[-1]:.3f}  "
                           + "  ".join(f"{k.split('/')[-1]}={v:.4f}"
                                       for k, v in head.items()))
                # a numbered checkpoint every NUMBERED_EVERY publishes
                # (trainer.py:113-123; the latest lives in the store)
                if updates % NUMBERED_EVERY == 0:
                    self._save_ckpt(self.ts.clock())
                if max_updates is not None and updates >= max_updates:
                    break
            self._save_ckpt(max(self.ts.clock(), 1))
            self.persist()
        if logger:
            logger(f"trainer: exiting after {updates} updates")
        return updates
