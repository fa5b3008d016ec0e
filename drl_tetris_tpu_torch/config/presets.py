"""Layered experiment presets -> typed framework config.

The port's copy of ``drl_tetris_tpu/config/presets.py`` (reference:
experiments/presets.py, tools/utils.py:34-45 parse_settings): the same
preset dictionaries (plain data and registry names), the same layering
(presets in order, then the experiment dict, patches and CLI overrides),
and the same typed result.

The port has no SIXten or Sherlock configs yet (ROADMAP 13):
``FrameworkConfig.sixten`` and ``sherlock`` stay None.  ``resolve``
accepts every preset all the same, so evaluation and ``print-config`` read
any run's settings; ``train`` refuses what it cannot run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

from drl_tetris_tpu_torch.algos.dqn import DQNConfig
from drl_tetris_tpu_torch.algos.ppo import CompressorConfig, PPOConfig
from drl_tetris_tpu_torch.algos.replay import ReplayConfig
from drl_tetris_tpu_torch.algos.value_estimator import EstimatorConfig
from drl_tetris_tpu_torch.config.parameter import (ExpParameter,
                                                   LinearParameter,
                                                   Parameter, param_eval)
from drl_tetris_tpu_torch.engine.core import EngineConfig
from drl_tetris_tpu_torch.env.env import EnvConfig
from drl_tetris_tpu_torch.models.nets import ModelConfig

# ---------------------------------------------------------------------------
# Preset dictionaries (flat key -> value, dotted keys address sub-configs)
# ---------------------------------------------------------------------------

PRESETS: Dict[str, Dict[str, Any]] = {
    # experiments/presets.py:123-182
    "default": {
        "agent": "sventon",
        "flavour": "ppo",
        "game_size": (22, 10),
        "pieces": (0, 1, 2, 3, 4, 5, 6),
        "n_players": 2,
        "time_elapsed_each_action": 400,
        "gamma": 0.98,
        "n_step_value_estimates": 5,
        "extra_rewards": False,
        "experience_replay_size": 2 * 10**6,
        "experience_replay_sample_mode": "rank",
        "time_to_reference_update": 1,
        "single_policy": True,
        "nn_regularizer": 1e-4,
        "eval_distribution": "argmax",
        "n_envs_per_thread": 30,
        "run_standalone": False,
        "augment_data": False,
    },
    # experiments/presets.py:30-58
    "sventon": {
        "n_samples_each_update": 8192,
        "minibatch_size": 32,
        "n_train_epochs_per_update": 3,
        "value_lr": Parameter(1e-4),
        "separate_piece_values": True,
        "advantage_type": "mean",
        "compress_advantages": None,
    },
    # experiments/presets.py:60-75
    "sventon_ppo": {
        "flavour": "ppo",
        "train_distribution": "pi",
        "eval_distribution": "pi",
        "workers_computes_advantages": True,
        "clipping_parameter": 0.05,
        "value_loss": 1.0,
        "policy_loss": 1.0,
        "entropy_loss": 0.01,
        "experience_replay_size": 5 * 10**4,
    },
    # experiments/presets.py:77-87
    "sventon_dqn": {
        "flavour": "dqn",
        "eval_distribution": "argmax",
        "train_distribution": "epsilon",
        "epsilon": Parameter(0.05),
        "prioritized_replay_alpha": Parameter(0.7),
        "prioritized_replay_beta": Parameter(0.7),
        "optimistic_prios": 0.0,
        "workers_computes_advantages": False,
    },
    # experiments/presets.py:89-104
    "resblock": {
        "architecture": "silver",
        "tower_layers": 3,
        "tower_filters": 64,
        "val_layers": 4,
        "val_filters": 64,
    },
    # experiments/sventon_ppo.py — the recommended default experiment
    "experiment_sventon_ppo": {
        "compress_advantages": CompressorConfig(lr=0.005, safety=3.0,
                                                clip_val=8.0, cautious=False),
        "compress_value_loss": CompressorConfig(lr=0.005, safety=3.0,
                                                clip_val=8.0, cautious=False),
        "n_step_value_estimates": 1,
        "clipping_parameter": 0.15,
        "value_loss": 0.01,
        "policy_loss": 0.9,
        "entropy_loss": 0.0,
        "value_lr": Parameter(1e-7),
        "n_samples_each_update": 2048,
        "minibatch_size": 64,
        "n_train_epochs_per_update": 4,
        "gae_lambda": 0.7,
        "gamma": 0.98,
        "nn_regularizer": 1e-5,
        "experience_replay_size": 2 * 10**4,
        "tower_layers": 5,
        "tower_filters": 64,
        "val_layers": 6,
        "val_filters": 128,
        "val_filter_size": 5,
        "n_envs_per_thread": 30,
    },
    # experiments/sixten_base.py — SIXten: V-learning on prioritized replay
    # with k-step estimates, using the env's world model
    "experiment_sixten": {
        "flavour": "sixten",
        "n_step_value_estimates": 5,
        "n_samples_each_update": 16384,
        "minibatch_size": 128,
        "n_train_epochs_per_update": 1,
        "time_to_reference_update": 20,
        # sixten_base.py:17-21 schedules for a 10M-step run: lr decays 3
        # decades over the horizon, beta anneals 0.5 -> 1.0
        "value_lr": ExpParameter(1e-3, base=10.0, decay=-3 / 10_000_000),
        "prioritized_replay_alpha": Parameter(0.7),
        "prioritized_replay_beta": LinearParameter(
            0.5, decay=0.5 / 10_000_000, max_val=1.0),
        "pieces": (0, 6),
        "train_distribution": "epsilon",
        "n_envs_per_thread": 16,
    },
    # experiments/presets.py:9-28 — Sherlock (delta-PPO over a spatial phi
    # field); agent/trainer classes become the flavour name, TF activation
    # objects become data
    "sherlock": {
        "agent": "sherlock",
        "flavour": "sherlock",
        "separate_piece_values": False,
        "train_distribution": "pi",
        "eval_distribution": "pi",
        "advantage_type": "mean",
        "workers_computes_advantages": True,
        "truncate_aggregation": True,
        "impossibility_loss": 0.1,
        "n_envs_per_thread": 16,
    },
    # experiments/sventon_dqn.py flavour
    "experiment_sventon_dqn": {
        "flavour": "dqn",
        "n_step_value_estimates": 37,
        "sparse_value_estimate_filter": (2, 3),
        "train_distribution": "pareto_distribution",
    },
    # The r3 long-run recipe (LEARNING_r03): fixes the r2 late-run
    # regression — Elo fell 2813 -> 2526 after 7.9M steps and the 10M
    # checkpoint lost 54/64 to the 6M demo (LEARNING_r02.json).  Three
    # levers: (1) lr decay instead of a constant hot lr (scheduled
    # parameter, presets.py:49 precedent), (2) an entropy floor that only
    # pushes back when the policy collapses below ~epsilon-noise entropy
    # (ppo_nets.py:178-183 terms), (3) league-pool opponents so self-play
    # stops chasing only its current self (cycling).  Minibatch 512 is the
    # TPU batch geometry (same algorithm; see bench.py roofline note).
    # Recipe history (measured, NOTES_ROUND3.md): variant A
    # (entropy_loss 0.01, pool_prob 0.35) kept entropy pinned at ~3.0 for
    # 8M steps — the policy never sharpened and lost 0-64 to the r2 6M
    # demo despite a monotone league curve.  The shipped variant keeps the
    # anti-cycling levers but makes the entropy term FLOOR-ONLY: the raw
    # bonus coefficient is negligible (the reference ships entropy_loss 0,
    # sventon_ppo.py) and the floor term (entropy_floor_loss * -relu(floor
    # - H), ppo_nets.py:178-183) only pushes back when entropy collapses
    # below ~eps-noise level (~0.43 at ppo_epsilon 0.05).
    "r3_learning": {
        "value_lr": LinearParameter(1e-4, final_val=3e-5,
                                    time_horizon=10_000_000),
        "entropy_loss": 0.001,
        "entropy_floor_loss": 100.0,
        "ppo_epsilon": 0.05,
        "minibatch_size": 512,
        "pool_prob": 0.2,
        "pool_size": 4,
        "pool_every": 40,
    },
    # The r4 recipe: the r3 gauntlet showed all three r3 levers applied
    # TOGETHER produced finals that lose 0-64 to the 6M demo
    # (data/summaries/h2h_r3b.json), while the strongest known agent
    # (data/demo_weights) came from the clean hot-lr recipe with NO
    # entropy terms and NO pool.  r4 keeps ONLY the lr decay (the fix for
    # the measured late-run degradation at constant 1e-4: demo10m's league
    # Elo fell 2813 -> 2526 after 7.9M, and its 10M final lost 10-54 to
    # the 6M demo) on top of the clean recipe.  The r4 ablations
    # (docs/NOTES_ROUND4.md) isolate which r3 lever caused the stall.
    "r4_learning": {
        "value_lr": LinearParameter(1e-4, final_val=3e-5,
                                    time_horizon=10_000_000),
        "entropy_loss": 0.0,
    },
    # Round 5 recipe of record: the r4c recipe (clean + lr decay) with
    # the now-validated entropy floor on by default.  The chip-efficient
    # mb256 geometry (43.7% MFU, 2x wall speed; lr sweep ab_r5_lrA/B/C)
    # was tried as the committed recipe and REJECTED on learning
    # evidence: it matches mb64 head-to-head at 2.5M but degrades by 10M
    # (parity10m_r5 final lost to its own 4-7M snapshots and 0-64 to the
    # demo; 8-epoch repair destabilized — docs/NOTES_ROUND5.md).  Large
    # minibatches are available via --set minibatch_size=... for short
    # runs where the 2x speed is worth the late-run risk.
    "r5_learning": {
        "minibatch_size": 64,
        "value_lr": LinearParameter(1e-4, final_val=3e-5,
                                    time_horizon=10_000_000),
        "entropy_loss": 0.0,
        "entropy_floor_standalone": 10.0,
        "ppo_epsilon": 0.05,
    },
}


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    """The fully resolved, typed configuration of one run."""
    settings: Dict[str, Any]          # the merged flat dict (for provenance)
    env: EnvConfig = EnvConfig()
    model: ModelConfig = ModelConfig()
    ppo: PPOConfig = PPOConfig()
    dqn: DQNConfig = DQNConfig()
    sixten: Any = None                # SixtenConfig: ROADMAP 13
    sherlock: Any = None              # SherlockConfig: ROADMAP 13
    replay: ReplayConfig = ReplayConfig()
    flavour: str = "ppo"
    n_envs: int = 30
    train_distribution: str = "pi"
    eval_distribution: str = "argmax"
    run_id: str = "run"
    # sampling schedules (ParamLike, evaluated per iteration)
    epsilon: Any = 0.05               # presets.py:81
    action_temperature: Any = 1.0     # sventon_dqn.py:16 / sixten_base.py:11
    tau_learning_rate: float = 0.01   # presets.py:178 (adaptive_epsilon EMA)


def merge_settings(presets: Sequence[str], *overlays: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """parse_settings (tools/utils.py:34-45): expand presets in order, then
    overlay the experiment dict / patches / CLI overrides."""
    out: Dict[str, Any] = {}
    for name in presets:
        if name not in PRESETS:
            raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
        out.update(PRESETS[name])
    for ov in overlays:
        if ov:
            out.update(ov)
    h, w = out.get("game_size", (22, 10))
    out["game_area"] = h * w  # derived key (tools/utils.py:44)
    return out


def resolve(settings: Dict[str, Any], run_id: str = "run") -> FrameworkConfig:
    """Validate the merged dict into typed configs (the env, model, PPO,
    DQN and replay parts of the JAX package's ``resolve``, with its
    defaults)."""
    s = settings
    h, w = s.get("game_size", (22, 10))
    engine = EngineConfig(
        height=h, width=w,
        n_players=s.get("n_players", 2),
        piece_map=tuple((tuple(s.get("pieces", range(7))) * 7)[:7]),
    )
    env = EnvConfig(
        engine=engine,
        time_elapsed_each_action=s.get("time_elapsed_each_action", 400),
        extra_rewards=s.get("extra_rewards", False),
    )
    model = ModelConfig(
        compute_dtype=s.get("compute_dtype", "bfloat16"),
        architecture=s.get("architecture", "silver"),   # network.py:25-32
        n_pieces=7,
        tower_layers=s.get("tower_layers", 5),
        tower_filters=s.get("tower_filters", 64),
        val_layers=s.get("val_layers", 6),
        val_filters=s.get("val_filters", 128),
        val_filter_size=s.get("val_filter_size", 5),
        separate_piece_values=s.get("separate_piece_values", True),
        used_pieces=tuple(sorted(set(s.get("pieces", range(7))))),
    )
    ppo = PPOConfig(
        clipping_parameter=s.get("clipping_parameter", 0.15),
        value_loss=s.get("value_loss", 0.01),
        policy_loss=s.get("policy_loss", 0.9),
        entropy_loss=s.get("entropy_loss", 0.0),
        entropy_floor_loss=s.get("entropy_floor_loss", 0.0),
        entropy_floor_standalone=s.get("entropy_floor_standalone", 0.0),
        rescaled_entropy=s.get("rescaled_entropy", 0.0),
        ppo_epsilon=s.get("ppo_epsilon", 0.0),
        nn_regularizer=s.get("nn_regularizer", 1e-5),
        lr=param_eval(s.get("value_lr", 1e-7)),
        gamma=s.get("gamma", 0.98),
        gae_lambda=s.get("gae_lambda", 0.7),
        single_policy=s.get("single_policy", True),
        n_train_epochs=s.get("n_train_epochs_per_update", 4),
        minibatch_size=s.get("minibatch_size", 64),
        compress_advantages=s.get("compress_advantages", None),
        compress_value_loss=s.get("compress_value_loss", None),
        augment_data=s.get("augment_data", False),
        workers_computes_advantages=s.get(
            "workers_computes_advantages", True),       # presets.py:23
        n_step_value_estimates=s.get("n_step_value_estimates", 1),
        time_to_reference_update=s.get("time_to_reference_update", 1),
        truncate_aggregation=s.get("truncate_aggregation", True),
        sparse_value_estimate_filter=tuple(
            s.get("sparse_value_estimate_filter", ())),
    )
    estimator = EstimatorConfig(
        k_step=s.get("n_step_value_estimates", 5),
        gamma=s.get("gamma", 0.98),
        single_policy=s.get("single_policy", True),
        truncate_aggregation=s.get("truncate_aggregation", True),
        step_filter=tuple(s.get("sparse_value_estimate_filter", ())),
    )
    dqn = DQNConfig(
        lr=param_eval(s.get("value_lr", 1e-4)),
        nn_regularizer=s.get("nn_regularizer", 1e-4),
        n_samples_each_update=s.get("n_samples_each_update", 8192),
        minibatch_size=s.get("minibatch_size", 32),
        n_train_epochs=s.get("n_train_epochs_per_update", 3),
        alpha=s.get("prioritized_replay_alpha", 0.7),
        beta=s.get("prioritized_replay_beta", 0.7),
        optimistic_prios=s.get("optimistic_prios", 0.0),
        time_to_reference_update=s.get("time_to_reference_update", 1),
        estimator=estimator,
    )
    replay = ReplayConfig(
        capacity=min(s.get("experience_replay_size", 2 * 10**5), 2 * 10**6),
        k_step=estimator.k_step,
        height=h,
        sample_mode={"rank": "rank"}.get(
            s.get("experience_replay_sample_mode", "rank"), "proportional"),
    )
    return FrameworkConfig(
        settings=s, env=env, model=model, ppo=ppo, dqn=dqn, replay=replay,
        flavour=s.get("flavour", "ppo"),
        n_envs=s.get("n_envs_per_thread", 30),
        train_distribution=s.get("train_distribution", "pi"),
        eval_distribution=s.get("eval_distribution", "argmax"),
        run_id=run_id,
        epsilon=s.get("epsilon", 0.05),
        action_temperature=s.get("action_temperature", 1.0),
        tau_learning_rate=s.get("tau_learning_rate", 0.01),
    )


CLI_PRESETS = ("default", "sventon", "sventon_ppo", "resblock",
               "experiment_sventon_ppo")


def load(presets: Sequence[str] = CLI_PRESETS,
         overrides: Optional[Dict[str, Any]] = None,
         run_id: str = "run") -> FrameworkConfig:
    return resolve(merge_settings(presets, overrides or {}), run_id=run_id)
