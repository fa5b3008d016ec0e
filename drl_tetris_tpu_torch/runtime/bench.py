"""Throughput benchmark of the port: engine env-steps/s and the training
iteration's env-steps/s and MFU, as one JSON line.

Counterpart of the root ``bench.py`` of the JAX package, on the card:

  python -m drl_tetris_tpu_torch bench [--n-envs 4096] [--iters 200]
                                       [--no-train] [--device cuda]

* ``step_env_steps_per_s``: the engine kernel's one-tick entry called once
  a tick, as the NN-in-the-loop rollout calls it (``env.step``), with
  uniform random actions drawn on the device, ``n_envs`` games for
  ``iters`` ticks;
* ``rollout_env_steps_per_s``: the T-tick entry, ``iters`` ticks in one
  launch with the in-kernel random actions;
* ``value``: the larger of the two (the JAX bench takes the best of its
  two engine programs);
* ``train_*``: one ``StandaloneTrainer`` iteration (rollout, GAE, the PPO
  update of 4 epochs) at the committed recipe, 1024 games x 64 ticks,
  minibatch 64, after a warm-up iteration at the same shapes, over 3
  iterations; ``train_peak_*`` the same at minibatch 256.  The FLOPs are
  ``iteration_flops``'s, the MFU (``train_mfu_pct``, a percentage) is
  against the card's published dense bf16 peak;
* ``device_kind`` and ``power_limit_w`` name the card.

A failure raises and the command exits non-zero; nothing is caught into
the JSON.  On the CPU (``--device cpu``) the engine runs its plain
version and the MFU keys are null: no peak is published for it.
"""
from __future__ import annotations

import subprocess
import time

import torch

from drl_tetris_tpu_torch import resolve_device
from drl_tetris_tpu_torch.engine import cuda_tick
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv

# dense bf16 peaks from the vendors' data sheets, by device name
PEAK_BF16_FLOPS = {"H100": 989e12}


def device_peak(device) -> tuple:
    """(name, dense bf16 peak FLOP/s or None) of ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(dev)
    peak = next((v for k, v in PEAK_BF16_FLOPS.items() if k in name), None)
    return name, peak


def power_limit_w(device):
    """The card's power limit in watts from nvidia-smi (None on the
    CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
         "nounits", "-i", str(dev.index or 0)], capture_output=True,
        text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_step(cfg: EnvConfig, n_games: int, n_iters: int, device) -> float:
    """env-steps/s of ``env.step`` (the one-tick entry) once a tick, with
    uniform random actions drawn on the device each tick; after one
    untimed tick."""
    env = TetrisVectorEnv(cfg, n_games, device=device)
    st = env.reset(0)
    gen = torch.Generator(device=env.device).manual_seed(1)

    def tick(st):
        r = torch.randint(0, 4, (n_games,), generator=gen,
                          device=env.device, dtype=torch.int32)
        t = torch.randint(0, cfg.engine.width, (n_games,), generator=gen,
                          device=env.device, dtype=torch.int32)
        return env.step(st, r, t)[0]
    st = tick(st)
    _sync(env.device)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        st = tick(st)
    int(st.rounds_played.sum())     # a value read back: the work is done
    return n_games * n_iters / (time.perf_counter() - t0)


def bench_rollout(cfg: EnvConfig, n_games: int, n_iters: int,
                  device) -> float:
    """env-steps/s of the T-tick entry: ``n_iters`` ticks of ``n_games``
    games in one launch with the in-kernel random actions (block 128),
    after one untimed launch."""
    env = TetrisVectorEnv(cfg, n_games, device=device)
    st = env.reset(0)

    def run(st, seed):
        return cuda_tick.rollout(cfg, st, n_iters, base_key=torch.tensor(
            [seed, seed + 1], dtype=torch.int64), block_games=128)
    st = run(st, 1)
    _sync(env.device)
    t0 = time.perf_counter()
    st = run(st, 2)
    int(st.rounds_played.sum())     # a value read back: the work is done
    return n_games * n_iters / (time.perf_counter() - t0)


def iteration_flops(net, vec, vis, n_envs: int, horizon: int,
                    n_epochs: int) -> dict:
    """FLOPs of one PPO training iteration from the net's conv and matmul
    shapes: torch's flop counter on one minibatch (``vec``, ``vis``: the
    net's inputs for it) gives the forward and the forward + backward per
    sample; the rollout runs a forward per game per tick and one for the
    bootstrap, the update forward + backward over every sample in every
    epoch (the dropped remainder of a minibatch ignored).  Returns
    {"fwd", "fwd_bwd"} per sample and "iteration" in total."""
    from torch.utils.flop_counter import FlopCounterMode
    mb = vec[0].shape[0]
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(vec, vis)
    fwd = fc.get_total_flops() / mb
    with FlopCounterMode(display=False) as fc:
        pi, v = net(vec, vis)
        (pi.sum() + v.sum()).backward()
    fwd_bwd = fc.get_total_flops() / mb
    net.zero_grad(set_to_none=True)
    return {"fwd": fwd, "fwd_bwd": fwd_bwd,
            "iteration": (fwd * n_envs * (horizon + 1)
                          + fwd_bwd * n_envs * horizon * n_epochs)}


def bench_training(n_envs: int = 1024, horizon: int = 64,
                   minibatch: int = 64, iters: int = 3, device=None) -> dict:
    """The training iteration's throughput and MFU: ``StandaloneTrainer``
    at the default config with ``minibatch`` (the committed recipe at 64),
    one warm-up iteration, then ``iters`` timed ones."""
    from drl_tetris_tpu_torch.algos.ppo import PPOConfig
    from drl_tetris_tpu_torch.algos.rollout import policy_inputs
    from drl_tetris_tpu_torch.runtime.standalone import (StandaloneConfig,
                                                         StandaloneTrainer)
    cfg = StandaloneConfig(n_envs=n_envs, horizon=horizon,
                           ppo=PPOConfig(minibatch_size=minibatch))
    tr = StandaloneTrainer(cfg, device=device)
    tr.train_iteration()
    _sync(tr.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        tr.train_iteration()
    _sync(tr.device)
    dt = time.perf_counter() - t0
    n_samples = n_envs * horizon
    out = {"train_env_steps_per_s": n_samples * iters / dt,
           "train_recipe": f"{n_envs}x{horizon} mb{minibatch}"}
    vec, vis = policy_inputs(tr.env.observe(tr.env_state))
    flops = iteration_flops(tr.net, [v[:minibatch] for v in vec],
                            [v[:minibatch] for v in vis], n_envs, horizon,
                            cfg.ppo.n_train_epochs)["iteration"]
    kind, peak = device_peak(tr.device)
    out["train_gflop_per_env_step"] = flops / n_samples / 1e9
    out["train_mfu_pct"] = (None if peak is None
                            else 100 * flops / (dt / iters) / peak)
    out["train_sol_env_steps_per_s"] = (None if peak is None
                                        else peak * n_samples / flops)
    out["device_kind"] = kind
    return out


def run(n_envs: int = 4096, iters: int = 200, train: bool = True,
        device=None) -> dict:
    """The benchmark's JSON object (the module docstring lists its
    keys)."""
    dev = resolve_device(device)
    cfg = EnvConfig()
    step_sps = bench_step(cfg, n_envs, iters, dev)
    roll_sps = bench_rollout(cfg, n_envs, iters, dev)
    out = {"metric": f"env_steps_per_s_{n_envs}_boards",
           "value": max(step_sps, roll_sps), "unit": "env-steps/s",
           "step_env_steps_per_s": step_sps,
           "rollout_env_steps_per_s": roll_sps,
           "n_envs": n_envs, "iters": iters}
    if train:
        out.update(bench_training(1024, 64, 64, device=dev))
        peak = bench_training(1024, 64, 256, device=dev)
        out.update({f"train_peak_{k[len('train_'):]}": v
                    for k, v in peak.items() if k.startswith("train_")})
    out["device_kind"] = device_peak(dev)[0]
    out["power_limit_w"] = power_limit_w(dev)
    return out


def add_arguments(p):
    """The ``bench`` verb's flags on the parser ``p``."""
    p.add_argument("--n-envs", type=int, default=4096)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--no-train", action="store_true",
                   help="only the engine entries, not the training "
                        "iteration")
    p.add_argument("--device", default="cuda",
                   help="torch device ('cpu' runs the plain versions)")
