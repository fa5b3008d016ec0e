#!/usr/bin/env python3
"""Where the time of the port's main path goes on the GPU.

    python3 tools/torch_profile_selfplay.py           # self-play ticks
    python3 tools/torch_profile_selfplay.py --train   # PPO minibatch steps

Default: drives the acting loop (make_rollout_fn with TetrisVectorEnv and
the full-width bfloat16 PPONet, weights from a numpy seed; 1024 games, the
main path's width, over 8 ticks) under torch.profiler.  ``--train``: builds
the main path's StandaloneTrainer (r5_learning, 1024 games, minibatch 64, 4
epochs, flax-matched initial weights) and profiles its PPO update over
32 minibatch steps (8 minibatches x 4 epochs) of a batch from one rollout
tick.  Prints the wall time per tick or per step, the device's busy share
(the union of kernel intervals over the window), the kernels per tick or
step, and the kernels that take most device time, grouped by name (and,
for ticks, the engine kernel's share).  The full table goes to
chiprun_out/torch_profile_{selfplay,train}.txt.  Needs a CUDA device and
nvcc (the engine kernel is built on first use).
"""
import argparse
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
GAMES, TICKS, MINIBATCHES = 1024, 8, 8


def profile_ticks():
    from drl_tetris_tpu_torch.algos.rollout import make_rollout_fn
    from drl_tetris_tpu_torch.engine import rng
    from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
    from drl_tetris_tpu_torch.models.convert import seeded_state_dict
    from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet
    from torch.profiler import ProfilerActivity, profile

    env = TetrisVectorEnv(EnvConfig(), GAMES, device="cuda")
    net = PPONet(ModelConfig(), device="cuda").eval()
    net.load_state_dict(seeded_state_dict(net, 3))
    rollout = make_rollout_fn(env, net, TICKS)
    key = rng.prng_key(5, "cuda")
    st = env.reset(1)
    st, _, _ = rollout(st, key)                     # warm-up: cuDNN, allocator
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout(st, key)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return prof, wall_s, TICKS, "tick"


def profile_steps():
    from drl_tetris_tpu_torch import config
    from drl_tetris_tpu_torch.runtime.standalone import (StandaloneConfig,
                                                         StandaloneTrainer)
    from drl_tetris_tpu_torch.utils.metrics import profile_update_steps

    mc = config.load("r5_learning")
    tr = StandaloneTrainer(StandaloneConfig(
        env=mc.env, model=mc.model, ppo=mc.ppo, n_envs=GAMES, seed=7,
        lr_schedule=mc.value_lr), device="cuda")
    prof, wall_s, steps = profile_update_steps(tr, MINIBATCHES)
    return prof, wall_s, steps, "step"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="profile PPO minibatch steps instead of ticks")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    from drl_tetris_tpu_torch.utils.metrics import busy_share, device_kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    prof, wall_s, n, unit = profile_steps() if opts.train \
        else profile_ticks()
    kernels = device_kernels(prof)
    share = busy_share(kernels, wall_s * 1e6) if kernels else 0.0
    table = prof.key_averages().table(sort_by="device_time_total",
                                      row_limit=40)
    what = "train" if opts.train else "selfplay"
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"torch_profile_{what}.txt"), "w") as f:
        f.write(f"{card}\n{n} {unit}s, wall {wall_s:.4f} s\n{table}\n")

    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    total = sum(by_name.values())
    print(f"card: {card}")
    print(f"[profile] {what}, {n} {unit}s: {wall_s / n * 1e3:.3f} ms/{unit} "
          f"wall, device busy {share:.4f} of the window, "
          f"{len(kernels) / n:.1f} kernels/{unit}, {total / n / 1e3:.3f} ms "
          f"kernel time/{unit}")
    if not opts.train:
        engine_us = sum(us for name, us in by_name.items()
                        if "step_kernel" in name)
        print(f"[profile] engine tick kernel (step_kernel): "
              f"{engine_us / n / 1e3:.4f} ms/tick, {engine_us / total:.4f} "
              f"of kernel time, {engine_us / (wall_s * 1e6):.4f} of the "
              f"wall window")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile] {us / n / 1e3:9.4f} ms/{unit} "
              f"{us / total:6.3f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
