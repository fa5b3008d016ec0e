#!/usr/bin/env python3
"""Where a self-play tick's time goes on the GPU, for the PyTorch port.

    python3 tools/torch_profile_selfplay.py

Drives the port's acting loop (make_rollout_fn with TetrisVectorEnv and the
full-width bfloat16 PPONet, weights from a numpy seed; 1024 games, the main
path's width, over 8 ticks) under
torch.profiler and prints: the wall time per tick, the device's busy share
(the union of kernel intervals over the window), the engine tick kernel's
time per tick and share, and the kernels that take most device time,
grouped by name.  The full table goes to
chiprun_out/torch_profile_selfplay.txt.  Needs a CUDA device and nvcc (the
engine kernel is built on first use).
"""
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
GAMES, TICKS = 1024, 8


def busy_share(events, wall_us):
    """Union of the device kernels' [start, end) intervals over the wall
    window (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / wall_us


def main():
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2

    from drl_tetris_tpu_torch.algos.rollout import make_rollout_fn
    from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
    from drl_tetris_tpu_torch.models.convert import seeded_state_dict
    from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    env = TetrisVectorEnv(EnvConfig(), GAMES, device="cuda")
    net = PPONet(ModelConfig(), device="cuda").eval()
    net.load_state_dict(seeded_state_dict(net, 3))
    rollout = make_rollout_fn(env, net, TICKS)
    gen = torch.Generator(device="cuda").manual_seed(5)
    st = env.reset(1)
    st, _, _ = rollout(st, gen)                     # warm-up: cuDNN, allocator
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout(st, gen)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    share = busy_share(kernels, wall_s * 1e6) if kernels else 0.0
    table = prof.key_averages().table(sort_by="device_time_total",
                                      row_limit=40)
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "torch_profile_selfplay.txt"), "w") as f:
        f.write(f"{card}\n{GAMES} games x {TICKS} ticks, wall "
                f"{wall_s:.4f} s\n{table}\n")

    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    total = sum(by_name.values())
    print(f"card: {card}")
    print(f"[profile] {GAMES} games x {TICKS} ticks: "
          f"{wall_s / TICKS * 1e3:.3f} ms/tick wall, device busy "
          f"{share:.4f} of the window, {len(kernels) / TICKS:.1f} "
          f"kernels/tick, {total / TICKS / 1e3:.3f} ms kernel "
          f"time/tick")
    engine_us = sum(us for name, us in by_name.items()
                    if "step_kernel" in name)
    print(f"[profile] engine tick kernel (step_kernel): "
          f"{engine_us / TICKS / 1e3:.4f} ms/tick, {engine_us / total:.4f} "
          f"of kernel time, {engine_us / (wall_s * 1e6):.4f} of the wall "
          f"window")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile] {us / TICKS / 1e3:9.4f} ms/tick "
              f"{us / total:6.3f}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
