#!/usr/bin/env python3
"""What IEEE float32 costs against TF32 on the port's main path, on one
NVIDIA GPU.

    python3 tools/torch_tf32_cost.py [--steps 64]

The port runs float32 as IEEE float32 (TF32 off for cuDNN and cuBLAS,
``drl_tetris_tpu_torch.use_ieee_float32``).  This script builds the main
path's StandaloneTrainer (r5_learning, 1024 games x horizon 64, minibatch
64, 4 epochs, the full-width bfloat16 net: its float32 parts are the
keyboard head's convolution and the value head), runs one warm-up
iteration with its update cut to one epoch, then two timed iterations
back to back, TF32 off and then on, and prints train env-steps/s, the
phase split and ms per Adam step of each.  Then it times ``--steps``
minibatch steps of the update alone in turns (off, on, on, off), for the
bfloat16 net and for a ``compute_dtype="float32"`` net, where every
convolution is float32.  Prints the card's name and power limit; the
results also go to chiprun_out/tf32_cost.json.  Needs a CUDA device and
nvcc (the engine kernel is built on first use).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
N_ENVS, HORIZON, SEED = 1024, 64, 7


def set_tf32(on: bool):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def timed_iteration(tr, tf32: bool):
    set_tf32(tf32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_iteration()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ppo = tr.cfg.ppo
    steps = ppo.n_train_epochs * (N_ENVS * HORIZON // ppo.minibatch_size)
    return dict(tf32=tf32, s=secs, sps=N_ENVS * HORIZON / secs,
                phase_ms=dict(tr.phase_ms),
                ms_per_step=tr.phase_ms["update"] / steps)


def steps_in_turns(tr, n_steps: int):
    """ms per minibatch step of ``tr``'s update, one epoch over a batch of
    ``n_steps`` minibatches (rolled out for as many ticks as that takes),
    TF32 off, on, on, off."""
    from drl_tetris_tpu_torch.algos.ppo import (Batch, make_ppo_update,
                                                segment_to_batch)
    from drl_tetris_tpu_torch.algos.rollout import make_rollout_fn
    from drl_tetris_tpu_torch.engine import rng
    ppo = dataclasses.replace(tr.cfg.ppo, n_train_epochs=1)
    rows = n_steps * ppo.minibatch_size
    ticks = -(-rows // tr.cfg.n_envs)
    _, seg, last = make_rollout_fn(tr.env, tr.net, ticks)(tr.env_state,
                                                           tr.generator)
    batch, _ = segment_to_batch(ppo, seg, last)
    batch = Batch(*[a[:rows] for a in batch])
    if batch[0].shape[0] != rows:
        raise AssertionError(f"{batch[0].shape[0]} rows for {n_steps} "
                             f"minibatches of {ppo.minibatch_size}")
    _, update = make_ppo_update(tr.cfg.env.engine, tr.net, ppo)
    key = rng.prng_key(0, tr.device)
    got = {False: [], True: []}
    for tf32 in (False, True, True, False):
        set_tf32(tf32)
        update(tr.state, batch, key)            # warm at this setting
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update(tr.state, batch, key)
        torch.cuda.synchronize()
        got[tf32].append((time.perf_counter() - t0) * 1e3 / n_steps)
    return {("on" if k else "off"): sum(v) / len(v) for k, v in got.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tf32_cost: no CUDA device is available", file=sys.stderr)
        return 2
    from drl_tetris_tpu_torch import config
    from drl_tetris_tpu_torch.algos.ppo import make_ppo_update
    from drl_tetris_tpu_torch.runtime.standalone import (StandaloneConfig,
                                                         StandaloneTrainer)
    card = card_line()
    print(f"card: {card}", flush=True)
    mc = config.load("r5_learning")
    out = {"card": card}
    for dtype in ("bfloat16", "float32"):
        cfg = StandaloneConfig(
            env=mc.env, model=dataclasses.replace(mc.model,
                                                  compute_dtype=dtype),
            ppo=mc.ppo, n_envs=N_ENVS, horizon=HORIZON, seed=SEED,
            lr_schedule=mc.value_lr)
        tr = StandaloneTrainer(cfg, device="cuda")
        if dtype == "bfloat16":
            full = tr.update
            tr.update = make_ppo_update(cfg.env.engine, tr.net,
                                        dataclasses.replace(
                                            cfg.ppo, n_train_epochs=1))[1]
            tr.train_iteration()                # warm-up, one epoch
            tr.update = full
            out["iterations"] = [timed_iteration(tr, False),
                                 timed_iteration(tr, True)]
            for r in out["iterations"]:
                print(f"[tf32 {'on' if r['tf32'] else 'off'}] {card}: "
                      f"{N_ENVS} x {HORIZON} r5_learning bf16 iteration "
                      f"{r['s']:.3f} s = {r['sps']:.1f} train env-steps/s; "
                      f"rollout {r['phase_ms']['rollout']:.1f} ms, update "
                      f"{r['phase_ms']['update']:.1f} ms = "
                      f"{r['ms_per_step']:.3f} ms per Adam step", flush=True)
        turns = steps_in_turns(tr, args.steps)
        out[f"steps_{dtype}"] = turns
        print(f"[tf32 steps] {card}: {dtype} net, {args.steps} minibatch "
              f"steps in turns (off, on, on, off): {turns['off']:.3f} ms per "
              f"step TF32 off, {turns['on']:.3f} ms on "
              f"({turns['off'] / turns['on']:.3f}x)", flush=True)
        del tr
        torch.cuda.empty_cache()
    set_tf32(False)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "tf32_cost.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
