#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline OLD_ENGINE_TICK_CU]

Builds the engine tick kernel (drl_tetris_tpu_torch/csrc/engine_tick.cu)
and the residual layers' epilogue (csrc/net_epilogue.cu) with nvcc, holds
each entry bit for bit against its plain PyTorch version on the card,
drives the port's paths through the entry
points a user calls, and times them:

1. build   nvcc into build/torch_kernels/, the engine kernel and the
   epilogue kernel (seconds; ptxas registers, stack frame and spills per
   kernel);
2. kernel vs plain, every state leaf equal:
   - the T-tick entry with replayed actions (1024 games x 64 ticks),
   - the T-tick entry with in-kernel random actions (block_games 128),
   - the one-tick entry over 64 ticks, with reward and done, each tick
     against the plain tick from the same state (``hold_ticks``, batched
     along the game axis; the T-tick entry is held against the chain's
     last state),
   - both entries at the kernel's limits (height 32, width 25, garbage
     cap 64) from a start state with crowded garbage FIFOs, and at a
     ragged game count (1001 games: the last CUDA block of 4 games holds
     one, so 3 of its warps return early), with replayed actions;
   - the one-tick entry's per-kind instantiation over T_KINDS ticks from
     crowded boards: every game a placement, every game a pose lock, and
     each game its own kind (1024 games), mixed kinds at the limits and
     at the ragged count, dones on every path;
   - the residual layers' epilogue kernel (phase_epilogue,
     csrc/net_epilogue.cu) against its plain version bit for bit at the
     'silver' net's main-path shapes (1024 boards of 24 x 12: 1->64,
     64->64, 76->64 with elu and without, 154->128 with the pool after it)
     and at every other layer the registry builds (truncate_add, tanh,
     float32, no peepholes); the 'silver' PPONet's no-grad forward on the
     NHWC path against its NCHW path on 1024 boards (31 launches a full
     forward, 25 a worker-side one); the kernel's time at each main-path
     shape beside its bytes bound, the plain version's time and F.elu's;
3. the self-play path (the acting loop of training): make_rollout_fn with
   TetrisVectorEnv(EnvConfig(), 1024) and PPONet(ModelConfig()) at full
   width in bfloat16, weights drawn from a numpy seed, horizon 64, the
   sampling noise drawn from a key (the JAX package's categorical).  The
   one-tick entry must launch exactly once per tick and the epilogue
   kernel 31 times a forward (65 forwards); the trajectory is
   replayed through the one-tick entry, every tick held against the plain
   engine, and must agree; the net at float32
   agrees with the CPU on a few boards;
4. the training iteration, the main path: StandaloneTrainer with the
   r5_learning settings (config.load), 1024 games x horizon 64, minibatch
   64, TRAIN_EPOCHS (1) of the recipe's 4 epochs (1,024 Adam steps; a
   cut of this phase alone: at 4 epochs the script took 1,215.6 s on an
   H100 80GB HBM3 at 700 W whose host ran 39 ms an Adam step, at 2
   956.5 s on one at 49 ms; ``bench`` times the whole recipe), the
   full-width bf16
   net from flax-matched initial weights.  One warm-up iteration at the same
   shapes with its update cut to 64 minibatch steps of one epoch (the cut
   that keeps the later phases inside the time limit), then one timed
   iteration: the one-tick entry must launch exactly 64 times in it, every
   stat be
   finite, the parameters move and Adam's lr equal the schedule's value.
   Prints train env-steps/s, the rollout / GAE / update split, ms per Adam
   step, the iteration's FLOPs from the conv shapes (torch's flop counter
   on one minibatch: forward x N x (horizon + 1) + (forward + backward) x
   samples x epochs) and train_mfu, their share of the 989 TFLOP/s bf16
   peak, kernels per minibatch step from a profile of 32 steps; and holds
   the update on 256 samples (4 steps) at float32 on the card against the
   CPU (first-step gradients and loss terms).  Every float32 on the card
   is IEEE float32 (TF32 off, set by the entry points; the script checks
   the flags once the trainer is built), so each check runs at the
   precision ``train`` runs at; then (phase_seed) a seed gives the JAX
   package's run: the trainer of data/seed_fixture.npz (seed 7, the
   full-width net at float32, 64 games x 4 ticks) through
   ``train_iteration`` on the card against JAX's draws in the file (the
   initial params from kinit, the threefry bits of the first tick's
   noise, the 256 actions of the first rollout), and the rollout's
   batched noise draw at 1024 x 64 x 40 timed against step 4's rollout
   phase (under 1%); step 3 counts the acting loop's kernels per tick
   with the noise drawn and given (equal: the draw runs once, before the
   loop);
5. checkpoints, the command line and evaluation (phase_cli):
   - the trained trainer of step 4 (3,602,996 parameters with Adam's
     moments) saved with runtime/checkpoint.save and restored into a fresh
     StandaloneTrainer: the state checksum equal, and validate_recovery on
     the policy's outputs for 64 boards; save and restore ms, bytes;
   - ``python -m drl_tetris_tpu_torch train`` as a subprocess at the
     default stack + r5_learning and the full-width net, 128 games x
     horizon 32, 2 iterations, a checkpoint each, a league round (16 games
     per pair) at iteration 2 that must append to elo_history.jsonl; then
     ``train --resume`` for one more iteration, which must restore step
     8,192 and reach 12,288; neither process may rebuild the kernel;
   - ``eval`` of that run against random, 64 games: the score, draw and
     Elo tables must parse, each seat's games be 64, the TOTAL column
     equal the wins, and wins plus draws equal the games;
   - an in-process round robin at full width (the trained net, argmax,
     against a fresh net sampling pi; 64 games, 32 per match), timed
     after one warm match at the same shapes: the one-tick entry must
     launch exactly once per match tick, and every match tick's state,
     reward and done, as the kernel computed them in the run, must equal
     the plain version's from the same state and actions; match
     env-steps/s;
   - ``train`` with the DQN stack (``default sventon sventon_dqn resblock
     experiment_sventon_dqn``) at 128 games x horizon 64, 2 iterations (an
     update each: 8,192 rows fill the 8,192-sample batch) with a league
     round, then ``train --resume`` for a third (the replay restarts empty
     and refills in that iteration);
   - ``train`` on the PPO stack with league-pool opponents and the
     linear reward shaper (``pool_prob=1.0 pool_every=1 pool_mode=pfsp
     reward_shaper=linear_reshaping reward_shaper_param=0.5``) at 128 x
     32 for 3 iterations: iterations 2 and 3 play the pool, the learner
     first and then second;
   - ``eval`` of the DQN run against the PPO pool run and random, 64
     games per pair, with the same table checks;
   then (phase_demo) the demo agent (data/demo_weights_torch, the JAX
   package's demo in the port's format) on the card against the JAX
   package's own outputs on 16 positions (float32 within 1e-4, bfloat16
   within the log-probability bound of tests/test_torch_nets.py,
   runtime/demo.py), and ``eval`` of the CLI run against it, 64 games,
   through the command line's entry point in this process: one one-tick
   launch per match tick, and every match tick's output equal to the
   plain version's from the same state and actions;
6. SVENton-DQN (phase_dqn): StandaloneDQNTrainer with
   the DQN stack resolved by ``config.presets.load`` (the 'silver' QNet at
   the resblock widths, 3 x 64 and 4 x 64 towers, bf16; pareto sampling;
   k = 37 with the step filter (2, 3), 13 steps; 8,192 samples per update
   in minibatches of 32 over 3 epochs, 768 Adam steps; rank replay of
   2,000,000 rows on the card), 1024 games x horizon 64.  One warm-up
   iteration with its update cut to one epoch, then one timed: exactly 64 one-tick launches, no host sync
   inside the update (torch's sync debug mode set to error around it), the
   replay holding at least 8,192 rows, every stat finite, the parameters
   moved, the reference net equal to the net after the update, the sampled
   rows' priorities rewritten from 2.0.  Prints DQN env-steps/s, the rollout /
   replay add / targets / update split, ms per Adam step, the replay's
   bytes and the targets' FLOPs; and holds one update on 256 samples of
   the replay (8 steps) at float32 on the card against the CPU (sampled
   rows, targets, first-step gradients, new priorities);
7. dual-policy training (phase_dual, phase_dual_dqn): DualPolicyTrainer
   at the default stack and r5_learning (single_policy=False), 256 games
   x horizon 64, minibatch 64, the recipe's 4 epochs (8,192 samples and
   512 Adam steps per policy), a warm-up iteration with its updates cut
   to 64 minibatch
   steps and one timed; DualPolicyDQNTrainer at the DQN stack, 1024 x 64, two
   2,000,000-row replays (32,768 rows per policy per iteration), one
   iteration.  Each: one one-tick launch per tick (both nets act on every
   game), every tick's output equal to the plain version's (the warm-up
   iteration's at 256 games, the DQN iteration's at 1024), the gate's
   decisions equal to what trained and moved, every stat
   finite; dual env-steps/s, phase_ms, ms per Adam step, the replays'
   bytes; one dual batch's PPO update on the card against the CPU at
   float32;
8. the other architectures (phase_architectures): 'vanilla', 'keyboard'
   and 'dreamer' (at the default stack's widths), PPONet and QNet forward
   and first-step gradients on 64 boards on the card against the CPU at
   float32; ``train --set architecture=... single_policy=false`` at 128 x
   32 for each (the three processes at once), then ``eval`` of the three
   and the demo agent (8 games a match), one one-tick launch per match
   tick, each equal to the plain version's;
9. the placement agents: SIXten (phase_sixten) at the preset shapes of
   ``--presets default sventon sventon_dqn experiment_sixten`` (the VNet
   with the 'silver' towers and the 6 x 128 5 x 5 value tower, bf16; 16
   games x horizon 32; 16,384 samples per update, minibatch 128, k 5),
   top-drop iterations until the replay holds an update's samples, one
   timed top-drop iteration with the first update, then one full-space
   iteration on the same replay; Sherlock (phase_sherlock) at ``default
   sventon sherlock``, 16 x 32, one timed iteration in each space after a
   warm one.  Each timed iteration: exactly 32 launches of the per-kind
   instantiation, a finite update that moved the net, every tick equal
   to the plain version's; env-steps/s, phase_ms (masks, forward, tick,
   replay or gae, update), the masks' ms per tick, the replay's bytes.
   Then (phase_placement_eval) ``eval`` of the five kinds (phase_cli's
   PPO run, the SIXten and Sherlock checkpoints of both spaces), 2 games
   per pair, through the command line's entry point in this process: one
   per-kind launch per match tick, each equal to the plain version's.
   phase_cli also runs ``train`` for SIXten (full space, 512 samples per
   update) and Sherlock (top-drop, a league round), and starts its
   processes in three stages of concurrent processes (the first train of
   every run; the two resumes; the two evals);
10. the rest of the JAX package's paths, at the command line's default
   stack (the full-width 'silver' PPONet, bf16), after phase_demo:
   - phase_play: ``play`` of phase_cli's PPO run against its pool run
     through the command line's entry point in this process: one ANSI
     frame per tick with both probe lines, one one-tick launch per tick,
     each tick held against the plain version;
   - phase_process: a tetrikv server, a WorkerRunner and a TrainerRunner
     in this process, PROC_ENVS x PROC_HORIZON segments, a segment then
     an update (PROC_SAMPLES samples, 512 Adam steps) twice, every worker
     tick held against the plain version; a fresh worker recovers the
     persisted state and validates its checksum, a tampered checksum is
     refused; then ``up --workers 2 --updates 2 --chaos`` as processes,
     every role on the card, each worker but the victim one segment
     (unbounded, two workers outrun the trainer and its second update
     trains on all it drained): worker 0 runs until the SIGTERM and must
     persist its state on that signal, and its replacement must reclaim
     the slot and recover that state in its own process (the checksum of
     a forward under deterministic cuDNN); the trainer's seconds per
     update, the workers' env-steps/s and each role's start-up;
   - phase_distributed: ``train --distributed`` (NCCL, world size 1) at
     DIST_ENVS x DIST_HORIZON, one iteration, in this process: every tick
     held against the plain version, the loss finite, the parameters
     moved;
   - phase_bench: ``bench --no-train`` as a subprocess (its JSON keys, both
     engine rates positive) and the package's training bench in this
     process at BENCH_TRAIN (one timed iteration after a warm one);
11. the engine path (the random-policy throughput run): the T-tick entry
   at 4096 boards with in-kernel random actions;
12. times: kernel, plain version and bound of each entry at the shape its
   path gives it (the timed kernel and plain outputs are held equal too),
   the rollout's env-steps/s.  The bound is the larger of the bytes side
   (state read and written once over the memory rate) and the operations
   side (tick_int_ops over a derived int32 rate: SMs x 64 INT32 lanes x
   the SM's maximum clock from nvidia-smi); the per-kind instantiation at
   1024 games with mixed kinds.  With ``--baseline``, an
   earlier engine_tick.cu with the same C interface is built too and
   timed in turns with the current one (new, old, old, new) at the same
   shapes.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(the engine's entries and the epilogue's, each with its launches on the
paths, time, bound and plain version's time), and as the last line ``{"ok": true, "device": {...}}``.  Any failure raises
and the script exits non-zero without that line; so does a machine with
no CUDA device.  A copy of the results goes to chiprun_out/chip_smoke.json.
"""
import argparse
import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate (data sheet)
INT32_LANES_PER_SM = 64            # INT32 lanes per SM per clock (Hopper
                                   # white paper); a derived rate, not a
                                   # published peak
SOURCE = "drl_tetris_tpu_torch/csrc/engine_tick.cu"
REPLACES = "drl_tetris_tpu/engine/pallas_tick.py:262"
N_SLICE, HORIZON = 1024, 64        # training geometry (bench.py:211)
N_ENGINE, T_ENGINE = 4096, 100     # engine throughput boards (bench.py:1)
N_RAGGED, T_EXTRA = 1001, 48       # ragged game count (its last block of 4
                                   # games has 1); ticks of the extra
                                   # comparisons
DEV = "cuda"
TRAIN_EPOCHS = 1                   # [train]'s epochs, the recipe's 4
                                   # cut to keep the script inside its
                                   # limit on a slow host (printed)
WARM_MINIBATCHES = 64              # the PPO warm-up updates' depth (cut)
TRAIN_SEED = 7
# float32 on the card is IEEE float32, the precision every entry point
# sets (drl_tetris_tpu_torch.use_ieee_float32: TF32 off), so the checks
# below run at the precision ``train`` runs at.  A net's float32 outputs
# on the card against the CPU, absolute (the convolutions' summation
# order)
NET_TOL = 1e-4
# the update on the card against the CPU at float32, from seeded weights:
# first-step gradients relative to each leaf's largest |g| (a full-width
# net's float32 sums in another order: measured 2.8e-5; under TF32
# 8.5e-3, which this tolerance rejects), and the last of the 4 steps' loss
# terms relative to the larger of their own size and the loss's scale
# (measured 1.8e-4: 3 Adam steps amplify ulps)
UPDATE_GRAD_TOL = 1e-3
UPDATE_STAT_TOL = 2e-3
CLI_ENVS, CLI_HORIZON = 128, 32     # the CLI's train geometry here
CLI_LEAGUE_GAMES = 16               # league games per pair
CLI_EVAL_GAMES = 64                 # CLI eval games per pair
EVAL_GAMES = 64                     # in-process round robin, per pair
CLI_TIMEOUT = 600                   # seconds for one CLI process
DQN_PRESETS = ("default", "sventon", "sventon_dqn", "resblock",
               "experiment_sventon_dqn")
DQN_SEED = 11
CLI_DQN_HORIZON = 64                # 128 x 64 = 8,192 rows: an update each
DEMO_EVAL_GAMES = 64                # the trained run against the demo
DUAL_ENVS = 256                     # dual PPO: 8,192 samples per policy, as
                                    # many env-steps per Adam step as 1024 x
                                    # 64 single-policy PPO
DUAL_SEED = 17
ARCHS = ("vanilla", "keyboard", "dreamer")
ARCH_BOARDS = 64                    # boards of the card-vs-CPU net checks
ARCH_EVAL_GAMES = 16                # the architectures' eval, per pair
SIXTEN_PRESETS = ("default", "sventon", "sventon_dqn", "experiment_sixten")
SHERLOCK_PRESETS = ("default", "sventon", "sherlock")
WM_ENVS, WM_HORIZON = 16, 32        # both flavours' preset shape
WM_SEED = 19
T_KINDS = 24                        # ticks of each per-kind comparison
WM_EVAL_GAMES = 2                   # the five-kind eval, per pair
PROC_ENVS, PROC_HORIZON = 128, 64   # a process worker's segment
PROC_SAMPLES = 8192                 # samples per process-mode update
PROC_SEED = 23
UP_WORKERS, UP_CHAOS_S = 2, 5       # up: workers, seconds to the chaos stop
DIST_ENVS, DIST_HORIZON = 256, 32   # train --distributed, one iteration
BENCH_TRAIN = (256, 64, 64)         # the in-process training bench
# the DQN update on the card against the CPU, float32, on 256
# samples of the replay (8 steps): targets relative to their largest
# |value|, first-step gradients as the PPO check's, new priorities
# absolute (|q - target| after 8 Adam steps)
DQN_TARGET_TOL = 1e-4
DQN_PRIO_TOL = 2e-3


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def state_bytes(state):
    from drl_tetris_tpu_torch.engine.core import tree_leaves
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(state))


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, n):
    """Mean device time of fn() over n calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def ptxas_report(report):
    """{kernel: {registers, stack, spill_stores, spill_loads}} from
    nvcc -Xptxas -v."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def build_and_report(source, tag, flags=None):
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.utils import nvcc
    flags = cuda_tick.NVCC_FLAGS if flags is None else flags
    t0 = time.perf_counter()
    path, report = nvcc.build(source, flags)
    secs = time.perf_counter() - t0
    log(f"[build{tag}] nvcc {' '.join(flags)} {source} -> "
        f"{path} in {secs:.1f} s")
    regs = ptxas_report(report)
    for name, r in regs.items():
        log(f"[build{tag}] {name}: {r.get('registers')} registers, "
            f"{r.get('stack')} bytes stack frame, {r.get('spill_stores')} "
            f"bytes spill stores, {r.get('spill_loads')} bytes spill loads")
    return path, secs, regs


def phase_build(results, card, baseline=None):
    """Build the kernels, and the baseline engine source when given
    (returns its library)."""
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.models import epilogue
    _, secs, regs = build_and_report(cuda_tick.SOURCE, "")
    if not regs:
        raise AssertionError("no ptxas report for the kernel")
    results.update(build_s=secs, ptxas=regs)
    _, secs, regs = build_and_report(epilogue.SOURCE, " epilogue",
                                     epilogue.NVCC_FLAGS)
    if not regs:
        raise AssertionError("no ptxas report for the epilogue kernel")
    results.update(epilogue_build_s=secs, epilogue_ptxas=regs)
    if baseline:
        path, _, regs = build_and_report(baseline, " baseline")
        results["baseline_ptxas"] = regs
        return cuda_tick.open_library(path)
    return None


def phase_kernel_vs_plain(results, card):
    """Both entries against the plain version on CUDA tensors."""
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.engine.checks import (KIND_MODES,
                                                    compare_entries,
                                                    compare_kinds, crowded,
                                                    max_abs_err,
                                                    replayed_actions)
    from drl_tetris_tpu_torch.engine.core import EngineConfig
    from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
    cfg = EnvConfig()
    start = TetrisVectorEnv(cfg, N_SLICE, device=DEV).reset(11)
    ar, at = replayed_actions(cfg, HORIZON, N_SLICE, 0, DEV)
    errs, events = {}, {}
    errs["rollout_replayed"], errs["step"], n_done, played = \
        compare_entries(cfg, start, ar, at)
    events["default"] = (n_done, played)

    base = torch.tensor([7, 2024], dtype=torch.int64)
    ker = cuda_tick.rollout(cfg, start, HORIZON, base_key=base,
                            block_games=128)
    ref = cuda_tick.rollout_plain(cfg, start, HORIZON, base_key=base,
                                  block_games=128)
    errs["rollout_random"] = max_abs_err(ker, ref)

    # the kernel's limits: every lane holds a row and a second FIFO slot
    lim = EnvConfig(engine=EngineConfig(height=32, width=25, garbage_cap=64))
    start = crowded(lim, TetrisVectorEnv(lim, N_SLICE, device=DEV).reset(12),
                    12)
    ar, at = replayed_actions(lim, T_EXTRA, N_SLICE, 1, DEV)
    errs["rollout_limits"], errs["step_limits"], n_done, played = \
        compare_entries(lim, start, ar, at)
    events["limits"] = (n_done, played)

    # a game count that is not a multiple of the games per CUDA block: the
    # last block's warps past n_games return
    start = TetrisVectorEnv(cfg, N_RAGGED, device=DEV).reset(13)
    ar, at = replayed_actions(cfg, T_EXTRA, N_RAGGED, 2, DEV)
    errs["rollout_ragged"], errs["step_ragged"], n_done, played = \
        compare_entries(cfg, start, ar, at)
    events["ragged"] = (n_done, played)

    # the one-tick entry's per-kind instantiation: every game a placement,
    # every game a pose lock, each game its own kind; then mixed kinds at
    # the limits and at the ragged count; crowded boards, so rounds end
    for tag, c, n, modes in (("", cfg, N_SLICE, KIND_MODES),
                             ("_limits", lim, N_SLICE, ("mixed",)),
                             ("_ragged", cfg, N_RAGGED, ("mixed",))):
        start = crowded(c, TetrisVectorEnv(c, n, device=DEV).reset(14), 14)
        for mode in modes:
            errs[f"kinds_{mode}{tag}"], d = compare_kinds(c, start, T_KINDS,
                                                          mode, 4)
            events[f"kinds_{mode}{tag}"] = (d, d)

    cuda_tick.raise_if_overflowed(start.current_player.device)
    log(f"[kernel vs plain] {card}: max |kernel - plain| over every leaf: "
        f"{errs}; (dones of the one-tick entry, rounds finished by the "
        f"T-tick entry; for the per-kind comparisons of {T_KINDS} ticks "
        f"the dones twice): {events}")
    if any(v != 0.0 for v in errs.values()):
        raise AssertionError(f"kernel disagrees with the plain version: "
                             f"{errs}")
    if any(d == 0 or p == 0 for d, p in events.values()):
        raise AssertionError("a comparison finished no round: it did not "
                             "reach round resets")
    results["errs"] = errs
    results["events"] = events


def phase_epilogue(results, card):
    """The residual layers' epilogue kernel (csrc/net_epilogue.cu) against
    its plain version, bit for bit, at the 'silver' net's main-path shapes
    (1024 boards of 24 x 12) and at every other layer the registry builds;
    the 'silver' PPONet's no-grad forward on the NHWC path against its
    NCHW path (the same call with autograd recording) on 1024 boards, full
    and worker-side; then at each main-path shape the kernel's time, its
    bytes bound, the plain version's time on NCHW tensors (the eager
    chain the blocks ran before) and ``F.elu`` alone (the library's
    yardstick); the kernel reads and writes rows padded to a multiple of
    8 channels, as on the net's path."""
    import torch.nn.functional as F

    from drl_tetris_tpu_torch.models import checks
    from drl_tetris_tpu_torch.models import epilogue as E

    layers = {**checks.MAIN_PATH, **checks.OTHERS}
    max_abs = 0.0
    for name, layer in layers.items():
        boards = checks.BOARDS if name in checks.MAIN_PATH else 64
        r = checks.kernel_vs_plain(layer, boards, DEV)
        sync()
        max_abs = max(max_abs, r["max_abs"])
        log(f"[epilogue] {name} at {boards} boards: bit-exact "
            f"{r['bit_exact']}, max |d| {r['max_abs']}, launches "
            f"{r['launches']}")
        if not (r["bit_exact"] and r["launches"] == 1
                and r["channels_last"]):
            raise AssertionError(f"epilogue {name}: {r}")
    paths = {}
    for full in (True, False):
        r = checks.silver_forward_paths(1024, seed=1, full_network=full,
                                        device=DEV)
        want = 31 if full else 25
        tag = "full" if full else "worker"
        log(f"[epilogue] silver {tag} forward, NHWC vs NCHW path, 1024 "
            f"boards: max |d pi| {r['pi_gap']!r}, max |d v| "
            f"{r['v_gap']!r}, bit-exact {r['bit_exact']}, launches "
            f"{r['launches']} ({want} expected)")
        if r["launches"] != want or r["pi_gap"] > checks.PATH_TOL["pi"] \
                or r["v_gap"] > checks.PATH_TOL["v"]:
            raise AssertionError(f"silver {tag} forward paths: {r}")
        paths[tag] = r
    times = {}
    for name, layer in checks.MAIN_PATH.items():
        c, bias, y = checks.layer_inputs(layer, checks.BOARDS, DEV)
        cn, yn, rows = c.contiguous(), y.contiguous(), checks.pad_rows(y)
        kernel = cuda_ms(lambda: E.epilogue(c, bias, rows, layer.mode,
                                            layer.act, layer.cin), 50)
        plain = cuda_ms(lambda: E.epilogue_plain(cn, bias, yn, layer.mode,
                                                 layer.act), 20)
        elu = cuda_ms(lambda: F.elu(cn), 50)
        bound = checks.layer_bytes(layer) / HBM_BYTES_PER_S * 1e3
        times[name] = {"kernel_ms": kernel, "plain_ms": plain,
                       "elu_ms": elu, "bound_ms": bound,
                       "bytes": checks.layer_bytes(layer)}
        log(f"[epilogue] {card}: {name}: kernel {kernel:.4f} ms, bound "
            f"{bound:.4f} ms ({checks.layer_bytes(layer)} bytes, "
            f"{100 * bound / kernel:.1f}% of it), plain {plain:.4f} ms, "
            f"F.elu alone {elu:.4f} ms")
    results.update(epilogue_paths=paths, epilogue_times=times,
                   epilogue_max_abs_err=max_abs)


def phase_selfplay(results, card):
    """The acting loop of training, through its entry points."""
    from drl_tetris_tpu_torch.algos.rollout import (make_policy_fn,
                                                    make_rollout_fn)
    from drl_tetris_tpu_torch.engine import cuda_tick, rng
    from drl_tetris_tpu_torch.engine.checks import hold_ticks, max_abs_err
    from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
    from drl_tetris_tpu_torch.models import epilogue
    from drl_tetris_tpu_torch.models.convert import seeded_state_dict
    from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet

    cfg = EnvConfig()
    env = TetrisVectorEnv(cfg, N_SLICE, device=DEV)
    net = PPONet(ModelConfig(), device=DEV).eval()
    net.load_state_dict(seeded_state_dict(net, 3))
    rollout = make_rollout_fn(env, net, HORIZON)
    key = rng.prng_key(5, DEV)

    warm = env.reset(1)
    rollout(warm, key)                       # cuDNN autotuning, allocator
    st0 = env.reset(2)
    for k in cuda_tick.LAUNCHES:
        cuda_tick.LAUNCHES[k] = 0
    epilogue.LAUNCHES["epilogue"] = 0
    sync()
    t0 = time.perf_counter()
    st, seg, last = rollout(st0, key)
    sync()
    secs = time.perf_counter() - t0
    launches = dict(cuda_tick.LAUNCHES)
    epilogue_launches = epilogue.LAUNCHES["epilogue"]
    if epilogue_launches != 31 * (HORIZON + 1):
        raise AssertionError(
            f"{epilogue.LAUNCHES['epilogue']} epilogue launches in a "
            f"rollout of {HORIZON + 1} full 'silver' forwards, not 31 each")

    T, N, H = HORIZON, N_SLICE, cfg.engine.height
    shapes = {"occ": (T, N, 2, H), "vec": (T, N, 2, 12), "piece": (T, N),
              "rot": (T, N), "trans": (T, N), "prob": (T, N),
              "v_piece": (T, N), "v_mean": (T, N), "reward": (T, N),
              "done": (T, N), "player": (T, N)}
    for name, shape in shapes.items():
        got = tuple(getattr(seg, name).shape)
        if got != shape:
            raise AssertionError(f"Segment.{name} {got} != {shape}")
    for name in ("prob", "v_piece", "v_mean"):
        x = getattr(seg, name)
        if not torch.isfinite(x).all():
            raise AssertionError(f"Segment.{name} is not finite")
    if not ((seg.prob > 0) & (seg.prob <= 1)).all():
        raise AssertionError("prob outside (0, 1]")
    if tuple(last.shape) != (N,) or not torch.isfinite(last).all():
        raise AssertionError("v_piece_last")
    grew = int((st.rounds_played - st0.rounds_played).sum())
    wins, losses = int((seg.reward == 1).sum()), int((seg.reward == -1).sum())
    if grew <= 0 or wins == 0 or losses == 0:
        raise AssertionError(f"rounds +{grew}, rewards +1 x{wins} -1 "
                             f"x{losses}: the loop did not finish rounds")
    if launches["step"] != HORIZON or launches["rollout"] != 0:
        raise AssertionError(f"launches {launches}: the one-tick entry must "
                             f"carry each of the {HORIZON} env steps")

    # the env side of the trajectory: the chosen actions replayed through
    # the one-tick entry from the same start state, every tick held
    # against the plain engine and the last state against the rollout's
    ticks, ks = [], st0
    for r, t in zip(seg.rot, seg.trans):
        out = cuda_tick.step(cfg, ks, r, t)
        ticks.append(((cfg, ks, r, t), out))
        ks = out[0]
    env_err = max(max_abs_err(st, ks), hold_ticks(ticks)[0])
    if env_err != 0.0:
        raise AssertionError(f"rollout state differs from the plain replay "
                             f"({env_err})")
    # the net: float32 on the card against the CPU, 8 boards
    # where a tick's time goes: the policy (observe, PPONet forward,
    # sample) against the env step (the one-tick entry and its wrapper)
    policy = make_policy_fn(env, net)
    cols = 4 * cfg.engine.width
    noise = rng.gumbel(key, (N, cols))      # a tick's share of the draw
    with torch.no_grad():
        policy_ms = cuda_ms(lambda: policy(st, noise), 20)
    r0, t0_ = seg.rot[0], seg.trans[0]
    env_ms = cuda_ms(lambda: env.step(st, r0, t0_), 50)
    net_err = net_card_vs_cpu(env, st0)
    tick_kernels, given_kernels, draw_kernels, parent_draw = acting_kernels(
        env, net, st0)
    sps = N * T / secs
    results["selfplay_reset_share"] = grew / (N * T)
    log(f"[self-play] {card}: {N} games x {T} ticks in {secs:.3f} s = "
        f"{sps:.0f} env-steps/s ({secs / T * 1e3:.2f} ms/tick: policy "
        f"{policy_ms:.2f} ms, env step {env_ms:.3f} ms); rounds +{grew}, "
        f"rewards +1 x{wins}, -1 x{losses}; one-tick launches "
        f"{launches['step']}; plain replay max err {env_err}; net f32 card "
        f"vs cpu max err {net_err:.2e}")
    log(f"[self-play] {card}: {tick_kernels:.1f} device kernels per acting "
        f"tick ({given_kernels:.1f} with the noise given); the rollout's "
        f"noise draw, once per iteration before the loop, {draw_kernels} "
        f"kernels; the parent drew per tick ({parent_draw} kernels: "
        f"torch.rand and the two logs), so its tick was "
        f"{tick_kernels + parent_draw:.1f}")
    if tick_kernels > given_kernels + 1:
        raise AssertionError(f"{tick_kernels} kernels per acting tick drawing "
                             f"the noise, {given_kernels} given it: the draw "
                             "is not outside the loop")
    for k in cuda_tick.LAUNCHES:             # the timing calls above
        cuda_tick.LAUNCHES[k] = 0
    results.update(selfplay_s=secs, selfplay_sps=sps, policy_ms=policy_ms,
                   env_step_ms=env_ms, step_launches=launches["step"],
                   net_err=net_err, acting_tick_kernels=tick_kernels,
                   noise_draw_kernels=draw_kernels,
                   parent_draw_kernels=parent_draw,
                   selfplay_epilogue_launches=epilogue_launches)


def acting_kernels(env, net, st):
    """(device kernels per tick of the acting loop, the same with the noise
    given, kernels of the rollout's batched noise draw, kernels of the
    parent's per-tick draw): profiles of rollouts of 2 and 6 ticks, whose
    difference over 4 ticks leaves out what runs once (the draw, the
    bootstrap value, the stacking), and of the two draws alone."""
    from torch.profiler import ProfilerActivity, profile

    from drl_tetris_tpu_torch.algos.rollout import make_rollout_fn
    from drl_tetris_tpu_torch.engine import rng
    from drl_tetris_tpu_torch.utils.metrics import device_kernels

    def count(fn):
        fn()                                 # cuDNN, allocator
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        return len(device_kernels(prof))

    key = rng.prng_key(9, DEV)
    n, cols = env.n_games, 4 * env.cfg.engine.width
    short, long_ = (make_rollout_fn(env, net, h) for h in (2, 6))
    per_tick = (count(lambda: long_(st, key)) - count(
        lambda: short(st, key))) / 4
    g = rng.gumbel(rng.split(key, 6), (n, cols))
    given = (count(lambda: long_(st, gumbel=g)) - count(
        lambda: short(st, gumbel=g[:2]))) / 4
    draw = count(lambda: rng.gumbel(rng.split(key, HORIZON), (n, cols)))

    def parent_draw():                       # the parent's gumbel_noise
        u = torch.rand((n, cols), device=DEV)
        return -torch.log(-torch.log(torch.clamp(u, min=1e-38)))
    return per_tick, given, draw, count(parent_draw)


def phase_seed(results, card):
    """A seed gives JAX's run on the card (runtime/seeded.py): the trainer
    of data/seed_fixture.npz (seed 7, the full-width net at float32, 64
    games, horizon 4) through ``train_iteration``, held against JAX's
    draws there: the initial params (first 8 values of every leaf, sums,
    sums of squares within INIT_RTOL), the threefry bits of the first
    tick's noise on the card, and the 256 actions of the first rollout.
    Then the rollout's batched noise draw at the main path's shapes
    (HORIZON keys x N_SLICE games x 40 actions), timed against [train]'s
    rollout phase of the same call: it must stay under 1% of it."""
    from drl_tetris_tpu_torch.engine import cuda_tick, rng
    from drl_tetris_tpu_torch.runtime import seeded

    t0 = time.perf_counter()
    launches_reset()
    errs = seeded.fixture_errors(DEV)
    sync()
    launches = dict(cuda_tick.LAUNCHES)
    tr = errs.pop("trainer")
    seeded.check_fixture(errs)
    if launches["step"] != seeded.TICKS:
        raise AssertionError(f"launches {launches} for {seeded.TICKS} ticks")
    cuda_tick.raise_if_overflowed(tr.env_state.current_player.device)
    keys = rng.split(rng.prng_key(TRAIN_SEED, DEV), HORIZON)
    cols = 4 * tr.cfg.env.engine.width
    draw_ms = cuda_ms(lambda: rng.gumbel(keys, (N_SLICE, cols)), 10)
    rollout_ms = results["train_phase_ms"]["rollout"]
    share = draw_ms / rollout_ms
    secs = time.perf_counter() - t0
    log(f"[seed] {card}: StandaloneTrainer(seed={seeded.SEED}) on the card "
        f"is JAX's run: {errs['exact_leaves']} of {errs['leaves']} leaves' "
        f"first values bit-exact, largest gaps {errs['head']:.2e} (values), "
        f"{errs['sum']:.2e} (sums), {errs['sumsq']:.2e} (sums of squares); "
        f"noise bits {errs['noise_bits']} differ, actions "
        f"{errs['actions']} of {2 * seeded.GAMES * seeded.TICKS} differ; "
        f"{secs:.1f} s")
    log(f"[seed] {card}: the batched noise draw of an iteration "
        f"({HORIZON} x {N_SLICE} x {cols} float32, "
        f"{HORIZON * N_SLICE * cols * 4 / 1e6:.1f} MB) {draw_ms:.3f} ms = "
        f"{100 * share:.3f}% of [train]'s rollout phase {rollout_ms:.1f} ms; "
        f"this host's Adam step {results['train_ms_per_step']:.3f} ms")
    if not share < 0.01:
        raise AssertionError(f"the noise draw takes {100 * share:.2f}% of "
                             "the rollout")
    launches_reset()
    results.update(seed_s=secs, seed_draw_ms=draw_ms, seed_draw_share=share,
                   seed_errs=errs)


def net_card_vs_cpu(env, state):
    from drl_tetris_tpu_torch.algos.rollout import policy_inputs
    from drl_tetris_tpu_torch.models.convert import seeded_state_dict
    from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet
    net = PPONet(ModelConfig(compute_dtype="float32"), device="cpu")
    net.load_state_dict(seeded_state_dict(net, 3))
    obs = env.observe(state)
    vec, vis = policy_inputs(obs)
    vec, vis = [v[:8] for v in vec], [v[:8] for v in vis]
    with torch.no_grad():
        gpi, gv = net.to(DEV)(vec, vis)
        cpi, cv = net.cpu()([v.cpu() for v in vec], [v.cpu() for v in vis])
    err = max((gpi.cpu() - cpi).abs().max().item(),
              (gv.cpu() - cv).abs().max().item())
    if not err < NET_TOL:
        raise AssertionError(f"PPONet float32 card vs CPU: {err}")
    return err


def phase_train(results, card):
    """The main path's training iteration (StandaloneTrainer, r5_learning):
    rollout with the one-tick entry, GAE, the PPO update with Adam."""
    from drl_tetris_tpu_torch import config
    from drl_tetris_tpu_torch.algos.rollout import policy_inputs
    from drl_tetris_tpu_torch.config.parameter import param_eval
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.runtime.bench import (device_peak,
                                                    iteration_flops)
    from drl_tetris_tpu_torch.runtime.standalone import (StandaloneConfig,
                                                         StandaloneTrainer)
    from drl_tetris_tpu_torch.utils.metrics import (busy_share,
                                                    device_kernels,
                                                    profile_update_steps)
    mc = config.load("r5_learning")
    ppo = dataclasses.replace(mc.ppo, n_train_epochs=TRAIN_EPOCHS)
    if TRAIN_EPOCHS != mc.ppo.n_train_epochs:
        log(f"[train] CUT: {TRAIN_EPOCHS} epochs instead of "
            f"{mc.ppo.n_train_epochs}")
    cfg = StandaloneConfig(env=mc.env, model=mc.model, ppo=ppo,
                           n_envs=N_SLICE, horizon=HORIZON, seed=TRAIN_SEED,
                           lr_schedule=mc.value_lr)
    tr = StandaloneTrainer(cfg, device=DEV)
    # the precision every check below holds: IEEE float32, set by the
    # trainer's entry point
    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on after the trainer was built")
    # the warm-up is a whole iteration at the timed shapes (cuDNN,
    # allocator) with its update cut to WARM_MINIBATCHES steps: the depth
    # of this earlier path is cut so that the later slices' phases fit
    full_update = tr.update
    tr.update = warm_update(cfg.env.engine, tr.net, ppo)
    t0 = time.perf_counter()
    tr.train_iteration()
    sync()
    warm_s = time.perf_counter() - t0
    tr.update = full_update
    before = [p.detach().clone() for p in tr.net.parameters()]
    steps_before = tr.total_steps
    for k in cuda_tick.LAUNCHES:
        cuda_tick.LAUNCHES[k] = 0
    sync()
    t0 = time.perf_counter()
    stats = tr.train_iteration()
    sync()
    secs = time.perf_counter() - t0
    launches = dict(cuda_tick.LAUNCHES)
    phase = dict(tr.phase_ms)

    if launches["step"] != HORIZON or launches["rollout"] != 0:
        raise AssertionError(f"launches {launches}: the one-tick entry must "
                             f"carry each of the {HORIZON} env steps")
    bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"stats not finite: {bad}")
    moved = max((p.detach() - b).abs().max().item()
                for p, b in zip(tr.net.parameters(), before))
    if not moved > 0.0:
        raise AssertionError("the update did not change the parameters")
    lr = tr.state.optimizer.param_groups[0]["lr"]
    want = param_eval(cfg.lr_schedule, steps_before)
    if lr != want:
        raise AssertionError(f"Adam lr {lr} != schedule {want}")

    n_samples = N_SLICE * HORIZON
    n_steps = ppo.n_train_epochs * (n_samples // ppo.minibatch_size)
    # analytic FLOPs from the conv shapes, the function bench's
    # train_mfu_pct reads too (train_mfu here is the same as a fraction)
    obs = tr.env.observe(tr.env_state)
    vec, vis = policy_inputs(obs)
    mb = ppo.minibatch_size
    flops = iteration_flops(tr.net, [v[:mb] for v in vec],
                            [v[:mb] for v in vis], N_SLICE, HORIZON,
                            ppo.n_train_epochs)
    fwd, fwd_bwd, iter_flops = (flops["fwd"], flops["fwd_bwd"],
                                flops["iteration"])
    kind, peak = device_peak(DEV)       # bench's dense bf16 peak
    if peak is None:
        raise AssertionError(f"no published bf16 peak for {kind}")
    mfu = iter_flops / secs / peak
    sps = n_samples / secs

    prof, prof_s, prof_steps = profile_update_steps(tr, 8)
    kernels = device_kernels(prof)
    kps = len(kernels) / prof_steps
    busy = busy_share(kernels, prof_s * 1e6)
    cuda_tick.raise_if_overflowed(tr.env_state.current_player.device)
    log(f"[train] {card}: StandaloneTrainer r5_learning, {N_SLICE} games x "
        f"{HORIZON} ticks, minibatch {mb}, {ppo.n_train_epochs} epochs "
        f"({n_steps} Adam steps), bf16 net; warm-up iteration "
        f"({WARM_MINIBATCHES} minibatch steps) {warm_s:.1f} "
        f"s, timed iteration {secs:.3f} s = {sps:.1f} train env-steps/s")
    log(f"[train] {card}: rollout {phase['rollout']:.1f} ms, GAE "
        f"{phase['gae']:.2f} ms, update {phase['update']:.1f} ms = "
        f"{phase['update'] / n_steps:.3f} ms per Adam step; one-tick "
        f"launches {launches['step']}")
    log(f"[train] {card}: {fwd / 1e9:.4f} GFLOP forward and "
        f"{fwd_bwd / 1e9:.4f} GFLOP forward+backward per sample; "
        f"iteration {iter_flops / 1e12:.3f} TFLOP "
        f"({iter_flops / n_samples / 1e9:.3f} GFLOP per env-step); "
        f"train_mfu {mfu:.5f} (a fraction; bench's train_mfu_pct is the "
        f"same in percent) of {peak / 1e12:.0f} TFLOP/s bf16")
    log(f"[train] {card}: profile of {prof_steps} minibatch steps: "
        f"{kps:.1f} kernels per step, {prof_s / prof_steps * 1e3:.3f} ms "
        f"per step under the profiler, device busy {busy:.4f}; lr {lr:.6g}, "
        f"loss {stats['losses/total_loss']:.5f}, entropy "
        f"{stats['entropy/entropy']:.4f}, max |dparam| {moved:.3e}")
    results.update(
        train_s=secs, train_sps=sps, train_warm_s=warm_s,
        train_phase_ms=phase, train_ms_per_step=phase["update"] / n_steps,
        train_steps=n_steps, train_epochs=ppo.n_train_epochs,
        train_launches=launches["step"], train_flops=iter_flops,
        train_fwd_flops=fwd, train_fwd_bwd_flops=fwd_bwd, train_mfu=mfu,
        train_kernels_per_step=kps, train_profile_busy=busy,
        train_stats=stats, train_lr=lr)
    update_card_vs_cpu(results, card, tr.env, tr.env_state, ppo)
    results["_trainer"] = tr                  # phase_cli checkpoints it


def warm_update(engine, net, ppo):
    """A warm-up iteration's PPO update: one epoch over the batch's first
    WARM_MINIBATCHES minibatches, at the timed shapes."""
    from drl_tetris_tpu_torch.algos.ppo import Batch, make_ppo_update
    update = make_ppo_update(engine, net, dataclasses.replace(
        ppo, n_train_epochs=1))[1]
    rows = WARM_MINIBATCHES * ppo.minibatch_size

    def warm(state, batch, key):
        if not isinstance(batch, Batch) or batch.piece.shape[0] < rows:
            raise AssertionError("the warm-up needs a worker-side batch of "
                                 f"at least {rows} rows")
        return update(state, Batch(*[a[:rows] for a in batch]), key)
    return warm


def update_card_vs_cpu(results, card, env, env_state, ppo_cfg):
    """The PPO update on 256 samples (4 minibatch steps) at float32, on the
    card and on the CPU, from weights drawn from a numpy seed and a batch
    of one rollout tick of ``env`` with them."""
    from drl_tetris_tpu_torch.algos import ppo as P
    from drl_tetris_tpu_torch.algos.rollout import make_rollout_fn

    from drl_tetris_tpu_torch.engine import rng

    cfg = dataclasses.replace(ppo_cfg, n_train_epochs=1)
    _, seg, last = make_rollout_fn(env, seeded_f32_net(env, 3), 1)(
        env_state, rng.prng_key(13, env.device))
    batch, _ = P.segment_to_batch(cfg, seg, last)
    grad_err, stat_err = hold_ppo_update(card, "[train]", env.cfg.engine,
                                         cfg, batch, 3)
    results.update(update_grad_err=grad_err, update_stat_err=stat_err)


def seeded_f32_net(env, seed, device=None, cls=None, model=None):
    """A float32 net (PPONet by default, at the main path's widths) for
    ``env``'s board on ``device`` (default the env's), weights drawn from
    a numpy seed."""
    from drl_tetris_tpu_torch.models.convert import seeded_state_dict
    from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet
    e = env.cfg.engine
    net = (cls or PPONet)(model or ModelConfig(compute_dtype="float32"),
                          board=(e.height, e.width),
                          device=device or env.device)
    net.load_state_dict(seeded_state_dict(net, seed))
    return net


def hold_ppo_update(card, tag, engine, cfg, batch, seed):
    """The first 4 minibatch steps of ``cfg``'s update on ``batch``'s first
    rows, at float32 from a numpy-seeded net, on the card and on the CPU:
    first-step gradients and the last step's loss terms.  Raises beyond
    the tolerances; returns (gradient error, loss-term error)."""
    from drl_tetris_tpu_torch.algos import ppo as P
    from drl_tetris_tpu_torch.engine import rng
    from drl_tetris_tpu_torch.models.convert import seeded_state_dict
    from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet

    n = 4 * cfg.minibatch_size
    batch = P.Batch(*[a[:n].cpu() for a in batch])

    def run(dev):
        net = PPONet(ModelConfig(compute_dtype="float32"),
                     board=(engine.height, engine.width), device=dev)
        net.load_state_dict(seeded_state_dict(net, seed))
        key = rng.prng_key(11, dev)
        b = P.Batch(*[a.to(dev) for a in batch])
        grads, _ = P.first_step_gradients(engine, cfg, net, b, key)
        grads = {k: g.cpu() for k, g in grads.items()}
        init_fn, update_fn = P.make_ppo_update(engine, net, cfg)
        _, stats = update_fn(init_fn(), b, key)
        return grads, {k: v.item() for k, v in stats.items()}

    g_card, s_card = run(DEV)
    g_cpu, s_cpu = run("cpu")
    errs = {k: (g_card[k] - ref).abs().max().item()
            / max(ref.abs().max().item(), 1e-30)
            for k, ref in g_cpu.items()}
    worst = sorted(errs, key=errs.get, reverse=True)[:3]
    grad_err = errs[worst[0]]
    # each term's error against the larger of its own size and the loss's
    # scale (its largest term): a term near zero, as the entropy-floor
    # penalty's mean of relu(floor - H) can be, is held absolutely
    scale = max(abs(v) for k, v in s_cpu.items() if k.startswith("losses/"))
    stat_errs = {k: abs(s_card[k] - v) / max(abs(v), scale)
                 for k, v in s_cpu.items() if "saturation" not in k}
    worst_stat = max(stat_errs, key=stat_errs.get)
    stat_err = stat_errs[worst_stat]
    sat_err = max(abs(s_card[k] - v) for k, v in s_cpu.items()
                  if "saturation" in k)
    log(f"{tag} {card}: update card vs cpu, float32, {n} samples, "
        f"{n // cfg.minibatch_size} steps: first-step gradients "
        f"{grad_err:.3e} of each leaf's max (tolerance {UPDATE_GRAD_TOL}; "
        f"worst leaves "
        f"{', '.join(f'{k} {errs[k]:.2e}' for k in worst)}; median "
        f"{sorted(errs.values())[len(errs) // 2]:.2e}), last-step loss "
        f"terms {stat_err:.3e} of max(|term|, loss scale {scale:.3e}) "
        f"({worst_stat}; tolerance {UPDATE_STAT_TOL}), saturations "
        f"{sat_err}")
    if not (grad_err < UPDATE_GRAD_TOL and stat_err < UPDATE_STAT_TOL
            and sat_err <= 1.0 / cfg.minibatch_size):
        raise AssertionError(f"{tag} the update on the card disagrees with "
                             f"the CPU")
    return grad_err, stat_err


def start_cli(args):
    """Start ``python -m drl_tetris_tpu_torch ARGS`` on the card from the
    checkout; returns (process, start time)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "drl_tetris_tpu_torch",
                             *args, "--device", DEV], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=REPO, process_group=0)
    return proc, time.perf_counter()


def finish_cli(started, label):
    """Wait for a ``start_cli`` process (killed past CLI_TIMEOUT); returns
    (stdout, seconds).  Fails on a non-zero exit."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)     # and what it started
        out, err = proc.communicate()
        raise AssertionError(f"CLI {label} ran past {CLI_TIMEOUT} s:\n"
                             f"{out[-6000:]}\n{err[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI {label} exited {proc.returncode}:\n"
                             f"{out[-3000:]}\n{err[-3000:]}")
    return out, secs


def finish_all(started):
    """Wait for several ``start_cli`` processes at once, each in its own
    thread: {label: (stdout, its own seconds)}.  Fails on any non-zero
    exit."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(started)) as ex:
        futures = {k: ex.submit(finish_cli, v, k) for k, v in started.items()}
        return {k: f.result() for k, f in futures.items()}


def eval_here(paths, games):
    """The ``eval`` verb of the command line in this process (its entry
    point, ``cli.main.main``) on the card, with every match tick recorded:
    returns (stdout, match ticks, one-tick launches, seconds, max |kernel
    - plain| over the match ticks, their dones).  Fails unless the
    one-tick entry launched once per match tick and every tick equals the
    plain version's."""
    from drl_tetris_tpu_torch.cli.main import main as cli_main
    from drl_tetris_tpu_torch.engine import cuda_tick
    out = io.StringIO()
    with recorded_kernel_ticks() as ticks_in, \
            contextlib.redirect_stdout(out):
        for k in cuda_tick.LAUNCHES:
            cuda_tick.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        cli_main(["eval", *paths, "--games", str(games), "--device", DEV])
        sync()
        secs = time.perf_counter() - t0
        launches = dict(cuda_tick.LAUNCHES)
    ticks = len(ticks_in)
    n_launched = launches["step"] + launches["step_kinds"]
    if n_launched != ticks or launches["rollout"] != 0 or ticks == 0:
        raise AssertionError(f"eval: launches {launches} for {ticks} match "
                             f"ticks: the one-tick entry must carry each")
    err, dones = held_against_plain(ticks_in, "eval match ticks")
    return out.getvalue(), ticks, n_launched, secs, err, dones


def held_against_plain(ticks_in, label):
    """Each recorded tick of the one-tick entry against ``step_plain`` from
    the same state and actions (``hold_ticks``, engine/checks.py, batched
    along the game axis): returns (max |kernel - plain| over every leaf,
    reward and done, the dones).  Fails unless that is 0.0 and some game
    finished."""
    from drl_tetris_tpu_torch.engine.checks import hold_ticks
    err, dones = hold_ticks(ticks_in)
    if err != 0.0 or dones == 0:
        raise AssertionError(f"{label}: kernel vs plain {err} over "
                             f"{len(ticks_in)} ticks, {dones} dones")
    return err, dones


def check_eval(text, names, games):
    """An eval's tables: every pair played ``games`` (wins + draws), the
    TOTAL column sums the wins, every entrant rated.  Returns ({(a, b):
    wins}, {(a, b): draws}, {name: Elo})."""
    table, _, rest = text.partition("Draws (games undecided at the tick "
                                    "limit):")
    draw_text, _, elo_text = rest.partition("Elo (Bradley-Terry MLE):")
    cells, totals = score_table(table, names)
    ratings = dict(re.findall(r"(\S+)\s+(-?\d+\.\d)", elo_text))
    draws = {(a, b): int(n) for a, b, n in
             re.findall(r"(\S+) vs (\S+): (\d+)", draw_text)}
    for a, b in itertools.combinations(names, 2):
        (w_ab, g_ab), (w_ba, g_ba) = cells[(a, b)], cells[(b, a)]
        if g_ab != games or g_ba != games or \
                w_ab + w_ba + draws.get((a, b), -1) != games:
            raise AssertionError(f"eval output:\n{text}")
    if set(ratings) != set(names) or totals != {
            a: sum(cells[(a, b)][0] for b in names if b != a) for a in names}:
        raise AssertionError(f"eval output:\n{text}")
    return {k: w for k, (w, _) in cells.items()}, draws, ratings


def iteration_sps(stdout):
    """{total steps: env-steps/s} from the train verb's iteration lines."""
    return {int(a.replace(",", "")): float(b.replace(",", ""))
            for a, b in re.findall(r"\[\s*([\d,]+) steps\] ([\d,.]+) sps",
                                   stdout)}


def score_table(text, names):
    """({(a, b): (wins, games)}, {a: TOTAL}) from Scoreboard.score_table's
    text."""
    rows = [r.split() for r in text.strip().splitlines()]
    if rows[0] != names + ["TOTAL"]:
        raise AssertionError(f"score table header {rows[0]}")
    cells, totals = {}, {}
    for row in rows[1:]:
        for b, cell in zip(names, row[1:1 + len(names)]):
            if b != row[0]:
                w, g = cell.split("/")
                cells[(row[0], b)] = (int(w), int(g))
        totals[row[0]] = int(row[1 + len(names)])
    return cells, totals


@contextlib.contextmanager
def recorded_kernel_ticks():
    """Within the block, every call of the one-tick entry's wrapper
    (``cuda_tick.step``: env steps of every kind, from matches, trainers
    and the command line's entry points run here) is recorded as ((cfg,
    state, r, t, kind, y), (state', reward, done)) in the list it
    yields."""
    from drl_tetris_tpu_torch.engine import cuda_tick
    ticks_in = []
    step = cuda_tick.step

    def recording(cfg, state, r, t, kind=None, y=None):
        out = step(cfg, state, r, t, kind, y)
        ticks_in.append(((cfg, state, r, t, kind, y), out))
        return out
    cuda_tick.step = recording
    try:
        yield ticks_in
    finally:
        cuda_tick.step = step


def phase_cli(results, card):
    """Checkpoints, the command line and evaluation on the card: the
    trained full-width trainer's checkpoint round trip; ``train`` (2
    iterations at CLI_ENVS x CLI_HORIZON with a league round), ``train
    --resume`` and ``eval`` as subprocesses; an in-process round robin at
    full width that counts the one-tick launches per match tick."""
    import tempfile

    from drl_tetris_tpu_torch.config.presets import CLI_PRESETS
    from drl_tetris_tpu_torch.algos.rollout import policy_inputs
    from drl_tetris_tpu_torch.engine import cuda_tick, rng
    from drl_tetris_tpu_torch.models.nets import PPONet
    from drl_tetris_tpu_torch.runtime import checkpoint as ckpt
    from drl_tetris_tpu_torch.runtime import evaluate
    from drl_tetris_tpu_torch.runtime.standalone import StandaloneTrainer
    from drl_tetris_tpu_torch.utils.elo import fit_elo

    tr = results.pop("_trainer")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cli-")
    d = tmp.name

    # 1. the full-width trainer's checkpoint, restored into a fresh trainer
    n_params = sum(p.numel() for p in tr.net.parameters())
    state = tr.state_dict()
    expected = ckpt.state_checksum(state)
    sync()
    t0 = time.perf_counter()
    ckpt.save(os.path.join(d, "ckpt"), tr.total_steps, state)
    save_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(d, "ckpt", str(tr.total_steps), ckpt.STATE_FILE)
    n_bytes = os.path.getsize(path)
    fresh = StandaloneTrainer(tr.cfg, device=DEV)
    sync()
    t0 = time.perf_counter()
    ckpt.restore(os.path.join(d, "ckpt"), fresh)
    sync()
    restore_ms = (time.perf_counter() - t0) * 1e3
    if ckpt.state_checksum(fresh.state_dict()) != expected:
        raise AssertionError("the restored trainer's state differs")
    vec, vis = policy_inputs(tr.env.observe(tr.env_state))
    vec, vis = [v[:64] for v in vec], [v[:64] for v in vis]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        def outputs(t):
            with torch.no_grad():
                return list(t.net(vec, vis))
        ckpt.validate_recovery(outputs, fresh, ckpt.state_checksum(
            outputs(tr)))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del fresh
    log(f"[cli] {card}: checkpoint of the r5_learning trainer "
        f"({n_params} parameters and Adam's moments): save {save_ms:.1f} "
        f"ms, restore into a fresh trainer {restore_ms:.1f} ms, "
        f"{n_bytes} bytes on disk; state checksum equal, policy outputs "
        f"on 64 boards bit-identical (validate_recovery)")

    # 2. train and train --resume through the command line
    built = sorted(os.listdir(cuda_tick.BUILD_DIR))
    per_iter = CLI_ENVS * CLI_HORIZON
    run_dir = os.path.join(d, "models", "smoke")
    train = ["train", "--presets", *CLI_PRESETS, "r5_learning",
             "--data-dir", d, "--run-id", "smoke", "--n-envs",
             str(CLI_ENVS), "--horizon", str(CLI_HORIZON), "--seed", "7",
             "--save-every", "1", "--league-every", "2", "--league-games",
             str(CLI_LEAGUE_GAMES)]
    # the first processes of every run at once (one card, 8 cores): the
    # PPO run, the DQN stack, league-pool PPO, SIXten and Sherlock
    dqn_iter = CLI_ENVS * CLI_DQN_HORIZON
    dqn_dir = os.path.join(d, "models", "dqn")
    dqn_train = ["train", "--presets", *DQN_PRESETS, "--data-dir", d,
                 "--run-id", "dqn", "--n-envs", str(CLI_ENVS), "--horizon",
                 str(CLI_DQN_HORIZON), "--seed", "7", "--save-every", "1",
                 "--league-every", "2", "--league-games",
                 str(CLI_LEAGUE_GAMES)]
    pool_dir = os.path.join(d, "models", "pool")
    wm = ["--data-dir", d, "--n-envs", str(WM_ENVS), "--horizon",
          str(WM_HORIZON), "--seed", "7", "--save-every", "1", "--steps",
          str(2 * WM_ENVS * WM_HORIZON)]
    started = {
        "train": start_cli(train + ["--steps", str(2 * per_iter)]),
        "train (dqn)": start_cli(dqn_train + ["--steps", str(2 * dqn_iter)]),
        "train (pool)": start_cli(
            ["train", "--presets", *CLI_PRESETS, "r5_learning", "--data-dir",
             d, "--run-id", "pool", "--n-envs", str(CLI_ENVS), "--horizon",
             str(CLI_HORIZON), "--seed", "7", "--save-every", "1",
             "--steps", str(3 * per_iter), "--set", "pool_prob=1.0",
             "pool_every=1", "pool_mode=pfsp",
             "reward_shaper=linear_reshaping", "reward_shaper_param=0.5"]),
        # the full placement space with an update in each iteration (the
        # sample count cut from 16,384 to 512: phase_sixten runs the
        # preset's)
        "train (sixten)": start_cli(
            ["train", "--presets", *SIXTEN_PRESETS, "--run-id", "sixten",
             *wm, "--set", "sixten_action_space=full",
             "n_samples_each_update=512"]),
        "train (sherlock)": start_cli(
            ["train", "--presets", *SHERLOCK_PRESETS, "--run-id",
             "sherlock", *wm, "--league-every", "2", "--league-games", "2"]),
    }
    outs = finish_all(started)
    out, train_s = outs["train"]
    sps = iteration_sps(out)
    if sorted(sps) != [per_iter, 2 * per_iter]:
        raise AssertionError(f"train printed the iterations {sorted(sps)}")
    elo_path = os.path.join(run_dir, "elo_history.jsonl")
    with open(elo_path) as f:
        elo_lines = [json.loads(x) for x in f]
    if [x["step"] for x in elo_lines] != [2 * per_iter] or \
            set(elo_lines[0]["ratings"]) != {"random", f"step_{2 * per_iter}"}:
        raise AssertionError(f"elo_history.jsonl after train: {elo_lines}")
    started = {"train --resume": start_cli(
        train + ["--steps", str(3 * per_iter), "--resume"]),
        "train --resume (dqn)": start_cli(
            dqn_train + ["--steps", str(3 * dqn_iter), "--resume"])}
    outs.update(finish_all(started))
    out2, resume_s = outs["train --resume"]
    if f"[resume] restored {run_dir} @ step {2 * per_iter:,}" not in out2:
        raise AssertionError(f"train --resume did not restore:\n{out2}")
    if sorted(iteration_sps(out2)) != [3 * per_iter] or \
            ckpt.latest_step(run_dir) != 3 * per_iter:
        raise AssertionError(f"train --resume steps:\n{out2}")
    if sorted(os.listdir(cuda_tick.BUILD_DIR)) != built:
        raise AssertionError("a CLI process rebuilt the kernel")
    cli_sps = sps[2 * per_iter]
    log(f"[cli] {card}: train {CLI_ENVS} x {CLI_HORIZON} (2 iterations, "
        f"league of {CLI_LEAGUE_GAMES} games per pair at iteration 2) in "
        f"{train_s:.1f} s of process wall time (start, 2 iterations, 3 "
        f"saves, the league) = {2 * per_iter / train_s:.1f} env-steps/s; "
        f"the second iteration alone, as the CLI prints it, {cli_sps:.1f} "
        f"train env-steps/s (this geometry; not comparable with the "
        f"{N_SLICE} x {HORIZON} figure); league ratings "
        f"{elo_lines[0]['ratings']}; train --resume @ "
        f"{2 * per_iter} -> {3 * per_iter} steps in {resume_s:.1f} s")

    # 3. eval of the run against random through the command line, and of
    # the DQN run, the pool run and random, at once
    names3 = ["dqn", "pool", "random"]
    started = {"eval": start_cli(["eval", run_dir, "--games",
                                  str(CLI_EVAL_GAMES)]),
               "eval (dqn, pool)": start_cli(
                   ["eval", dqn_dir, pool_dir, "random", "--games",
                    str(CLI_EVAL_GAMES)])}
    outs.update(finish_all(started))
    out3, eval_s = outs["eval"]
    table, _, rest = out3.partition("Draws (games undecided at the tick "
                                    "limit):")
    draw_text, _, elo_text = rest.partition("Elo (Bradley-Terry MLE):")
    cells, totals = score_table(table, ["smoke", "random"])
    ratings = dict(re.findall(r"(\S+)\s+(-?\d+\.\d)", elo_text))
    draws = re.fullmatch(r"smoke vs random: (\d+)", draw_text.strip())
    (w_a, g_a), (w_b, g_b) = cells[("smoke", "random")], \
        cells[("random", "smoke")]
    if set(ratings) != {"smoke", "random"} or draws is None \
            or g_a != CLI_EVAL_GAMES or g_b != CLI_EVAL_GAMES \
            or totals != {"smoke": w_a, "random": w_b} \
            or w_a + w_b + int(draws[1]) != CLI_EVAL_GAMES:
        raise AssertionError(f"eval output:\n{out3}")
    draws = int(draws[1])
    log(f"[cli] {card}: eval {CLI_EVAL_GAMES} games vs random in "
        f"{eval_s:.1f} s: wins {w_a}, losses {w_b}, draws {draws}; Elo "
        f"{ratings}")

    # 3b. the DQN stack through train and train --resume; league-pool PPO
    # with the reward shaper; eval of the three
    out4, dqn_s = outs["train (dqn)"]
    dqn_sps = iteration_sps(out4)
    if sorted(dqn_sps) != [dqn_iter, 2 * dqn_iter] or \
            "[league] step" not in out4:
        raise AssertionError(f"train (dqn) printed:\n{out4}")
    out5, dqn_resume_s = outs["train --resume (dqn)"]
    if f"[resume] restored {dqn_dir} @ step {2 * dqn_iter:,}" not in out5 \
            or ckpt.latest_step(dqn_dir) != 3 * dqn_iter:
        raise AssertionError(f"train --resume (dqn):\n{out5}")
    raw = ckpt.restore_raw(dqn_dir)
    if raw["update_count"] != 3 or "ref_params" not in raw:
        raise AssertionError(f"the DQN run made {raw['update_count']} "
                             f"updates, not 3")
    _, pool_s = outs["train (pool)"]
    with open(os.path.join(d, "summaries", "pool.jsonl")) as f:
        pool_lines = [json.loads(x) for x in f]
    pool_wr = [x.get("pool/opponent_winrate_ema") for x in pool_lines]
    if [x["step"] for x in pool_lines] != [per_iter, 2 * per_iter,
                                           3 * per_iter] \
            or pool_wr[0] is not None or None in pool_wr[1:]:
        raise AssertionError(f"train (pool): win-rate EMAs {pool_wr}")
    if sorted(os.listdir(cuda_tick.BUILD_DIR)) != built:
        raise AssertionError("a CLI process rebuilt the kernel")
    out7, eval3_s = outs["eval (dqn, pool)"]
    table, _, rest = out7.partition("Draws (games undecided at the tick "
                                    "limit):")
    draw_text, _, elo_text = rest.partition("Elo (Bradley-Terry MLE):")
    cells3, totals3 = score_table(table, names3)
    ratings3 = dict(re.findall(r"(\S+)\s+(-?\d+\.\d)", elo_text))
    draws3 = {(a, b): int(n) for a, b, n in
              re.findall(r"(\S+) vs (\S+): (\d+)", draw_text)}
    for a, b in itertools.combinations(names3, 2):
        (w_ab, g_ab), (w_ba, g_ba) = cells3[(a, b)], cells3[(b, a)]
        if g_ab != CLI_EVAL_GAMES or g_ba != CLI_EVAL_GAMES or \
                w_ab + w_ba + draws3.get((a, b), -1) != CLI_EVAL_GAMES:
            raise AssertionError(f"eval (dqn, pool) output:\n{out7}")
    if set(ratings3) != set(names3) or totals3 != {
            a: sum(cells3[(a, b)][0] for b in names3 if b != a)
            for a in names3}:
        raise AssertionError(f"eval (dqn, pool) output:\n{out7}")
    log(f"[cli] {card}: train (dqn stack) {CLI_ENVS} x {CLI_DQN_HORIZON}, "
        f"2 iterations (an update each) and a league round in {dqn_s:.1f} "
        f"s, the second iteration {dqn_sps[2 * dqn_iter]:.1f} DQN "
        f"env-steps/s as the CLI prints it; --resume to "
        f"{3 * dqn_iter} steps (update count 3) in {dqn_resume_s:.1f} s; "
        f"train (pool, pfsp, linear_reshaping 0.5) {CLI_ENVS} x "
        f"{CLI_HORIZON}, 3 iterations in {pool_s:.1f} s, opponent win-rate "
        f"EMAs {pool_wr[1:]}; eval dqn, pool, random ({CLI_EVAL_GAMES} "
        f"games per pair) in {eval3_s:.1f} s: wins {dict(cells3)}, draws "
        f"{draws3}, Elo {ratings3}")
    # 3c. SIXten (full placement space) and Sherlock through train
    wm_iter = WM_ENVS * WM_HORIZON
    wm_log = {}
    for run_id, label in (("sixten", "train (sixten)"),
                          ("sherlock", "train (sherlock)")):
        out_wm, secs = outs[label]
        raw = ckpt.restore_raw(os.path.join(d, "models", run_id))
        if sorted(iteration_sps(out_wm)) != [wm_iter, 2 * wm_iter] or \
                int(raw["update_count"]) != 2:
            raise AssertionError(f"{label}: update count "
                                 f"{raw['update_count']}:\n{out_wm}")
        wm_log[run_id] = (secs, iteration_sps(out_wm)[2 * wm_iter])
    if "[league] step" not in outs["train (sherlock)"][0]:
        raise AssertionError("train (sherlock) played no league round")
    log(f"[cli] {card}: train (sixten, full space, 512 samples per "
        f"update) and train (sherlock, top-drop, a league round) "
        f"{WM_ENVS} x {WM_HORIZON}, 2 iterations each (an update each): "
        + ", ".join(f"{k} {v[0]:.1f} s, the second iteration {v[1]:.1f} "
                    f"env-steps/s as the CLI prints it"
                    for k, v in wm_log.items()))
    results.update(cli_wm=wm_log)
    results.update(cli_dqn_s=dqn_s, cli_dqn_resume_s=dqn_resume_s,
                   cli_dqn_sps=dqn_sps[2 * dqn_iter], cli_pool_s=pool_s,
                   cli_eval3_s=eval3_s, cli_eval3_elo=ratings3)

    # 4. a round robin in process at full width: one launch per match tick
    e = tr.cfg.env.engine
    rnd = PPONet(tr.cfg.model, board=(e.height, e.width), device=DEV)
    rnd.init_flax_(rng.prng_key(0xE10))
    agents = [evaluate.EvalAgent("trained", tr.net.eval()),
              evaluate.EvalAgent("random", rnd.eval(), distribution="pi")]
    # one warm match at the round robin's shapes (cuDNN, allocator)
    evaluate.play_match(tr.cfg.env, tuple(agents),
                        n_games=EVAL_GAMES // 2, seed=2)
    with recorded_kernel_ticks() as ticks_in:
        for k in cuda_tick.LAUNCHES:
            cuda_tick.LAUNCHES[k] = 0
        sync()
        t0 = time.perf_counter()
        board = evaluate.round_robin(tr.cfg.env, agents,
                                     games_per_pair=EVAL_GAMES, seed=3)
        sync()
        rr_s = time.perf_counter() - t0
        launches = dict(cuda_tick.LAUNCHES)
    ticks = len(ticks_in)
    if launches["step"] != ticks or launches["rollout"] != 0 or ticks == 0:
        raise AssertionError(f"launches {launches} for {ticks} match ticks:"
                             f" the one-tick entry must carry each tick")
    games = board.games[("trained", "random")]
    if games != EVAL_GAMES:
        raise AssertionError(f"{games} games of {EVAL_GAMES} recorded")
    match_sps = EVAL_GAMES // 2 * ticks / rr_s
    # what the kernel computed on each match tick against the plain version
    # from the same state and actions
    match_err, match_done = held_against_plain(ticks_in, "match ticks")
    results["errs"]["step_eval"] = match_err
    log(f"[cli] {card}: round robin in process, full width, trained "
        f"(argmax) vs random (pi), {EVAL_GAMES} games, after one warm "
        f"match: {ticks} match ticks in 2 matches of {EVAL_GAMES // 2} "
        f"games, {rr_s:.2f} s = {match_sps:.0f} match env-steps/s; "
        f"max |kernel - plain| over the {ticks} match ticks {match_err} "
        f"({match_done} dones); "
        f"one-tick launches {launches['step']} (one per match tick); "
        f"{board.wins[('trained', 'random')]}-"
        f"{board.wins[('random', 'trained')]}, Elo {fit_elo(board)}")
    results["_cli_tmp"] = tmp                 # phase_demo evaluates "smoke"
    results.update(
        ckpt_save_ms=save_ms, ckpt_restore_ms=restore_ms,
        ckpt_bytes=n_bytes, ckpt_params=n_params, cli_train_s=train_s,
        cli_resume_s=resume_s, cli_train_sps=cli_sps, cli_eval_s=eval_s,
        cli_eval=dict(wins=w_a, losses=w_b, draws=draws, elo=ratings),
        eval_launches=launches["step"], eval_ticks=ticks,
        match_s=rr_s, match_sps=match_sps)


def launches_reset():
    from drl_tetris_tpu_torch.engine import cuda_tick
    for k in cuda_tick.LAUNCHES:
        cuda_tick.LAUNCHES[k] = 0


def process_fw():
    """The CLI's default stack (the full-width 'silver' PPONet, bf16) with
    PROC_SAMPLES samples per update: the process runtime's config."""
    from drl_tetris_tpu_torch.config import presets
    return presets.load(presets.CLI_PRESETS,
                        {"n_samples_each_update": PROC_SAMPLES})


def phase_process(results, card):
    """The process runtime on the card: in this process a tetrikv server,
    a WorkerRunner and a TrainerRunner at the full-width default stack,
    two segments of PROC_ENVS x PROC_HORIZON and two updates; every
    recorded worker tick held against the plain version; persist and
    recover a fresh worker (the checksum validates, a tampered one
    raises).  Then ``up --workers 2 --updates 2 --chaos`` through the
    command line, the roles as processes on the card."""
    import tempfile

    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.runtime.kv import free_port, launch_server
    from drl_tetris_tpu_torch.runtime.runner import (TrainerRunner,
                                                     WorkerRunner)
    from drl_tetris_tpu_torch.runtime.standalone import StandaloneConfig
    from drl_tetris_tpu_torch.runtime.training_state import TrainingState
    fw = process_fw()
    cfg = StandaloneConfig(env=fw.env, model=fw.model, ppo=fw.ppo,
                           n_envs=PROC_ENVS, horizon=PROC_HORIZON,
                           seed=PROC_SEED)
    seg = PROC_ENVS * PROC_HORIZON
    port = free_port()
    server = launch_server(port)
    try:
        worker = WorkerRunner(cfg, TrainingState("proc", port=port), "ppo",
                              fw, device=DEV)
        trainer = TrainerRunner(cfg, TrainingState("proc", role="trainer",
                                                   port=port),
                                min_samples=PROC_SAMPLES, flavour="ppo",
                                fw=fw, device=DEV)
        before = [p.detach().clone() for p in trainer.net.parameters()]
        # a segment, then an update on it, twice: the trainer trains on
        # all it has drained, so two queued segments would make one
        # update.  Each run persists at its end and the second recovers
        # and validates that state first.
        worker_s, updates = 0.0, 0
        with recorded_kernel_ticks() as ticks_in:
            launches_reset()
            for _ in range(2):
                sync()
                t0 = time.perf_counter()
                worker.run(max_steps=seg)
                sync()
                worker_s += time.perf_counter() - t0
                launches = dict(cuda_tick.LAUNCHES)
                updates += trainer.run(max_updates=1)
                if dict(cuda_tick.LAUNCHES) != launches:
                    raise AssertionError("the trainer stepped the env")
        if updates != 2:
            raise AssertionError(f"{updates} updates, not 2")
        if launches["step"] != 2 * PROC_HORIZON or \
                len(ticks_in) != 2 * PROC_HORIZON:
            raise AssertionError(f"launches {launches} for "
                                 f"{len(ticks_in)} worker ticks")
        err, dones = held_against_plain(ticks_in, "worker ticks")
        moved = max((p.detach() - b).abs().max().item()
                    for p, b in zip(trainer.net.parameters(), before))
        if not moved > 0.0:
            raise AssertionError("the process updates did not move the net")
        # each trainer run publishes after its update and at its exit
        if worker.update_weights() != 4:
            raise AssertionError("the worker did not see the weights")
        fresh = WorkerRunner(cfg, TrainingState("proc", role=worker.ts.me,
                                                port=port), "ppo", fw,
                             device=DEV)
        if not fresh.recover():               # validates the checksum
            raise AssertionError("the fresh worker found no state")
        fresh.ts.store_validation(None, "0" * 32)
        try:
            WorkerRunner(cfg, fresh.ts, "ppo", fw, device=DEV).recover()
        except RuntimeError as e:
            if "recovery validation failed" not in str(e):
                raise
        else:
            raise AssertionError("a tampered checksum was accepted")
    finally:
        server.kill()
        server.wait()
    update_s = trainer.update_s
    worker_sps = 2 * seg / worker_s
    log(f"[process] {card}: WorkerRunner + TrainerRunner in this process, "
        f"the default stack (full-width PPONet, bf16), {PROC_ENVS} x "
        f"{PROC_HORIZON} segments: 2 segments in {worker_s:.2f} s = "
        f"{worker_sps:.1f} worker env-steps/s (with the store round "
        f"trips); 2 updates of {PROC_SAMPLES} samples in "
        f"{update_s[0]:.2f} and {update_s[1]:.2f} s; one-tick launches "
        f"{launches['step']}; max |kernel - plain| over the "
        f"{len(ticks_in)} worker ticks {err} ({dones} dones); a fresh "
        f"worker recovered and validated its checksum, a tampered "
        f"checksum raised")

    # up: the store, a trainer and UP_WORKERS workers as processes, each
    # worker but the chaos victim one segment (--steps): unbounded workers
    # outrun the trainer about 40 to 1 here, and a trainer trains on all
    # it drains, so its second update would take up to 64 segments
    # (PERF.md, process mode).  Worker 0 runs until the SIGTERM, so the
    # signal lands mid-run.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_up-") as d:
        out, up_s = finish_cli(start_cli(
            ["up", "--workers", str(UP_WORKERS), "--updates", "2",
             "--steps", str(seg), "--chaos", str(UP_CHAOS_S), "--port",
             str(free_port()), "--run-id", "up", "--data-dir", d,
             "--n-envs", str(PROC_ENVS), "--horizon", str(PROC_HORIZON),
             "--seed", str(PROC_SEED), "--set",
             f"n_samples_each_update={PROC_SAMPLES}"]), "up")
    # up lets worker0 claim its slot before the others start, so it holds
    # worker-0, the first slot its replacement finds free
    slot = "worker-0"
    for want in ("trainer: update 2", "[up] CHAOS: SIGTERM worker0",
                 f"[worker0] claimed slot {slot} ",
                 f"[worker0b] claimed slot {slot} ",
                 f"[worker0b] {slot}: recovered state from store"):
        if want not in out:
            raise AssertionError(f"up printed no {want!r}:\n{out[-6000:]}")
    # worker 0 persisted because of the signal, not at a step limit
    chaos = out.index("[up] CHAOS: SIGTERM worker0")
    if f"[worker0] {slot}: state persisted on a signal" not in out[chaos:]:
        raise AssertionError("worker 0 did not persist on the SIGTERM:\n"
                             f"{out[-6000:]}")
    starts = {name: float(secs) for name, secs in re.findall(
        r"\[(\w+)\] .*\(start-up ([\d.]+) s\)", out)}
    up_updates = [float(x) for x in re.findall(
        r"\[trainer\] trainer: update \d+ .* update_s=([\d.]+)", out)]
    worker_rates = [float(x) for x in re.findall(
        r"\[worker\w*\] worker-\d+: segment pushed .* ([\d.]+) "
        r"env-steps/s", out)]
    log(f"[process] {card}: up --workers {UP_WORKERS} --updates 2 --chaos "
        f"{UP_CHAOS_S} (all roles on the card) in {up_s:.1f} s: start-up "
        f"{starts} s; trainer s per update {up_updates}; worker segments "
        f"{worker_rates} env-steps/s each; worker 0 stopped, the "
        f"replacement reclaimed worker-0 and recovered its state")
    results["errs"]["step_process"] = err
    results.update(process_launches=launches["step"],
                   process_worker_sps=worker_sps, process_update_s=update_s,
                   process_dones=dones, up_s=up_s, up_startup_s=starts,
                   up_update_s=up_updates, up_worker_sps=worker_rates)


def phase_distributed(results, card):
    """``train --distributed`` (world size 1, NCCL) through the command
    line's entry point in this process: one iteration of DIST_ENVS x
    DIST_HORIZON at the default stack and full width, every tick recorded
    and held against the plain version, the loss finite, the parameters
    moved from their initialisation."""
    import tempfile

    from drl_tetris_tpu_torch.cli.main import main as cli_main
    from drl_tetris_tpu_torch.engine import cuda_tick, rng
    from drl_tetris_tpu_torch.models.nets import PPONet
    from drl_tetris_tpu_torch.parallel.mesh import backend_for
    from drl_tetris_tpu_torch.runtime import checkpoint as ckpt
    from torch import distributed as dist
    steps = DIST_ENVS * DIST_HORIZON
    out = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist-") as d, \
            recorded_kernel_ticks() as ticks_in, \
            contextlib.redirect_stdout(out):
        launches_reset()
        t0 = time.perf_counter()
        cli_main(["train", "--distributed", "--device", DEV, "--data-dir",
                  d, "--run-id", "dist", "--n-envs", str(DIST_ENVS),
                  "--horizon", str(DIST_HORIZON), "--steps", str(steps),
                  "--seed", "3"])
        sync()
        secs = time.perf_counter() - t0
        launches = dict(cuda_tick.LAUNCHES)
        raw = ckpt.restore_raw(os.path.join(d, "models", "dist"))
    text = out.getvalue()
    if dist.is_initialized():
        raise AssertionError("train --distributed left its process group")
    if launches["step"] != DIST_HORIZON or len(ticks_in) != DIST_HORIZON:
        raise AssertionError(f"launches {launches} for {len(ticks_in)} "
                             "ticks")
    err, dones = held_against_plain(ticks_in, "distributed ticks")
    loss = re.search(r"total_loss=(\S+)", text)
    sps = iteration_sps(text).get(steps)
    if loss is None or not math.isfinite(float(loss[1])) or sps is None \
            or int(raw["total_steps"]) != steps:
        raise AssertionError(f"train --distributed printed:\n{text}")
    fw = process_fw()
    e = fw.env.engine
    init = PPONet(fw.model, board=(e.height, e.width), device="cpu")
    init.init_flax_(rng.split(rng.prng_key(3))[0])   # --seed 3's kp
    moved = max(float(np.abs(raw["params"][k] - v.numpy()).max())
                for k, v in init.state_dict().items())
    if not moved > 0.0:
        raise AssertionError("train --distributed did not move the net")
    log(f"[distributed] {card}: train --distributed (world size 1, "
        f"{backend_for(DEV)}), "
        f"{DIST_ENVS} x {DIST_HORIZON}, one iteration at full width: "
        f"{sps:.1f} env-steps/s as the CLI prints it, the command "
        f"{secs:.1f} s; loss {float(loss[1]):.5f}, max |dparam| "
        f"{moved:.3e}; one-tick launches {launches['step']}; max |kernel - "
        f"plain| over the {len(ticks_in)} ticks {err} ({dones} dones)")
    results["errs"]["step_distributed"] = err
    results.update(distributed_launches=launches["step"],
                   distributed_sps=sps, distributed_s=secs)


BENCH_KEYS = ("metric", "value", "unit", "step_env_steps_per_s",
              "rollout_env_steps_per_s", "device_kind", "power_limit_w")
TRAIN_BENCH_KEYS = ("train_env_steps_per_s", "train_recipe",
                    "train_mfu_pct", "train_gflop_per_env_step",
                    "train_sol_env_steps_per_s", "device_kind")


def phase_bench(results, card):
    """``bench --no-train`` as a subprocess (its JSON line's keys, both
    engine rates positive), then the package's training bench in this
    process at BENCH_TRAIN (games, horizon, minibatch), one timed
    iteration after a warm one."""
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.runtime import bench
    out, secs = finish_cli(start_cli(["bench", "--no-train"]), "bench")
    line = json.loads(out.strip().splitlines()[-1])
    missing = [k for k in BENCH_KEYS if k not in line]
    if missing or not (line["step_env_steps_per_s"] > 0
                       and line["rollout_env_steps_per_s"] > 0) \
            or line["value"] != max(line["step_env_steps_per_s"],
                                    line["rollout_env_steps_per_s"]):
        raise AssertionError(f"bench printed {line} (missing {missing})")
    n, h, mb = BENCH_TRAIN
    launches_reset()
    train = bench.bench_training(n, h, mb, iters=1, device=DEV)
    launches = dict(cuda_tick.LAUNCHES)
    missing = [k for k in TRAIN_BENCH_KEYS if k not in train]
    if missing or not train["train_env_steps_per_s"] > 0 \
            or launches["step"] != 2 * h:
        raise AssertionError(f"bench_training gave {train}, launches "
                             f"{launches}")
    log(f"[bench] {card}: bench --no-train in {secs:.1f} s: "
        f"{json.dumps(line)}")
    log(f"[bench] {card}: bench_training {n} x {h} mb{mb}, one timed "
        f"iteration after a warm one: {json.dumps(train)}; one-tick "
        f"launches {launches['step']}")
    results.update(bench_line=line, bench_train=train,
                   bench_launches=launches["step"])


def phase_play(results, card):
    """``play`` of two of phase_cli's checkpoints (the PPO run and the
    league-pool run) through the command line's entry point in this
    process: one ANSI frame per tick with both agents' probe lines, one
    one-tick launch per tick, each held against the plain version."""
    from drl_tetris_tpu_torch.cli.main import main as cli_main
    from drl_tetris_tpu_torch.engine import cuda_tick
    d = results["_cli_tmp"].name
    out = io.StringIO()
    with recorded_kernel_ticks() as ticks_in, \
            contextlib.redirect_stdout(out):
        launches_reset()
        t0 = time.perf_counter()
        cli_main(["play", os.path.join(d, "models", "smoke"),
                  os.path.join(d, "models", "pool"), "--device", DEV])
        sync()
        secs = time.perf_counter() - t0
        launches = dict(cuda_tick.LAUNCHES)
    frames = out.getvalue().split("\x1b[2J\x1b[H")[1:]
    probes = [len(re.findall(r" H=-?[\d.]+ v=[+-][\d.]+ [AB]$", f, re.M))
              for f in frames]
    if not frames or len(frames) != len(ticks_in) or set(probes) != {2} \
            or launches["step"] != len(ticks_in):
        raise AssertionError(f"play: {len(frames)} frames, probes "
                             f"{set(probes)}, launches {launches} for "
                             f"{len(ticks_in)} ticks")
    err, dones = held_against_plain(ticks_in, "play ticks")
    log(f"[play] {card}: play smoke vs pool, one game: {len(frames)} ANSI "
        f"frames with both probe lines in {secs:.2f} s "
        f"({len(frames) / secs:.1f} ticks/s); one-tick launches "
        f"{launches['step']}; max |kernel - plain| {err} ({dones} dones)")
    log("[play] last frame:\n" + frames[-1])
    results["errs"]["step_play"] = err
    results.update(play_launches=launches["step"], play_ticks=len(frames),
                   play_s=secs)


def phase_dqn(results, card):
    """SVENton-DQN at the full DQN stack: the pareto rollout with the
    one-tick entry, the 2M-row rank replay on the card, k-step targets
    through the reference net, IS-weighted Q steps with Adam."""
    from torch.utils.flop_counter import FlopCounterMode

    from drl_tetris_tpu_torch.algos import dqn as D
    from drl_tetris_tpu_torch.algos.rollout import policy_inputs
    from drl_tetris_tpu_torch.config.presets import load
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.runtime.standalone import (
        StandaloneDQNConfig, StandaloneDQNTrainer)
    fw = load(DQN_PRESETS)
    cfg = StandaloneDQNConfig(
        env=fw.env, model=fw.model, dqn=fw.dqn, replay=fw.replay,
        n_envs=N_SLICE, horizon=HORIZON,
        train_distribution=fw.train_distribution, epsilon=fw.epsilon,
        action_temperature=fw.action_temperature,
        tau_learning_rate=fw.tau_learning_rate, seed=DQN_SEED)
    tr = StandaloneDQNTrainer(cfg, device=DEV)
    # the warm-up iteration (cuDNN, allocator) runs its update for one
    # epoch at the timed shapes: a cut of this earlier path's depth
    full = tr.update
    tr.update = D.make_dqn_update(cfg.env.engine, tr.net, dataclasses.replace(
        cfg.dqn, n_train_epochs=1), cfg.replay)[1]
    t0 = time.perf_counter()
    tr.train_iteration()
    sync()
    warm_s = time.perf_counter() - t0
    tr.update = full
    before = [p.detach().clone() for p in tr.net.parameters()]
    updates_before = tr.state.update_count
    written = []                              # the update's prio write

    def record(st, idx, new):
        written.append((idx, st.prio[idx].clone()))
        out = update_prios(st, idx, new)
        written[-1] += (st.prio[idx].clone(),)
        return out
    update_prios = D.replay_update_prios
    D.replay_update_prios = record
    update = tr.update

    def update_without_sync(*args, **kwargs):
        # the update reads nothing back to the host: a sync raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            return update(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    tr.update = update_without_sync
    try:
        for k in cuda_tick.LAUNCHES:
            cuda_tick.LAUNCHES[k] = 0
        sync()
        t0 = time.perf_counter()
        stats = tr.train_iteration()
        sync()
        secs = time.perf_counter() - t0
        launches = dict(cuda_tick.LAUNCHES)
    finally:
        D.replay_update_prios = update_prios
        tr.update = update
    phase = dict(tr.phase_ms)

    if launches["step"] != HORIZON or launches["rollout"] != 0:
        raise AssertionError(f"launches {launches}: the one-tick entry must "
                             f"carry each of the {HORIZON} env steps")
    n = cfg.dqn.n_samples_each_update
    if tr.replay.size < n or tr.state.update_count != updates_before + 1 \
            or len(written) != 1:
        raise AssertionError(f"replay {tr.replay.size} rows, update count "
                             f"{tr.state.update_count}: no update ran")
    bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
    if bad or not stats:
        raise AssertionError(f"stats not finite: {bad or stats}")
    moved = max((p.detach() - b).abs().max().item()
                for p, b in zip(tr.net.parameters(), before))
    if not moved > 0.0:
        raise AssertionError("the update did not change the parameters")
    if not all(torch.equal(p, r) for p, r in
               zip(tr.net.parameters(), tr.state.ref_net.parameters())):
        raise AssertionError("the reference net differs from the net after "
                             "the update (time_to_reference_update 1)")
    idx, prio_before, prio_after = written[0]
    was_new = prio_before == 2.0
    rewritten = int((was_new & (prio_after != 2.0)).sum())
    if idx.numel() != n or int(was_new.sum()) == 0 or \
            rewritten < 0.99 * int(was_new.sum()):
        raise AssertionError(f"{int(was_new.sum())} sampled rows at prio "
                             f"2.0, {rewritten} rewritten")

    steps = cfg.dqn.n_train_epochs * (n // cfg.dqn.minibatch_size)
    n_env_steps = N_SLICE * HORIZON
    sps = n_env_steps / secs
    replay_bytes = tr.replay.nbytes()
    # the targets: one reference forward per kept step over the sample
    obs = tr.env.observe(tr.env_state)
    vec, vis = policy_inputs(obs)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        tr.net([v[:64] for v in vec], [v[:64] for v in vis])
    fwd = fc.get_total_flops() / 64
    k_steps = len(cfg.dqn.estimator.steps)
    target_flops = k_steps * n * fwd
    cuda_tick.raise_if_overflowed(tr.env_state.current_player.device)
    log(f"[dqn] {card}: StandaloneDQNTrainer {' '.join(DQN_PRESETS)}, "
        f"{N_SLICE} games x {HORIZON} ticks, {cfg.train_distribution}, "
        f"k {cfg.dqn.estimator.k_step} ({k_steps} steps), {n} samples in "
        f"minibatches of {cfg.dqn.minibatch_size} x "
        f"{cfg.dqn.n_train_epochs} epochs ({steps} Adam steps), "
        f"{cfg.model.compute_dtype} QNet; "
        f"warm-up iteration (one epoch) {warm_s:.1f} s, timed iteration "
        f"{secs:.3f} s = "
        f"{sps:.1f} DQN env-steps/s")
    log(f"[dqn] {card}: rollout {phase['rollout']:.1f} ms, replay add "
        f"{phase['replay_add']:.2f} ms, sample + targets "
        f"{phase['targets']:.1f} ms, update {phase['update']:.1f} ms = "
        f"{phase['update'] / steps:.3f} ms per Adam step, no host sync in "
        f"the update; one-tick launches {launches['step']}; replay "
        f"{tr.replay.size} of "
        f"{cfg.replay.capacity} rows, {replay_bytes} bytes on the card "
        f"({replay_bytes / cfg.replay.capacity:.0f} per row)")
    log(f"[dqn] {card}: targets {k_steps} forwards x {n} samples x "
        f"{fwd / 1e9:.4f} GFLOP = {target_flops / 1e12:.3f} TFLOP; "
        f"{rewritten} of {int(was_new.sum())} sampled rows at prio 2.0 "
        f"rewritten; loss {stats['tot_loss']:.5f}, q {stats['q_val']:.4f}, "
        f"target {stats['q_target']:.4f}, max |dparam| {moved:.3e}")
    results.update(
        dqn_s=secs, dqn_sps=sps, dqn_warm_s=warm_s, dqn_phase_ms=phase,
        dqn_ms_per_step=phase["update"] / steps, dqn_steps=steps,
        dqn_launches=launches["step"], dqn_replay_bytes=replay_bytes,
        dqn_target_flops=target_flops, dqn_fwd_flops=fwd, dqn_stats=stats)
    dqn_update_card_vs_cpu(results, card, tr)


def dqn_update_card_vs_cpu(results, card, tr):
    """One DQN update on 256 samples (8 minibatch steps) at float32, on
    the card and on the CPU, from weights drawn from a numpy
    seed, over a copy of the first rows of ``tr``'s replay and the same
    injected gumbel noise: the sampled rows, their targets, the first-step
    gradients and the new priorities."""
    from drl_tetris_tpu_torch.algos import dqn as D
    from drl_tetris_tpu_torch.algos.replay import ReplayState
    from drl_tetris_tpu_torch.engine import rng
    from drl_tetris_tpu_torch.models.convert import seeded_state_dict
    from drl_tetris_tpu_torch.models.nets import ModelConfig, QNet

    cfg = dataclasses.replace(tr.cfg.dqn, n_samples_each_update=256,
                              n_train_epochs=1)
    rows = 4096
    rcfg = dataclasses.replace(tr.cfg.replay, capacity=rows)
    src = tr.replay
    cpu_replay = ReplayState(
        **{f: getattr(src, f)[:rows].cpu() for f in
           ("occ", "vec", "piece", "rot", "trans", "reward", "done",
            "prio")}, cursor=rows - rcfg.k_step, size=rows - rcfg.k_step)
    engine = tr.env.cfg.engine
    model = ModelConfig(**{**dataclasses.asdict(tr.cfg.model),
                           "compute_dtype": "float32"})
    gumbel = -torch.log(-torch.log(torch.rand(
        rows, generator=torch.Generator().manual_seed(5)).clamp(min=1e-30)))

    def run(dev):
        net = QNet(model, board=(engine.height, engine.width), device=dev)
        net.load_state_dict(seeded_state_dict(net, 3))
        st = ReplayState(**{k: (v.to(dev).clone() if torch.is_tensor(v)
                                else v)
                            for k, v in vars(cpu_replay).items()})
        key = rng.prng_key(21, dev)
        init_fn, update_fn = D.make_dqn_update(engine, net, cfg, rcfg)
        state = init_fn()
        idx, iw, samples, kp = D.sample_for_update(
            engine, cfg, rcfg, state.ref_net, st, key, 0.7, 0.7,
            gumbel.to(dev))
        grads, _, _ = D.first_step_gradients(engine, cfg, net, samples, iw,
                                             kp)
        update_fn(state, st, key, 0.7, 0.7, gumbel.to(dev))
        return (idx.cpu(), samples["target"].cpu(),
                {k: g.cpu() for k, g in grads.items()}, st.prio.cpu())

    c_idx, c_tgt, c_grads, c_prio = run(DEV)
    h_idx, h_tgt, h_grads, h_prio = run("cpu")
    same_rows = bool(torch.equal(c_idx, h_idx))
    tgt_err = ((c_tgt - h_tgt).abs().max()
               / h_tgt.abs().max().clamp(min=1e-30)).item()
    grad_err = max(((c_grads[k] - g).abs().max()
                    / g.abs().max().clamp(min=1e-30)).item()
                   for k, g in h_grads.items())
    prio_err = (c_prio - h_prio).abs().max().item()
    log(f"[dqn] {card}: update card vs cpu, float32, 256 samples "
        f"of {rows} replay rows, 8 steps: sampled rows equal {same_rows}; "
        f"targets {tgt_err:.3e} of the largest (tolerance {DQN_TARGET_TOL}), "
        f"first-step gradients {grad_err:.3e} of each leaf's max "
        f"(tolerance {UPDATE_GRAD_TOL}), new priorities {prio_err:.3e} "
        f"absolute (tolerance {DQN_PRIO_TOL})")
    if not (same_rows and tgt_err < DQN_TARGET_TOL
            and grad_err < UPDATE_GRAD_TOL and prio_err < DQN_PRIO_TOL):
        raise AssertionError("the DQN update on the card disagrees with the "
                             "CPU")
    results.update(dqn_target_err=tgt_err, dqn_grad_err=grad_err,
                   dqn_prio_err=prio_err)


def phase_engine(results, card):
    """The random-policy engine run: one T-tick launch over 4096 boards."""
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
    cfg = EnvConfig()
    env = TetrisVectorEnv(cfg, N_ENGINE, device=DEV)
    st0 = env.reset(4)
    base = torch.tensor([99, 1], dtype=torch.int64)
    for k in cuda_tick.LAUNCHES:
        cuda_tick.LAUNCHES[k] = 0
    st = cuda_tick.rollout(cfg, st0, T_ENGINE, base_key=base,
                           block_games=128)
    sync()
    launches = dict(cuda_tick.LAUNCHES)
    if launches["rollout"] != 1:
        raise AssertionError(f"launches {launches}")
    grew = int((st.rounds_played - st0.rounds_played).sum())
    if grew <= 0:
        raise AssertionError("the engine run finished no round")
    log(f"[engine] {card}: {N_ENGINE} boards x {T_ENGINE} ticks, rounds "
        f"+{grew}, T-tick launches {launches['rollout']}")
    results["rollout_launches"] = launches["rollout"]
    results["engine_reset_share"] = grew / (N_ENGINE * T_ENGINE)


def phase_demo(results, card):
    """The demo agent on the card: its net against the JAX package's own
    outputs (data/demo_weights_torch/demo_outputs.npz) at float32 and
    bfloat16, and ``eval`` of phase_cli's trained run against it through
    the command line's entry point, DEMO_EVAL_GAMES games, one one-tick
    launch per match tick, each held against the plain version."""
    from drl_tetris_tpu_torch.runtime import demo
    tmp = results["_cli_tmp"]            # phase_placement_eval removes it
    errs = demo.fixture_errors(DEV)
    demo.check_fixture(errs)
    names = ["smoke", os.path.basename(demo.DEMO_DIR)]
    out, ticks, launches, secs, tick_max, dones = eval_here(
        [os.path.join(tmp.name, "models", "smoke"), demo.DEMO_DIR],
        DEMO_EVAL_GAMES)
    wins, draws, ratings = check_eval(out, names, DEMO_EVAL_GAMES)
    log(f"[demo] {card}: the demo agent (step 6,029,312) on the card "
        f"against JAX's outputs on 16 positions: float32 pi "
        f"{errs['float32']['pi']:.3e}, v {errs['float32']['v']:.3e} "
        f"(tolerance {demo.F32_TOL}); bfloat16 pi "
        f"{errs['bfloat16']['pi']:.3e}, v {errs['bfloat16']['v']:.3e}, log "
        f"pi {errs['bfloat16']['log_pi']:.3e} (tolerances {demo.BF16_TOL})")
    log(f"[demo] {card}: eval smoke vs the demo, {DEMO_EVAL_GAMES} games, "
        f"in {secs:.1f} s: wins {wins}, draws {draws}, Elo {ratings}; "
        f"{ticks} match ticks, one-tick launches {launches}; max |kernel "
        f"- plain| over the {ticks} match ticks {tick_max} ({dones} dones)")
    results["errs"]["step_demo_eval"] = tick_max
    results.update(demo_errs=errs, demo_eval_ticks=ticks,
                   demo_eval_launches=launches, demo_eval_s=secs,
                   demo_eval_wins={f"{a} vs {b}": w
                                   for (a, b), w in wins.items()})


def moved_and_trained(stats, nets, before):
    """(per policy: trained by the update, max |dparam|) of a dual
    iteration; fails unless exactly the trained policies moved."""
    trained = [any(k.startswith(f"policy_{p}/") for k in stats)
               for p in (0, 1)]
    moved = [max((p.detach() - b).abs().max().item()
                 for p, b in zip(net.parameters(), bs))
             for net, bs in zip(nets, before)]
    if [m > 0.0 for m in moved] != trained or not any(trained):
        raise AssertionError(f"trained {trained}, parameters moved {moved}")
    return trained, moved


def phase_dual(results, card):
    """Dual-policy PPO (single_policy=False) at the CLI's default stack
    and r5_learning: DUAL_ENVS games x HORIZON ticks, minibatch 64,
    the recipe's 4 epochs (8,192 samples per policy).
    Both nets act every tick, one
    one-tick launch per tick; the merge and split with unsigned-gamma GAE;
    a PPO update of each policy the win-rate gate lets train.  One
    warm-up iteration (its updates cut to WARM_MINIBATCHES steps) whose
    ticks are held
    against the plain version, one timed; then one dual batch's update on
    the card against the CPU at float32."""
    from drl_tetris_tpu_torch import config
    from drl_tetris_tpu_torch.algos.dual import (make_dual_rollout_fn,
                                                 split_dual_segment)
    from drl_tetris_tpu_torch.engine import cuda_tick, rng
    from drl_tetris_tpu_torch.runtime.standalone import (DualPolicyConfig,
                                                         DualPolicyTrainer)
    mc = config.load("r5_learning")
    ppo = dataclasses.replace(mc.ppo, single_policy=False)
    cfg = DualPolicyConfig(env=mc.env, model=mc.model, ppo=ppo,
                           n_envs=DUAL_ENVS, horizon=HORIZON, seed=DUAL_SEED)
    tr = DualPolicyTrainer(cfg, device=DEV)
    full = tr.update
    tr.update = warm_update(cfg.env.engine, tr.nets[0], ppo)
    with recorded_kernel_ticks() as ticks_in:
        t0 = time.perf_counter()
        tr.train_iteration()
        sync()
        warm_s = time.perf_counter() - t0
    tick_max, dones = held_against_plain(ticks_in, "dual PPO ticks")
    del ticks_in
    tr.update = full
    before = [[p.detach().clone() for p in n.parameters()] for n in tr.nets]
    for k in cuda_tick.LAUNCHES:
        cuda_tick.LAUNCHES[k] = 0
    sync()
    t0 = time.perf_counter()
    stats = tr.train_iteration()
    sync()
    secs = time.perf_counter() - t0
    launches = dict(cuda_tick.LAUNCHES)
    phase = dict(tr.phase_ms)
    if launches["step"] != HORIZON or launches["rollout"] != 0:
        raise AssertionError(f"dual launches {launches}: the one-tick entry "
                             f"must carry each of the {HORIZON} ticks")
    bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"dual stats not finite: {bad}")
    trained, moved = moved_and_trained(stats, tr.nets, before)
    gate = [tr.winrate.should_train(p) for p in (0, 1)]
    if trained != gate:
        raise AssertionError(f"trained {trained}, the gate says {gate}")
    per_policy = DUAL_ENVS * HORIZON // 2
    steps = ppo.n_train_epochs * (per_policy // ppo.minibatch_size)
    upd_ms = sum(phase.get(f"update_{p}", 0.0) for p in (0, 1))
    ms_step = upd_ms / (steps * sum(trained))
    sps = DUAL_ENVS * HORIZON / secs
    cuda_tick.raise_if_overflowed(tr.env_state.current_player.device)
    log(f"[dual] {card}: DualPolicyTrainer r5_learning single_policy=False, "
        f"{DUAL_ENVS} games x {HORIZON} ticks ({per_policy} samples per "
        f"policy), minibatch {ppo.minibatch_size}, {ppo.n_train_epochs} "
        f"epochs ({steps} Adam steps per policy), bf16 nets; warm-up "
        f"iteration ({WARM_MINIBATCHES} minibatch steps per policy) "
        f"{warm_s:.1f} s, timed iteration "
        f"{secs:.3f} s = {sps:.1f} dual env-steps/s")
    log(f"[dual] {card}: phase_ms "
        f"{ {k: round(v, 2) for k, v in phase.items()} }; "
        f"{ms_step:.3f} ms per Adam step; one-tick launches "
        f"{launches['step']}; gate: win rate of policy 0 "
        f"{tr.winrate.rate_0:.4f}, trained {trained}, max |dparam| "
        f"{[f'{m:.3e}' for m in moved]}; max |kernel - plain| over the "
        f"warm-up's {HORIZON} ticks at {DUAL_ENVS} games {tick_max} "
        f"({dones} dones)")
    results["errs"]["step_dual"] = tick_max
    # one dual batch (2 ticks of both float32 nets on the trainer's games)
    # through the update on the card and on the CPU
    nets = [seeded_f32_net(tr.env, seed) for seed in (3, 4)]
    _, seg, last = make_dual_rollout_fn(tr.env, nets, 2)(
        tr.env_state, rng.prng_key(13, tr.env.device))
    one = dataclasses.replace(ppo, n_train_epochs=1)
    b0, _, _ = split_dual_segment(one, seg, last)
    grad_err, stat_err = hold_ppo_update(card, "[dual]", cfg.env.engine,
                                         one, b0, 3)
    results.update(
        dual_s=secs, dual_sps=sps, dual_warm_s=warm_s, dual_phase_ms=phase,
        dual_ms_per_step=ms_step, dual_launches=launches["step"],
        dual_trained=trained, dual_winrate=float(tr.winrate.rate_0),
        dual_grad_err=grad_err, dual_stat_err=stat_err)


def phase_dual_dqn(results, card):
    """Dual-policy SVENton-DQN at the CLI's DQN stack, N_SLICE games x
    HORIZON ticks: both QNets act with pareto sampling (one one-tick
    launch per tick), the merged transitions of each policy go to its own
    2,000,000-row replay on the card (32,768 rows per policy per
    iteration), and each policy the gate lets train takes an update of
    768 Adam steps.  One timed iteration (phase_dqn warmed the same
    shapes); its ticks are held against the plain version afterwards."""
    from drl_tetris_tpu_torch.config.presets import load
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.runtime.standalone import (
        DualPolicyDQNConfig, DualPolicyDQNTrainer)
    fw = load(DQN_PRESETS)
    cfg = DualPolicyDQNConfig(
        env=fw.env, model=fw.model, dqn=fw.dqn, replay=fw.replay,
        n_envs=N_SLICE, horizon=HORIZON,
        train_distribution=fw.train_distribution, epsilon=fw.epsilon,
        action_temperature=fw.action_temperature,
        tau_learning_rate=fw.tau_learning_rate, seed=DQN_SEED,
        winrate_lr=fw.settings.get("winrate_learningrate", 0.02),
        winrate_tolerance=fw.settings.get("winrate_tolerance", 0.1))
    tr = DualPolicyDQNTrainer(cfg, device=DEV)
    before = [[p.detach().clone() for p in n.parameters()] for n in tr.nets]
    for k in cuda_tick.LAUNCHES:
        cuda_tick.LAUNCHES[k] = 0
    sync()
    with recorded_kernel_ticks() as ticks_in:
        t0 = time.perf_counter()
        stats = tr.train_iteration()
        sync()
        secs = time.perf_counter() - t0
    launches = dict(cuda_tick.LAUNCHES)
    phase = dict(tr.phase_ms)
    tick_max, dones = held_against_plain(ticks_in, "dual DQN ticks")
    del ticks_in
    if launches["step"] != HORIZON or launches["rollout"] != 0:
        raise AssertionError(f"dual DQN launches {launches}: the one-tick "
                             f"entry must carry each of the {HORIZON} ticks")
    rows = N_SLICE * HORIZON // 2
    if [r.size for r in tr.replays] != [rows, rows]:
        raise AssertionError(f"replays hold {[r.size for r in tr.replays]} "
                             f"rows, not {rows} each")
    bad = {k: v for k, v in stats.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"dual DQN stats not finite: {bad}")
    trained, moved = moved_and_trained(stats, tr.nets, before)
    gate = [tr.winrate.should_train(p) for p in (0, 1)]
    if trained != gate:
        raise AssertionError(f"trained {trained}, the gate says {gate}")
    n = cfg.dqn.n_samples_each_update
    steps = cfg.dqn.n_train_epochs * (n // cfg.dqn.minibatch_size)
    upd_ms = sum(phase.get(f"update_{p}", 0.0) for p in (0, 1))
    ms_step = upd_ms / (steps * sum(trained))
    sps = N_SLICE * HORIZON / secs
    replay_bytes = sum(r.nbytes() for r in tr.replays)
    cuda_tick.raise_if_overflowed(tr.env_state.current_player.device)
    log(f"[dual dqn] {card}: DualPolicyDQNTrainer {' '.join(DQN_PRESETS)} "
        f"single_policy=False, {N_SLICE} games x {HORIZON} ticks "
        f"({rows} rows per policy), {cfg.train_distribution}, {n} samples "
        f"per update ({steps} Adam steps per policy); one iteration "
        f"{secs:.3f} s = {sps:.1f} dual DQN env-steps/s")
    log(f"[dual dqn] {card}: phase_ms "
        f"{ {k: round(v, 2) for k, v in phase.items()} }; {ms_step:.3f} ms "
        f"per Adam step; one-tick launches {launches['step']}; replays "
        f"{replay_bytes} bytes on the card; gate: win rate of policy 0 "
        f"{tr.winrate.rate_0:.4f}, trained {trained}, max |dparam| "
        f"{[f'{m:.3e}' for m in moved]}; max |kernel - plain| over the "
        f"{HORIZON} ticks at {N_SLICE} games {tick_max} ({dones} dones)")
    results["errs"]["step_dual_dqn"] = tick_max
    results.update(
        dual_dqn_s=secs, dual_dqn_sps=sps, dual_dqn_phase_ms=phase,
        dual_dqn_ms_per_step=ms_step, dual_dqn_launches=launches["step"],
        dual_dqn_replay_bytes=replay_bytes, dual_dqn_trained=trained,
        dual_dqn_winrate=float(tr.winrate.rate_0))


def phase_architectures(results, card):
    """'vanilla', 'keyboard' and 'dreamer' (dreamer at the default
    stack's widths): PPONet and QNet forward and first-step gradients on
    the card against the CPU at float32 on ARCH_BOARDS boards (the PPO
    loss on a rollout tick's batch; the DQN loss on its rows with seeded
    targets); a dual ``train`` of each through the command line at
    CLI_ENVS x CLI_HORIZON (one iteration, the three processes at once);
    then ``eval`` of the three and the demo agent, one one-tick launch per
    match tick, each held against the plain version."""
    import tempfile

    from drl_tetris_tpu_torch import config
    from drl_tetris_tpu_torch.algos import dqn as D
    from drl_tetris_tpu_torch.algos import ppo as P
    from drl_tetris_tpu_torch.algos.rollout import (make_rollout_fn,
                                                    policy_inputs)
    from drl_tetris_tpu_torch.config.presets import CLI_PRESETS, load
    from drl_tetris_tpu_torch.engine import rng
    from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
    from drl_tetris_tpu_torch.models.nets import PPONet, QNet
    from drl_tetris_tpu_torch.runtime import checkpoint as ckpt
    from drl_tetris_tpu_torch.runtime import demo

    env = TetrisVectorEnv(EnvConfig(), ARCH_BOARDS, device=DEV)
    state = env.reset(23)
    engine = env.cfg.engine
    ppo = dataclasses.replace(config.load("r5_learning").ppo,
                              n_train_epochs=1, minibatch_size=ARCH_BOARDS)
    dqn = dataclasses.replace(load(DQN_PRESETS).dqn, n_train_epochs=1,
                              minibatch_size=ARCH_BOARDS)
    vec, vis = policy_inputs(env.observe(state))
    targets = torch.from_numpy(np.random.RandomState(31).uniform(
        -1, 1, ARCH_BOARDS).astype(np.float32))
    errs = {}
    for arch in ARCHS:
        model = dataclasses.replace(config.load().model, architecture=arch,
                                    compute_dtype="float32")
        for cls in (PPONet, QNet):
            _, seg, last = make_rollout_fn(
                env, seeded_f32_net(env, 5, DEV, cls, model), 1, "argmax")(
                    state)
            batch, _ = P.segment_to_batch(ppo, seg, last)
            rows = {"occ0": seg.occ[0], "vec0": seg.vec[0], "rot": seg.rot[0],
                    "trans": seg.trans[0], "piece": seg.piece[0]}
            outs, grads = {}, {}
            for dev in (DEV, "cpu"):
                net = seeded_f32_net(env, 5, dev, cls, model)
                with torch.no_grad():
                    outs[dev] = [o.cpu() for o in net(
                        [v.to(dev) for v in vec], [v.to(dev) for v in vis])]
                key = rng.prng_key(11, dev)
                if cls is PPONet:
                    g, _ = P.first_step_gradients(
                        engine, ppo, net, P.Batch(*[a.to(dev) for a in batch]),
                        key)
                else:
                    samples = {k: v.to(dev) for k, v in rows.items()}
                    samples["target"] = targets.to(dev)
                    g, _, _ = D.first_step_gradients(
                        engine, dqn, net, samples,
                        torch.ones(ARCH_BOARDS, device=dev), key)
                grads[dev] = {k: v.cpu() for k, v in g.items()}
            fwd = max((a - b).abs().max().item()
                      for a, b in zip(outs[DEV], outs["cpu"]))
            grad = max((grads[DEV][k] - g).abs().max().item()
                       / max(g.abs().max().item(), 1e-30)
                       for k, g in grads["cpu"].items())
            errs[f"{arch} {cls.__name__}"] = (fwd, grad)
    log(f"[arch] {card}: float32 card vs cpu on {ARCH_BOARDS} boards, "
        f"(forward max abs, first-step gradients of each leaf's max): "
        f"{ {k: (f'{a:.2e}', f'{b:.2e}') for k, (a, b) in errs.items()} } "
        f"(tolerances {NET_TOL}, {UPDATE_GRAD_TOL})")
    if not all(a < NET_TOL and b < UPDATE_GRAD_TOL for a, b in errs.values()):
        raise AssertionError(f"an architecture disagrees card vs CPU: {errs}")

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_arch-")
    try:
        per_iter = CLI_ENVS * CLI_HORIZON
        started = {arch: start_cli(
            ["train", "--presets", *CLI_PRESETS, "r5_learning", "--data-dir",
             tmp.name, "--run-id", arch, "--n-envs", str(CLI_ENVS),
             "--horizon", str(CLI_HORIZON), "--seed", "7", "--steps",
             str(per_iter), "--set", f"architecture={arch}",
             "single_policy=false"]) for arch in ARCHS}
        train_s = {}
        for arch, (out, secs) in finish_all(started).items():
            train_s[arch] = secs
            run_dir = os.path.join(tmp.name, "models", arch)
            if sorted(iteration_sps(out)) != [per_iter] or \
                    ckpt.latest_step(run_dir) != per_iter or \
                    ckpt.load_settings(run_dir)["architecture"] != arch:
                raise AssertionError(f"train ({arch}, dual):\n{out}")
        names = list(ARCHS) + [os.path.basename(demo.DEMO_DIR)]
        out, ticks, launches, eval_s, tick_max, dones = eval_here(
            [os.path.join(tmp.name, "models", a) for a in ARCHS]
            + [demo.DEMO_DIR], ARCH_EVAL_GAMES)
        wins, draws, ratings = check_eval(out, names, ARCH_EVAL_GAMES)
    finally:
        tmp.cleanup()
    log(f"[arch] {card}: train --set architecture=... single_policy=false, "
        f"{CLI_ENVS} x {CLI_HORIZON}, one iteration each, three processes "
        f"at once: "
        f"{ {a: round(t, 1) for a, t in train_s.items()} } s; eval of the "
        f"three and the demo, {ARCH_EVAL_GAMES} games per pair, in "
        f"{eval_s:.1f} s: wins {wins}, Elo {ratings}; {ticks} match ticks, "
        f"one-tick launches {launches}; max |kernel - plain| over the "
        f"{ticks} match ticks {tick_max} ({dones} dones)")
    results["errs"]["step_arch_eval"] = tick_max
    results.update(arch_errs=errs, arch_train_s=train_s,
                   arch_eval_ticks=ticks, arch_eval_launches=launches,
                   arch_eval_s=eval_s, arch_elo=ratings)


def placement_iteration(tr, tag, card):
    """One timed iteration of a SIXten or Sherlock trainer with every env
    step recorded: exactly WM_HORIZON launches of the one-tick entry's
    per-kind instantiation, every stat finite, the net moved, every tick
    equal to the plain version's.  Returns (seconds, env-steps/s, stats,
    max |kernel - plain|, dones)."""
    from drl_tetris_tpu_torch.engine import cuda_tick
    before = [p.detach().clone() for p in tr.net.parameters()]
    count = tr.state.update_count
    with recorded_kernel_ticks() as ticks_in:
        for k in cuda_tick.LAUNCHES:
            cuda_tick.LAUNCHES[k] = 0
        sync()
        t0 = time.perf_counter()
        stats = tr.train_iteration()
        sync()
        secs = time.perf_counter() - t0
        launches = dict(cuda_tick.LAUNCHES)
    if launches != {"step": 0, "step_kinds": WM_HORIZON, "rollout": 0}:
        raise AssertionError(f"{tag}: launches {launches}: the per-kind "
                             f"entry must carry each of {WM_HORIZON} ticks")
    if tr.state.update_count != count + 1 or not stats or not all(
            math.isfinite(float(v)) for v in stats.values()):
        raise AssertionError(f"{tag}: no finite update: {stats}")
    moved = max((p.detach() - b).abs().max().item()
                for p, b in zip(tr.net.parameters(), before))
    if not moved > 0:
        raise AssertionError(f"{tag}: the update moved nothing")
    err, dones = held_against_plain(ticks_in, f"{tag} ticks")
    cuda_tick.raise_if_overflowed(torch.device(DEV))
    return secs, WM_ENVS * WM_HORIZON / secs, stats, err, dones


def wm_checkpoint(d, run_id, tr, cfg, space_key, space):
    """Save a trainer as the command line does (state.pt beside its
    settings), so that ``eval`` loads it with its kind."""
    from drl_tetris_tpu_torch.runtime import checkpoint as ckpt
    path = os.path.join(d, run_id)
    ckpt.save(path, tr.total_steps, tr.state_dict(),
              settings=dict(cfg.settings, **{space_key: space}))
    return path


def phase_sixten(results, card):
    """SIXten at the preset shapes (the VNet with the 'silver' towers and
    the 6 x 128 5 x 5 value tower, bf16; 16 games x horizon 32; 16,384
    samples per update in minibatches of 128; k 5): top-drop iterations
    until the replay holds an update's samples, then one timed iteration
    with the first update; then one full-space iteration from the same
    replay, its games' boards crowded again so that rounds end within the
    iteration (the cut: the full space does not fill its own replay).
    Every tick of both timed iterations is held against the plain
    version."""
    from drl_tetris_tpu_torch.config import presets
    from drl_tetris_tpu_torch.engine.checks import crowded
    from drl_tetris_tpu_torch.runtime.standalone import (
        StandaloneSIXtenConfig, StandaloneSIXtenTrainer)
    cfg = presets.load(SIXTEN_PRESETS)

    def trainer(space):
        return StandaloneSIXtenTrainer(StandaloneSIXtenConfig(
            env=cfg.env, model=cfg.model, replay=cfg.replay, n_envs=WM_ENVS,
            horizon=WM_HORIZON, train_distribution=cfg.train_distribution,
            seed=WM_SEED, epsilon=cfg.epsilon,
            action_temperature=cfg.action_temperature,
            tau_learning_rate=cfg.tau_learning_rate, action_space=space),
            sixten_cfg=cfg.sixten, device=DEV)
    n = cfg.sixten.n_samples_each_update
    per_iter = WM_ENVS * WM_HORIZON
    top = trainer("top_drop")
    top.env_state = crowded(cfg.env, top.env_state, WM_SEED)
    sync()
    t0 = time.perf_counter()
    warm = 0
    while top.replay.size + per_iter < n:
        top.train_iteration()
        warm += 1
    sync()
    warm_s = time.perf_counter() - t0
    out = {}
    out["top_drop"] = placement_iteration(top, "sixten top-drop", card)
    phases = {"top_drop": dict(top.phase_ms)}
    full = trainer("full")
    full.replay, full.total_steps = top.replay, top.total_steps
    full.env_state = crowded(cfg.env, top.env_state, WM_SEED + 2)
    out["full"] = placement_iteration(full, "sixten full", card)
    phases["full"] = dict(full.phase_ms)
    for space, (secs, sps, stats, err, dones) in out.items():
        ph = phases[space]
        log(f"[sixten] {card}: {space}, {WM_ENVS} games x {WM_HORIZON} "
            f"ticks and an update of {n} samples ({n // cfg.sixten.minibatch_size} "
            f"Adam steps) in {secs:.2f} s = {sps:.1f} env-steps/s; "
            f"phase_ms {ph}; masks {ph['masks'] / WM_HORIZON:.2f} ms per "
            f"tick; max |kernel - plain| over the {WM_HORIZON} ticks {err} "
            f"({dones} dones); stats {stats}")
        results["errs"][f"kinds_sixten_{space}"] = err
    log(f"[sixten] {card}: {warm} top-drop iterations before the first "
        f"update in {warm_s:.1f} s; the replay {cfg.replay.capacity} "
        f"rows, {top.replay.nbytes()} bytes on the card")
    import tempfile
    results["_wm_tmp"] = tempfile.TemporaryDirectory(prefix="chip_smoke_wm-")
    d = results["_wm_tmp"].name
    results["_wm_ckpts"] = [
        wm_checkpoint(d, "sixten", top, cfg, "sixten_action_space",
                      "top_drop"),
        wm_checkpoint(d, "sixten_full", full, cfg, "sixten_action_space",
                      "full")]
    results.update(sixten_warm_iters=warm, sixten_warm_s=warm_s,
                   sixten_replay_bytes=top.replay.nbytes(),
                   sixten={k: dict(s=v[0], sps=v[1], phase_ms=phases[k])
                           for k, v in out.items()},
                   sixten_launches=2 * WM_HORIZON)


def phase_sherlock(results, card):
    """Sherlock at the preset shapes (SherlockNet: the 'silver' trunk and
    the phi head, bf16 trunk; 16 games x horizon 32, minibatch 32, 3
    epochs): a warm top-drop iteration, then one timed iteration in each
    space (from crowded boards, so that rounds end within it); every tick
    held against the plain version."""
    from drl_tetris_tpu_torch.config import presets
    from drl_tetris_tpu_torch.engine.checks import crowded
    from drl_tetris_tpu_torch.runtime.standalone import (
        SherlockTrainerConfig, StandaloneSherlockTrainer)
    cfg = presets.load(SHERLOCK_PRESETS)

    def trainer(space):
        return StandaloneSherlockTrainer(SherlockTrainerConfig(
            env=cfg.env, model=cfg.model, n_envs=WM_ENVS,
            horizon=WM_HORIZON, seed=WM_SEED, action_space=space),
            sherlock_cfg=cfg.sherlock, device=DEV)
    top = trainer("top_drop")
    top.env_state = crowded(cfg.env, top.env_state, WM_SEED + 1)
    top.train_iteration()
    out = {"top_drop": placement_iteration(top, "sherlock top-drop", card)}
    phases = {"top_drop": dict(top.phase_ms)}
    full = trainer("full")
    full.env_state = crowded(cfg.env, top.env_state, WM_SEED + 3)
    out["full"] = placement_iteration(full, "sherlock full", card)
    phases["full"] = dict(full.phase_ms)
    b = WM_ENVS * WM_HORIZON
    steps = cfg.sherlock.n_train_epochs * (b // cfg.sherlock.minibatch_size)
    for space, (secs, sps, stats, err, dones) in out.items():
        ph = phases[space]
        log(f"[sherlock] {card}: {space}, {WM_ENVS} games x {WM_HORIZON} "
            f"ticks and an update ({steps} Adam steps) in {secs:.2f} s = "
            f"{sps:.1f} env-steps/s; phase_ms {ph}; masks "
            f"{ph['masks'] / WM_HORIZON:.2f} ms per tick; max |kernel - "
            f"plain| over the {WM_HORIZON} ticks {err} ({dones} dones); "
            f"stats {stats}")
        results["errs"][f"kinds_sherlock_{space}"] = err
    d = results["_wm_tmp"].name
    results["_wm_ckpts"] += [
        wm_checkpoint(d, "sherlock", top, cfg, "sherlock_action_space",
                      "top_drop"),
        wm_checkpoint(d, "sherlock_full", full, cfg,
                      "sherlock_action_space", "full")]
    results.update(sherlock={k: dict(s=v[0], sps=v[1], phase_ms=phases[k])
                             for k, v in out.items()},
                   sherlock_launches=2 * WM_HORIZON)


def phase_placement_eval(results, card):
    """``eval`` of the five kinds through the command line's entry point in
    this process: the PPO run of phase_cli (macro) and the SIXten and
    Sherlock checkpoints of both spaces, WM_EVAL_GAMES games per pair,
    argmax.  Every match tick is one launch of the one-tick entry (the
    per-kind instantiation: no pairing is macro against macro) and equals
    the plain version's."""
    names = ["smoke", "sixten", "sixten_full", "sherlock", "sherlock_full"]
    tmps = [results.pop("_cli_tmp"), results.pop("_wm_tmp")]
    try:
        smoke = os.path.join(tmps[0].name, "models", "smoke")
        out, ticks, launches, secs, err, dones = eval_here(
            [smoke] + results.pop("_wm_ckpts"), WM_EVAL_GAMES)
    finally:
        for tmp in tmps:
            tmp.cleanup()
    wins, draws, elo = check_eval(out, names, WM_EVAL_GAMES)
    results["errs"]["kinds_eval"] = err
    log(f"[placement eval] {card}: five kinds, {WM_EVAL_GAMES} games per "
        f"pair: {ticks} match ticks in {secs:.1f} s = "
        f"{ticks / secs:.2f} match ticks/s (one game a match); one-tick "
        f"launches {launches}; max |kernel - plain| {err} ({dones} dones); "
        f"wins {wins}, draws {draws}, Elo {elo}")
    results.update(wm_eval_launches=launches, wm_eval_ticks=ticks,
                   wm_eval_s=secs)


THREEFRY_OPS = 79   # threefry2x32: key word 2 + 2 adds + 20 x (add, rotate,
                    # xor) + 5 x 3 key injections (a rotate is one SHF)


def tick_int_ops(cfg, reset_share, action_draw, kind="macro"):
    """32-bit integer and logic operations of one game-tick on the common
    path (the acting player's make phase of ``kind``: "macro", "place",
    "pose" or "mixed", a third of each; both players' finish phase),
    counted term by term from the tick's code; loops that stop early are
    counted at the trip count of a typical tick, low rather than high.
    Float32 operations (bag weights, payout) are a few dozen and run on
    the FP32 units; they are not counted."""
    e = cfg.engine
    H, W, CAP = e.height, e.width, e.garbage_cap
    draw = 2 * THREEFRY_OPS + 3          # uniform01(fold_in(key, counter))
    ext = 2 * H                          # (occ << 4) | walls, per row
    probe = 4 * 4                        # 4 piece rows x (index, shift, and, test)
    macro = (ext
             + 1.5 * (8 + 3 * 8 + probe)  # rotations: mean r of 1.5, lookup,
                                          # range checks, the first kick
             + (W + 2) * (probe + 3)      # left and right slides: ~W+2 probes
             + ext + 4 * (H // 2) * 3     # hard drop: 4 rows scan ~H/2 rows
             + 4 * 5 + 4)                 # add the piece
    make = {"macro": macro,
            # placement: the rotations, one slide towards the target
            "place": macro - (W + 2) * (probe + 3) / 2 + 6,
            # pose lock: lookup, range checks, one probe, the hard drop
            "pose": ext + 8 + 4 * 4 + probe + ext + 4 * (H // 2) * 3
            + 4 * 5 + 4}
    make["mixed"] = (make["macro"] + make["place"] + make["pose"]) / 3
    macro = make[kind]
    finish = (6 * H                       # clear_lines: full test, move
              + 6                         # send_lines
              + 8 + draw + 4 + ext + probe  # new piece: copy, draw, spawn test
              + 40                        # delay check, FIFO front, combo
              + 5)                        # reward, snapshot, counts
    tick = (2 * THREEFRY_OPS              # the env key's split2
            + macro + 2 * finish + 15)    # both players; reward and flip
    reset = (2 * THREEFRY_OPS + 2 * draw  # fold_in pair, >= 2 piece draws
             + 2 * (2 * H + 2 * CAP + 25))  # restart both players
    ops = tick + reset_share * reset
    if action_draw:                      # fold_in, fold_in, random_bits
        ops += 3 * THREEFRY_OPS + 4
    return ops


def int32_ops_per_s():
    """Derived int32 rate: SMs x INT32 lanes per SM x the SM's maximum
    clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6, sms, mhz


def in_turns(fns, n):
    """Mean time of each fn over two turns, in the order a, b, b, a."""
    order = list(range(len(fns))) + list(range(len(fns)))[::-1]
    got = [[] for _ in fns]
    for i in order:
        got[i].append(cuda_ms(fns[i], n))
    return [sum(g) / len(g) for g in got]


def phase_times(results, card, baseline=None):
    """Kernel, plain and bound times of both entries at their paths'
    shapes; with a baseline library, its times in turns with the
    kernel's."""
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.engine.checks import (crowded, kind_actions,
                                                    max_abs_err)
    from drl_tetris_tpu_torch.env.env import (EnvConfig, TetrisVectorEnv,
                                              step_plain)
    cfg = EnvConfig()
    libs = [cuda_tick.load()] + ([baseline] if baseline else [])
    stream = torch.cuda.current_stream().cuda_stream
    int_rate, sms, mhz = int32_ops_per_s()

    # one-tick entry, N = 1024: kernel alone on fixed buffers; the timed
    # launches' outputs are held against the timed plain call's
    env = TetrisVectorEnv(cfg, N_SLICE, device=DEV)
    st = env.reset(6)
    rs = np.random.RandomState(1)
    r = torch.from_numpy(rs.randint(0, 4, N_SLICE).astype(np.int32)).to(DEV)
    t = torch.from_numpy(rs.randint(0, cfg.engine.width, N_SLICE).astype(
        np.int32)).to(DEV)
    args, keep, (outs, k_rew, k_done) = cuda_tick.step_args(cfg, st, r, t)
    launches = [lambda lib=lib: cuda_tick.check(
        lib.engine_tick_step(*args, stream), "engine_tick_step")
        for lib in libs]
    for f in launches:
        cuda_ms(f, 5)
    step_times = in_turns(launches, 200)
    launches[0]()                        # the kernel's outputs last
    wrap_ms = cuda_ms(lambda: cuda_tick.step(cfg, st, r, t), 200)
    plain = {}
    step_plain(cfg, st, r, t)
    step_plain_ms = cuda_ms(
        lambda: plain.update(out=step_plain(cfg, st, r, t)), 10)
    p_st, p_rew, p_done = plain["out"]
    step_err = max(max_abs_err(cuda_tick.unflatten(outs), p_st),
                   (k_rew - p_rew).abs().max().item(),
                   float((k_done != p_done).sum().item()))
    step_bytes = 2 * state_bytes(st) + 2 * 4 * N_SLICE + 5 * N_SLICE
    step_ops = N_SLICE * tick_int_ops(cfg, results["selfplay_reset_share"],
                                      False)
    del keep

    # the one-tick entry's per-kind instantiation, N = 1024, from crowded
    # boards: every game a placement, every game a pose lock, each game its
    # own kind (a third each; the kernels line's figure)
    kst = crowded(cfg, env.reset(9), 9)
    kinds_t = {}
    for mode in ("place", "pose", "mixed"):
        kind, kr, kt, ky = kind_actions(cfg, kst, mode,
                                        np.random.RandomState(2))
        args, keep, (outs, k_rew, k_done) = cuda_tick.step_args(
            cfg, kst, kr, kt, kind, ky)
        launch = (lambda: cuda_tick.check(
            libs[0].engine_tick_step(*args, stream), "engine_tick_step"))
        cuda_ms(launch, 5)
        ms = cuda_ms(launch, 200)
        step_plain(cfg, kst, kr, kt, kind, ky)
        p_ms = cuda_ms(lambda: plain.update(
            out=step_plain(cfg, kst, kr, kt, kind, ky)), 10)
        p_st, p_rew, p_done = plain["out"]
        err = max(max_abs_err(cuda_tick.unflatten(outs), p_st),
                  (k_rew - p_rew).abs().max().item(),
                  float((k_done != p_done).sum().item()))
        ops = N_SLICE * tick_int_ops(cfg, results["selfplay_reset_share"],
                                     False, mode)
        kinds_t[mode] = (ms, p_ms, err, ops)
        del keep
    kinds_ms, kinds_plain_ms, _, kinds_ops = kinds_t["mixed"]
    kinds_err = max(v[2] for v in kinds_t.values())
    kinds_bytes = 2 * state_bytes(kst) + 4 * 4 * N_SLICE + 5 * N_SLICE

    # T-tick entry, 4096 boards x T_ENGINE ticks, random actions
    env = TetrisVectorEnv(cfg, N_ENGINE, device=DEV)
    st = env.reset(8)
    base = [5, 6]
    args, keep, outs = cuda_tick.rollout_args(cfg, st, T_ENGINE, None, base,
                                              128)
    launches = [lambda lib=lib: cuda_tick.check(
        lib.engine_tick_rollout(*args, stream), "engine_tick_rollout")
        for lib in libs]
    for f in launches:
        cuda_ms(f, 1)
    roll_times = in_turns(launches, 5)
    launches[0]()
    bk = torch.tensor(base, dtype=torch.int64)
    roll_plain_ms = cuda_ms(lambda: plain.update(out=cuda_tick.rollout_plain(
        cfg, st, T_ENGINE, base_key=bk, block_games=128)), 1)
    roll_err = max_abs_err(cuda_tick.unflatten(outs), plain["out"])
    del keep
    roll_bytes = 2 * state_bytes(st)
    roll_ops = N_ENGINE * T_ENGINE * tick_int_ops(
        cfg, results["engine_reset_share"], True)
    cuda_tick.raise_if_overflowed(st.current_player.device)
    log(f"[times] {card}: max |kernel - plain| at the timed shapes: "
        f"one-tick {step_err}, per-kind {kinds_err}, T-tick {roll_err}")
    if step_err != 0.0 or roll_err != 0.0 or kinds_err != 0.0:
        raise AssertionError("kernel disagrees with the plain version at "
                             "the timed shapes")

    def bound(n_bytes, n_ops):
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        o_ms = n_ops / int_rate * 1e3
        return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations", \
            b_ms, o_ms

    step_ms, roll_ms = step_times[0], roll_times[0]
    sb, sby, sb_bytes, sb_ops = bound(step_bytes, step_ops)
    kb, kby, kb_bytes, kb_ops = bound(kinds_bytes, kinds_ops)
    log(f"[times] {card}: bound of the per-kind one-tick entry (mixed "
        f"kinds): bytes {kinds_bytes} B -> {kb_bytes:.6f} ms, operations "
        f"{kinds_ops:.4g} ({kinds_ops / N_SLICE:.0f} per game-tick; "
        + ", ".join(f"{k} {tick_int_ops(cfg, results['selfplay_reset_share'], False, k):.0f}"
                    for k in ("macro", "place", "pose"))
        + f") -> {kb_ops:.6f} ms; bound by {kby}")
    rb, rby, rb_bytes, rb_ops = bound(roll_bytes, roll_ops)
    log(f"[times] {card}: int32 rate {int_rate:.4g} op/s derived from {sms} "
        f"SMs x {INT32_LANES_PER_SM} lanes x {mhz:.0f} MHz (clocks.max.sm)")
    log(f"[times] {card}: bound of the one-tick entry: bytes "
        f"{step_bytes} B -> {sb_bytes:.6f} ms, operations "
        f"{step_ops:.4g} ({step_ops / N_SLICE:.0f} per game-tick) -> "
        f"{sb_ops:.6f} ms; bound by {sby}")
    log(f"[times] {card}: bound of the T-tick entry: bytes {roll_bytes} B "
        f"-> {rb_bytes:.6f} ms, operations {roll_ops:.4g} "
        f"({roll_ops / (N_ENGINE * T_ENGINE):.0f} per game-tick) -> "
        f"{rb_ops:.6f} ms; bound by {rby}")
    kernels = [
        dict(name="engine_tick_step", route="cuda", source=SOURCE,
             replaces=REPLACES, launches=results["train_launches"],
             selfplay_launches=results["step_launches"],
             eval_launches=results["eval_launches"],
             eval_ticks=results["eval_ticks"],
             max_abs_err=max([results["errs"][k] for k in results["errs"]
                              if k.startswith("step")] + [step_err]),
             ms=step_ms, plain_ms=step_plain_ms, bound_ms=sb, bound_by=sby,
             library_ms=None,
             dqn_launches=results["dqn_launches"],
             dual_launches=results["dual_launches"],
             dual_dqn_launches=results["dual_dqn_launches"],
             demo_eval_launches=results["demo_eval_launches"],
             demo_eval_ticks=results["demo_eval_ticks"],
             arch_eval_launches=results["arch_eval_launches"],
             arch_eval_ticks=results["arch_eval_ticks"],
             process_launches=results["process_launches"],
             distributed_launches=results["distributed_launches"],
             bench_launches=results["bench_launches"],
             play_launches=results["play_launches"],
             path="training iteration (StandaloneTrainer.train_iteration)",
             shape=f"{N_SLICE} games x 1 tick", wrapper_ms=wrap_ms,
             bytes_ms=sb_bytes, ops_ms=sb_ops),
        dict(name="engine_tick_step (per-kind)", route="cuda",
             source=SOURCE, replaces=REPLACES,
             launches=results["sixten_launches"]
             + results["sherlock_launches"] + results["wm_eval_launches"],
             sixten_launches=results["sixten_launches"],
             sherlock_launches=results["sherlock_launches"],
             eval_launches=results["wm_eval_launches"],
             eval_ticks=results["wm_eval_ticks"],
             max_abs_err=max([results["errs"][k] for k in results["errs"]
                              if k.startswith("kinds")] + [kinds_err]),
             ms=kinds_ms, plain_ms=kinds_plain_ms, bound_ms=kb,
             bound_by=kby, library_ms=None,
             path="SIXten and Sherlock iterations, the five-kind eval",
             shape=f"{N_SLICE} games x 1 tick, mixed kinds",
             bytes_ms=kb_bytes, ops_ms=kb_ops,
             place_ms=kinds_t["place"][0], pose_ms=kinds_t["pose"][0],
             place_plain_ms=kinds_t["place"][1],
             pose_plain_ms=kinds_t["pose"][1]),
        dict(name="engine_tick_rollout", route="cuda", source=SOURCE,
             replaces=REPLACES, launches=results["rollout_launches"],
             max_abs_err=max([results["errs"][k] for k in results["errs"]
                              if k.startswith("rollout")] + [roll_err]),
             ms=roll_ms, plain_ms=roll_plain_ms, bound_ms=rb, bound_by=rby,
             library_ms=None, path="engine random-policy run (rollout)",
             shape=f"{N_ENGINE} games x {T_ENGINE} ticks",
             bytes_ms=rb_bytes, ops_ms=rb_ops),
    ]
    log(f"[times] {card}: one-tick entry {step_ms:.4f} ms/launch at "
        f"{N_SLICE} games ({N_SLICE / step_ms * 1e3:.0f} env-steps/s; "
        f"wrapper call {wrap_ms:.4f} ms), plain {step_plain_ms:.2f} ms")
    for mode, (ms, p_ms, _, ops) in kinds_t.items():
        b, by, b_bytes, b_ops = bound(kinds_bytes, ops)
        log(f"[times] {card}: per-kind one-tick entry, {mode}: {ms:.4f} "
            f"ms/launch at {N_SLICE} games, plain {p_ms:.2f} ms; bound "
            f"{b:.6f} ms by {by} (bytes {b_bytes:.6f} ms, operations "
            f"{ops:.4g} -> {b_ops:.6f} ms)")
    log(f"[times] {card}: T-tick entry {roll_ms:.4f} ms for {N_ENGINE} "
        f"boards x {T_ENGINE} ticks = "
        f"{N_ENGINE * T_ENGINE / roll_ms * 1e3:.0f} env-steps/s, plain "
        f"{roll_plain_ms:.1f} ms")
    if baseline:
        log(f"[times] {card}: baseline source, in turns with the kernel "
            f"(new, old, old, new): one-tick {step_times[1]:.4f} ms vs "
            f"{step_ms:.4f} ms ({step_times[1] / step_ms:.2f}x), T-tick "
            f"{roll_times[1]:.4f} ms vs {roll_ms:.4f} ms "
            f"({roll_times[1] / roll_ms:.2f}x)")
        kernels[0]["baseline_ms"] = step_times[1]
        kernels[1]["baseline_ms"] = roll_times[1]
    results["engine_sps"] = N_ENGINE * T_ENGINE / roll_ms * 1e3
    return kernels + [epilogue_entry(results)]


def epilogue_entry(results):
    """The kernels line's entry of the residual layers' epilogue, from
    ``phase_epilogue`` and ``phase_selfplay``: per main-path shape its
    time, bytes bound and plain version's time."""
    from drl_tetris_tpu_torch.models import checks
    times = results["epilogue_times"]
    return dict(
        name="net_epilogue", route="cuda",
        source="drl_tetris_tpu_torch/csrc/net_epilogue.cu", replaces=None,
        selfplay_launches=results["selfplay_epilogue_launches"],
        max_abs_err=results["epilogue_max_abs_err"],
        ms={k: v["kernel_ms"] for k, v in times.items()},
        bound_ms={k: v["bound_ms"] for k, v in times.items()},
        bound_by="bytes",
        plain_ms={k: v["plain_ms"] for k, v in times.items()},
        library_ms={k: v["elu_ms"] for k, v in times.items()},
        path="no-grad forward of every ResidualBlock on the card",
        shape=f"{checks.BOARDS} boards of {checks.MAP[0]} x {checks.MAP[1]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="an earlier engine_tick.cu with the "
                    "same C interface, timed in turns with the kernel")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import drl_tetris_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})",
              file=sys.stderr)
        return 2

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    torch.cuda.set_device(0)
    results = {"card": card}
    t0 = time.perf_counter()
    baseline = phase_build(results, card, opts.baseline)
    for phase in (phase_kernel_vs_plain, phase_epilogue, phase_selfplay,
                  phase_train,
                  phase_seed, phase_cli, phase_demo, phase_play, phase_process,
                  phase_distributed, phase_bench, phase_dqn, phase_dual,
                  phase_dual_dqn, phase_architectures, phase_sixten,
                  phase_sherlock, phase_placement_eval, phase_engine):
        t = time.perf_counter()
        phase(results, card)
        log(f"[{phase.__name__}] done in {time.perf_counter() - t:.1f} s")
    kernels = phase_times(results, card, baseline)
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t0
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(results, f, indent=1)
    log(f"train {results['train_sps']:.1f} env-steps/s (train_mfu "
        f"{results['train_mfu']:.5f}; {results['train_ms_per_step']:.3f} "
        f"ms per Adam step; noise draw {results['seed_draw_ms']:.3f} ms, "
        f"{100 * results['seed_draw_share']:.3f}% of the rollout), DQN "
        f"{results['dqn_sps']:.1f} "
        f"env-steps/s, dual PPO {results['dual_sps']:.1f} at {DUAL_ENVS} x "
        f"{HORIZON}, dual DQN {results['dual_dqn_sps']:.1f}, CLI train {results['cli_train_sps']:.1f}"
        f" env-steps/s at {CLI_ENVS} x {CLI_HORIZON}, match "
        f"{results['match_sps']:.0f} env-steps/s, checkpoint save "
        f"{results['ckpt_save_ms']:.1f} ms / restore "
        f"{results['ckpt_restore_ms']:.1f} ms, self-play "
        f"{results['selfplay_sps']:.0f} env-steps/s, process worker "
        f"{results['process_worker_sps']:.1f} env-steps/s and "
        f"{results['process_update_s'][1]:.2f} s per update, distributed "
        f"{results['distributed_sps']:.1f} env-steps/s, engine kernel "
        f"{results['engine_sps']:.0f} env-steps/s; {card}; total "
        f"{results['total_s']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
