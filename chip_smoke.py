#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the engine tick kernel (drl_tetris_tpu_torch/csrc/engine_tick.cu)
with nvcc, holds both of its entries bit for bit against their plain
PyTorch version on the card, drives the port's two paths through the
entry points a user calls, and times the kernels:

1. build   nvcc into build/torch_kernels/ (seconds and ptxas report);
2. kernel vs plain, every state leaf equal:
   - the T-tick entry with replayed actions (1024 games x 64 ticks),
   - the T-tick entry with in-kernel random actions (block_games 128),
   - the one-tick entry over 64 ticks, with reward and done;
3. the self-play path (the acting loop of training): make_rollout_fn with
   TetrisVectorEnv(EnvConfig(), 1024) and PPONet(ModelConfig()) at full
   width in bfloat16, weights drawn from a numpy seed, horizon 64.  The
   one-tick entry must launch exactly once per tick; the trajectory is
   replayed through the plain engine and must agree; the net at float32
   agrees with the CPU on a few boards;
4. the engine path (the random-policy throughput run): the T-tick entry
   at 4096 boards with in-kernel random actions;
5. times: kernel, plain version and memory bound of each entry at the
   shape its path gives it (the timed kernel and plain outputs are held
   equal too), the rollout's env-steps/s.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as the last line ``{"ok": true, "device": {...}}``.  Any failure raises
and the script exits non-zero without that line; so does a machine with
no CUDA device.  A copy of the results goes to chiprun_out/chip_smoke.json.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate (data sheet)
SOURCE = "drl_tetris_tpu_torch/csrc/engine_tick.cu"
REPLACES = "drl_tetris_tpu/engine/pallas_tick.py:262"
N_SLICE, HORIZON = 1024, 64        # training geometry (bench.py:211)
N_ENGINE, T_ENGINE = 4096, 100     # engine throughput boards (bench.py:1)
DEV = "cuda"


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


def max_abs_err(a, b):
    """Largest |a - b| over every leaf of two state trees (0 == bit
    exact: integer leaves compare their bit patterns)."""
    from drl_tetris_tpu_torch.engine.core import tree_leaves
    worst = 0.0
    for (name, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"leaf {name}: {x.shape}/{x.dtype} vs "
                                 f"{y.shape}/{y.dtype}")
        if x.dtype == torch.float32:
            if torch.equal(x.view(torch.int32), y.view(torch.int32)):
                continue
            e = (x.double() - y.double()).abs().nan_to_num(float("inf"))
            # bits differ even where values are equal (-0.0, NaN payloads)
            worst = max(worst, e.max().item(), 2.0 ** -149)
        else:
            e = (x.long() - y.long()).abs().max().item()
            worst = max(worst, float(e))
    return worst


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


def phase_build(results, card):
    from drl_tetris_tpu_torch.engine import cuda_tick
    t0 = time.perf_counter()
    path, report = cuda_tick.build()
    secs = time.perf_counter() - t0
    log(f"[build] nvcc {' '.join(cuda_tick.NVCC_FLAGS)} -> {path} "
        f"in {secs:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    results["build_s"] = secs


def phase_kernel_vs_plain(results, card):
    """Both entries against the plain version on CUDA tensors."""
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.env.env import (EnvConfig, TetrisVectorEnv,
                                              step_plain)
    cfg = EnvConfig()
    env = TetrisVectorEnv(cfg, N_SLICE, device=DEV)
    start = env.reset(11)
    rs = np.random.RandomState(0)
    ar = torch.from_numpy(rs.randint(0, 4, (HORIZON, N_SLICE)).astype(
        np.int32)).to(DEV)
    at = torch.from_numpy(rs.randint(0, cfg.engine.width,
                                     (HORIZON, N_SLICE)).astype(
        np.int32)).to(DEV)
    errs = {}

    ker = cuda_tick.rollout(cfg, start, HORIZON, actions=(ar, at))
    ref = cuda_tick.rollout_plain(cfg, start, HORIZON, actions=(ar, at))
    errs["rollout_replayed"] = max_abs_err(ker, ref)
    played = int((ker.rounds_played - start.rounds_played).sum())

    base = torch.tensor([7, 2024], dtype=torch.int64)
    ker = cuda_tick.rollout(cfg, start, HORIZON, base_key=base,
                            block_games=128)
    ref = cuda_tick.rollout_plain(cfg, start, HORIZON, base_key=base,
                                  block_games=128)
    errs["rollout_random"] = max_abs_err(ker, ref)

    ks, ps = start, start
    step_err, n_done = 0.0, 0
    for tick in range(HORIZON):
        ks, kr, kd = cuda_tick.step(cfg, ks, ar[tick], at[tick])
        ps, pr, pd = step_plain(cfg, ps, ar[tick], at[tick])
        step_err = max(step_err, max_abs_err(ks, ps),
                       (kr - pr).abs().max().item(),
                       float((kd != pd).sum().item()))
        n_done += int(kd.sum())
    errs["step"] = step_err
    cuda_tick.raise_if_overflowed(start.current_player.device)
    log(f"[kernel vs plain] {card}: max |kernel - plain| over every leaf: "
        f"{errs}; rounds finished {played} (replayed), dones {n_done} "
        f"(one-tick)")
    if any(v != 0.0 for v in errs.values()):
        raise AssertionError(f"kernel disagrees with the plain version: "
                             f"{errs}")
    if played == 0 or n_done == 0:
        raise AssertionError("no round finished: the comparison did not "
                             "reach round resets")
    results["errs"] = errs


def phase_selfplay(results, card):
    """The acting loop of training, through its entry points."""
    from drl_tetris_tpu_torch.algos.rollout import (make_policy_fn,
                                                    make_rollout_fn)
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
    from drl_tetris_tpu_torch.models.convert import seeded_state_dict
    from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet

    cfg = EnvConfig()
    env = TetrisVectorEnv(cfg, N_SLICE, device=DEV)
    net = PPONet(ModelConfig(), device=DEV).eval()
    net.load_state_dict(seeded_state_dict(net, 3))
    rollout = make_rollout_fn(env, net, HORIZON)
    gen = torch.Generator(device=DEV).manual_seed(5)

    warm = env.reset(1)
    rollout(warm, gen)                       # cuDNN autotuning, allocator
    st0 = env.reset(2)
    for k in cuda_tick.LAUNCHES:
        cuda_tick.LAUNCHES[k] = 0
    sync()
    t0 = time.perf_counter()
    st, seg, last = rollout(st0, gen)
    sync()
    secs = time.perf_counter() - t0
    launches = dict(cuda_tick.LAUNCHES)

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

    # the env side of the trajectory: replay the chosen actions through
    # the plain engine from the same start state
    ref = cuda_tick.rollout_plain(cfg, st0, HORIZON,
                                  actions=(seg.rot, seg.trans))
    env_err = max_abs_err(st, ref)
    if env_err != 0.0:
        raise AssertionError(f"rollout state differs from the plain replay "
                             f"({env_err})")
    # the net: float32 on the card (no TF32) against the CPU, 8 boards
    # where a tick's time goes: the policy (observe, PPONet forward,
    # sample) against the env step (the one-tick entry and its wrapper)
    policy = make_policy_fn(env, net)
    with torch.no_grad():
        policy_ms = cuda_ms(lambda: policy(st, gen), 20)
    r0, t0_ = seg.rot[0], seg.trans[0]
    env_ms = cuda_ms(lambda: env.step(st, r0, t0_), 50)
    net_err = net_card_vs_cpu(env, st0)
    sps = N * T / secs
    log(f"[self-play] {card}: {N} games x {T} ticks in {secs:.3f} s = "
        f"{sps:.0f} env-steps/s ({secs / T * 1e3:.2f} ms/tick: policy "
        f"{policy_ms:.2f} ms, env step {env_ms:.3f} ms); rounds +{grew}, "
        f"rewards +1 x{wins}, -1 x{losses}; one-tick launches "
        f"{launches['step']}; plain replay max err {env_err}; net f32 card "
        f"vs cpu max err {net_err:.2e}")
    for k in cuda_tick.LAUNCHES:             # the timing calls above
        cuda_tick.LAUNCHES[k] = 0
    results.update(selfplay_s=secs, selfplay_sps=sps, policy_ms=policy_ms,
                   env_step_ms=env_ms, step_launches=launches["step"],
                   net_err=net_err)


def net_card_vs_cpu(env, state):
    from drl_tetris_tpu_torch.algos.rollout import policy_inputs
    from drl_tetris_tpu_torch.models.convert import seeded_state_dict
    from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    torch.backends.cudnn.allow_tf32 = True
    if not err < 1e-4:
        raise AssertionError(f"PPONet float32 card vs CPU: {err}")
    return err


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


def phase_times(results, card):
    """Kernel, plain and bound times of both entries at their paths'
    shapes."""
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.env.env import (EnvConfig, TetrisVectorEnv,
                                              step_plain)
    cfg = EnvConfig()
    lib = cuda_tick.load()
    stream = torch.cuda.current_stream().cuda_stream

    # one-tick entry, N = 1024: kernel alone on fixed buffers; the timed
    # launches' outputs are held against the timed plain call's
    env = TetrisVectorEnv(cfg, N_SLICE, device=DEV)
    st = env.reset(6)
    rs = np.random.RandomState(1)
    r = torch.from_numpy(rs.randint(0, 4, N_SLICE).astype(np.int32)).to(DEV)
    t = torch.from_numpy(rs.randint(0, cfg.engine.width, N_SLICE).astype(
        np.int32)).to(DEV)
    args, keep, (outs, k_rew, k_done) = cuda_tick.step_args(cfg, st, r, t)
    launch = lambda: cuda_tick.check(lib.engine_tick_step(*args, stream),
                                     "engine_tick_step")
    cuda_ms(launch, 5)
    step_ms = cuda_ms(launch, 200)
    wrap_ms = cuda_ms(lambda: cuda_tick.step(cfg, st, r, t), 200)
    plain = {}
    step_plain(cfg, st, r, t)
    step_plain_ms = cuda_ms(
        lambda: plain.update(out=step_plain(cfg, st, r, t)), 10)
    p_st, p_rew, p_done = plain["out"]
    step_err = max(max_abs_err(cuda_tick.unflatten(st, outs), p_st),
                   (k_rew - p_rew).abs().max().item(),
                   float((k_done != p_done).sum().item()))
    step_bytes = 2 * state_bytes(st) + 2 * 4 * N_SLICE + 5 * N_SLICE
    del keep

    # T-tick entry, 4096 boards x T_ENGINE ticks, random actions
    env = TetrisVectorEnv(cfg, N_ENGINE, device=DEV)
    st = env.reset(8)
    base = [5, 6]
    args, keep, outs = cuda_tick.rollout_args(cfg, st, T_ENGINE, None, base,
                                              128)
    launch = lambda: cuda_tick.check(lib.engine_tick_rollout(*args, stream),
                                     "engine_tick_rollout")
    cuda_ms(launch, 1)
    roll_ms = cuda_ms(launch, 5)
    bk = torch.tensor(base, dtype=torch.int64)
    roll_plain_ms = cuda_ms(lambda: plain.update(out=cuda_tick.rollout_plain(
        cfg, st, T_ENGINE, base_key=bk, block_games=128)), 1)
    roll_err = max_abs_err(cuda_tick.unflatten(st, outs), plain["out"])
    del keep
    roll_bytes = 2 * state_bytes(st)
    cuda_tick.raise_if_overflowed(st.current_player.device)
    log(f"[times] {card}: max |kernel - plain| at the timed shapes: "
        f"one-tick {step_err}, T-tick {roll_err}")
    if step_err != 0.0 or roll_err != 0.0:
        raise AssertionError("kernel disagrees with the plain version at "
                             "the timed shapes")

    kernels = [
        dict(name="engine_tick_step", route="cuda", source=SOURCE,
             replaces=REPLACES, launches=results["step_launches"],
             max_abs_err=max(results["errs"]["step"], step_err), ms=step_ms,
             plain_ms=step_plain_ms,
             bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
             library_ms=None, path="self-play rollout (make_rollout_fn)",
             shape=f"{N_SLICE} games x 1 tick", wrapper_ms=wrap_ms),
        dict(name="engine_tick_rollout", route="cuda", source=SOURCE,
             replaces=REPLACES, launches=results["rollout_launches"],
             max_abs_err=max(results["errs"]["rollout_replayed"],
                             results["errs"]["rollout_random"], roll_err),
             ms=roll_ms, plain_ms=roll_plain_ms,
             bound_ms=roll_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
             library_ms=None, path="engine random-policy run (rollout)",
             shape=f"{N_ENGINE} games x {T_ENGINE} ticks"),
    ]
    log(f"[times] {card}: one-tick entry {step_ms:.4f} ms/launch at "
        f"{N_SLICE} games ({N_SLICE / step_ms * 1e3:.0f} env-steps/s; "
        f"wrapper call {wrap_ms:.4f} ms), plain {step_plain_ms:.2f} ms")
    log(f"[times] {card}: T-tick entry {roll_ms:.3f} ms for {N_ENGINE} "
        f"boards x {T_ENGINE} ticks = "
        f"{N_ENGINE * T_ENGINE / roll_ms * 1e3:.0f} env-steps/s, plain "
        f"{roll_plain_ms:.1f} ms")
    results["engine_sps"] = N_ENGINE * T_ENGINE / roll_ms * 1e3
    return kernels


def main():
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
    for phase in (phase_build, phase_kernel_vs_plain, phase_selfplay,
                  phase_engine):
        t = time.perf_counter()
        phase(results, card)
        log(f"[{phase.__name__}] done in {time.perf_counter() - t:.1f} s")
    kernels = phase_times(results, card)
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t0
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(results, f, indent=1)
    log(f"self-play {results['selfplay_sps']:.0f} env-steps/s, engine "
        f"kernel {results['engine_sps']:.0f} env-steps/s; {card}; total "
        f"{results['total_s']:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
