"""Entry: a PPO worker's segment, ``make_worker_parts(flavour="ppo")`` of
drl_tetris_tpu_torch/runtime/runner.py: the rollout (observe, the net,
``pi`` sampling, the engine kernel's one-tick entry) and ``ship`` (the
worker-side GAE batch handed to the host as numpy), one set of weights
for the window, the segment keys split from a chain as
``WorkerRunner.collect`` splits them.

Set-up builds the parts, gives the net the benchmark's weights
(``draw_weights``), resets the games from the benchmark's key and warms
up with one segment from that state, whose output is dropped; the window
starts from the same state.  The judge takes the window's first segment
and one more drawn from the seed: the engine replays each from its start
(the reference's own reset for the first, the program's state for the
other) with the shipped actions, and the f32 net recomputes the batch.
Numbers compared:

* ``engine_mismatches``: elements of the reset, of every shipped board,
  vector observation and piece, and of the first segment's end state
  (against the second's start) that differ (exact);
* ``action_gap``: the widest gap by which a shipped action's log p + noise
  lies below the reference's best;
* ``logprob_gap``: the widest |log p| gap of the shipped probabilities;
* ``value_gap``: the widest gap of the values the rollout computed
  (v(s|piece) and v(s) of every tick, the bootstrap v(s|piece) of the end
  state) against the reference net's;
* ``gae_gap``: the widest gap of the shipped advantages and value targets
  against the reference's GAE over the replayed rewards and dones and the
  values the program's rollout computed (GAE by itself; the values are
  ``value_gap``'s).
"""
from __future__ import annotations

import random
import time
from types import SimpleNamespace

import torch

from benchmark import programs
from benchmark.reference import rng
from benchmark.reference.acting import (act, replay, rollout_noise,
                                        segment_batch)
from benchmark.reference.compare import (as_reference_state, cat_states,
                                         mismatches, take_games)
from benchmark.reference.env import reset
from benchmark.reference.gae import sventon_gae
from benchmark.reference.nets import PPONet, ieee_float32
from benchmark.work.engine import env_config

BATCH_FIELDS = ("occ", "vec", "piece", "rot", "trans", "old_prob",
                "advantage", "target_v")
VALUE_FIELDS = ("v_piece", "v_mean", "v_last")


def draw_weights(ctx, state_dict):
    """The benchmark's weights (``Context.weights_like``) with the value
    tower set so that tanh leaves v unsaturated.  Drawn plainly, the add
    joins carry the vector planes (the spawn column, 3) and every tower's
    sum down the residual stream into the value head's 8 output channels,
    and v reads +-1 on most seeds.  So the residual's 8 channels are held
    at elu's floor (-1) by a bias of -30 on the last layer but one, the
    head's base channel gets +1 back, and the tower's convs but the last
    are doubled: v is then the last conv's reading of the tower."""
    w = ctx.weights_like(state_dict)
    m = ctx.config["model"]
    last, n_out = m["val_layers"] - 1, m["n_pieces"] + 1
    tower = "trunk.value_tower.convs."
    for i in range(last):
        w[f"{tower}{i}.weight"].mul_(2.0)
    w[f"{tower}{last - 1}.bias"][:n_out] = -30.0
    w[f"{tower}{last}.bias"][0] += 1.0
    return w


def build(ctx):
    from drl_tetris_tpu_torch.algos.rollout import HParams
    from drl_tetris_tpu_torch.engine import rng as prng
    from drl_tetris_tpu_torch.env.env import TetrisVectorEnv
    from drl_tetris_tpu_torch.runtime.runner import make_worker_parts
    from drl_tetris_tpu_torch.runtime.standalone import StandaloneConfig
    fw = programs.framework(ctx.config)
    traffic = ctx.workload["traffic"]
    cfg = StandaloneConfig(env=fw.env, model=fw.model, ppo=fw.ppo,
                           n_envs=traffic["n_envs"],
                           horizon=traffic["horizon"])
    s = SimpleNamespace()
    s.cfg, s.prng, s.hp, s.seed = ctx.config, prng, HParams(), ctx.seed
    s.env = TetrisVectorEnv(cfg.env, cfg.n_envs, device=ctx.device)
    nets, s.rollout, s.ship = make_worker_parts(cfg, s.env, "ppo")
    ctx.mark("program built")
    s.net = nets[0]
    s.weights = draw_weights(ctx, s.net.state_dict())
    s.net.load_params_(s.weights)
    s.chain_key, s.env_key, warm_key = ctx.key(), ctx.key(), ctx.key()
    s.env_state = s.env.reset(s.env_key)
    ctx.mark("inputs made")
    if ctx.fault is not None:
        ctx.fault(s)
    s.rollout(s.env_state, warm_key, s.hp, None)
    s.key = s.chain_key.clone()
    s.cuda = ctx.device.type == "cuda"
    s.segments = []
    return s


def unit(s) -> dict:
    start = s.env_state
    s.key, kroll = s.prng.split(s.key)
    if s.cuda:
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
    else:
        t0 = time.perf_counter()
    s.env_state, seg, v_last = s.rollout(start, kroll, s.hp, None)
    if s.cuda:
        t1.record()
    else:
        t1 = time.perf_counter()
    packet = s.ship(seg, v_last, s.env_state)
    rollout_ms = t0.elapsed_time(t1) if s.cuda else (t1 - t0) * 1e3
    s.segments.append((start, kroll, packet,
                       (seg.v_piece, seg.v_mean, v_last)))
    T, N = seg.done.shape
    return {"env_steps": T * N, "ticks": T, "games": N,
            "rollout_ms": rollout_ms, "fwd_samples": N * (T + 1),
            "dones": int(seg.done.sum())}


def record(s) -> dict:
    """The window's first segment and one drawn from the seed, with the
    start of the segment after the first."""
    n = len(s.segments)
    picks = [0] + ([random.Random(s.seed).randrange(1, n)] if n > 1 else [])
    out = []
    for k in picks:
        start, kroll, packet, values = s.segments[k]
        out.append({
            "index": k, "kroll": kroll.cpu(),
            "start": as_reference_state(start),
            "batch": {f: torch.as_tensor(packet["batch"][f])
                      for f in BATCH_FIELDS},
            "values": dict(zip(VALUE_FIELDS,
                               (v.detach().cpu() for v in values)))})
    nxt = as_reference_state(s.segments[1][0]) if n > 1 else None
    return {"weights": {k: v.detach().cpu() for k, v in s.weights.items()},
            "env_key": s.env_key.cpu(), "segments": out,
            "second_start": nxt}


def judge(rec, ctx) -> dict:
    ieee_float32()
    cfg = env_config(ctx.config)
    ppo = ctx.config["ppo"]
    gamma = -ppo["gamma"] if ppo["single_policy"] else ppo["gamma"]
    lam, gve = ppo["gae_lambda"], ppo["gve_lambda"]
    traffic = ctx.workload["traffic"]
    n, h = traffic["n_envs"], traffic["horizon"]
    W = cfg.engine.width
    n_act = ctx.config["model"]["n_rotations"] * W
    segs = rec["segments"]

    s0 = reset(cfg, rec["env_key"], n, "cpu")
    bad = mismatches(s0, segs[0]["start"])
    starts = [s0] + [sg["start"] for sg in segs[1:]]
    shaped = [{k: b.reshape((h, n) + tuple(b.shape[1:]))
               for k, b in sg["batch"].items()} for sg in segs]
    rot = torch.cat([b["rot"] for b in shaped], 1)
    trans = torch.cat([b["trans"] for b in shaped], 1)
    end, views = replay(cfg, cat_states(starts), rot, trans)
    if rec["second_start"] is not None:
        bad += mismatches(take_games(end, 0, n), rec["second_start"])

    net = PPONet(ctx.config["model"], (cfg.engine.height, W)).to(ctx.device)
    net.load_state_dict(rec["weights"])
    gaps, lp, vg, gg = [], [], [], []
    for i, (sg, b) in enumerate(zip(segs, shaped)):
        lo, hi = i * n, (i + 1) * n
        v = {k: x[:, lo:hi] for k, x in views.items()}
        bad += sum(mismatches(v[k], b[k]) for k in ("occ", "vec", "piece"))
        noise = rollout_noise(sg["kroll"], h, n, n_act)
        ref, gap, ref_values = segment_batch(
            cfg, gamma, lam, gve, net, v, b["rot"], b["trans"],
            take_games(end, lo, hi), noise)
        gaps.append(gap)
        got = {k: x.to(ref.old_prob.device) for k, x in sg["batch"].items()}
        lp.append(float((torch.log(got["old_prob"].clamp(min=1e-20))
                         - torch.log(ref.old_prob.clamp(min=1e-20))
                         ).abs().max()))
        pv = {k: x.to(ref.old_prob.device) for k, x in sg["values"].items()}
        vg.append(max(float((pv[k].float() - ref_values[k]).abs().max())
                      for k in VALUE_FIELDS))
        adv, tgt, _ = sventon_gae(
            v["reward"].to(pv["v_last"].device),
            v["done"].to(pv["v_last"].device), pv["v_piece"], pv["v_mean"],
            pv["v_last"], gamma=gamma, gae_lambda=lam, gve_lambda=gve)
        gg.append(max(float((got["advantage"] - adv.reshape(-1)).abs().max()),
                      float((got["target_v"] - tgt.reshape(-1)).abs().max())))
    return {"engine_mismatches": float(bad), "action_gap": max(gaps),
            "logprob_gap": max(lp), "value_gap": max(vg),
            "gae_gap": max(gg)}


def control_record(ctx, precision: str = "fp8", segments: int = 2) -> dict:
    """The reference one precision step below the configuration's in the
    program's place (the towers at ``precision``, GAE in bfloat16): the
    same inputs, its own sampling; the first ``segments`` segments as
    ``record`` gives them (the judge takes the first and the last)."""
    ieee_float32()
    cfg = env_config(ctx.config)
    ppo = ctx.config["ppo"]
    gamma = -ppo["gamma"] if ppo["single_policy"] else ppo["gamma"]
    lam, gve = ppo["gae_lambda"], ppo["gve_lambda"]
    traffic = ctx.workload["traffic"]
    n, h = traffic["n_envs"], traffic["horizon"]
    n_act = ctx.config["model"]["n_rotations"] * cfg.engine.width
    net = PPONet(ctx.config["model"], (cfg.engine.height, cfg.engine.width),
                 precision).to(ctx.device)
    weights = draw_weights(ctx, net.state_dict())
    net.load_state_dict(weights)
    chain_key, env_key = ctx.key(), ctx.key()
    ctx.key()                                    # the warm-up's key
    state = reset(cfg, env_key.cpu(), n, "cpu")
    key = rng.u32(chain_key.cpu())
    segs = []
    for k in range(segments):
        key, kroll = rng.split(key)
        end, r, t, views = act(cfg, net, state,
                               rollout_noise(kroll, h, n, n_act))
        b, _, values = segment_batch(cfg, gamma, lam, gve, net, views, r,
                                     t, end, gae_dtype=torch.bfloat16)
        segs.append({"index": k, "kroll": kroll, "start": state,
                     "batch": {f: getattr(b, f).cpu() for f in
                               BATCH_FIELDS},
                     "values": {k: x.cpu() for k, x in values.items()}})
        state = end
    return {"weights": {k: v.cpu() for k, v in weights.items()},
            "env_key": env_key.cpu(),
            "segments": [segs[0], segs[-1]] if segments > 1 else segs,
            "second_start": segs[1]["start"] if segments > 1 else None}


def _state_unchanged(s):
    """The env step hands back the state it was given."""
    step = s.env.step

    def stuck(state, r, t):
        _, reward, done = step(state, r, t)
        return state, reward, done
    s.env.step = stuck


def _half_batch(s):
    """The shipped batch holds the first half of the games."""
    ship = s.ship

    def half(seg, v_last, env_state):
        n = seg.done.shape[1] // 2
        return ship(type(seg)(*[a[:, :n] for a in seg]), v_last[:n],
                    env_state)
    s.ship = half


def _altered_action(s):
    """Game 0's sampled translation moves one column where it is
    drawn."""
    from drl_tetris_tpu_torch.algos import rollout as R
    draw = R.D.action_distribution
    W = s.cfg["env"]["engine"]["width"]

    def altered(A, gumbel):
        (r, t), ent = draw(A, gumbel)
        t = t.clone()
        t[0] = (t[0] + 1) % W
        return (r, t), ent
    R.D.action_distribution = altered
    return lambda: setattr(R.D, "action_distribution", draw)


def _value_left_out(s):
    """The net's values come back as 0: the value tower left out."""
    forward = s.net.forward

    def no_value(vec, vis):
        pi, v = forward(vec, vis)
        return pi, torch.zeros_like(v)
    s.net.forward = no_value


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "altered_action": _altered_action, "value_left_out": _value_left_out}
