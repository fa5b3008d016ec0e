"""Entry: SIXten's standalone trainer, one
``StandaloneSIXtenTrainer.train_iteration`` of
drl_tetris_tpu_torch/runtime/standalone.py a unit: the games act by the
one-ply world-model search over their legal top-drop placements (the
placement masks, V over every successor board in one batched forward,
epsilon's draw, one launch of the engine kernel's per-kind entry a tick),
the segment goes into the prioritized replay, then one update: the rank
sample from the whole replay, the k-step windows, the k-step lambda
targets through the reference net, Adam over the minibatches, the new
priorities written back.

Set-up builds the trainer from the configuration's presets and its
``trainer`` settings (``_trainer_settings``: the CUDA graphs), gives its net
and reference net the benchmark's weights (``draw_weights``), its key and
its games' reset from the seed, fills the replay (``fill_replay``: the
port's own engine under uniformly drawn legal top-drop placements at a
wide width, written through ``replay_add_segment``, then a drawn three
quarters of the rows given priorities |N(0, std)| as rows that were
sampled before carry |v - target|), and runs one warm iteration.

The judge takes two iterations of the timed path at the timed sizes: the
warm one, the first update, from the benchmark's weights, where V is
unsaturated; and the window's last (an iteration under the profiler is not
judged), where after every earlier update's Adam steps at the published
learning rate V mostly reads +-1, tanh's gradient vanishes and the
gradient is mostly the L2 term's, but whose reference net has fallen
behind the online one.  Recorded from the timed path: the trainer's key
and its games' state before the iteration, the placements handed to the
engine, the rollout's segment, the games' state after it; at the update's
start the replay's priorities and size, alpha and beta, the net's and the
reference net's weights; the sample, its IS weights and its targets; the
first minibatch's gradient and Adam's moments (at the optimizer's first
step), the weights after that step, and the number of steps; the
replay's cursor and size before the iteration and at the update's start;
after the iteration the rows the add wrote, the sampled rows' windows and
priorities.
Numbers compared, against benchmark/reference in float32 with TF32 off:

* ``engine_mismatches``: elements of the segment's boards, vector
  observations, pieces, rewards and dones, of its recorded rotations and
  translations, and of the end state that differ from the reference
  engine's replay (on the CPU) of the recorded placements (exact);
* ``mask_mismatches``: ticks of games whose recorded probability (1 over
  the number of legal placements) differs from the plain masks', or whose
  placement the plain masks call illegal (exact);
* ``explore_mismatches``: ticks where epsilon's draw from the tick's key
  explores and the placement is not the uniform pick of that draw (exact);
* ``value_gap``: the widest gap of the values the warm iteration's
  rollout recorded, V of the chosen successor and the successors' mean,
  against the reference's V of the same successors (at the window's last
  iteration the weights have grown under Adam, and bf16's error in the
  pre-tanh sums shows where tanh is still steep: up to 0.086 two updates
  in; it is reported apart, ``value_gap.1``);
* ``choice_regret``: on the ticks that do not explore, the reference's V
  of the best legal successor less the chosen one's, summed, over the
  same for a uniform legal pick, which reads 1 on average, and the worst
  pick more (values, not choices: near-ties flip on rounding; the warm
  iteration's, V later saturating);
* ``add_mismatches``: elements of the rows the segment's add wrote
  (fields and priorities), and the cursor and size after it, that differ
  from the reference's add of the recorded segment (exact);
* ``sample_mismatches``: rows of the sample that differ from the rank
  sample the reference draws from the same priorities and the key's noise
  on the card (exact);
* ``target_gap``: the widest gap of the k-step targets against the
  reference's through the recorded reference weights;
* ``grad_gap``: the first minibatch's loss gradient against the
  reference's at the recorded weights, the worst tensor's ||g - g_ref||
  over the larger of ||g_ref|| and the median tensor's;
* ``prio_gap``: the widest gap of that minibatch's new priorities;
* ``step_gap``: the first Adam step's change of the weights against the
  reference's step from the same weights, moments and recorded gradient
  at the configuration's learning rate, held per tensor as ``grad_gap``
  (weights left unchanged read 1);
* ``adam_step_mismatch``: |Adam steps of the update - the minibatches an
  update holds|.

Counts are summed over the two iterations, the other numbers are the wider
of the two (``value_gap`` and ``choice_regret`` the warm one's); each
iteration's are also given apart (``<name>.0`` the warm one's, ``<name>.1``
the last's).  The control
(``control_record``) is the reference with its towers in float8 e4m3 in
the program's place, one iteration from the same set-up; the faults
(``FAULTS``) break the path once it is built.
"""
from __future__ import annotations

import dataclasses
import statistics
from types import SimpleNamespace

import torch

from benchmark import programs
from benchmark.core import synchronize
from benchmark.reference import rng
from benchmark.reference import replay as R
from benchmark.reference.compare import as_reference_state, mismatches
from benchmark.reference.env import reset
from benchmark.reference.nets import ieee_float32
from benchmark.reference.observations import observe
from benchmark.reference.placement import (acting_player, perspective_occ,
                                           replay_place, step_place)
from benchmark.reference.sixten import (VNet, adam_step, choose, explore,
                                        gradient, legal_prob,
                                        successor_values)
from benchmark.reference.value_estimator import kstep_targets
from benchmark.work.engine import env_config

SEG_FIELDS = ("occ", "vec", "piece", "rot", "trans", "prob", "v_piece",
              "v_mean", "reward", "done")
SECTIONS = ("sixten", "replay", "epsilon")
# held at the benchmark's weights alone: later V saturates, so the value
# error and the successors' spread are the warm iteration's
WARM_ONLY = ("value_gap", "choice_regret")
COUNTS = ("mismatches", "mismatch")     # summed over the iterations


def _resolved(ctx):
    """The port's FrameworkConfig of the file's presets; raises where the
    file's sixten, replay or epsilon section differs from it (env, model,
    value_lr and train_distribution are ``programs.framework``'s)."""
    fw = programs.framework(ctx.config)
    got = {"sixten": programs._plain(fw.sixten),
           "replay": programs._plain(fw.replay),
           "epsilon": programs._plain(fw.epsilon)}
    diff = [d for k in SECTIONS if k in ctx.config
            for d in programs._differences(ctx.config[k], got[k], "." + k)]
    if diff:
        raise ValueError("the presets resolve to another configuration than "
                         "the file states: " + "; ".join(diff))
    return fw


def draw_weights(ctx, state_dict):
    """The benchmark's weights (``Context.weights_like``) with the value
    head set so that tanh leaves v unsaturated: drawn plainly, the
    residual join carries the vector planes (the spawn column, 3) and the
    towers' sums into the head's 8 output channels.  So those channels of
    the last layer but one are held at elu's floor (-1) by a bias of -30,
    and the head's base channel gets +1 back.  (The PPO entry also doubles
    the value tower's other convs; on the VNet that spreads the values so
    far that a third of the seeds read |v| near 1 and the bf16 gaps then
    vary four-fold across seeds.)"""
    w = ctx.weights_like(state_dict)
    m = ctx.config["model"]
    last, n_out = m["val_layers"] - 1, m["n_pieces"] + 1
    tower = "value_tower.convs."
    w[f"{tower}{last - 1}.bias"][:n_out] = -30.0
    w[f"{tower}{last}.bias"][0] += 1.0
    return w


def fill_replay(ctx, env_cfg, replay_cfg, replay, traffic):
    """Fill ``replay`` (the port's ReplayState) to the last whole run of
    ``fill_horizon`` rows below capacity - k: ``fill_games`` games of the
    port's engine, each tick a uniformly drawn legal top-drop placement
    (noise from the seed), written through ``replay_add_segment``; then
    ``sampled_share`` of the rows, drawn, get |N(0, sampled_prio_std)|."""
    from drl_tetris_tpu_torch.algos.replay import replay_add_segment
    from drl_tetris_tpu_torch.algos.rollout import Segment, _perspective_occ
    from drl_tetris_tpu_torch.engine import masks as M
    from drl_tetris_tpu_torch.env.env import TetrisVectorEnv, take_player
    G, T = traffic["fill_games"], traffic["fill_horizon"]
    dev = ctx.device
    W = env_cfg.engine.width
    env = TetrisVectorEnv(env_cfg, G, device=dev)
    state = env.reset(ctx.key())
    runs = (replay_cfg.capacity - replay_cfg.k_step) // T
    while runs > 0:
        ticks = []
        for _ in range(T):
            p = state.current_player
            ps = state.engine.players
            piece, rot = take_player(ps.piece, p), take_player(ps.rot, p)
            mask, _ = M.top_drop(env_cfg.engine, take_player(ps.occ, p),
                                 piece, rot)
            u = torch.rand((G, mask[0].numel()), generator=ctx.gen,
                           device=dev)
            choice = torch.argmax(torch.where(mask.reshape(G, -1), u, -1.0),
                                  dim=1)
            r_rel = torch.remainder(choice // W - rot, 4).to(torch.int32)
            x = (choice % W - 1).to(torch.int32)
            occ, vec = _perspective_occ(state, p), env.observe(state).vec
            state, reward, done = env.step_place(state, r_rel, x)
            ticks.append((occ, vec, piece, r_rel, torch.clamp(x, min=0),
                          reward, done))
        n = min(G, runs)
        occ, vec, piece, r, t, reward, done = (
            torch.stack(xs)[:, :n] for xs in zip(*ticks))
        zero = torch.zeros_like(reward)
        replay_add_segment(replay_cfg, replay, Segment(
            occ=occ, vec=vec, piece=piece, rot=r, trans=t, prob=zero,
            v_piece=zero, v_mean=zero, reward=reward, done=done,
            player=torch.zeros_like(piece)), T)
        runs -= n
    size = replay.size
    rows = torch.randperm(size, generator=ctx.gen, device=dev)[
        :int(size * traffic["sampled_share"])]
    replay.prio[rows] = (torch.randn(rows.shape[0], generator=ctx.gen,
                                     device=dev)
                         * traffic["sampled_prio_std"]).abs()


def _install_recorders(s):
    """Record what the judge reads of the timed path (see the module's
    docstring) into ``s.cur``, without changing what the path computes.
    The rollout runs through ``s.rollout`` (a fault may replace it); the
    sample's recorder stays in ``algos/sixten.py`` after the run, and the
    next build's takes its place."""
    from drl_tetris_tpu_torch.algos import sixten as X
    tr = s.trainer
    s.rollout = tr.rollout

    def rollout(env_state, key=None, hp=None):
        out = s.rollout(env_state, key, hp)
        s.cur["seg"] = out[1]
        return out
    tr.rollout = rollout
    step_place_ = tr.env.step_place

    def step(state, r_rel, x):
        s.cur["actions"].append((r_rel, x))
        return step_place_(state, r_rel, x)
    tr.env.step_place = step
    sample_for_update = getattr(X.sample_for_update, "unrecorded",
                                X.sample_for_update)

    def sample(engine_cfg, cfg, replay_cfg, target_fn, ref_net, replay,
               key, alpha, beta, gumbel=None):
        c = s.cur
        c.update(prio_before=replay.prio.clone(), size=replay.size,
                 cursor=replay.cursor, alpha=float(alpha), beta=float(beta),
                 steps=0, grads=None,
                 net={k: v.detach().clone()
                      for k, v in tr.state.net.state_dict().items()},
                 ref={k: v.detach().clone()
                      for k, v in tr.state.ref_net.state_dict().items()})
        out = sample_for_update(engine_cfg, cfg, replay_cfg, target_fn,
                                ref_net, replay, key, alpha, beta, gumbel)
        c.update(idx=out[0], iw=out[1], target=out[2]["target"])
        return out
    sample.unrecorded = sample_for_update
    X.sample_for_update = sample
    named = list(tr.state.net.named_parameters())

    def pre_step(optimizer, args, kwargs):
        c = s.cur
        if "steps" not in c:
            return
        c["steps"] += 1
        if c["grads"] is None:
            c["grads"] = {n: (p.grad.detach().clone() if p.grad is not None
                              else torch.zeros_like(p)) for n, p in named}
            c["adam"] = {n: _adam_state(optimizer.state.get(p))
                         for n, p in named}

    def post_step(optimizer, args, kwargs):
        c = s.cur
        if c.get("steps") == 1:
            c["after"] = {n: p.detach().clone() for n, p in named}
    tr.state.optimizer.register_step_pre_hook(pre_step)
    tr.state.optimizer.register_step_post_hook(post_step)


def _adam_state(state):
    """(steps taken, exp_avg, exp_avg_sq) of one tensor's Adam state, None
    before its first step."""
    if not state:
        return None
    return (int(state["step"]), state["exp_avg"].detach().clone(),
            state["exp_avg_sq"].detach().clone())


def _added_rows(fields, cursor: int, n: int) -> dict:
    """The rows an add of n rows at ``cursor`` writes, and those it writes
    where it wraps to row 0 first: {"at_cursor", "at_0"} of the FIELDS."""
    return {"at_cursor": {f: fields[f][cursor:cursor + n].clone()
                          for f in R.FIELDS},
            "at_0": {f: fields[f][:n].clone() for f in R.FIELDS}}


def _trainer_settings(ctx, config_type) -> dict:
    """The file's ``trainer`` section (the trainer's own settings, such as
    its CUDA graphs); raises where the program's trainer has no such
    setting, so a program without it cannot run the configuration."""
    trainer = dict(ctx.config.get("trainer", {}))
    have = {f.name for f in dataclasses.fields(config_type)}
    missing = sorted(set(trainer) - have)
    if missing:
        raise ValueError(f"the program's {config_type.__name__} has no "
                         f"setting {', '.join(missing)} that the "
                         f"configuration states")
    return trainer


def build(ctx):
    from drl_tetris_tpu_torch.runtime.standalone import (
        StandaloneSIXtenConfig, StandaloneSIXtenTrainer)
    trainer = _trainer_settings(ctx, StandaloneSIXtenConfig)
    fw = _resolved(ctx)
    traffic = ctx.workload["traffic"]
    if traffic["action_space"] != "top_drop":
        raise ValueError("the entry counts top-drop successors")
    cfg = StandaloneSIXtenConfig(
        env=fw.env, model=fw.model, replay=fw.replay,
        n_envs=traffic["n_envs"], horizon=traffic["horizon"],
        train_distribution=fw.train_distribution, epsilon=fw.epsilon,
        action_temperature=fw.action_temperature,
        tau_learning_rate=fw.tau_learning_rate,
        action_space=traffic["action_space"], **trainer)
    s = SimpleNamespace(cur={}, last=None)
    s.trainer = tr = StandaloneSIXtenTrainer(cfg, sixten_cfg=fw.sixten,
                                             device=ctx.device)
    ctx.mark("program built")
    s.weights = draw_weights(ctx, tr.net.state_dict())
    tr.init_params(s.weights)
    tr.key, env_key = ctx.key(), ctx.key()
    tr.env_state = tr.env.reset(env_key)
    ctx.mark("weights and keys")
    fill_replay(ctx, fw.env, fw.replay, tr.replay, traffic)
    synchronize(ctx.device)
    ctx.mark("replay filled")
    s.capacity, s.k = fw.replay.capacity, fw.replay.k_step
    e = fw.env.engine
    n, h = traffic["n_envs"], traffic["horizon"]
    sc = fw.sixten
    n_mb = sc.n_samples_each_update // sc.minibatch_size
    s.per_update = {"target_boards": len(sc.estimator.steps)
                    * sc.n_samples_each_update,
                    "train_samples": n_mb * sc.minibatch_size
                    * sc.n_train_epochs}
    s.successors = n * 4 * e.width * (h + 1)
    _install_recorders(s)
    if ctx.fault is not None:
        ctx.fault(s)
    unit(s)
    s.warm = s.last
    return s


def unit(s) -> dict:
    tr = s.trainer
    n, h = tr.cfg.n_envs, tr.cfg.horizon
    c = s.cur = {"key": tr.key.clone(), "start": tr.env_state, "actions": [],
                 "epsilon": float(tr._hparams().epsilon),
                 "cursor0": tr.replay.cursor, "size0": tr.replay.size}
    tr.train_iteration()
    c["end"] = tr.env_state
    fields = {f: getattr(tr.replay, f) for f in R.FIELDS}
    c["added"] = _added_rows(fields, c["cursor0"], n * h)
    if "idx" in c:
        c["windows"] = R.gather_windows(fields, c["idx"], s.capacity, s.k)
        c["prio_after"] = tr.replay.prio[c["idx"]].clone()
    if not torch.autograd._profiler_enabled():
        s.last = c
    updated = "idx" in c
    return {"env_steps": h * n, "games": n, "ticks": h,
            "dones": int(c["seg"].done.sum()),
            "successor_boards": s.successors,
            "target_boards": s.per_update["target_boards"] * updated,
            "train_samples": s.per_update["train_samples"] * updated}


def _cpu(tree):
    return {k: v.detach().cpu() for k, v in tree.items()}


def _iteration(c) -> dict:
    """One recorded iteration on the CPU."""
    seg = c["seg"]
    return {"net": _cpu(c["net"]), "ref": _cpu(c["ref"]),
            "key": c["key"].cpu(), "start": as_reference_state(c["start"]),
            "end": as_reference_state(c["end"]),
            "r_rel": torch.stack([a[0] for a in c["actions"]]).cpu(),
            "x": torch.stack([a[1] for a in c["actions"]]).cpu(),
            "seg": {f: getattr(seg, f).detach().cpu() for f in SEG_FIELDS},
            "epsilon": c["epsilon"], "alpha": c["alpha"], "beta": c["beta"],
            "cursor0": c["cursor0"], "size0": c["size0"],
            "added": {k: _cpu(v) for k, v in c["added"].items()},
            "cursor": c["cursor"], "size": c["size"],
            "prio_before": c["prio_before"].cpu(),
            "idx": c["idx"].cpu(), "iw": c["iw"].cpu(),
            "target": c["target"].cpu(), "windows": _cpu(c["windows"]),
            "grads": _cpu(c["grads"]), "adam_steps": c["steps"],
            "adam": {k: None if v is None else (v[0], v[1].cpu(), v[2].cpu())
                     for k, v in c["adam"].items()},
            "after": _cpu(c["after"]), "prio_after": c["prio_after"].cpu()}


def record(s) -> dict:
    """The warm iteration (the first update, from the benchmark's weights)
    and the window's last iteration, on the CPU."""
    return {"iterations": [_iteration(s.warm), _iteration(s.last)]}


def _acting_numbers(cfg, net, rec):
    """engine, mask, explore mismatches, the value gap and the choice
    regret (``_choice_regret``) of the recorded segment."""
    W = cfg.engine.width
    seg, r_rel, x = rec["seg"], rec["r_rel"], rec["x"]
    end, states, views = replay_place(cfg, rec["start"], r_rel, x)
    bad = sum(mismatches(views[k], seg[k])
              for k in ("occ", "vec", "piece", "reward", "done"))
    bad += mismatches(r_rel, seg["rot"])
    bad += mismatches(torch.clamp(x, min=0), seg["trans"])
    bad += mismatches(end, rec["end"])
    kroll = rng.split(rng.u32(rec["key"]), 3)[1]
    keys = rng.split(kroll, len(states))
    mask_bad = explore_bad = 0
    value_gaps = [0.0]
    greedy = []
    for t, st in enumerate(states):
        mask, v_next, v_mean = successor_values(cfg.engine, net, st)
        dev = mask.device
        rot = acting_player(st)["rot"].to(dev)
        col = (torch.remainder(r_rel[t].to(dev) + rot, 4) * W
               + x[t].to(dev) + 1).long()
        inside = (col >= 0) & (col < mask.shape[1])
        col = col.clamp(0, mask.shape[1] - 1)
        any_legal = mask.any(1)
        legal = mask.gather(1, col[:, None])[:, 0] & inside
        mask_bad += int((legal_prob(mask).cpu() != seg["prob"][t]).sum())
        mask_bad += int((any_legal & ~legal).sum())
        explores, pick = explore(keys[t], mask, rec["epsilon"])
        explore_bad += int((explores & any_legal & (pick != col)).sum())
        chosen = v_next.gather(1, col[:, None])[:, 0]
        mean = torch.where(mask, v_mean, 0.0).mean(1)
        value_gaps.append(float((seg["v_mean"][t].to(dev) - mean).abs()
                                .max()))
        if bool(legal.any()):
            value_gaps.append(float((seg["v_piece"][t].to(dev) - chosen)[
                legal].abs().max()))
        sel = ~explores & legal
        best = torch.where(mask, v_next, -torch.inf).amax(1)
        uniform = torch.where(mask, v_next, 0.0).sum(1) / mask.sum(1).clamp(
            min=1)
        greedy.append(torch.stack([best, chosen, uniform], 1)[sel])
    return (float(bad), float(mask_bad), float(explore_bad), max(value_gaps),
            _choice_regret(torch.cat(greedy).double()))


def _choice_regret(greedy) -> float:
    """The regret of the choices on the ticks that do not explore, from
    the reference's values (best, chosen, mean over the legal successors)
    of each: best - chosen summed over the ticks, over the same for a
    uniform legal pick (best - mean); 0 where every tick is a tie."""
    best, chosen, uniform = greedy.unbind(1)
    regret = float((best - uniform).sum())
    return float((best - chosen).sum()) / regret if regret > 0 else 0.0


def _grad_gap(prog, ref) -> float:
    """The worst tensor's ||prog - ref|| over the larger of ||ref|| and the
    median tensor's."""
    norms = {n: float(ref[n].double().norm()) for n in ref}
    med = statistics.median(norms.values())
    return max(float((prog[n].double().to(ref[n].device) - ref[n].double()
                      ).norm()) / max(norms[n], med, 1e-30) for n in ref)


def _step_gap(rec, lr: float) -> float:
    """The first Adam step's change of the weights against the reference's
    step (``adam_step``) from the same weights, moments and gradient at
    the configuration's learning rate, as ``_grad_gap`` holds tensors."""
    prog, ref = {}, {}
    for n, g in rec["grads"].items():
        p0 = rec["net"][n]
        state = rec["adam"][n]
        steps, m, v = (0, torch.zeros_like(p0), torch.zeros_like(p0)) \
            if state is None else (state[0], state[1].clone(),
                                   state[2].clone())
        ref[n] = (adam_step(p0, g, m, v, steps + 1, lr) - p0).double()
        prog[n] = (rec["after"][n] - p0).double()
    return _grad_gap(prog, ref)


def _add_mismatches(rec, capacity: int, k: int) -> float:
    """Elements of the rows the iteration's add wrote (fields and
    priorities), and the cursor and size after it, that differ from the
    reference's add of the recorded segment at the recorded cursor."""
    rows = R.add_rows({f: rec["seg"][f] for f in R.FIELDS}, k)
    n = rows["prio"].shape[0]
    start, cursor, size = R.add_place(rec["cursor0"], rec["size0"], n,
                                      capacity, k)
    got = rec["added"]["at_0" if start == 0 else "at_cursor"]
    bad = sum(mismatches(got[f], rows[f]) for f in R.FIELDS)
    bad += mismatches(rec["prio_before"][start:start + n], rows["prio"])
    return float(bad + (cursor != rec["cursor"]) + (size != rec["size"]))


def _numbers(rec, ctx) -> dict:
    """The compared numbers of one recorded iteration."""
    cfg = env_config(ctx.config)
    m, sc, rp = (ctx.config[k] for k in ("model", "sixten", "replay"))
    est = sc["estimator"]
    dev = ctx.device
    board = (cfg.engine.height, cfg.engine.width)
    net = VNet(m, board).to(dev)
    net.load_state_dict(rec["net"])
    engine_bad, mask_bad, explore_bad, value_gap, choice_regret = \
        _acting_numbers(cfg, net, rec)

    n, mb = sc["n_samples_each_update"], sc["minibatch_size"]
    kupd = rng.split(rng.u32(rec["key"]), 3)[2].to(dev)
    ks, kp = rng.split(kupd)
    idx, iw = R.sample(rec["prio_before"].to(dev), rec["size"], n,
                       rec["alpha"], rec["beta"],
                       R.noise(ks, rp["capacity"]), rp["sample_mode"])
    got = rec["idx"].to(dev)
    sample_bad = float((idx != got).sum()) if got.shape == idx.shape \
        else float(n)

    ref_net = VNet(m, board).to(dev)
    ref_net.load_state_dict(rec["ref"])
    win = {k: v.to(dev) for k, v in rec["windows"].items()}
    gamma = -est["gamma"] if est["single_policy"] else est["gamma"]
    steps = list(range(1, est["k_step"] + 1))
    target = kstep_targets(cfg.engine, ref_net, win, steps, gamma,
                           est["lam"], est["truncate_aggregation"])
    target_gap = float((rec["target"].to(dev) - target).abs().max())

    rows = rng.permutation(rng.split(kp, 1)[0], n)[:mb]
    grads, prios = gradient(cfg.engine, sc["nn_regularizer"], net,
                            win["occ"][rows, 0], win["vec"][rows, 0],
                            win["piece"][rows], target[rows], iw[rows])
    prio_gap = float((rec["prio_after"].to(dev)[rows] - prios).abs().max())
    return {"engine_mismatches": engine_bad, "mask_mismatches": mask_bad,
            "explore_mismatches": explore_bad, "value_gap": value_gap,
            "choice_regret": choice_regret,
            "add_mismatches": _add_mismatches(rec, rp["capacity"],
                                              rp["k_step"]),
            "sample_mismatches": sample_bad, "target_gap": target_gap,
            "grad_gap": _grad_gap(rec["grads"], grads),
            "prio_gap": prio_gap,
            "step_gap": _step_gap(rec, sc["lr"]),
            "adam_step_mismatch": float(abs(rec["adam_steps"] - n // mb)),
            "adam_steps": float(rec["adam_steps"])}


def judge(rec, ctx) -> dict:
    """Each number over the recorded iterations: counts summed, the others
    at their widest (``WARM_ONLY``'s the first iteration's), and each
    iteration's apart (``<name>.<i>``)."""
    ieee_float32()
    if ctx.config["sixten"]["n_train_epochs"] != 1:
        raise ValueError("the judge holds the priorities of an update of "
                         "one epoch")
    per = [_numbers(it, ctx) for it in rec["iterations"]]
    out = {}
    for k in per[0]:
        vals = [p[k] for p in per]
        if k.endswith(COUNTS):
            out[k] = sum(vals)
            continue
        out[k] = vals[0] if k in WARM_ONLY else max(vals)
        if len(per) > 1:
            out.update({f"{k}.{i}": v for i, v in enumerate(vals)})
    return out


def control_record(ctx, precision: str = "fp8") -> dict:
    """The reference one precision step below the configuration's in the
    program's place (the towers at ``precision``): the set-up's inputs
    drawn as ``build`` draws them, then one iteration of its own from its
    games' reset: its choices, its segment into the replay, its sample,
    its targets, its first minibatch's gradient and priorities."""
    ieee_float32()
    fw = _resolved(ctx)
    traffic = ctx.workload["traffic"]
    cfg = env_config(ctx.config)
    m, sc = ctx.config["model"], ctx.config["sixten"]
    est = sc["estimator"]
    dev = ctx.device
    board = (cfg.engine.height, cfg.engine.width)
    W = cfg.engine.width
    net = VNet(m, board, precision).to(dev)
    weights = draw_weights(ctx, net.state_dict())
    net.load_state_dict(weights)
    key, env_key = ctx.key(), ctx.key()
    from drl_tetris_tpu_torch.algos.replay import replay_init
    from drl_tetris_tpu_torch.config.parameter import param_eval
    port_replay = replay_init(fw.replay, dev)
    fill_replay(ctx, fw.env, fw.replay, port_replay, traffic)
    rep = {f: getattr(port_replay, f) for f in R.FIELDS + ("prio",)}
    rep.update(cursor=port_replay.cursor, size=port_replay.size)
    del port_replay

    n_envs, h = traffic["n_envs"], traffic["horizon"]
    eps = float(param_eval(fw.epsilon, 0))
    start = state = reset(cfg, env_key.cpu(), n_envs, "cpu")
    k0 = rng.u32(key.cpu())
    _, kroll, kupd = rng.split(k0, 3)
    keys = rng.split(kroll, h)
    ticks, actions = [], []
    for t in range(h):
        mask, v_next, v_mean = successor_values(cfg.engine, net, state)
        explores, pick = explore(keys[t], mask, eps)
        choice = choose(mask, v_next, explores, pick)
        v_sel = v_next.gather(1, choice[:, None])[:, 0]
        v_sel = torch.where(mask.any(1), v_sel, 0.0).cpu()
        v_mean = torch.where(mask, v_mean, 0.0).mean(1).cpu()
        choice = choice.cpu()
        rot = acting_player(state)["rot"]
        r_rel = torch.remainder(choice // W - rot, 4).to(torch.int32)
        x = (choice % W - 1).to(torch.int32)
        obs = observe(cfg.engine, state.engine, state.current_player)
        view = {"occ": perspective_occ(state), "vec": obs.vec,
                "piece": obs.piece[:, 0], "rot": r_rel,
                "trans": torch.clamp(x, min=0),
                "prob": legal_prob(mask).cpu(), "v_piece": v_sel,
                "v_mean": v_mean}
        state, view["reward"], view["done"] = step_place(cfg, state, r_rel,
                                                         x)
        ticks.append(view)
        actions.append((r_rel, x))
    seg = {k: torch.stack([v[k] for v in ticks]) for k in ticks[0]}
    cursor0, size0 = rep["cursor"], rep["size"]
    R.add_segment(rep, {k: v.to(dev) for k, v in seg.items()},
                  fw.replay.capacity, fw.replay.k_step)
    added = _added_rows(rep, cursor0, n_envs * h)
    alpha = float(param_eval(fw.sixten.alpha, n_envs * h))
    beta = float(param_eval(fw.sixten.beta, n_envs * h))
    prio_before = rep["prio"].clone()
    n, mb = sc["n_samples_each_update"], sc["minibatch_size"]
    ks, kp = rng.split(kupd.to(dev))
    idx, iw = R.sample(prio_before, rep["size"], n, alpha, beta,
                       R.noise(ks, fw.replay.capacity),
                       fw.replay.sample_mode)
    win = R.gather_windows(rep, idx, fw.replay.capacity, fw.replay.k_step)
    gamma = -est["gamma"] if est["single_policy"] else est["gamma"]
    target = kstep_targets(cfg.engine, net, win,
                           list(range(1, est["k_step"] + 1)), gamma,
                           est["lam"], est["truncate_aggregation"])
    rows = rng.permutation(rng.split(kp, 1)[0], n)[:mb]
    grads, prios = gradient(cfg.engine, sc["nn_regularizer"], net,
                            win["occ"][rows, 0], win["vec"][rows, 0],
                            win["piece"][rows], target[rows], iw[rows])
    prio_after = prio_before[idx]
    prio_after[rows] = prios
    after = {k: adam_step(weights[k], g, torch.zeros_like(g),
                          torch.zeros_like(g), 1, sc["lr"])
             for k, g in grads.items()}
    return {"iterations": [{
        "net": _cpu(weights), "ref": _cpu(weights), "key": k0,
        "start": start, "end": state,
        "r_rel": torch.stack([a[0] for a in actions]),
        "x": torch.stack([a[1] for a in actions]),
        "seg": {f: seg[f] for f in SEG_FIELDS}, "epsilon": eps,
        "alpha": alpha, "beta": beta, "cursor0": cursor0, "size0": size0,
        "added": {k: _cpu(v) for k, v in added.items()},
        "cursor": rep["cursor"], "size": rep["size"],
        "prio_before": prio_before.cpu(), "idx": idx.cpu(), "iw": iw.cpu(),
        "target": target.cpu(), "windows": _cpu(win), "grads": _cpu(grads),
        "adam_steps": (n // mb) * sc["n_train_epochs"],
        "adam": {k: None for k in grads}, "after": _cpu(after),
        "prio_after": prio_after.cpu()}]}


def _state_unchanged(s):
    """The env step hands back the state it was given."""
    step = s.trainer.env.step_place

    def stuck(state, r_rel, x):
        _, reward, done = step(state, r_rel, x)
        return state, reward, done
    s.trainer.env.step_place = stuck


def _rotation_masked(s):
    """The placement masks leave out every placement of rotation 1."""
    from drl_tetris_tpu_torch.algos.sixten import make_sixten_rollout
    from drl_tetris_tpu_torch.config.parameter import param_eval
    from drl_tetris_tpu_torch.engine import masks as M
    boards = M.placement_boards

    def masked(cfg, occ, garb, piece, cur_rot):
        mask, after, cleared = boards(cfg, occ, garb, piece, cur_rot)
        mask = mask.clone()
        mask[:, 1] = False
        return mask, after, cleared
    M.placement_boards = masked
    tr = s.trainer
    s.rollout = make_sixten_rollout(
        tr.env, tr.net, tr.cfg.horizon,
        distribution=tr.cfg.train_distribution,
        epsilon=param_eval(tr.cfg.epsilon), action_space=tr.cfg.action_space,
        cuda_graphs=tr.cfg.cuda_graphs)
    return lambda: setattr(M, "placement_boards", boards)


def _half_minibatches(s):
    """The update takes every other minibatch of its epochs."""
    from drl_tetris_tpu_torch.algos import sixten as X
    indices = X.minibatch_indices

    def half(cfg, n, key):
        return indices(cfg, n, key)[:, ::2]
    X.minibatch_indices = half
    return lambda: setattr(X, "minibatch_indices", indices)


def _prios_kept(s):
    """The new priorities are not written back."""
    from drl_tetris_tpu_torch.algos import sixten as X
    update = X.replay_update_prios
    X.replay_update_prios = lambda st, idx, new: st
    return lambda: setattr(X, "replay_update_prios", update)


def _online_targets(s):
    """The targets go through the online net instead of the reference
    net."""
    from drl_tetris_tpu_torch.algos import sixten as X
    sample = X.sample_for_update

    def online(engine_cfg, cfg, replay_cfg, target_fn, ref_net, replay, key,
               alpha, beta, gumbel=None):
        return sample(engine_cfg, cfg, replay_cfg, target_fn,
                      s.trainer.state.net, replay, key, alpha, beta, gumbel)
    X.sample_for_update = online
    return lambda: setattr(X, "sample_for_update", sample)


def _worst_choice(s):
    """The search picks the worst legal successor: the rollout's net gives
    -V (the recorded values are then -V too)."""
    from drl_tetris_tpu_torch.algos.sixten import make_sixten_rollout
    from drl_tetris_tpu_torch.config.parameter import param_eval
    tr = s.trainer

    class Negated(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, vec, vis):
            return -self.net(vec, vis)
    s.rollout = make_sixten_rollout(
        tr.env, Negated(tr.net), tr.cfg.horizon,
        distribution=tr.cfg.train_distribution,
        epsilon=param_eval(tr.cfg.epsilon), action_space=tr.cfg.action_space,
        cuda_graphs=tr.cfg.cuda_graphs)


def _add_skipped(s):
    """The segment is not written into the replay."""
    from drl_tetris_tpu_torch.runtime import standalone
    add = standalone.replay_add_segment
    standalone.replay_add_segment = lambda cfg, st, seg, horizon: st
    return lambda: setattr(standalone, "replay_add_segment", add)


def _weights_unchanged(s):
    """Adam's steps leave the weights as they were (learning rate 0; the
    moments still move)."""
    for g in s.trainer.state.optimizer.param_groups:
        g["lr"] = 0.0


def _window_shifted(s):
    """The k-step windows start one row after the sampled row."""
    from drl_tetris_tpu_torch.algos import sixten as X
    gather = X.replay_gather_windows

    def shifted(cfg, st, idx):
        return gather(cfg, st, torch.clamp(idx + 1, max=cfg.capacity - 1))
    X.replay_gather_windows = shifted
    return lambda: setattr(X, "replay_gather_windows", gather)


FAULTS = {"state_unchanged": _state_unchanged,
          "rotation_masked": _rotation_masked,
          "half_minibatches": _half_minibatches,
          "prios_kept": _prios_kept, "online_targets": _online_targets,
          "window_shifted": _window_shifted, "worst_choice": _worst_choice,
          "add_skipped": _add_skipped,
          "weights_unchanged": _weights_unchanged}
