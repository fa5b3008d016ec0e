"""Command-line entry points of the port.

Counterpart of ``drl_tetris_tpu/cli/main.py`` (reference: the scripts layer,
scripts/trainer_runscript.py, eval.py, print_settings.py):

  python -m drl_tetris_tpu_torch train          # standalone self-play PPO/DQN
  python -m drl_tetris_tpu_torch eval CKPT [CKPT...]   # round-robin
  python -m drl_tetris_tpu_torch print-config   # resolved settings dump

Every verb takes ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions).  Checkpoints are the port's own (runtime/checkpoint.py); a JAX
run's checkpoint comes across with tools/torch_import_flax_checkpoint.py.

``train`` runs SVENton-PPO (with league-pool opponents, ``--pool-seed``
and reward shapers from the settings) and SVENton-DQN (``--presets default
sventon sventon_dqn ...``), each also as dual-policy training (``--set
single_policy=false``: two policies against each other, checkpoints hold
policy 0, as the JAX CLI's; ``--resume``, ``--init-from`` and
``--pool-seed`` are refused there), with any of the four architectures
(``--set architecture=silver|vanilla|keyboard|dreamer``); ``eval`` mixes
PPO and DQN checkpoints of any architecture.

Not ported yet, each exits with a message naming its ROADMAP item:
``train --distributed/--multihost`` and the verbs ``kv``, ``worker``,
``trainer``, ``up`` (14); the flavours ``sixten`` and ``sherlock`` (11,
13); ``play`` (15); ``bench`` (10).
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import shlex
import sys
import time

NOT_PORTED = {
    "kv": "ROADMAP 14 (distributed runtime)",
    "worker": "ROADMAP 14 (distributed runtime)",
    "trainer": "ROADMAP 14 (distributed runtime)",
    "up": "ROADMAP 14 (distributed runtime)",
    "play": "ROADMAP 15 (the ANSI renderer)",
    "bench": "ROADMAP 10 (the port-side bench)",
}


def _add_common(p):
    from drl_tetris_tpu_torch.config.presets import CLI_PRESETS
    p.add_argument("--presets", nargs="*", default=list(CLI_PRESETS),
                   help="preset layering, applied in order (tools/utils.py:34-45)")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="overrides, e.g. --set gamma=0.99 minibatch_size=128")
    p.add_argument("--run-id", default="run")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run ('cpu' runs the plain "
                        "versions)")


def _parse_overrides(pairs):
    out = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        try:
            val = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
            continue
        if isinstance(val, (dict, list)):
            # revive __kind__-tagged values (Parameter schedules,
            # CompressorConfig) with the settings side-file codec, so
            # e.g. a scheduled lr is expressible from the command line:
            # --set 'value_lr={"__kind__":"LinearParameter",
            #                  "init_val":4e-4,"final_val":1.2e-4,
            #                  "time_horizon":10000000}'
            from drl_tetris_tpu_torch.runtime.checkpoint import _dec
            val = _dec(val)
        out[k] = val
    return out


def _load_cfg(args):
    from drl_tetris_tpu_torch.config.presets import load
    return load(args.presets, _parse_overrides(args.set), run_id=args.run_id)


_HEADLINE_KEYS = ("losses/total_loss", "losses/policy_loss",
                  "losses/value_loss", "entropy/entropy",
                  "misc/clip_saturation", "tot_loss", "value_loss", "q_val")


def _headline(stats):
    picked = [(k, stats[k]) for k in _HEADLINE_KEYS if k in stats]
    if not picked:
        picked = list(stats.items())[:4]
    return "  ".join(f"{k.split('/')[-1]}={float(v):.4f}" for k, v in picked[:5])


def cmd_train(args):
    if args.distributed or args.multihost:
        raise SystemExit("train --distributed/--multihost: not ported yet, "
                         "see ROADMAP 14 (distributed runtime)")
    if args.experiment:
        # batch runs from the experiment schedule: presets + cumulative
        # patches -> one run per patch with distinct run-ids
        # (tools/experiment_schedule.py:3-40, trainer_runscript.py:19-23)
        from drl_tetris_tpu_torch.config.schedule import (
            EXPERIMENTS, experiment_schedule)
        exps = []
        for name in args.experiment:
            if name not in EXPERIMENTS:
                raise SystemExit(
                    f"unknown experiment {name!r}; "
                    f"known: {sorted(EXPERIMENTS)}")
            exps.append(EXPERIMENTS[name])
        for cfg in experiment_schedule(exps, only_last=args.only_last,
                                       overrides=_parse_overrides(args.set)):
            print(f"=== experiment run: {cfg.run_id} ===", flush=True)
            _train_one(cfg, args)
        return
    _train_one(_load_cfg(args), args)


def _check_trainable(cfg, args):
    """What the port's trainers run: PPO and DQN, single- or
    dual-policy; a dual run has no resume, warm start or seeded pool."""
    if cfg.flavour in ("sixten", "sherlock"):
        raise SystemExit(f"flavour {cfg.flavour!r} waits for ROADMAP 13 "
                         "(and its placement masks, ROADMAP 11)")
    if cfg.flavour not in ("ppo", "dqn"):
        raise SystemExit(f"unknown flavour {cfg.flavour!r}")
    if cfg.ppo.single_policy:
        return
    if args.resume:
        raise SystemExit("--resume supports the single-state trainers "
                         "(ppo/dqn); dual-policy checkpoints persist "
                         "policy 0 only")
    if args.init_from:
        raise SystemExit("--init-from: a dual-policy run starts both "
                         "policies fresh; a checkpoint holds one policy "
                         "and cannot warm-start two")
    if args.pool_seed:
        raise SystemExit("--pool-seed requires pool_prob > 0, which "
                         "dual-policy training does not have")


def _make_shaper(cfg):
    """The settings' reward shaper ("reward_shaper" and
    "reward_shaper_param", experiments/sventon_base.py:61-62), its amount
    evaluated at t = 0 as the JAX CLI does; None for none."""
    from drl_tetris_tpu_torch.algos.reward_shapers import make_shaper
    from drl_tetris_tpu_torch.config.parameter import param_eval
    name = cfg.settings.get("reward_shaper")
    if not name or name == "none":
        return None
    amount = float(param_eval(cfg.settings.get("reward_shaper_param", 0.0)))
    try:
        return make_shaper(name, amount, cfg.ppo.single_policy)
    except ValueError as e:
        raise SystemExit(str(e))


def _run_settings(cfg, args, n_envs, horizon):
    """The settings side-file saved next to checkpoints, extended with the
    actual run geometry so a checkpoint dir alone reproduces its run
    (the reference's side-file reconstructs the agent,
    sventon_agent_base.py:128-129, tools/utils.py:54-64; this also records
    the command)."""
    s = dict(cfg.settings)
    s["n_envs_per_thread"] = n_envs            # the value actually trained
    s["run_geometry"] = {
        "run_id": cfg.run_id, "flavour": cfg.flavour,
        "n_envs": n_envs, "horizon": horizon,
        "total_steps": args.steps, "seed": args.seed,
        "save_every": args.save_every, "league_every": args.league_every,
        "init_from": args.init_from,
        "pool_seed": list(args.pool_seed or []),
        "command": "python -m drl_tetris_tpu_torch "
                   + " ".join(shlex.quote(a) for a in sys.argv[1:]),
    }
    return s


def _make_trainer(cfg, args):
    """The standalone trainer of ``cfg``'s flavour on ``args.device``."""
    from drl_tetris_tpu_torch.runtime import standalone as S
    n_envs = args.n_envs or cfg.n_envs
    s = cfg.settings
    if not cfg.ppo.single_policy:
        # two policies against each other (worker.py:157-192), gated by
        # their win rate
        gate = dict(winrate_lr=s.get("winrate_learningrate", 0.02),
                    winrate_tolerance=s.get("winrate_tolerance", 0.1))
        if cfg.flavour == "dqn":
            return S.DualPolicyDQNTrainer(S.DualPolicyDQNConfig(
                env=cfg.env, model=cfg.model, dqn=cfg.dqn, replay=cfg.replay,
                n_envs=n_envs, horizon=args.horizon,
                train_distribution=cfg.train_distribution, seed=args.seed,
                epsilon=cfg.epsilon,
                action_temperature=cfg.action_temperature,
                tau_learning_rate=cfg.tau_learning_rate, **gate),
                device=args.device)
        return S.DualPolicyTrainer(S.DualPolicyConfig(
            env=cfg.env, model=cfg.model, ppo=cfg.ppo, n_envs=n_envs,
            horizon=args.horizon, seed=args.seed, **gate),
            device=args.device)
    if cfg.flavour == "dqn":
        scfg = S.StandaloneDQNConfig(
            env=cfg.env, model=cfg.model, dqn=cfg.dqn, replay=cfg.replay,
            n_envs=n_envs, horizon=args.horizon,
            train_distribution=cfg.train_distribution, seed=args.seed,
            epsilon=cfg.epsilon, action_temperature=cfg.action_temperature,
            tau_learning_rate=cfg.tau_learning_rate)
        return S.StandaloneDQNTrainer(scfg, device=args.device)
    scfg = S.StandaloneConfig(
        env=cfg.env, model=cfg.model, ppo=cfg.ppo, n_envs=n_envs,
        horizon=args.horizon, seed=args.seed,
        # raw (possibly scheduled) value_lr: re-evaluated per iteration
        lr_schedule=s.get("value_lr"),
        pool_prob=float(s.get("pool_prob", 0.0)),
        pool_size=int(s.get("pool_size", 4)),
        pool_every=int(s.get("pool_every", 0)),
        pool_mode=str(s.get("pool_mode", "uniform")),
        pool_wr_lr=float(s.get("pool_wr_lr", 0.05)),
        reward_shaper=_make_shaper(cfg))
    return S.StandaloneTrainer(scfg, device=args.device)


def _train_one(cfg, args):
    from drl_tetris_tpu_torch.runtime import checkpoint as ckpt
    from drl_tetris_tpu_torch.runtime.evaluate import EvalAgent
    from drl_tetris_tpu_torch.utils.metrics import MetricsWriter, timekeeper

    _check_trainable(cfg, args)
    ckpt_dir = os.path.join(args.data_dir, "models", cfg.run_id)
    metrics_dir = os.path.join(args.data_dir, "summaries")
    if args.pool_seed and (cfg.flavour != "ppo" or float(
            cfg.settings.get("pool_prob", 0.0)) <= 0):
        raise SystemExit("--pool-seed requires the PPO trainer with "
                         "pool_prob > 0 (--set pool_prob=...)")
    tr = _make_trainer(cfg, args)

    resumed_from = None
    if args.resume:
        # Crash/preemption recovery: the learner's state from the run's
        # own latest checkpoint, the step count continued from there and
        # the key chain moved past the opening segment; the env resets and
        # a DQN run's replay restarts empty.
        latest = ckpt.latest_step(ckpt_dir)
        if latest is None:
            print(f"[resume] no checkpoint in {ckpt_dir}; starting fresh",
                  flush=True)
        else:
            tr.resume(ckpt.restore_raw(ckpt_dir, latest), latest)
            resumed_from = latest
            print(f"[resume] restored {ckpt_dir} @ step {latest:,}",
                  flush=True)

    if args.init_from and resumed_from is not None:
        # --resume already restored this run's own later state; re-applying
        # the warm start would clobber the progress made since it.
        print(f"[init] --init-from skipped (resumed @ {resumed_from:,})",
              flush=True)
    elif args.init_from:
        # Warm start: a checkpoint's params into the fresh trainer; Adam
        # restarts (sventon_agent_base.py:116-145).
        raw = ckpt.restore_raw(args.init_from)
        tr.init_params(raw.get("params", raw))
        print(f"[init] params restored from {args.init_from}", flush=True)

    for path in args.pool_seed:
        # external frozen opponents, played from iteration 0 at pool_prob
        raw = ckpt.restore_raw(path)
        tr.seed_pool(raw.get("params", raw))
        print(f"[pool] seeded opponent from {path}", flush=True)

    league = None
    if args.league_every:
        from drl_tetris_tpu_torch.runtime.league import (TrainingLeague,
                                                         random_anchor)
        anchors = [_load_agent(path, cfg, device=tr.device,
                               name=os.path.basename(path.rstrip("/")))[0]
                   for path in args.league_anchor]
        league = TrainingLeague(cfg.env, random_anchor(tr.net),
                                out_dir=ckpt_dir,
                                games_per_pair=args.league_games,
                                fixed_anchors=anchors)
        if resumed_from is not None:
            # Re-seed the rolling pool from the run's own saved snapshots,
            # so the resumed segment keeps playing its recent past (the
            # cumulative cross-table is not rebuilt: elo_history.jsonl
            # carries both segments).
            steps = [s for s in ckpt.all_steps(ckpt_dir) if s <= resumed_from]
            for s in steps[-4:]:
                raw = ckpt.restore_raw(ckpt_dir, step=s)
                net = _new_net(cfg, tr.device).load_params_(
                    raw.get("params", raw))
                league.pool.append(EvalAgent(
                    name=f"step_{s}", net=net.eval(),
                    distribution=league.distribution, kind=league.kind))
                league.history.steps[f"step_{s}"] = s
            if steps:
                print(f"[resume] league pool re-seeded from snapshots "
                      f"{steps[-4:]}", flush=True)

    def league_tick(it, total):
        if league is None or it % args.league_every:
            return
        # The league is telemetry: a transient failure must not kill a
        # long training run.  Retry with backoff, then skip the tick.
        for attempt in range(3):
            try:
                ratings = league.evaluate(tr.net, total, seed=args.seed + it)
                break
            except Exception as e:  # noqa: BLE001 (deliberately broad)
                print(f"[league] eval failed (attempt {attempt + 1}/3): "
                      f"{str(e).splitlines()[0][:200]}", flush=True)
                time.sleep(5.0 * (attempt + 1))
        else:
            print(f"[league] step {total:,}: SKIPPED after 3 failures",
                  flush=True)
            return
        latest = ratings.get(f"step_{total}", 0.0)
        print(f"[league] step {total:,}: elo={latest:.1f}  "
              + " ".join(f"{k}={v:.0f}" for k, v in
                         sorted(ratings.items())), flush=True)

    n_envs, horizon = tr.cfg.n_envs, tr.cfg.horizon
    steps_per_iter = n_envs * horizon
    run_settings = _run_settings(cfg, args, n_envs, horizon)
    with MetricsWriter(metrics_dir, cfg.run_id) as mw:
        it = 0
        while tr.total_steps < args.steps:
            t0 = time.time()
            with timekeeper.section("train_iteration"):
                stats = tr.train_iteration()
            it += 1
            if stats:
                mw.update(stats, tr.total_steps)
            if it % args.log_every == 0:
                sps = steps_per_iter / max(time.time() - t0, 1e-9)
                print(f"[{tr.total_steps:>12,} steps] {sps:,.0f} sps  "
                      + _headline(stats), flush=True)
            if it % args.save_every == 0:
                with timekeeper.section("checkpoint"):
                    ckpt.save(ckpt_dir, tr.total_steps, tr.state_dict(),
                              settings=run_settings)
            league_tick(it, tr.total_steps)
        ckpt.save(ckpt_dir, tr.total_steps, tr.state_dict(),
                  settings=run_settings)
    print(timekeeper.table())


def _new_net(cfg, device):
    """An untrained full net of ``cfg``'s flavour (QNet for dqn, else
    PPONet) for its model and board."""
    from drl_tetris_tpu_torch.models.nets import PPONet, QNet
    e = cfg.env.engine
    cls = QNet if cfg.flavour == "dqn" else PPONet
    return cls(cfg.model, board=(e.height, e.width), full_network=True,
               device=device)


def _load_agent(path, cfg, device=None, name=None):
    """Build an EvalAgent from a checkpoint, reconstructing it from the
    settings side-file saved next to the weights (the reference's
    weights<->settings pairing, eval.py:99-104, tools/utils.py:47-52), so
    tournaments can mix flavours (PPONet and QNet) and model sizes.
    ``random`` is a net with fresh weights (the JAX package draws them from
    PRNGKey(0); the port from a torch.Generator seeded with 0)."""
    import torch

    from drl_tetris_tpu_torch.runtime import checkpoint as ckpt
    from drl_tetris_tpu_torch.runtime.evaluate import EvalAgent

    if path != "random":
        s = ckpt.load_settings(path)
        if s is not None:
            from drl_tetris_tpu_torch.config.presets import resolve
            try:
                cfg = resolve(s, run_id=cfg.run_id)
            except Exception as e:
                print(f"warning: {path}: unusable settings side-file ({e}); "
                      "using CLI presets", file=sys.stderr)
    if cfg.flavour in ("sixten", "sherlock"):
        raise SystemExit(f"{path}: {cfg.flavour} agents are not ported yet "
                         "(ROADMAP 11, 13)")
    net = _new_net(cfg, device)
    if path == "random":
        net.init_flax_(torch.Generator().manual_seed(0))
    else:
        raw = ckpt.restore_raw(path)
        net.load_params_(raw.get("params", raw))
    net.eval().requires_grad_(False)
    return EvalAgent(name=name or os.path.basename(path.rstrip("/")),
                     net=net, distribution=cfg.eval_distribution), cfg


def _check_compat(cfgs):
    """game_size compatibility across tournament entrants
    (tools/utils.py:54-64)."""
    sizes = {(c.env.engine.height, c.env.engine.width) for c in cfgs}
    if len(sizes) > 1:
        raise SystemExit(f"incompatible game sizes between entrants: {sizes}")


def cmd_eval(args):
    from drl_tetris_tpu_torch.runtime.evaluate import round_robin
    from drl_tetris_tpu_torch.utils.elo import elo_table, fit_elo

    def load_all():
        cli_cfg = _load_cfg(args)
        loaded = [_load_agent(p, cli_cfg, device=args.device)
                  for p in args.checkpoints]
        if len(loaded) == 1:
            loaded.append(_load_agent("random", loaded[0][1],
                                      device=args.device, name="random"))
        _check_compat([c for _, c in loaded])
        return [a for a, _ in loaded], loaded[0][1]

    rnd = 0
    while True:
        # per-round weight reload: spectate a live training run
        # (eval.py:196-205 --reload)
        agents, cfg = load_all()
        board = round_robin(cfg.env, agents, games_per_pair=args.games,
                            seed=args.seed + rnd)
        print(board.score_table())
        print("\nDraws (games undecided at the tick limit):")
        for a, b in itertools.combinations(board.players, 2):
            print(f"  {a} vs {b}: {board.draws[(a, b)]}")
        print("\nElo (Bradley-Terry MLE):")
        print(elo_table(fit_elo(board)), flush=True)
        if not args.reload:
            return
        rnd += 1
        print(f"\n[reload] round {rnd}: reloading weights...", flush=True)
        time.sleep(args.reload)


def cmd_print_config(args):
    if args.diff:
        return _print_config_diff(*args.diff)
    cfg = _load_cfg(args)
    print(f"# presets: {args.presets}")
    for section in ("env", "model", "ppo", "dqn", "replay"):
        print(f"\n[{section}]")
        print(dataclasses.asdict(getattr(cfg, section)))
    print("\n[merged settings]")
    for k in sorted(cfg.settings):
        print(f"  {k:<36} {cfg.settings[k]!r}")


def _print_config_diff(path_a, path_b):
    """Diff two settings side-files (checkpoint dirs or settings.json
    paths), tools/settings_printer.py:25-36."""
    from drl_tetris_tpu_torch.runtime.checkpoint import load_settings

    def load_one(p):
        if p.endswith(".json"):
            p = os.path.dirname(p) or "."
        s = load_settings(p)
        if s is None:
            raise SystemExit(f"no settings side-file found for {p}")
        return s

    a, b = load_one(path_a), load_one(path_b)
    keys = sorted(set(a) | set(b))
    same = True
    for k in keys:
        va, vb = a.get(k, "<absent>"), b.get(k, "<absent>")
        if va != vb:
            same = False
            print(f"  {k:<36} {va!r:<28} != {vb!r}")
    if same:
        print("settings are identical")


def cmd_not_ported(args):
    raise SystemExit(f"{args.cmd}: not ported yet, see "
                     f"{NOT_PORTED[args.cmd]}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="drl_tetris_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="self-play training (PPO or DQN, "
                       "standalone)")
    _add_common(t)
    t.add_argument("--steps", type=int, default=10_000_000)
    t.add_argument("--experiment", nargs="*", default=[],
                   help="named experiment(s) from config/schedule.py: one "
                        "run per cumulative patch")
    t.add_argument("--only-last", action="store_true",
                   help="run only the last patch of the schedule")
    t.add_argument("--n-envs", type=int, default=0)
    t.add_argument("--horizon", type=int, default=72)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--log-every", type=int, default=1)
    t.add_argument("--save-every", type=int, default=50)
    t.add_argument("--league-every", type=int, default=0,
                   help="every N iterations, play the current snapshot "
                        "against past snapshots + a random anchor and refit "
                        "Elo ratings (writes elo_history.jsonl)")
    t.add_argument("--league-games", type=int, default=16)
    t.add_argument("--league-anchor", action="append", default=[],
                   metavar="CHECKPOINT",
                   help="external checkpoint(s) added to the league as "
                        "permanent fixed entrants (repeatable)")
    t.add_argument("--resume", action="store_true",
                   help="continue this run-id from its latest checkpoint "
                        "(params, Adam state and step count; the env "
                        "resets); no-op if the run dir is empty")
    t.add_argument("--init-from", default=None, metavar="CHECKPOINT",
                   help="warm start: this checkpoint's params into the "
                        "fresh trainer (Adam restarts)")
    t.add_argument("--pool-seed", action="append", default=[],
                   metavar="CHECKPOINT",
                   help="pre-seed the league-pool opponents with this "
                        "checkpoint's net (repeatable; needs pool_prob > 0)")
    t.add_argument("--distributed", action="store_true",
                   help="not ported yet (ROADMAP 14)")
    t.add_argument("--multihost", action="store_true",
                   help="not ported yet (ROADMAP 14)")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="round-robin tournament between checkpoints")
    _add_common(e)
    e.add_argument("checkpoints", nargs="+")
    e.add_argument("--games", type=int, default=16)
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--reload", type=float, default=0.0, metavar="SECONDS",
                   help="re-run forever, reloading weights between rounds "
                        "(spectate a live training run, eval.py:196-205)")
    e.set_defaults(fn=cmd_eval)

    c = sub.add_parser("print-config", help="dump the resolved configuration")
    _add_common(c)
    c.add_argument("--diff", nargs=2, metavar=("A", "B"),
                   help="diff two settings side-files (checkpoint dirs), "
                        "settings_printer.py:25-36")
    c.set_defaults(fn=cmd_print_config)

    for name, item in NOT_PORTED.items():
        n = sub.add_parser(name, help=f"not ported yet ({item})")
        n.add_argument("rest", nargs=argparse.REMAINDER)
        n.set_defaults(fn=cmd_not_ported)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
