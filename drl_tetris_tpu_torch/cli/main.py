"""Command-line entry points of the port.

Counterpart of ``drl_tetris_tpu/cli/main.py`` (reference: the scripts layer,
scripts/trainer_runscript.py, worker_runscript.py, eval.py,
print_settings.py):

  python -m drl_tetris_tpu_torch train          # standalone self-play
  python -m drl_tetris_tpu_torch train --distributed   # data-parallel PPO
  python -m drl_tetris_tpu_torch eval CKPT [CKPT...]   # round-robin
  python -m drl_tetris_tpu_torch play [CKPT [CKPT]]    # watch a game
  python -m drl_tetris_tpu_torch print-config   # resolved settings dump
  python -m drl_tetris_tpu_torch bench          # throughput benchmark
  python -m drl_tetris_tpu_torch kv | worker | trainer | up
                                                # the process runtime

Every verb that runs the engine or a net takes ``--device`` (default
``cuda``; ``cpu`` runs the plain versions).  Checkpoints are the port's own
(runtime/checkpoint.py); a JAX run's checkpoint comes across with
tools/torch_import_flax_checkpoint.py.

``train`` runs SVENton-PPO (with league-pool opponents, ``--pool-seed``
and reward shapers from the settings) and SVENton-DQN (``--presets default
sventon sventon_dqn ...``), each also as dual-policy training (``--set
single_policy=false``: two policies against each other, checkpoints hold
policy 0, as the JAX CLI's; ``--resume``, ``--init-from`` and
``--pool-seed`` are refused there), with any of the four architectures
(``--set architecture=silver|vanilla|keyboard|dreamer``); SIXten
(``--presets default sventon sventon_dqn experiment_sixten``) and Sherlock
(``--presets default sventon sherlock``), each in the top-drop or the full
placement space (``--set sixten_action_space=full`` /
``sherlock_action_space=full``).  ``eval`` mixes checkpoints of every
flavour and architecture.

``train --distributed`` trains single-policy PPO data-parallel over a
``torch.distributed`` process group (parallel/mesh.py): world size 1 on
one card, or one rank per host with ``--multihost --coordinator HOST:PORT
--num-hosts N --host-id I`` (NCCL on the card, gloo on the CPU).  Unlike
the JAX CLI, which trains PPO on its mesh whatever the flavour, it refuses
any other flavour and ``single_policy=false``.

The process runtime (runtime/runner.py): ``kv`` runs the tetrikv store,
``worker`` and ``trainer`` its roles, ``up`` the store, a trainer and N
workers as local processes (``--chaos S`` stops worker 0 and starts a
replacement that must reclaim its slot and recover its state).  Unlike
the JAX roles, which default to the CPU, every role runs on ``--device``
(default the card), and ``up`` passes its own to each: on one card the
trainer and the workers share it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import shlex
import sys
import time

def _startup_s() -> float:
    """Seconds since this process started (Linux's /proc): a role's
    start-up time, interpreter, imports and model build included."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


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
    if args.multihost or args.distributed:
        return _train_data_parallel(args)
    _train_runs(args)


def _train_runs(args):
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


def _train_data_parallel(args):
    """``train --distributed``: the process group (one rank here, or
    ``--multihost``'s rank among ``--num-hosts``), then the runs, then the
    group torn down."""
    from torch import distributed as dist

    from drl_tetris_tpu_torch import resolve_device
    from drl_tetris_tpu_torch.parallel.mesh import make_mesh
    from drl_tetris_tpu_torch.runtime.kv import free_port
    args.distributed = True
    device = resolve_device(args.device)
    if args.multihost:
        make_mesh(device, f"tcp://{args.coordinator}", args.num_hosts,
                  args.host_id)
    else:
        make_mesh(device, f"tcp://127.0.0.1:{free_port()}")
    try:
        _train_runs(args)
    finally:
        dist.destroy_process_group()


def _check_trainable(cfg, args):
    """What the port's trainers run: PPO and DQN, single- or
    dual-policy, SIXten and Sherlock; a dual run has no resume, warm start
    or seeded pool; the data-parallel trainer single-policy PPO from
    fresh weights."""
    if cfg.flavour not in ("ppo", "dqn", "sixten", "sherlock"):
        raise SystemExit(f"unknown flavour {cfg.flavour!r}")
    if args.distributed:
        if cfg.flavour != "ppo" or not cfg.ppo.single_policy:
            raise SystemExit(
                "train --distributed: the mesh path trains single-policy "
                f"PPO only (this run is flavour {cfg.flavour!r}, "
                f"single_policy={cfg.ppo.single_policy}); train it "
                "without --distributed")
        if args.resume or args.init_from or args.pool_seed:
            raise SystemExit("train --distributed starts from fresh "
                             "weights: --resume, --init-from and "
                             "--pool-seed are the standalone trainer's")
        return
    if cfg.ppo.single_policy or cfg.flavour in ("sixten", "sherlock"):
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
    if args.distributed:
        from drl_tetris_tpu_torch.parallel.mesh import (DistributedConfig,
                                                        DistributedTrainer)
        return DistributedTrainer(DistributedConfig(
            env=cfg.env, model=cfg.model, ppo=cfg.ppo,
            n_envs=args.n_envs or 4096, horizon=args.horizon,
            seed=args.seed), device=args.device)
    if cfg.flavour == "sixten":
        return S.StandaloneSIXtenTrainer(S.StandaloneSIXtenConfig(
            env=cfg.env, model=cfg.model, replay=cfg.replay, n_envs=n_envs,
            horizon=args.horizon, train_distribution=cfg.train_distribution,
            seed=args.seed, epsilon=cfg.epsilon,
            action_temperature=cfg.action_temperature,
            tau_learning_rate=cfg.tau_learning_rate,
            action_space=s.get("sixten_action_space", "top_drop")),
            sixten_cfg=cfg.sixten, device=args.device)
    if cfg.flavour == "sherlock":
        return S.StandaloneSherlockTrainer(S.SherlockTrainerConfig(
            env=cfg.env, model=cfg.model, n_envs=n_envs,
            horizon=args.horizon, seed=args.seed,
            action_space=s.get("sherlock_action_space", "top_drop")),
            sherlock_cfg=cfg.sherlock, device=args.device)
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
        # a DQN or SIXten run's replay restarts empty.
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

    # a data-parallel run's replicas are equal: rank 0 alone logs, saves
    # and plays the league
    writer = getattr(tr, "rank", 0) == 0
    league = None
    if args.league_every and writer:
        from drl_tetris_tpu_torch.runtime.league import (TrainingLeague,
                                                         random_anchor)
        anchors = [_load_agent(path, cfg, device=tr.device,
                               name=os.path.basename(path.rstrip("/")))[0]
                   for path in args.league_anchor]
        league = TrainingLeague(cfg.env, random_anchor(tr.net),
                                out_dir=ckpt_dir,
                                games_per_pair=args.league_games,
                                kind=_kind(cfg), fixed_anchors=anchors)
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
    with (MetricsWriter(metrics_dir, cfg.run_id) if writer
          else contextlib.nullcontext()) as mw:
        it = 0
        while tr.total_steps < args.steps:
            t0 = time.time()
            with timekeeper.section("train_iteration"):
                stats = tr.train_iteration()
            it += 1
            if not writer:
                continue
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
        if writer:
            ckpt.save(ckpt_dir, tr.total_steps, tr.state_dict(),
                      settings=run_settings)
    if writer:
        print(timekeeper.table())


def _kind(cfg) -> str:
    """The evaluation kind of ``cfg``'s flavour and action space."""
    if cfg.flavour == "sixten":
        return ("world_model_full"
                if cfg.settings.get("sixten_action_space") == "full"
                else "world_model")
    if cfg.flavour == "sherlock":
        return ("sherlock_full"
                if cfg.settings.get("sherlock_action_space") == "full"
                else "sherlock")
    return "macro"


def _new_net(cfg, device):
    """An untrained full net of ``cfg``'s flavour (QNet for dqn, VNet for
    sixten, SherlockNet for sherlock, else PPONet) for its model and
    board."""
    from drl_tetris_tpu_torch.algos.sherlock import SherlockNet
    from drl_tetris_tpu_torch.algos.sixten import VNet
    from drl_tetris_tpu_torch.models.nets import PPONet, QNet
    e = cfg.env.engine
    cls = {"dqn": QNet, "sixten": VNet, "sherlock": SherlockNet}.get(
        cfg.flavour, PPONet)
    return cls(cfg.model, board=(e.height, e.width), full_network=True,
               device=device)


def _load_agent(path, cfg, device=None, name=None):
    """Build an EvalAgent from a checkpoint, reconstructing it from the
    settings side-file saved next to the weights (the reference's
    weights<->settings pairing, eval.py:99-104, tools/utils.py:47-52), so
    tournaments can mix flavours (PPONet, QNet, VNet, SherlockNet) and
    model sizes.
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
    net = _new_net(cfg, device)
    if path == "random":
        net.init_flax_(torch.Generator().manual_seed(0))
    else:
        raw = ckpt.restore_raw(path)
        net.load_params_(raw.get("params", raw))
    net.eval().requires_grad_(False)
    return EvalAgent(name=name or os.path.basename(path.rstrip("/")),
                     net=net, distribution=cfg.eval_distribution,
                     kind=_kind(cfg)), cfg


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
                            seed=args.seed + rnd, render=args.render)
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


def cmd_play(args):
    """Watch one game (ANSI frames and the probe bars; ``--pygame`` also a
    window): a checkpoint against itself, as the JAX CLI plays it, two
    checkpoints against each other, or fresh weights with none."""
    from drl_tetris_tpu_torch.runtime.evaluate import play_match
    if len(args.checkpoints) > 2:
        raise SystemExit("play takes at most two checkpoints")
    paths = (list(args.checkpoints) or ["random"]) * 2
    cfg = _load_cfg(args)
    a, cfg = _load_agent(paths[0], cfg, device=args.device, name="A")
    b, cfg_b = _load_agent(paths[1], cfg, device=args.device, name="B")
    _check_compat([cfg, cfg_b])
    try:
        play_match(cfg.env, (a, b), n_games=1, seed=args.seed, render=True,
                   pygame=args.pygame)
    except RuntimeError as e:
        if args.pygame and "pygame" in str(e):
            raise SystemExit(f"play --pygame: {e}")
        raise


def cmd_bench(args):
    from drl_tetris_tpu_torch.runtime import bench
    print(json.dumps(bench.run(args.n_envs, args.iters, not args.no_train,
                               args.device)), flush=True)


def _standalone_cfg(args, cfg):
    from drl_tetris_tpu_torch.runtime.standalone import StandaloneConfig
    return StandaloneConfig(
        env=cfg.env, model=cfg.model, ppo=cfg.ppo,
        n_envs=args.n_envs or cfg.n_envs, horizon=args.horizon,
        seed=args.seed)


def _log(message):
    print(message, flush=True)


def cmd_kv(args):
    """Run the tetrikv store in the foreground (the docker-compose 'redis'
    service, docker-compose.yaml:29-35): this process becomes the server,
    so a signal to it reaches the server."""
    from drl_tetris_tpu_torch.runtime.kv import server_binary
    binary = server_binary()
    print(f"tetrikv listening on :{args.port}", flush=True)
    os.execv(binary, [binary, str(args.port)])


def cmd_worker(args):
    """A process-mode worker (scripts/worker_runscript.py:15-28): claims a
    worker-<i> slot, streams rollout segments to the store, polls the
    weights."""
    from drl_tetris_tpu_torch.runtime.kv import KVClient
    from drl_tetris_tpu_torch.runtime.runner import (WorkerRunner,
                                                     effective_flavour)
    from drl_tetris_tpu_torch.runtime.training_state import TrainingState
    cfg = _load_cfg(args)
    ts = TrainingState(cfg.run_id,
                       kv=KVClient(host=args.host, port=args.port))
    print(f"claimed slot {ts.me} on {args.host}:{args.port}", flush=True)
    runner = WorkerRunner(_standalone_cfg(args, cfg), ts,
                          flavour=effective_flavour(cfg), fw=cfg,
                          device=args.device)
    print(f"{ts.me}: ready on {runner.device} (start-up "
          f"{_startup_s():.1f} s)", flush=True)
    runner.run(max_steps=args.steps or None, logger=_log)


def cmd_trainer(args):
    """The process-mode trainer (scripts/trainer_runscript.py:15-26):
    drains the experience queue, trains, publishes versioned weights."""
    from drl_tetris_tpu_torch.runtime.kv import KVClient
    from drl_tetris_tpu_torch.runtime.runner import (TrainerRunner,
                                                     effective_flavour)
    from drl_tetris_tpu_torch.runtime.training_state import TrainingState
    cfg = _load_cfg(args)
    ts = TrainingState(cfg.run_id, role="trainer",
                       kv=KVClient(host=args.host, port=args.port))
    ckpt_dir = os.path.join(args.data_dir, "models", cfg.run_id)
    runner = TrainerRunner(
        _standalone_cfg(args, cfg), ts,
        min_samples=cfg.settings.get("n_samples_each_update", 2048),
        ckpt_dir=ckpt_dir, settings=cfg.settings,
        flavour=effective_flavour(cfg), fw=cfg, device=args.device)
    print(f"trainer up on {args.host}:{args.port}, {runner.device}; "
          f"checkpoints -> {ckpt_dir} (start-up {_startup_s():.1f} s)",
          flush=True)
    runner.run(max_updates=args.updates or None, logger=_log,
               log_every=args.log_every)


RECOVERY_WAIT_S = 300      # up --chaos: the replacement's start and recovery


def cmd_up(args):
    """The topology launcher: tetrikv, one trainer and N workers as local
    processes (the docker-compose file, docker-compose.yaml:4-35), each
    role on ``--device``.  ``--steps`` bounds each worker but the chaos
    victim.  ``--chaos S``: worker 0 runs until, S seconds in and once it
    has pushed a segment, the launcher SIGTERMs it (it persists its state
    to the store); then it starts a replacement, which must reclaim the freed slot and recover
    that state (elastic recovery, training_state.py:43-52); the launcher
    then waits for the recovery before it stops everything."""
    import signal
    import subprocess
    import threading

    from drl_tetris_tpu_torch.runtime.kv import launch_server

    kv_proc = launch_server(args.port)
    print(f"[up] tetrikv on :{args.port}", flush=True)
    procs, pumps = {}, {}
    seen = {"pushed": threading.Event(), "recovered": threading.Event()}

    def passthrough():
        return ((["--presets", *args.presets] if args.presets else [])
                + (["--set", *args.set] if args.set else [])
                + ["--run-id", args.run_id, "--data-dir", args.data_dir,
                   "--port", str(args.port), "--device", args.device,
                   "--n-envs", str(args.n_envs or 0),
                   "--horizon", str(args.horizon), "--seed", str(args.seed)])

    def spawn(name, role_args):
        p = subprocess.Popen(
            [sys.executable, "-m", "drl_tetris_tpu_torch", *role_args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = p

        def pump():
            for line in p.stdout:
                if name == "worker0" and "segment pushed" in line:
                    seen["pushed"].set()
                if name == "worker0b" and "recovered state" in line:
                    seen["recovered"].set()
                print(f"[{name}] {line}", end="", flush=True)
        pumps[name] = threading.Thread(target=pump, daemon=True)
        pumps[name].start()
        return p

    def stop_all():
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + 60
        for p in procs.values():
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        kv_proc.kill()
        kv_proc.wait()

    def interrupted(*_):
        stop_all()
        sys.exit(130)
    signal.signal(signal.SIGINT, interrupted)
    try:
        trainer = spawn("trainer", ["trainer", *passthrough(),
                                    "--updates", str(args.updates)])
        for i in range(args.workers):
            # the chaos victim runs until its SIGTERM
            steps = 0 if args.chaos and i == 0 else args.steps
            spawn(f"worker{i}", ["worker", *passthrough(),
                                 "--steps", str(steps)])
        if args.chaos:
            time.sleep(args.chaos)
            victim = procs["worker0"]
            seen["pushed"].wait(timeout=600)
            print("[up] CHAOS: SIGTERM worker0 (its state persists to the "
                  "store)", flush=True)
            victim.send_signal(signal.SIGTERM)
            victim.wait(timeout=120)
            print("[up] CHAOS: starting a replacement; it must reclaim the "
                  "slot and recover", flush=True)
            spawn("worker0b", ["worker", *passthrough(),
                               "--steps", str(args.steps)])
        trainer.wait()
        print(f"[up] trainer finished (rc={trainer.returncode})", flush=True)
        if args.chaos and trainer.returncode == 0:
            # the replacement recovers once it has started: wait for that,
            # or for it to end without recovering
            deadline = time.time() + RECOVERY_WAIT_S
            while not seen["recovered"].wait(timeout=1.0):
                if procs["worker0b"].poll() is not None:
                    pumps["worker0b"].join(timeout=10)   # its last lines
                if seen["recovered"].is_set():
                    break
                if procs["worker0b"].poll() is not None or \
                        time.time() > deadline:
                    print("[up] CHAOS: the replacement did not recover",
                          flush=True)
                    sys.exit(1)
    finally:
        stop_all()
    sys.exit(trainer.returncode or 0)


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


def main(argv=None):
    p = argparse.ArgumentParser(prog="drl_tetris_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="self-play training (PPO, DQN, SIXten "
                       "or Sherlock, standalone)")
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
                   help="data-parallel single-policy PPO over a process "
                        "group (world size 1 on one card)")
    t.add_argument("--multihost", action="store_true",
                   help="one rank per host: join --coordinator's process "
                        "group as rank --host-id of --num-hosts")
    t.add_argument("--coordinator", default="127.0.0.1:9777")
    t.add_argument("--num-hosts", type=int, default=1)
    t.add_argument("--host-id", type=int, default=0)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="round-robin tournament between checkpoints")
    _add_common(e)
    e.add_argument("checkpoints", nargs="+")
    e.add_argument("--games", type=int, default=16)
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--render", action="store_true",
                   help="print every tick's frame and the probe bars")
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

    w = sub.add_parser("play", help="watch a game")
    _add_common(w)
    w.add_argument("checkpoints", nargs="*", metavar="checkpoint",
                   help="none (fresh weights), one (against itself) or two")
    w.add_argument("--seed", type=int, default=0)
    w.add_argument("--pygame", action="store_true",
                   help="also open the pygame window renderer "
                        "(pause on keypress, draw_tetris.py:103-143)")
    w.set_defaults(fn=cmd_play)

    def _add_proc(sp):
        _add_common(sp)
        sp.add_argument("--host", default="127.0.0.1")
        sp.add_argument("--port", type=int, default=6399)
        sp.add_argument("--n-envs", type=int, default=0)
        sp.add_argument("--horizon", type=int, default=72)
        sp.add_argument("--seed", type=int, default=0)

    k = sub.add_parser("kv", help="run the tetrikv control-plane store")
    k.add_argument("--port", type=int, default=6399)
    k.set_defaults(fn=cmd_kv)

    wk = sub.add_parser(
        "worker", help="process-mode rollout worker (streams segments)")
    _add_proc(wk)
    wk.add_argument("--steps", type=int, default=0,
                    help="stop after N env-steps (0 = until SIGTERM)")
    wk.set_defaults(fn=cmd_worker)

    tr = sub.add_parser(
        "trainer", help="process-mode trainer (drains queue, publishes "
                        "weights)")
    _add_proc(tr)
    tr.add_argument("--updates", type=int, default=0,
                    help="stop after N updates (0 = until SIGTERM)")
    tr.add_argument("--log-every", type=int, default=1)
    tr.set_defaults(fn=cmd_trainer)

    up = sub.add_parser(
        "up", help="launch tetrikv, one trainer and N workers locally")
    _add_common(up)
    up.add_argument("--workers", type=int, default=3)   # compose scale: 3
    up.add_argument("--port", type=int, default=6399)
    up.add_argument("--n-envs", type=int, default=0)
    up.add_argument("--horizon", type=int, default=72)
    up.add_argument("--seed", type=int, default=0)
    up.add_argument("--updates", type=int, default=0)
    up.add_argument("--steps", type=int, default=0,
                    help="each worker stops after N env-steps (0 = until "
                         "stopped); the chaos victim runs until its SIGTERM")
    up.add_argument("--chaos", type=float, default=0.0,
                    help="after S seconds, kill worker 0 and show the "
                         "slot reclaimed and its state recovered")
    up.set_defaults(fn=cmd_up)

    b = sub.add_parser("bench", help="throughput benchmark (one JSON line)")
    from drl_tetris_tpu_torch.runtime.bench import add_arguments
    add_arguments(b)
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
