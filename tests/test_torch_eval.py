"""The port's evaluation (runtime/evaluate.py), league (runtime/league.py),
Elo and scoreboard (utils/) against the JAX package's.

* Scoreboard tables, online Elo, the Bradley-Terry fit and the league's
  ``elo_history.jsonl`` lines equal the JAX copies' on the same results.
* A round robin of two agents from seeded flax params (a small float32
  net, ``argmax``, 8 games per pair on a 12 x 8 board) gives the JAX
  package's scoreboard game for game, and ``fit_elo`` within 1e-9; so
  does one of a QNet agent sampling epsilon-greedy (epsilon 0.2, JAX's
  key chain) against an ``argmax`` PPONet, 4 games per pair.  JAX's
  round robins are committed (tests/jax_fixtures/eval_*.npz,
  tests/torch_jax_fixtures.py); a ``slow`` test plays them again with
  JAX and holds them to the files.
* The training league snapshots, plays the random anchor, its fixed
  anchors and its pool, and appends one refit per evaluation to ``elo_history.jsonl``.
* An unknown agent kind raises, rendered or not; a rendered round robin
  prints a frame a tick (tests/test_torch_render.py holds the frames
  against JAX's).
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.engine.core import EngineConfig as JEngineConfig  # noqa: E402
from drl_tetris_tpu.env.env import EnvConfig as JEnvConfig  # noqa: E402
from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu.runtime import evaluate as jevaluate  # noqa: E402
from drl_tetris_tpu.utils import elo as jelo  # noqa: E402
from drl_tetris_tpu.utils import scoreboard as jscoreboard  # noqa: E402
from drl_tetris_tpu_torch.engine import cuda_tick, rng  # noqa: E402
from drl_tetris_tpu_torch.engine.core import EngineConfig  # noqa: E402
from drl_tetris_tpu_torch.env.env import EnvConfig  # noqa: E402
from drl_tetris_tpu_torch.models import nets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import params_from_flax  # noqa: E402
from drl_tetris_tpu_torch.runtime import evaluate  # noqa: E402
from drl_tetris_tpu_torch.runtime.league import TrainingLeague  # noqa: E402
from drl_tetris_tpu_torch.utils import elo, scoreboard  # noqa: E402
from tests import torch_jax_fixtures as fixtures  # noqa: E402
from tests.test_torch_nets import SMALL, randomize  # noqa: E402

H, W = 12, 8
GAMES = 8


def results(seed, names, n=60):
    """(winner, loser | None for a draw) pairs from a numpy seed."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a, b = rs.choice(len(names), 2, replace=False)
        out.append((names[a], names[b] if rs.rand() < 0.85 else None,
                    names[b]))
    return out


NAMES = ["random", "step_10", "demo", "step_20"]


def boards(seed):
    port, ref = scoreboard.Scoreboard(NAMES[:1]), jscoreboard.Scoreboard(
        NAMES[:1])
    for a, b, other in results(seed, NAMES):
        for board in (port, ref):
            if b is None:
                board.declare_draw(a, other)
            else:
                board.declare_winner(a, b)
    return port, ref


@pytest.mark.parametrize("seed", (0, 1))
def test_scoreboard_and_elo_copies(seed):
    port, ref = boards(seed)
    assert port.score_table() == ref.score_table()
    assert port.win_rate("demo", "random") == ref.win_rate("demo", "random")
    n_draws = sum(b is None and {a, other} == {"demo", "random"}
                  for a, b, other in results(seed, NAMES))
    assert port.draws[("demo", "random")] == port.draws[("random", "demo")]
    assert port.draws[("demo", "random")] == n_draws
    assert elo.fit_elo(port) == jelo.fit_elo(ref)
    assert elo.elo_table(elo.fit_elo(port)) == jelo.elo_table(
        jelo.fit_elo(ref))
    t, jt = elo.EloTracker(), jelo.EloTracker()
    t.record_scoreboard(port)
    jt.record_scoreboard(ref)
    assert t.table() == jt.table()


def test_league_history_lines(tmp_path):
    port, ref = boards(2)
    h = elo.LeagueHistory(str(tmp_path / "port"))
    jh = jelo.LeagueHistory(str(tmp_path / "jax"))
    for step, name in ((10, "step_10"), (20, "step_20")):
        h.add_result(port, step, name)
        jh.add_result(ref, step, name)
    lines = (tmp_path / "port" / "elo_history.jsonl").read_text()
    jlines = (tmp_path / "jax" / "elo_history.jsonl").read_text()
    assert [json.loads(x) for x in lines.splitlines()] == \
        [json.loads(x) for x in jlines.splitlines()]
    assert h.curve() == [elo.LeagueEntry(**dataclasses.asdict(e))
                         for e in jh.curve()]


def board_params(seed, kbd_scale=12.0):
    """Seeded flax params for the small float32 net on the H x W board,
    the keyboard kernel scaled up (by ``kbd_scale``) so argmax is decided
    by the boards."""
    net = jnets.PPONet(jnets.ModelConfig(compute_dtype="float32", **SMALL))
    p = net.init(jax.random.PRNGKey(0), [jnp.zeros((1, 12))] * 2,
                 [jnp.zeros((1, H, W, 1))] * 2)["params"]
    p = randomize(jax.tree.map(np.asarray, p), seed)
    kbd = p["SventonNet_0"]["KeyboardConv_0"]["Conv_0"]
    kbd["kernel"] = kbd["kernel"] * kbd_scale
    return p


def port_net(params):
    net = nets.PPONet(nets.ModelConfig(compute_dtype="float32", **SMALL),
                      board=(H, W), device="cpu")
    net.load_state_dict(params_from_flax(params))
    return net


def board_json(board) -> dict:
    """A scoreboard's players, wins and games as JSON strings (a fixture's
    leaves)."""
    return dict(players=json.dumps(list(board.players)), **{
        k: json.dumps(sorted([a, b, n] for (a, b), n in
                             getattr(board, k).items()))
        for k in ("wins", "games")})


def jax_argmax_round_robin() -> dict:
    """The JAX package's argmax round robin of two seeded agents and the
    fitted Elo (tests/jax_fixtures/eval_argmax_round_robin.npz)."""
    params = [board_params(s) for s in (1, 2)]
    jnet = jnets.PPONet(jnets.ModelConfig(compute_dtype="float32", **SMALL))
    jagents = [jevaluate.EvalAgent(name=f"a{i}", params={"params": p},
                                   net=jnet, distribution="argmax")
               for i, p in enumerate(params)]
    jenv = JEnvConfig(engine=JEngineConfig(height=H, width=W))
    ref = jevaluate.round_robin(jenv, jagents, games_per_pair=GAMES, seed=5)
    return dict(board=board_json(ref), fit=jelo.fit_elo(ref))


def test_argmax_round_robin_matches_jax(monkeypatch):
    ref = fixtures.load("eval_argmax_round_robin")
    agents = [evaluate.EvalAgent(name=f"a{i}", net=port_net(p),
                                 distribution="argmax")
              for i, p in enumerate([board_params(s) for s in (1, 2)])]
    env = EnvConfig(engine=EngineConfig(height=H, width=W))
    ticks = []
    step = cuda_tick.step
    monkeypatch.setattr(cuda_tick, "step", lambda *a: ticks.append(1) or
                        step(*a))
    got = evaluate.round_robin(env, agents, games_per_pair=GAMES, seed=5)
    assert board_json(got) == {k: str(v) for k, v in ref["board"].items()}
    assert sum(got.games.values()) == 2 * GAMES        # every game counted
    assert sum(got.wins.values()) > 0
    assert len(ticks) % evaluate.CHUNK == 0 and len(ticks) > 0
    fit = elo.fit_elo(got)
    assert set(fit) == set(ref["fit"])
    assert all(abs(fit[k] - float(v)) < 1e-9 for k, v in ref["fit"].items())


def qnet_round_robin_params():
    # the QNet's keyboard kernel unscaled: A = tanh(logits) would saturate
    # at 1.0 in many cells, and argmax over float32 ties of tanh is not
    # held across frameworks
    return [board_params(7, kbd_scale=1.0), board_params(8)]


def jax_epsilon_qnet_round_robin() -> dict:
    """The JAX package's round robin of an epsilon-greedy QNet agent
    against an argmax PPONet (tests/jax_fixtures/
    eval_epsilon_qnet_round_robin.npz)."""
    params = qnet_round_robin_params()
    model = dict(compute_dtype="float32", **SMALL)
    jagents = [
        jevaluate.EvalAgent(name="q", params={"params": params[0]},
                            net=jnets.QNet(jnets.ModelConfig(**model)),
                            distribution="epsilon", epsilon=0.2),
        jevaluate.EvalAgent(name="p", params={"params": params[1]},
                            net=jnets.PPONet(jnets.ModelConfig(**model)),
                            distribution="argmax")]
    jenv = JEnvConfig(engine=JEngineConfig(height=H, width=W))
    ref = jevaluate.round_robin(jenv, jagents, games_per_pair=4, seed=9)
    return dict(board=board_json(ref))


def test_epsilon_qnet_round_robin_matches_jax():
    ref = fixtures.load("eval_epsilon_qnet_round_robin")
    params = qnet_round_robin_params()
    model = dict(compute_dtype="float32", **SMALL)
    q = nets.QNet(nets.ModelConfig(**model), board=(H, W), device="cpu")
    q.load_state_dict(params_from_flax(params[0]))
    agents = [evaluate.EvalAgent("q", q, distribution="epsilon",
                                 epsilon=0.2),
              evaluate.EvalAgent("p", port_net(params[1]))]
    env = EnvConfig(engine=EngineConfig(height=H, width=W))
    got = evaluate.round_robin(env, agents, games_per_pair=4, seed=9)
    want = {k: str(v) for k, v in ref["board"].items()}
    assert board_json(got)["wins"] == want["wins"]
    assert board_json(got)["games"] == want["games"]
    assert sum(got.games.values()) == 8 and sum(got.wins.values()) > 0


# slow: the JAX match programs, about 160 and 220 s cold
@pytest.mark.slow
@pytest.mark.parametrize("name, compute", [
    ("eval_argmax_round_robin", jax_argmax_round_robin),
    ("eval_epsilon_qnet_round_robin", jax_epsilon_qnet_round_robin)])
def test_round_robin_fixture_regenerates(name, compute):
    fixtures.regenerates(name, compute)


def test_unported_kinds_and_render_raise(capsys):
    """Every kind of the JAX package is played (tests/
    test_torch_cli_world_model.py); an unknown kind raises, rendered or
    not.  Rendering is ported: a rendered round robin prints one frame a
    tick with the probe lines."""
    net = port_net(board_params(3))
    env = EnvConfig(engine=EngineConfig(height=H, width=W))
    a = evaluate.EvalAgent("a", net)
    assert set(evaluate.KINDS) == {"macro", "world_model",
                                   "world_model_full", "sherlock",
                                   "sherlock_full"}
    for render in (False, True):
        with pytest.raises(ValueError, match="unknown kind"):
            evaluate.play_match(env, (a, dataclasses.replace(a, kind="keys")),
                                render=render)
    board = evaluate.round_robin(env, [a, dataclasses.replace(a, name="b")],
                                 games_per_pair=2, render=True)
    assert sum(board.games.values()) == 2 * 2     # both seats' counts
    frames = capsys.readouterr().out.split("\x1b[2J\x1b[H")[1:]
    assert frames and all(" H=" in f and " a" in f for f in frames)


def test_training_league(tmp_path):
    env = EnvConfig(engine=EngineConfig(height=H, width=W))
    rnd = nets.PPONet(nets.ModelConfig(compute_dtype="float32", **SMALL),
                      board=(H, W), device="cpu").init_flax_(
        rng.prng_key(0xE10))
    league = TrainingLeague(env, rnd, out_dir=str(tmp_path),
                            games_per_pair=2)
    learner = port_net(board_params(4))
    r1 = league.evaluate(learner, 100, seed=1)
    with torch.no_grad():                 # the snapshot is a copy
        for p in learner.parameters():
            p.mul_(0.5)
    r2 = league.evaluate(learner, 200, seed=2)
    assert set(r1) == {"random", "step_100"}
    assert set(r2) == {"random", "step_100", "step_200"}
    assert r1["random"] == r2["random"] == 1000.0
    assert [a.name for a in league.pool] == ["step_100", "step_200"]
    assert not torch.equal(league.pool[0].net.trunk.kbd.conv.weight,
                           league.pool[1].net.trunk.kbd.conv.weight)
    lines = (tmp_path / "elo_history.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [100, 200]
    assert league.rating_of_latest() == (200, r2["step_200"])
    games = league.history.board.games
    assert games[("step_200", "step_100")] == 2
    assert games[("step_200", "random")] == 2
    assert games[("step_100", "random")] == 4          # both evaluations


def test_league_entrants(monkeypatch):
    """Each evaluation is one round robin of the snapshot, the pool (its
    last max_pool snapshots), the random anchor and the fixed anchors."""
    from drl_tetris_tpu_torch.runtime import league as L
    entrants = []

    def fake_round_robin(env_cfg, agents, games_per_pair, seed):
        entrants.append([a.name for a in agents])
        board = scoreboard.Scoreboard(entrants[-1])
        for other in entrants[-1][1:]:
            board.declare_winner(entrants[-1][0], other)
        return board
    monkeypatch.setattr(L, "round_robin", fake_round_robin)
    net = port_net(board_params(5))
    anchor = evaluate.EvalAgent("anchor", port_net(board_params(6)))
    league = TrainingLeague(EnvConfig(), net, games_per_pair=2, max_pool=2,
                            fixed_anchors=[anchor])
    for step in (1, 2, 3):
        league.evaluate(net, step)
    assert entrants == [["step_1", "random", "anchor"],
                        ["step_2", "step_1", "random", "anchor"],
                        ["step_3", "step_1", "step_2", "random", "anchor"]]
    assert [a.name for a in league.pool] == ["step_2", "step_3"]
    assert league.history.steps["anchor"] == 0


def test_timekeeper_and_logstamp_copies():
    """The port's timekeeper and logstamp against the JAX package's: the
    same tags, call counts and table rows (times aside), and the same
    stamps for one sequence of return values under each flag setting."""
    from drl_tetris_tpu.utils import metrics as jmetrics
    from drl_tetris_tpu_torch.utils import metrics

    def drive(m):
        tk = m.timekeeper
        tk.flush()

        def tick(x):
            return x + 1
        tagged = tk.timed("tagged")(tick)
        for x in range(3):
            tagged(x)
        tk.timed()(tick)(0)
        with tk.section("section"):
            pass
        rows = [(r.split()[0], r.split()[2])
                for r in tk.table().splitlines()[1:]]
        counts = dict(tk.counts)
        return sorted(rows), counts, sorted(tk.flush())

    assert drive(metrics) == drive(jmetrics)
    assert not metrics.timekeeper.stats

    def stamps(m, **flags):
        out = []
        returns = iter([1, 1, 2, 2, "2", None, None])
        f = m.logstamp(out.append, name="f", **flags)(lambda: next(returns))
        for _ in range(7):
            f()
        return [line[20:] for line in out]          # the time stamp aside

    for flags in ({}, {"only_new": False}, {"only_new": False,
                                            "on_entry": True},
                  {"only_new": False, "on_exit": True}, {"on_exit": True}):
        assert stamps(metrics, **flags) == stamps(jmetrics, **flags), flags
    assert stamps(metrics) == ["[x] f"] * 4
