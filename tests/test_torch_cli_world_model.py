"""SIXten and Sherlock through the port's command line (its entry point,
``main``, in this process), on the CPU with tiny nets on a 10 x 6 board:
``train`` for each flavour in both placement spaces (SIXten top-drop
with a league round against the uniform random anchor, then
``--resume``), and ``eval`` of the five kinds (a PPO macro agent, the
four placement agents) in two round robins that hold every pairing of make
phases, where every match tick is one env step of its pairing's make
phases.  tests/test_torch_cli.py runs the command line as
a subprocess.

The round robin of the five kinds against the JAX package's scoreboard,
game for game, is ``test_five_kind_round_robin_matches_jax`` (marked slow:
JAX compiles one match function per seating, about ten minutes cold, as
tests/test_cross_space_eval.py, the JAX package's own five-kind
tournament, is marked).
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import contextlib  # noqa: E402
import io  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu_torch.cli.main import main  # noqa: E402
from drl_tetris_tpu_torch.engine import cuda_tick  # noqa: E402
from drl_tetris_tpu_torch.engine import step as S  # noqa: E402
from drl_tetris_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402

TINY = ["tower_layers=1", "tower_filters=4", "val_layers=1", "val_filters=4",
        "compute_dtype=float32", "game_size=[10,6]", "minibatch_size=8",
        "n_train_epochs_per_update=1", "n_samples_each_update=16",
        "experience_replay_size=200", "n_step_value_estimates=3"]
SIXTEN = ["default", "sventon", "sventon_dqn", "experiment_sixten"]
SHERLOCK = ["default", "sventon", "sherlock"]
N_ENVS, HORIZON = 4, 4
PER_ITER = N_ENVS * HORIZON


def common(d, run_id, presets, extra=()):
    return ["--device", "cpu", "--data-dir", d, "--run-id", run_id,
            "--n-envs", str(N_ENVS), "--horizon", str(HORIZON),
            "--save-every", "1", "--seed", "3", "--presets", *presets,
            "--set", *TINY, *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_wm"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["train", "--steps", str(2 * PER_ITER), "--league-every", "2",
              "--league-games", "2", *common(d, "sixten", SIXTEN)])
    logs = {"sixten": out.getvalue()}
    main(["train", "--steps", str(3 * PER_ITER), "--resume",
          *common(d, "sixten", SIXTEN)])
    for run_id, presets, space in (
            ("sixten_full", SIXTEN, "sixten_action_space=full"),
            ("sherlock", SHERLOCK, "sherlock_action_space=top_drop"),
            ("sherlock_full", SHERLOCK, "sherlock_action_space=full"),
            ("ppo", ["default", "sventon", "sventon_ppo", "resblock",
                     "experiment_sventon_ppo"], "flavour=ppo")):
        main(["train", "--steps", str(PER_ITER),
              *common(d, run_id, presets, [space])])
    return d, logs


def test_train_and_resume(runs):
    d, logs = runs
    assert re.search(r"\[league\] step 32: elo=", logs["sixten"])
    assert ckpt.all_steps(os.path.join(d, "models", "sixten")) == [16, 32,
                                                                     48]
    state = ckpt.restore_raw(os.path.join(d, "models", "sixten"))
    assert {"params", "ref_params", "adam", "update_count"} <= set(state)
    assert int(state["update_count"]) >= 1
    for run_id in ("sixten_full", "sherlock", "sherlock_full"):
        state = ckpt.restore_raw(os.path.join(d, "models", run_id))
        assert int(state["total_steps"]) == PER_ITER, run_id
        s = ckpt.load_settings(os.path.join(d, "models", run_id))
        assert s["run_geometry"]["flavour"] in ("sixten", "sherlock")
    sherlock = ckpt.restore_raw(os.path.join(d, "models", "sherlock_full"))
    assert any(k.startswith("phi_") for k in sherlock["params"])


def test_eval_five_kinds(runs, capsys, monkeypatch):
    d, _ = runs
    kinds = []
    step = cuda_tick.step

    def counted(cfg, state, r, t, kind=None, y=None):
        kinds.append(None if kind is None else kind.clone())
        return step(cfg, state, r, t, kind, y)
    monkeypatch.setattr(cuda_tick, "step", counted)
    # every kind, every pairing of make phases (macro and pose, macro and
    # placement, placement and pose, both ways), in two round robins
    for names, pairs in ((["ppo", "sixten_full", "sherlock"], 3),
                         (["sixten", "sherlock_full"], 1)):
        capsys.readouterr()
        main(["eval", *[os.path.join(d, "models", n) for n in names],
              "--games", "2", "--device", "cpu"])
        out = capsys.readouterr().out
        for n in names:
            assert n in out
        # the draws table: one line per pair, one game each way
        assert out.count(" vs ") == pairs
    # no pairing is macro against macro: every tick takes the per-kind path
    assert kinds and all(k is not None for k in kinds)
    assert torch.cat(kinds).unique().tolist() == [S.MACRO, S.PLACE, S.POSE]


@pytest.mark.slow
def test_five_kind_round_robin_matches_jax():
    """The argmax round robin of PPO, VNet (top-drop and full) and
    SherlockNet (top-drop and full) agents from the same seeded weights:
    the port's scoreboard is JAX's, game for game."""
    import jax
    import jax.numpy as jnp
    from drl_tetris_tpu.algos import sherlock as jsherlock
    from drl_tetris_tpu.algos import sixten as jsixten
    from drl_tetris_tpu.engine.core import EngineConfig as JEngineConfig
    from drl_tetris_tpu.env.env import EnvConfig as JEnvConfig
    from drl_tetris_tpu.models import nets as jnets
    from drl_tetris_tpu.runtime import evaluate as jevaluate
    from drl_tetris_tpu_torch.algos.sherlock import SherlockNet
    from drl_tetris_tpu_torch.algos.sixten import VNet
    from drl_tetris_tpu_torch.engine.core import EngineConfig
    from drl_tetris_tpu_torch.env.env import EnvConfig
    from drl_tetris_tpu_torch.models import nets
    from drl_tetris_tpu_torch.models.convert import params_from_flax
    from drl_tetris_tpu_torch.runtime import evaluate
    from tests.test_torch_nets import SMALL, randomize

    H, W = 12, 8
    model = dict(compute_dtype="float32", **SMALL)
    jm = jnets.ModelConfig(**model)
    dummy = ([jnp.zeros((1, 12))] * 2, [jnp.zeros((1, H, W, 1))] * 2)

    def params(net, seed):
        p = net.init(jax.random.PRNGKey(0), *dummy)["params"]
        p = randomize(jax.tree.map(np.asarray, p), seed)
        if "ResidualBlock_4" in p and "SventonNet_0" not in p:   # VNet
            p["ResidualBlock_4"]["Conv_1"]["bias"][0] -= 3.0
        elif "Conv_0" not in p:                  # PPONet: as test_torch_eval
            kbd = p["SventonNet_0"]["KeyboardConv_0"]["Conv_0"]
            kbd["kernel"] = kbd["kernel"] * 12.0
        return p

    specs = [("macro", jnets.PPONet(jm), nets.PPONet, 1),
             ("world_model", jsixten.VNet(jm), VNet, 2),
             ("world_model_full", jsixten.VNet(jm), VNet, 3),
             ("sherlock", jsherlock.SherlockNet(jm), SherlockNet, 4),
             ("sherlock_full", jsherlock.SherlockNet(jm), SherlockNet, 5)]
    jagents, agents = [], []
    for kind, jnet, cls, seed in specs:
        p = params(jnet, seed)
        jagents.append(jevaluate.EvalAgent(name=kind, params={"params": p},
                                           net=jnet, kind=kind))
        net = cls(nets.ModelConfig(**model), board=(H, W), device="cpu")
        net.load_state_dict(params_from_flax(p))
        agents.append(evaluate.EvalAgent(name=kind, net=net, kind=kind))
    ref = jevaluate.round_robin(
        JEnvConfig(engine=JEngineConfig(height=H, width=W)), jagents,
        games_per_pair=2, seed=3)
    got = evaluate.round_robin(
        EnvConfig(engine=EngineConfig(height=H, width=W)), agents,
        games_per_pair=2, seed=3)
    assert dict(got.wins) == dict(ref.wins)
    assert dict(got.games) == dict(ref.games)
    # 10 pairs, each counted from both sides: 2 games per ordered pair
    assert sum(got.games.values()) == 40 and sum(got.wins.values()) > 0
