"""The port's command line on its dual-policy and architecture paths, on
the CPU with a tiny net (4 games per iteration):

* ``train --set single_policy=false`` on the PPO stack (12 x 8 board,
  horizon 4) for 2 iterations with a league round, and on the DQN stack
  (cut as in tests/test_torch_cli_dqn.py, horizon 8: 16 rows per policy,
  an update of each in every iteration) for 2: the checkpoints hold
  policy 0 in the single trainers' form, the metrics both policies and
  the win rate;
* on a dual run ``--resume``, ``--init-from`` and ``--pool-seed`` exit
  with a message, before any training;
* ``eval`` of the two dual checkpoints against each other;
* ``--set architecture=vanilla``, ``keyboard`` (dual) and ``dreamer`` for
  one iteration each on a 12 x 10 board, then ``eval`` of the three: each
  checkpoint's settings.json rebuilds its architecture.

One ``train`` runs as a subprocess, as a user runs it; the others call
the CLI's ``main`` in this process, which spares each the start-up.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402

import pytest  # noqa: E402

from drl_tetris_tpu_torch.cli.main import main  # noqa: E402
from drl_tetris_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from tests.test_torch_cli import N_ENVS, TINY, run  # noqa: E402
from tests.test_torch_cli_dqn import DQN, metrics  # noqa: E402

HORIZON, DQN_HORIZON = 4, 8
PER_ITER, DQN_ITER = N_ENVS * HORIZON, N_ENVS * DQN_HORIZON
DUAL = ["single_policy=false"]
ARCH_TINY = [x for x in TINY if not x.startswith("game_size")] + \
    ["game_size=[12,10]"]


def run_here(*args):
    """The CLI's ``main`` in this process; returns what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(list(args))
    return out.getvalue()


def score_cells(text, names):
    """{(a, b): (wins, games)} and the draws of an eval's output."""
    table, _, rest = text.partition("Draws (games undecided at the tick "
                                    "limit):")
    rows = [r.split() for r in table.strip().splitlines()]
    assert rows[0] == names + ["TOTAL"], rows[0]
    cells = {}
    for row in rows[1:]:
        for b, cell in zip(names, row[1:1 + len(names)]):
            if b != row[0]:
                cells[(row[0], b)] = tuple(map(int, cell.split("/")))
    draws = {(a, b): int(n) for a, b, n in
             re.findall(r"(\S+) vs (\S+): (\d+)", rest)}
    return cells, draws


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_dual"))

    def common(run_id, horizon):
        return ["--device", "cpu", "--data-dir", d, "--run-id", run_id,
                "--n-envs", str(N_ENVS), "--horizon", str(horizon),
                "--save-every", "1", "--seed", "4"]
    out = dict(dir=d, ppo_dir=os.path.join(d, "models", "dual"),
               dqn_dir=os.path.join(d, "models", "dual_dqn"))
    out["ppo"] = run("train", "--steps", str(2 * PER_ITER),
                     *common("dual", HORIZON), "--league-every", "2",
                     "--league-games", "2", "--set", *TINY, *DUAL)
    dqn = DQN[:DQN.index("--set") + 1] + DUAL + DQN[DQN.index("--set") + 1:]
    out["dqn"] = run_here("train", "--steps", str(2 * DQN_ITER),
                          *common("dual_dqn", DQN_HORIZON), *dqn)
    out["eval"] = run_here("eval", out["ppo_dir"], out["dqn_dir"],
                           "--games", "4", "--device", "cpu")
    out["arch_dirs"] = {}
    for arch, extra in (("vanilla", []), ("keyboard", DUAL),
                        ("dreamer", [])):
        run_here("train", "--steps", str(PER_ITER), *common(arch, HORIZON),
                 "--set", *ARCH_TINY, f"architecture={arch}", *extra)
        out["arch_dirs"][arch] = os.path.join(d, "models", arch)
    out["arch_eval"] = run_here("eval", *out["arch_dirs"].values(),
                                "--games", "4", "--device", "cpu")
    out["common"] = common
    return out


def test_dual_ppo_train(session):
    s = session
    assert f"[{2 * PER_ITER:>12,} steps]" in s["ppo"]
    assert ckpt.all_steps(s["ppo_dir"]) == [PER_ITER, 2 * PER_ITER]
    raw = ckpt.restore_raw(s["ppo_dir"])
    # policy 0 in the single PPO trainer's form
    assert set(raw) == {"params", "adam", "adv_comp", "vloss_comp",
                        "update_count", "total_steps", "key"}
    assert raw["update_count"] == 2 and raw["total_steps"] == 2 * PER_ITER
    assert ckpt.load_settings(s["ppo_dir"])["single_policy"] is False
    lines = metrics(s["dir"], "dual")
    assert [x["step"] for x in lines] == [PER_ITER, 2 * PER_ITER]
    for x in lines:
        assert 0.0 < x["winrate/policy_0"] < 1.0
        assert "policy_0/losses/total_loss" in x
        assert "policy_1/losses/total_loss" in x
    with open(os.path.join(s["ppo_dir"], "elo_history.jsonl")) as f:
        elo = [json.loads(x) for x in f]
    assert set(elo[0]["ratings"]) == {"random", f"step_{2 * PER_ITER}"}


def test_dual_dqn_train(session):
    s = session
    raw = ckpt.restore_raw(s["dqn_dir"])
    assert set(raw) == {"params", "ref_params", "adam", "update_count",
                        "total_steps", "key"}
    # 16 rows per policy per iteration fill the 16-sample batch
    assert raw["update_count"] == 2 and raw["total_steps"] == 2 * DQN_ITER
    lines = metrics(s["dir"], "dual_dqn")
    assert [x["step"] for x in lines] == [DQN_ITER, 2 * DQN_ITER]
    assert {"policy_0/tot_loss", "policy_1/tot_loss",
            "winrate/policy_0"} <= set(lines[-1])


@pytest.mark.parametrize("flag, message", [
    (["--resume"], "dual-policy checkpoints persist policy 0 only"),
    (["--init-from", "DUAL_DIR"], "--init-from: a dual-policy run"),
    (["--pool-seed", "DUAL_DIR"], "--pool-seed requires pool_prob > 0"),
])
def test_dual_refusals(session, flag, message):
    """Each exits with its message before a trainer is built: the run
    writes nothing."""
    flag = [session["ppo_dir"] if f == "DUAL_DIR" else f for f in flag]
    with pytest.raises(SystemExit) as e:
        main(["train", "--steps", str(PER_ITER),
              *session["common"]("refused", HORIZON), *flag, "--set", *TINY,
              *DUAL])
    assert message in str(e.value)
    assert not os.path.exists(os.path.join(session["dir"], "models",
                                           "refused"))


def test_eval_of_dual_checkpoints(session):
    cells, draws = score_cells(session["eval"], ["dual", "dual_dqn"])
    (w_a, g_a), (w_b, g_b) = cells[("dual", "dual_dqn")], \
        cells[("dual_dqn", "dual")]
    assert g_a == g_b == 4
    assert w_a + w_b + draws[("dual", "dual_dqn")] == 4


def test_architectures_train_and_eval(session):
    dirs = session["arch_dirs"]
    for arch, d in dirs.items():
        assert ckpt.load_settings(d)["architecture"] == arch
        params = ckpt.restore_raw(d)["params"]
        if arch == "dreamer":
            assert "trunk.a_dense.weight" in params
            assert "trunk.kbd.conv.weight" not in params
        elif arch == "vanilla":
            assert "trunk.vec_enc.0.0.weight" in params
            assert "trunk.a_dense.weight" in params
        else:
            assert {"trunk.vec_enc.0.0.weight",
                    "trunk.kbd.conv.weight"} <= set(params)
    names = list(dirs)
    cells, draws = score_cells(session["arch_eval"], names)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            assert cells[(a, b)][1] == cells[(b, a)][1] == 4
            assert cells[(a, b)][0] + cells[(b, a)][0] + draws[(a, b)] == 4
