"""The port's command line (``python -m drl_tetris_tpu_torch``) as a user
runs it, on the CPU with a tiny net on a 12 x 8 board: ``train`` for 2
iterations with a league round, ``train --resume`` for one more (its
league pool re-seeded from the saved snapshots),
``eval`` of the result against random, and ``print-config`` (also
``--diff``).  The DQN and league-pool paths of ``train`` and ``eval`` are
in tests/test_torch_cli_dqn.py, the process runtime, ``train
--distributed``, ``bench`` and ``play`` in tests/test_torch_cli_process.py.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import REPO, rekey_jax_cache

rekey_jax_cache()

import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402

from drl_tetris_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402

TINY = ["tower_layers=1", "tower_filters=8", "val_layers=1", "val_filters=8",
        "compute_dtype=float32", "game_size=[12,8]", "minibatch_size=8",
        "n_train_epochs_per_update=1"]
N_ENVS, HORIZON = 4, 4
PER_ITER = N_ENVS * HORIZON


def run(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "drl_tetris_tpu_torch",
                          *args], capture_output=True, text=True, env=env,
                         timeout=timeout, cwd=REPO)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli"))
    run_dir = os.path.join(d, "models", "t")
    common = ["--device", "cpu", "--data-dir", d, "--run-id", "t",
              "--n-envs", str(N_ENVS), "--horizon", str(HORIZON),
              "--save-every", "1", "--league-every", "2",
              "--league-games", "2", "--seed", "3", "--set", *TINY]
    first = run("train", "--steps", str(2 * PER_ITER), *common)
    resumed = run("train", "--steps", str(3 * PER_ITER), "--resume", *common)
    evaluated = run("eval", run_dir, "--games", "4", "--device", "cpu")
    config = run("print-config", "--device", "cpu", "--set", "gamma=0.5")
    diff = run("print-config", "--diff", run_dir,
               os.path.join(REPO, "data", "demo_weights"))
    return dict(dir=d, run_dir=run_dir, first=first, resumed=resumed,
                evaluated=evaluated, config=config, diff=diff)


def test_train_and_resume(session):
    s = session
    assert f"[{2 * PER_ITER:>12,} steps]" in s["first"]
    assert f"[resume] restored {s['run_dir']} @ step {2 * PER_ITER:,}" in \
        s["resumed"]
    assert "league pool re-seeded" in s["resumed"]
    assert f"[{3 * PER_ITER:>12,} steps]" in s["resumed"]
    assert ckpt.all_steps(s["run_dir"]) == [PER_ITER, 2 * PER_ITER,
                                            3 * PER_ITER]
    raw = ckpt.restore_raw(s["run_dir"])
    assert raw["total_steps"] == 3 * PER_ITER and raw["update_count"] == 3
    settings = ckpt.load_settings(s["run_dir"])
    geo = settings["run_geometry"]
    assert (geo["n_envs"], geo["horizon"], geo["seed"]) == \
        (N_ENVS, HORIZON, 3)
    assert geo["command"].startswith("python -m drl_tetris_tpu_torch train")
    assert settings["game_size"] == [12, 8]
    lines = [json.loads(x) for x in open(os.path.join(
        s["run_dir"], "elo_history.jsonl"))]
    assert [x["step"] for x in lines] == [2 * PER_ITER]
    assert set(lines[0]["ratings"]) == {"random", "step_32"}
    assert "[league] step 32" in s["first"]
    metrics = open(os.path.join(s["dir"], "summaries", "t.jsonl")).read(
    ).splitlines()
    assert [json.loads(x)["step"] for x in metrics] == [16, 32, 48]


def test_eval_prints_tables(session):
    out = session["evaluated"]
    table, _, rest = out.partition("Draws (games undecided at the tick "
                                   "limit):")
    draws, _, elo = rest.partition("Elo (Bradley-Terry MLE):")
    rows = [r.split() for r in table.strip().splitlines()]
    assert rows[0] == ["t", "random", "TOTAL"]
    cells = {r[0]: r[1:4] for r in rows[1:]}
    (w_t, g_t), (w_r, g_r) = [map(int, cells["t"][1].split("/")),
                              map(int, cells["random"][0].split("/"))]
    assert (int(cells["t"][2]), int(cells["random"][2])) == (w_t, w_r)
    n_draws = int(re.fullmatch(r"t vs random: (\d+)", draws.strip())[1])
    assert g_t == g_r == 4 and w_t + w_r + n_draws == 4
    ratings = dict(re.findall(r"(\S+)\s+(-?\d+\.\d)", elo))
    assert set(ratings) == {"t", "random"}


def test_print_config(session):
    out = session["config"]
    for section in ("[env]", "[model]", "[ppo]", "[dqn]", "[merged settings]"):
        assert section in out
    assert "'gamma': 0.5" in out and "value_lr" in out
    diff = session["diff"]
    assert "run_geometry" in diff and "game_size" in diff
