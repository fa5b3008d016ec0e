"""The port's command line on its DQN and league-pool paths, as a user
runs it, on the CPU with a tiny net on a 12 x 8 board (4 games x horizon
8 per iteration):

* ``train`` with the DQN stack (``default sventon sventon_dqn resblock
  experiment_sventon_dqn``, cut to k = 3, 16 samples per update in
  minibatches of 8, a 200-row replay) for 2 iterations with a league
  round, ``train --resume`` for a third (the replay restarts empty and
  refills), and ``train --init-from`` of its checkpoint into a new run;
* ``train`` on the PPO stack with league-pool opponents (``pool_prob=1.0
  pool_every=1 pool_mode=pfsp``) and the linear reward shaper for 3
  iterations, so iterations 2 and 3 play the pool from both seats; then
  ``--pool-seed`` with that run's checkpoint into a new run, which plays
  the seeded opponent from its first iteration;
* ``eval`` of the DQN run against the PPO run: the tables parse and
  every pair played its games.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402

import pytest  # noqa: E402

from drl_tetris_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from tests.test_torch_cli import N_ENVS, TINY, run  # noqa: E402

HORIZON = 8
PER_ITER = N_ENVS * HORIZON
DQN = ["--presets", "default", "sventon", "sventon_dqn", "resblock",
       "experiment_sventon_dqn", "--set", *TINY, "n_step_value_estimates=3",
       "sparse_value_estimate_filter=[]", "n_samples_each_update=16",
       "experience_replay_size=200"]
POOL = ["--set", *TINY, "pool_prob=1.0", "pool_every=1", "pool_mode=pfsp",
        "reward_shaper=linear_reshaping", "reward_shaper_param=0.5"]


def metrics(d, run_id):
    with open(os.path.join(d, "summaries", f"{run_id}.jsonl")) as f:
        return [json.loads(x) for x in f]


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_dqn"))

    def common(run_id):
        return ["--device", "cpu", "--data-dir", d, "--run-id", run_id,
                "--n-envs", str(N_ENVS), "--horizon", str(HORIZON),
                "--save-every", "1", "--seed", "5"]
    dqn_dir = os.path.join(d, "models", "dqn")
    ppo_dir = os.path.join(d, "models", "pool")
    out = dict(dir=d, dqn_dir=dqn_dir, ppo_dir=ppo_dir)
    out["dqn"] = run("train", "--steps", str(2 * PER_ITER), *common("dqn"),
                     "--league-every", "2", "--league-games", "2", *DQN)
    out["resumed"] = run("train", "--steps", str(3 * PER_ITER), "--resume",
                         *common("dqn"), *DQN)
    out["init"] = run("train", "--steps", str(PER_ITER), "--init-from",
                      dqn_dir, *common("dqn_init"), *DQN)
    out["pool"] = run("train", "--steps", str(3 * PER_ITER), *common("pool"),
                      *POOL)
    out["seeded"] = run("train", "--steps", str(PER_ITER), "--pool-seed",
                        ppo_dir, *common("seeded"), *POOL)
    out["eval"] = run("eval", dqn_dir, ppo_dir, "--games", "4", "--device",
                      "cpu")
    return out


def test_dqn_train_resume_and_init(session):
    s = session
    assert f"[{2 * PER_ITER:>12,} steps]" in s["dqn"]
    assert f"[resume] restored {s['dqn_dir']} @ step {2 * PER_ITER:,}" in \
        s["resumed"]
    assert ckpt.all_steps(s["dqn_dir"]) == [PER_ITER, 2 * PER_ITER,
                                            3 * PER_ITER]
    raw = ckpt.restore_raw(s["dqn_dir"])
    assert set(raw) == {"params", "ref_params", "adam", "update_count",
                        "total_steps", "key"}
    # an update per iteration (32 rows >= 16), the resumed one included
    assert raw["total_steps"] == 3 * PER_ITER and raw["update_count"] == 3
    settings = ckpt.load_settings(s["dqn_dir"])
    assert settings["flavour"] == "dqn"
    assert settings["run_geometry"]["flavour"] == "dqn"
    lines = metrics(s["dir"], "dqn")
    assert [x["step"] for x in lines] == [32, 64, 96]
    assert {"q_val", "q_target", "tot_loss"} <= set(lines[0])
    with open(os.path.join(s["dqn_dir"], "elo_history.jsonl")) as f:
        elo = [json.loads(x) for x in f]
    assert set(elo[0]["ratings"]) == {"random", f"step_{2 * PER_ITER}"}
    assert f"[init] params restored from {s['dqn_dir']}" in s["init"]
    init = ckpt.restore_raw(os.path.join(s["dir"], "models", "dqn_init"))
    assert init["update_count"] == 1


def test_ppo_pool_and_shaper(session):
    s = session
    lines = metrics(s["dir"], "pool")
    assert [x["step"] for x in lines] == [32, 64, 96]
    # the pool holds a snapshot from iteration 1 on; pool_prob 1 plays it
    assert "pool/opponent_winrate_ema" not in lines[0]
    for x in lines[1:]:
        assert 0.0 <= x["pool/opponent_winrate_ema"] <= 1.0
    settings = ckpt.load_settings(s["ppo_dir"])
    assert settings["reward_shaper"] == "linear_reshaping"
    assert f"[pool] seeded opponent from {s['ppo_dir']}" in s["seeded"]
    seeded = metrics(s["dir"], "seeded")
    assert "pool/opponent_winrate_ema" in seeded[0]
    geo = ckpt.load_settings(os.path.join(s["dir"], "models", "seeded"))
    assert geo["run_geometry"]["pool_seed"] == [s["ppo_dir"]]


def test_eval_mixes_dqn_and_ppo(session):
    out = session["eval"]
    table, _, rest = out.partition("Draws (games undecided at the tick "
                                   "limit):")
    rows = [r.split() for r in table.strip().splitlines()]
    assert rows[0] == ["dqn", "pool", "TOTAL"]
    cells = {r[0]: r[1:3] for r in rows[1:]}
    w_d, g_d = map(int, cells["dqn"][1].split("/"))
    w_p, g_p = map(int, cells["pool"][0].split("/"))
    draws = int(re.search(r"dqn vs pool: (\d+)", rest)[1])
    assert g_d == g_p == 4 and w_d + w_p + draws == 4
    ratings = dict(re.findall(r"(\S+)\s+(-?\d+\.\d)",
                              rest.partition("Elo (Bradley-Terry MLE):")[2]))
    assert set(ratings) == {"dqn", "pool"}
