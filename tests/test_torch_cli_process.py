"""The port's command line for the process runtime, the data-parallel
trainer, ``bench`` and ``play``, on the CPU with a tiny net on a 12 x 8
board, each server and process group at a free port found at run time:

* ``--help`` of every verb the JAX CLI has beyond train/eval/print-config,
  each role defaulting to the card;
* ``kv`` serves; ``up --workers 1 --updates 1`` from a cold shell (the
  store, a trainer and a worker as processes: a slot claimed, segments
  pushed, an update, a checkpoint); ``up --chaos`` stops worker 0 after
  its first segment and a replacement reclaims the slot and recovers its
  state;
* ``train --multihost`` with two ranks on gloo (rank 0 logs and saves the
  replicas' checkpoint) and ``train --distributed`` at world size 1,
  whose checkpoint ``play`` and ``eval --render`` then show;
* ``bench --device cpu`` prints its JSON line with the engine keys, and
  the package's training bench its train keys;
* ``play --pygame`` without pygame exits with a message.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import REPO, rekey_jax_cache

rekey_jax_cache()

import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import pytest  # noqa: E402

from drl_tetris_tpu_torch.cli.main import main  # noqa: E402
from drl_tetris_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from drl_tetris_tpu_torch.runtime.kv import KVClient, free_port  # noqa: E402
from tests.test_torch_cli import TINY  # noqa: E402

N_ENVS, HORIZON = 4, 8
ENV = dict(os.environ, PYTHONPATH=REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""))


def start(*args):
    return subprocess.Popen([sys.executable, "-m", "drl_tetris_tpu_torch",
                             *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=ENV,
                            cwd=REPO)


def finish(proc, timeout=300):
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-4000:]
    return out


@pytest.mark.parametrize("verb", ["kv", "worker", "trainer", "up", "bench",
                                  "play"])
def test_help_of_every_new_verb(verb, capsys):
    with pytest.raises(SystemExit) as e:
        main([verb, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith("usage:")
    if verb != "kv":
        assert "--device" in out


def test_kv_serves(tmp_path):
    port = free_port()
    proc = start("kv", "--port", str(port))
    kv = KVClient(port=port, timeout=5.0)
    try:
        deadline = time.time() + 60
        while not kv.ping():
            assert time.time() < deadline and proc.poll() is None
            time.sleep(0.1)
        kv.set("k", b"v")
        assert kv.get("k") == b"v"
    finally:
        kv.close()
        proc.kill()
        proc.communicate()


def up_args(d, *extra, samples=32):
    return ["up", "--device", "cpu", "--workers", "1", "--updates", "1",
            "--port", str(free_port()), "--run-id", "u", "--data-dir", d,
            "--n-envs", str(N_ENVS), "--horizon", str(HORIZON), *extra,
            "--set", *TINY, f"n_samples_each_update={samples}"]


def test_up_from_a_cold_shell(tmp_path):
    d = str(tmp_path)
    out = finish(start(*up_args(d)))
    assert "[worker0] claimed slot worker-0" in out
    assert "worker-0: segment pushed" in out
    assert "trainer: update 1" in out
    assert "[up] trainer finished (rc=0)" in out
    run_dir = os.path.join(d, "models", "u")
    step = ckpt.latest_step(run_dir)
    assert step is not None and step >= N_ENVS * HORIZON
    raw = ckpt.restore_raw(run_dir, step)
    assert raw["update_count"] == 1 and raw["total_steps"] == step


def test_up_chaos_recovers_the_slot(tmp_path):
    # --steps bounds the replacement; worker 0 runs until the SIGTERM
    out = finish(start(*up_args(str(tmp_path), "--chaos", "1", "--steps",
                                str(N_ENVS * HORIZON),
                                samples=2 * N_ENVS * HORIZON)))
    chaos = out.index("[up] CHAOS: SIGTERM worker0")
    assert "[worker0] worker-0: state persisted on a signal" in out[chaos:]
    assert "[worker0b] claimed slot worker-0" in out
    assert "[worker0b] worker-0: recovered state from store" in out
    assert "trainer: update 1" in out
    assert "did not recover" not in out


def train_args(d, run_id, steps, *extra):
    return ["train", "--device", "cpu", "--run-id", run_id, "--data-dir", d,
            "--horizon", "4", "--steps", str(steps), *extra,
            "--set", *TINY]


def test_multihost_two_ranks_on_gloo(tmp_path):
    d = str(tmp_path)
    coord = f"127.0.0.1:{free_port()}"
    procs = [start(*train_args(d, "m", 64, "--n-envs", "8", "--multihost",
                               "--coordinator", coord, "--num-hosts", "2",
                               "--host-id", str(r))) for r in range(2)]
    outs = [finish(p) for p in procs]
    assert "[          32 steps]" in outs[0]
    assert "[          64 steps]" in outs[0]
    assert "steps]" not in outs[1]                # rank 1 only trains
    run_dir = os.path.join(d, "models", "m")
    assert ckpt.all_steps(run_dir) == [64]
    raw = ckpt.restore_raw(run_dir)
    assert raw["update_count"] == 2 and raw["total_steps"] == 64


def test_distributed_train_then_play_and_eval_render(tmp_path, capsys):
    d = str(tmp_path)
    out = finish(start(*train_args(d, "dp", 32, "--n-envs", "4",
                                   "--distributed", "--save-every", "1")))
    assert "[          16 steps]" in out and "[          32 steps]" in out
    run_dir = os.path.join(d, "models", "dp")
    assert ckpt.all_steps(run_dir) == [16, 32]
    first = os.path.join(d, "models", "dp16")        # the run at step 16
    shutil.copytree(run_dir, first)
    shutil.rmtree(os.path.join(first, "32"))
    main(["play", first, run_dir, "--device", "cpu", "--seed", "1"])
    frames = capsys.readouterr().out.split("\x1b[2J\x1b[H")[1:]
    assert frames and all(" H=" in f and f.startswith("A ") for f in frames)
    main(["eval", run_dir, "--games", "2", "--device", "cpu", "--render"])
    out = capsys.readouterr().out
    assert "Elo (Bradley-Terry MLE)" in out and "\x1b[2J\x1b[H" in out


def test_play_pygame_without_pygame_exits(monkeypatch):
    monkeypatch.setitem(sys.modules, "pygame", None)
    with pytest.raises(SystemExit, match="pygame"):
        main(["play", "--device", "cpu", "--pygame", "--set", *TINY])


def test_bench_prints_the_keys():
    out = finish(start("bench", "--device", "cpu", "--n-envs", "8",
                       "--iters", "2", "--no-train"))
    line = json.loads(out.strip().splitlines()[-1])
    assert line["metric"] == "env_steps_per_s_8_boards"
    assert line["unit"] == "env-steps/s"
    assert line["step_env_steps_per_s"] > 0
    assert line["rollout_env_steps_per_s"] > 0
    assert line["value"] == max(line["step_env_steps_per_s"],
                                line["rollout_env_steps_per_s"])
    assert line["device_kind"] == "cpu" and line["power_limit_w"] is None
    assert "vs_baseline" not in line and "pallas_ok" not in line

    from drl_tetris_tpu_torch.runtime.bench import bench_training
    train = bench_training(4, 4, 8, iters=1, device="cpu")
    assert train["train_recipe"] == "4x4 mb8"
    assert train["train_env_steps_per_s"] > 0
    assert train["train_gflop_per_env_step"] > 0
    # no published peak for a CPU: no MFU
    assert train["train_mfu_pct"] is None
    assert train["train_sol_env_steps_per_s"] is None
