"""The port's presets, experiment schedule and settings codec
(config/presets.py, config/schedule.py, runtime/checkpoint.py _enc/_dec)
against the JAX package's.

* Every preset stack of the JAX experiments and recipes resolves to the
  same env, model, PPO, DQN and replay config, distributions, flavour and
  n_envs, and
  the raw value_lr schedule evaluates the same at t = 0, 5M and 20M.
* ``experiment_schedule`` gives the same run ids and configs.
* ``settings.json`` is written byte for byte as the JAX package writes it,
  and every side-file under data/ decodes and resolves to the same
  configs on both sides.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import REPO, rekey_jax_cache

rekey_jax_cache()

import dataclasses  # noqa: E402
import glob  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import pytest  # noqa: E402

from drl_tetris_tpu.config import parameter as jparameter  # noqa: E402
from drl_tetris_tpu.config import presets as jpresets  # noqa: E402
from drl_tetris_tpu.config import schedule as jschedule  # noqa: E402
from drl_tetris_tpu.runtime import checkpoint as jckpt  # noqa: E402
from drl_tetris_tpu_torch import config  # noqa: E402
from drl_tetris_tpu_torch.cli.main import _parse_overrides  # noqa: E402
from drl_tetris_tpu_torch.config import parameter, presets, schedule  # noqa: E402
from drl_tetris_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402

CLI = list(presets.CLI_PRESETS)
STACKS = {
    "cli": CLI,
    "cli+r3_learning": CLI + ["r3_learning"],
    "cli+r4_learning": CLI + ["r4_learning"],
    "cli+r5_learning": CLI + ["r5_learning"],
    "default": ["default"],
    "sventon_ppo_bare": ["default", "sventon", "sventon_ppo"],
    "sventon_dqn": list(jschedule.EXPERIMENTS["sventon_dqn"].presets),
    "sixten": list(jschedule.EXPERIMENTS["sixten"].presets),
    "sherlock": list(jschedule.EXPERIMENTS["sherlock"].presets),
}
SIDE_FILES = sorted(glob.glob(os.path.join(REPO, "data", "**",
                                           "settings.json"), recursive=True))


def assert_same_config(got, ref):
    for part in ("env", "model", "ppo", "dqn", "replay"):
        assert dataclasses.asdict(getattr(got, part)) == \
            dataclasses.asdict(getattr(ref, part)), part
    for f in ("flavour", "n_envs", "train_distribution", "eval_distribution",
              "run_id", "tau_learning_rate"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("epsilon", "action_temperature"):
        assert parameter.param_eval(getattr(got, f)) == \
            jparameter.param_eval(getattr(ref, f)), f
    schedule_got = got.settings.get("value_lr", 1e-7)
    schedule_ref = ref.settings.get("value_lr", 1e-7)
    for t in (0, 5_000_000, 20_000_000):
        assert parameter.param_eval(schedule_got, t) == \
            jparameter.param_eval(schedule_ref, t), t


def test_preset_dictionaries_are_the_jax_ones():
    assert sorted(presets.PRESETS) == sorted(jpresets.PRESETS)
    for name, d in presets.PRESETS.items():
        assert ckpt._enc(d) == jckpt._enc(jpresets.PRESETS[name]), name


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_preset_stack_resolves_like_jax(stack):
    ref = jpresets.load(STACKS[stack], run_id=stack)
    got = presets.load(STACKS[stack], run_id=stack)
    assert_same_config(got, ref)
    assert got.settings["game_area"] == ref.settings["game_area"]


def test_load_with_overrides_like_jax():
    ov = {"tower_layers": 1, "gamma": 0.99, "pieces": [2, 3],
          "game_size": [20, 8], "compute_dtype": "float32",
          "value_lr": jparameter.ExpParameter(1e-3, decay=-1e-7)}
    port_ov = dict(ov, value_lr=parameter.ExpParameter(1e-3, decay=-1e-7))
    assert_same_config(presets.load(CLI, port_ov), jpresets.load(CLI, ov))


@pytest.mark.parametrize("recipe", (None, "r5_learning"))
def test_main_path_view_is_the_cli_stack(recipe):
    """config.load is a view of presets.load(CLI stack [+ recipe])."""
    fw = presets.load(CLI + ([recipe] if recipe else []))
    mc = config.load(recipe)
    assert (mc.env, mc.model, mc.ppo, mc.n_envs) == \
        (fw.env, fw.model, fw.ppo, fw.n_envs)
    assert mc.value_lr == fw.settings["value_lr"]
    assert mc.horizon == 72


@pytest.mark.parametrize("only_last", (False, True))
def test_experiment_schedule_like_jax(only_last):
    names = sorted(schedule.EXPERIMENTS)
    ov = {"minibatch_size": 32}
    got = list(schedule.experiment_schedule(
        [schedule.EXPERIMENTS[n] for n in names], only_last=only_last,
        overrides=ov))
    ref = list(jschedule.experiment_schedule(
        [jschedule.EXPERIMENTS[n] for n in names], only_last=only_last,
        overrides=ov))
    assert [c.run_id for c in got] == [c.run_id for c in ref]
    for g, r in zip(got, ref):
        assert_same_config(g, r)
    sweep = list(schedule.experiment_schedule(
        [schedule.EXPERIMENTS["lr_sweep"]]))
    assert [c.run_id for c in sweep] == ["lr_sweep", "lr_sweep-patch1",
                                         "lr_sweep-patch2"]
    assert [c.ppo.lr for c in sweep] == [1e-7, 1e-4, 1e-5]


@pytest.mark.parametrize("stack", ("cli+r5_learning", "sixten",
                                   "sventon_dqn"))
def test_settings_json_is_byte_identical(tmp_path, stack):
    """save() writes the side-file JAX's save() writes, byte for byte."""
    import jax.numpy as jnp
    extra = {"run_geometry": {"n_envs": 4, "seed": 1, "pool_seed": []}}
    ref = dict(jpresets.load(STACKS[stack]).settings, **extra)
    got = dict(presets.load(STACKS[stack]).settings, **extra)
    jckpt.save(str(tmp_path / "jax"), 1, {"params": {"w": jnp.zeros(2)}},
               settings=ref)
    ckpt.save(str(tmp_path / "port"), 1, {"params": {"w": torch.zeros(2)}},
              settings=got)
    a = (tmp_path / "jax" / "settings.json").read_bytes()
    b = (tmp_path / "port" / "settings.json").read_bytes()
    assert a == b
    assert b"__kind__" in b
    back = ckpt.load_settings(str(tmp_path / "port"))
    assert json.dumps(ckpt._enc(back)) == json.dumps(jckpt._enc(
        jckpt.load_settings(str(tmp_path / "jax"))))


def test_side_files_exist():
    assert len(SIDE_FILES) >= 5, SIDE_FILES


@pytest.mark.parametrize("path", SIDE_FILES,
                         ids=[os.path.relpath(p, REPO) for p in SIDE_FILES])
def test_data_side_file_resolves_like_jax(path):
    """JSON lists where resolve expects tuples, run_geometry and pool_*
    keys: every side-file of the JAX runs reads in the port."""
    d = os.path.dirname(path)
    ref_s, got_s = jckpt.load_settings(d), ckpt.load_settings(d)
    assert json.dumps(ckpt._enc(got_s)) == json.dumps(jckpt._enc(ref_s))
    assert_same_config(presets.resolve(got_s, run_id="x"),
                       jpresets.resolve(ref_s, run_id="x"))


def test_parse_overrides_revives_kinds():
    ov = _parse_overrides([
        'value_lr={"__kind__":"LinearParameter","init_val":4e-4,'
        '"final_val":1.2e-4,"time_horizon":10000000}',
        "gamma=0.99", "compute_dtype=float32", "pieces=[2,3]"])
    assert ov["value_lr"] == parameter.LinearParameter(
        4e-4, final_val=1.2e-4, time_horizon=10_000_000)
    assert ov["gamma"] == 0.99 and ov["compute_dtype"] == "float32"
    assert ov["pieces"] == [2, 3]
