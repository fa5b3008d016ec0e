"""The port's checkpoints (runtime/checkpoint.py), the trainer's state_dict
and resume (runtime/standalone.py), the train-state converters
(models/convert.py) and the bridge tool
(tools/torch_import_flax_checkpoint.py).

* save/restore reproduces a trainer's state bit for bit, Adam's included:
  the restored trainer's next iteration equals the original's.
* ``validate_recovery`` passes on the policy's outputs and raises on a
  changed weight; a crash mid-save leaves ``latest_step`` where it was.
* A JAX ``StandaloneTrainer`` iteration saved with the JAX
  ``checkpoint.save``, read back with ``restore_raw`` and converted with
  ``ppo_state_from_flax``, resumes in the port with ``--resume``
  semantics; the next iteration on both sides (JAX's gumbel draws
  injected) keeps the key chain and env state bit-exact and the stats and
  parameters within tests/test_torch_trainer.py's tolerances.  One Adam
  step from the converted state equals optax's step (bias correction at
  the restored count) to float32 rounding.  JAX's run and step are
  committed (tests/jax_fixtures/checkpoint_resume.npz,
  tests/torch_jax_fixtures.py); a ``slow`` test runs them again with JAX
  and holds them to the file.
* The bridge tool converts data/demo_weights; ``_load_agent`` rebuilds it
  from the side-file and its float32 forward matches the JAX agent's
  within 1e-4.
* The committed port demo (data/demo_weights_torch): the bridge tool,
  run again with ``--params-only --fixture``, writes a checkpoint with
  the same ``state_checksum``, the same settings.json bytes and a fixture
  whose inputs are equal and whose JAX outputs agree within 1e-6 (float32)
  and 1e-3 (bfloat16; XLA:CPU may pick other kernels on another CPU);
  the port's net on the CPU is within the fixture check's tolerances
  (runtime/demo.py), and ``eval`` rebuilds the demo from its side-file.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import (assert_state_equal, jax_leaves,
                                      rekey_jax_cache)

rekey_jax_cache()

import dataclasses  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.env.env import EnvConfig as JEnvConfig  # noqa: E402
from drl_tetris_tpu.config import parameter as jparameter  # noqa: E402
from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu.runtime import checkpoint as jckpt  # noqa: E402
from drl_tetris_tpu.runtime import standalone as jstandalone  # noqa: E402
from drl_tetris_tpu_torch import config  # noqa: E402
from drl_tetris_tpu_torch.algos.rollout import policy_inputs  # noqa: E402
from drl_tetris_tpu_torch.models import nets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import (params_from_flax,  # noqa: E402
                                                 ppo_state_from_flax,
                                                 ppo_state_to_flax)
from drl_tetris_tpu_torch.runtime import checkpoint as ckpt  # noqa: E402
from drl_tetris_tpu_torch.runtime.standalone import (  # noqa: E402
    StandaloneConfig, StandaloneTrainer)
from tests import torch_jax_fixtures as fixtures  # noqa: E402
from tests.test_torch_nets import DEMO_DIR, SMALL, make_inputs  # noqa: E402
from tests.test_torch_ppo import jax_ppo_config, relerr  # noqa: E402
from tests.test_torch_trainer import (EPOCHS, HORIZON, MB, N,  # noqa: E402
                                      SEED, STAT_TOL, jax_gumbel)

TINY = dict(tower_layers=1, tower_filters=4, val_layers=1, val_filters=4)


def tiny_trainer(seed=1):
    mc = config.load("r5_learning")
    ppo = dataclasses.replace(mc.ppo, minibatch_size=8, n_train_epochs=2)
    cfg = StandaloneConfig(env=mc.env, model=nets.ModelConfig(
        compute_dtype="float32", **TINY), ppo=ppo, n_envs=4, horizon=4,
        seed=seed, lr_schedule=mc.value_lr)
    return StandaloneTrainer(cfg, device="cpu")


def leaves(sd, prefix=""):
    for k in sorted(sd):
        v = sd[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def assert_same_state(a, b):
    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys()
    for k, x in la.items():
        y = lb[k]
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


def test_save_restore_is_bit_exact(tmp_path):
    tr = tiny_trainer()
    tr.train_iteration()
    state = tr.state_dict()
    assert ckpt.save(str(tmp_path), tr.total_steps, state, settings={"a": 1})
    assert ckpt.latest_step(str(tmp_path)) == tr.total_steps == 16
    # the restored trainer starts from other weights and a fresh Adam
    tr2 = ckpt.restore(str(tmp_path), tiny_trainer(seed=2))
    assert_same_state(tr.state_dict(), tr2.state_dict())
    assert ckpt.state_checksum(tr2.state_dict()) == \
        ckpt.state_checksum(state)
    # the same next iteration: same games, same sampling noise (the
    # restored key draws it)
    tr2.env_state = tr.env_state
    s1, s2 = tr.train_iteration(), tr2.train_iteration()
    assert s1 == s2
    assert_same_state(tr.state_dict(), tr2.state_dict())
    raw = ckpt.restore_raw(str(tmp_path))
    assert isinstance(raw.get("params", raw)["trunk.kbd.conv.weight"],
                      np.ndarray)
    assert raw["total_steps"] == 16 and raw["adam"]["betas"] == (0.9, 0.999)


def test_init_params_keeps_a_fresh_adam(tmp_path):
    """--init-from: the checkpoint's weights, Adam and the step count
    fresh."""
    tr = tiny_trainer()
    tr.train_iteration()
    ckpt.save(str(tmp_path), tr.total_steps, tr.state_dict())
    warm = tiny_trainer(seed=2)
    raw = ckpt.restore_raw(str(tmp_path))
    warm.init_params(raw.get("params", raw))
    for k, p in warm.net.named_parameters():
        assert torch.equal(p, tr.net.get_parameter(k)), k
    assert not warm.state.optimizer.state
    assert warm.total_steps == 0 and warm.state.update_count == 0


def test_validate_recovery(tmp_path):
    tr = tiny_trainer()
    ckpt.save(str(tmp_path), 0, tr.state_dict())
    vec, vis = policy_inputs(tr.env.observe(tr.env_state))

    def outputs(t):
        with torch.no_grad():
            return list(t.net(vec, vis))
    expected = ckpt.state_checksum(outputs(tr))
    restored = ckpt.restore(str(tmp_path), tiny_trainer(seed=5))
    assert ckpt.validate_recovery(outputs, restored, expected)
    with torch.no_grad():
        restored.net.trunk.kbd.conv.bias[3] += 1e-3
    with pytest.raises(RuntimeError, match="recovery validation failed"):
        ckpt.validate_recovery(outputs, restored, expected)


def test_crash_mid_save_keeps_latest_step(tmp_path, monkeypatch):
    d = str(tmp_path)
    state = {"params": {"w": torch.arange(6.0)}}
    ckpt.save(d, 10, state)

    def crash(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a file")
        raise OSError("disk gone")
    monkeypatch.setattr(torch, "save", crash)
    with pytest.raises(OSError):
        ckpt.save(d, 20, state)
    monkeypatch.undo()
    assert ckpt.latest_step(d) == 10
    assert sorted(os.listdir(d)) == ["10"]            # no temporary left
    # an existing step is kept, as orbax keeps it
    assert not ckpt.save(d, 10, {"params": {"w": torch.zeros(6)}})
    assert (ckpt.restore_raw(d)["params"]["w"] == np.arange(6.0)).all()
    assert ckpt.save(d, 20, state) and ckpt.latest_step(d) == 20
    assert ckpt.latest_step(str(tmp_path / "absent")) is None


# ---------------------------------------------------------------------------
# a JAX run's train state, carried over
# ---------------------------------------------------------------------------

def seeded_grads(params):
    """Gradients for ``params`` (a flax tree) drawn from a numpy seed."""
    rs = np.random.RandomState(0)
    return jax.tree.map(lambda p: rs.standard_normal(p.shape).astype(
        np.float32) * 1e-2, params)


def jax_resume_run(d) -> dict:
    """One JAX StandaloneTrainer iteration (test_torch_trainer's config),
    saved with the JAX checkpoint.save in ``d`` and read back raw; JAX's
    --resume from it and the next iteration, with its gumbel draws; and
    optax's Adam step from the saved optimizer state on seeded gradients
    (tests/jax_fixtures/checkpoint_resume.npz)."""
    mc = config.load("r5_learning")
    ppo = dataclasses.replace(mc.ppo, minibatch_size=MB,
                              n_train_epochs=EPOCHS)
    model = nets.ModelConfig(compute_dtype="float32", **SMALL)
    jschedule = jparameter.LinearParameter(**dataclasses.asdict(mc.value_lr))
    jtr = jstandalone.StandaloneTrainer(jstandalone.StandaloneConfig(
        env=JEnvConfig(), model=jnets.ModelConfig(**dataclasses.asdict(model)),
        ppo=jax_ppo_config(ppo), n_envs=N, horizon=HORIZON, seed=SEED,
        lr_schedule=jschedule))
    key0, env0 = jtr.key, jtr.env_state
    jtr.train_iteration()
    latest = jtr.total_steps
    jckpt.save(d, latest, jtr.state)
    raw = jckpt.restore_raw(d)

    # one more Adam step with optax on seeded gradients
    params = jax.tree.map(jnp.asarray, raw["params"])
    grads = jax.tree.map(jnp.asarray, seeded_grads(raw["params"]))
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-4)
    updates, new_opt = tx.update(grads, jtr.state.opt_state, params)
    adam = dict(params=optax.apply_updates(params, updates),
                mu=new_opt.inner_state[0].mu, nu=new_opt.inner_state[0].nu,
                count=new_opt.count)

    # JAX --resume (cli/main.py:332-344) on a trainer in its fresh state
    jtr.state = jckpt.restore(d, jtr.state, step=latest)
    jtr.key = jax.random.fold_in(key0, latest)
    jtr.env_state = env0
    gumbel = jax_gumbel(jtr).numpy()
    jstats = jtr.train_iteration()
    after = dict(total_steps=jtr.total_steps,
                 key=np.asarray(jax.random.key_data(jtr.key)),
                 state=jax_leaves(jtr.env_state),
                 update_count=int(jtr.state.update_count), stats=jstats,
                 params=jax.tree.map(np.asarray, jtr.state.params["params"]))
    return dict(raw=raw, latest=latest, env0=jax_leaves(env0), adam=adam,
                gumbel=gumbel, after=after)


# slow: the JAX trainer's two iterations and a checkpoint, about 240 s cold
@pytest.mark.slow
def test_resume_fixture_regenerates(tmp_path):
    fixtures.regenerates("checkpoint_resume",
                         lambda: jax_resume_run(str(tmp_path)))


@pytest.fixture(scope="module")
def jax_run():
    """JAX's run (the fixture), and the port's trainer resumed from JAX's
    raw state with --resume semantics and its next iteration (JAX's gumbel
    draws injected)."""
    ref = fixtures.load("checkpoint_resume")
    mc = config.load("r5_learning")
    ppo = dataclasses.replace(mc.ppo, minibatch_size=MB,
                              n_train_epochs=EPOCHS)
    model = nets.ModelConfig(compute_dtype="float32", **SMALL)
    cfg = StandaloneConfig(env=mc.env, model=model, ppo=ppo, n_envs=N,
                           horizon=HORIZON, seed=SEED,
                           lr_schedule=mc.value_lr)
    raw, latest = ref["raw"], int(ref["latest"])
    tr = StandaloneTrainer(cfg, device="cpu")
    assert_state_equal(ref["env0"], tr.env_state, "fresh")
    tr.resume(ppo_state_from_flax(raw), latest)
    resumed = {k: p.detach().clone() for k, p in tr.net.named_parameters()}
    stats = tr.train_iteration(gumbel=torch.from_numpy(ref["gumbel"]))
    return dict(cfg=cfg, raw=raw, latest=latest, ref=ref, tr=tr, stats=stats,
                resumed=resumed)


def test_ppo_state_converters_round_trip(jax_run):
    raw = jax_run["raw"]
    back = ppo_state_to_flax(ppo_state_from_flax(raw))
    ja, jb = jax.tree_util.tree_flatten_with_path(raw)[0], \
        jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in ja] == [p for p, _ in jb]
    for (path, a), (_, b) in zip(ja, jb):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert (a == b).all(), path
    state = ppo_state_from_flax(raw)
    assert state["update_count"] == 1
    assert {int(s) for s in state["adam"]["step"].values()} == \
        {EPOCHS * N * HORIZON // MB}
    kbd = params_from_flax(raw["params"])["trunk.kbd.conv.weight"]
    assert kbd.shape[0] == 4 * 7                 # OIHW: R * P outputs


def test_adam_step_from_converted_state_matches_optax(jax_run):
    """Moments, count and lr carried over: one more Adam step on the same
    gradients gives optax's parameters and moments."""
    raw, adam = jax_run["raw"], jax_run["ref"]["adam"]
    new_params = params_from_flax(adam["params"])
    tr = StandaloneTrainer(jax_run["cfg"], device="cpu")
    tr.load_ppo_state(ppo_state_from_flax(raw))
    tr.state.optimizer.param_groups[0]["lr"] = 1e-4
    g = params_from_flax(seeded_grads(raw["params"]))
    for name, p in tr.net.named_parameters():
        p.grad = g[name].clone()
    tr.state.optimizer.step()
    got = tr.ppo_state_dict()["adam"]
    want = {k: params_from_flax(adam[k]) for k in ("mu", "nu")}
    for name, p in tr.net.named_parameters():
        for a, b in ((p.detach(), new_params[name]),
                     (got["exp_avg"][name], want["mu"][name]),
                     (got["exp_avg_sq"][name], want["nu"][name])):
            assert (a - b).abs().max().item() <= \
                1e-6 * b.abs().max().item() + 1e-12, name
        assert int(got["step"][name]) == int(adam["count"])


def test_resume_from_jax_state(jax_run):
    r = jax_run
    after, tr = r["ref"]["after"], r["tr"]
    assert tr.total_steps == int(after["total_steps"]) == 2 * r["latest"]
    assert (tr.key.numpy().astype(np.uint32) == after["key"]).all()
    assert_state_equal(after["state"], tr.env_state, "after resume")
    assert tr.state.optimizer.param_groups[0]["lr"] == \
        config.parameter.param_eval(r["cfg"].lr_schedule, r["latest"])
    assert tr.state.update_count == int(after["update_count"]) == 2
    jstats = {k: float(v) for k, v in after["stats"].items()}
    assert set(r["stats"]) == set(jstats)
    for k, v in jstats.items():
        got = r["stats"][k]
        if "saturation" in k:
            assert abs(v - got) <= 1.0 / MB + 1e-6, (k, v, got)
        else:
            assert relerr(v, got) < STAT_TOL, (k, v, got)
    jparams = params_from_flax(after["params"])
    steps = EPOCHS * (N * HORIZON // MB)
    tol = 2 * r["cfg"].ppo.lr * steps + 1e-6
    for k, p in tr.net.named_parameters():
        err = (p.detach() - jparams[k]).abs().max().item()
        assert err <= tol, (k, err, tol)
    moved = max((p.detach() - r["resumed"][k]).abs().max().item()
                for k, p in tr.net.named_parameters())
    assert moved > 1e-5


def test_bridge_tool_converts_demo_weights(tmp_path):
    from drl_tetris_tpu.cli.main import _load_agent as j_load_agent
    from drl_tetris_tpu.config.presets import load as jload
    from drl_tetris_tpu_torch.cli.main import _load_agent
    from drl_tetris_tpu_torch.config.presets import load
    from tools.torch_import_flax_checkpoint import convert

    step = convert(DEMO_DIR, str(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == step
    assert (tmp_path / "settings.json").read_bytes() == open(
        os.path.join(DEMO_DIR, "settings.json"), "rb").read()
    # another CLI config: the side-file must win
    small = {"tower_layers": 1, "tower_filters": 8, "val_layers": 1,
             "val_filters": 8}
    agent, acfg = _load_agent(str(tmp_path), load(overrides=small),
                              device="cpu")
    jagent, jcfg = j_load_agent(DEMO_DIR, jload(overrides=small))
    assert acfg.model == nets.ModelConfig(**dataclasses.asdict(jcfg.model))
    assert agent.distribution == jagent.distribution
    net32 = nets.PPONet(dataclasses.replace(acfg.model,
                                            compute_dtype="float32"),
                        device="cpu")
    net32.load_state_dict(agent.net.state_dict())
    jnet32 = jnets.PPONet(dataclasses.replace(jcfg.model,
                                              compute_dtype="float32"))
    vecs, viss = make_inputs(4, 11)
    jpi, jv = jnet32.apply(jagent.params, [jnp.asarray(v) for v in vecs],
                           [jnp.asarray(v) for v in viss])
    with torch.no_grad():
        tpi, tv = net32([torch.from_numpy(v) for v in vecs],
                        [torch.from_numpy(v) for v in viss])
    assert np.abs(np.asarray(jpi) - tpi.numpy()).max() < 1e-4
    assert np.abs(np.asarray(jv) - tv.numpy()).max() < 1e-4


def test_committed_demo_regenerates(tmp_path):
    from drl_tetris_tpu_torch.runtime import demo
    from tools.torch_import_flax_checkpoint import convert, write_fixture

    step = convert(DEMO_DIR, str(tmp_path), params_only=True)
    assert step == ckpt.latest_step(demo.DEMO_DIR) == 6029312
    committed = ckpt.restore_raw(demo.DEMO_DIR)
    assert set(committed) == {"params"}
    assert ckpt.state_checksum(committed) == ckpt.state_checksum(
        ckpt.restore_raw(str(tmp_path)))
    for d in (str(tmp_path), demo.DEMO_DIR):
        assert open(os.path.join(d, "settings.json"), "rb").read() == open(
            os.path.join(DEMO_DIR, "settings.json"), "rb").read()
    write_fixture(DEMO_DIR, str(tmp_path), step)
    got, want = demo.load_fixture(str(tmp_path)), demo.load_fixture()
    assert set(got) == set(want)
    for k in ("step", "vec", "vis"):
        assert got[k].dtype == want[k].dtype and (got[k] == want[k]).all(), k
    for k in ("pi", "v"):
        assert np.abs(got[f"{k}_float32"] - want[f"{k}_float32"]).max() \
            <= 1e-6, k
        assert np.abs(got[f"{k}_bfloat16"] - want[f"{k}_bfloat16"]).max() \
            <= 1e-3, k
    assert want["vec"].shape == (16, 2, 12)
    assert want["pi_float32"].shape == (16, 4, 10, 7)


def test_port_demo_net_matches_the_fixture():
    from drl_tetris_tpu_torch.cli.main import _load_agent
    from drl_tetris_tpu_torch.config.presets import load
    from drl_tetris_tpu_torch.runtime import demo

    errs = demo.fixture_errors("cpu")
    demo.check_fixture(errs)
    assert errs["float32"]["pi"] < 1e-4 and errs["float32"]["v"] < 1e-4
    agent, cfg = _load_agent(demo.DEMO_DIR, load(), device="cpu")
    assert agent.name == "demo_weights_torch"
    assert cfg.model.architecture == "silver"
    assert sum(p.numel() for p in agent.net.parameters()) == 3_602_996
