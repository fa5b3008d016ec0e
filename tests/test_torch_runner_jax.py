"""The port's process runtime (runtime/runner.py) against the JAX
package's runners, on a tetrikv server at a free port, with small float32
nets (2 layers of 8 filters), 4 games x 8 ticks:

* the packets of the dqn and sixten workers against the JAX
  ``WorkerRunner``'s from the same converted weights and seed (their
  draws follow JAX's keys, epsilon 0.3): every integer, board and
  observation equal, the net's floats within NET_TOL; the ppo worker's
  batch with JAX's gumbel draws injected, the same way (GAE's floats
  within NET_TOL);
* the PPO trainer core's first update on JAX's packet against JAX's core
  from the same weights (the same key chain, so the same minibatches):
  the stats within STAT_TOL relative, the compressors within COMP_TOL,
  the parameters within Adam's bound 2 x lr x steps + 1e-6
  (tests/test_torch_ppo.py says why), and the key chains equal after.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.config import presets as jpresets  # noqa: E402
from drl_tetris_tpu.runtime import runner as jrunner  # noqa: E402
from drl_tetris_tpu.runtime import standalone as jstandalone  # noqa: E402
from drl_tetris_tpu.runtime import training_state as jts  # noqa: E402
from drl_tetris_tpu_torch.config import presets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import params_from_flax  # noqa: E402
from drl_tetris_tpu_torch.runtime.kv import free_port, launch_server  # noqa: E402
from drl_tetris_tpu_torch.runtime.runner import (WorkerRunner,  # noqa: E402
                                                 make_trainer_core)
from drl_tetris_tpu_torch.runtime.training_state import TrainingState  # noqa: E402
from tests.test_torch_nets import small_params  # noqa: E402
from tests.test_torch_ppo import COMP_TOL, STAT_TOL, relerr  # noqa: E402
from tests.test_torch_runner import (HORIZON, N, PRESETS, run_cfg,  # noqa: E402
                                     settings)
from tests.test_torch_sixten import jvnet_params  # noqa: E402

NET_TOL = 1e-5


@pytest.fixture(scope="module")
def port():
    p = free_port()
    proc = launch_server(p)
    yield p
    proc.kill()
    proc.wait()


def jax_fw(flavour, **extra):
    return jpresets.resolve(jpresets.merge_settings(
        PRESETS[flavour], settings(flavour, **extra)))


def jax_worker_packet(port, flavour, jfw, params, run_id):
    """The JAX WorkerRunner's first packet with ``params``, and the key
    it rolled out with."""
    jw = jrunner.WorkerRunner(run_cfg(jfw, jstandalone),
                              jts.TrainingState(run_id, port=port),
                              flavour=flavour, fw=jfw)
    jw.params = {"params": params}
    _, kroll = jax.random.split(jw.key)
    jw.run(max_steps=N * HORIZON)
    (packet,) = list(jw.ts.pop_data_iter())
    return packet, kroll


def port_worker(port, flavour, fw, params, run_id, net_params):
    w = WorkerRunner(run_cfg(fw), TrainingState(run_id, port=port), flavour,
                     fw, device="cpu")
    w.nets[0].load_params_(net_params(params))
    return w


def assert_fields_close(jfields, fields, where):
    """Integers, booleans and boards bit for bit, the observations too,
    the net's floats within NET_TOL of the field's scale."""
    assert set(jfields) == set(fields), where
    for k, a in jfields.items():
        a, b = np.asarray(a), fields[k]
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, k)
        if a.dtype == np.float32 and k != "vec":
            err = np.abs(a - b).max()
            assert err <= NET_TOL * max(1.0, np.abs(a).max()), (where, k, err)
        else:
            assert (a == b).all(), (where, k)


@pytest.mark.parametrize("flavour", ["dqn", "sixten"])
def test_replay_worker_packet_matches_jax(port, flavour):
    extra = dict(train_distribution="epsilon", epsilon=0.3)
    jfw = jax_fw(flavour, **extra)
    fw = presets.load(PRESETS[flavour], settings(flavour, **extra))
    params = (small_params(9) if flavour == "dqn"
              else jvnet_params(jfw.model, 9))
    jpacket, _ = jax_worker_packet(port, flavour, jfw, params, f"j-{flavour}")
    w = port_worker(port, flavour, fw, params, f"t-{flavour}",
                    params_from_flax)
    packet = w.collect(N * HORIZON)
    assert_fields_close(jpacket["segment"]._asdict(), packet["segment"],
                        flavour)
    assert len(np.unique(packet["segment"]["trans"])) > 1


@pytest.fixture(scope="module")
def ppo_packets(port):
    """The JAX ppo worker's first packet and the port's with JAX's gumbel
    draws, from the same weights and seed."""
    jfw = jax_fw("ppo")
    fw = presets.load(PRESETS["ppo"], settings("ppo"))
    params = small_params(3)
    jpacket, kroll = jax_worker_packet(port, "ppo", jfw, params, "j-ppo")
    W = fw.env.engine.width
    gumbel = torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
        k, (N, 4 * W), jnp.float32)) for k in jax.random.split(
            kroll, HORIZON)]))
    w = port_worker(port, "ppo", fw, params, "t-ppo", params_from_flax)
    return jfw, fw, jpacket, w.collect(N * HORIZON, gumbel=gumbel)


def test_ppo_worker_batch_matches_jax(ppo_packets):
    _, _, jpacket, packet = ppo_packets
    assert_fields_close(jpacket["batch"]._asdict(), packet["batch"], "ppo")
    assert set(jpacket["stats"]) == set(packet["stats"])
    for k, v in jpacket["stats"].items():
        assert abs(v - packet["stats"][k]) <= NET_TOL * max(1.0, abs(v)), k


def test_ppo_trainer_core_first_update_matches_jax(ppo_packets):
    jfw, fw, jpacket, _ = ppo_packets
    lr, epochs = 1e-4, 2
    jcfg = run_cfg(jfw, jstandalone)
    jcfg = dataclasses.replace(jcfg, ppo=dataclasses.replace(
        jcfg.ppo, lr=lr, n_train_epochs=epochs))
    cfg = run_cfg(fw)
    cfg = dataclasses.replace(cfg, ppo=dataclasses.replace(
        cfg.ppo, lr=lr, n_train_epochs=epochs))
    jcore = jrunner.make_trainer_core(jcfg, "ppo", None, N * HORIZON)
    core = make_trainer_core(cfg, "ppo", None, N * HORIZON, device="cpu")
    core.net.load_params_(params_from_flax(jax.tree.map(
        np.asarray, jcore.state.params["params"])))
    jcore.add(jpacket)
    core.add({"batch": {k: (v.view(np.int32) if v.dtype == np.uint32
                            else v)
                        for k, v in jpacket["batch"]._asdict().items()}})
    jstats, stats = jcore.maybe_train(), core.maybe_train()
    assert set(jstats) == set(stats)
    for k, v in jstats.items():
        if "saturation" in k:
            assert abs(v - stats[k]) <= 1.0 / cfg.ppo.minibatch_size + 1e-6
        else:
            assert relerr(v, stats[k]) < STAT_TOL, (k, v, stats[k])
    for jc, c in ((jcore.state.adv_comp, core.state.adv_comp),
                  (jcore.state.vloss_comp, core.state.vloss_comp)):
        for a, b in zip(jc, c):
            assert relerr(float(a), b.item()) < COMP_TOL
    steps = epochs * (N * HORIZON // cfg.ppo.minibatch_size)
    tol = 2 * lr * steps + 1e-6
    jparams = params_from_flax(jax.tree.map(
        np.asarray, jcore.state.params["params"]))
    for k, p in core.net.named_parameters():
        err = (p.detach() - jparams[k]).abs().max().item()
        assert err <= tol, (k, err, tol)
    # the key chains stayed together: the next update shuffles alike
    assert np.array_equal(np.asarray(jax.random.key_data(jcore.key)),
                          core.key.numpy())
