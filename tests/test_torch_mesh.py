"""The port's data-parallel PPO (algos/ppo.py ``make_ppo_update(group=)``,
parallel/mesh.py) against the JAX package's ``make_ppo_update(axis_name=)``
under ``shard_map``:

* world size 2: two spawned processes on a gloo group (tests/
  torch_mesh_rank.py), each updating on its own shard of 64 samples with
  its own key, against JAX on a 2-device CPU mesh with the same shards,
  keys, weights (a small float32 net, ``SMALL``) and PPO config
  (minibatch 16, 2 epochs, lr 1e-4, both compressors on).  The first
  step's averaged gradients within GRAD_TOL of each leaf's largest (JAX's
  recorded by an optax stage after its pmean), each rank's last-minibatch
  stats within STAT_TOL (saturations within one sample), the compressors
  within COMP_TOL, the parameters within Adam's bound and the two ranks'
  replicas bit-identical;
* ``DistributedTrainer`` at world size 1 (gloo, in this process): one
  iteration with finite stats that moves the parameters;
* ``train --distributed`` refuses every flavour but single-policy PPO.
Every process group meets at a free port found at run time.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import REPO, rekey_jax_cache

rekey_jax_cache()

import dataclasses  # noqa: E402
import math  # noqa: E402
import multiprocessing  # noqa: E402
import pickle  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from drl_tetris_tpu.algos import ppo as jppo  # noqa: E402
from drl_tetris_tpu.engine.core import EngineConfig as JEngineConfig  # noqa: E402
from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu_torch import config  # noqa: E402
from drl_tetris_tpu_torch.algos.ppo import first_step_gradients  # noqa: E402
from drl_tetris_tpu_torch.engine.core import EngineConfig  # noqa: E402
from drl_tetris_tpu_torch.models import nets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import params_from_flax  # noqa: E402
from drl_tetris_tpu_torch.runtime.kv import free_port  # noqa: E402
from tests.test_torch_nets import SMALL  # noqa: E402
from tests.test_torch_ppo import (COMP_TOL, GRAD_TOL, STAT_TOL,  # noqa: E402
                                  jax_ppo_config, near_policy, recorder,
                                  relerr, seeded_batch, sharp_params,
                                  to_torch_batch)
from tests.torch_mesh_rank import update_rank  # noqa: E402

WORLD, B, MB, EPOCHS, LR = 2, 64, 16, 2, 1e-4
KEY_SEEDS = (11, 12)


def ppo_cfg():
    return dataclasses.replace(config.load().ppo, minibatch_size=MB,
                               n_train_epochs=EPOCHS, lr=LR)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    cfg = ppo_cfg()
    params = sharp_params(5)
    net = nets.PPONet(nets.ModelConfig(compute_dtype="float32", **SMALL),
                      device="cpu")
    net.load_state_dict(params_from_flax(params))
    shards = [near_policy(seeded_batch(B, 20 + r), net, 30 + r)
              for r in range(WORLD)]
    keys = [np.asarray(jax.random.key_data(jax.random.PRNGKey(s)))
            for s in KEY_SEEDS]

    # JAX: shard_map over a 2-device CPU mesh
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    jnet = jnets.PPONet(jnets.ModelConfig(compute_dtype="float32", **SMALL))
    tx = optax.chain(recorder(), optax.adam(cfg.lr))
    jinit, jupdate = jppo.make_ppo_update(
        JEngineConfig(), jnet, jax_ppo_config(cfg), optimizer=tx,
        axis_name="data")

    def shard(state, batch, key):
        st, stats = jupdate(state, batch, key[0])
        return st, jax.tree.map(lambda a: a[None], stats)
    step = jax.jit(shard_map(shard, mesh=mesh,
                             in_specs=(P(), P("data"), P("data")),
                             out_specs=(P(), P("data")), check_rep=False))
    batch = jppo.Batch(*[jnp.asarray(np.concatenate([s[i] for s in shards]))
                         for i in range(len(jppo.Batch._fields))])
    jstate, jstats = step(jinit({"params": params}), batch,
                          jnp.asarray(np.stack(keys)))

    # the port: two processes on a gloo group
    d = tmp_path_factory.mktemp("mesh")
    inputs = str(d / "inputs.pkl")
    tbatches = [[a.numpy() for a in to_torch_batch(s)] for s in shards]
    with open(inputs, "wb") as f:
        pickle.dump({"model": SMALL, "params": params_from_flax(params),
                     "cfg": cfg, "batches": tbatches,
                     "keys": [k.astype(np.int64) for k in keys]}, f)
    ctx = multiprocessing.get_context("spawn")
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=update_rank,
                         args=(r, WORLD, init, inputs, str(d / f"{r}.pkl")))
             for r in range(WORLD)]
    old_path = sys.path[:]
    sys.path.insert(0, REPO)         # the children import the port
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
    finally:
        sys.path[:] = old_path
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD
    ranks = []
    for r in range(WORLD):
        with open(d / f"{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    jgrads = params_from_flax(jax.tree.map(
        np.asarray, jstate.opt_state[0][1]["params"]))
    own, _ = first_step_gradients(EngineConfig(), cfg, net,
                                  to_torch_batch(shards[0]),
                                  torch.from_numpy(keys[0].astype(np.int64)))
    return dict(cfg=cfg, params=params_from_flax(params), jstate=jstate,
                jstats=jstats, jgrads=jgrads, ranks=ranks, own_grads=own)


def test_averaged_first_gradients_match_jax(both):
    for rank in both["ranks"]:
        assert set(rank["first_grads"]) == set(both["jgrads"])
        for k, g in rank["first_grads"].items():
            jg = both["jgrads"][k].numpy()
            scale = np.abs(jg).max()
            err = np.abs(g - jg).max()
            assert err <= GRAD_TOL * scale + 1e-12, (k, err, scale)
    # both ranks stepped with the same average, and it is not a shard's
    # own gradient
    a, b = (r["first_grads"] for r in both["ranks"])
    assert all(np.array_equal(a[k], b[k]) for k in a)
    own = both["own_grads"]
    assert max(np.abs(own[k].numpy() - a[k]).max()
               / np.abs(a[k]).max() for k in a) > 100 * GRAD_TOL


def test_each_rank_stats_and_compressors_match_jax(both):
    jstats = {k: np.asarray(v) for k, v in both["jstats"].items()}
    for r, rank in enumerate(both["ranks"]):
        assert set(rank["stats"]) == set(jstats)
        for k, v in rank["stats"].items():
            ref = float(jstats[k][r])
            if "saturation" in k:
                assert abs(ref - v) <= 1.0 / MB + 1e-6, (r, k, ref, v)
            else:
                assert relerr(ref, v) < STAT_TOL, (r, k, ref, v)
        for name in ("adv_comp", "vloss_comp"):
            for a, b in zip(getattr(both["jstate"], name), rank[name]):
                assert relerr(float(a), b) < COMP_TOL, (r, name)
    # the value loss is the global one on both ranks
    v0, v1 = (rank["stats"]["losses/value_loss"] for rank in both["ranks"])
    assert v0 == v1


def test_parameters_match_jax_and_stay_replicated(both):
    steps = EPOCHS * (B // MB)
    tol = 2 * LR * steps + 1e-6
    jparams = params_from_flax(jax.tree.map(
        np.asarray, both["jstate"].params["params"]))
    r0, r1 = (rank["params"] for rank in both["ranks"])
    moved = 0.0
    for k, p in r0.items():
        assert np.array_equal(p, r1[k]), k
        err = np.abs(p - jparams[k].numpy()).max()
        assert err <= tol, (k, err, tol)
        moved = max(moved, np.abs(p - both["params"][k].numpy()).max())
    assert moved > 0.5 * LR


def test_distributed_trainer_world_size_one():
    from torch import distributed as dist

    from drl_tetris_tpu_torch.parallel.mesh import (DistributedConfig,
                                                    DistributedTrainer,
                                                    make_mesh)
    group = make_mesh("cpu", f"tcp://127.0.0.1:{free_port()}")
    try:
        cfg = DistributedConfig(
            model=nets.ModelConfig(compute_dtype="float32", **SMALL),
            ppo=dataclasses.replace(ppo_cfg(), minibatch_size=8,
                                    n_train_epochs=1),
            n_envs=4, horizon=8, seed=3)
        tr = DistributedTrainer(cfg, group, device="cpu")
        assert (tr.world, tr.rank, tr.n_local) == (1, 0, 4)
        before = [p.detach().clone() for p in tr.net.parameters()]
        stats = tr.train_iteration()
        assert stats and all(math.isfinite(v) for v in stats.values())
        assert max((p.detach() - b).abs().max().item()
                   for p, b in zip(tr.net.parameters(), before)) > 0.0
        assert tr.total_steps == 32
        assert int(tr.state_dict()["total_steps"]) == 32
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("argv", [
    ["--presets", "default", "sventon", "sventon_dqn"],
    ["--presets", "default", "sventon", "sherlock"],
    ["--set", "single_policy=false"],
])
def test_distributed_refuses_all_but_single_policy_ppo(argv):
    from torch import distributed as dist

    from drl_tetris_tpu_torch.cli.main import main
    with pytest.raises(SystemExit, match="single-policy PPO only"):
        main(["train", "--distributed", "--device", "cpu", *argv])
    assert not dist.is_initialized()
