"""The port's architecture registry (models/nets.py ``make_trunk``:
'silver', 'vanilla', 'keyboard', 'dreamer'), dropout, the converter for
the new flax trees, and the float32 precision rule, against the JAX
package's flax nets on the same weights and inputs:

* PPONet and QNet of each architecture from converted params (a small
  net, 6 boards from a numpy seed): float32 within 1e-5.  'vanilla' and
  'keyboard' take no compute dtype in JAX and run in float32 under
  ``compute_dtype="bfloat16"`` too: within 1e-5 there as well.  'dreamer'
  at bfloat16 within DREAMER_BF16_TOL: measured on the CPU over 12 input
  and weight seeds (8 boards), the largest gaps were 1.9e-4 on pi, 8.6e-3
  on v, 8.6e-3 on Q, 2.6e-3 on V, 1.6e-3 on A, and 2.0e-3 in log pi over
  the cells where JAX gives p > 1e-3; each tolerance is 1.5x its gap;
* dropout 0.3: the nets run deterministically (every port path does, as
  the JAX trainers do), so outputs equal those at rate 0 and JAX's; a
  rate outside [0, 1) raises;
* ``params_to_flax(params_from_flax(p))`` gives JAX's tree back bit for
  bit, for each architecture, full and worker-side;
* ``init_flax_`` draws from flax's initialisers (the distributions, not
  JAX's draws);
* TF32 is off for cuDNN and cuBLAS once an entry point resolved its
  device (the flags are process-wide and readable without a card).
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu_torch.models import nets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import (params_from_flax,  # noqa: E402
                                                 params_to_flax)
from tests.test_torch_nets import SMALL, make_inputs, randomize  # noqa: E402

NEW = ("vanilla", "keyboard", "dreamer")
F32_TOL = 1e-5
DREAMER_BF16_TOL = {"pi": 3e-4, "v": 1.3e-2, "log_pi": 3e-3, "q": 1.3e-2,
                    "qv": 4e-3, "a": 2.4e-3}


def flax_params(cls, cfg_kw, seed, full_network=True, randomized=True):
    vecs, viss = make_inputs(2, 0)
    net = getattr(jnets, cls)(jnets.ModelConfig(**cfg_kw), full_network)
    p = net.init(jax.random.PRNGKey(0), [jnp.asarray(v) for v in vecs],
                 [jnp.asarray(v) for v in viss])["params"]
    p = jax.tree.map(np.asarray, p)
    return randomize(p, seed) if randomized else p


def outputs_both(cls, cfg_kw, params, seed, n=6, full_network=True,
                 port_kw=None):
    """The JAX net's and the port's outputs on seeded inputs (numpy)."""
    vecs, viss = make_inputs(n, seed, unit_vec=True)
    jout = getattr(jnets, cls)(jnets.ModelConfig(**cfg_kw), full_network
                               ).apply({"params": params},
                                       [jnp.asarray(v) for v in vecs],
                                       [jnp.asarray(v) for v in viss])
    net = getattr(nets, cls)(nets.ModelConfig(**(port_kw or cfg_kw)),
                             full_network=full_network, device="cpu")
    net.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        tout = net([torch.from_numpy(v) for v in vecs],
                   [torch.from_numpy(v) for v in viss])
    return [np.asarray(a) for a in jout], [t.numpy() for t in tout]


def test_registry_names_and_unknown_architecture():
    assert nets.ARCHITECTURES == jnets.ARCHITECTURES
    with pytest.raises(ValueError, match="unknown architecture"):
        nets.ModelConfig(architecture="resnet50")


@pytest.mark.parametrize("cls", ["PPONet", "QNet"])
@pytest.mark.parametrize("arch", NEW + ("silver",))
def test_float32_matches_jax(arch, cls):
    kw = dict(compute_dtype="float32", architecture=arch, **SMALL)
    jout, tout = outputs_both(cls, kw, flax_params(cls, kw, 4), 3)
    for a, b in zip(jout, tout):
        assert a.shape == b.shape
        assert np.abs(a - b).max() < F32_TOL, np.abs(a - b).max()
    assert jout[0].shape == (6, 4, 10, 7)
    assert jout[0].std() > 1e-3                     # not degenerate


@pytest.mark.parametrize("arch", ["vanilla", "keyboard"])
def test_legacy_trunks_run_float32_under_bfloat16(arch):
    kw = dict(compute_dtype="bfloat16", architecture=arch, **SMALL)
    jout, tout = outputs_both("PPONet", kw, flax_params("PPONet", kw, 5), 6)
    for a, b in zip(jout, tout):
        assert np.abs(a - b).max() < F32_TOL, np.abs(a - b).max()


@pytest.mark.parametrize("cls", ["PPONet", "QNet"])
def test_dreamer_bfloat16_matches_jax(cls):
    kw = dict(compute_dtype="bfloat16", architecture="dreamer", **SMALL)
    jout, tout = outputs_both(cls, kw, flax_params(cls, kw, 7), 8, n=8)
    names = ("pi", "v") if cls == "PPONet" else ("q", "qv", "a")
    for name, a, b in zip(names, jout, tout):
        assert np.abs(a - b).max() < DREAMER_BF16_TOL[name], \
            (name, np.abs(a - b).max())
    if cls == "PPONet":
        live = jout[0] > 1e-3
        gap = np.abs(np.log(jout[0][live]) - np.log(tout[0][live])).max()
        assert live.sum() > 20 and gap < DREAMER_BF16_TOL["log_pi"], gap


@pytest.mark.parametrize("arch", ["silver", "dreamer"])
def test_dropout_is_inert_on_every_path(arch):
    """Rate 0.3: the same outputs as rate 0 and as JAX's deterministic
    net (its trainers pass no dropout rng either)."""
    kw = dict(compute_dtype="float32", architecture=arch, dropout=0.3,
              **SMALL)
    params = flax_params("PPONet", kw, 9)
    jout, tout = outputs_both("PPONet", kw, params, 10)
    _, t0 = outputs_both("PPONet", kw, params, 10,
                         port_kw={**kw, "dropout": 0.0})
    for a, b, c in zip(jout, tout, t0):
        assert np.abs(a - b).max() < F32_TOL
        assert (b == c).all()


@pytest.mark.parametrize("rate", [-0.1, 1.0])
def test_dropout_rate_outside_unit_interval_raises(rate):
    with pytest.raises(ValueError, match="dropout rate"):
        nets.ResidualBlock(3, n_layers=1, n_filters=8, dropout=rate)


@pytest.mark.parametrize("full_network", [True, False])
@pytest.mark.parametrize("arch", NEW)
def test_converter_round_trip(arch, full_network):
    kw = dict(compute_dtype="float32", architecture=arch, **SMALL)
    for cls in ("PPONet", "QNet"):
        p = flax_params(cls, kw, 2, full_network)
        back = params_to_flax(params_from_flax(p))["params"]
        ja = jax.tree_util.tree_flatten_with_path(p)[0]
        jb = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [k for k, _ in ja] == [k for k, _ in jb]
        for (path, a), (_, b) in zip(ja, jb):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert (a == b).all(), path
        net = getattr(nets, cls)(nets.ModelConfig(**kw),
                                 full_network=full_network, device="cpu")
        assert set(params_from_flax(p)) == set(net.state_dict())


@pytest.mark.parametrize("arch", NEW)
def test_worker_view_shares_the_acting_modules(arch):
    cfg = nets.ModelConfig(compute_dtype="float32", architecture=arch,
                           **SMALL)
    net = nets.PPONet(cfg, device="cpu")
    net.init_flax_(torch.Generator().manual_seed(1))
    view = net.worker_view()
    assert {id(p) for p in view.parameters()} <= \
        {id(p) for p in net.parameters()}
    vecs, viss = make_inputs(3, 1, unit_vec=True)
    vec = [torch.from_numpy(v) for v in vecs]
    vis = [torch.from_numpy(v) for v in viss]
    with torch.no_grad():
        (pi, _), (vpi, vv) = net(vec, vis), view(vec, vis)
    assert torch.equal(pi, vpi) and vv.shape == (3, 1) and (vv == 0).all()


@pytest.mark.parametrize("arch", NEW)
def test_flax_initialisers(arch):
    """Zero biases, a zero keyboard kernel, and per layer of at least 500
    elements a std within 10% of the flax init's (lecun-normal kernels,
    glorot-uniform advantage heads)."""
    kw = dict(compute_dtype="float32", architecture=arch)
    ref = params_from_flax(flax_params("PPONet", kw, 0, randomized=False))
    net = nets.PPONet(nets.ModelConfig(**kw), device="cpu")
    got = net.init_flax_(torch.Generator().manual_seed(0)).state_dict()
    assert set(got) == set(ref)
    n_checked = 0
    for k, v in got.items():
        if "kbd" in k:
            if k.endswith("weight"):
                assert (v == 0).all() and (ref[k] == 0).all(), k
            continue
        if k.endswith(".bias"):
            assert (v == 0).all() and (ref[k] == 0).all(), k
        elif k.endswith("norm.weight"):
            assert (v == 1).all() and (ref[k] == 1).all(), k
        elif v.numel() >= 500:
            a, b = v.std().item(), ref[k].std().item()
            assert abs(a / b - 1) < 0.1, (k, a, b)
            n_checked += 1
    assert n_checked >= 8


def test_float32_precision_rule_after_a_trainer_is_built():
    from drl_tetris_tpu_torch.runtime.standalone import (DualPolicyConfig,
                                                         DualPolicyTrainer)
    from drl_tetris_tpu_torch import config
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    ppo = dataclasses.replace(config.load().ppo, single_policy=False)
    DualPolicyTrainer(DualPolicyConfig(
        model=nets.ModelConfig(compute_dtype="float32", **SMALL), ppo=ppo,
        n_envs=2, horizon=2), device="cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
