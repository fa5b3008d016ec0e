"""The port's PPONet (models/nets.py) and flax->torch converter
(models/convert.py) against the JAX package's flax PPONet on the same
weights and inputs.

Tolerances: float32 outputs agree to 1e-5 (small net) and 1e-4 (the demo
weights at full width) absolute; the gap is the convolutions' summation
order.  In bfloat16 the two frameworks round the convolutions' sums and
the activations at slightly different points, and the differences grow
through the 16 layers of the towers.  Measured on the CPU over 24 input
seeds (0..23) at 4 boards with the demo weights, the largest gap was
0.041 on pi and 0.158 on v (medians 0.023 and 0.020; bfloat16 itself moves
the outputs by up to 0.26 from float32).  A gap of 0.041 is more than a
uniform cell's probability, so the policy is also held in log space: over
the cells where JAX gives p > 1e-3, the largest |log p_jax - log p_torch|
was 0.397 (median 0.186).  BF16_TOL is 1.5x each largest gap.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache, REPO

rekey_jax_cache()

import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu_torch.engine import rng  # noqa: E402
from drl_tetris_tpu_torch.models import nets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import params_from_flax  # noqa: E402

SMALL = dict(tower_layers=2, tower_filters=8, val_layers=2, val_filters=8)
DEMO_DIR = os.path.join(REPO, "data", "demo_weights")
DEMO_STEP = 6029312
BF16_TOL = {"pi": 0.062, "v": 0.24, "log_pi": 0.6}
LOG_PI_FLOOR = 1e-3


def make_inputs(n, seed, h=22, w=10, unit_vec=False):
    """Per-perspective ([me, opponent]) vec (n, 12) and vis (n, h, w, 1)
    from a numpy seed: stacked random boards and observation-like scalars
    (or, with ``unit_vec``, scalars uniform in [0, 1), which keep a
    randomly initialised net's logits of order one)."""
    rs = np.random.RandomState(seed)
    vecs, viss = [], []
    for _ in range(2):
        tops = rs.randint(2, h, size=(n, 1, w))
        vis = (np.arange(h)[None, :, None] >= tops).astype(np.float32)
        vis *= (rs.rand(n, h, w) < 0.85)
        viss.append(vis[..., None].astype(np.float32))
        vec = np.concatenate([rs.randint(0, 8, (n, 2)),
                              rs.randint(0, 5, (n, 1)),
                              rs.randint(0, 250, (n, 1)),
                              rs.randint(0, 4, (n, 1)),
                              np.eye(7)[rs.randint(0, 7, n)]], axis=1)
        if unit_vec:
            vec = rs.rand(n, 12)
        vecs.append(vec.astype(np.float32))
    return vecs, viss


def randomize(params, seed):
    """The flax tree with every leaf redrawn (the keyboard head initialises
    to zeros, which would make pi uniform): kernels at 1/sqrt(fan in),
    biases and norm parameters around their defaults."""
    rs = np.random.RandomState(seed)

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            x = rs.standard_normal(a.shape) / np.sqrt(fan_in)
        elif name == "scale":
            x = 1.0 + 0.1 * rs.standard_normal(a.shape)
        else:
            x = 0.1 * rs.standard_normal(a.shape)
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, params)


def run_both(cfg_kw, params, vecs, viss, full_network=True):
    jcfg = jnets.ModelConfig(**cfg_kw)
    variables = params if "params" in params else {"params": params}
    jpi, jv = jnets.PPONet(jcfg, full_network).apply(
        variables, [jnp.asarray(v) for v in vecs],
        [jnp.asarray(v) for v in viss])
    net = nets.PPONet(nets.ModelConfig(**cfg_kw), board=viss[0].shape[1:3],
                      full_network=full_network, device="cpu")
    net.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        tpi, tv = net([torch.from_numpy(v) for v in vecs],
                      [torch.from_numpy(v) for v in viss])
    assert tpi.dtype == torch.float32 and tv.dtype == torch.float32
    assert tuple(tpi.shape) == jpi.shape and tuple(tv.shape) == jv.shape
    return (np.asarray(jpi), np.asarray(jv)), (tpi.numpy(), tv.numpy())


def small_params(seed, full_network=True):
    vecs, viss = make_inputs(2, 0)
    net = jnets.PPONet(jnets.ModelConfig(compute_dtype="float32", **SMALL),
                       full_network)
    p = net.init(jax.random.PRNGKey(0), [jnp.asarray(v) for v in vecs],
                 [jnp.asarray(v) for v in viss])["params"]
    return randomize(jax.tree.map(np.asarray, p), seed)


def test_small_net_f32():
    params = small_params(1)
    vecs, viss = make_inputs(6, 2, unit_vec=True)
    (jpi, jv), (tpi, tv) = run_both(dict(compute_dtype="float32", **SMALL),
                                    params, vecs, viss)
    assert np.abs(jpi - tpi).max() < 1e-5
    assert np.abs(jv - tv).max() < 1e-5
    assert jpi.std() > 1e-3 and jv.std() > 1e-3        # not degenerate


def test_small_net_worker_side():
    """full_network=False: the same policy, a zero (B, 1) value."""
    params = small_params(3, full_network=False)
    vecs, viss = make_inputs(4, 5, unit_vec=True)
    (jpi, jv), (tpi, tv) = run_both(dict(compute_dtype="float32", **SMALL),
                                    params, vecs, viss, full_network=False)
    assert np.abs(jpi - tpi).max() < 1e-5
    assert tv.shape == (4, 1) and (tv == 0).all() and (jv == 0).all()


@pytest.fixture(scope="module")
def demo_params():
    from drl_tetris_tpu.runtime.checkpoint import restore_raw
    return restore_raw(DEMO_DIR, DEMO_STEP)["params"]


def test_converter_covers_demo_weights(demo_params):
    leaves = jax.tree.leaves(demo_params)
    assert len(leaves) == 64
    assert sum(a.size for a in leaves) == 3_602_996
    sd = params_from_flax(demo_params)
    net = nets.PPONet(nets.ModelConfig(), device="cpu")
    assert set(sd) == set(net.state_dict())
    for k, v in net.state_dict().items():
        assert sd[k].shape == v.shape, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_demo_weights_full_width(demo_params, dtype):
    vecs, viss = make_inputs(4, 9)
    (jpi, jv), (tpi, tv) = run_both(dict(compute_dtype=dtype), demo_params,
                                    vecs, viss)
    tol = {"pi": 1e-4, "v": 1e-4} if dtype == "float32" else BF16_TOL
    assert np.abs(jpi - tpi).max() < tol["pi"], np.abs(jpi - tpi).max()
    assert np.abs(jv - tv).max() < tol["v"], np.abs(jv - tv).max()
    assert np.allclose(tpi.sum(axis=(1, 2)), 1.0, atol=1e-5)
    if dtype == "bfloat16":
        live = jpi > LOG_PI_FLOOR
        gap = np.abs(np.log(jpi[live]) - np.log(tpi[live])).max()
        assert live.sum() > 20 and gap < tol["log_pi"], (live.sum(), gap)


def test_flax_initialisers():
    """PPONet.init_flax_ draws from flax's initialisers (here from another
    key than the reference's, so only the distributions meet): a zero keyboard
    kernel, zero biases (the keyboard bias normal(1e-5)), LayerNorm weight
    1, and per layer of at least 500 elements a std within 10% of the
    flax init's (glorot_uniform; normal(0.01) on the value tower's last
    two convs), at full width."""
    vecs, viss = make_inputs(1, 0)
    jparams = jnets.PPONet(jnets.ModelConfig()).init(
        jax.random.PRNGKey(0), [jnp.asarray(v) for v in vecs],
        [jnp.asarray(v) for v in viss])["params"]
    ref = params_from_flax(jax.tree.map(np.asarray, jparams))
    net = nets.PPONet(nets.ModelConfig(), device="cpu")
    got = net.init_flax_(rng.prng_key(1)).state_dict()
    assert set(got) == set(ref)
    assert (got["trunk.kbd.conv.weight"] == 0).all()
    assert (ref["trunk.kbd.conv.weight"] == 0).all()
    kbd_bias = got["trunk.kbd.conv.bias"].std().item()
    assert 0.5e-5 < kbd_bias < 2e-5, kbd_bias
    n_checked = 0
    for k, v in got.items():
        if k.endswith(".bias") and "kbd" not in k:
            assert (v == 0).all() and (ref[k] == 0).all(), k
        elif k.endswith("norm.weight"):
            assert (v == 1).all() and (ref[k] == 1).all(), k
        elif v.numel() >= 500 and "kbd" not in k:
            a, b = v.std().item(), ref[k].std().item()
            assert abs(a / b - 1) < 0.1, (k, a, b)
            n_checked += 1
    assert n_checked >= 30
    # the value tower's output convs are the narrow normal(0.01) ones
    last = f"trunk.value_tower.convs.{nets.ModelConfig().val_layers - 1}"
    assert abs(got[last + ".weight"].std().item() / 0.01 - 1) < 0.1
