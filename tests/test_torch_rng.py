"""The port's threefry RNG (drl_tetris_tpu_torch/engine/rng.py) against
jax.random under partitionable threefry, bit for bit."""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.engine import rng as jrng  # noqa: E402
from drl_tetris_tpu_torch.engine import rng  # noqa: E402

SEEDS = (0, 1, 987, 2**31 + 5, 2**32 - 1)


def _kd(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    key = jax.random.PRNGKey(seed)
    kd = rng.prng_key(seed)
    assert (_np(kd) == _kd(key)).all()
    for c in (0, 1, 7, 123456, 2**32 - 1):
        ref = _kd(jax.random.fold_in(key, jnp.uint32(c)))
        assert (_np(rng.fold_in(kd, c)) == ref).all(), c
    assert (_np(rng.split2(kd)) == _kd(jax.random.split(key))).all()
    for n in (1, 3, 64, 1000):
        assert (_np(rng.split(kd, n)) == _kd(jax.random.split(key, n))).all()


def test_batched_fold_in_and_split():
    """(N, 2) keys and per-game data, as env.step and engine.reset use
    them."""
    keys = jax.random.split(jax.random.PRNGKey(5), 17)
    kd = _t(jax.random.key_data(keys))
    data = np.arange(17, dtype=np.uint32) * 977
    ref = np.stack([_kd(jax.random.fold_in(k, jnp.uint32(d)))
                    for k, d in zip(keys, data)])
    assert (_np(rng.fold_in(kd, _t(data))) == ref).all()
    ref = np.stack([_kd(jax.random.split(k)) for k in keys])
    assert (_np(rng.split2(kd)) == ref).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_randint(seed):
    key = jax.random.PRNGKey(seed)
    kd = rng.prng_key(seed)
    for shape in ((), (5,), (3, 7), (1024,)):
        ref = np.asarray(jax.random.bits(key, shape, jnp.uint32))
        assert (_np(rng.random_bits(kd, shape)) == ref).all(), shape
        ref = np.asarray(jax.random.uniform(key, shape, jnp.float32))
        got = rng.uniform01(kd, shape).numpy()
        assert got.dtype == np.float32
        assert (got.view(np.uint32) == ref.view(np.uint32)).all(), shape
    for lo, hi in ((0, 2), (0, 7), (-5, 1000), (3, 4)):
        for n in (1, 64, 1000):
            ref = np.asarray(jax.random.randint(key, (n,), lo, hi))
            got = rng.randint(kd, (n,), lo, hi).numpy()
            assert got.dtype == np.int32 and (got == ref).all(), (lo, hi, n)


@pytest.mark.parametrize("n", (1, 128, 1000, 65536))
def test_permutation(n):
    """jax.random.permutation: 0 rounds at n = 1, 1 at 128 and 1000, 2 at
    65,536 (the training batch); bit-exact for several keys."""
    for seed in (0, 3, 2**31 + 5):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jax.random.permutation(key, n))
        got = rng.permutation(rng.prng_key(seed), n).numpy()
        assert got.shape == (n,) and (got == ref).all(), (seed, n)
    # a split key, as the PPO update's per-epoch keys
    sub = jax.random.split(jax.random.PRNGKey(9), 4)[3]
    ref = np.asarray(jax.random.permutation(sub, n))
    assert (rng.permutation(_t(jax.random.key_data(sub)), n).numpy()
            == ref).all()


def test_key_uniform_is_the_engine_draw():
    """key_uniform(fold_in(k, c)) == uniform(fold_in(k, c)) per game: the
    engine's bag and hole draw (engine/step.py _uniform)."""
    keys = jax.random.split(jax.random.PRNGKey(11), 33)
    ctr = np.arange(33, dtype=np.uint32) % 9
    ref = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(k, jnp.uint32(c)), dtype=jnp.float32))
        for k, c in zip(keys, ctr)])
    got = rng.key_uniform(rng.fold_in(_t(jax.random.key_data(keys)),
                                      _t(ctr))).numpy()
    assert (got.view(np.uint32) == ref.view(np.uint32)).all()


def test_kernel_action_stream():
    """random_bits(fold_in(fold_in(base, tick), block)) of the engine
    kernel (engine/pallas_tick.py:238-243) against the JAX package's rng
    helpers, and the (r, t) the port derives from it."""
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.env.env import EnvConfig

    base = jax.random.key_data(jax.random.PRNGKey(42))
    cfg = EnvConfig()
    block, n = 16, 64
    for tick in (0, 1, 5, 63):
        ref_r, ref_t = [], []
        for b in range(n // block):
            tk = jrng.fold_in(jrng.fold_in(base, jnp.uint32(tick)),
                              jnp.uint32(b))
            bits = np.asarray(jrng.random_bits(tk, (block,)))
            ref_r.append(bits % 4)
            ref_t.append((bits >> 16) % cfg.engine.width)
        r, t = cuda_tick.random_actions(cfg, _t(base), tick, n, block)
        assert (r.numpy() == np.concatenate(ref_r)).all(), tick
        assert (t.numpy() == np.concatenate(ref_t)).all(), tick
