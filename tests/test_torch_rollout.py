"""The port's self-play rollout (algos/rollout.py) against the JAX
package's ``make_rollout_fn`` on the same weights, start state and sampling
noise: a small PPONet at float32, 8 games, horizon 16, under the "pi"
(training) and "argmax" (evaluation) distributions.

The JAX rollout draws ``keys = split(key, horizon)`` and one
``categorical`` per tick, which is ``argmax(gumbel(key_k) + log p)``; the
test hands the port those gumbel draws.  Integer and board fields must be
equal; the float fields agree to 1e-5 absolute (the nets' summation
order).  JAX's rollouts are committed (tests/jax_fixtures/rollout_*.npz,
tests/torch_jax_fixtures.py); a ``slow`` test runs them again with JAX and
holds them to the files.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import (assert_state_equal, jax_leaves,
                                      rekey_jax_cache)

rekey_jax_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.algos.rollout import make_rollout_fn as j_rollout_fn  # noqa: E402
from drl_tetris_tpu.env.env import (EnvConfig as JEnvConfig,  # noqa: E402
                                    TetrisVectorEnv as JEnv)
from drl_tetris_tpu.models import nets as jnets  # noqa: E402

from drl_tetris_tpu_torch.algos.rollout import make_rollout_fn  # noqa: E402
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv  # noqa: E402
from drl_tetris_tpu_torch.models import nets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import params_from_flax  # noqa: E402
from tests import torch_jax_fixtures as fixtures  # noqa: E402
from tests.test_torch_nets import SMALL, make_inputs, randomize  # noqa: E402

N, HORIZON = 8, 16     # the JAX trainers' parity shapes (test_torch_seed)
EXACT = ("occ", "vec", "piece", "rot", "trans", "reward", "done", "player")
CLOSE = ("prob", "v_piece", "v_mean")


def rollout_params():
    jnet = jnets.PPONet(jnets.ModelConfig(compute_dtype="float32", **SMALL))
    vecs, viss = make_inputs(2, 0)
    params = jnet.init(jax.random.PRNGKey(0), [jnp.asarray(v) for v in vecs],
                       [jnp.asarray(v) for v in viss])["params"]
    return randomize(jax.tree.map(np.asarray, params), 4)


def jax_rollout(distribution) -> dict:
    """JAX's rollout from rollout_params(): its reset and final state as
    leaves, the segment's fields, the last values and the gumbel draws of
    its keys (tests/jax_fixtures/rollout_DISTRIBUTION.npz)."""
    jnet = jnets.PPONet(jnets.ModelConfig(compute_dtype="float32", **SMALL))
    jenv = JEnv(JEnvConfig(), N)
    js0 = jenv.reset(jax.random.PRNGKey(21))
    key = jax.random.PRNGKey(5)
    js, jseg, jlast = j_rollout_fn(jenv, jnet, HORIZON, distribution)(
        {"params": rollout_params()}, js0, key)
    keys = jax.random.split(key, HORIZON)
    gumbel = np.stack([np.asarray(jax.random.gumbel(
        k, (N, 4 * jenv.cfg.n_translations), jnp.float32)) for k in keys])
    return dict(reset=jax_leaves(js0), state=jax_leaves(js),
                seg={f: getattr(jseg, f) for f in EXACT + CLOSE},
                last=jlast, gumbel=gumbel)


# slow: JAX's rollout, about 75 s cold each
@pytest.mark.slow
@pytest.mark.parametrize("distribution", ["pi", "argmax"])
def test_rollout_fixture_regenerates(distribution):
    fixtures.regenerates(f"rollout_{distribution}",
                         lambda: jax_rollout(distribution))


def rollout_both(distribution):
    """The port's rollout against JAX's (the fixture) from the same
    weights and start state; the port gets the JAX rollout's gumbel
    noise."""
    ref = fixtures.load(f"rollout_{distribution}")
    env = TetrisVectorEnv(EnvConfig(), N, device="cpu")
    net = nets.PPONet(nets.ModelConfig(compute_dtype="float32", **SMALL),
                      device="cpu")
    net.load_state_dict(params_from_flax(rollout_params()))
    ts0 = env.reset(21)
    assert_state_equal(ref["reset"], ts0, "reset")
    ts, seg, last = make_rollout_fn(env, net, HORIZON, distribution)(
        ts0, gumbel=torch.from_numpy(ref["gumbel"]))

    assert_state_equal(ref["state"], ts, "final state")
    for name in EXACT:
        a, b = ref["seg"][name], getattr(seg, name).numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert (a == b).all(), name
    for name in CLOSE:
        a, b = ref["seg"][name], getattr(seg, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.abs(a - b).max() < 1e-5, (name, np.abs(a - b).max())
    assert np.abs(ref["last"] - last.numpy()).max() < 1e-5
    return seg


def test_rollout_matches_jax():
    seg = rollout_both("pi")
    # the sampled actions are not all the argmax: the noise mattered
    assert len(set(seg.trans.flatten().tolist())) > 3


def test_rollout_argmax_matches_jax():
    """The eval distribution: the plane's argmax, no noise."""
    seg = rollout_both("argmax")
    assert len(set(seg.trans.flatten().tolist())) > 1      # not degenerate


def test_main_path_defaults_match_jax_presets():
    """The port's typed defaults (config.py) equal what the JAX CLI's
    default preset layering resolves to, for the slice's configs."""
    import dataclasses
    from drl_tetris_tpu.config.presets import load as jax_load
    from drl_tetris_tpu_torch import config

    ref, got = jax_load(), config.load()
    assert dataclasses.asdict(got.env) == dataclasses.asdict(ref.env)
    assert dataclasses.asdict(got.model) == dataclasses.asdict(ref.model)
    assert got.train_distribution == ref.train_distribution
    assert got.eval_distribution == ref.eval_distribution
