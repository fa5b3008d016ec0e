"""The port's GAE (algos/gae.py) against the JAX package's ``sventon_gae``
on the same seeded (T, N) segment, with dones in the middle of the segment
and at its last tick, under the negated gamma of single-policy self-play
and an unsigned one.  Tolerance 1e-6 absolute (float32 sums in another
order)."""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.algos.gae import sventon_gae as j_gae  # noqa: E402
from drl_tetris_tpu_torch.algos.gae import sventon_gae  # noqa: E402

TOL = 1e-6


def segment(T, N, seed):
    rs = np.random.RandomState(seed)
    done = rs.rand(T, N) < 0.15
    done[T // 2, 0] = True                 # mid-segment
    done[T - 1, 1] = True                  # at the last tick
    done[:, 2] = False                     # a game with no done at all
    reward = np.where(done, rs.choice([-1.0, 1.0], (T, N)), 0.0)
    vp = np.tanh(rs.randn(T, N))
    vm = np.tanh(rs.randn(T, N))
    last = np.tanh(rs.randn(N))
    return (reward.astype(np.float32), done, vp.astype(np.float32),
            vm.astype(np.float32), last.astype(np.float32))


@pytest.mark.parametrize("gamma", (-0.98, 0.98))
def test_gae_matches_jax(gamma):
    r, d, vp, vm, last = segment(24, 8, 0)
    ja, jt, js = j_gae(jnp.asarray(r), jnp.asarray(d), jnp.asarray(vp),
                       jnp.asarray(vm), jnp.asarray(last), gamma=gamma,
                       gae_lambda=0.7, gve_lambda=0.95)
    ta, tt, ts = sventon_gae(*[torch.from_numpy(x) for x in (r, d, vp, vm,
                                                             last)],
                             gamma=gamma, gae_lambda=0.7, gve_lambda=0.95)
    assert ta.dtype == torch.float32 and ta.shape == (24, 8)
    assert np.abs(np.asarray(ja) - ta.numpy()).max() < TOL
    assert np.abs(np.asarray(jt) - tt.numpy()).max() < TOL
    assert set(js) == set(ts)
    for k in js:
        assert abs(float(js[k]) - float(ts[k])) < TOL, k
    # the carry resets at a done tick: game 0's mid-segment done sees
    # neither the next value nor the later ticks (A = td = r - vp, W = 1)
    i = 24 // 2
    assert abs(ta[i, 0].item() - (r[i, 0] - vm[i, 0])) < TOL
