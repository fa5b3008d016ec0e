"""The port's sampling and reward machinery against the JAX package's, on
the same numpy-seeded inputs and keys:

* ``action_epsilongreedy``: the indices bit-exact from the same key, for
  epsilon 0, 0.3, 1 and a 0-d tensor epsilon (JAX's key chain is the
  port's threefry, so no noise is injected); the entropy within 1e-6 (its
  sum runs in another order).
* ``pareto`` and ``action_pareto`` with JAX's gumbel draws injected:
  the probabilities within 1e-6 (pow and sum order), ties ranked in index
  order as JAX's stable argsort does, the sampled indices equal, the
  entropies within 1e-5.
* ``linear_reshaping`` on random (T, N) segments with dones, single and
  dual policy: within 1e-6.
* ``_traj_len_ema`` (the device form, a closed form in float64) against
  both JAX forms (the lax.scan and the host loop): the lengths exact, the
  EMA within 1e-5 relative.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.algos import distributions as jD  # noqa: E402
from drl_tetris_tpu.algos import reward_shapers as jshapers  # noqa: E402
from drl_tetris_tpu.runtime import standalone as jstandalone  # noqa: E402
from drl_tetris_tpu_torch.algos import distributions as D  # noqa: E402
from drl_tetris_tpu_torch.algos import reward_shapers as shapers  # noqa: E402
from drl_tetris_tpu_torch.runtime import standalone  # noqa: E402

N, R, T = 64, 4, 10


def scores(seed, ties=False):
    rs = np.random.RandomState(seed)
    a = rs.randn(N, R, T).astype(np.float32)
    if ties:                      # many equal scores per plane
        a = np.round(a * 2) / 2
    return a


def jkey(seed):
    return jax.random.PRNGKey(seed)


def tkey(seed):
    return torch.from_numpy(np.asarray(jax.random.key_data(jkey(seed))
                                       ).astype(np.int64))


@pytest.mark.parametrize("epsilon", (0.0, 0.3, 1.0, "tensor"))
def test_epsilongreedy_bit_exact(epsilon):
    a = scores(1)
    eps = 0.3 if epsilon == "tensor" else epsilon
    (jr, jt), jent = jD.action_epsilongreedy(jnp.asarray(a), jkey(7),
                                             jnp.float32(eps))
    teps = torch.tensor(eps) if epsilon == "tensor" else eps
    (r, t), ent = D.action_epsilongreedy(torch.from_numpy(a), tkey(7), teps)
    assert (np.asarray(jr) == r.numpy()).all()
    assert (np.asarray(jt) == t.numpy()).all()
    assert np.abs(np.asarray(jent) - ent.numpy()).max() < 1e-6
    greedy = a.reshape(N, -1).argmax(-1)
    explored = (r.numpy() * T + t.numpy()) != greedy
    if eps == 0.0:
        assert not explored.any()
    else:
        assert explored.any()


@pytest.mark.parametrize("ties,temperature", [(False, 1.0), (True, 1.0),
                                              (False, 0.7)])
def test_pareto_with_injected_gumbel(ties, temperature):
    a = scores(2, ties)
    jp = np.asarray(jax.vmap(lambda v: jD.pareto(v, jnp.float32(
        temperature)))(jnp.asarray(a.reshape(N, -1))))
    p = D.pareto(torch.from_numpy(a.reshape(N, -1)), temperature).numpy()
    assert np.abs(jp - p).max() < 1e-6
    if ties:                      # tied scores, distinct ranks, index order
        assert len(np.unique(a[0])) < R * T
        assert len(np.unique(p[0])) == R * T
    key = jkey(11)
    (jr, jt), jent = jD.action_pareto(jnp.asarray(a), key,
                                      jnp.float32(temperature))
    g = torch.from_numpy(np.array(jax.random.gumbel(key, (N, R * T),
                                                      jnp.float32)))
    (r, t), ent = D.action_pareto(torch.from_numpy(a), temperature,
                                  gumbel=g)
    assert (np.asarray(jr) == r.numpy()).all()
    assert (np.asarray(jt) == t.numpy()).all()
    assert np.abs(np.asarray(jent) - ent.numpy()).max() < 1e-5


def segment(seed, t=24, n=16, p_done=0.15):
    rs = np.random.RandomState(seed)
    done = rs.rand(t, n) < p_done
    reward = np.where(done, rs.choice([-1.0, 1.0], (t, n)),
                      0.05 * rs.randn(t, n)).astype(np.float32)
    return reward, done


@pytest.mark.parametrize("single_policy", (True, False))
@pytest.mark.parametrize("seed", (0, 1))
def test_linear_reshaping_matches_jax(single_policy, seed):
    reward, done = segment(seed)
    jf = jshapers.make_shaper("linear_reshaping", 0.4, single_policy)
    f = shapers.make_shaper("linear_reshaping", 0.4, single_policy)
    want = np.asarray(jf(jnp.asarray(reward), jnp.asarray(done)))
    got = f(torch.from_numpy(reward), torch.from_numpy(done)).numpy()
    assert got.dtype == np.float32
    assert np.abs(want - got).max() < 1e-6
    assert np.abs(got - reward).max() > 1e-3          # it did reshape


def test_shaper_names():
    assert shapers.make_shaper(None, 0.5) is None
    assert shapers.make_shaper("none", 0.5) is None
    r = torch.ones(3, 2)
    assert shapers.no_reshaping()(r, r) is r
    with pytest.raises(ValueError):
        shapers.make_shaper("height", 0.5)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_traj_len_ema_matches_both_jax_forms(seed):
    rs = np.random.RandomState(seed)
    _, done = segment(seed, t=32, n=24, p_done=0.1)
    if seed == 2:
        done[:] = False                               # no round finishes
    ep0 = rs.randint(0, 20, 24).astype(np.int32)
    atl0, tau = 11.5, 0.01
    jep, jatl = jstandalone._traj_len_ema(jnp.asarray(done),
                                          jnp.asarray(ep0),
                                          jnp.float32(atl0), tau)
    hep, hatl = jstandalone._traj_len_ema_host(done, ep0, atl0, tau)
    ep, atl = standalone._traj_len_ema(torch.from_numpy(done),
                                       torch.from_numpy(ep0), atl0, tau)
    assert (ep.numpy() == np.asarray(jep)).all()
    assert (ep.numpy() == hep).all()
    assert ep.dtype == torch.int32 and atl.dtype == torch.float32
    for ref in (float(jatl), hatl):
        assert abs(atl.item() - ref) <= 1e-5 * abs(ref)
    hep2, hatl2 = standalone._traj_len_ema_host(done, ep0, atl0, tau)
    assert (hep2 == hep).all() and hatl2 == hatl
    if seed == 2:
        assert atl.item() == np.float32(atl0)
