"""The port's PPO learner (algos/ppo.py) against the JAX package's
``algos/ppo.py`` on the same seeded batch, weights, keys and Adam state.

* ``compressor_apply``: outputs, running state and saturation within 1e-6
  over a sequence of calls that saturates.
* ``augment_batch``: bit-exact.
* one ``update_fn`` on a small float32 net (``SMALL``), 128 samples,
  minibatch 32, 2 epochs (8 Adam steps), under the main path's default
  PPOConfig, the ``r5_learning`` one, and one with every optional term on
  (entropy bonus, floor and rescaled entropy, the standalone floor,
  cautious compressors, mirror augmentation).  Both sides shuffle with the
  same ``permutation`` of the same key.  Adam divides by sqrt(v) + eps, so
  a weight whose gradient is ulps from zero can step +lr in one framework
  and -lr in the other; the test holds
  - the gradients of the first minibatch per leaf within GRAD_TOL of that
    leaf's largest |g| (JAX's gradients recorded by an optax stage before
    Adam),
  - the last minibatch's loss terms within STAT_TOL (relative, floor
    1e-6), the compressor states within COMP_TOL (relative),
  - the parameters after the update within 2 x lr x steps + 1e-6: at most
    every step of a weight's moves opposite.
Measured on the CPU over the three configs: first-minibatch gradients 2.7e-5
of the leaf's largest, loss terms 4.1e-5 relative, compressor states 2.5e-7
relative, parameters 6.7e-5 absolute (lr 1e-4, 8 and 16 steps).  The
tolerances are about 4x the measured gaps.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.algos import ppo as jppo  # noqa: E402
from drl_tetris_tpu.engine.core import EngineConfig as JEngineConfig  # noqa: E402
from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu_torch import config  # noqa: E402
from drl_tetris_tpu_torch.algos import ppo  # noqa: E402
from drl_tetris_tpu_torch.engine import rng  # noqa: E402
from drl_tetris_tpu_torch.engine.core import EngineConfig  # noqa: E402
from drl_tetris_tpu_torch.env.observations import field_grid  # noqa: E402
from drl_tetris_tpu_torch.models import nets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import params_from_flax  # noqa: E402
from tests.test_torch_nets import SMALL, small_params  # noqa: E402

B, MB, EPOCHS = 128, 32, 2
GRAD_TOL = 1e-4
STAT_TOL = 2e-4
COMP_TOL = 1e-5
ALL_TERMS = dict(entropy_loss=0.01, entropy_floor_loss=1.0,
                 rescaled_entropy=0.1, entropy_floor_standalone=10.0,
                 ppo_epsilon=0.05, lr=1e-4, augment_data=True,
                 compress_advantages=ppo.CompressorConfig(cautious=True),
                 compress_value_loss=ppo.CompressorConfig(cautious=True))


def jax_ppo_config(cfg: ppo.PPOConfig) -> jppo.PPOConfig:
    """The JAX PPOConfig with the port's field values."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, ppo.CompressorConfig):
            v = jppo.CompressorConfig(**dataclasses.asdict(v))
        kw[f.name] = v
    return jppo.PPOConfig(**kw)


def seeded_batch(n, seed, width=10, height=22):
    """A training batch from a numpy seed, as numpy arrays in the port's
    Batch field order (occ as uint32)."""
    rs = np.random.RandomState(seed)
    occ = rs.randint(0, 1 << width, (n, 2, height)).astype(np.uint32)
    occ[:, :, : height // 2] = 0                     # empty upper half
    vec = rs.rand(n, 2, 12).astype(np.float32)
    return [occ, vec, rs.randint(0, 7, n).astype(np.int32),
            rs.randint(0, 4, n).astype(np.int32),
            rs.randint(0, width, n).astype(np.int32),
            rs.uniform(0.005, 0.3, n).astype(np.float32),
            (0.5 * rs.randn(n) * np.where(rs.rand(n) < 0.05, 12.0, 1.0)
             ).astype(np.float32),
            np.tanh(rs.randn(n)).astype(np.float32)]


def near_policy(arrays, net, seed):
    """old_prob set to the net's own p(a) times exp(0.1 N(0, 1)): most
    ratios fall inside the clip range and the surrogate has a gradient."""
    b = to_torch_batch(arrays)
    grids = field_grid(EngineConfig(), b.occ)
    with torch.no_grad():
        pi, _ = net([b.vec[:, 0], b.vec[:, 1]],
                    [grids[:, 0, ..., None], grids[:, 1, ..., None]])
    p = pi[torch.arange(len(b.piece)), b.rot.long(), b.trans.long(),
           b.piece.long()].numpy()
    noise = np.exp(0.1 * np.random.RandomState(seed).randn(len(p)))
    arrays[5] = (p * noise).astype(np.float32)
    return arrays


def to_jax_batch(arrays):
    return jppo.Batch(*[jnp.asarray(a) for a in arrays])


def to_torch_batch(arrays):
    occ = arrays[0].view(np.int32)
    return ppo.Batch(*[torch.from_numpy(np.ascontiguousarray(a))
                       for a in [occ] + arrays[1:]])


# ---------------------------------------------------------------------------
# compressor, augmentation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cautious", (False, True))
def test_compressor_matches_jax(cautious):
    c = ppo.CompressorConfig(lr=0.05, cautious=cautious)
    jc = jppo.CompressorConfig(**dataclasses.asdict(c))
    rs = np.random.RandomState(1)
    jst, st = jppo.compressor_init(), ppo.compressor_init()
    sats = []
    for k in range(6):
        # outliers large against the running mean: the clip saturates
        x = (rs.randn(64) * (1.0 + 3 * k)).astype(np.float32)
        x[:3] *= 40.0
        jy, jst, jsat = jppo.compressor_apply(jc, jst, jnp.asarray(x))
        y, st, sat = ppo.compressor_apply(c, st, torch.from_numpy(x))
        assert np.abs(np.asarray(jy) - y.numpy()).max() < 1e-6 * max(
            1.0, np.abs(np.asarray(jy)).max())
        for a, b in zip(jst, st):
            assert abs(float(a) - b.item()) < 1e-6 * max(1.0, float(a))
        assert float(jsat) == sat.item()
        sats.append(sat.item())
    assert max(sats) > 0.0


def test_compressor_passes_gradient_to_x_only():
    c = ppo.CompressorConfig()
    x = torch.tensor([0.5, -2.0, 30.0], requires_grad=True)
    st = ppo.CompressorState(torch.tensor(2.0), torch.tensor(4.0))
    y, new, _ = ppo.compressor_apply(c, st, x)
    y.sum().backward()
    # clip = min(3 * 4 / 2, 8) = 6: 30 / 2 = 15 is clipped, no gradient
    assert x.grad.tolist() == [0.5, 0.5, 0.0]
    assert not new.x_mean.requires_grad and not new.x_max.requires_grad


def test_augment_batch_bit_exact():
    arrays = seeded_batch(40, 2)
    jb = jppo.augment_batch(JEngineConfig(), to_jax_batch(arrays))
    tb = ppo.augment_batch(EngineConfig(), to_torch_batch(arrays))
    for name, a, b in zip(ppo.Batch._fields, jb, tb):
        a, b = np.asarray(a), b.numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert (a == b).all(), name


# ---------------------------------------------------------------------------
# one update
# ---------------------------------------------------------------------------

def recorder():
    """An optax stage that passes gradients through and keeps the first
    step's."""
    def init(params):
        return (jnp.int32(0), jax.tree.map(jnp.zeros_like, params))

    def update(g, state, params=None):
        n, first = state
        first = jax.tree.map(lambda f, x: jnp.where(n == 0, x, f), first, g)
        return g, (n + 1, first)
    return optax.GradientTransformation(init, update)


def sharp_params(seed):
    """SMALL params with the keyboard kernel scaled up: some samples'
    action planes fall below the entropy floor."""
    p = small_params(seed)
    kbd = p["SventonNet_0"]["KeyboardConv_0"]["Conv_0"]
    kbd["kernel"] = kbd["kernel"] * 12.0
    return p


def relerr(a, b):
    return abs(a - b) / max(1e-6, abs(a))


CONFIGS = {"default": config.load().ppo,
           "r5_learning": config.load("r5_learning").ppo,
           "all_terms": dataclasses.replace(config.load().ppo, **ALL_TERMS)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def both_updates(request):
    cfg = dataclasses.replace(CONFIGS[request.param], minibatch_size=MB,
                              n_train_epochs=EPOCHS)
    params = sharp_params(5)
    seed = 17
    net = nets.PPONet(nets.ModelConfig(compute_dtype="float32", **SMALL),
                      device="cpu")
    net.load_state_dict(params_from_flax(params))
    arrays = near_policy(seeded_batch(B, 6), net, 7)

    jnet = jnets.PPONet(jnets.ModelConfig(compute_dtype="float32", **SMALL))
    tx = optax.chain(recorder(), optax.adam(cfg.lr))
    jinit, jupdate = jppo.make_ppo_update(JEngineConfig(), jnet,
                                          jax_ppo_config(cfg), optimizer=tx)
    jstate, jstats = jupdate(jinit({"params": params}),
                             to_jax_batch(arrays), jax.random.PRNGKey(seed))
    jgrads = params_from_flax(
        jax.tree.map(np.asarray, jstate.opt_state[0][1]["params"]))

    init_fn, update_fn = ppo.make_ppo_update(EngineConfig(), net, cfg)
    batch = to_torch_batch(arrays)
    key = rng.prng_key(seed)

    grads, _ = ppo.first_step_gradients(EngineConfig(), cfg, net, batch,
                                        key)
    state, stats = update_fn(init_fn(), batch, key)
    return dict(cfg=cfg, name=request.param, params=params_from_flax(params),
                jstate=jstate, jstats=jstats, jgrads=jgrads,
                grads=grads, state=state, stats=stats)


def test_update_first_minibatch_gradients(both_updates):
    r = both_updates
    assert set(r["grads"]) == set(r["jgrads"])
    for k, g in r["grads"].items():
        jg = r["jgrads"][k]
        scale = jg.abs().max().item()
        err = (g - jg).abs().max().item()
        assert err <= GRAD_TOL * scale + 1e-12, (k, err, scale)
    # the gradients are not degenerate
    assert max(g.abs().max().item() for g in r["jgrads"].values()) > 1e-3


def test_update_loss_terms_and_compressors(both_updates):
    r = both_updates
    stats = {k: v.item() for k, v in r["stats"].items()}
    jstats = {k: float(v) for k, v in r["jstats"].items()}
    assert set(stats) == set(jstats)
    for k, v in jstats.items():
        if "saturation" in k:
            # a fraction of the minibatch: one flip moves it by 1/MB
            assert abs(v - stats[k]) <= 1.0 / MB + 1e-6, (k, v, stats[k])
        else:
            assert relerr(v, stats[k]) < STAT_TOL, (k, v, stats[k])
    for jc, c in ((r["jstate"].adv_comp, r["state"].adv_comp),
                  (r["jstate"].vloss_comp, r["state"].vloss_comp)):
        for a, b in zip(jc, c):
            assert relerr(float(a), b.item()) < COMP_TOL
    assert r["state"].update_count == int(r["jstate"].update_count) == 1
    if r["cfg"].entropy_floor_standalone:
        assert jstats["losses/entropy_floor_penalty"] > 0.0


def test_update_parameters(both_updates):
    r = both_updates
    cfg = r["cfg"]
    n = B * (2 if cfg.augment_data else 1)
    steps = EPOCHS * (n // MB)
    tol = 2 * cfg.lr * steps + 1e-6
    jparams = params_from_flax(jax.tree.map(
        np.asarray, r["jstate"].params["params"]))
    moved = 0.0
    for k, p in r["state"].net.named_parameters():
        err = (p.detach() - jparams[k]).abs().max().item()
        assert err <= tol, (k, err, tol)
        moved = max(moved, (p.detach() - r["params"][k]).abs().max().item())
    assert moved > 0.5 * cfg.lr                    # the update did move
    # the torch Adam state holds every parameter, once
    assert len(r["state"].optimizer.state) == len(r["params"])


def test_loss_sees_exactly_the_flax_leaves():
    """The L2 term runs over net.parameters(): the same leaves and element
    count as the flax tree (no buffer such as the piece mask is one)."""
    params = small_params(0)
    leaves = jax.tree.leaves(params)
    net = nets.PPONet(nets.ModelConfig(compute_dtype="float32", **SMALL),
                      device="cpu")
    ps = list(net.parameters())
    assert len(ps) == len(leaves)
    assert sum(p.numel() for p in ps) == sum(a.size for a in leaves)
    assert not any(b is p for b in net.buffers() for p in ps)


def test_workers_computes_advantages_false_is_not_ported():
    """Trainer-computed targets are ported (tests/test_torch_ppo_modes.py);
    what that mode does not take, as in the JAX package, is the mirror
    augmentation, a worker-computes-advantages feature."""
    cfg = dataclasses.replace(ppo.PPOConfig(),
                              workers_computes_advantages=False,
                              augment_data=True)
    net = nets.PPONet(nets.ModelConfig(compute_dtype="float32", **SMALL),
                      device="cpu")
    with pytest.raises(ValueError):
        ppo.make_ppo_update(EngineConfig(), net, cfg)
    init_fn, _ = ppo.make_ppo_update(
        EngineConfig(), net, dataclasses.replace(cfg, augment_data=False))
    state = init_fn()
    assert state.ref_countdown == 0 and state.ref_net is not net
