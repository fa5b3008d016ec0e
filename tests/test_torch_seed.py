"""A seed gives the JAX package's run: every random stream of the port
follows JAX's key chain, with nothing injected.

* ``FlaxInit`` (models/flax_init.py) against ``net.init(key, ...)`` for
  every net a trainer builds (PPONet's four trunks, full and worker-side,
  QNet, SIXten's VNet, SherlockNet) at ``SMALL`` widths: the leaves that
  flax draws uniformly (glorot_uniform) and the constant ones bit for bit,
  the normal-drawn ones (normal, lecun_normal's truncated normal) within
  INIT_RTOL relative, element by element (measured: 3.4e-7).
* ``rng.gumbel`` against ``jax.random.gumbel`` on a batch of keys, 1-D
  and 2-D shapes: the uniform bits equal, the values within GUMBEL_ULPS
  ulps of max(|value|, 1); ``distributions.categorical`` against
  ``jax.random.categorical``: the indices equal.
* Each trainer from one seed, the port's against the JAX package's, with
  nothing injected: single PPO, SVENton-DQN (pareto and adaptive
  epsilon), dual PPO, dual DQN, SIXten and Sherlock in both spaces.  The
  initial params as above, then one ``train_iteration`` each: every
  integer field of the rollout segment (the actions on every tick,
  pieces, players, dones) equal, the env state and the key bit-exact
  after it, and the stats within the trainer's own parity test's
  tolerance.  JAX's run of each is committed
  (tests/jax_fixtures/seed_CASE.npz, tests/torch_jax_fixtures.py); a
  ``slow`` test runs the JAX trainer again and holds it to the file.
* The league's random anchor and the CLI's ``random`` agent against JAX's
  ``init`` on their keys; the committed fixture of JAX's full-width run
  (data/seed_fixture.npz) against the port's trainer.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import (assert_state_equal, jax_leaves,
                                      rekey_jax_cache)

rekey_jax_cache()

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu.algos import replay as jreplay  # noqa: E402
from drl_tetris_tpu.algos import sherlock as jsherlock  # noqa: E402
from drl_tetris_tpu.algos import sixten as jsixten  # noqa: E402
from drl_tetris_tpu.algos import value_estimator as jve  # noqa: E402
from drl_tetris_tpu.env.env import EnvConfig as JEnvConfig  # noqa: E402
from drl_tetris_tpu.models import nets as jnets  # noqa: E402
from drl_tetris_tpu.runtime import standalone as jstandalone  # noqa: E402
from drl_tetris_tpu_torch import config  # noqa: E402
from drl_tetris_tpu_torch.algos import distributions as D  # noqa: E402
from drl_tetris_tpu_torch.algos import replay, sherlock, sixten  # noqa: E402
from drl_tetris_tpu_torch.algos.value_estimator import EstimatorConfig  # noqa: E402
from drl_tetris_tpu_torch.engine import rng  # noqa: E402
from drl_tetris_tpu_torch.env.env import EnvConfig  # noqa: E402
from drl_tetris_tpu_torch.models import nets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import params_from_flax  # noqa: E402
from drl_tetris_tpu_torch.runtime import standalone  # noqa: E402
from drl_tetris_tpu_torch.runtime.league import random_anchor  # noqa: E402
from tests.test_torch_dqn import configs as dqn_configs  # noqa: E402
from tests.test_torch_dual import assert_stats_close as ppo_stats_close  # noqa: E402
from tests.test_torch_nets import SMALL  # noqa: E402
from tests.test_torch_ppo import jax_ppo_config  # noqa: E402
from tests.test_torch_sixten import TINY  # noqa: E402
from tests.test_torch_sixten import assert_stats_close as stats_close  # noqa: E402
from tests import torch_jax_fixtures as fixtures  # noqa: E402

INIT_RTOL = 1e-6
GUMBEL_ULPS = 2
H, W = 22, 10
SEED = 11


def tkey(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(
        np.int64))


def dummy(h=H, w=W):
    return [jnp.zeros((1, 12))] * 2, [jnp.zeros((1, h, w, 1))] * 2


def normal_drawn(name: str, model) -> bool:
    """Whether flax draws the leaf from a normal: the keyboard head's bias,
    an output block's last two kernels (the value tower's, normal(0.01)),
    Sherlock's phi conv kernel, and the kernels the 'vanilla' and
    'keyboard' trunks leave to flax's default lecun_normal."""
    if name.endswith("kbd.conv.bias") or name == "phi_conv.weight":
        return True
    last = model.val_layers - 1
    if any(f"value_tower.convs.{i}.weight" in name for i in (last - 1, last)):
        return True
    return (model.architecture in ("vanilla", "keyboard")
            and name.endswith(".weight") and "a_dense" not in name
            and "kbd" not in name)


def assert_init_equal(jparams, net, model, where=""):
    """The port net's parameters against JAX's flax init: uniform-drawn and
    constant leaves bit for bit, normal-drawn ones within INIT_RTOL."""
    ref = params_from_flax(jax.tree.map(np.asarray, jparams))
    got = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    assert set(ref) == set(got), (where, set(ref) ^ set(got))
    for k, want in ref.items():
        if normal_drawn(k, model):
            err = ((got[k] - want).abs()
                   / want.abs().clamp(min=1e-30)).max().item()
            assert err <= INIT_RTOL, (where, k, err)
        else:
            assert torch.equal(got[k], want), (where, k)


# ---------------------------------------------------------------------------
# flax's initialisation
# ---------------------------------------------------------------------------

INIT_CASES = {
    "silver": ("PPONet", "silver", True), "silver_worker":
    ("PPONet", "silver", False), "dreamer": ("PPONet", "dreamer", True),
    "vanilla": ("PPONet", "vanilla", True), "vanilla_worker":
    ("PPONet", "vanilla", False), "keyboard": ("PPONet", "keyboard", True),
    "keyboard_worker": ("PPONet", "keyboard", False),
    "qnet": ("QNet", "silver", True), "vnet": ("VNet", "silver", True),
    "sherlock": ("SherlockNet", "silver", True)}


def jax_net(cls: str, model, full=True):
    if cls == "VNet":
        return jsixten.VNet(model)
    if cls == "SherlockNet":
        return jsherlock.SherlockNet(model)
    return getattr(jnets, cls)(model, full)


def port_net(cls: str, model, full=True):
    ctor = {"VNet": sixten.VNet, "SherlockNet": sherlock.SherlockNet}.get(
        cls) or getattr(nets, cls)
    return ctor(model, full_network=full, device="cpu")


@pytest.mark.parametrize("case", list(INIT_CASES))
def test_flax_init_is_jax_init(case):
    cls, arch, full = INIT_CASES[case]
    kw = dict(compute_dtype="float32", architecture=arch, **SMALL)
    key = jax.random.split(jax.random.PRNGKey(7), 3)[1]
    jparams = jax_net(cls, jnets.ModelConfig(**kw), full).init(key, *dummy())
    model = nets.ModelConfig(**kw)
    net = port_net(cls, model, full).init_flax_(tkey(key))
    assert_init_equal(jparams, net, model, case)


# ---------------------------------------------------------------------------
# The sampling noise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(40,), (6, 40), (3, 5, 7)])
def test_batched_gumbel_is_jax_gumbel(shape):
    keys = jax.random.split(jax.random.PRNGKey(3), 8).reshape(4, 2, -1)
    tk = tkey(keys)
    got = rng.gumbel(tk, shape).numpy()
    assert got.shape == (4, 2, *shape)
    for i in range(4):
        for j in range(2):
            k = keys[i, j]
            want_bits = np.asarray(jax.random.bits(k, shape, jnp.uint32))
            bits = rng.random_bits(tk[i, j], shape).numpy()
            assert (bits.astype(np.uint32) == want_bits).all()
            want = np.asarray(jax.random.gumbel(k, shape, jnp.float32))
            # ulps of the value, or of 1 near 0, where -log(-log(u)) turns
            # an ulp of the inner log into many of the result
            ulp = np.spacing(np.maximum(np.abs(want), np.float32(1)))
            err = (np.abs(got[i, j] - want) / ulp).max()
            assert err <= GUMBEL_ULPS, (i, j, err)


@pytest.mark.parametrize("n", [1, 64])
def test_categorical_is_jax_categorical(n):
    rs = np.random.RandomState(n)
    logits = np.log(rs.dirichlet(np.ones(40), size=n)).astype(np.float32)
    for i, k in enumerate(jax.random.split(jax.random.PRNGKey(5), 16)):
        want = np.asarray(jax.random.categorical(k, jnp.asarray(logits)))
        got = D.categorical(tkey(k), torch.from_numpy(logits)).numpy()
        assert (got == want).all(), (i, got, want)


# ---------------------------------------------------------------------------
# The trainers from one seed
# ---------------------------------------------------------------------------

# The shapes and settings of the trainers' own parity tests (test_torch_
# trainer, _dqn, _dual, _sixten, _sherlock) and of the rollout tests
# (test_torch_rollout, test_torch_dqn's pareto rollout), so that a cold
# run compiles each JAX program once for the files that share it (the
# persistent cache keys on the program, not on the seed or the weights).
PPO_KW = dict(n_envs=8, horizon=16, seed=SEED)
DQN_KW = dict(n_envs=8, horizon=16, epsilon=0.3, seed=SEED)
PLACE_KW = dict(n_envs=4, horizon=8, seed=SEED)


def ppo_config(single_policy=True):
    return dataclasses.replace(config.load("r5_learning").ppo,
                               single_policy=single_policy, minibatch_size=32,
                               n_train_epochs=2)


def ppo_case():
    ppo, model = ppo_config(), nets.ModelConfig(compute_dtype="float32",
                                                **SMALL)
    return (lambda: jstandalone.StandaloneTrainer(jstandalone.StandaloneConfig(
        env=JEnvConfig(), model=jnets.ModelConfig(**dataclasses.asdict(
            model)), ppo=jax_ppo_config(ppo), **PPO_KW)),
        lambda: standalone.StandaloneTrainer(standalone.StandaloneConfig(
            model=model, ppo=ppo, **PPO_KW), device="cpu"),
        model, lambda j, p: ppo_stats_close(j, p, 32))


def dual_ppo_case():
    ppo, model = ppo_config(False), nets.ModelConfig(compute_dtype="float32",
                                                     **SMALL)
    return (lambda: jstandalone.DualPolicyTrainer(jstandalone.DualPolicyConfig(
        env=JEnvConfig(), model=jnets.ModelConfig(**dataclasses.asdict(
            model)), ppo=jax_ppo_config(ppo), **PPO_KW)),
        lambda: standalone.DualPolicyTrainer(standalone.DualPolicyConfig(
            model=model, ppo=ppo, **PPO_KW), device="cpu"),
        model, lambda j, p: ppo_stats_close(j, p, 32))


def dqn_case(distribution, dual=False):
    got, ref = dqn_configs()
    kw = dict(DQN_KW, train_distribution=distribution)
    if dual:
        kw["horizon"] = 32
    jcls, cls = (("DualPolicyDQNConfig", "DualPolicyDQNTrainer") if dual
                 else ("StandaloneDQNConfig", "StandaloneDQNTrainer"))
    jtr = lambda: getattr(jstandalone, cls)(  # noqa: E731
        getattr(jstandalone, jcls)(env=ref.env, model=ref.model, dqn=ref.dqn,
                                   replay=ref.replay, **kw))
    tr = lambda: getattr(standalone, cls)(getattr(standalone, jcls)(  # noqa: E731
        env=got.env, model=got.model, dqn=got.dqn, replay=got.replay, **kw),
        device="cpu")
    if dual:
        return jtr, tr, got.model, lambda j, p: ppo_stats_close(
            j, p, got.dqn.minibatch_size)
    return jtr, tr, got.model, stats_close


def sixten_case(space):
    kw = dict(compute_dtype="float32", **TINY)
    rcfg = dict(capacity=200, k_step=3, height=H)
    common = dict(train_distribution="epsilon", epsilon=0.3,
                  action_space=space, **PLACE_KW)
    model = nets.ModelConfig(**kw)
    return (lambda: jstandalone.StandaloneSIXtenTrainer(
        jstandalone.StandaloneSIXtenConfig(
            env=JEnvConfig(), model=jnets.ModelConfig(**kw),
            replay=jreplay.ReplayConfig(**rcfg), **common),
        sixten_cfg=jsixten.SixtenConfig(
            n_samples_each_update=16, minibatch_size=8,
            estimator=jve.EstimatorConfig(k_step=3))),
        lambda: standalone.StandaloneSIXtenTrainer(
            standalone.StandaloneSIXtenConfig(
                env=EnvConfig(), model=model,
                replay=replay.ReplayConfig(**rcfg), **common),
            sixten_cfg=sixten.SixtenConfig(
                n_samples_each_update=16, minibatch_size=8,
                estimator=EstimatorConfig(k_step=3)), device="cpu"),
        model, stats_close)


def sherlock_case(space):
    kw = dict(compute_dtype="float32", **TINY)
    common = dict(action_space=space, **PLACE_KW)
    sk = dict(minibatch_size=8, n_train_epochs=2, lr=1e-4)
    model = nets.ModelConfig(**kw)
    return (lambda: jstandalone.StandaloneSherlockTrainer(
        jstandalone.SherlockTrainerConfig(
            env=JEnvConfig(), model=jnets.ModelConfig(**kw), **common),
        sherlock_cfg=jsherlock.SherlockConfig(**sk)),
        lambda: standalone.StandaloneSherlockTrainer(
            standalone.SherlockTrainerConfig(env=EnvConfig(), model=model,
                                             **common),
            sherlock_cfg=sherlock.SherlockConfig(**sk), device="cpu"),
        model, stats_close)


TRAINERS = {
    "ppo": ppo_case, "dqn_pareto": lambda: dqn_case("pareto_distribution"),
    "dqn_epsilon": lambda: dqn_case("adaptive_epsilon"),
    "dual_ppo": dual_ppo_case,
    "dual_dqn": lambda: dqn_case("adaptive_epsilon", dual=True),
    "sixten_top_drop": lambda: sixten_case("top_drop"),
    "sixten_full": lambda: sixten_case("full"),
    "sherlock_top_drop": lambda: sherlock_case("top_drop"),
    "sherlock_full": lambda: sherlock_case("full")}


def recorded(obj):
    """Wrap ``obj.rollout`` to keep each call's segment."""
    segs = []
    roll = obj.rollout

    def rollout(*args, **kwargs):
        out = roll(*args, **kwargs)
        segs.append(out[1])
        return out
    obj.rollout = rollout
    return segs


def jax_ppo_iteration(jtr):
    """The JAX PPO trainer's ``train_iteration`` by its parts: the fused
    program's rollout on kroll, GAE and update on kupd (key, kstep =
    split(key); kroll, kupd = split(kstep)), each its own program, so that
    the segment reaches the host and the rollout compiles once.  Returns
    ([segment], stats)."""
    from drl_tetris_tpu.utils.metrics import fetch_stats
    jtr.key, kstep = jax.random.split(jtr.key)
    kroll, kupd = jax.random.split(kstep)
    jtr.env_state, seg, v_last = jtr.rollout(jtr.state.params,
                                             jtr.env_state, kroll)
    batch, gae_stats = jtr._proc(seg, v_last)
    jtr.state, stats = jtr.update(jtr.state, batch, kupd)
    stats.update(gae_stats)
    jtr.total_steps += jtr.cfg.n_envs * jtr.cfg.horizon
    return [seg], fetch_stats(stats)


def jax_learner_params(jtr):
    if hasattr(jtr, "states"):
        return [s.params for s in jtr.states]
    return [jtr.state.params]


def segment_ints(seg) -> dict:
    """A segment's integer fields (the actions of every tick, pieces,
    players, dones; Sherlock's action is the 0/1 plane ``delta``)."""
    out = {f: np.asarray(getattr(seg, f)) for f in seg._fields}
    return {f: a for f, a in out.items()
            if a.dtype.kind != "f" or f == "delta"}


def jax_seeded_run(case) -> dict:
    """The JAX trainer of ``case`` from its seed, nothing injected: its
    initial params, the env state after its reset, then one
    ``train_iteration``: the segment's integer fields, the env state and
    the key after it, and the stats (tests/jax_fixtures/seed_CASE.npz)."""
    jtr = TRAINERS[case]()[0]()
    out = dict(params=[jax.tree.map(np.asarray, p)
                       for p in jax_learner_params(jtr)],
               reset=jax_leaves(jtr.env_state))
    if case == "ppo":
        jsegs, jstats = jax_ppo_iteration(jtr)
    else:
        jsegs = recorded(jtr)
        jstats = jtr.train_iteration()
    assert len(jsegs) == 1 and jstats
    out.update(segment=segment_ints(jsegs[0]),
               state=jax_leaves(jtr.env_state),
               key=np.asarray(jax.random.key_data(jtr.key)),
               stats={k: float(v) for k, v in jstats.items()})
    return out


def assert_segments_equal(jseg: dict, seg, where):
    """Every integer field of JAX's segment equal; on a mismatch, the first
    differing tick and game."""
    for f, a in jseg.items():
        b = getattr(seg, f).cpu().numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        bad = np.argwhere(a != b)
        assert not len(bad), (where, f, bad[:3].tolist(), a[tuple(bad[0])],
                              b[tuple(bad[0])])
    assert len(jseg) >= 4, (where, list(jseg))      # actions among them


@pytest.mark.parametrize("case", list(TRAINERS))
def test_seeded_trainer_is_the_jax_run(case):
    ref = fixtures.load(f"seed_{case}")
    _, port_trainer, model, assert_stats = TRAINERS[case]()
    tr = port_trainer()
    nets_ = getattr(tr, "nets", [tr.net])
    assert len(ref["params"]) == len(nets_)
    for k, (jp, net) in enumerate(zip(ref["params"], nets_)):
        assert_init_equal(jp, net, model, f"{case} policy {k}")
    assert_state_equal(ref["reset"], tr.env_state, "reset")
    segs = recorded(tr)
    stats = tr.train_iteration()
    assert len(segs) == 1
    assert_segments_equal(ref["segment"], segs[0], case)
    assert_state_equal(ref["state"], tr.env_state, "after the iteration")
    assert (ref["key"] == tr.key.numpy().astype(np.uint32)).all()
    jstats = {k: float(v) for k, v in ref["stats"].items()}
    assert jstats and stats
    assert_stats(jstats, stats)


# slow: JAX's trainers, 110-260 s each cold
@pytest.mark.slow
@pytest.mark.parametrize("case", list(TRAINERS))
def test_seeded_trainer_fixture_regenerates(case):
    fixtures.regenerates(f"seed_{case}", lambda: jax_seeded_run(case))


# ---------------------------------------------------------------------------
# The league's anchor and the CLI's random agent
# ---------------------------------------------------------------------------

def test_league_anchor_is_jax_init():
    """drl_tetris_tpu/cli/main.py:162: ``net.init(PRNGKey(0xE10), ...)``."""
    kw = dict(compute_dtype="float32", **SMALL)
    jparams = jnets.PPONet(jnets.ModelConfig(**kw)).init(
        jax.random.PRNGKey(0xE10), *dummy())
    model = nets.ModelConfig(**kw)
    anchor = random_anchor(nets.PPONet(model, device="cpu"))
    assert_init_equal(jparams, anchor, model, "anchor")


def test_cli_random_agent_is_jax_init():
    """drl_tetris_tpu/cli/main.py:466: ``net.init(PRNGKey(0), ...)`` of the
    flavour's net (here SVENton-DQN's QNet)."""
    from drl_tetris_tpu_torch.cli.main import _load_agent
    got, ref = dqn_configs()
    jparams = jnets.QNet(ref.model).init(jax.random.PRNGKey(0), *dummy())
    agent, _ = _load_agent("random", got, device="cpu")
    assert isinstance(agent.net, nets.QNet)
    assert_init_equal(jparams, agent.net, got.model, "random")


def test_committed_seed_fixture_holds_on_the_cpu():
    """data/seed_fixture.npz (tests/torch_seed_fixture.py, JAX's full-width
    StandaloneTrainer(seed=7)) against the port's trainer on the CPU: the
    check chip_smoke.py [seed] makes on the card (runtime/seeded.py)."""
    from drl_tetris_tpu_torch.runtime import seeded
    errs = seeded.fixture_errors("cpu", iterate=False)
    errs.pop("trainer")
    seeded.check_fixture(errs)
    assert errs["exact_leaves"] == errs["leaves"] == 64
