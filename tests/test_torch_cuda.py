"""The port's kernels against their plain PyTorch versions on the card: the
engine tick kernel (csrc/engine_tick.cu), every state leaf, reward and done
flag bit for bit; the residual layers' epilogue (csrc/net_epilogue.cu) bit
for bit at the main path's shapes and at every other layer the registry
builds, and the 'silver' net's no-grad forward on the NHWC path against
its NCHW path (31 launches a full forward, 25 a worker-side one); the
SIXten trainer with its CUDA graphs (the search's choice, each
minibatch's forward and backward) bit for bit against the same trainer
without them.

These tests need an NVIDIA GPU and nvcc, and skip elsewhere.  They share
their inputs and comparison with chip_smoke.py (engine/checks.py).  On a
machine with a card and without JAX, run them without the suite's conftest
(which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import sys

import torch  # noqa: I001  (first: see test_torch_harness)

if "jax" in sys.modules:          # under the suite's conftest
    from tests.test_torch_harness import rekey_jax_cache
    rekey_jax_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu_torch.engine import cuda_tick  # noqa: E402
from drl_tetris_tpu_torch.engine.checks import (compare_entries,  # noqa: E402
                                                crowded, replayed_actions)
from drl_tetris_tpu_torch.engine.core import EngineConfig, tree_leaves  # noqa: E402
from drl_tetris_tpu_torch.env.env import (EnvConfig, TetrisVectorEnv,  # noqa: E402
                                          step_plain)
from drl_tetris_tpu_torch.models import checks as net_checks  # noqa: E402

pytestmark = pytest.mark.cuda

N, T = 256, 48


@pytest.fixture
def env():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return TetrisVectorEnv(EnvConfig(), N, device="cuda")


def actions(width, seed):
    rs = np.random.RandomState(seed)
    r = rs.randint(0, 4, (T, N)).astype(np.int32)
    t = rs.randint(0, width, (T, N)).astype(np.int32)
    return torch.from_numpy(r).cuda(), torch.from_numpy(t).cuda()


def assert_bits_equal(a, b, where):
    for (name, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert x.dtype == y.dtype and x.shape == y.shape, (where, name)
        assert torch.equal(x, y), (where, name)


def test_step_entry_matches_plain(env):
    ar, at = actions(env.cfg.engine.width, 0)
    ks = ps = env.reset(3)
    before = cuda_tick.LAUNCHES["step"]
    dones = 0
    for k in range(T):
        ks, kr, kd = env.step(ks, ar[k], at[k])
        ps, pr, pd = step_plain(env.cfg, ps, ar[k], at[k])
        assert_bits_equal(ks, ps, f"tick {k}")
        assert torch.equal(kr, pr) and torch.equal(kd, pd), k
        dones += int(kd.sum())
    assert cuda_tick.LAUNCHES["step"] - before == T
    assert dones > 0
    cuda_tick.raise_if_overflowed(ks.current_player.device)


def test_rollout_entry_matches_plain(env):
    start = env.reset(4)
    acts = actions(env.cfg.engine.width, 1)
    ker = cuda_tick.rollout(env.cfg, start, T, actions=acts)
    ref = cuda_tick.rollout_plain(env.cfg, start, T, actions=acts)
    assert_bits_equal(ker, ref, "replayed")
    assert int((ker.rounds_played - start.rounds_played).sum()) > 0
    base = torch.tensor([17, 3], dtype=torch.int64)
    ker = cuda_tick.rollout(env.cfg, start, T, base_key=base, block_games=64)
    ref = cuda_tick.rollout_plain(env.cfg, start, T, base_key=base,
                                  block_games=64)
    assert_bits_equal(ker, ref, "random actions")


EDGES = {
    # name: (config, games, crowded start)
    "limits": (EnvConfig(engine=EngineConfig(height=32, width=25,
                                             garbage_cap=64)), N, True),
    "ragged": (EnvConfig(), 1001, False),     # the last block holds 1 game
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_entries_match_plain_at(case):
    """Both entries against the plain version with replayed actions: at the
    kernel's limits (every lane a row and a second FIFO slot, from crowded
    FIFOs) and at a game count that is not a multiple of the games per CUDA
    block, so that warps past the last game return."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, n, crowd = EDGES[case]
    start = TetrisVectorEnv(cfg, n, device="cuda").reset(9)
    if crowd:
        start = crowded(cfg, start, 9)
    ar, at = replayed_actions(cfg, T, n, 3, "cuda")
    roll_err, step_err, dones, played = compare_entries(cfg, start, ar, at)
    assert roll_err == 0.0 and step_err == 0.0, (roll_err, step_err)
    assert dones > 0 and played > 0


LAYERS = {**net_checks.MAIN_PATH, **net_checks.OTHERS}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_epilogue_kernel_matches_plain(name):
    """The kernel on channels-last inputs against the eager chain on the
    same values in NCHW, each followed by the layer's pool: bit for bit,
    at 1024 boards for the main path's layers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    boards = net_checks.BOARDS if name in net_checks.MAIN_PATH else 64
    r = net_checks.kernel_vs_plain(LAYERS[name], boards)
    assert r["bit_exact"], r
    assert r["launches"] == 1 and r["channels_last"], r


@pytest.mark.parametrize("full_network", [True, False])
def test_silver_forward_nhwc_against_nchw(full_network):
    """The 'silver' PPONet at the main path's widths, no grad: the NHWC
    path against the NCHW path on the same 1024 boards; the epilogue
    launches once a residual layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = net_checks.silver_forward_paths(1024, seed=1,
                                        full_network=full_network)
    assert r["launches"] == (31 if full_network else 25), r
    assert r["pi_gap"] <= net_checks.PATH_TOL["pi"], r
    assert r["v_gap"] <= net_checks.PATH_TOL["v"], r


def test_sixten_trainer_graphs_match_eager():
    """Three iterations of the SIXten trainer at the 'silver' widths, 8 games
    x 8 ticks, updates of 256 samples in minibatches of 64: with its CUDA
    graphs and without, the games, the replay, the weights, Adam's moments
    and the stats agree bit for bit, and the graphs replayed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from drl_tetris_tpu_torch.algos.replay import ReplayConfig
    from drl_tetris_tpu_torch.algos.sixten import SixtenConfig
    from drl_tetris_tpu_torch.runtime.standalone import (
        StandaloneSIXtenConfig, StandaloneSIXtenTrainer)
    from drl_tetris_tpu_torch.utils import graphs
    scfg = SixtenConfig(lr=1e-3, n_samples_each_update=256, minibatch_size=64,
                        time_to_reference_update=2)
    runs = []
    for cuda_graphs in (False, True):
        tr = StandaloneSIXtenTrainer(StandaloneSIXtenConfig(
            replay=ReplayConfig(capacity=1024, sample_mode="rank"),
            n_envs=8, horizon=8, seed=5, cuda_graphs=cuda_graphs),
            sixten_cfg=scfg, device="cuda")
        before = graphs.REPLAYS["graph"]
        stats = [tr.train_iteration() for _ in range(6)]
        replays = graphs.REPLAYS["graph"] - before
        adam = [tr.state.optimizer.state[p][k] for p in tr.net.parameters()
                for k in ("exp_avg", "exp_avg_sq")]
        runs.append((tr, stats, replays, adam))
    (eager, s_eager, r_eager, a_eager), (graph, s_graph, r_graph, a_graph) \
        = runs
    assert r_eager == 0
    # a segment's 8 ticks and its bootstrap, 4 minibatches an update
    assert graph.state.update_count >= 2
    assert r_graph == 6 * 9 + 4 * graph.state.update_count
    assert_bits_equal(eager.env_state, graph.env_state, "games")
    for f in ("occ", "vec", "piece", "prio"):
        assert torch.equal(getattr(eager.replay, f), getattr(graph.replay, f)
                           ), f
    for (name, p), q in zip(eager.net.named_parameters(),
                            graph.net.parameters()):
        assert torch.equal(p, q), name
    for a, b in zip(a_eager, a_graph):
        assert torch.equal(a, b)
    assert s_eager == s_graph
