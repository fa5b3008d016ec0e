"""The engine tick kernel's host build (csrc/engine_tick_host.cpp: the
kernel's own warp-form tick, with each warp's lanes as arrays of 32 values)
against the plain PyTorch tick, bit for bit on every leaf, reward and done
flag, where the warp mapping has its edges:

* the kernel's limits, height 32, width 25, garbage cap 64: every lane holds
  a board row and a second FIFO slot.  The start state has crowded FIFOs
  (``engine.checks.crowded``), so that pops and blocks cross slot 32;
* a game count (37) that is not a multiple of the kernel's 4 games per
  CUDA block.  The host form runs each warp's work game by game, so it has
  no blocks: the early return of the warps past the last game is covered
  on the card (tests/test_torch_cuda.py, chip_smoke.py, 1001 games);

and the host definitions of the lane primitives against numpy.  The plain
tick is held against JAX in tests/test_torch_engine.py, so nothing here
compiles JAX.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import ctypes  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu_torch.engine import cuda_tick  # noqa: E402
from drl_tetris_tpu_torch.engine.checks import crowded  # noqa: E402
from drl_tetris_tpu_torch.engine.core import EngineConfig  # noqa: E402
from drl_tetris_tpu_torch.env.env import (EnvConfig, TetrisVectorEnv,  # noqa: E402
                                          step_plain)
from tests.test_torch_engine import (assert_torch_states_equal,  # noqa: E402
                                     greedy_actions, host_kernel_lib,
                                     host_rollout, host_step)

N_TICKS = 40
CASES = {
    # name: (config, games, crowded start)
    "limits": (EnvConfig(engine=EngineConfig(height=32, width=25,
                                             garbage_cap=64)), 32, True),
    "ragged": (EnvConfig(), 37, False),
}


@pytest.fixture(scope="module")
def lib():
    lib = host_kernel_lib()
    if lib is None:
        pytest.skip("no g++ to build the kernel's host form")
    return lib


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_kernel_matches_plain_at(lib, case):
    """The one-tick entry tick by tick with reward and done, then the
    T-tick entry with the same replayed actions and with in-kernel random
    actions, from the same start; with round ends, line clears and (at the
    limits) pops from FIFOs longer than one warp on the way."""
    cfg, n, crowd = CASES[case]
    start = TetrisVectorEnv(cfg, n, device="cpu").reset(5)
    if crowd:
        start = crowded(cfg, start, 5)
    gen = torch.Generator().manual_seed(5)
    random_rows = torch.rand(n, 2, generator=gen) < 0.35
    hs = ps = start
    ars, ats = [], []
    dones = clears = long_pops = 0
    for tick in range(N_TICKS):
        r, t = greedy_actions(cfg, ps, random_rows, gen)
        ars.append(r)
        ats.append(t)
        prev = ps.engine.players
        hs, hr, hd = host_step(lib, cfg, hs, r, t)
        ps, pr, pd = step_plain(cfg, ps, r, t)
        assert torch.equal(hr, pr) and torch.equal(hd, pd), tick
        assert_torch_states_equal(hs, ps, f"{case} step {tick}")
        cur = ps.engine.players
        dones += int(pd.sum())
        clears += int((cur.lines_cleared > prev.lines_cleared).sum())
        long_pops += int(((prev.g_size > 32) & (cur.g_size < prev.g_size)
                          ).sum())
    assert dones > 0 and clears > 0, (dones, clears)
    if crowd:
        assert long_pops > 0
    actions = (torch.stack(ars).contiguous(), torch.stack(ats).contiguous())
    ro = host_rollout(lib, cfg, start, N_TICKS, actions=actions)
    assert_torch_states_equal(ro, ps, f"{case} rollout replayed")
    base = torch.tensor([31, 7], dtype=torch.int64)
    ro = host_rollout(lib, cfg, start, N_TICKS, base_key=base, block_games=n)
    ref = cuda_tick.rollout_plain(cfg, start, N_TICKS, base_key=base,
                                  block_games=n)
    assert_torch_states_equal(ro, ref, f"{case} rollout random")
    assert int((ref.rounds_played - start.rounds_played).sum()) > 0


def test_lane_primitives_match_numpy(lib):
    """ballot, any, bcast, the add/min/or reductions, gather, the
    zero-filled shuffles and the inclusive scan of the host form, on random
    words, against numpy (sums wrap at 32 bits)."""
    fn = lib.engine_tick_host_lanes
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    rs = np.random.RandomState(0)
    lanes = np.arange(32)
    for case in range(200):
        v = rs.randint(0, 2 ** 32, 32, dtype=np.uint64).astype(np.uint32)
        if case % 4 == 0:
            v &= 0x1F                     # small values: min ties, no wrap
        p = (rs.rand(32) < [0.0, 0.03, 0.5, 1.0][case % 4]).astype(np.uint8)
        src = rs.randint(0, 32, 32).astype(np.int32)
        n = [0, 1, 2, 5, 17, 31, 32, 40][case % 8]
        k = int(rs.randint(0, 32))
        out = np.zeros(134, dtype=np.uint32)
        fn(v.ctypes.data, p.ctypes.data, src.ctypes.data, n, k,
           out.ctypes.data)
        assert out[0] == int((p.astype(np.uint64) << lanes.astype(
            np.uint64)).sum()), case
        assert out[1] == int(p.any())
        assert out[2] == v[k]
        assert out[3] == int(v.astype(np.uint64).sum() % 2 ** 32)
        assert out[4].view(np.int32) == v.view(np.int32).min()
        assert out[5] == np.bitwise_or.reduce(v)
        assert (out[6:38] == v[src]).all()
        down = np.where(lanes + n < 32, v[np.minimum(lanes + n, 31)], 0)
        up = np.where(lanes >= n, v[np.maximum(lanes - n, 0)], 0)
        assert (out[38:70] == down).all(), (case, n)
        assert (out[70:102] == up).all(), (case, n)
        scan = (np.cumsum(v.astype(np.uint64)) % 2 ** 32).astype(np.uint32)
        assert (out[102:134] == scan).all()
