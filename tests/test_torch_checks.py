"""engine/checks.py's comparisons, which hold the engine kernel against its
plain version on the card (chip_smoke.py, tests/test_torch_cuda.py): the
one-tick entry's recorded ticks go through ``step_plain`` batched along the
game axis (``hold_ticks``).  On the CPU the entries are the plain version
itself, so these tests check the batching: every split of the ticks into
``step_plain`` calls gives the same verdict, macro and per-kind ticks mix,
and one changed value anywhere in one game of one tick is found.
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from drl_tetris_tpu_torch.engine import checks, cuda_tick  # noqa: E402
from drl_tetris_tpu_torch.engine.core import tree_leaves, tree_map  # noqa: E402
from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv  # noqa: E402

N, T = 12, 10


@pytest.fixture(scope="module")
def start():
    cfg = EnvConfig()
    return cfg, checks.crowded(cfg, TetrisVectorEnv(cfg, N, device="cpu")
                               .reset(3), 3)


@pytest.fixture(scope="module")
def ticks(start):
    """T ticks alternating macro and mixed per-kind actions."""
    cfg, st = start
    rs = np.random.RandomState(5)
    ar, at = checks.replayed_actions(cfg, T, N, 5, "cpu")
    out = []
    for k in range(T):
        if k % 2:
            kind, r, t, y = checks.kind_actions(cfg, st, "mixed", rs)
            inputs = (cfg, st, r, t, kind, y)
        else:
            inputs = (cfg, st, ar[k], at[k])
        res = cuda_tick.step(*inputs)
        out.append((inputs, res))
        st = res[0]
    return out


def test_compare_entries_from_a_crowded_start(start):
    cfg, st = start
    ar, at = checks.replayed_actions(cfg, T, N, 7, "cpu")
    roll_err, step_err, dones, played = checks.compare_entries(cfg, st, ar,
                                                               at)
    assert roll_err == 0.0 and step_err == 0.0
    assert dones > 0 and played == dones


@pytest.mark.parametrize("mode", checks.KIND_MODES)
def test_compare_kinds_from_a_crowded_start(start, mode):
    cfg, st = start
    err, dones = checks.compare_kinds(cfg, st, T, mode, 4)
    assert err == 0.0 and dones > 0


@pytest.mark.parametrize("games", [N, 3 * N, checks.PLAIN_GAMES])
def test_hold_ticks_splits_alike(ticks, monkeypatch, games):
    """One tick a call, three a call, all in one: the same verdict."""
    monkeypatch.setattr(checks, "PLAIN_GAMES", games)
    dones = sum(int(o[2].sum()) for _, o in ticks)
    assert checks.hold_ticks(ticks) == (0.0, dones)
    assert dones > 0


def _changed(out, what):
    state, reward, done = (tree_map(lambda x: x.clone(), out[0]),
                           out[1].clone(), out[2].clone())
    if what == "reward":
        reward[N - 1] += 1.0
    elif what == "done":
        done[N - 1] = ~done[N - 1]
    else:
        leaves = [x for _, x in tree_leaves(state)
                  if x.dtype != torch.float32]
        x = leaves[int(what)]
        x.view(-1)[-1] ^= 1
    return state, reward, done


@pytest.mark.parametrize("what", ["reward", "done", "0", "-1"])
@pytest.mark.parametrize("tick", [0, T - 1])
def test_hold_ticks_finds_one_changed_value(ticks, monkeypatch, what, tick):
    """The last game of one tick changed in its reward, its done flag or
    one bit of an integer leaf: the error is not 0."""
    monkeypatch.setattr(checks, "PLAIN_GAMES", 3 * N)
    bad = list(ticks)
    bad[tick] = (bad[tick][0], _changed(bad[tick][1], what))
    err, _ = checks.hold_ticks(bad)
    assert err > 0.0
