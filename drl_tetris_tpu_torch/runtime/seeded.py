"""The JAX package's run from one seed, as a fixture, and the check that
holds the port's trainer from the same seed against it, where no JAX runs.

``data/seed_fixture.npz`` holds what the JAX ``StandaloneTrainer`` with
seed SEED (the full-width net at float32, GAMES games, a horizon of TICKS)
draws from its key chain: per leaf of its initial params the sum, the sum
of squares and the first 8 values (in flax's layout, by flax path), the
actions of its first rollout, and the uniform bits of that rollout's first
tick's categorical.  tests/torch_seed_fixture.py writes it where JAX
runs.  ``fixture_errors`` builds the port's trainer from the same seed on
a device and measures it against the file: the initial params drawn from
kinit (models/flax_init.py), the threefry bits of the first tick's noise
on the device, and the actions of the first iteration's rollout, whose
noise is drawn from kroll on the device.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "seed_fixture.npz")
SEED, GAMES, TICKS = 7, 64, 4
INIT_RTOL = 1e-6      # the normal-drawn leaves (erfinv's ulps); others exact


def load_fixture(path: str = FIXTURE) -> Dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def seeded_trainer(device):
    """The port's trainer of the fixture: seed SEED, the full-width net at
    float32, GAMES games, a horizon of TICKS."""
    from drl_tetris_tpu_torch.models.nets import ModelConfig
    from drl_tetris_tpu_torch.runtime.standalone import (StandaloneConfig,
                                                         StandaloneTrainer)
    return StandaloneTrainer(StandaloneConfig(
        model=ModelConfig(compute_dtype="float32"), n_envs=GAMES,
        horizon=TICKS, seed=SEED), device=device)


def init_errors(net, fx) -> Dict[str, float]:
    """The net's initial params against the fixture's leaves: the largest
    relative gap of the first 8 values, of the sums (against the leaf's
    scale sqrt(n * sum of squares)) and of the sums of squares, and the
    number of leaves whose first 8 values are bit-exact."""
    from drl_tetris_tpu_torch.models.convert import params_to_flax
    tree = params_to_flax(net.state_dict())["params"]
    head = total = sumsq = 0.0
    exact = 0
    for name, s, ss, h in zip(fx["names"], fx["sums"], fx["sumsqs"],
                              fx["heads"]):
        node = tree
        for k in str(name).split("/"):
            node = node[k]
        a = node.reshape(-1)
        mine = a[:len(h)]
        exact += int(np.array_equal(mine, h))
        head = max(head, float(np.max(np.abs(mine - h)
                                      / np.maximum(np.abs(h), 1e-30))))
        scale = np.sqrt(a.size * ss) if ss > 0 else 1.0
        total = max(total, abs(a.sum(dtype=np.float64) - s) / scale)
        got_ss = np.square(a, dtype=np.float64).sum()
        sumsq = max(sumsq, abs(got_ss - ss) / max(ss, 1e-30))
    return {"head": head, "sum": total, "sumsq": sumsq,
            "exact_leaves": exact, "leaves": len(fx["names"])}


def first_kroll(tr):
    """kroll of the trainer's next iteration (key, kstep = split(key);
    kroll, kupd = split(kstep))."""
    from drl_tetris_tpu_torch.engine import rng
    _, kstep = rng.split(tr.key)
    return rng.split(kstep)[0]


def fixture_errors(device, iterate: bool = True,
                   path: str = FIXTURE) -> Dict[str, float]:
    """The port's trainer of the fixture on ``device`` against the file:
    ``init_errors``, the mismatched bits of the first tick's noise, and
    the actions of the first rollout that differ (``iterate``: through
    ``train_iteration``, else the rollout alone on kroll)."""
    from drl_tetris_tpu_torch.engine import rng
    fx = load_fixture(path)
    tr = seeded_trainer(device)
    errs = init_errors(tr.net, fx)
    kroll = first_kroll(tr)
    width = tr.cfg.env.engine.width
    bits = rng.random_bits(rng.split(kroll, TICKS)[0], (GAMES, 4 * width))
    errs["noise_bits"] = int((bits.cpu().numpy().astype(np.uint32)
                              != fx["noise_bits"]).sum())
    errs["kroll"] = int((kroll.cpu().numpy().astype(np.uint32)
                         != fx["kroll"]).sum())
    if iterate:
        segs = []
        roll = tr.rollout

        def recorded(*args, **kwargs):
            out = roll(*args, **kwargs)
            segs.append(out[1])
            return out
        tr.rollout = recorded
        tr.train_iteration()
        seg = segs[0]
    else:
        with torch.no_grad():
            seg = tr.rollout(tr.env_state, kroll)[1]
    errs["actions"] = int(
        (seg.rot.cpu().numpy() != fx["rot"]).sum()
        + (seg.trans.cpu().numpy() != fx["trans"]).sum())
    errs["trainer"] = tr
    return errs


def check_fixture(errs: dict) -> None:
    """Raise unless ``fixture_errors`` found the port's draws JAX's."""
    bad = {k: errs[k] for k in ("head", "sum") if not errs[k] <= INIT_RTOL}
    if not errs["sumsq"] <= 2 * INIT_RTOL:
        bad["sumsq"] = errs["sumsq"]
    bad.update({k: errs[k] for k in ("noise_bits", "kroll", "actions")
                if errs[k]})
    if bad:
        raise AssertionError(f"the port's seeded trainer is not JAX's run: "
                             f"{bad} (init tolerance {INIT_RTOL})")
