#!/usr/bin/env python3
"""Write the JAX package's run from one seed as a small fixture, for
holding the PyTorch port against it where no JAX runs (on the card).

    python tests/torch_seed_fixture.py [OUT]

OUT defaults to data/seed_fixture.npz.  The JAX ``StandaloneTrainer`` with
seed SEED, the full-width net at float32 (``ModelConfig(compute_dtype=
"float32")``), GAMES games and a horizon of TICKS, gives:

* ``names`` (the flax path of each leaf of its initial params, '/'
  joined), ``sums`` and ``sumsqs`` (float64) and ``heads`` (the first 8
  values in flax's layout), in that order;
* ``rot``, ``trans`` (TICKS, GAMES): the actions of its first rollout,
  the one its first ``train_iteration`` runs (kroll of its key chain);
* ``noise_bits`` (GAMES, 4 * width): the uniform bits of the first tick's
  categorical, ``jax.random.bits`` of ``split(kroll, TICKS)[0]``;
* ``kroll``: that rollout's key.

It imports only JAX, numpy and the JAX package; the port reads the file
(``chip_smoke.py`` [seed], ``tests/test_torch_seed.py``).
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, GAMES, TICKS, HEAD = 7, 64, 4, 8
DEFAULT_OUT = os.path.join(REPO, "data", "seed_fixture.npz")


def fixture() -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from drl_tetris_tpu.models.nets import ModelConfig
    from drl_tetris_tpu.runtime.standalone import (StandaloneConfig,
                                                   StandaloneTrainer)

    tr = StandaloneTrainer(StandaloneConfig(
        model=ModelConfig(compute_dtype="float32"), n_envs=GAMES,
        horizon=TICKS, seed=SEED))
    leaves = [("/".join(k.key for k in path), np.asarray(a, np.float32))
              for path, a in jax.tree_util.tree_flatten_with_path(
                  tr.state.params["params"])[0]]
    out = dict(
        names=np.array([n for n, _ in leaves]),
        sums=np.array([a.sum(dtype=np.float64) for _, a in leaves]),
        sumsqs=np.array([np.square(a, dtype=np.float64).sum()
                         for _, a in leaves]),
        heads=np.stack([a.reshape(-1)[:HEAD] for _, a in leaves]))
    # the first train_iteration's rollout: key, kstep = split(key);
    # kroll, kupd = split(kstep)
    _, kstep = jax.random.split(tr.key)
    kroll, _ = jax.random.split(kstep)
    _, seg, _ = tr.rollout(tr.state.params, tr.env_state, kroll)
    width = tr.cfg.env.engine.width
    out.update(
        rot=np.asarray(seg.rot, np.int32), trans=np.asarray(seg.trans,
                                                            np.int32),
        noise_bits=np.asarray(jax.random.bits(
            jax.random.split(kroll, TICKS)[0], (GAMES, 4 * width),
            np.uint32)),
        kroll=np.asarray(jax.random.key_data(kroll)))
    return out


def main(argv) -> int:
    sys.path.insert(0, REPO)
    path = argv[1] if len(argv) > 1 else DEFAULT_OUT
    np.savez_compressed(path, **fixture())
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
