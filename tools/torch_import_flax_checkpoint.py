#!/usr/bin/env python3
"""Carry a JAX package checkpoint over to the PyTorch port's format.

    python tools/torch_import_flax_checkpoint.py SRC DST [--step N]
        [--params-only] [--fixture]

Reads the orbax checkpoint in SRC (a run directory such as
data/demo_weights) with the JAX package's ``restore_raw``, converts it and
writes DST/<step>/state.pt with the port's ``runtime/checkpoint.save``,
then copies SRC's settings.json beside it unchanged.  A whole train state
goes through ``models/convert``, so ``train --resume`` continues it in the
port: a ``PPOState`` with optax's Adam (also a trainer-computes-targets
one, with its reference net) through ``ppo_state_from_flax``, a
``DQNState`` through ``dqn_state_from_flax``; a params-only checkpoint
through ``params_from_flax``.  ``--params-only`` keeps the net's weights
alone (what ``eval`` and ``--init-from`` read).

``--fixture`` also writes DST/demo_outputs.npz: the inputs of 16
positions (16 games reset from ``PRNGKey(0)``, then 40 ticks of
numpy-seeded random actions, observed from the acting player's side) and
the JAX package's ``PPONet`` outputs ``pi`` and ``v`` on them at float32
and at bfloat16.  With it the port's net on the card is held against
JAX's own numbers, where no JAX runs.  The committed
``data/demo_weights_torch`` was written with

    python tools/torch_import_flax_checkpoint.py data/demo_weights \
        data/demo_weights_torch --params-only --fixture

This is the one tool that imports both packages.  It runs where JAX is,
on the CPU, never on the card's machine; the port itself reads only its
own format.
"""
import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


FIXTURE = "demo_outputs.npz"
FIXTURE_GAMES, FIXTURE_TICKS, FIXTURE_SEED = 16, 40, 0


def convert(src: str, dst: str, step=None, params_only: bool = False) -> int:
    """Convert SRC's checkpoint at ``step`` (default its latest) into DST
    (only the net's weights with ``params_only``); returns the step."""
    from drl_tetris_tpu.runtime import checkpoint as jckpt
    from drl_tetris_tpu_torch.models.convert import (dqn_state_from_flax,
                                                     params_from_flax,
                                                     ppo_state_from_flax)
    from drl_tetris_tpu_torch.runtime import checkpoint as ckpt

    if step is None:
        step = jckpt.latest_step(src)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {src}")
    raw = jckpt.restore_raw(src, step=step)
    if params_only:
        raw = {"params": raw["params"]}
    if isinstance(raw, dict) and "opt_state" in raw:
        state = (ppo_state_from_flax(raw) if "adv_comp" in raw
                 else dqn_state_from_flax(raw))
    else:
        params = raw.get("params", raw) if isinstance(raw, dict) else raw
        state = {"params": {k: v.numpy() for k, v in
                            params_from_flax(params).items()}}
    ckpt.save(dst, step, state)
    settings = os.path.join(src, "settings.json")
    if os.path.exists(settings):
        shutil.copyfile(settings, os.path.join(dst, "settings.json"))
    return step


def write_fixture(src: str, dst: str, step=None) -> str:
    """JAX's demo outputs on seeded positions into DST/demo_outputs.npz
    (see the module docstring); returns the path.  ``vis`` is stored as
    uint8 (the fields are 0/1)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from drl_tetris_tpu.algos.rollout import policy_inputs
    from drl_tetris_tpu.config.presets import resolve
    from drl_tetris_tpu.env.env import TetrisVectorEnv
    from drl_tetris_tpu.models.nets import PPONet
    from drl_tetris_tpu.runtime import checkpoint as jckpt

    if step is None:
        step = jckpt.latest_step(src)
    cfg = resolve(jckpt.load_settings(src))
    n, e = FIXTURE_GAMES, cfg.env.engine
    env = TetrisVectorEnv(cfg.env, n)
    st = env.reset(jax.random.PRNGKey(FIXTURE_SEED))
    rs = np.random.RandomState(FIXTURE_SEED)
    for _ in range(FIXTURE_TICKS):
        st, _, _ = env.step(st, jnp.asarray(rs.randint(0, 4, n), jnp.int32),
                            jnp.asarray(rs.randint(0, e.width, n),
                                        jnp.int32))
    vec, vis = policy_inputs(env.observe(st))
    params = jckpt.restore_raw(src, step=step)["params"]   # {"params": ...}
    out = {"step": np.asarray(step), "vec": np.stack(vec, 1),
           "vis": np.stack(vis, 1)[..., 0].astype(np.uint8)}
    for dtype in ("float32", "bfloat16"):
        net = PPONet(dataclasses.replace(cfg.model, compute_dtype=dtype))
        pi, v = net.apply(params, vec, vis)
        out[f"pi_{dtype}"] = np.asarray(pi, np.float32)
        out[f"v_{dtype}"] = np.asarray(v, np.float32)
    os.makedirs(dst, exist_ok=True)
    path = os.path.join(dst, FIXTURE)
    np.savez_compressed(path, **out)
    return path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="JAX checkpoint directory (orbax steps)")
    ap.add_argument("dst", help="port checkpoint directory to write")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--params-only", action="store_true",
                    help="keep only the net's weights")
    ap.add_argument("--fixture", action="store_true",
                    help=f"also write DST/{FIXTURE}, JAX's outputs on "
                         "seeded positions")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    step = convert(args.src, args.dst, args.step, args.params_only)
    print(f"wrote {os.path.join(args.dst, str(step))}")
    if args.fixture:
        print(f"wrote {write_fixture(args.src, args.dst, step)}")


if __name__ == "__main__":
    main()
