#!/usr/bin/env python3
"""Carry a JAX package checkpoint over to the PyTorch port's format.

    python tools/torch_import_flax_checkpoint.py SRC DST [--step N]

Reads the orbax checkpoint in SRC (a run directory such as
data/demo_weights) with the JAX package's ``restore_raw``, converts it and
writes DST/<step>/state.pt with the port's ``runtime/checkpoint.save``,
then copies SRC's settings.json beside it unchanged.  A whole train state
goes through ``models/convert``, so ``train --resume`` continues it in the
port: a ``PPOState`` with optax's Adam (also a trainer-computes-targets
one, with its reference net) through ``ppo_state_from_flax``, a
``DQNState`` through ``dqn_state_from_flax``; a params-only checkpoint
through ``params_from_flax``.

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


def convert(src: str, dst: str, step=None) -> int:
    """Convert SRC's checkpoint at ``step`` (default its latest) into DST;
    returns the step."""
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="JAX checkpoint directory (orbax steps)")
    ap.add_argument("dst", help="port checkpoint directory to write")
    ap.add_argument("--step", type=int, default=None)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    step = convert(args.src, args.dst, args.step)
    print(f"wrote {os.path.join(args.dst, str(step))}")


if __name__ == "__main__":
    main()
