"""Checkpoint / resume with recovery validation, in PyTorch's own format.

Counterpart of ``drl_tetris_tpu/runtime/checkpoint.py`` (reference:
numbered weight files with a settings side-file,
sventon_agent_base.py:116-129, tools/utils.py:74-86; the md5 recovery
check, runner.py:61-120).  The JAX package writes orbax checkpoints; the
port writes

    <dir>/<step>/state.pt      torch.save of a nested dict: tensors under
                               the port's state_dict names, plus plain
                               ints, floats, strings and tuples
    <dir>/settings.json        the run's settings, byte for byte as the
                               JAX package writes them

and reads ``state.pt`` with ``torch.load(weights_only=True)``, which
refuses pickled objects.  A step is written into a temporary directory
beside it and moved into place with ``os.replace``, so ``latest_step``
never sees a half-written step.  A JAX checkpoint comes across through
``tools/torch_import_flax_checkpoint.py``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"
NUMBERED_EVERY = 250  # trainer.py:113-123 save cadence (process trainer)


def _enc(v):
    """Settings value -> JSON.  Dataclasses (CompressorConfig, Parameter
    schedules) round-trip through a __kind__ tag; the reference instead
    pickles live objects next to the weights (sventon_agent_base.py:128-129,
    self-criticized README.md:91)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {"__kind__": type(v).__name__,
                **{k: _enc(x) for k, x in dataclasses.asdict(v).items()}}
    if isinstance(v, (tuple, list)):
        return [_enc(x) for x in v]
    if isinstance(v, dict):
        return {k: _enc(x) for k, x in v.items()}
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return {"__repr__": repr(v)}


def _dec(v):
    if isinstance(v, dict) and "__kind__" in v:
        kind = v.pop("__kind__")
        from drl_tetris_tpu_torch.algos.ppo import CompressorConfig
        from drl_tetris_tpu_torch.config import parameter as P
        registry = {"Parameter": P.Parameter,
                    "LinearParameter": P.LinearParameter,
                    "ExpParameter": P.ExpParameter,
                    "CompressorConfig": CompressorConfig}
        cls = registry.get(kind)
        return cls(**{k: _dec(x) for k, x in v.items()}) if cls else v
    if isinstance(v, dict):
        return {k: _dec(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_dec(x) for x in v]
    return v


def _to_torch(tree):
    """numpy leaves -> tensors (weights_only loading refuses numpy)."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    return tree


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), str(int(step)))


def save(directory: str, step: int, state: Any,
         settings: Optional[dict] = None) -> bool:
    """Save ``state`` (a nested dict of tensors, numpy arrays and plain
    values) as step ``step``; also writes the run settings side-file next
    to the steps (sventon_agent_base.py:128-129).  A step that exists
    already is kept and not written again (orbax's CheckpointManager
    skips it too); returns whether the step was written."""
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    wrote = False
    if not os.path.exists(final):
        tmp = tempfile.mkdtemp(prefix=f".tmp-{int(step)}-",
                               dir=os.path.abspath(directory))
        try:
            torch.save(_to_torch(state), os.path.join(tmp, STATE_FILE))
            os.replace(tmp, final)
            wrote = True
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
    if settings is not None:
        with open(os.path.join(directory, "settings.json"), "w") as f:
            json.dump({k: _enc(v) for k, v in settings.items()}, f, indent=1)
    return wrote


def load_settings(checkpoint_path: str) -> Optional[dict]:
    """Find the settings side-file for a checkpoint path (the run dir or a
    step dir inside it), tools/utils.py:47-52 weight->settings pairing."""
    p = os.path.abspath(checkpoint_path.rstrip("/"))
    for d in (p, os.path.dirname(p)):
        sp = os.path.join(d, "settings.json")
        if os.path.exists(sp):
            with open(sp) as f:
                return {k: _dec(v) for k, v in json.load(f).items()}
    return None


def all_steps(directory: str):
    """The finished steps under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.exists(
                      os.path.join(directory, d, STATE_FILE)))


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _load(directory: str, step: Optional[int], map_location):
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    return torch.load(os.path.join(_step_dir(directory, step), STATE_FILE),
                      map_location=map_location, weights_only=True)


def restore(directory: str, target: Any, step: Optional[int] = None) -> Any:
    """Load step ``step`` (default the latest) into ``target``, anything
    with ``load_state_dict`` (a ``StandaloneTrainer``, a module), and
    return it; tensors go to the target's own devices."""
    target.load_state_dict(_load(directory, step, torch.device("cpu")))
    return target


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.numpy()
    return tree


def restore_raw(directory: str, step: Optional[int] = None) -> Any:
    """The saved nested dict with numpy leaves (on the host), so
    ``raw.get("params", raw)`` is a params-only view of any checkpoint,
    as the JAX package's ``restore_raw`` gives (eval.py:99-139)."""
    return _to_numpy(_load(directory, step, torch.device("cpu")))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def state_checksum(tree: Any) -> str:
    """md5 over every leaf's bytes, dict keys in sorted order (as
    ``jax.tree.leaves`` orders them): the recovery-validation artifact
    (runner.py:119-120 md5-of-dill; ``pytree_checksum`` in JAX)."""
    h = hashlib.md5()
    for leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            leaf = leaf.detach().cpu().numpy()
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()


def validate_recovery(compute_fn, restored_state, expected_checksum: str):
    """runner.validate_runner (runner.py:90-104): recompute the recorded
    computation from the restored state and require a bit-identical result."""
    out = compute_fn(restored_state)
    got = state_checksum(out)
    if got != expected_checksum:
        raise RuntimeError(
            f"recovery validation failed: checksum {got} != {expected_checksum}")
    return True
