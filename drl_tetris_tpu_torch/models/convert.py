"""Flax parameter trees -> PyTorch state dicts for models/nets.py.

``params_from_flax`` takes the JAX package's PPONet params as a nested dict
of numpy arrays (what ``drl_tetris_tpu.runtime.checkpoint.restore_raw``
returns under 'params'; no JAX is needed to convert) and returns a
``state_dict`` for ``PPONet``.  ``seeded_state_dict`` draws a PPONet's
weights from a numpy seed instead, for runs without a checkpoint.

``params_from_flax`` maps:

* Conv kernels HWIO -> OIHW, Dense kernels (in, out) -> (out, in);
* LayerNorm scale/bias -> weight/bias;
* module names: SventonNet_0/ResidualBlock_{0,1} -> trunk.vis_tower.{0,1},
  ResidualBlock_{2,3} -> trunk.join_tower.{0,1}, ResidualBlock_4 ->
  trunk.adv_tower, KeyboardConv_0 -> trunk.kbd, ResidualBlock_5 ->
  trunk.value_tower (flax numbers modules in creation order);
  Conv_i -> convs.i, LayerNorm_0 -> norm.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_BLOCKS = {0: "vis_tower.0", 1: "vis_tower.1", 2: "join_tower.0",
           3: "join_tower.1", 4: "adv_tower", 5: "value_tower"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_path(path) -> str:
    parts = list(path)
    if parts and parts[0] == "params":
        parts = parts[1:]
    if not parts or parts[0] != "SventonNet_0":
        raise KeyError(f"not a SventonNet param: {'/'.join(path)}")
    out = ["trunk"]
    for name in parts[1:-1]:
        m = re.fullmatch(r"ResidualBlock_(\d+)", name)
        if m:
            out.append(_BLOCKS[int(m.group(1))])
            continue
        m = re.fullmatch(r"Conv_(\d+)", name)
        if m:
            out.append("conv" if out[-1] == "kbd" else f"convs.{m.group(1)}")
            continue
        if name == "KeyboardConv_0":
            out.append("kbd")
        elif name == "LayerNorm_0":
            out.append("norm")
        else:
            raise KeyError(f"unmapped flax module {name}")
    return ".".join(out)


def params_from_flax(params) -> Dict[str, torch.Tensor]:
    """Convert a flax PPONet param tree (nested dicts of arrays) to a
    PPONet state_dict."""
    sd = {}
    for path, value in _flatten(dict(params)):
        a = np.asarray(value, dtype=np.float32)
        leaf = path[-1]
        base = _module_path(path)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            sd[base + ".weight"] = torch.from_numpy(np.ascontiguousarray(a))
        elif leaf == "scale":
            sd[base + ".weight"] = torch.from_numpy(a.copy())
        elif leaf == "bias":
            sd[base + ".bias"] = torch.from_numpy(a.copy())
        else:
            raise KeyError(f"unmapped flax param {'/'.join(path)}")
    return sd


def seeded_state_dict(net, seed: int) -> Dict[str, torch.Tensor]:
    """Weights for ``net`` from a numpy seed, on the CPU: conv kernels
    N(0, 1/fan_in), biases N(0, 0.01), LayerNorm weight 1 and bias 0."""
    rs = np.random.RandomState(seed)
    sd = {}
    for name, t in net.state_dict().items():
        if name.endswith("norm.weight"):
            a = np.ones(t.shape)
        elif name.endswith("norm.bias"):
            a = np.zeros(t.shape)
        elif t.ndim == 4:
            fan_in = t.shape[1] * t.shape[2] * t.shape[3]
            a = rs.standard_normal(t.shape) / np.sqrt(fan_in)
        else:
            a = 0.01 * rs.standard_normal(t.shape)
        sd[name] = torch.from_numpy(a.astype(np.float32))
    return sd
