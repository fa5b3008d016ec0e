"""Flax parameter trees and train states <-> PyTorch state dicts.

``params_from_flax`` takes the JAX package's PPONet or QNet params as a
nested dict of numpy arrays (what ``drl_tetris_tpu.runtime.checkpoint
.restore_raw`` returns under 'params'; no JAX is needed to convert) and
returns a ``state_dict`` for ``PPONet`` or ``QNet`` (both wrap the same
SventonNet trunk, so their trees and names are the same);
``params_to_flax`` is its inverse.  ``ppo_state_from_flax`` and
``ppo_state_to_flax`` carry a whole JAX ``PPOState`` (params, optax Adam
state, compressors, update count; with trainer-computed targets the
reference params and their countdown) to and from the port's learner
state (``StandaloneTrainer.ppo_state_dict``), as numpy trees;
``dqn_state_from_flax`` and ``dqn_state_to_flax`` do the same for a
``DQNState`` (params, reference params, Adam, update count;
``StandaloneDQNTrainer.dqn_state_dict``).  ``seeded_state_dict`` draws
a net's weights from a numpy seed instead, for runs without a
checkpoint.

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
from typing import Any, Dict

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


_FLAX_BLOCKS = {v: f"ResidualBlock_{k}" for k, v in _BLOCKS.items()}


def _flax_path(name: str):
    """PPONet state_dict name -> the flax param path under 'params'."""
    parts = name.split(".")
    if parts[0] != "trunk":
        raise KeyError(f"not a PPONet parameter: {name}")
    out, i = ["SventonNet_0"], 1
    while i < len(parts) - 1:
        two = ".".join(parts[i:i + 2])
        if two in _FLAX_BLOCKS:
            out.append(_FLAX_BLOCKS[two])
            i += 2
            continue
        if parts[i] in _FLAX_BLOCKS:
            out.append(_FLAX_BLOCKS[parts[i]])
        elif parts[i] == "kbd":
            out.append("KeyboardConv_0")
        elif parts[i] == "conv":
            out.append("Conv_0")
        elif parts[i] == "convs":
            out.append(f"Conv_{parts[i + 1]}")
            i += 1
        elif parts[i] == "norm":
            out.append("LayerNorm_0")
        else:
            raise KeyError(f"unmapped PPONet module in {name}")
        i += 1
    leaf = parts[-1]
    if leaf == "bias":
        return out + ["bias"]
    if leaf == "weight":
        return out + ["scale" if out[-1] == "LayerNorm_0" else "kernel"]
    raise KeyError(f"unmapped PPONet parameter {name}")


def params_to_flax(state_dict) -> Dict[str, Any]:
    """A PPONet state_dict (tensors or arrays) as the flax param tree
    ``{'params': {'SventonNet_0': ...}}`` of numpy float32 arrays: the
    inverse of ``params_from_flax``."""
    tree: Dict[str, Any] = {}
    for name, value in state_dict.items():
        a = np.asarray(value.detach().cpu() if torch.is_tensor(value)
                       else value, dtype=np.float32)
        path = _flax_path(name)
        if path[-1] == "kernel":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return {"params": tree}


def _numpy_tree(sd):
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v)
            else np.asarray(v) for k, v in sd.items()}


def _adam_from_flax(opt, params) -> Dict[str, Any]:
    """optax ``inject_hyperparams(adam)`` state -> torch Adam's, under the
    names of ``params`` (a port state_dict): ``exp_avg``/``exp_avg_sq``
    from ``mu``/``nu`` (kernels transposed as the weights are), each
    parameter's ``step`` from the shared ``count``, ``lr``, ``betas`` and
    ``eps`` from the hyperparameters."""
    hp = opt["hyperparams"]
    adam = opt["inner_state"][0]
    count = int(np.asarray(adam["count"]))
    if int(np.asarray(opt["count"])) != count:
        raise ValueError("optax's outer and inner Adam counts differ")
    if float(np.asarray(hp.get("eps_root", 0.0))) != 0.0:
        raise ValueError("torch Adam has no eps_root")
    return {
        "lr": float(np.asarray(hp["learning_rate"])),
        "betas": (float(np.asarray(hp["b1"])), float(np.asarray(hp["b2"]))),
        "eps": float(np.asarray(hp["eps"])),
        "step": {k: np.asarray(count, np.float32) for k in params},
        "exp_avg": _numpy_tree(params_from_flax(adam["mu"])),
        "exp_avg_sq": _numpy_tree(params_from_flax(adam["nu"])),
    }


def _adam_to_flax(adam) -> Dict[str, Any]:
    """The inverse of ``_adam_from_flax``.  Every parameter's Adam step
    must be the same (optax keeps one count)."""
    steps = {int(np.asarray(v.cpu() if torch.is_tensor(v) else v))
             for v in adam["step"].values()}
    if len(steps) != 1:
        raise ValueError(f"per-parameter Adam steps differ: {sorted(steps)}")
    count = np.asarray(steps.pop(), np.int32)
    b1, b2 = adam["betas"]
    return {
        "count": count,
        "hyperparams": {"b1": _f32(b1), "b2": _f32(b2),
                        "eps": _f32(adam["eps"]), "eps_root": _f32(0.0),
                        "learning_rate": _f32(adam["lr"])},
        "inner_state": [{"count": count.copy(),
                         "mu": params_to_flax(adam["exp_avg"]),
                         "nu": params_to_flax(adam["exp_avg_sq"])},
                        None],
    }


def _f32(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float32)


def ppo_state_from_flax(raw) -> Dict[str, Any]:
    """A JAX ``PPOState`` (drl_tetris_tpu/algos/ppo.py:150) as restored by
    ``restore_raw`` (nested dicts of numpy arrays) -> the port's learner
    state as numpy trees: ``params`` (the PPONet state_dict), ``adam``
    (``_adam_from_flax``), ``adv_comp``/``vloss_comp``, ``update_count``,
    and, when the state has a reference net (trainer-computed targets),
    ``ref_params`` and ``ref_countdown``."""
    params = _numpy_tree(params_from_flax(raw["params"]))
    out = {
        "params": params,
        "adam": _adam_from_flax(raw["opt_state"], params),
        "adv_comp": {k: np.asarray(raw["adv_comp"][k], np.float32)
                     for k in ("x_mean", "x_max")},
        "vloss_comp": {k: np.asarray(raw["vloss_comp"][k], np.float32)
                       for k in ("x_mean", "x_max")},
        "update_count": int(np.asarray(raw["update_count"])),
    }
    if raw.get("ref_params") is not None:
        out["ref_params"] = _numpy_tree(params_from_flax(raw["ref_params"]))
        out["ref_countdown"] = int(np.asarray(raw["ref_countdown"]))
    return out


def ppo_state_to_flax(state) -> Dict[str, Any]:
    """The port's learner state (``ppo_state_from_flax``'s form, tensors
    or arrays) -> a JAX ``PPOState`` tree of numpy arrays, in the layout
    ``restore_raw`` gives for one saved by the JAX package's
    ``inject_hyperparams(adam)`` trainer."""
    def comp(c):
        return {k: _f32(c[k]) for k in ("x_mean", "x_max")}
    ref = state.get("ref_params")
    return {
        "params": params_to_flax(state["params"]),
        "opt_state": _adam_to_flax(state["adam"]),
        "adv_comp": comp(state["adv_comp"]),
        "vloss_comp": comp(state["vloss_comp"]),
        "update_count": np.asarray(int(state["update_count"]), np.int32),
        "ref_params": None if ref is None else params_to_flax(ref),
        "ref_countdown": None if ref is None else np.asarray(
            int(state["ref_countdown"]), np.int32),
    }


def dqn_state_from_flax(raw) -> Dict[str, Any]:
    """A JAX ``DQNState`` (drl_tetris_tpu/algos/dqn.py:54) as restored by
    ``restore_raw`` -> the port's DQN learner state as numpy trees:
    ``params`` and ``ref_params`` (QNet state_dicts), ``adam``,
    ``update_count``."""
    params = _numpy_tree(params_from_flax(raw["params"]))
    return {
        "params": params,
        "ref_params": _numpy_tree(params_from_flax(raw["ref_params"])),
        "adam": _adam_from_flax(raw["opt_state"], params),
        "update_count": int(np.asarray(raw["update_count"])),
    }


def dqn_state_to_flax(state) -> Dict[str, Any]:
    """The inverse of ``dqn_state_from_flax``."""
    return {
        "params": params_to_flax(state["params"]),
        "ref_params": params_to_flax(state["ref_params"]),
        "opt_state": _adam_to_flax(state["adam"]),
        "update_count": np.asarray(int(state["update_count"]), np.int32),
    }


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
