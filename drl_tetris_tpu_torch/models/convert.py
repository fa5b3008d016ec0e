"""Flax parameter trees and train states <-> PyTorch state dicts.

``params_from_flax`` takes the JAX package's PPONet, QNet, VNet (SIXten) or
SherlockNet params as a nested dict of numpy arrays (what
``drl_tetris_tpu.runtime.checkpoint.restore_raw`` returns under 'params';
no JAX is needed to convert) and returns a ``state_dict`` for ``PPONet`` or
``QNet`` (both wrap the trunk that the architecture names, so their trees
and names are the same), ``algos/sixten.VNet`` (ResidualBlock_{0..4} ->
vis_tower.{0,1}, join_tower.{0,1}, value_tower) or
``algos/sherlock.SherlockNet`` (SventonNet_0 -> trunk.*, ResidualBlock_0
-> phi_tower, Conv_0 -> phi_conv); ``params_to_flax`` is its inverse.  ``ppo_state_from_flax`` and
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
* module names, per trunk (flax numbers modules of one type in creation
  order, so the numbers follow the JAX trunks' ``__call__``):
  - SventonNet_0 ('silver', 'dreamer'): ResidualBlock_{0,1} ->
    trunk.vis_tower.{0,1}, ResidualBlock_{2,3} -> trunk.join_tower.{0,1},
    ResidualBlock_4 -> trunk.adv_tower, KeyboardConv_0 -> trunk.kbd
    (Dense_0 -> trunk.a_dense for 'dreamer'), ResidualBlock_5 ->
    trunk.value_tower; inside a block Conv_i -> convs.i, LayerNorm_0 ->
    norm;
  - ConvThenDense_0 ('vanilla') and ConvKeyboard_0 ('keyboard'):
    Dense_{2i+j} -> trunk.vec_enc.i.j and Conv_{4i+j} -> trunk.vis_enc.i.j
    for perspective i; then Dense_4, Dense_5 -> trunk.value_hidden,
    trunk.value_out and the advantage head Dense_6 -> trunk.a_dense
    ('vanilla'; Dense_4 without the value head), or Dense_6 ->
    trunk.value_pieces and KeyboardConv_0 -> trunk.kbd ('keyboard').
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

_BLOCKS = {0: "vis_tower.0", 1: "vis_tower.1", 2: "join_tower.0",
           3: "join_tower.1", 4: "adv_tower", 5: "value_tower"}
_TRUNKS = ("SventonNet_0", "ConvThenDense_0", "ConvKeyboard_0")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _dense_names(trunk: str, n_dense: int) -> Dict[str, str]:
    """Dense_i -> port module under the trunk, for a trunk with
    ``n_dense`` Dense modules."""
    if trunk == "SventonNet_0":
        return {"Dense_0": "a_dense"} if n_dense else {}
    names = {f"Dense_{2 * i + j}": f"vec_enc.{i}.{j}"
             for i in range(2) for j in range(2)}
    tail = {("ConvThenDense_0", 5): ["a_dense"],
            ("ConvThenDense_0", 7): ["value_hidden", "value_out", "a_dense"],
            ("ConvKeyboard_0", 4): [],
            ("ConvKeyboard_0", 6): ["value_hidden", "value_out"],
            ("ConvKeyboard_0", 7): ["value_hidden", "value_out",
                                    "value_pieces"]}.get((trunk, n_dense))
    if tail is None:
        raise KeyError(f"{trunk} with {n_dense} Dense modules")
    names.update({f"Dense_{4 + k}": m for k, m in enumerate(tail)})
    return names


def _module_table(trunk: str, modules) -> Dict[Tuple[str, ...], str]:
    """{flax module path under the trunk: port module path under
    ``trunk.``} for a trunk whose top-level flax modules are ``modules``
    (a residual block's inner modules are mapped by ``_port_module``)."""
    table = {("KeyboardConv_0", "Conv_0"): "kbd.conv"}
    n_dense = sum(m.startswith("Dense_") for m in modules)
    table.update({(f, ): m for f, m in _dense_names(trunk, n_dense).items()})
    if trunk == "SventonNet_0":
        table.update({(f"ResidualBlock_{b}", ): name
                      for b, name in _BLOCKS.items()})
    else:
        table.update({(f"Conv_{4 * i + j}", ): f"vis_enc.{i}.{j}"
                      for i in range(2) for j in range(4)})
    return table


def _port_module(table, path: Tuple[str, ...]) -> str:
    """The port module of a flax module path under the trunk."""
    if path in table:
        return table[path]
    if len(path) == 2 and path[:1] in table:        # inside a block
        m = re.fullmatch(r"Conv_(\d+)", path[1])
        if m:
            return f"{table[path[:1]]}.convs.{m.group(1)}"
        if path[1] == "LayerNorm_0":
            return f"{table[path[:1]]}.norm"
    raise KeyError(f"unmapped flax module {'/'.join(path)}")


def _flax_module(table, module: str) -> Tuple[str, ...]:
    """The inverse of ``_port_module``."""
    inverse = {m: f for f, m in table.items()}
    if module in inverse:
        return inverse[module]
    block, _, inner = module.rpartition(".")
    m = re.fullmatch(r"(.+)\.convs", block)
    if m and m.group(1) in inverse:
        return inverse[m.group(1)] + (f"Conv_{inner}", )
    if inner == "norm" and block in inverse:
        return inverse[block] + ("LayerNorm_0", )
    raise KeyError(f"unmapped PPONet module {module}")


# VNet (SIXten): its blocks sit at the top of the tree; SherlockNet: the
# SventonNet trunk, then the phi head's block and conv
_VNET = {("ResidualBlock_0",): "vis_tower.0",
         ("ResidualBlock_1",): "vis_tower.1",
         ("ResidualBlock_2",): "join_tower.0",
         ("ResidualBlock_3",): "join_tower.1",
         ("ResidualBlock_4",): "value_tower"}
_PHI = {("ResidualBlock_0",): "phi_tower", ("Conv_0",): "phi_conv"}


def _body_from_flax(table, body, prefix: str) -> Dict[str, torch.Tensor]:
    """state_dict entries (under ``prefix``) of a flax module tree whose
    modules ``table`` maps."""
    sd = {}
    for path, value in _flatten(dict(body)):
        a = np.asarray(value, dtype=np.float32)
        leaf = path[-1]
        base = prefix + _port_module(table, path[:-1])
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            sd[base + ".weight"] = torch.from_numpy(np.array(a, order="C"))
        elif leaf == "scale":
            sd[base + ".weight"] = torch.from_numpy(a.copy())
        elif leaf == "bias":
            sd[base + ".bias"] = torch.from_numpy(a.copy())
        else:
            raise KeyError(f"unmapped flax param {'/'.join(path)}")
    return sd


def params_from_flax(params) -> Dict[str, torch.Tensor]:
    """Convert a flax PPONet, QNet, VNet or SherlockNet param tree (nested
    dicts of arrays, with or without the top 'params' key) to the port
    net's state_dict."""
    tree = dict(params)
    if "params" in tree:
        tree = dict(tree["params"])
    if set(tree) == {"SventonNet_0", "ResidualBlock_0", "Conv_0"}:
        body = tree.pop("SventonNet_0")
        sd = _body_from_flax(_module_table("SventonNet_0", body), body,
                             "trunk.")
        sd.update(_body_from_flax(_PHI, tree, ""))
        return sd
    if tree and all(k in {m[0] for m in _VNET} for k in tree):
        return _body_from_flax(_VNET, tree, "")
    (trunk, body), = tree.items()
    if trunk not in _TRUNKS:
        raise KeyError(f"not a PPONet or QNet trunk: {trunk}")
    return _body_from_flax(_module_table(trunk, body), body, "trunk.")


def _port_trunk(names) -> Tuple[str, Tuple[str, ...]]:
    """(flax trunk name, its top-level flax modules) for a port
    state_dict's parameter names."""
    mods = {n.split(".")[1] for n in names}
    if "vec_enc" in mods:
        trunk = "ConvKeyboard_0" if "kbd" in mods else "ConvThenDense_0"
        n_dense = 4 + sum(m in mods for m in ("value_hidden", "value_out",
                                               "value_pieces", "a_dense"))
    else:
        trunk, n_dense = "SventonNet_0", int("a_dense" in mods)
    return trunk, tuple(f"Dense_{i}" for i in range(n_dense))


def _flax_leaf(table, name: str, root: Tuple[str, ...]
               ) -> Tuple[str, ...]:
    """The flax path (modules..., leaf) under ``root`` of a parameter
    ``name`` (without its prefix) of a body whose modules ``table`` maps."""
    module, leaf = name.rsplit(".", 1)
    path = (*root, *_flax_module(table, module))
    if leaf == "bias":
        return path + ("bias",)
    if leaf == "weight":
        return path + ("scale" if path[-1] == "LayerNorm_0" else "kernel",)
    raise KeyError(f"unmapped parameter {name}")


def flax_paths(names) -> Dict[str, Tuple[str, ...]]:
    """{parameter name of a PPONet, QNet, VNet or SherlockNet: its flax
    path (modules..., leaf) under 'params'}."""
    names = list(names)
    trunk = [n[len("trunk."):] for n in names if n.startswith("trunk.")]
    rest = [n for n in names if not n.startswith("trunk.")]
    if not trunk:                                        # VNet
        return {n: _flax_leaf(_VNET, n, ()) for n in rest}
    flax_trunk, modules = _port_trunk(["trunk." + n for n in trunk])
    table = _module_table(flax_trunk, modules)
    out = {"trunk." + n: _flax_leaf(table, n, (flax_trunk,)) for n in trunk}
    if rest:                                             # SherlockNet
        if flax_trunk != "SventonNet_0":
            raise KeyError(f"a phi head on a {flax_trunk} trunk")
        out.update({n: _flax_leaf(_PHI, n, ()) for n in rest})
    return out


def params_to_flax(state_dict) -> Dict[str, Any]:
    """A PPONet, QNet, VNet or SherlockNet state_dict (tensors or arrays)
    as the flax param tree ``{'params': ...}`` of numpy float32 arrays: the
    inverse of ``params_from_flax``."""
    tree: Dict[str, Any] = {}
    for name, path in flax_paths(state_dict).items():
        value = state_dict[name]
        a = np.asarray(value.detach().cpu() if torch.is_tensor(value)
                       else value, dtype=np.float32)
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
