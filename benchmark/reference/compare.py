"""Comparisons the judges share: states leaf by leaf, and per-leaf norms.

A state of the program arrives as its own dataclass tree (an EnvState of
drl_tetris_tpu_torch); ``as_reference_state`` rebuilds it as the
reference's tree by field name, on the CPU, without importing the
program."""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, Optional

import torch

from benchmark.reference.core import EngineState, PlayerState
from benchmark.reference.env import EnvState


def _rebuild(cls, obj):
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        sub = {"engine": EngineState, "players": PlayerState}.get(f.name)
        kw[f.name] = _rebuild(sub, v) if sub else v.detach().cpu()
    return cls(**kw)


def as_reference_state(state) -> EnvState:
    """An EnvState tree with the reference's field names, on the CPU."""
    return _rebuild(EnvState, state)


def leaves(tree, prefix: str = ""):
    if dataclasses.is_dataclass(tree):
        out = []
        for f in dataclasses.fields(tree):
            out += leaves(getattr(tree, f.name), prefix + f.name + ".")
        return out
    return [(prefix[:-1], tree)]


def mismatches(a, b) -> int:
    """Elements that differ between two trees (or tensors) of the same
    layout; a leaf of another shape counts whole."""
    la = leaves(a) if dataclasses.is_dataclass(a) else [("", a)]
    lb = dict(leaves(b) if dataclasses.is_dataclass(b) else [("", b)])
    n = 0
    for name, x in la:
        y = lb.get(name)
        x = x.detach().cpu()
        if y is None or tuple(y.shape) != tuple(x.shape):
            n += x.numel()
            continue
        n += int((x != y.detach().cpu().to(x.dtype)).sum())
    return n


def cat_states(trees):
    """States of n_i games each, as one state of sum(n_i) games."""
    t = trees[0]
    if dataclasses.is_dataclass(t):
        return type(t)(**{f.name: cat_states([getattr(x, f.name)
                                              for x in trees])
                          for f in dataclasses.fields(t)})
    return torch.cat(trees)


def take_games(tree, lo: int, hi: int):
    """Games [lo, hi) of a state."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: take_games(getattr(tree, f.name), lo, hi)
                             for f in dataclasses.fields(tree)})
    return tree[lo:hi]


def leaf_norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  keep: Optional[set] = None) -> dict:
    """Per leaf |norm(prog) - norm(ref)| over the larger of the reference
    leaf's norm and the median leaf's norm (among the leaves kept): the
    worst leaf's gap ("worst", its name "leaf") and the median gap."""
    names = [n for n in ref if keep is None or n in keep]
    rn = {n: float(ref[n].double().norm()) for n in names}
    pn = {n: float(prog[n].double().norm()) for n in names}
    med = statistics.median(rn.values())
    gaps = {n: abs(pn[n] - rn[n]) / max(rn[n], med) for n in names}
    leaf = max(gaps, key=gaps.get)
    return {"worst": gaps[leaf], "leaf": leaf,
            "median": statistics.median(gaps.values())}
