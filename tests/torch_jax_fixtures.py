"""JAX's side of the port's costlier parity tests, committed as fixtures.

A parity test whose JAX reference costs minutes of XLA compiles in a cold
run reads JAX's outputs (and the inputs JAX drew them from) from
``tests/jax_fixtures/NAME.npz``, and the port's side runs on them as
before.  A ``slow`` test beside it computes the same outputs with the JAX
package again and holds them against the file:

    python -m pytest tests/test_torch_*.py -m slow -k regenerates

With ``JAX_FIXTURES_WRITE=1`` in the environment those tests write the
files instead (after a change to the JAX package, to a test's inputs or to
what a fixture holds), and pass.

A fixture is a tree of dicts and lists whose leaves are numpy arrays,
numbers, strings or None, flattened into one ``.npz`` under ``::``-joined
paths (a flax path or a stat name may hold ``/``; a None is an empty
array under its path and NONE).  Integers, booleans and
strings come back bit for bit; a regenerated float may differ from the
committed one by ``FLOAT_RTOL`` relative (XLA:CPU's code for another host
CPU), which the tests' own tolerances, all wider, absorb.
"""
import os

import numpy as np

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "jax_fixtures")
WRITE = "JAX_FIXTURES_WRITE"
SEP = "::"
NONE = "<None>"
FLOAT_RTOL = 1e-6


def flatten(tree, prefix="") -> dict:
    """{path: numpy array} of a tree of dicts, lists, tuples (named ones
    as dicts) and leaves."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return {f"{prefix}{SEP}{NONE}": np.zeros(0, np.int8)}
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        k = str(k)
        assert SEP not in k and k, k
        out.update(flatten(v, f"{prefix}{SEP}{k}" if prefix else k))
    return out


def unflatten(flat: dict):
    """The tree of ``flatten``'s paths: dicts, and lists where a level's
    keys are 0..n-1."""
    root: dict = {}
    for path, a in flat.items():
        node = root
        *parents, last = path.split(SEP)
        if last == NONE:
            *parents, last = parents
            a = None
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = a

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == sorted(map(str, range(len(node)))):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(root)


def digests(leaves) -> np.ndarray:
    """The sha1 of each array's bytes: a trajectory's per-tick states held
    exactly at a few bytes a leaf (a uint32 leaf and the same bits as
    int32 give one digest)."""
    import hashlib
    return np.array([hashlib.sha1(np.ascontiguousarray(a).tobytes())
                     .hexdigest() for a in leaves])


def assert_digests(want: np.ndarray, state, where=""):
    """The port's state (a dataclass of tensors) against ``digests`` of
    JAX's leaves, leaf by leaf in flatten order."""
    from drl_tetris_tpu_torch.engine.core import tree_leaves
    leaves = tree_leaves(state)
    got = digests([b.detach().cpu().numpy() for _, b in leaves])
    assert len(got) == len(want), (where, len(got), len(want))
    bad = [name for (name, _), g, w in zip(leaves, got, want) if g != w]
    assert not bad, (where, bad)


def path(name: str) -> str:
    return os.path.join(DIR, f"{name}.npz")


def load(name: str):
    """The committed fixture ``name`` as a tree of numpy arrays."""
    with np.load(path(name), allow_pickle=False) as f:
        return unflatten({k: f[k] for k in f.files})


def regenerates(name: str, compute) -> None:
    """``compute()`` (the JAX side, as a tree) against the committed
    fixture: the same paths, dtypes and shapes, integers, booleans and
    strings equal, floats within FLOAT_RTOL relative of max(|x|, 1).  Under
    JAX_FIXTURES_WRITE=1 it writes the fixture instead."""
    got = flatten(compute())
    if os.environ.get(WRITE) == "1":
        os.makedirs(DIR, exist_ok=True)
        np.savez_compressed(path(name), **got)
        return
    with np.load(path(name), allow_pickle=False) as f:
        want = {k: f[k] for k in f.files}
    assert set(got) == set(want), (name, sorted(set(got) ^ set(want))[:5])
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (name, k, g.dtype, w.dtype, g.shape, w.shape)
        if w.dtype.kind == "f":
            err = np.abs(g.astype(np.float64) - w) / np.maximum(np.abs(w), 1)
            assert not err.size or err.max() <= FLOAT_RTOL, (name, k,
                                                             err.max())
        else:
            assert (g == w).all(), (name, k)
