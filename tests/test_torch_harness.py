"""Harness of the PyTorch port's tests, and the helpers they share.

Loading torch into a JAX process changes XLA:CPU's target tuning, so every
compile that follows must land in the ``-tf`` namespace of the persistent
cache, never in the ``-plain`` one that torch-free processes read
(drl_tetris_tpu/__init__.py).  Under ``pytest -n 6 --dist loadfile`` every
worker imports every test module, so each ``test_torch_*`` module imports
torch first and then calls ``rekey_jax_cache``.  JAX fixes its cache
directory at the first compile, so the cache is reset before the re-key.

The port's plain versions run thousands of small tensor ops.  Each xdist
worker imports this module, so each sets torch to one thread: one thread
pool per worker would oversubscribe the CPUs the JAX tests compile on;
``child_env`` does the same for the processes the tests start.  A cold
run of the suite is bound by XLA compiles, so the re-key also lowers the
persistent cache's threshold: the workers share compiles of a tenth of a
second and more, not only those of two seconds and more.

The port itself (drl_tetris_tpu_torch) never imports JAX or the JAX package;
a subprocess below shows it.
"""
import torch  # noqa: I001  (first: the re-key below must see it loaded)

import os
import subprocess
import sys

import numpy as np

torch.set_num_threads(1)
SHARED_COMPILE_S = 0.1


def rekey_jax_cache() -> str:
    """Point JAX's persistent cache at this torch-loaded process's
    namespace; returns the configured directory."""
    import jax
    from jax._src import compilation_cache
    import drl_tetris_tpu

    assert "torch" in sys.modules
    compilation_cache.reset_cache()
    drl_tetris_tpu.enable_compilation_cache()
    # keep the compiles of a tenth of a second and more too: six xdist
    # workers compile the same small programs (initialisers, resets,
    # updates), and a cold suite is bound by compile time
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      SHARED_COMPILE_S)
    return jax.config.jax_compilation_cache_dir


rekey_jax_cache()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child_env(**extra) -> dict:
    """The environment of a process a test starts: the repo on its path
    and one intra-op thread, as each xdist worker has (six workers' worth
    of children with full thread pools starve the CPUs)."""
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1", **extra)


def jax_leaves(state):
    import jax
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def assert_state_equal(jax_state, torch_state, where=""):
    """Every leaf bit-identical: the JAX pytree's leaves in flatten order
    against the port's dataclass leaves in field order (uint32 JAX leaves
    against the port's int32 bit patterns)."""
    from drl_tetris_tpu_torch.engine.core import tree_leaves
    jl = jax_leaves(jax_state)
    tl = tree_leaves(torch_state)
    assert len(jl) == len(tl), (len(jl), len(tl))
    for a, (name, b) in zip(jl, tl):
        b = b.detach().cpu().numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (where, name, a.dtype, b.dtype, a.shape, b.shape)
        assert (a == b).all(), (where, name, np.argwhere(a != b)[:5])


def to_torch_state(jax_state, like):
    """A JAX EnvState (or EngineState) as the port's dataclass ``like``,
    on the CPU."""
    from drl_tetris_tpu_torch.engine.core import tree_leaves
    import dataclasses
    leaves = iter(jax_leaves(jax_state))

    def rebuild(tree):
        if dataclasses.is_dataclass(tree):
            return type(tree)(**{f.name: rebuild(getattr(tree, f.name))
                                 for f in dataclasses.fields(tree)})
        a = next(leaves)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.copy())
    out = rebuild(like)
    assert len(tree_leaves(out)) == len(jax_leaves(jax_state))
    return out


# ---------------------------------------------------------------------------
# The harness itself
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    """Importing every module of the port leaves jax and the JAX package
    out of sys.modules (a fresh interpreter, so nothing else loaded them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import drl_tetris_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or\n"
        "             k.startswith(('jax.', 'flax', 'optax', 'orbax',\n"
        "                           'drl_tetris_tpu.')) or k == 'drl_tetris_tpu')\n"
        "print('LOADED', len([k for k in sys.modules if k.startswith(p.__name__)]))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split("LOADED")[1]) >= 12, res.stdout


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names nothing of JAX or the JAX package."""
    import ast
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    bad = [n for n in names if n.split(".")[0] in
           ("jax", "flax", "optax", "orbax", "drl_tetris_tpu")]
    assert not bad, bad
    assert "drl_tetris_tpu_torch" in {n.split(".")[0] for n in names}


def test_jax_cache_is_rekeyed_to_tf():
    """After a compile in this torch-loaded process, the cache JAX actually
    uses is the '-tf' namespace."""
    import jax
    import jax.numpy as jnp
    from jax._src import compilation_cache
    import drl_tetris_tpu

    rekey_jax_cache()
    jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()
    expected = drl_tetris_tpu._cache_dir()
    if not expected:
        return                      # caching disabled by the environment
    cache = compilation_cache._cache
    assert cache is not None
    path = str(getattr(cache, "_path", ""))
    assert path.rstrip("/") == expected.rstrip("/"), (path, expected)
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        assert path.rstrip("/").endswith("-tf"), path


def test_cpu_tensors_take_the_plain_path():
    """On CPU tensors the kernel wrappers run the plain version and never
    count a launch; the entry points refuse a missing card."""
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
    from drl_tetris_tpu_torch.engine.core import EngineConfig

    before = dict(cuda_tick.LAUNCHES)
    env = TetrisVectorEnv(EnvConfig(engine=EngineConfig(width=6)), 4,
                          device="cpu")
    st = env.reset(3)
    z = torch.zeros(4, dtype=torch.int32)
    st2, rew, done = env.step(st, z, z)
    assert rew.shape == (4,) and done.shape == (4,)
    cuda_tick.rollout(env.cfg, st2, 2, actions=(z.repeat(2, 1),
                                                 z.repeat(2, 1)))
    assert cuda_tick.LAUNCHES == before
    if not torch.cuda.is_available():
        import pytest
        with pytest.raises(RuntimeError):
            TetrisVectorEnv(EnvConfig(), 4)


def test_net_device_is_explicit(monkeypatch):
    """PPONet builds on the card unless asked for another device, raises
    with no card, and the rollout refuses a net that is not on the env's
    device."""
    import pytest
    from drl_tetris_tpu_torch.algos.rollout import make_rollout_fn
    from drl_tetris_tpu_torch.env.env import EnvConfig, TetrisVectorEnv
    from drl_tetris_tpu_torch.models.nets import ModelConfig, PPONet

    cfg = ModelConfig(compute_dtype="float32", tower_layers=1,
                      tower_filters=4, val_layers=1, val_filters=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        PPONet(cfg)
    net = PPONet(cfg, device="cpu")
    assert all(p.device.type == "cpu" for p in net.parameters())
    env = TetrisVectorEnv(EnvConfig(), 2, device="cpu")
    make_rollout_fn(env, net, 2)
    with pytest.raises(ValueError):
        make_rollout_fn(env, PPONet(cfg, device="meta"), 2)
