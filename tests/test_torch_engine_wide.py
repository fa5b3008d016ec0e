"""The port's plain engine against the JAX package at width 25, the widest
board EngineConfig allows and beyond the f32-exact guard of the TPU
kernel's matmul shifts.  A module of its own, so that under ``--dist
loadfile`` its JAX compiles run beside those of test_torch_engine.py."""
import torch  # noqa: F401,I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

from tests.test_torch_engine import run_parity  # noqa: E402


def test_env_step_matches_jax_width25():
    """60 ticks at width 25: every leaf, reward and done equal each tick,
    with line clears and finished rounds on the way."""
    _, _, final, ev = run_parity(25, 60, seed=3)
    assert ev["clears"] > 0 and ev["done"] > 0, ev
