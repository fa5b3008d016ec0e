"""The engine kernel's share of its roofline in the traced iteration, for
the one-tick entry's per-kind instantiation (``step_kernel<true>``, every
game a placement), as ``engine_roofline.act`` reads the macro one: the
least time of one launch over its device time per launch.  The bytes are
``step_bytes`` and the per-game kind and y (int32) read; the operations
``tick_int_ops`` of the place kind, with the iteration's share of resets
(benchmark/work/engine.py)."""
from benchmark.trace import kernels_named
from benchmark.work import engine, peaks

NAMES = ["step_kernel"]   # the only instantiation an iteration launches


def read(run):
    t = run["trace"]
    if t is None or run["ctx"].device.type != "cuda":
        return None
    launches = kernels_named(t, NAMES)
    if not launches:
        return None
    per_launch = sum(s for _, s in launches) / len(launches)
    u = t["unit"]
    cfg = engine.env_config(run["ctx"].config)
    n = u["games"]
    share = u["dones"] / (n * u["ticks"])
    least = max((engine.step_bytes(cfg, n) + 2 * 4 * n)
                / peaks.HBM_BYTES_PER_S,
                n * engine.tick_int_ops(cfg, share, False, "place")
                / peaks.int32_ops_per_s())
    return 100.0 * least / per_launch
