"""The engine kernel's share of its roofline in the traced segment: the
least time of one launch of the one-tick entry over its device time per
launch.  The least time is the larger of the bytes side (the state read
and written once, the actions read, reward and done written, at the
HBM rate) and the operation side (the 32-bit integer operations of a
game-tick, with the segment's share of resets, at the derived INT32
rate), from the benchmark's own counts (benchmark/work/engine.py)."""
from benchmark.trace import kernels_named
from benchmark.work import engine, peaks

NAMES = ["step_kernel"]   # the one-tick entry's instantiations


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
    least = max(engine.step_bytes(cfg, n) / peaks.HBM_BYTES_PER_S,
                n * engine.tick_int_ops(cfg, share, False)
                / peaks.int32_ops_per_s())
    return 100.0 * least / per_launch
