"""The window's model FLOPs over its time against the card's dense bf16
peak, in percent: a forward per acting sample (the bootstrap's
included), counted on the benchmark's reference net
(benchmark/work/flops.py)."""
from benchmark.work import flops, peaks


def read(run):
    if run["ctx"].device.type != "cuda":
        return None
    fwd, _ = flops.per_sample(run["ctx"].config)
    total = sum(fwd * u["fwd_samples"] for u in run["units"])
    return 100.0 * total / run["window_s"] / peaks.BF16_FLOPS
