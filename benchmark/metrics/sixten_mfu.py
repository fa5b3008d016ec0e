"""The window's VNet FLOPs over its time against the card's dense bf16
peak, in percent: a forward per successor board of the acting ticks (the
bootstrap's included) and per state of the k-step targets, a forward and a
backward per minibatch sample, counted on the benchmark's reference VNet
(benchmark/work/vnet_flops.py)."""
from benchmark.work import peaks, vnet_flops


def read(run):
    if run["ctx"].device.type != "cuda":
        return None
    fwd, fwd_bwd = vnet_flops.per_board(run["ctx"].config)
    total = sum(fwd * (u["successor_boards"] + u["target_boards"])
                + fwd_bwd * u["train_samples"] for u in run["units"])
    return 100.0 * total / run["window_s"] / peaks.BF16_FLOPS
