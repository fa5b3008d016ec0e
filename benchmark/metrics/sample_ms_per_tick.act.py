"""The stream's time of the traced segment's ``sample`` spans (the piece
gather, the action draw, the prob and value gathers; the bootstrap's
included), summed, over its ticks: CUDA events at each span's start and
end (drl_tetris_tpu_torch/utils/tracing.py)."""
from benchmark.spans import device_ms_per_tick, traced_summary


def read(run):
    return from_summary(traced_summary(run))


def from_summary(summary):
    return device_ms_per_tick(summary, "sample")
