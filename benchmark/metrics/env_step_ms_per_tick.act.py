"""The stream's time of the traced segment's ``env_step`` spans (the
acting player's boards and the env step, one launch of the engine
kernel's one-tick entry), summed, over its ticks: CUDA events at each
span's start and end (drl_tetris_tpu_torch/utils/tracing.py)."""
from benchmark.spans import device_ms_per_tick, traced_summary


def read(run):
    return from_summary(traced_summary(run))


def from_summary(summary):
    return device_ms_per_tick(summary, "env_step")
