"""The stream's time of the traced iteration's ``masks`` spans (the
observation and the acting piece's legal top-drop placements with their
successor boards), summed, over its ticks: CUDA events at each span's
start and end (drl_tetris_tpu_torch/utils/tracing.py)."""
from benchmark.spans import device_ms_per_tick, traced_summary


def read(run):
    return from_summary(traced_summary(run))


def from_summary(summary):
    return device_ms_per_tick(summary, "masks")
