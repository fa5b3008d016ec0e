"""The stream's time of the traced iteration's ``update.step`` spans (a
minibatch of the update: forward, backward and Adam's step), summed, over
their count (one a minibatch): CUDA events at each span's start and end
(drl_tetris_tpu_torch/utils/tracing.py)."""
from benchmark.spans import traced_summary


def read(run):
    return from_summary(traced_summary(run))


def from_summary(summary):
    if not summary or "update.step" not in summary:
        return None
    s = summary["update.step"]
    return None if s["device_ms"] is None else s["device_ms"] / s["count"]
