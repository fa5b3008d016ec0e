"""The stream's time of the traced iteration's ``update.targets`` spans
(the k-step targets: the reference net's forwards over the sample's
windows), summed, over their count (one an update): CUDA events at each
span's start and end (drl_tetris_tpu_torch/utils/tracing.py)."""
from benchmark.spans import traced_summary


def read(run):
    return from_summary(traced_summary(run))


def from_summary(summary):
    if not summary or "update.targets" not in summary:
        return None
    s = summary["update.targets"]
    return None if s["device_ms"] is None else s["device_ms"] / s["count"]
