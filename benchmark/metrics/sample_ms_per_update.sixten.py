"""The stream's time of the traced iteration's ``update.sample`` spans (the
replay's rank sample: the noise, the scores over every row, the top-k and
the k-step windows' gather), summed, over their count (one an update):
CUDA events at each span's start and end
(drl_tetris_tpu_torch/utils/tracing.py)."""
from benchmark.spans import traced_summary


def read(run):
    return from_summary(traced_summary(run))


def from_summary(summary):
    if not summary or "update.sample" not in summary:
        return None
    s = summary["update.sample"]
    return None if s["device_ms"] is None else s["device_ms"] / s["count"]
