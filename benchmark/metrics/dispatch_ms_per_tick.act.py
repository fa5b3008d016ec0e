"""The host's time inside the traced segment's ``tick`` spans, over its
ticks: how long the host takes to issue a tick (observe, forward, sample,
env step), beside the stream's time of the same layers, under the
profiler (drl_tetris_tpu_torch/utils/tracing.py)."""
from benchmark.spans import traced_summary


def read(run):
    return from_summary(traced_summary(run))


def from_summary(summary):
    if not summary or "tick" not in summary:
        return None
    return summary["tick"]["host_ms"] / summary["tick"]["count"]
