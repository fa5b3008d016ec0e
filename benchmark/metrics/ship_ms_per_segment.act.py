"""The traced segment's ship: the stream's time of its ``ship.gae`` spans
(the worker-side GAE batch) plus the host's time of its ``ship.copy``
spans (the batch and stats to the host, ending in the copy's sync), over
its rollouts (drl_tetris_tpu_torch/utils/tracing.py)."""
from benchmark.spans import traced_summary


def read(run):
    return from_summary(traced_summary(run))


def from_summary(summary):
    if not summary or not {"ship.gae", "ship.copy", "rollout"} <= set(
            summary) or summary["ship.gae"]["device_ms"] is None:
        return None
    return ((summary["ship.gae"]["device_ms"]
             + summary["ship.copy"]["host_ms"])
            / summary["rollout"]["count"])
