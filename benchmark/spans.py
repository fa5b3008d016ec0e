"""The program's own spans of the traced unit, for the readers of the
metrics whose source is ``program_span``: the summary of the latest unit
of ``drl_tetris_tpu_torch/utils/tracing.py`` (a rollout and the ship that
follows it), which records only under the profiler here.  None without a
card or a trace, and where the program has no such module or span."""
from __future__ import annotations


def traced_summary(run):
    """{span name: {"count", "host_ms", "device_ms"}} of the traced unit,
    or None."""
    if run["trace"] is None or run["ctx"].device.type != "cuda":
        return None
    try:
        from drl_tetris_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.summary(tracing.current_unit()) or None


def device_ms_per_tick(summary, name: str):
    """The stream's time of the ``name`` spans, summed, over the unit's
    ticks; None where either is missing."""
    if not summary or name not in summary or "tick" not in summary:
        return None
    ms = summary[name]["device_ms"]
    return None if ms is None else ms / summary["tick"]["count"]
