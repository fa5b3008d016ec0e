"""The stream's time of the traced iteration's ``forward`` spans (V over
every successor board and the choice; once more for the segment's stack
and the bootstrap), summed, over its ticks: the reader of
``forward_ms_per_tick.act``, read on this cell."""
from pathlib import Path

from benchmark.core import load_module

_act = load_module(Path(__file__).with_name("forward_ms_per_tick.act.py"),
                   "metric_forward_ms_per_tick_act")
read, from_summary = _act.read, _act.from_summary
