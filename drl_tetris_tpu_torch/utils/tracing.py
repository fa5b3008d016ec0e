"""Spans of the port's work, on the profiler's clock.

A span is a named interval of the host's work at a layer boundary.  It
records its host start and end (``time.time_ns()``, the Unix clock of
``torch.profiler``'s events), CUDA events at its start and end on the
card (its interval on the stream), its parent span and the unit of work
it belongs to: a trainer's iteration, or a rollout and the spans after
it (a worker's ship).  The counter at the same boundaries is every span's
calls.

    with tracing.span("rollout"):          # encloses spans
        with tracing.leaf("forward"):      # holds none
            ...

Every span records while ``torch.profiler`` records.  Inside an
``Iteration`` (a trainer's iteration) its phases record, the spans opened
directly inside it, whose times give its ``phase_ms``; the spans inside
those record only under the profiler.  Otherwise ``span`` and ``leaf``
make one check and return a shared null context: no CUDA event, no
``record_function``, no allocation.  Under the profiler a leaf is also a
``record_function`` of its name, so it sits on the device trace's
timeline; an enclosing span is not, because the profiler's readers name
idle time by the outermost host operation, which would then be the
enclosing span everywhere.

Recorded spans go to a bounded buffer (``CAPACITY``, the oldest dropped
first); ``summary()`` reduces them to per-name counts, host ms and device
ms.  The spans of one process are those of the thread that acts.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional

import torch

CAPACITY = 1 << 14
# outside an iteration, a span of this name opened at the top starts a new
# unit; the spans after it (a worker's ship) belong to it too
UNIT = "rollout"

_profiling = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class Span:
    """One recorded span.  ``events`` are its CUDA events (start, end), or
    None; ``device_ms`` is the stream's time between them (None without
    them), and reading it waits for the end event and frees both."""

    __slots__ = ("name", "parent", "unit", "start_ns", "end_ns", "events",
                 "_device_ms")

    def __init__(self, name: str, parent: Optional["Span"], unit: int,
                 cuda: bool):
        self.name, self.parent, self.unit = name, parent, unit
        self.end_ns = None
        self._device_ms = None
        self.events = None
        self.start_ns = time.time_ns()
        if cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self.events[0].record()

    def _stop(self):
        if self.events is not None:
            self.events[1].record()
        self.end_ns = time.time_ns()

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        if self.events is not None:
            start, end = self.events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self.events = None
        return self._device_ms


class _Tracer:
    def __init__(self):
        self.spans = collections.deque(maxlen=CAPACITY)
        self.open: List[Span] = []
        self.iterations: List["Iteration"] = []
        self.unit = 0
        self.suffix = ""


_T = _Tracer()


class _Open:
    """A span being recorded (the context ``span`` and ``leaf`` return
    while spans record)."""

    __slots__ = ("name", "leaf", "rf")

    def __init__(self, name: str, leaf: bool):
        self.name, self.leaf = name, leaf

    def __enter__(self) -> Span:
        t = _T
        self.rf = None
        if self.leaf and _profiling():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        parent = t.open[-1] if t.open else None
        if parent is None and not t.iterations and self.name == UNIT:
            t.unit += 1
        cuda = (t.iterations[-1].cuda if t.iterations
                else torch.cuda.is_initialized())
        s = Span(self.name + t.suffix, parent, t.unit, cuda)
        t.open.append(s)
        t.spans.append(s)
        for it in t.iterations:
            if parent is it.outer:
                it.phases.append(s)
        return s

    def __exit__(self, *exc):
        _T.open.pop()._stop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _records() -> bool:
    """Whether a span opened now records: under the profiler, or as a
    phase of the innermost iteration (or anywhere inside one that records
    every span)."""
    its = _T.iterations
    if not its:
        return _profiling()
    it = its[-1]
    return (it.every_span or (_T.open[-1] if _T.open else None) is it.outer
            or _profiling())


def span(name: str):
    """A span that encloses other spans (a rollout, a tick, a trainer's
    phase)."""
    if not _records():
        return _NULL
    return _Open(name, False)


def leaf(name: str):
    """A span that holds no other span; under the profiler also a
    ``record_function`` of its name."""
    if not _records():
        return _NULL
    return _Open(name, True)


@contextlib.contextmanager
def suffix(text: str):
    """Spans opened inside take ``text`` after their names (one policy's
    phases in a dual trainer)."""
    before = _T.suffix
    _T.suffix = before + text
    try:
        yield
    finally:
        _T.suffix = before


class Iteration:
    """A trainer's iteration on ``device``, one unit.  Its phases are the
    spans opened directly inside it, and record with or without the
    profiler; the spans inside them record under the profiler, or always
    with ``every_span`` (a tool's split of a unit without the profiler).
    ``phase_ms()``, once the device has passed the iteration's end, gives
    {phase name: ms}: the stream's time on the card, the host's on the CPU
    (where every operation has finished on return), summed over the phases
    of one name."""

    def __init__(self, device, every_span: bool = False):
        self.cuda = torch.device(device).type == "cuda"
        self.every_span = every_span
        self.phases: List[Span] = []
        self.outer: Optional[Span] = None

    def __enter__(self) -> "Iteration":
        _T.unit += 1
        self.outer = _T.open[-1] if _T.open else None
        _T.iterations.append(self)
        return self

    def __exit__(self, *exc):
        _T.iterations.remove(self)
        return False

    def phase_ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.phases:
            ms = s.device_ms if self.cuda else s.host_ms
            out[s.name] = out.get(s.name, 0.0) + ms
        return out


def current_unit() -> int:
    """The unit the latest spans belong to."""
    return _T.unit


def spans() -> List[Span]:
    """The buffered spans in the order they started."""
    return list(_T.spans)


def clear() -> None:
    """Drop every buffered span."""
    _T.spans.clear()


def summary(unit: Optional[int] = None) -> Dict[str, dict]:
    """{name: {"count", "host_ms", "device_ms"}} over the
    buffered spans that have ended, those of ``unit`` where it is given;
    ``device_ms`` is None where the spans had no CUDA events."""
    out: Dict[str, dict] = {}
    for s in list(_T.spans):
        if s.end_ns is None or (unit is not None and s.unit != unit):
            continue
        d = out.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                    "device_ms": None})
        d["count"] += 1
        d["host_ms"] += s.host_ms
        ms = s.device_ms
        if ms is not None:
            d["device_ms"] = (d["device_ms"] or 0.0) + ms
    return out
