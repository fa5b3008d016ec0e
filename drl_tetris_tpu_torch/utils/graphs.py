"""CUDA graphs for the port's fixed-shape loops on the card.

``Captured(fn, args)`` runs ``fn(*args)`` twice on a side stream (so that
cuDNN and the caching allocator have settled), then records one call into
a CUDA graph.  Calling it copies new arguments into the graph's own input
buffers and replays the graph: the host issues a few launches instead of
one per operation, and the card, not the host's pace, sets the loop's
time.  The outputs are the graph's own buffers, overwritten by the next
replay.  The kernels and their order are the eager call's, so are the
numbers.  ``fn`` must not synchronise with the host nor copy from host
memory; the tensors it reads besides its arguments (weights) are read at
every replay from where they were at capture, so they must be updated in
place.  ``REPLAYS`` counts the replays.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

REPLAYS = {"graph": 0}
WARMUP = 2


def usable(device: torch.device) -> bool:
    """Whether work on ``device`` can be captured: a CUDA device."""
    return device.type == "cuda"


class Captured:
    """``fn`` captured once for arguments shaped like ``args``."""

    def __init__(self, fn: Callable, args: Sequence[torch.Tensor],
                 before_capture: Callable[[], None] = lambda: None):
        self.inputs = [a.clone() for a in args]
        cur = torch.cuda.current_stream(self.inputs[0].device)
        side = torch.cuda.Stream(self.inputs[0].device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn(*self.inputs)
        cur.wait_stream(side)
        before_capture()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)

    def fits(self, args: Sequence[torch.Tensor]) -> bool:
        return len(args) == len(self.inputs) and all(
            a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
            for a, b in zip(args, self.inputs))

    def __call__(self, *args: torch.Tensor):
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        self.graph.replay()
        REPLAYS["graph"] += 1
        return self.outputs
