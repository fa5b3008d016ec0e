"""FLOPs per board of SIXten's value net, counted by torch's flop counter
(``torch.utils.flop_counter.FlopCounterMode``, the method of
benchmark/work/flops.py) over the benchmark's frozen reference VNet
(benchmark/reference/sixten.py), never the program's: the count stays the
same whatever implements the net.  A successor board and a target's state
cost one forward; a minibatch sample one forward and one backward."""
from __future__ import annotations

import functools
import json

import torch

from benchmark.reference.nets import VEC_DIM
from benchmark.reference.sixten import VNet

BATCH = 2


@functools.lru_cache(maxsize=8)
def _per_board(model_json: str, height: int, width: int):
    from torch.utils.flop_counter import FlopCounterMode
    net = VNet(json.loads(model_json), (height, width))
    g = torch.Generator().manual_seed(0)
    vec = [torch.randn(BATCH, VEC_DIM, generator=g) for _ in range(2)]
    vis = [torch.rand(BATCH, height, width, 1, generator=g).round()
           for _ in range(2)]
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(vec, vis)
    fwd = fc.get_total_flops() / BATCH
    with FlopCounterMode(display=False) as fc:
        net(vec, vis).sum().backward()
    return fwd, fc.get_total_flops() / BATCH


def per_board(config: dict):
    """(forward, forward + backward) FLOPs per board of the configuration's
    VNet at its board."""
    e = config["env"]["engine"]
    return _per_board(json.dumps(config["model"], sort_keys=True),
                      e["height"], e["width"])
