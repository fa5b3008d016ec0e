"""FLOPs per sample of the configuration's net, counted by torch's flop
counter (``torch.utils.flop_counter.FlopCounterMode``, the method of
drl_tetris_tpu_torch/runtime/bench.py ``iteration_flops``) over the
benchmark's frozen reference net (benchmark/reference/nets.py), never the
program's: the count stays the same whatever implements the net."""
from __future__ import annotations

import functools
import json

import torch

from benchmark.reference.nets import PPONet, VEC_DIM

BATCH = 2


@functools.lru_cache(maxsize=8)
def _per_sample(model_json: str, height: int, width: int):
    from torch.utils.flop_counter import FlopCounterMode
    model = json.loads(model_json)
    net = PPONet(model, (height, width))
    g = torch.Generator().manual_seed(0)
    vec = [torch.randn(BATCH, VEC_DIM, generator=g) for _ in range(2)]
    vis = [torch.rand(BATCH, height, width, 1, generator=g).round()
           for _ in range(2)]
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(vec, vis)
    fwd = fc.get_total_flops() / BATCH
    with FlopCounterMode(display=False) as fc:
        pi, v = net(vec, vis)
        (pi.sum() + v.sum()).backward()
    return fwd, fc.get_total_flops() / BATCH


def per_sample(config: dict):
    """(forward, forward + backward) FLOPs per sample of the
    configuration's net at its board."""
    e = config["env"]["engine"]
    return _per_sample(json.dumps(config["model"], sort_keys=True),
                       e["height"], e["width"])
