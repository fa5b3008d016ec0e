"""The yardstick's counts: FLOPs of the reference net, bytes and integer
operations of an engine launch (against the chip_smoke.py lines they
copy), and the trace's reduction to busy time, kernels and idle gaps."""
import json
from types import SimpleNamespace
from pathlib import Path

import pytest
import torch

from benchmark import trace
from benchmark.work import engine, flops

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "benchmark/configs/sventon_ppo.json")
                    .read_text())


def silver_conv_flops(m, height, width):
    """2 x multiply-adds of the 'silver' trunk's convs, walked from its
    layer rule (peephole 'add' joins keep max(conv, input) channels; the
    value tower pools (3, 2) after each layer, clamped to the map)."""
    H, W = height + 2, width + 2
    f, k = m["tower_filters"], m["tower_filter_size"] ** 2
    total = 0

    def tower(c):
        nonlocal total
        for _ in range(m["tower_layers"]):
            total += 2 * c * f * k * H * W
            c = max(c, f)
        return c
    c_vis = tower(1)
    tower(1)
    c_join = tower(12 + c_vis)
    tower(12 + c_vis)
    c_adv = tower(max(12, c_join))
    n_act = m["n_rotations"] * m["n_pieces"]
    total += 2 * c_adv * n_act * H * 3 * (W - 2)
    c, h, w = 2 * c_join + 2, H, W
    for i in range(m["val_layers"]):
        last = i == m["val_layers"] - 1
        out = m["n_pieces"] + 1 if last else m["val_filters"]
        total += 2 * c * out * m["val_filter_size"] ** 2 * h * w
        c = out if last else max(c, out)
        h, w = h // min(3, h), w // min(2, w)
    return total


def test_forward_flops_are_the_convs_multiply_adds():
    fwd, fwd_bwd = flops.per_sample(CONFIG)
    assert fwd == silver_conv_flops(CONFIG["model"], 22, 10)
    assert 2 * fwd < fwd_bwd <= 3 * fwd


def test_flops_count_the_reference_net_not_a_program():
    a = flops.per_sample(CONFIG)
    small = json.loads(json.dumps(CONFIG))
    small["model"]["tower_filters"] = 32
    assert flops.per_sample(small)[0] < a[0]


def test_engine_bytes_match_the_kernels_leaves():
    from drl_tetris_tpu_torch.engine import cuda_tick
    from drl_tetris_tpu_torch.env.env import EnvConfig
    cfg = engine.env_config(CONFIG)
    n = 1024
    spec = cuda_tick._leaf_spec(EnvConfig(), n)
    want = sum(shape.numel() * torch.empty((), dtype=dt).element_size()
               for _, dt, shape, _ in spec)
    assert engine.state_bytes(cfg, n) == want
    assert engine.step_bytes(cfg, n) == 2 * want + 13 * n


@pytest.mark.parametrize("kind", ["macro", "place", "pose", "mixed"])
@pytest.mark.parametrize("share", [0.0, 0.0213, 1.0])
def test_tick_ops_are_chip_smokes(kind, share):
    import chip_smoke
    from drl_tetris_tpu_torch.env.env import EnvConfig
    cfg = engine.env_config(CONFIG)
    for draw in (False, True):
        assert engine.tick_int_ops(cfg, share, draw, kind) == \
            chip_smoke.tick_int_ops(EnvConfig(), share, draw, kind)


class Ev(SimpleNamespace):
    def name(self):
        return self.n

    def device_type(self):
        return self.d

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.t

    def is_user_annotation(self):
        return self.u


def test_trace_reduction():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = [Ev(n=trace.SPAN, d=cpu, s=0, t=1000, u=True),
           Ev(n="aten::conv2d", d=cpu, s=0, t=300, u=False),
           Ev(n="aten::add", d=cpu, s=500, t=400, u=False),
           Ev(n="k1", d=cuda, s=100, t=100, u=False),
           Ev(n="k2", d=cuda, s=150, t=100, u=False),
           Ev(n="k1", d=cuda, s=600, t=100, u=False),
           Ev(n="ann", d=cuda, s=0, t=1000, u=True)]
    out = trace.reduce_events(evs)
    assert out["window_s"] == pytest.approx(1e-6)
    assert out["busy_s"] == pytest.approx(250e-9)
    assert len(out["kernels"]) == 3
    ops = dict(out["breakdown"]["device_ops"])
    assert ops["k1"] == pytest.approx(200e-9)
    gaps = dict(out["breakdown"]["idle_gaps"])
    # gaps: [0,100) conv2d, [250,600) mid 425 python, [700,1000) add
    assert gaps["aten::conv2d"] == pytest.approx(100e-9)
    assert gaps["python"] == pytest.approx(350e-9)
    assert gaps["aten::add"] == pytest.approx(300e-9)
    assert trace.kernels_named(out, ["k2"]) == [("k2", pytest.approx(1e-7))]
