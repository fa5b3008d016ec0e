"""The JAX package's demo agent in the port's format, and the check that
holds the port's net against JAX's own outputs on it.

``data/demo_weights_torch`` holds the demo checkpoint of
``data/demo_weights`` (step 6,029,312, the r5 'silver' PPONet) as the
port's params-only ``state.pt`` beside the same ``settings.json``, and
``demo_outputs.npz``: 16 positions (``vec``, ``vis``) and the JAX
``PPONet``'s ``pi`` and ``v`` on them at float32 and at bfloat16.
tools/torch_import_flax_checkpoint.py writes both (``--params-only
--fixture``), where JAX runs; the port reads them anywhere, the card's
machine included.

Tolerances: float32 within F32_TOL absolute (the summation order of the
convolutions); bfloat16 within BF16_TOL, the bounds of
tests/test_torch_nets.py (pi and v absolute, and log pi over the cells
where JAX gives p > LOG_PI_FLOOR), which the two frameworks' different
rounding points through 16 bfloat16 layers need.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np
import torch

DEMO_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "demo_weights_torch")
FIXTURE = "demo_outputs.npz"
F32_TOL = 1e-4
BF16_TOL = {"pi": 0.062, "v": 0.24, "log_pi": 0.6}
LOG_PI_FLOOR = 1e-3


def load_fixture(directory: str = DEMO_DIR) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(directory, FIXTURE)) as f:
        return {k: f[k] for k in f.files}


def fixture_inputs(fixture, device):
    """The positions as the nets' per-perspective input lists."""
    vec = torch.from_numpy(fixture["vec"]).to(device)
    vis = torch.from_numpy(fixture["vis"].astype(np.float32)).to(device)
    return [vec[:, 0], vec[:, 1]], [vis[:, 0, ..., None],
                                    vis[:, 1, ..., None]]


def demo_net(compute_dtype: str, device, directory: str = DEMO_DIR):
    """The demo agent's PPONet at ``compute_dtype`` on ``device``, built
    from its settings.json and weights."""
    from drl_tetris_tpu_torch.config.presets import resolve
    from drl_tetris_tpu_torch.models.nets import PPONet
    from drl_tetris_tpu_torch.runtime import checkpoint as ckpt
    cfg = resolve(ckpt.load_settings(directory))
    e = cfg.env.engine
    net = PPONet(dataclasses.replace(cfg.model, compute_dtype=compute_dtype),
                 board=(e.height, e.width), device=device)
    net.load_params_(ckpt.restore_raw(directory)["params"])
    return net.eval().requires_grad_(False)


def fixture_errors(device, directory: str = DEMO_DIR) -> dict:
    """{dtype: {output: max gap}} of the port's demo net on ``device``
    against JAX's outputs in the fixture (log_pi for bfloat16)."""
    fx = load_fixture(directory)
    vec, vis = fixture_inputs(fx, device)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        with torch.no_grad():
            pi, v = demo_net(dtype, device, directory)(vec, vis)
        pi, v = pi.float().cpu().numpy(), v.float().cpu().numpy()
        jpi, jv = fx[f"pi_{dtype}"], fx[f"v_{dtype}"]
        errs[dtype] = {"pi": float(np.abs(pi - jpi).max()),
                       "v": float(np.abs(v - jv).max())}
        if dtype == "bfloat16":
            live = jpi > LOG_PI_FLOOR
            errs[dtype]["log_pi"] = float(np.abs(
                np.log(jpi[live]) - np.log(np.maximum(pi[live], 1e-30))
            ).max())
    return errs


def check_fixture(errs: dict) -> None:
    """Raise unless ``fixture_errors``'s gaps are within the tolerances."""
    bad = {k: e for k, e in errs["float32"].items() if not e < F32_TOL}
    bad.update({f"bf16 {k}": e for k, e in errs["bfloat16"].items()
                if not e < BF16_TOL[k]})
    if bad:
        raise AssertionError(f"the port's demo net disagrees with JAX's "
                             f"outputs: {bad} (float32 tolerance {F32_TOL}, "
                             f"bfloat16 {BF16_TOL})")
