"""drl_tetris_tpu_torch: the PyTorch / CUDA port of drl_tetris_tpu.

The JAX package ``drl_tetris_tpu`` stays the reference; this package mirrors
its layout (``engine/``, ``env/``, ``models/``, ``algos/``, ``config/``,
``runtime/``, ``utils/``) in PyTorch idiom and imports nothing of it, nor
JAX.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU.  With no card and no explicit CPU request they raise; they never
fall back.  On CPU tensors the engine runs its plain PyTorch version; on
CUDA tensors it launches the hand-written kernel (engine/cuda_tick.py).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (default "cuda") as a torch.device; raises if it names a
    CUDA device and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
