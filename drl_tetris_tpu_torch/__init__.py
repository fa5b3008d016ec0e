"""drl_tetris_tpu_torch: the PyTorch / CUDA port of drl_tetris_tpu.

The JAX package ``drl_tetris_tpu`` stays the reference; this package mirrors
its layout (``engine/``, ``env/``, ``models/``, ``algos/``, ``config/``,
``runtime/``, ``utils/``) in PyTorch idiom and imports nothing of it, nor
JAX.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU.  With no card and no explicit CPU request they raise; they never
fall back.  On CPU tensors the engine runs its plain PyTorch version; on
CUDA tensors it launches the hand-written kernel (engine/cuda_tick.py).

Float32 is IEEE float32 on the card too: ``resolve_device``, which every
entry point passes through (the env, the nets and so the trainers,
rollouts and evaluation), turns TF32 off for cuDNN's convolutions and
cuBLAS's matmuls, as the JAX package's ``compute_dtype="float32"``
("for bit-stable comparisons") asks.  bfloat16 compute is unchanged.
"""
from __future__ import annotations

import torch


def use_ieee_float32():
    """Float32 convolutions and matmuls in IEEE float32: TF32 off for
    cuDNN and cuBLAS (process-wide; torch leaves cuDNN's on)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``device`` (default "cuda") as a torch.device, with float32 set to
    IEEE (``use_ieee_float32``); raises if it names a CUDA device and no
    card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    use_ieee_float32()
    return dev
