"""The card's peaks: published rates of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense, at its 700 W limit) and the derived INT32 rate of
chip_smoke.py (``INT32_LANES_PER_SM``, ``int32_ops_per_s``)."""
from __future__ import annotations

import functools
import subprocess

import torch

BF16_FLOPS = 989e12          # dense bfloat16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12    # HBM3
INT32_LANES_PER_SM = 64      # INT32 lanes per SM per clock (Hopper white
                             # paper); the rate below is derived, not
                             # published


def smi(query: str) -> str:
    """One nvidia-smi query of card 0 (no units)."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,"
         "nounits", "-i", "0"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=1)
def int32_ops_per_s() -> float:
    """SMs x INT32 lanes per SM x the SM's maximum clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * float(smi("clocks.max.sm")) * 1e6
