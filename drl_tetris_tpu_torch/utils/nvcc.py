"""Build route of the port's hand-written CUDA kernels: nvcc compiles a
source with a plain C interface into a shared library under
``build/torch_kernels/``, named by the source's stem and keyed by the hash
of the source and the flags, and ctypes loads it.  A library that exists
is reused, so processes of one checkout build each source once."""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
TARGET = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
          "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "with the CUDA toolkit on the machine with the "
                           "card")
    return path


def build(source: Path, flags: Sequence[str]) -> Tuple[Path, str]:
    """Compile ``source`` with ``flags`` into build/torch_kernels/ unless
    the library for this exact source and flags exists.  Returns (library
    path, the compiler's report: ptxas registers, spills and stack per
    kernel)."""
    source = Path(source)
    digest = hashlib.sha1(source.read_bytes()
                          + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    log = out.with_suffix(".ptxas.txt")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *flags, "-Xptxas", "-v", "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    log.write_text(res.stderr)
    os.replace(tmp, out)
    return out, res.stderr


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a C entry."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
