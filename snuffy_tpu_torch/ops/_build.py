"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on first use into
`build/snuffy_tpu_torch/lib<name>-<hash>.so` at the repository root, with a
plain C interface (no PyTorch headers, so a build takes seconds). The hash
covers the source and the flags, so a library is rebuilt only when either
changes. A failed build raises with nvcc's output. Nothing here runs at
import time: this module is imported on machines without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "snuffy_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    build_s: float      # 0.0 when the library was already built
    log: str            # nvcc's output (ptxas register/spill lines)


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of snuffy_tpu_torch build only where the CUDA toolkit is "
        "installed"
    )


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> BuiltLibrary:
    """Compile `csrc/<name>.cu` if its build is missing, then load it."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    build_s, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_s = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src}:\n"
                f"{' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, out)
    return BuiltLibrary(ctypes.CDLL(str(out)), out, build_s, log)
