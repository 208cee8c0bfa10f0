"""The port's hand-written CUDA kernels: one record each, built and launched
through one path.

  sparse_attention_fwd  csrc/sparse_attention_fwd.cu  (ops/fused_attention.py)
  sparse_attention_bwd  csrc/sparse_attention_bwd.cu  (ops/fused_attention.py)
  dense_attention       csrc/dense_attention.cu       (ops/dense_attention.py)

Each kernel is built for sm_90a by `_build.py` on first use and called
through ctypes. `launch` calls a kernel's C entry on the current stream and
adds one to the kernel's `launches`, which counts launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from snuffy_tpu_torch.ops import _build

MAX_DK = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass
class Kernel:
    name: str        # csrc/<name>.cu and its C entry snuffy_<name>
    source: str
    replaces: str    # file:line of the TPU kernel
    argtypes: tuple
    launches: int = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD = Kernel(
    "sparse_attention_fwd", "snuffy_tpu_torch/csrc/sparse_attention_fwd.cu",
    "snuffy_tpu/ops/pallas_attention.py:94",
    (_P,) * 8 + (_I,) * 6 + (_F, _I, _F, _F, _P),
)
BWD = Kernel(
    "sparse_attention_bwd", "snuffy_tpu_torch/csrc/sparse_attention_bwd.cu",
    "snuffy_tpu/ops/pallas_attention.py:194",
    (_P,) * 11 + (_I,) * 6 + (_F, _I, _F, _F, _P),
)
DENSE = Kernel(
    "dense_attention", "snuffy_tpu_torch/csrc/dense_attention.cu",
    "snuffy_tpu/ops/experimental/dense_attention.py:40",
    (_P,) * 4 + (_I,) * 5 + (_F, _P),
)
KERNELS = (FWD, BWD, DENSE)


def reset_launches() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


@functools.lru_cache(maxsize=None)
def load_kernel(name: str) -> _build.BuiltLibrary:
    """Build (first use) and bind one kernel's C entry points, once."""
    kernel = next(k for k in KERNELS if k.name == name)
    built = _build.load_library(name)
    fn = getattr(built.lib, f"snuffy_{name}")
    fn.argtypes = list(kernel.argtypes)
    fn.restype = ctypes.c_int
    err = built.lib.snuffy_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


def launch(kernel: Kernel, device: torch.device, *args) -> None:
    """Call the kernel's C entry on the current stream of `device`; raise
    on a refused launch."""
    lib = load_kernel(kernel.name).lib
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"snuffy_{kernel.name}")(*args, stream)
    if err != 0:
        msg = lib.snuffy_cuda_error_string(err).decode()
        raise RuntimeError(
            f"{kernel.name} launch failed: cudaError {err} ({msg})")
    kernel.launches += 1
