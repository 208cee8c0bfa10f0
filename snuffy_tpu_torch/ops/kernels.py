"""The port's hand-written CUDA kernels: one record each, built and launched
through one path.

  sparse_attention_fwd  csrc/sparse_attention_fwd.cu  (ops/fused_attention.py)
  sparse_attention_bwd  csrc/sparse_attention_bwd.cu  (ops/fused_attention.py)
  dense_attention       csrc/dense_attention.cu       (ops/dense_attention.py)
  residual_norm         csrc/residual_norm.cu         (ops/residual_norm.py)

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
    # the device kernels of one launch, as fragments of their names in a
    # profiler trace: the passes, then the reduce of N splits (where N is
    # split)
    passes: tuple = ()
    launches: int = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD = Kernel(
    "sparse_attention_fwd", "snuffy_tpu_torch/csrc/sparse_attention_fwd.cu",
    "snuffy_tpu/ops/pallas_attention.py:94",
    (_P,) * 9 + (_I,) * 7 + (_F, _I, _F, _F, _P),
    passes=("row_stats", "slot_accumulate", "split_reduce"),
)
BWD = Kernel(
    "sparse_attention_bwd", "snuffy_tpu_torch/csrc/sparse_attention_bwd.cu",
    "snuffy_tpu/ops/pallas_attention.py:194",
    (_P,) * 12 + (_I,) * 7 + (_F, _I, _F, _F, _P),
    passes=("row_grad", "slot_grad", "dk_reduce"),
)
DENSE = Kernel(
    "dense_attention", "snuffy_tpu_torch/csrc/dense_attention.cu",
    "snuffy_tpu/ops/experimental/dense_attention.py:40",
    (_P,) * 4 + (_I,) * 5 + (_F, _P),
    passes=("dense_attention",),
)
# No TPU kernel: the JAX block's residual sums and nn.LayerNorms, which
# XLA fuses (norm1, the attention's sum, norm2, the closing sum, the final
# norm). Its device kernel's name matches no other kernel's passes and not
# torch's vectorized_layer_norm_kernel.
RESIDUAL_NORM = Kernel(
    "residual_norm", "snuffy_tpu_torch/csrc/residual_norm.cu",
    "snuffy_tpu/models/vit.py:202,211-212,229,235-236,368-374",
    (_P,) * 7 + (_I,) * 4 + (_F, _P),
    passes=("residual_norm",),
)
KERNELS = (FWD, BWD, DENSE, RESIDUAL_NORM)

# The bodies of every kernel: the device kernels' names end in
# _tf32_kernel, _tc_kernel (the dense kernel's _wgmma_kernel) and _kernel.
BODIES = ("f32 tensor cores (3xTF32)", "bf16 tensor cores", "CUDA cores")


def kernel_body(*tensors: torch.Tensor) -> str:
    """The body (one of BODIES) that a kernel's dispatch takes for a call
    on these tensors (q first; the rest those whose bases the kernel
    reads or writes): the rule of `launch_dtype` in every `csrc/*.cu`.
    dk ≤ 128 in whole 16-byte chunks a row (dk % 4 == 0 in f32, % 8 == 0
    in bf16) with 16-byte aligned bases takes the tensor cores."""
    q = tensors[0]
    dk = q.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    if dk <= 128 and aligned and dk % (16 // q.element_size()) == 0:
        return BODIES[0] if q.dtype == torch.float32 else BODIES[1]
    return BODIES[2]


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
