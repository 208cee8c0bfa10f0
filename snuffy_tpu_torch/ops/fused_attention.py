"""Fused inverted sparse attention: the hand-written Hopper kernel.

Replaces `snuffy_tpu/ops/pallas_attention.py::_fwd_kernel` (with its
`_keep_factor` dropout hash and its segment mode) by the CUDA C++ kernel
in `csrc/sparse_attention_fwd.cu`, built for sm_90a by `_build.py` and
called through ctypes. The public functions keep the JAX signatures.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it runs the plain version in `sparse_attention.py`, which is the
kernel's oracle. `launches` counts the kernel's launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from snuffy_tpu_torch.ops import _build
from snuffy_tpu_torch.ops.sparse_attention import (
    packed_inverted_sparse_attention,
)

KERNEL = "sparse_attention_fwd"
SOURCE = "snuffy_tpu_torch/csrc/sparse_attention_fwd.cu"
REPLACES = "snuffy_tpu/ops/pallas_attention.py:94"
MAX_DK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


@functools.lru_cache(maxsize=None)
def load_kernel() -> _build.BuiltLibrary:
    """Build (first use) and bind the kernel's C entry points, once."""
    built = _build.load_library(KERNEL)
    fn = built.lib.snuffy_sparse_attention_fwd
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, i, f, f, p]
    fn.restype = ctypes.c_int
    err = built.lib.snuffy_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


def _int32(seed: int) -> int:
    return (int(seed) + 2**31) % 2**32 - 2**31


def _check_cuda_args(q, k, v, slot_valid, q_valid, segments):
    tensors = {"q": q, "k": k, "v": v, "slot_valid": slot_valid,
               "q_valid": q_valid}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q/k/v must share one of {list(_DTYPES)}, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if slot_valid.dtype != torch.bool or q_valid.dtype != torch.bool:
        raise TypeError("slot_valid and q_valid must be bool")
    if q.dim() != 3 or k.dim() != 3 or v.shape != q.shape:
        raise ValueError(
            f"want q, v (h, k·N, dk) and k (h, k·S, dk); got q {tuple(q.shape)}"
            f", k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    h, kn, dk = q.shape
    if k.shape[0] != h or k.shape[2] != dk:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if slot_valid.shape != (k.shape[1],) or q_valid.shape != (kn,):
        raise ValueError(
            f"masks {tuple(slot_valid.shape)}, {tuple(q_valid.shape)} do not "
            f"match {k.shape[1]} slots and {kn} rows"
        )
    if segments < 1 or kn % segments or k.shape[1] % segments:
        raise ValueError(
            f"packed rows ({kn}) and slots ({k.shape[1]}) must divide "
            f"segments={segments}"
        )
    if not 1 <= dk <= MAX_DK:
        raise ValueError(f"the kernel takes 1 <= dk <= {MAX_DK}, got {dk}")
    if max(q.numel(), k.numel()) >= 2**31:
        raise ValueError("tensors of 2**31 or more elements are not supported")


def fused_packed_inverted_sparse_attention(
    q: torch.Tensor,           # (h, k·N, dk): k bags packed on the row axis
    k: torch.Tensor,           # (h, k·S, dk)
    v: torch.Tensor,           # (h, k·N, dk)
    slot_valid: torch.Tensor,  # (k·S,) bool
    q_valid: torch.Tensor,     # (k·N,) bool
    segments: int,
    *,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Segment-aware fused inverted sparse attention → (h, k·S, dk)."""
    if q.device.type == "cpu":
        return packed_inverted_sparse_attention(
            q, k, v, slot_valid, q_valid, segments,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
        )
    if q.device.type != "cuda":
        raise ValueError(f"no sparse attention for device {q.device}")
    _check_cuda_args(q, k, v, slot_valid, q_valid, segments)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            f"{KERNEL} has no backward kernel yet (the training slice adds "
            "it); run under torch.no_grad() or torch.inference_mode()"
        )
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    h, kn, dk = q.shape
    n, s = kn // segments, k.shape[1] // segments
    out = torch.empty((h, k.shape[1], dk), dtype=q.dtype, device=q.device)
    row_max = torch.empty((h * kn,), dtype=torch.float32, device=q.device)
    row_scale = torch.empty_like(row_max)
    lib = load_kernel().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.snuffy_sparse_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_valid.data_ptr(),
            q_valid.data_ptr(), out.data_ptr(), row_max.data_ptr(),
            row_scale.data_ptr(), h, segments, n, s, dk, _DTYPES[q.dtype],
            1.0 / math.sqrt(dk),
            _int32(0 if dropout_seed is None else dropout_seed),
            dropout_rate, 1.0 / (1.0 - dropout_rate), stream,
        )
    if err != 0:
        msg = lib.snuffy_cuda_error_string(err).decode()
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err} ({msg})")
    global launches
    launches += 1
    return out


def fused_inverted_sparse_attention(
    q: torch.Tensor,           # (h, N, dk)
    k: torch.Tensor,           # (h, S, dk)
    v: torch.Tensor,           # (h, N, dk)
    slot_valid: torch.Tensor,  # (S,) bool
    q_valid: torch.Tensor,     # (N,) bool
    *,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Fused inverted sparse attention for one bag → (h, S, dk)."""
    return fused_packed_inverted_sparse_attention(
        q, k, v, slot_valid, q_valid, 1,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
    )
