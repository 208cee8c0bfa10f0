"""The card's published peaks and the work each kernel needs, for the
`<kernel>_roofline` and `mfu` metrics.

Peaks: one NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data
sheet; chip_smoke.py:334-335): 989.4 TFLOP/s in bf16 and 3.35 TB/s of HBM;
494.7 TFLOP/s in TF32 for float32 work.
A kernel's bound is the larger of its bytes over the bandwidth and its
FLOPs over the peak (chip_smoke.py:402 `bound_ms`); its share is the sum
of its calls' bounds over the device time the trace gives its passes.

The work is what the layer needs, whatever the kernel does: each input and
output once, over the live rows and slots only, and the products of the
live (row, slot) pairs (chip_smoke.py:394 `live_pairs`, :530-533 forward).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989.4e12
PEAK_HBM_BYTES = 3.35e12
# products of float32 operands: no unit of the card runs them faster than
# its TF32 tensor cores (494.7 TFLOP/s dense, the same data sheet)
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float32": 494.7e12}
ELT = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype="bfloat16") -> float:
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_FLOPS[dtype])


def sparse_fwd_bound(heads, dk, rows, slots, dtype="bfloat16") -> float:
    """K1 on one bag: q, v over its live rows, k and the output over its
    live slots, the two masks; 4·h·dk FLOPs a live pair."""
    nbytes = (2 * rows + 2 * slots) * heads * dk * ELT[dtype] + rows + slots
    return bound_s(nbytes, 4 * heads * dk * rows * slots, dtype)


def dense_bound(z, n, dk, dtype="bfloat16") -> float:
    """K5 on z sequences of n tokens: q, k, v and the output once;
    4·n²·dk FLOPs a sequence."""
    return bound_s(4 * z * n * dk * ELT[dtype], 4 * z * n * n * dk, dtype)


def live_slots(n: int, k_top: int, k_rand: int) -> int:
    """Slots that hold a row, in a bag of n valid rows."""
    top = min(k_top, n)
    return top + min(k_rand, n - top)


def share(bound_total_s: float, device_s: float):
    """Percent of the bound reached, or None where the trace holds no time
    for the kernel (the metric is then left out, never read as 0)."""
    if device_s <= 0.0 or bound_total_s <= 0.0:
        return None
    return 100.0 * bound_total_s / device_s


def kernel_share(job, kernel: str):
    """`share` of one registry kernel over a job's traced stretch."""
    if job.trace is None:
        return None
    return share(job.kernel_bound_s.get(kernel, 0.0),
                 job.trace.kernel_s.get(kernel, 0.0))


def mfu(job):
    """Percent of the peak of the cell's compute dtype: the FLOPs the
    untraced part of the window completed over its host-clock length."""
    done, seconds = job.untraced_work()
    if done <= 0 or seconds <= 0:
        return None
    return 100.0 * done / (seconds * PEAK_FLOPS[job.compute_dtype])


def idle(job):
    """Percent of the traced stretch with no device operation running."""
    if job.trace is None or job.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - job.trace.busy_s / job.trace.window_s)
