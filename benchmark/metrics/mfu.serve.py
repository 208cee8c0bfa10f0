"""Model FLOPs of the untraced requests (embedder and MILNet forward,
benchmark/flops.py) over their window's length times the bf16 peak."""

from benchmark.roofline import mfu


def read(job):
    return mfu(job)
