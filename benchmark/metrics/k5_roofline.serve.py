"""K5 (dense attention) over its bound in the traced requests: the bound
from the tiles' shapes (benchmark/roofline.py), the time from the trace's
kernels named by the registry."""

from benchmark.roofline import kernel_share


def read(job):
    return kernel_share(job, "dense_attention")
