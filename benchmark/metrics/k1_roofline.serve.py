"""K1 (sparse attention forward) over its bound in the traced requests:
the live rows and slots of each bag, the time from the trace."""

from benchmark.roofline import kernel_share


def read(job):
    return kernel_share(job, "sparse_attention_fwd")
