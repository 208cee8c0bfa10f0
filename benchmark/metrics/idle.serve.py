"""Share of the traced stretch of serving with no device operation."""

from benchmark.roofline import idle


def read(job):
    return idle(job)
