"""The readers of the serve path's spans on a made-up job: what each
reads, over which requests, and None where no request carries its key
(the program before the spans)."""

from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT

READERS = ("upload_us_per_tile.serve", "upload_stream_us_per_tile.serve",
           "classify_dispatch_ms.serve")


def reader(name):
    return run.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


class FakeJob:
    """Requests 0 and 1 traced, 2 and 3 not; each (index, latency,
    prediction) as the serve driver keeps them."""

    def __init__(self, timings):
        self.done = [(i, 0.5, SimpleNamespace(timings=t))
                     for i, t in enumerate(timings)]
        self.traced = {0, 1}

    def untraced(self):
        return [d for d in self.done if d[0] not in self.traced]


def spans(n, upload, milnet, stream=None):
    t = {"n_patches": n, "embed_s": 1.0, "classify_s": 0.01,
         "upload_s": upload, "milnet_s": milnet}
    if stream is not None:
        t["upload_stream_s"] = stream
    return t


def test_readers_read_their_requests():
    job = FakeJob([spans(1000, 9.0, 9.0, stream=0.03),
                   spans(3000, 9.0, 9.0, stream=0.05),
                   spans(2000, 0.1, 0.002),
                   spans(6000, 0.5, 0.004)])
    assert reader(READERS[0]).read(job) == pytest.approx(75.0)   # µs
    assert reader(READERS[1]).read(job) == pytest.approx(20.0)   # µs
    assert reader(READERS[2]).read(job) == pytest.approx(3.0)    # ms


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_their_keys(name):
    bare = {"n_patches": 1000, "embed_s": 0.1, "classify_s": 0.005}
    assert reader(name).read(FakeJob([bare] * 4)) is None
    assert reader(name).read(FakeJob([])) is None
