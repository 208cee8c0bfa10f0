"""The reader of `forward_us_per_tile.serve` on a made-up job: Σ
forward_stream_s / Σ tiles over the traced requests that carry it, and
None where none does (the program before the `serve.forward` span)."""

import pytest

from benchmark.tests.test_bench_span_metrics import FakeJob, reader, spans


def forward(n, stream=None):
    t = spans(n, 0.1, 0.002)
    if stream is not None:
        t["forward_stream_s"] = stream
    return t


def test_forward_reader_reads_the_traced_requests():
    job = FakeJob([forward(1000, 0.9), forward(3000, 0.3),
                   forward(2000, 5.0), forward(6000)])
    assert reader("forward_us_per_tile.serve").read(job) == pytest.approx(
        300.0)


def test_forward_reader_gives_none_without_its_key():
    r = reader("forward_us_per_tile.serve")
    assert r.read(FakeJob([forward(1000)] * 4)) is None
    assert r.read(FakeJob([])) is None
