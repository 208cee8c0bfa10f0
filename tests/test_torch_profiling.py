"""The port's `utils/profiling` against `snuffy_tpu/utils/profiling.py`,
and the serve path's spans.

`device_trace` writes one trace where the JAX one writes one; a small serve
request traced through `predict_tiles` (the card's phase 17 of
chip_smoke.py, on the CPU) holds the program's spans, nested by call and
carrying one id a request, around every op of the request, and gives the
scores of the same request outside the trace, bit for bit; with no
profiler the spans only add host seconds to `timings`; `device_profile`
refuses a trace without device time (a stubbed profiler: there is no card
here).
"""

import glob
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from snuffy_tpu.utils import profiling as jax_profiling
from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.embed.registry import Embedder
from snuffy_tpu_torch.models.snuffy import build_milnet
from snuffy_tpu_torch.models.vit import VisionTransformer
from snuffy_tpu_torch.pipeline.slide_inference import predict_tiles
from snuffy_tpu_torch.tools.profile_serve import read_trace, traced_request
from snuffy_tpu_torch.utils import profiling

SPANS = ("serve.embed", "serve.classify")
EMBED_BATCH = 4


@pytest.fixture(scope="module")
def serve_models():
    """A 2-layer ViT and a MILNet of d=32 at ρ=0.5 (the random share drawn
    from the request's seeded generator), and 10 tiles of 240² (resized to
    224²): three embed batches of 4."""
    torch.manual_seed(0)
    vit = VisionTransformer(patch_size=16, embed_dim=32, depth=2, num_heads=2)
    embedder = Embedder(vit, 32, 1).eval()
    cfg = SnuffyModelConfig(feats_size=32, num_classes=1, num_heads=2,
                            big_lambda=8, random_patch_share=0.5, depth=2,
                            activation="gelu")
    milnet = build_milnet(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tiles = torch.from_numpy(
        rng.integers(0, 256, (10, 240, 240, 3)).astype(np.uint8))
    return embedder, milnet, tiles


@pytest.fixture(scope="module")
def two_traced_requests(serve_models, tmp_path_factory):
    """The events of one `device_trace` around two requests (the tiles,
    then their first 5), and the two predictions."""
    embedder, milnet, tiles = serve_models
    log_dir = str(tmp_path_factory.mktemp("trace"))
    requests = (tiles, tiles[:5])
    with profiling.device_trace(log_dir):
        preds = [predict_tiles(t, embedder, milnet, embed_batch=EMBED_BATCH)
                 for t in requests]
    path, = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        return json.load(f)["traceEvents"], preds


def _spans(events, name):
    """[(start, end, request id)] of the span `name`, by start."""
    return sorted((e["ts"], e["ts"] + e["dur"],
                   e["args"]["Concrete Inputs"][0])
                  for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == name)


def _inside(outer, inner):
    return [i for i in inner if outer[0] <= i[0] and i[1] <= outer[1]]


def test_device_trace_without_a_dir_is_a_no_op(tmp_path):
    for log_dir in (None, ""):
        with profiling.device_trace(log_dir), profiling.annotate("stage"):
            assert not torch.autograd.profiler._is_profiler_enabled
            torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


def test_device_trace_writes_one_trace_as_the_jax_one_does(tmp_path):
    """Each writes one trace under a log_dir it makes; the port's is
    Chrome/Perfetto JSON holding the annotated span."""
    with jax_profiling.device_trace(str(tmp_path / "jax" / "run")):
        with jax_profiling.annotate("stage"):
            jnp.ones(4).sum().block_until_ready()
    with profiling.device_trace(str(tmp_path / "torch" / "run")):
        with profiling.annotate("stage"):
            torch.ones(4).sum()
    jax_traces = glob.glob(str(tmp_path / "jax" / "run" / "**" /
                               "*.xplane.pb"), recursive=True)
    traces = glob.glob(str(tmp_path / "torch" / "run" / "*"))
    assert len(jax_traces) == 1 and len(traces) == 1
    assert traces[0].endswith(".pt.trace.json")
    host, kernels = read_trace(traces[0], ("stage", "absent"))
    assert len(host["stage"]) == 1 and host["absent"] == [] and kernels == []


def test_traced_serve_request_holds_both_spans_and_the_same_scores(
        serve_models, tmp_path):
    """`traced_request` traces `predict_tiles`: the trace holds
    `serve.embed` then `serve.classify` once each, and the scores are the
    untraced call's bit for bit."""
    embedder, milnet, tiles = serve_models
    want = predict_tiles(tiles, embedder, milnet, embed_batch=EMBED_BATCH)
    pred, path = traced_request(tiles, embedder, milnet,
                                str(tmp_path / "trace"),
                                embed_batch=EMBED_BATCH)
    assert os.path.dirname(path) == str(tmp_path / "trace")
    np.testing.assert_array_equal(pred.instance_scores, want.instance_scores)
    assert pred.bag_score == want.bag_score
    host, kernels = read_trace(path, SPANS)
    assert [len(host[s]) for s in SPANS] == [1, 1]
    (e0, e1), (c0, c1) = host["serve.embed"][0], host["serve.classify"][0]
    assert e0 < e1 <= c0 < c1
    assert kernels == []                    # no device here


def test_spans_nest_by_call_one_upload_a_batch(two_traced_requests):
    """serve.request ⊃ serve.embed ⊃ ⌈n / embed_batch⌉ serve.upload, and
    serve.request ⊃ serve.classify ⊃ serve.milnet, for each request."""
    events, _ = two_traced_requests
    requests = _spans(events, "serve.request")
    assert len(requests) == 2
    for req, n in zip(requests, (10, 5)):
        embed, = _inside(req, _spans(events, "serve.embed"))
        classify, = _inside(req, _spans(events, "serve.classify"))
        assert embed[1] <= classify[0]
        uploads = _inside(embed, _spans(events, "serve.upload"))
        assert len(uploads) == math.ceil(n / EMBED_BATCH)
        assert len(_inside(classify, _spans(events, "serve.milnet"))) == 1


def test_no_slot_wait_on_the_cpu_route(two_traced_requests):
    """On the CPU no batch is staged, so serve.embed holds its
    ⌈n / embed_batch⌉ serve.upload spans and no serve.upload_wait (the
    staged batches' waits are `tests/test_torch_upload_card.py`'s)."""
    events, _ = two_traced_requests
    assert not _spans(events, "serve.upload_wait")
    for req, n in zip(_spans(events, "serve.request"), (10, 5)):
        embed, = _inside(req, _spans(events, "serve.embed"))
        uploads = _inside(embed, _spans(events, "serve.upload"))
        assert len(uploads) == math.ceil(n / EMBED_BATCH)


def test_spans_of_a_request_share_its_id(two_traced_requests):
    """Every span inside a request carries the request's id, and the two
    requests have two ids."""
    events, _ = two_traced_requests
    requests = _spans(events, "serve.request")
    inner = [s for name in ("serve.embed", "serve.upload", "serve.classify",
                            "serve.milnet") for s in _spans(events, name)]
    for req, n in zip(requests, (10, 5)):
        mine = _inside(req, inner)
        assert len(mine) == 3 + math.ceil(n / EMBED_BATCH)
        assert {s[2] for s in mine} == {req[2]}
    assert len({r[2] for r in requests}) == 2
    assert len(inner) == sum(len(_inside(r, inner)) for r in requests)


def test_every_op_of_a_traced_request_lies_in_its_span(serve_models,
                                                       two_traced_requests):
    """The trace puts each aten op inside a `serve.request`, and the traced
    requests score as the untraced ones, bit for bit."""
    embedder, milnet, tiles = serve_models
    events, preds = two_traced_requests
    requests = _spans(events, "serve.request")
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    assert ops
    assert all(any(r[0] <= a and b <= r[1] for r in requests)
               for a, b in ops)
    for pred, t in zip(preds, (tiles, tiles[:5])):
        want = predict_tiles(t, embedder, milnet, embed_batch=EMBED_BATCH)
        np.testing.assert_array_equal(pred.instance_scores,
                                      want.instance_scores)
        assert pred.bag_score == want.bag_score


def test_untraced_spans_add_host_seconds_only(serve_models, monkeypatch):
    """With no profiler recording, the serve path opens no profiler range
    and makes no CUDA event; `timings` carries upload_s and milnet_s, each
    within its stage's time, and no upload_stream_s."""
    embedder, milnet, tiles = serve_models

    def refuse(*args, **kwargs):
        raise AssertionError("entered with no profiler recording")

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    t = predict_tiles(tiles, embedder, milnet, embed_batch=EMBED_BATCH).timings
    assert 0.0 <= t["upload_s"] <= t["embed_s"]
    assert 0.0 <= t["milnet_s"] <= t["classify_s"]
    assert "upload_stream_s" not in t


def test_untraced_timings_count_the_slot_wait_and_no_staging(serve_models):
    """On the CPU `predict_tiles` stages no batch through the pinned ring
    (upload_staged 0) and reports the slot wait as 0, apart from upload_s
    and within embed_s."""
    embedder, milnet, tiles = serve_models
    t = predict_tiles(tiles, embedder, milnet, embed_batch=EMBED_BATCH).timings
    assert t["upload_staged"] == 0
    assert t["upload_wait_s"] == 0.0
    assert t["upload_wait_s"] + t["upload_s"] <= t["embed_s"]


def test_annotate_adds_under_the_names_last_part():
    """Host seconds accumulate under "<last part>_s"; a span given no
    dict adds nothing."""
    timings = {}
    for _ in range(3):
        with profiling.annotate("serve.upload", timings):
            pass
    with profiling.annotate("serve.classify"):
        pass
    assert list(timings) == ["upload_s"] and timings["upload_s"] >= 0.0


class _Event:
    def __init__(self, key, device_type, us, annotation=False):
        self.key, self.device_type, self.count = key, device_type, 5
        self.self_device_time_total = us
        self.is_user_annotation = annotation


def _stub_profiler(monkeypatch, events):
    """torch.profiler.profile replaced by a stub whose key_averages gives
    `events`; the card's synchronize by a no-op. Returns the calls."""
    calls = []

    class Profile:
        def __init__(self, activities):
            calls.append(activities)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return calls


@pytest.mark.parametrize("events", [
    [],
    [_Event("aten::mm", DeviceType.CPU, 0.0)],
    # a user annotation drawn on the device timeline is not device work
    [_Event("step", DeviceType.CUDA, 40.0, annotation=True)],
])
def test_device_profile_refuses_where_no_device_time_is_recorded(
        monkeypatch, events):
    calls = _stub_profiler(monkeypatch, events)
    fn_calls = []
    with pytest.raises(profiling.NoDeviceTime, match="no device time"):
        profiling.device_profile(lambda: fn_calls.append(1))
    assert len(calls) == 1 and len(fn_calls) == 1 + profiling.ITERS
    assert issubclass(profiling.NoDeviceTime, RuntimeError)
    assert profiling.traced(lambda: None) is None and len(calls) == 3


def test_device_profile_reads_the_kernels_per_call(monkeypatch):
    events = [_Event("aten::mm", DeviceType.CPU, 50.0),
              _Event("void dense_attention_wgmma_kernel<64>", DeviceType.CUDA,
                     30.0),
              _Event("Memcpy HtoD", DeviceType.CUDA, 20.0),
              _Event("step", DeviceType.CUDA, 90.0, annotation=True)]
    calls = _stub_profiler(monkeypatch, events)
    busy, ops, kernels = profiling.traced(lambda: None)
    assert len(calls) == 1 and profiling.ITERS == 5
    assert busy == pytest.approx(0.01)
    assert kernels == [("void dense_attention_wgmma_kernel<64>", 0.006),
                       ("Memcpy HtoD", 0.004)]
    assert ops == [("aten::mm", 0.01, 1.0)]
