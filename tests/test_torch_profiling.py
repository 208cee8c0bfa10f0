"""The port's `utils/profiling` against `snuffy_tpu/utils/profiling.py`.

`device_trace` writes one trace where the JAX one writes one; a small serve
request traced with the spans "embed" and "classify" (the card's phase 17
of chip_smoke.py, on the CPU) holds both spans and gives the scores of the
same request outside the trace, bit for bit; `device_profile` refuses a
trace without device time (a stubbed profiler: there is no card here).
"""

import glob
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

SPANS = ("embed", "classify")


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


def test_traced_serve_request_holds_both_spans_and_the_same_scores(tmp_path):
    """8 tiles of 240² (resized to 224²) in two embed batches through a
    2-layer ViT and a MILNet of d=32 at ρ=0.5 (the random share drawn from
    the request's seeded generator)."""
    torch.manual_seed(0)
    vit = VisionTransformer(patch_size=16, embed_dim=32, depth=2, num_heads=2)
    embedder = Embedder(vit, 32, 1).eval()
    cfg = SnuffyModelConfig(feats_size=32, num_classes=1, num_heads=2,
                            big_lambda=8, random_patch_share=0.5, depth=2,
                            activation="gelu")
    milnet = build_milnet(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tiles = torch.from_numpy(
        rng.integers(0, 256, (8, 240, 240, 3)).astype(np.uint8))

    want = predict_tiles(tiles, embedder, milnet, embed_batch=4)
    ins, bag, path = traced_request(tiles, embedder, milnet,
                                    str(tmp_path / "trace"), embed_batch=4)
    assert os.path.dirname(path) == str(tmp_path / "trace")
    np.testing.assert_array_equal(ins, want.instance_scores)
    assert bag == want.bag_score
    host, kernels = read_trace(path, SPANS)
    assert [len(host[s]) for s in SPANS] == [1, 1]
    (e0, e1), (c0, c1) = host["embed"][0], host["classify"][0]
    assert e0 < e1 <= c0 < c1
    assert kernels == []                    # no device here


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
