"""The serve path's upload on the card (marked `cuda`; skipped without a
GPU). No JAX here, so the card's machine collects this file:

    python -m pytest --noconftest -m cuda -q \\
        -o "markers=cuda: needs a CUDA GPU" tests/test_torch_upload_card.py

`embed_bag` through the uploader (`pipeline/slide_inference._Uploads`)
gives the bag of a batch-by-batch synchronous upload bit for bit: at the
tail sizes of a 256-tile batch, for pageable, pinned and on-device tiles,
over two requests back to back with other tiles, and with an embedder that
spins on the card before each forward, which widens the window in which a
refilled pinned buffer or an overwritten device buffer would corrupt a
batch. Host tiles, pageable or pinned, are staged once a batch, tiles on
the card never; under a profiler the copies' stream time lies within
embed_s and each staged batch's slot wait lies before its upload span. A
larger batch replaces the uploader's buffers, a smaller one reuses them.
"""

import gc
import glob
import json
import math
import os
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.data.bucketing import bucket_length
from snuffy_tpu_torch.embed.registry import Embedder
from snuffy_tpu_torch.models.snuffy import build_milnet
from snuffy_tpu_torch.models.vit import VisionTransformer
from snuffy_tpu_torch.pipeline import slide_inference
from snuffy_tpu_torch.pipeline.slide_inference import embed_bag, predict_tiles
from snuffy_tpu_torch.utils import profiling

EMBED_BATCH = 256
SIZES = (1, 255, 256, 257, 1075, 9306)
SECOND = 694              # the second request's offset into the pool
POOL = max(SIZES) + SECOND
SPIN_CYCLES = 40_000_000  # about 20 ms of the card's clock, more than staging


class Spinning(torch.nn.Module):
    """The embedder behind a spin on the current stream before each
    forward: the forward reads its batch that much later."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        torch.cuda._sleep(SPIN_CYCLES)
        return self.inner(x)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def embedder(card):
    torch.manual_seed(0)
    vit = VisionTransformer(patch_size=16, embed_dim=64, depth=2, num_heads=2)
    return Embedder(vit, 64, 1).to(card).eval()


@pytest.fixture(scope="module")
def pools(card):
    """The same seeded uint8 224² tiles in pageable host memory, in pinned
    host memory and on the card."""
    gen = torch.Generator(card).manual_seed(3)
    on_card = torch.randint(0, 256, (POOL, 224, 224, 3), generator=gen,
                            device=card, dtype=torch.uint8)
    pageable = on_card.cpu()
    return {"pageable": pageable, "pinned": pageable.pin_memory(),
            "device": on_card}


@pytest.fixture(scope="module")
def references(card, embedder, pools):
    """The bag of each request as a synchronous upload makes it: each
    batch copied, the card synchronised, then embedded."""
    out = {}

    @torch.inference_mode()
    def reference(tiles):
        n = int(tiles.shape[0])
        bag = None
        for start in range(0, n, EMBED_BATCH):
            x = tiles[start:start + EMBED_BATCH].to(card)
            torch.cuda.synchronize(card)
            feats, _ = embedder(x)
            if bag is None:
                bag = torch.zeros((bucket_length(n), feats.shape[1]),
                                  dtype=torch.float32, device=card)
            bag[start:start + feats.shape[0]] = feats
        torch.cuda.synchronize(card)
        return bag

    def get(offset, n):
        if (offset, n) not in out:
            out[offset, n] = reference(pools["pageable"][offset:offset + n])
        return out[offset, n]

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("spin", [False, True], ids=["plain", "spinning"])
@pytest.mark.parametrize("route", ["pageable", "pinned", "device"])
@pytest.mark.parametrize("n", SIZES)
def test_embed_bag_is_the_synchronous_upload_bit_for_bit(
        card, embedder, pools, references, n, route, spin):
    """Two requests back to back, the second on other tiles, give each the
    synchronous upload's bag bit for bit; host tiles (pageable or pinned)
    are staged once a batch, on-device ones never."""
    model = Spinning(embedder) if spin else embedder
    bags, timings = [], []
    for offset in (0, SECOND):
        t = {}
        bags.append(embed_bag(pools[route][offset:offset + n], model, card,
                              embed_batch=EMBED_BATCH, timings=t))
        timings.append(t)
    for offset, bag, t in zip((0, SECOND), bags, timings):
        want = references(offset, n)
        assert bag.shape == want.shape
        assert torch.equal(bag, want), (
            f"{int((bag != want).any(dim=1).sum())} rows differ")
        staged = math.ceil(n / EMBED_BATCH) if route != "device" else 0
        assert t["upload_staged"] == staged
        assert t["upload_wait_s"] >= 0.0 and t["upload_s"] > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["pageable", "device"])
def test_copy_stream_time_within_embed_under_a_profiler(card, embedder,
                                                        pools, route):
    """A traced request of 1075 tiles: upload_stream_s (the copies alone)
    lies within embed_s; pageable tiles cross as pinned copies, staged
    once a batch."""
    cfg = SnuffyModelConfig(feats_size=64, num_classes=1, num_heads=2,
                            big_lambda=64, random_patch_share=0.5, depth=2,
                            activation="gelu")
    milnet = build_milnet(cfg, seed=0, device=card)
    tiles = pools[route][:1075]
    predict_tiles(tiles, embedder, milnet)          # builds and warms
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = predict_tiles(tiles, embedder, milnet).timings
    assert 0.0 <= t["upload_stream_s"] <= t["embed_s"]
    assert t["upload_wait_s"] + t["upload_s"] <= t["embed_s"]
    keys = [e.key for e in prof.key_averages()]
    if route == "pageable":
        assert t["upload_staged"] == 5
        assert t["upload_stream_s"] > 0.0
        assert any("HtoD" in k and "Pinned" in k for k in keys), keys
    else:
        assert t["upload_staged"] == 0


@pytest.mark.cuda
def test_one_slot_wait_a_staged_batch_in_embed_and_outside_upload(
        card, embedder, pools, tmp_path):
    """A traced request of 1075 pageable tiles: serve.embed ⊃ 5
    serve.upload_wait and 5 serve.upload, each wait ending before its
    batch's upload starts and after the previous batch's upload ends: no
    wait lies inside an upload."""
    tiles = pools["pageable"][:1075]
    embed_bag(tiles, embedder, card, embed_batch=EMBED_BATCH, timings={})
    with profiling.device_trace(str(tmp_path)):
        embed_bag(tiles, embedder, card, embed_batch=EMBED_BATCH, timings={})
    path, = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    def spans(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("cat") == "user_annotation"
                      and e.get("name") == name)

    embed, = spans("serve.embed")
    waits, uploads = spans("serve.upload_wait"), spans("serve.upload")
    assert len(waits) == len(uploads) == 5
    assert all(embed[0] <= s[0] and s[1] <= embed[1]
               for s in waits + uploads)
    for k, (wait, upload) in enumerate(zip(waits, uploads)):
        assert wait[1] <= upload[0]
        if k:
            assert uploads[k - 1][1] <= wait[0]


@pytest.mark.cuda
def test_a_larger_batch_replaces_the_buffers_a_smaller_one_reuses_them(card):
    """An uploader holds two pinned and two device buffers, of the largest
    batch it has staged: a batch of larger tiles frees the first ones, a
    smaller batch uses the larger ones' first bytes; every batch arrives
    bit for bit."""
    up = slide_inference._Uploads(card)
    gen = torch.Generator().manual_seed(5)

    def tiles(rows, side):
        return torch.randint(0, 256, (rows, side, side, 3), generator=gen,
                             dtype=torch.uint8)

    def check(batch, rows):
        out = up(batch, rows)
        torch.cuda.synchronize(card)
        assert torch.equal(out.cpu(), batch)

    for _ in range(3):
        check(tiles(8, 16), 8)
    first = [weakref.ref(b) for b in up.host + up.dev]
    assert up.dev[0].numel() == 8 * 16 * 16 * 3
    for _ in range(3):
        check(tiles(8, 32), 8)
    gc.collect()
    assert all(ref() is None for ref in first)
    assert len(up.host) == len(up.dev) == 2
    assert all(b.numel() == 8 * 32 * 32 * 3 for b in up.host + up.dev)
    kept = [b.data_ptr() for b in up.host + up.dev]
    for batch in (tiles(8, 16), tiles(3, 32), tiles(8, 16)):
        check(batch, 8)
    assert [b.data_ptr() for b in up.host + up.dev] == kept
