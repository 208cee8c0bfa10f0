"""The serve path's upload (`pipeline/slide_inference._Uploads`) on the CPU.

On the CPU every batch takes the plain route: `embed_bag` gives the bag a
batch-by-batch loop gives, bit for bit, at the tail sizes of a 256-tile
batch; nothing is staged and no slot is waited for. The uploaders are
kept one a thread and device. The ring's routes on the card are held by
`tests/test_torch_upload_card.py`.
"""

import threading

import pytest
import torch

from snuffy_tpu_torch.data.bucketing import bucket_length
from snuffy_tpu_torch.pipeline import slide_inference
from snuffy_tpu_torch.pipeline.slide_inference import embed_bag

EMBED_BATCH = 256
SIZES = (1, 255, 256, 257, 1075, 9306)
SIDE = 4
D = 8


class Linear(torch.nn.Module):
    """uint8 tiles (b, t, t, 3) → (a fixed linear map of their pixels,
    None), the embedder's interface; records each batch's row count."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.randn((SIDE * SIDE * 3, D), generator=g)
        self.rows = []

    def forward(self, x):
        self.rows.append(int(x.shape[0]))
        return x.float().flatten(1) @ self.w / 255.0, None


def batch_by_batch(tiles, embedder):
    """The bag as one batch at a time makes it, with no uploader."""
    n = int(tiles.shape[0])
    bag = torch.zeros((bucket_length(n), D))
    for start in range(0, n, EMBED_BATCH):
        feats, _ = embedder(tiles[start:start + EMBED_BATCH])
        bag[start:start + feats.shape[0]] = feats
    return bag


@pytest.fixture(scope="module")
def pool():
    g = torch.Generator().manual_seed(1)
    return torch.randint(0, 256, (max(SIZES) + 100, SIDE, SIDE, 3),
                         generator=g, dtype=torch.uint8)


@pytest.mark.parametrize("n", SIZES)
def test_embed_bag_on_the_cpu_is_the_batch_by_batch_bag(pool, n):
    """Two requests back to back (other tiles each) give the loop's bags
    bit for bit, one embedder call a batch; `timings` counts no staged
    batch and no slot wait, and carries the upload's host seconds."""
    embedder = Linear()
    for offset in (0, 100):
        tiles = pool[offset:offset + n]
        timings = {}
        embedder.rows.clear()
        bag = embed_bag(tiles, embedder, torch.device("cpu"),
                        embed_batch=EMBED_BATCH, embed_size=SIDE,
                        timings=timings)
        rows = list(embedder.rows)
        want = batch_by_batch(tiles, embedder)
        assert torch.equal(bag, want)
        assert bag.shape == (bucket_length(n), D)
        assert rows == [min(EMBED_BATCH, n - s)
                        for s in range(0, n, EMBED_BATCH)]
        assert timings["upload_staged"] == 0
        assert timings["upload_wait_s"] == 0.0
        assert timings["upload_s"] >= 0.0
        assert "upload_stream_s" not in timings


def test_embed_bag_without_timings_is_the_same_bag(pool):
    """With no `timings` (as the benchmark's warm-up calls it) the spans
    count nothing and the bag is the loop's."""
    embedder = Linear()
    bag = embed_bag(pool[:300], embedder, torch.device("cpu"),
                    embed_batch=EMBED_BATCH, embed_size=SIDE)
    assert torch.equal(bag, batch_by_batch(pool[:300], embedder))


def test_the_cpu_route_hands_the_batch_on_as_it_is(pool):
    """A CPU target takes the tiles themselves, no copy, and adds the
    seconds of the upload span alone: it waits for no slot."""
    up = slide_inference._uploader(torch.device("cpu"))
    timings = {}
    batch = pool[:EMBED_BATCH]
    for _ in range(3):
        assert up(batch, EMBED_BATCH, timings).data_ptr() == batch.data_ptr()
    assert set(timings) == {"upload_s"}
    assert up.host is None and up.dev is None


def test_uploaders_are_kept_a_thread_and_device():
    """The same thread and device find the same uploader whatever the
    batch shape; another thread makes its own."""
    cpu = torch.device("cpu")
    first = slide_inference._uploader(cpu)
    assert slide_inference._uploader(torch.device("cpu")) is first
    other = []
    thread = threading.Thread(
        target=lambda: other.append(slide_inference._uploader(cpu)))
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert len(other) == 1 and other[0] is not first
    assert isinstance(other[0], slide_inference._Uploads)

