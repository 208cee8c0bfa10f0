"""Slide inference on the GPU: slide → tiles → embeddings → bag score.

Port of `snuffy_tpu/pipeline/slide_inference.py`. `predict_slide` takes
the streaming path whenever the tile grid of the read level is aligned
with the tile size (no residual resize), as the JAX one does with its
native reader:

  * the C reader decodes a block of grid rows per call and computes each
    tile's edge energy there (`NativeSlide.read_grid`), or, for a JPEG-
    tiled level whose embed/tile ratio is M/8, decodes straight at the
    embed size through libjpeg's scaled IDCT (`read_grid_scaled`);
  * a one-block prefetch thread reads block i+1 while block i uploads and
    embeds (the ctypes call releases the GIL);
  * kept tiles go up in full `embed_batch` batches through the uploader
    `embed_bag` uses (`_Uploads`: staged through its pinned ring, copied
    on its copy stream);
  * embeddings land in one preallocated f32 device buffer of
    bucket_length(cols·rows) + embed_batch rows, the padded bag the
    aggregator classifies (the grid's bucket, as in JAX, not the kept
    count's); only the scores come back.

Otherwise (a residual resize) it reads tile by tile in a process pool
(`read_slide_tiles`) and classifies with `predict_tiles`. Tiles go to the
device as uint8; the resize to the embed size (when the tile size differs
and the scaled decode does not apply), the cast and the normalisation run
there.

The upload (`_Uploads`) takes its route from where a batch lies: host
tiles bound for the card are staged through a ring of two pinned buffers
and copied on a copy stream of their own, so that batch i+1 is staged and
copied while batch i embeds; tiles on the device are used as they are,
and on the CPU nothing changes. Events alone guard the ring, never a
synchronise of the device.

Timings of `predict_slide`, with the JAX meanings: read_filter_s (wall
time blocked on the reader), read_decode_s (the reader's own time,
streaming path), embed_s (streaming: the synchronised tail after the last
batch was dispatched; per tile: the whole embed), classify_s, total_s,
n_patches, and decode_path (`grid_jpeg_scaled`, `grid` or `per_tile`).
`predict_tiles` runs `embed_bag` then `classify_bag` and reports embed_s
(upload + embed, synchronised), classify_s, total_s and n_patches, and,
from the spans inside them (`utils/profiling.annotate`), upload_s (the
host's seconds staging and enqueueing each batch's upload), upload_wait_s
(the host's seconds waiting for a ring slot), upload_staged (the batches
staged through the pinned ring) and milnet_s (the MILNet forward's
dispatch, before its scores are fetched to the host) and forward_s (the
host's seconds dispatching the embedder's forward, a batch at a time);
while a profiler records on a CUDA device, upload_stream_s (the seconds of
the copies alone, on the stream that ran them) and forward_stream_s (the
forwards alone, on the compute stream). Under a profiler its spans
`serve.request` ⊃ `serve.embed` ⊃ `serve.upload`, `serve.forward` (one
each a batch, the upload after the batch's `serve.upload_wait` where it
is staged) and `serve.request` ⊃ `serve.classify` ⊃ `serve.milnet` carry
the call's request id.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from snuffy_tpu_torch.data.bucketing import bucket_length
from snuffy_tpu_torch.tiling.deepzoom import (
    TilerConfig,
    area_resize,
    edge_energy,
    pick_read_level,
)
from snuffy_tpu_torch.utils.profiling import (
    annotate,
    stream_edges,
    stream_seconds,
)


@dataclass
class SlidePrediction:
    bag_score: float
    instance_scores: np.ndarray       # (N,)
    positions: List[Tuple[int, int]]  # (col, row) per kept tile
    timings: dict


# The slide handle of a reader process (set by its pool initializer).
_reader_state: dict = {}


def _init_reader(slide_path):
    from snuffy_tpu_torch.native import NativeSlide

    _reader_state["slide"] = NativeSlide(slide_path)


def _read_tile(args):
    col, row, level, read, tile, threshold = args
    slide = _reader_state["slide"]
    region = slide.read_region(level, col * read, row * read, read, read)
    if read != tile:
        region = area_resize(region, tile)
    if edge_energy(region) <= threshold:
        return None
    return col, row, region


def read_slide_tiles(
    slide_path: str,
    cfg: TilerConfig,
    workers: int = 8,
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """WSI → (kept tiles (N, t, t, 3) uint8, their (col, row) positions).

    Port of `snuffy_tpu/pipeline/slide_inference.py:31-95`: a process
    pool of `workers` readers, each with its own slide handle, reads the
    tile grid of the chosen level and drops background tiles."""
    slide, level, read, cols, rows = _grid_geometry(slide_path, cfg)
    slide.close()
    jobs = [
        (c, r, level, read, cfg.tile_size, cfg.background_threshold)
        for r in range(rows)
        for c in range(cols)
    ]
    if workers > 1:
        with mp.get_context("spawn").Pool(
                workers, initializer=_init_reader,
                initargs=(slide_path,)) as pool:
            results = pool.map(_read_tile, jobs)
    else:
        _init_reader(slide_path)
        try:
            results = [_read_tile(j) for j in jobs]
        finally:
            _reader_state.pop("slide").close()
    kept = [r for r in results if r is not None]
    if not kept:
        return np.zeros((0, cfg.tile_size, cfg.tile_size, 3), np.uint8), []
    positions = [(c, r) for c, r, _ in kept]
    tiles = np.stack([t for _, _, t in kept])
    return tiles, positions


def _linear_resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(out, in) weights of `jax.image.resize(..., "linear", antialias=True)`
    along one axis (jax/_src/image/scale.py compute_weight_mat), in f32."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32) + 0.5)
                * inv_scale - 0.5)
    x = (sample_f[None, :]
         - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = (1.0 - x / kernel_scale).clamp_min(0.0)            # triangle kernel
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T


def device_resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 (B, t, t, 3) → f32 (B, size, size, 3) in [0, 1], the JAX
    `_wrap_device_resize` prologue (linear, antialiased)."""
    imf = images.float() / 255.0
    wh = _linear_resize_weights(imf.shape[1], size).to(imf.device)
    ww = _linear_resize_weights(imf.shape[2], size).to(imf.device)
    return torch.einsum("oh,bhwc,pw->bopc", wh, imf, ww)


@torch.inference_mode()
def embed_bag(
    tiles: torch.Tensor,           # (n, t, t, 3) uint8, n ≥ 1, any device
    embedder: torch.nn.Module,     # images → (feats, logits)
    device: torch.device,
    *,
    embed_batch: int = 256,
    embed_size: int = 224,
    timings: Optional[dict] = None,
) -> torch.Tensor:
    """The tiles' features in batches of `embed_batch` on `device`, into
    the padded f32 bag (bucket_length(n), d) whose rows past n are zero;
    returns once the device has finished them.

    Each batch goes up through the thread's uploader for `device`
    (`_Uploads`): host tiles bound for the card are staged through its
    pinned ring and copied on its copy stream while the previous batch
    embeds, tiles on the device are used as they are. Where `timings` is
    given it adds upload_s (the host's seconds staging and enqueueing),
    upload_wait_s (the host's seconds waiting for a ring slot: 0 unless
    staged), upload_staged (the batches staged through the ring: 0 on the
    CPU and for tiles on the device), forward_s (the host's seconds in the
    embedder's calls, span `serve.forward`) and, under a profiler on the
    card, upload_stream_s (the copies alone, on the stream that ran them)
    and forward_stream_s (the forwards alone, on the compute stream)."""
    with annotate("serve.embed"):
        n = int(tiles.shape[0])
        upload = _uploader(device)
        on_card = timings is not None and device.type == "cuda"
        edges = [] if on_card else None
        forward_edges = [] if on_card else None
        if timings is not None:
            timings.setdefault("upload_staged", 0)
            timings.setdefault("upload_wait_s", 0.0)
        bag = None
        for start in range(0, n, embed_batch):
            chunk = upload(tiles[start:start + embed_batch], embed_batch,
                           timings, edges)
            if chunk.shape[1] != embed_size or chunk.shape[2] != embed_size:
                chunk = device_resize(chunk, embed_size)
            with annotate("serve.forward", timings), \
                    stream_edges(forward_edges):
                feats, _ = embedder(chunk)
            if bag is None:
                bag = torch.zeros((bucket_length(n), feats.shape[1]),
                                  dtype=torch.float32, device=device)
            bag[start:start + feats.shape[0]] = feats
        if device.type == "cuda":
            torch.cuda.synchronize()
        if edges:
            timings["upload_stream_s"] = stream_seconds(edges)
        if forward_edges:
            timings["forward_stream_s"] = stream_seconds(forward_edges)
    return bag


@torch.inference_mode()
def classify_bag(
    bag: torch.Tensor,             # (n_pad, d) f32, the first n rows valid
    n: int,
    milnet: torch.nn.Module,       # (feats, mask, generator=…) → logits
    seed: int = 0,
    timings: Optional[dict] = None,
) -> Tuple[np.ndarray, float]:
    """The bag's (instance scores (n,), bag score), the random share drawn
    from a generator seeded with `seed` on the bag's device. Adds
    milnet_s to `timings` where given."""
    with annotate("serve.classify"):
        mask = torch.arange(bag.shape[0], device=bag.device) < n
        gen = torch.Generator(bag.device).manual_seed(seed)
        with annotate("serve.milnet", timings):
            ins_logits, bag_logits = milnet(bag, mask, generator=gen)
        return (torch.sigmoid(ins_logits[:n, 0]).cpu().numpy(),
                float(torch.sigmoid(bag_logits[0])))


@torch.inference_mode()
def predict_tiles(
    tiles: torch.Tensor,           # (n, t, t, 3) uint8, any device
    embedder: torch.nn.Module,     # images → (feats, logits)
    milnet: torch.nn.Module,       # (feats, mask, generator=…) → logits
    *,
    embed_batch: int = 256,
    embed_size: int = 224,
    seed: int = 0,
) -> SlidePrediction:
    """Embed and classify one bag of tiles on the models' device."""
    with annotate("serve.request", request=True):
        device = next(milnet.parameters()).device
        timings = {}
        t_start = time.perf_counter()
        tiles = torch.as_tensor(tiles)
        n = int(tiles.shape[0])
        if n == 0:
            # no tissue, no evidence: nothing to classify
            timings.update(embed_s=0.0, classify_s=0.0, n_patches=0,
                           total_s=time.perf_counter() - t_start)
            return SlidePrediction(0.0, np.zeros((0,), np.float32), [],
                                   timings)

        bag = embed_bag(tiles, embedder, device, embed_batch=embed_batch,
                        embed_size=embed_size, timings=timings)
        timings["embed_s"] = time.perf_counter() - t_start

        t0 = time.perf_counter()
        ins_scores, bag_score = classify_bag(bag, n, milnet, seed, timings)
        timings["classify_s"] = time.perf_counter() - t0
        timings["total_s"] = time.perf_counter() - t_start
        timings["n_patches"] = n
        return SlidePrediction(bag_score, ins_scores, [], timings)


def _grid_geometry(slide_path: str, cfg: TilerConfig):
    """(open slide, read level, read side, grid cols, grid rows)."""
    from snuffy_tpu_torch.native import NativeSlide

    slide = NativeSlide(slide_path)
    level, residual = pick_read_level(
        slide, cfg.objective_power / cfg.base_mag)
    read = int(round(cfg.tile_size * residual))
    lw, lh = slide.level_dimensions(level)
    return slide, level, read, lw // read, lh // read


class _Uploads:
    """uint8 tile batches → `device`, by a route taken from where each
    batch lies:

      * host memory, bound for the card: the host copies the batch into
        the next of a ring of two pinned buffers (staging), and a copy
        stream of the uploader's own copies that into the matching one of
        two device buffers;
      * anything else (tiles already on the card, the CPU as target, a
        batch that is not uint8): `.to(device)`, which leaves tiles on
        their device as they are.

    The caller's stream (the current one at each call) waits for a copy by
    an event before it reads the device buffer. Two events a slot guard
    the ring, and nothing synchronises the device: the host refills a
    pinned buffer only after the event behind the buffer's last copy has
    passed (that wait is the span `serve.upload_wait`, before and outside
    `serve.upload`), and the copy stream overwrites a device buffer only
    after an event that each call records on the caller's stream first,
    behind the work enqueued since the previous call: the forward that
    read the previous batch. The buffers hold `rows` tiles of the batch's
    shape; they are allocated at their first use and kept, and replaced
    by larger ones when a batch of more rows or larger tiles comes, so an
    uploader holds two of each, of the largest batch it has staged; a
    smaller batch uses their first bytes. `_uploader` keeps one uploader a
    thread and device.

    A call adds to `timings`, where given: the spans' upload_wait_s and
    upload_s, and upload_staged, one a staged batch. Under a profiler,
    `edges` (a list, for the card) takes the CUDA event pair of the copy
    alone, recorded on the stream that runs it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host = self.dev = None     # two flat uint8 buffers each
        if device.type == "cuda":
            self.copy_stream = torch.cuda.Stream(device)
            self.copied = [torch.cuda.Event(), torch.cuda.Event()]
            self.consumed = [torch.cuda.Event(), torch.cuda.Event()]
        self.turn = 0
        self.held = None    # the slot whose batch the caller last received

    def __call__(self, batch: torch.Tensor, rows: int,
                 timings: Optional[dict] = None,
                 edges: Optional[list] = None) -> torch.Tensor:
        if not (self.device.type == "cuda" and batch.device.type == "cpu"
                and batch.dtype == torch.uint8):
            with annotate("serve.upload", timings), stream_edges(edges):
                return batch.to(self.device, non_blocking=True)
        slot = self.turn
        compute = torch.cuda.current_stream(self.device)
        if self.held is not None:
            self.consumed[self.held].record(compute)
            self.held = None
        with annotate("serve.upload_wait", timings):
            self.copied[slot].synchronize()
        with annotate("serve.upload", timings):
            size = batch.numel()
            need = max(size, rows * math.prod(batch.shape[1:]))
            if self.dev is None or self.dev[0].numel() < need:
                self._allocate(need, compute)
            src = self.host[slot][:size].view(batch.shape)
            src.copy_(batch)
            out = self.dev[slot][:size].view(batch.shape)
            with torch.cuda.stream(self.copy_stream):
                self.copy_stream.wait_event(self.consumed[slot])
                with stream_edges(edges):
                    out.copy_(src, non_blocking=True)
                self.copied[slot].record(self.copy_stream)
            compute.wait_event(self.copied[slot])
            if timings is not None:
                timings["upload_staged"] = timings.get("upload_staged", 0) + 1
            self.turn ^= 1
            self.held = slot
            return out

    def _allocate(self, size: int, compute: torch.cuda.Stream) -> None:
        # The old buffers go safely: the pinned ones' copies were recorded
        # with the host allocator, the device ones belong to `compute`,
        # whose reads of them come first. The new device buffers may reuse
        # blocks that work on `compute` still reads: the copy stream waits
        # for it before its first write.
        self.host = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        self.dev = [torch.empty(size, dtype=torch.uint8, device=self.device)
                    for _ in range(2)]
        self.copy_stream.wait_stream(compute)


_UPLOADERS = threading.local()


def _uploader(device: torch.device) -> _Uploads:
    """The calling thread's uploader of batches to `device`, made at its
    first use and kept (a thread of its own each: two threads on one ring
    would refill each other's slots)."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    kept = _UPLOADERS.__dict__.setdefault("kept", {})
    if device not in kept:
        kept[device] = _Uploads(device)
    return kept[device]


@torch.inference_mode()
def predict_slide(
    slide_path: str,
    embedder: torch.nn.Module,
    milnet: torch.nn.Module,
    tiler_cfg: Optional[TilerConfig] = None,
    embed_batch: int = 256,
    embed_size: int = 224,
    workers: int = 8,
    seed: int = 0,
    prefetch: Optional[bool] = None,
    scaled_decode: Optional[bool] = None,
) -> SlidePrediction:
    """One slide → bag and instance scores on the models' device.

    The streaming path when the read level's grid is aligned with the tile
    size, else the per-tile path (module docstring). `prefetch` None or
    True reads the next block in a thread; `scaled_decode` None or True
    takes the M/8 scaled JPEG decode where the level allows it, False
    always decodes at the tile size (and resizes on the device). A reader
    that does not build, or a slide that does not open, raises."""
    cfg = tiler_cfg or TilerConfig()
    t_start = time.perf_counter()
    slide, level, read, cols, rows = _grid_geometry(slide_path, cfg)
    if read != cfg.tile_size:
        slide.close()
        t0 = time.perf_counter()
        tiles, positions = read_slide_tiles(slide_path, cfg, workers)
        read_s = time.perf_counter() - t0
        pred = predict_tiles(torch.from_numpy(tiles), embedder, milnet,
                             embed_batch=embed_batch, embed_size=embed_size,
                             seed=seed)
        pred.timings.update(read_filter_s=read_s, decode_path="per_tile",
                            total_s=time.perf_counter() - t_start)
        pred.positions = positions
        return pred
    try:
        scaled = (cfg.tile_size != embed_size and scaled_decode is not False
                  and slide.scaled_grid_ok(level, read, embed_size))
        return _stream(slide, level, read, cols, rows, embedder, milnet, cfg,
                       embed_batch, embed_size, seed,
                       prefetch is not False, scaled, t_start)
    finally:
        slide.close()


def _stream(slide, level, read, cols, rows, embedder, milnet, cfg,
            embed_batch, embed_size, seed, prefetch, scaled, t_start
            ) -> SlidePrediction:
    """The streaming path of `predict_slide` (JAX slide_inference.py
    :189-342) on an open slide."""
    device = next(milnet.parameters()).device
    side = embed_size if scaled else read
    upload = _uploader(device)
    block_rows = max(1, -(-embed_batch // max(cols, 1)))
    starts = list(range(0, rows, block_rows)) if cols else []
    n_pad = bucket_length(cols * rows)
    bag = None
    n_done = 0
    t_decode = 0.0

    def read_block(r0):
        nonlocal t_decode
        nb = min(block_rows, rows - r0)
        t0 = time.perf_counter()
        if scaled:
            out = slide.read_grid_scaled(level, read, cols, nb, r0,
                                         embed_size)
        else:
            out = slide.read_grid(level, read, cols, nb, r0)
        t_decode += time.perf_counter() - t0
        return out

    def dispatch(batch: np.ndarray, count: int):
        # Rows past `count` hold the padding tiles' features; the next
        # batch overwrites them or the mask leaves them out.
        nonlocal bag, n_done
        x = upload(torch.from_numpy(batch), embed_batch)
        if x.shape[1] != embed_size or x.shape[2] != embed_size:
            x = device_resize(x, embed_size)
        feats, _ = embedder(x)
        if bag is None:
            bag = torch.zeros((n_pad + embed_batch, feats.shape[1]),
                              dtype=torch.float32, device=device)
        bag[n_done:n_done + embed_batch] = feats
        n_done += count

    positions: List[Tuple[int, int]] = []
    carry: List[np.ndarray] = []
    n_carry = 0
    t_read = 0.0
    pool = ThreadPoolExecutor(max_workers=1) if prefetch else None
    try:
        future = pool.submit(read_block, starts[0]) if pool and starts else None
        for i, r0 in enumerate(starts):
            t0 = time.perf_counter()
            tiles, energy = future.result() if pool else read_block(r0)
            t_read += time.perf_counter() - t0
            if pool and i + 1 < len(starts):
                future = pool.submit(read_block, starts[i + 1])
            idx = np.nonzero(energy > cfg.background_threshold)[0]
            positions.extend((int(j % cols), int(r0 + j // cols))
                             for j in idx)
            if idx.size:
                carry.append(tiles[idx])
                n_carry += idx.size
            while n_carry >= embed_batch:
                buf = np.concatenate(carry) if len(carry) > 1 else carry[0]
                dispatch(buf[:embed_batch], embed_batch)
                rest = buf[embed_batch:]
                carry = [rest] if len(rest) else []
                n_carry = len(rest)
    finally:
        if pool:
            pool.shutdown(wait=True)
    if n_carry:
        buf = np.concatenate(carry) if len(carry) > 1 else carry[0]
        pad = np.zeros((embed_batch - n_carry,) + buf.shape[1:], np.uint8)
        dispatch(np.concatenate([buf, pad]), n_carry)
    timings = dict(read_filter_s=t_read, read_decode_s=t_decode,
                   decode_path="grid_jpeg_scaled" if scaled else "grid")
    n = n_done
    if n == 0:
        # no tissue, no evidence: nothing to classify
        timings.update(embed_s=0.0, classify_s=0.0, n_patches=0,
                       total_s=time.perf_counter() - t_start)
        return SlidePrediction(0.0, np.zeros((0,), np.float32), [], timings)

    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda *a: None))
    t0 = time.perf_counter()
    sync()
    timings["embed_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ins_scores, bag_score = classify_bag(bag[:n_pad], n, milnet, seed)
    timings["classify_s"] = time.perf_counter() - t0
    timings["total_s"] = time.perf_counter() - t_start
    timings["n_patches"] = n
    return SlidePrediction(bag_score, ins_scores, positions, timings)
