"""Slide inference on the GPU: tiles → embeddings → bag score.

Port of `snuffy_tpu/pipeline/slide_inference.py` (the tile reader and the
per-tile path; the streaming, prefetch and scaled-decode path is not
ported yet). Tiles go to the device as uint8; the resize to the embed
size (when the tile size differs), the cast and the normalisation run
there. Embeddings fill one preallocated (bucket_length(n), D) f32 device
buffer, which is the padded bag the aggregator classifies; only the
scores come back to the host.

Timings: embed_s (upload + embed, synchronised), classify_s (aggregator
forward and the copy of the scores), total_s, n_patches; predict_slide
adds read_filter_s for the tile reader.
"""

from __future__ import annotations

import multiprocessing as mp
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from snuffy_tpu_torch.data.bucketing import bucket_length
from snuffy_tpu_torch.tiling.deepzoom import (
    TilerConfig,
    edge_energy,
    pick_read_level,
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
    import cv2

    slide = _reader_state["slide"]
    region = slide.read_region(level, col * read, row * read, read, read)
    if read != tile:
        region = cv2.resize(region, (tile, tile), interpolation=cv2.INTER_AREA)
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
    from snuffy_tpu_torch.native import NativeSlide

    with NativeSlide(slide_path) as slide:
        level, residual = pick_read_level(
            slide, cfg.objective_power / cfg.base_mag)
        read = int(round(cfg.tile_size * residual))
        lw, lh = slide.level_dimensions(level)
    cols, rows = lw // read, lh // read

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
    device = next(milnet.parameters()).device
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda *a: None))
    timings = {}
    t_start = time.perf_counter()
    tiles = torch.as_tensor(tiles)
    n = int(tiles.shape[0])
    if n == 0:
        # no tissue, no evidence: nothing to classify
        timings.update(embed_s=0.0, classify_s=0.0, n_patches=0,
                       total_s=time.perf_counter() - t_start)
        return SlidePrediction(0.0, np.zeros((0,), np.float32), [], timings)

    n_pad = bucket_length(n)
    bag = None
    for start in range(0, n, embed_batch):
        chunk = tiles[start:start + embed_batch].to(device, non_blocking=True)
        if chunk.shape[1] != embed_size or chunk.shape[2] != embed_size:
            chunk = device_resize(chunk, embed_size)
        feats, _ = embedder(chunk)
        if bag is None:
            bag = torch.zeros((n_pad, feats.shape[1]), dtype=torch.float32,
                              device=device)
        bag[start:start + feats.shape[0]] = feats
    sync()
    timings["embed_s"] = time.perf_counter() - t_start

    t0 = time.perf_counter()
    mask = torch.arange(n_pad, device=device) < n
    gen = torch.Generator(device).manual_seed(seed)
    ins_logits, bag_logits = milnet(bag, mask, generator=gen)
    ins_scores = torch.sigmoid(ins_logits[:n, 0]).cpu().numpy()
    bag_score = float(torch.sigmoid(bag_logits[0]))
    timings["classify_s"] = time.perf_counter() - t0
    timings["total_s"] = time.perf_counter() - t_start
    timings["n_patches"] = n
    return SlidePrediction(bag_score, ins_scores, [], timings)


def predict_slide(
    slide_path: str,
    embedder: torch.nn.Module,
    milnet: torch.nn.Module,
    tiler_cfg: Optional[TilerConfig] = None,
    embed_batch: int = 256,
    embed_size: int = 224,
    workers: int = 8,
    seed: int = 0,
) -> SlidePrediction:
    """WSI → tiles with the shared reader, then `predict_tiles`."""
    t0 = time.perf_counter()
    tiles, positions = read_slide_tiles(slide_path, tiler_cfg or TilerConfig(),
                                        workers)
    read_s = time.perf_counter() - t0
    pred = predict_tiles(torch.from_numpy(tiles), embedder, milnet,
                         embed_batch=embed_batch, embed_size=embed_size,
                         seed=seed)
    pred.timings["read_filter_s"] = read_s
    pred.timings["total_s"] += read_s
    pred.positions = positions
    return pred
