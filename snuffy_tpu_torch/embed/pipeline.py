"""Batched patch feature extraction: JPEG bags → per-bag CSV embeddings.

The port's copy of `snuffy_tpu/embed/pipeline.py` (the reference extraction
loop, reference compute_feats.py:66-266), with the standard library's `csv`
in place of pandas, and the port's libjpeg decoder (`native.decode_jpeg`)
and a numpy copy of PIL's bilinear resample in place of PIL:

  * bag = one directory of patch JPEGs named `{col}_{row}[-{level}].jpeg`;
  * patch labels looked up in the dataset-level tile_label.csv dict;
  * images resized to `img_size` and sent to the device as uint8, where the
    `Embedder` casts and normalises them;
  * one fixed `batch_size` per forward, the tail batch zero-padded;
  * per-bag CSV `[0..D−1, label, position]` + dataset CSV `[path, label]`,
    the MIL loader's schema, and `save_class_features`'s shuffled dataset
    CSV in the JAX package's row order.

`embed_tiles` is the device part alone (uint8 tiles → feats). Host decode
runs in a spawned process pool.

Several GPUs (`parallel/distributed.py`, one process a GPU): the ranks
take the bags by stride, each writes its own bags' CSVs, and the dataset
rows are gathered to every rank in the order one process gives them
(JAX `embed/pipeline.py:242-243`). The JAX package's local dp mesh over
a host's chips (`embed/pipeline.py:112-123`) has no counterpart: with one
rank a GPU, the stride is that split.
"""

from __future__ import annotations

import csv
import functools
import glob
import multiprocessing as mp
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from snuffy_tpu_torch.embed import registry

# The JAX module's float32 arrays, from registry's tuples.
IMAGENET_MEAN = np.asarray(registry.IMAGENET_MEAN, np.float32)
IMAGENET_STD = np.asarray(registry.IMAGENET_STD, np.float32)

_POSITION_RE = re.compile(r"(\d+)_(\d+)(?:-(\d+))?\.jpe?g$", re.IGNORECASE)


def parse_position(filename: str) -> Optional[str]:
    """`{col}_{row}[-{level}].jpeg` → 'col_row'."""
    m = _POSITION_RE.search(os.path.basename(filename))
    if not m:
        return None
    return f"{m.group(1)}_{m.group(2)}"


def load_patch_labels(tile_label_csv: str) -> Dict[str, int]:
    """slide/position → patch label dict from a headerless `key,label` CSV.
    Keys are '{slide}_{col}_{row}'."""
    labels: Dict[str, int] = {}
    with open(tile_label_csv, newline="") as f:
        for row in csv.reader(f):
            if not row:
                continue
            key, lab = row[0], int(float(row[1]))
            if key in labels and labels[key] != lab:
                raise ValueError(f"duplicate conflicting patch label for {key}")
            labels[key] = lab
    return labels


# PIL's fixed point for 8-bit resampling (Pillow's Resample.c).
_PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=None)
def _bilinear_taps(in_size: int, out_size: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(out, taps) source indices and integer weights of PIL's BILINEAR
    resample along one axis (precompute_coeffs and normalize_coeffs_8bpc):
    the triangle filter's support scales with the downscale factor, the
    weights are normalised in doubles, summed in order, and rounded to
    22-bit fixed point."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    index = np.zeros((out_size, ksize), np.int64)
    weight = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) / filterscale))
              for x in range(xmax)]
        total = 0.0
        for w in ws:
            total += w
        for x, w in enumerate(ws):
            w = w / total if total != 0.0 else w
            weight[xx, x] = int(0.5 + w * (1 << _PRECISION_BITS))
            index[xx, x] = x + xmin
        index[xx, xmax:] = xmin
    return index, weight


def _resample_axis(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass of PIL's 8-bit resample along `axis` (0 rows, 1 columns)
    of an (h, w, c) uint8 image: start at half a unit, add pixel × weight,
    keep the integer part and clip to [0, 255]."""
    index, weight = _bilinear_taps(img.shape[axis], out_size)
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    shape = (-1, 1, 1) if axis == 0 else (1, -1, 1)
    for t in range(index.shape[1]):
        taps = np.take(img, index[:, t], axis=axis).astype(np.int64)
        acc += taps * weight[:, t].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_bilinear_resize(img: np.ndarray, size: Tuple[int, int]
                        ) -> np.ndarray:
    """(h, w, 3) uint8 → (size[1], size[0], 3), the bytes of PIL's
    `Image.fromarray(img).resize(size, Image.BILINEAR)`: a horizontal pass
    to 8 bits, then a vertical one, each only where the size changes."""
    out_w, out_h = size
    if img.shape[1] != out_w:
        img = _resample_axis(img, 1, out_w)
    if img.shape[0] != out_h:
        img = _resample_axis(img, 0, out_h)
    return img


def _decode_one(args):
    """One patch JPEG → (size, size, 3) uint8, as PIL's
    `Image.open(path).convert("RGB")`, then `.resize((size, size),
    BILINEAR)` when its size differs."""
    from snuffy_tpu_torch import native

    path, size = args
    img = native.decode_jpeg(path, size_hint=size)
    if img.shape[:2] != (size, size):
        img = pil_bilinear_resize(img, (size, size))
    return img


def decode_batch(paths: Sequence[str], size: int, pool=None) -> np.ndarray:
    jobs = [(p, size) for p in paths]
    if pool is not None:
        imgs = pool.map(_decode_one, jobs)
    else:
        imgs = [_decode_one(j) for j in jobs]
    return np.stack(imgs)


def normalize_batch(batch: np.ndarray, imagenet: bool) -> np.ndarray:
    """Host-side normalization fallback; the embedders normalize on the
    device (`Embedder`), so batches normally stay uint8."""
    if imagenet:
        return (batch.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    return batch


def list_bags(dataset_path: str, fold: str) -> List[str]:
    """`<dataset>/single/<fold>/**/bag_dir` — every dir containing JPEGs."""
    root = os.path.join(dataset_path, "single", fold)
    bags = set()
    for ext in ("*.jpg", "*.jpeg"):
        for jpg in glob.glob(os.path.join(root, "**", ext), recursive=True):
            bags.add(os.path.dirname(jpg))
    return sorted(bags)


def _device(embedder: torch.nn.Module) -> torch.device:
    return next(embedder.parameters()).device


def embed_batch(embedder: torch.nn.Module, tiles, batch_size: int
                ) -> np.ndarray:
    """Up to `batch_size` uint8 tiles (m, H, W, 3), numpy or torch on any
    device → (m, D) f32 feats on the host. The batch is zero-padded to
    `batch_size`, so every forward has one shape."""
    tiles = torch.as_tensor(tiles)
    m = tiles.shape[0]
    if not 0 < m <= batch_size:
        raise ValueError(f"{m} tiles for a batch of {batch_size}")
    batch = tiles.to(_device(embedder), non_blocking=True)
    if m < batch_size:
        pad = batch.new_zeros((batch_size - m,) + tuple(batch.shape[1:]))
        batch = torch.cat([batch, pad])
    with torch.inference_mode():
        feats, _ = embedder(batch)
    return feats[:m].float().cpu().numpy()


def embed_tiles(embedder: torch.nn.Module, tiles, batch_size: int = 128
                ) -> np.ndarray:
    """All uint8 tiles (N, H, W, 3) of one bag → (N, D) f32 feats, in fixed
    batches of `batch_size`."""
    n = tiles.shape[0]
    out = [embed_batch(embedder, tiles[s:s + batch_size], batch_size)
           for s in range(0, n, batch_size)]
    return np.concatenate(out) if out else np.zeros((0, 0), np.float32)


def compute_bag_feats(
    embedder: torch.nn.Module,
    patch_paths: Sequence[str],
    batch_size: int = 128,
    img_size: int = 224,
    pool=None,
) -> np.ndarray:
    """All patches of one bag → (N, D) feats, decoding one batch at a time."""
    out = [embed_batch(embedder,
                       decode_batch(patch_paths[s:s + batch_size], img_size,
                                    pool),
                       batch_size)
           for s in range(0, len(patch_paths), batch_size)]
    return np.concatenate(out) if out else np.zeros((0, 0), np.float32)


def _write_rows(out_csv: str, header: List[str], rows) -> None:
    os.makedirs(os.path.dirname(out_csv), exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)


def write_bag_csv(
    out_csv: str,
    feats: np.ndarray,
    positions: Optional[List[str]] = None,
    labels: Optional[List[int]] = None,
):
    """Per-bag CSV with the loader's schema: columns 0..D−1 (each float32
    written as the shortest string that reads back to it, as pandas does),
    then `label` and `position` when both are given."""
    header = [str(i) for i in range(feats.shape[1])]
    cells = np.asarray(feats, np.float32).astype(str).tolist()
    if labels is not None and positions is not None:
        header += ["label", "position"]
        cells = [row + [int(lab), pos]
                 for row, lab, pos in zip(cells, labels, positions)]
    _write_rows(out_csv, header, cells)


def write_dataset_csv(out_csv: str, rows: List[Tuple[str, int]]):
    """Dataset-level `[path, label]` CSV (header `0,1`)."""
    _write_rows(out_csv, ["0", "1"], rows)


def shuffle_order(n: int, seed: int) -> np.ndarray:
    """The row order of pandas' `sample(frac=1.0, random_state=seed)`:
    `RandomState(seed).choice(n, n, replace=False)`."""
    return np.random.RandomState(seed).choice(n, size=n, replace=False)


def save_class_features(out_dir: str, dataset_csv_name: str,
                        droped: int = 0, seed: int = 0
                        ) -> Optional[List[Tuple[str, int]]]:
    """The reference's artifact tree (reference compute_feats.py:548-587):

      * one `[bag_path, label]` CSV per (split, class) at
        `<out_dir>/<split>/<class>.csv`, class numbers from the globally
        sorted class-name list;
      * the seeded-shuffled dataset CSV at `<out_dir>/<dataset>.csv`, in
        the row order of the JAX package's pandas shuffle;
      * `droped != 0` writes nothing.

    Returns the shuffled (path, label) rows, or None when gated off or when
    no split/class layout exists under out_dir."""
    if droped != 0:
        return None
    split_class_dirs = sorted(
        glob.glob(os.path.join(out_dir, "*", "*" + os.sep))
    )
    split_class_dirs = [d for d in split_class_dirs if os.path.isdir(d)]
    if not split_class_dirs:
        return None
    classes = sorted(
        {d.rstrip(os.sep).split(os.sep)[-1] for d in split_class_dirs}
    )
    rows: List[Tuple[str, int]] = []
    for d in split_class_dirs:
        bag_csvs = sorted(glob.glob(os.path.join(d, "*.csv")))
        split_name, class_name = d.rstrip(os.sep).split(os.sep)[-2:]
        label = classes.index(class_name)
        class_rows = [(p, label) for p in bag_csvs]
        _write_rows(os.path.join(out_dir, split_name, class_name + ".csv"),
                    ["0", "label"], class_rows)
        rows += class_rows
    rows = [rows[i] for i in shuffle_order(len(rows), seed)]
    _write_rows(os.path.join(out_dir, dataset_csv_name), ["0", "label"], rows)
    return rows


def extract_dataset(
    embedder: torch.nn.Module,
    dataset_path: str,
    fold: str,
    out_dir: str,
    class_labels: Optional[Dict[str, int]] = None,
    tile_label_csv: Optional[str] = None,
    batch_size: int = 128,
    img_size: int = 224,
    num_workers: int = 0,
) -> List[Tuple[str, int]]:
    """Every bag under `<dataset>/single/<fold>` → one CSV under out_dir.
    Returns the dataset rows (bag CSV path, class). Over several ranks,
    rank r embeds bags r, r + W, ... and every rank returns every row;
    the gather waits for the slowest rank."""
    from snuffy_tpu_torch.parallel import distributed

    patch_labels = (load_patch_labels(tile_label_csv) if tile_label_csv
                    else None)
    pool = (mp.get_context("spawn").Pool(num_workers) if num_workers > 0
            else None)
    world, rank = distributed.world_size(), distributed.rank()
    rows: List[Tuple[int, str, int]] = []
    try:
        for index, bag_dir in enumerate(list_bags(dataset_path, fold)):
            if index % world != rank:
                continue
            patch_paths = sorted(
                glob.glob(os.path.join(bag_dir, "*.jpg"))
                + glob.glob(os.path.join(bag_dir, "*.jpeg"))
            )
            if not patch_paths:
                continue
            feats = compute_bag_feats(embedder, patch_paths, batch_size,
                                      img_size, pool)
            slide = os.path.basename(bag_dir)
            # <out_dir>/<split>/<class>/<slide>.csv: the fold dir is
            # stripped (reference compute_feats.py:262-266).
            rel = os.path.relpath(
                bag_dir, os.path.join(dataset_path, "single", fold)
            )
            out_csv = os.path.join(out_dir, rel + ".csv")
            positions = [parse_position(p) or "" for p in patch_paths]
            labels = None
            if patch_labels is not None:
                labels = [
                    patch_labels.get(f"{slide}_{pos}", 0) for pos in positions
                ]
            write_bag_csv(out_csv, feats, positions, labels)
            cls = 0
            if class_labels:
                cls_dir = os.path.basename(os.path.dirname(bag_dir))
                cls = class_labels.get(cls_dir, 0)
            rows.append((index, out_csv, cls))
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    gathered = sorted(r for part in distributed.host_allgather(rows)
                      for r in part)
    return [(out_csv, cls) for _, out_csv, cls in gathered]
