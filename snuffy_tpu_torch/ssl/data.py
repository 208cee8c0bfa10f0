"""Host-side image streaming for SSL pretraining.

The port's `snuffy_tpu/ssl/data.py`: the host decodes an ImageFolder's
images into fixed-size uint8 batches and every augmentation runs on the
device (`ssl/augment.py`), in place of the reference's torchvision
ImageFolder + DataLoader (reference mae_adapter/main_pretrain_adapter.py:
154-193).

Decoding needs no PIL: JPEGs go through the port's libjpeg decoder
(`native.decode_jpeg`, PIL's `convert("RGB")` pixels), PNGs through the
zlib reader of `viz/png.py` (8-bit gray, RGB or RGBA, any row filter;
gray replicated and alpha dropped as `convert("RGB")` does; any other PNG
raises ValueError naming the file), and a size that differs from
`img_size` through the numpy copy of PIL's BILINEAR resize
(`embed.pipeline.pil_bilinear_resize`). So a batch equals the JAX
`_decode`'s bit for bit. The decode runs in a thread pool: the libjpeg
call releases the GIL.
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np

from snuffy_tpu_torch.embed.pipeline import pil_bilinear_resize


def list_image_folder(root: str) -> Tuple[List[str], List[int]]:
    """ImageFolder contract: root/<class>/**/*.{jpg,jpeg,png} → (paths,
    class indices), classes and files in sorted order."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    paths, labels = [], []
    for i, c in enumerate(classes):
        for ext in ("*.jpg", "*.jpeg", "*.png"):
            for p in sorted(glob.glob(os.path.join(root, c, "**", ext),
                                      recursive=True)):
                paths.append(p)
                labels.append(i)
    return paths, labels


def read_rgb(path: str, size_hint: int = 256) -> np.ndarray:
    """An image file → (H, W, 3) uint8, as PIL's
    `Image.open(path).convert("RGB")`."""
    if path.lower().endswith(".png"):
        from snuffy_tpu_torch.viz.png import read_png

        try:
            img = read_png(path)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        if img.ndim == 2:
            return np.repeat(img[..., None], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])
    from snuffy_tpu_torch import native

    return native.decode_jpeg(path, size_hint=size_hint)


def decode(path: str, size: int) -> np.ndarray:
    """One image → (size, size, 3) uint8: the JAX `_decode` (PIL
    `convert("RGB")`, then `resize((size, size), BILINEAR)` when its size
    differs)."""
    img = read_rgb(path, size)
    if img.shape[:2] != (size, size):
        img = pil_bilinear_resize(img, (size, size))
    return img


class ImageBatcher:
    """Shuffled fixed-size uint8 batches (B, S, S, 3); an epoch drops its
    tail like DataLoader(drop_last=True). The order is the JAX one:
    `np.random.default_rng(seed)`'s permutation, a new one each epoch.
    `num_workers` > 0 decodes in that many threads."""

    def __init__(self, paths: List[str], batch_size: int, img_size: int,
                 num_workers: int = 0, seed: int = 0):
        self.paths = paths
        self.batch_size = batch_size
        self.img_size = img_size
        self.rng = np.random.default_rng(seed)
        self.pool = (ThreadPoolExecutor(num_workers) if num_workers > 0
                     else None)

    def __len__(self):
        return len(self.paths) // self.batch_size

    def decode_batch(self, paths: List[str]) -> np.ndarray:
        size = self.img_size
        if self.pool is not None:
            imgs = list(self.pool.map(lambda p: decode(p, size), paths))
        else:
            imgs = [decode(p, size) for p in paths]
        return np.stack(imgs)

    def epoch(self) -> Iterator[np.ndarray]:
        order = self.rng.permutation(len(self.paths))
        for start in range(0, len(self.paths) - self.batch_size + 1,
                           self.batch_size):
            yield self.decode_batch(
                [self.paths[i] for i in order[start:start + self.batch_size]])

    def close(self):
        if self.pool is not None:
            self.pool.shutdown()
            self.pool = None
