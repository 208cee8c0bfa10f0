"""Device-side augmentation for DINO and MAE pretraining, batched.

The port of `snuffy_tpu/ssl/augment.py`: the reference's
DataAugmentationDINO (reference dino_adapter/main_dino_adapter.py:674-719:
2 global crops at 224 and N local crops at 96, with flip, colour jitter,
grayscale, blur and solarization) and the MAE `transform_train`
(`mae_train_augment`: a bicubic RandomResizedCrop with scale (0.2, 1.0),
a flip and the ImageNet normalisation; reference
mae_adapter/main_pretrain_adapter.py:155-159). The JAX package vmaps each
op over the batch; here each op is one tensor program over a batch of
crops: every crop's window becomes gather indices into the source batch,
and its flip, jitter, blur and solarize draws broadcast over its pixels.
No Python loop runs over images.

Each op is split in two: a *draw* (`draw_views`: the uniforms and
Bernoullis of every crop, as tensors from an explicit `torch.Generator`
on the device) and an *apply* that takes them, so the same apply can be
fed the JAX functions' own draws. A draw holds, per crop:

  area       U(scale)             crop area over the image's
  log_ratio  U(log 3/4, log 4/3)  log aspect ratio
  y, x       U(0, 1)              window offsets
  flip       Bernoulli(0.5)
  bright, contrast, sat, hue      U(±0.4), U(±0.4), U(±0.2), U(±0.1)
  jitter     Bernoulli(0.8)
  gray       Bernoulli(0.2)
  sigma      U(0.1, 2.0)
  blur, solar  Bernoulli(p) with the view's probabilities

The arithmetic is the JAX code's, in f32 and in its order: the one-shot
crop sampling (sides clipped to [8, side]), a `linspace` grid over the
window, edge-clamped bilinear or bicubic (Keys, a = −0.5) taps, the
9-tap edge-padded separable blur, the `roll`-based hue direction. A
uniform U(lo, hi) is `u·(hi − lo) + lo`, as `jax.random.uniform` maps
it, and a Bernoulli(p) is `u < p`.

The MAE transform draws only the crop (area, log_ratio, y, x) and the
flip (`mae_draws`), and applies them by `mae_apply`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

Draws = Dict[str, torch.Tensor]
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RATIO = (3 / 4, 4 / 3)


def _uniform(gen, n, lo, hi, device) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=device)
    return torch.maximum(u * (hi - lo) + lo, torch.tensor(lo, device=device))


def _bernoulli(gen, n, p, device) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=device) < p


def draw_views(gen: torch.Generator, n: int, scale: Tuple[float, float],
               blur_p: Union[float, torch.Tensor],
               solar_p: Union[float, torch.Tensor],
               device: torch.device) -> Draws:
    """Every draw of `n` crops (module docstring), on `device` from
    `gen`. `blur_p`/`solar_p` are one probability or one a crop."""
    d = {
        "area": _uniform(gen, n, scale[0], scale[1], device),
        "log_ratio": _uniform(gen, n, math.log(RATIO[0]), math.log(RATIO[1]),
                              device),
        "y": torch.rand(n, generator=gen, device=device),
        "x": torch.rand(n, generator=gen, device=device),
        "flip": _bernoulli(gen, n, 0.5, device),
        "bright": _uniform(gen, n, -0.4, 0.4, device),
        "contrast": _uniform(gen, n, -0.4, 0.4, device),
        "sat": _uniform(gen, n, -0.2, 0.2, device),
        "hue": _uniform(gen, n, -0.1, 0.1, device),
        "jitter": _bernoulli(gen, n, 0.8, device),
        "gray": _bernoulli(gen, n, 0.2, device),
        "sigma": _uniform(gen, n, 0.1, 2.0, device),
    }
    d["blur"] = _bernoulli(gen, n, blur_p, device)
    d["solar"] = _bernoulli(gen, n, solar_p, device)
    return d


def _col(t: torch.Tensor) -> torch.Tensor:
    """(n,) → (n, 1, 1, 1), to broadcast over (n, H, W, C)."""
    return t.reshape(-1, 1, 1, 1)


def linspace01(n: int, device=None) -> torch.Tensor:
    """`jnp.linspace(0, 1, n)` as XLA computes it: i · f32(1/(n − 1)) (the
    division by a constant becomes a product by its reciprocal), the last
    point exactly 1."""
    if n == 1:
        return torch.zeros(1, device=device)
    recip = float(np.float32(1.0) / np.float32(n - 1))
    lin = torch.arange(n, dtype=torch.float32, device=device) * recip
    lin[-1] = 1.0
    return lin


def crop_grid(h: int, w: int, area_frac, log_ratio, y, x, out_size: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each crop's (out,) sample rows and columns in the source image, as
    `random_resized_crop` computes them from its draws."""
    area = h * w * area_frac
    r = torch.exp(log_ratio)
    ch = torch.sqrt(area / r).clamp(8.0, h)
    cw = torch.sqrt(area * r).clamp(8.0, w)
    y0 = y * (h - ch)
    x0 = x * (w - cw)
    lin = linspace01(out_size, area.device)
    ys = y0[:, None] + (ch - 1)[:, None] * lin[None]
    xs = x0[:, None] + (cw - 1)[:, None] * lin[None]
    return ys, xs


def _gather(images, src, yi, xi):
    """images[src[c], yi[c, i], xi[c, j]] → (n, out, out, C)."""
    return images[src[:, None, None], yi[:, :, None], xi[:, None, :]]


def bilinear_sample(images, src, ys, xs) -> torch.Tensor:
    h, w = images.shape[1], images.shape[2]
    y0 = torch.floor(ys).long().clamp(0, h - 1)
    x0 = torch.floor(xs).long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    a = _gather(images, src, y0, x0)
    b = _gather(images, src, y0, x1)
    c = _gather(images, src, y1, x0)
    d = _gather(images, src, y1, x1)
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def cubic_weights(t: torch.Tensor) -> torch.Tensor:
    """Keys cubic, a = −0.5 (PIL's BICUBIC), for taps at offsets
    (−1, 0, 1, 2) of fractional positions t → (4, *t.shape); powers as
    `lax.integer_pow` forms them."""
    a = -0.5
    d = torch.stack([t + 1.0, t, 1.0 - t, 2.0 - t])
    d2 = d * d
    d3 = d * d2
    near = (a + 2.0) * d3 - (a + 3.0) * d2 + 1.0
    far = a * d3 - 5.0 * a * d2 + 8.0 * a * d - 4.0 * a
    return torch.where(d <= 1.0, near, far)


def bicubic_sample(images, src, ys, xs) -> torch.Tensor:
    """Separable 4×4-tap bicubic grid sample with edge clamping."""
    h, w = images.shape[1], images.shape[2]
    yb = torch.floor(ys).long()
    xb = torch.floor(xs).long()
    wy = cubic_weights(ys - yb)              # (4, n, out)
    wx = cubic_weights(xs - xb)
    out = 0.0
    for i in range(4):
        yi = (yb + (i - 1)).clamp(0, h - 1)
        row_acc = 0.0
        for j in range(4):
            xj = (xb + (j - 1)).clamp(0, w - 1)
            row_acc = row_acc + _gather(images, src, yi, xj) * \
                wx[j][:, None, :, None]
        out = out + row_acc * wy[i][:, :, None, None]
    return out


def random_resized_crop(images: torch.Tensor, src: torch.Tensor, d: Draws,
                        out_size: int, method: str = "bilinear"
                        ) -> torch.Tensor:
    """Crops of `images` (B, H, W, C) f32: crop c samples images[src[c]]
    over its drawn window on an out_size² grid → (n, out, out, C)."""
    ys, xs = crop_grid(images.shape[1], images.shape[2], d["area"],
                       d["log_ratio"], d["y"], d["x"], out_size)
    if method == "bicubic":
        return bicubic_sample(images, src, ys, xs)
    if method != "bilinear":
        raise ValueError(f"method {method!r}")
    return bilinear_sample(images, src, ys, xs)


def hflip(img: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(_col(flip), img.flip(2), img)


def color_jitter(img: torch.Tensor, d: Draws) -> torch.Tensor:
    """Brightness, contrast, saturation and the first-order hue shift,
    where `d["jitter"]` (torchvision ColorJitter semantics)."""
    out = img * _col(1.0 + d["bright"])
    mean = out.mean(dim=(1, 2, 3), keepdim=True)
    out = (out - mean) * _col(1.0 + d["contrast"]) + mean
    gray = out.mean(dim=-1, keepdim=True)
    out = (out - gray) * _col(1.0 + d["sat"]) + gray
    out = out + _col(d["hue"]) * (torch.roll(out, 1, dims=-1) - out)
    return torch.where(_col(d["jitter"]), out.clamp(0.0, 1.0), img)


def grayscale(img: torch.Tensor, gray: torch.Tensor) -> torch.Tensor:
    g = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    return torch.where(_col(gray), torch.stack([g] * 3, dim=-1), img)


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor,
                  blur: torch.Tensor, kernel_size: int = 9) -> torch.Tensor:
    """Separable gaussian blur with each crop's sigma, rows then columns,
    edge-padded (reference dino_adapter/utils.py:39-56), where `blur`."""
    half = kernel_size // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32,
                      device=img.device)
    t = xs[None] / sigma[:, None]
    g = torch.exp(-0.5 * (t * t))
    g = g / g.sum(dim=1, keepdim=True)                # (n, k)
    h, w = img.shape[1], img.shape[2]
    rows_idx = torch.arange(h, device=img.device)
    cols_idx = torch.arange(w, device=img.device)
    rows = 0
    for i in range(kernel_size):
        idx = (rows_idx + (i - half)).clamp(0, h - 1)
        rows = rows + img[:, idx] * _col(g[:, i])
    out = 0
    for i in range(kernel_size):
        idx = (cols_idx + (i - half)).clamp(0, w - 1)
        out = out + rows[:, :, idx] * _col(g[:, i])
    return torch.where(_col(blur), out, img)


def solarization(img: torch.Tensor, solar: torch.Tensor,
                 threshold: float = 0.5) -> torch.Tensor:
    sol = torch.where(img >= threshold, 1.0 - img, img)
    return torch.where(_col(solar), sol, img)


def normalize(img: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD
              ) -> torch.Tensor:
    m = torch.tensor(mean, dtype=torch.float32, device=img.device)
    s = torch.tensor(std, dtype=torch.float32, device=img.device)
    return (img - m) / s


def apply_views(images: torch.Tensor, src: torch.Tensor, d: Draws,
                out_size: int) -> torch.Tensor:
    """The DINO view transform on every crop: crop, flip, jitter,
    grayscale, blur, solarize, normalize (`dino_global_crop` and, with
    `solar` all False, `dino_local_crop`) → (n, out, out, 3)."""
    x = random_resized_crop(images, src, d, out_size)
    x = hflip(x, d["flip"])
    x = color_jitter(x, d)
    x = grayscale(x, d["gray"])
    x = gaussian_blur(x, d["sigma"], d["blur"])
    x = solarization(x, d["solar"])
    return normalize(x)


def multicrop_draws(gen: torch.Generator, b: int, n_local: int,
                    global_scale=(0.4, 1.0), local_scale=(0.05, 0.4),
                    device: Optional[torch.device] = None
                    ) -> Tuple[Draws, Draws]:
    """The draws of `dino_multicrop_batch`: 2·b global crops (the first
    view blurred always and never solarized, the second blurred with
    p = 0.1 and solarized with p = 0.2) and n_local·b local crops
    (blurred with p = 0.5, never solarized), view-major."""
    device = device or torch.device("cuda")
    blur = torch.cat([torch.full((b,), 1.0), torch.full((b,), 0.1)])
    solar = torch.cat([torch.zeros(b), torch.full((b,), 0.2)])
    g = draw_views(gen, 2 * b, global_scale, blur.to(device),
                   solar.to(device), device)
    loc = draw_views(gen, n_local * b, local_scale, 0.5, 0.0, device)
    return g, loc


def dino_multicrop_batch(images: torch.Tensor, gen: torch.Generator,
                         n_local: int = 8, global_size: int = 224,
                         local_size: int = 96, global_scale=(0.4, 1.0),
                         local_scale=(0.05, 0.4),
                         draws: Optional[Tuple[Draws, Draws]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) uint8 (or f32 in [0, 1]) → (globals (2, B, gs, gs, 3),
    locals (n_local, B, ls, ls, 3)), normalized, on the images' device:
    one program for the global crops and one for the local ones. `draws`
    (as `multicrop_draws` gives them) replaces the draws from `gen`."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    b = images.shape[0]
    g_d, l_d = draws if draws is not None else multicrop_draws(
        gen, b, n_local, global_scale, local_scale, images.device)
    src = torch.arange(b, device=images.device)
    g = apply_views(images, src.repeat(2), g_d, global_size)
    if n_local == 0:
        loc = images.new_zeros((0, b, local_size, local_size, 3))
    else:
        loc = apply_views(images, src.repeat(n_local), l_d, local_size)
        loc = loc.reshape(n_local, b, local_size, local_size, 3)
    return g.reshape(2, b, global_size, global_size, 3), loc


def mae_draws(gen: torch.Generator, n: int, scale=(0.2, 1.0),
              device: Optional[torch.device] = None) -> Draws:
    """The draws of `mae_train_augment` for `n` images: the crop's area,
    log aspect ratio and offsets, and the flip."""
    device = device or torch.device("cuda")
    return {
        "area": _uniform(gen, n, scale[0], scale[1], device),
        "log_ratio": _uniform(gen, n, math.log(RATIO[0]), math.log(RATIO[1]),
                              device),
        "y": torch.rand(n, generator=gen, device=device),
        "x": torch.rand(n, generator=gen, device=device),
        "flip": _bernoulli(gen, n, 0.5, device),
    }


def mae_apply(images: torch.Tensor, d: Draws, out_size: int) -> torch.Tensor:
    """Image i cropped (bicubic) by its draws, flipped where drawn,
    normalised → (B, out, out, 3) f32."""
    src = torch.arange(images.shape[0], device=images.device)
    x = random_resized_crop(images, src, d, out_size, "bicubic")
    return normalize(hflip(x, d["flip"]))


def mae_train_augment(images: torch.Tensor, gen: Optional[torch.Generator],
                      out_size: int, scale=(0.2, 1.0),
                      draws: Optional[Draws] = None) -> torch.Tensor:
    """(B, H, W, 3) uint8 (or f32 in [0, 1]) of any size → (B, out_size,
    out_size, 3) f32, normalised, on the images' device: the crop window
    is taken from the raw decode, as torchvision crops the original
    image. `draws` (as `mae_draws` gives them) replaces the draws from
    `gen`."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    if draws is None:
        draws = mae_draws(gen, images.shape[0], scale, images.device)
    return mae_apply(images, draws, out_size)
