"""DINO Vision Transformer embedder (CLS output), in PyTorch.

Port of `snuffy_tpu/models/vit.py` for feature extraction, with its
optional parallel adapter; no sequence packing, output =
LayerNorm(x)[:, 0]. Parameter names are the DINO/timm keys
(`patch_embed.proj`, `blocks.{i}.attn.qkv`, `norm1`, `mlp.fc1`, `norm`,
`cls_token`, `pos_embed`) and the DINO-adapter ones
(`blocks.{i}.adaptmlp.{down_proj,up_proj,scale,adapter_layer_norm_before}`),
so a published DINO state dict loads with `strict=True`.

Images come in the JAX package's layout, (B, H, W, 3) float. The patch
embedding is a reshape and one GEMM (the stride-p conv written out).
Attention runs on (b·h, n, dk), the JAX MHSA layout, through the dense
attention kernel (`ops/dense_attention.py`): its scores and softmax are
f32 whatever the compute dtype, where the JAX MHSA rounds the scores to
bf16 under `compute_dtype="bfloat16"`. LayerNorm eps is 1e-6 (flax's
default), stats in f32.
An input whose patch grid differs from the 224² one gets the position
grid resized as `jax.image.resize(..., "bicubic")` resizes it
(`interpolate_pos_encoding`): Keys' cubic with a = −0.5 (torch's bicubic
takes −0.75), half-pixel centres, the kernel widened by the scale on a
downscale, and the weights renormalised where taps fall off the edge.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from snuffy_tpu_torch.models.layers import LN_EPS, layer_norm, linear
from snuffy_tpu_torch.ops.dense_attention import fused_self_attention
from snuffy_tpu_torch.ops.init import lecun_normal


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, dtype):
        b, n, c = x.shape
        h, dk = self.num_heads, c // self.num_heads
        qkv = linear(x, self.qkv, dtype).reshape(b, n, 3, h, dk)
        qkv = qkv.permute(2, 0, 3, 1, 4).contiguous()     # (3, b, h, n, dk)
        q, k, v = qkv.view(3, b * h, n, dk).unbind(0)
        out = fused_self_attention(q, k, v, n)            # (b·h, n, dk)
        out = out.reshape(b, h, n, dk).transpose(1, 2).reshape(b, n, c)
        return linear(out, self.proj, dtype)


class Adapter(nn.Module):
    """Parallel bottleneck adapter, eval mode: [LN] → down → ReLU → up →
    × scale → [LN] (JAX `Adapter`; its dropout is off at inference). Init
    as JAX's: down N(0, 1/(3·dim)), up and biases 0, a learnable scale 1."""

    def __init__(self, dim: int, bottleneck: int = 64, scale: float = 0.1,
                 learnable_scale: bool = False,
                 layernorm_option: str = "none"):
        super().__init__()
        if layernorm_option not in ("in", "out", "none"):
            raise ValueError(f"layernorm_option {layernorm_option!r}")
        self.layernorm_option = layernorm_option
        if layernorm_option != "none":
            self.adapter_layer_norm_before = nn.LayerNorm(dim, eps=LN_EPS)
        self.down_proj = nn.Linear(dim, bottleneck)
        self.up_proj = nn.Linear(bottleneck, dim)
        self.scale = (nn.Parameter(torch.ones(1)) if learnable_scale
                      else scale)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.down_proj.weight.normal_(
                0.0, (3.0 * self.down_proj.in_features) ** -0.5,
                generator=gen)
            for t in (self.down_proj.bias, self.up_proj.weight,
                      self.up_proj.bias):
                t.zero_()
            if isinstance(self.scale, nn.Parameter):
                self.scale.fill_(1.0)

    def forward(self, x, dtype):
        if self.layernorm_option == "in":
            x = layer_norm(x, self.adapter_layer_norm_before, dtype)
        h = linear(F.relu(linear(x, self.down_proj, dtype)), self.up_proj,
                   dtype)
        # a learnable f32 scale promotes a bf16 branch to f32, as in JAX
        h = h * self.scale
        if self.layernorm_option == "out":
            h = layer_norm(h, self.adapter_layer_norm_before, dtype)
        return h


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, dtype):
        return linear(F.gelu(linear(x, self.fc1, dtype)), self.fc2, dtype)


class Block(nn.Module):
    """Pre-norm transformer block with the optional parallel adapter, fed
    by the post-attention sequence: x = x + attn; x + mlp(norm2(x)) +
    adapter(x)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, adapter: Optional[dict] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.adaptmlp = Adapter(dim, **adapter) if adapter else None

    def forward(self, x, dtype):
        x = x + self.attn(layer_norm(x, self.norm1, dtype), dtype)
        out = x + self.mlp(layer_norm(x, self.norm2, dtype), dtype)
        if self.adaptmlp is not None:
            out = out + self.adaptmlp(x, dtype)
        return out


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, patch_size)

    def forward(self, x, dtype):  # (B, H, W, 3) → (B, N, D)
        b, hh, ww, c = x.shape
        p = self.patch_size
        gh, gw = hh // p, ww // p
        x = x[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, c)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, gh * gw, c * p * p)
        w = self.proj.weight.reshape(self.proj.out_channels, -1)
        return F.linear(x.to(dtype), w.to(dtype), self.proj.bias.to(dtype))


def init_weights(model: nn.Module, tokens, gen: torch.Generator) -> None:
    """The JAX models' init: flax's lecun_normal kernels, zero biases,
    trunc_normal(0.02) `tokens`, the adapters' LoRA-style init."""
    with torch.no_grad():
        for p in tokens:
            nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=gen)
            p.mul_(0.02)
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                lecun_normal(mod.weight, gen)
                if mod.bias is not None:
                    mod.bias.zero_()
        for mod in model.modules():
            if isinstance(mod, Adapter):
                mod.reset_parameters(gen)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = −0.5, of |x| (jax.image's
    `_fill_keys_cubic_kernel`)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


@functools.lru_cache(maxsize=None)
def bicubic_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(out, in) f32 weights of `jax.image.resize(..., "bicubic")` along
    one axis (antialiased, no translation), step for step in f32 as
    jax/_src/image/scale.py `compute_weight_mat` builds them: sample
    centres (o + ½)·in/out − ½; on a downscale the kernel widened by
    in/out; each output's weights divided by their sum (so taps that fall
    off the edge are renormalised away); an output whose centre lies
    outside the input gets none."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :]
                - np.arange(in_size, dtype=np.float32)[:, None])
         / kernel_scale)
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, np.float32(0.0))
    return torch.from_numpy(np.ascontiguousarray(w.T, dtype=np.float32))


def interpolate_pos_encoding(pos_embed: torch.Tensor, n_patches: int,
                             w: int, h: int, patch_size: int
                             ) -> torch.Tensor:
    """Bicubic-resize the grid part of a (1, 1+N0, D) position embedding to
    the (h // patch, w // patch) patch grid, in f32, with JAX's weights
    (`snuffy_tpu/models/vit.py` `interpolate_pos_encoding`). Returned as
    it is when the input has N0 patches."""
    n0 = pos_embed.shape[1] - 1
    if n_patches == n0:
        return pos_embed
    dim = pos_embed.shape[-1]
    g0 = int(round(math.sqrt(n0)))
    gw, gh = w // patch_size, h // patch_size
    grid = pos_embed[0, 1:].float().reshape(g0, g0, dim)
    wh = bicubic_weights(g0, gh).to(grid.device)
    ww = bicubic_weights(g0, gw).to(grid.device)
    grid = torch.einsum("oh,hwd,pw->opd", wh, grid, ww)
    return torch.cat([pos_embed[:, :1].float(),
                      grid.reshape(1, gh * gw, dim)], dim=1)


class VisionTransformer(nn.Module):
    """ViT backbone → CLS embedding (B, D) in float32."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, use_adapter: bool = False,
                 adapter_bottleneck: int = 64, adapter_scale: float = 0.1,
                 adapter_learnable_scale: bool = False,
                 adapter_layernorm_option: str = "none",
                 compute_dtype: str = "float32", seed: int = 0):
        super().__init__()
        self.embed_dim = embed_dim
        self.compute_dtype = compute_dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + (224 // patch_size) ** 2, embed_dim))
        adapter = (dict(bottleneck=adapter_bottleneck, scale=adapter_scale,
                        learnable_scale=adapter_learnable_scale,
                        layernorm_option=adapter_layernorm_option)
                   if use_adapter else None)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, adapter)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        init_weights(self, (self.cls_token, self.pos_embed),
                     torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = (torch.bfloat16 if self.compute_dtype == "bfloat16"
                 else torch.float32)
        b, h_img, w_img, _ = x.shape
        x = self.patch_embed(x, dtype)
        pe = interpolate_pos_encoding(self.pos_embed, x.shape[1], w_img,
                                      h_img, self.patch_embed.patch_size)
        cls = self.cls_token.to(dtype).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1) + pe.to(dtype)
        for blk in self.blocks:
            x = blk(x, dtype)
        # LayerNorm is per token: normalise the CLS token only.
        return layer_norm(x[:, 0], self.norm, dtype).float()


def vit_small(**kw) -> VisionTransformer:
    return VisionTransformer(embed_dim=384, depth=12, num_heads=6, **kw)


def vit_base(**kw) -> VisionTransformer:
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12, **kw)
