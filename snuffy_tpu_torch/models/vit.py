"""DINO Vision Transformer embedder (CLS output), in PyTorch.

Port of `snuffy_tpu/models/vit.py` for feature extraction: no adapter, no
sequence packing, output = LayerNorm(x)[:, 0]. Parameter names are the
DINO/timm keys (`patch_embed.proj`, `blocks.{i}.attn.qkv`, `norm1`,
`mlp.fc1`, `norm`, `cls_token`, `pos_embed`), so a published DINO state
dict loads with `strict=True`.

Images come in the JAX package's layout, (B, H, W, 3) float. The patch
embedding is a reshape and one GEMM (the stride-p conv written out).
Attention is a plain matmul + softmax, as the JAX model computes it with
einsum outside any Pallas kernel; with `compute_dtype="bfloat16"` the
scores are bf16 too. LayerNorm eps is 1e-6 (flax's default), stats in f32.
The positional embedding is not interpolated: JAX resizes it with its
bicubic kernel (Keys a=−0.5; torch's bicubic uses a=−0.75), so an input
whose patch grid differs from the 224² one raises instead of differing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from snuffy_tpu_torch.models.layers import LN_EPS, layer_norm, linear
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
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)   # (b, h, n, dk)
        attn = torch.matmul(q, k.transpose(-2, -1)) * (dk ** -0.5)
        attn = torch.softmax(attn, dim=-1).to(dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return linear(out, self.proj, dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, dtype):
        return linear(F.gelu(linear(x, self.fc1, dtype)), self.fc2, dtype)


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, dtype):
        x = x + self.attn(layer_norm(x, self.norm1, dtype), dtype)
        return x + self.mlp(layer_norm(x, self.norm2, dtype), dtype)


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


class VisionTransformer(nn.Module):
    """ViT backbone → CLS embedding (B, D) in float32."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, compute_dtype: str = "float32",
                 seed: int = 0):
        super().__init__()
        self.embed_dim = embed_dim
        self.compute_dtype = compute_dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + (224 // patch_size) ** 2, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self._init_weights(torch.Generator().manual_seed(seed))

    def _init_weights(self, gen: torch.Generator) -> None:
        """The JAX model's init: flax's lecun_normal kernels, zero biases,
        trunc_normal(0.02) cls/pos tokens."""
        with torch.no_grad():
            for p in (self.cls_token, self.pos_embed):
                nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=gen)
                p.mul_(0.02)
            for mod in self.modules():
                if isinstance(mod, (nn.Linear, nn.Conv2d)):
                    lecun_normal(mod.weight, gen)
                    if mod.bias is not None:
                        mod.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = (torch.bfloat16 if self.compute_dtype == "bfloat16"
                 else torch.float32)
        b = x.shape[0]
        x = self.patch_embed(x, dtype)
        if x.shape[1] != self.pos_embed.shape[1] - 1:
            raise NotImplementedError(
                f"{x.shape[1]} patches but a {self.pos_embed.shape[1] - 1}-"
                "patch position grid: the JAX model resizes it with its own "
                "bicubic kernel (Keys a=-0.5), which is not ported; feed "
                "224x224 images"
            )
        cls = self.cls_token.to(dtype).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        for blk in self.blocks:
            x = blk(x, dtype)
        # LayerNorm is per token: normalise the CLS token only.
        return layer_norm(x[:, 0], self.norm, dtype).float()


def vit_small(**kw) -> VisionTransformer:
    return VisionTransformer(embed_dim=384, depth=12, num_heads=6, **kw)


def vit_base(**kw) -> VisionTransformer:
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12, **kw)
