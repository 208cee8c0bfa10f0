"""DINO Vision Transformer (CLS output) and the DINO head, in PyTorch.

Port of `snuffy_tpu/models/vit.py`: the ViT with its optional parallel
adapter, for extraction and for DINO-adapter pretraining, and `DINOHead`.
Output = LayerNorm(x)[:, 0]. Parameter names are the DINO/timm keys
(`patch_embed.proj`, `blocks.{i}.attn.qkv`, `norm1`, `mlp.fc1`, `norm`,
`cls_token`, `pos_embed`) and the DINO-adapter ones
(`blocks.{i}.adaptmlp.{down_proj,up_proj,scale,adapter_layer_norm_before}`),
so a published DINO state dict loads with `strict=True`.

Images come in the JAX package's layout, (B, H, W, 3) float. The patch
embedding is a reshape and one GEMM (the stride-p conv written out).
Attention runs on (b·h, n, dk), the JAX MHSA layout, through the dense
attention kernel (`ops/dense_attention.py`), in training too (its
gradient goes through the plain version): its scores and softmax are f32
whatever the compute dtype, where the JAX MHSA rounds the scores to bf16
under `compute_dtype="bfloat16"`. LayerNorm eps is 1e-6 (flax's
default), stats in f32.
An input whose patch grid differs from the 224² one gets the position
grid resized as `jax.image.resize(..., "bicubic")` resizes it
(`interpolate_pos_encoding`): Keys' cubic with a = −0.5 (torch's bicubic
takes −0.75), half-pixel centres, the kernel widened by the scale on a
downscale, and the weights renormalised where taps fall off the edge.

Training (`model.train()`, a `generator` on the input's device passed to
`forward`) draws the JAX model's dropouts: `drop_rate` on the position-
embedded tokens, the attention projection and the MLP, the adapter's own
dropout (0.1, hard-wired in the JAX `Block`; `adapter_dropout` sets it,
0 for parity tests) and stochastic depth (`drop_path_rate`, linearly
spaced over the blocks, one draw a sample and residual branch).
`attn_drop_rate` > 0 is refused: the dense kernel has no dropout on its
probabilities.

Crop packing (`forward(x, pack=k)`) folds groups of k images into one
sequence of k·n tokens: LayerNorm, the GEMMs and the adapter run on the
packed rows, stochastic depth draws once a segment, and the attention
folds the k segments into the kernel's z axis. That is the JAX
`pack_mode='blocked'`. The JAX `'masked'` mode runs one k·n attention
with a block-diagonal −1e9 mask, whose off-block weights underflow to
exact zeros (`snuffy_tpu/models/vit.py:345-353,102-110`; held equal by
`tests/test_ssl.py::test_vit_pack_forward_parity`). The dense kernel takes
no additive mask, so `'masked'` here runs the same fold; it is held to the
JAX `'masked'` forward by the port's tests.

Virchow2 (Zimmermann et al. 2024, arXiv:2408.13985; timm
`vit_huge_patch14_224` with `reg_tokens=4`, `init_values=1e-5`,
`mlp_layer=SwiGLUPacked`, `vit_huge_patch14_reg4` below) takes four options
that are off for every other model, each costing nothing when off:
`reg_tokens` register tokens (`reg_token`, between the class token and the
patches; the position table covers [class, registers, patches], timm's
default `no_embed_class=False`); `init_values` LayerScale (`ls1.gamma`,
`ls2.gamma`: x + γ₁ ⊙ attn(LN(x)), then x + γ₂ ⊙ FFN(LN(x)), γ cast to the
compute dtype); `mlp="swiglu_packed"` (timm's `GluMlp` with
`gate_last=False`: fc1's output split in halves a, b, SiLU(a) ⊙ b into fc2
of half the width); `pool="cls_mean"`, the final LayerNorm's class token
and the mean of its patch tokens (registers left out), concatenated
(`num_features` = 2 · `embed_dim`). Its timm state dict loads with
`strict=True`. `img_size` sizes the position table (224² by default).

`DINOHead` is the JAX head under the reference's torch names: a 3-layer
MLP with exact GELU (`mlp.{0,2,4}`, or with BatchNorm `mlp.{0,3,6}` and
`mlp.{1,4}`), L2 normalisation with +1e-12, and the weight-normed last
layer w = v / (‖v‖ + 1e-12) · g (`last_layer.weight_v` (out, in),
`last_layer.weight_g` (out, 1)), g held at 1 under `norm_last_layer`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from snuffy_tpu_torch.models.layers import LN_EPS, dropout, layer_norm, linear
from snuffy_tpu_torch.ops.dense_attention import fused_self_attention
from snuffy_tpu_torch.ops.init import lecun_normal


@dataclasses.dataclass(frozen=True)
class Run:
    """How a forward runs: `train` draws the dropouts from `generator`;
    `segments` images are packed in each sequence."""

    train: bool = False
    generator: Optional[torch.Generator] = None
    segments: int = 1


EVAL = Run()


def lora_down_init(w: torch.Tensor, generator: torch.Generator
                   ) -> torch.Tensor:
    """torch kaiming_normal_(a=√5) on an (out, in) weight: N(0, 1/(3·in))
    (the JAX `lora_down_init`)."""
    with torch.no_grad():
        return w.normal_(0.0, (3.0 * w.shape[1]) ** -0.5, generator=generator)


def drop_path(x: torch.Tensor, rate: float, run: Run) -> torch.Tensor:
    """Stochastic depth on a residual branch (b, n, d): keep each sample,
    or with packing each of its `run.segments` crops, with probability
    1 − rate, scaled by 1/(1 − rate)."""
    if not run.train or rate == 0.0:
        return x
    keep = 1.0 - rate
    b, n, d = x.shape
    seg = run.segments
    mask = torch.rand((b, seg, 1, 1), generator=run.generator,
                      device=x.device) < keep
    y = x.reshape(b, seg, n // seg, d)
    return torch.where(mask, y / keep, torch.zeros_like(y)).reshape(b, n, d)


def _dropout(x: torch.Tensor, rate: float, run: Run) -> torch.Tensor:
    return dropout(x, rate, run.generator) if run.train else x


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.proj_drop = proj_drop
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, dtype, run: Run = EVAL):
        b, n, c = x.shape
        h, dk = self.num_heads, c // self.num_heads
        qkv = linear(x, self.qkv, dtype).reshape(b, n, 3, h, dk)
        qkv = qkv.permute(2, 0, 3, 1, 4).contiguous()     # (3, b, h, n, dk)
        # packed segments are contiguous runs of n/segments tokens: fold
        # them into z (one attention per crop)
        seg = run.segments
        q, k, v = qkv.view(3, b * h * seg, n // seg, dk).unbind(0)
        out = fused_self_attention(q, k, v, n // seg)
        out = out.reshape(b, h, n, dk).transpose(1, 2).reshape(b, n, c)
        return _dropout(linear(out, self.proj, dtype), self.proj_drop, run)


class Adapter(nn.Module):
    """Parallel bottleneck adapter: [LN] → down → ReLU → dropout → up →
    × scale → [LN] (JAX `Adapter`; the dropout draws in training only).
    Init as JAX's: down N(0, 1/(3·dim)), up and biases 0, a learnable
    scale 1."""

    def __init__(self, dim: int, bottleneck: int = 64, scale: float = 0.1,
                 learnable_scale: bool = False,
                 layernorm_option: str = "none", dropout: float = 0.1):
        super().__init__()
        if layernorm_option not in ("in", "out", "none"):
            raise ValueError(f"layernorm_option {layernorm_option!r}")
        self.layernorm_option = layernorm_option
        self.dropout = dropout
        if layernorm_option != "none":
            self.adapter_layer_norm_before = nn.LayerNorm(dim, eps=LN_EPS)
        self.down_proj = nn.Linear(dim, bottleneck)
        self.up_proj = nn.Linear(bottleneck, dim)
        self.scale = (nn.Parameter(torch.ones(1)) if learnable_scale
                      else scale)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            lora_down_init(self.down_proj.weight, gen)
            for t in (self.down_proj.bias, self.up_proj.weight,
                      self.up_proj.bias):
                t.zero_()
            if isinstance(self.scale, nn.Parameter):
                self.scale.fill_(1.0)

    def forward(self, x, dtype, run: Run = EVAL):
        if self.layernorm_option == "in":
            x = layer_norm(x, self.adapter_layer_norm_before, dtype)
        h = _dropout(F.relu(linear(x, self.down_proj, dtype)), self.dropout,
                     run)
        h = linear(h, self.up_proj, dtype)
        # a learnable f32 scale promotes a bf16 branch to f32, as in JAX
        h = h * self.scale
        if self.layernorm_option == "out":
            h = layer_norm(h, self.adapter_layer_norm_before, dtype)
        return h


class Mlp(nn.Module):
    """fc1 → exact GELU → fc2, or with `gated` timm's packed SwiGLU: fc1's
    output split in halves a, b, SiLU(a) ⊙ b into an fc2 of half fc1's
    width."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0,
                 gated: bool = False):
        super().__init__()
        self.drop = drop
        self.gated = gated
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden // 2 if gated else hidden, dim)

    def forward(self, x, dtype, run: Run = EVAL):
        h = linear(x, self.fc1, dtype)
        if self.gated:
            a, b = h.chunk(2, dim=-1)
            h = F.silu(a) * b
        else:
            h = F.gelu(h)
        x = _dropout(h, self.drop, run)
        return _dropout(linear(x, self.fc2, dtype), self.drop, run)


class LayerScale(nn.Module):
    """timm's LayerScale: a branch scaled by γ (dim,), `init_values` at
    init, in the branch's dtype."""

    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    """Pre-norm transformer block with the optional parallel adapter, fed
    by the post-attention sequence: x = x + dp(attn); x + dp(mlp(norm2(x)))
    + adapter(x), dp the block's stochastic depth."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, adapter: Optional[dict] = None,
                 drop: float = 0.0, drop_path_rate: float = 0.0,
                 init_values: Optional[float] = None, gated: bool = False):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, qkv_bias, drop)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, gated)
        self.adaptmlp = Adapter(dim, **adapter) if adapter else None
        scaled = init_values is not None
        self.ls1 = LayerScale(dim, init_values) if scaled else None
        self.ls2 = LayerScale(dim, init_values) if scaled else None

    def forward(self, x, dtype, run: Run = EVAL):
        a = self.attn(layer_norm(x, self.norm1, dtype), dtype, run)
        if self.ls1 is not None:
            a = self.ls1(a)
        x = x + drop_path(a, self.drop_path_rate, run)
        y = self.mlp(layer_norm(x, self.norm2, dtype), dtype, run)
        if self.ls2 is not None:
            y = self.ls2(y)
        y = drop_path(y, self.drop_path_rate, run)
        out = x + y
        if self.adaptmlp is not None:
            out = out + self.adaptmlp(x, dtype, run)
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
                             w: int, h: int, patch_size: int,
                             prefix: int = 1) -> torch.Tensor:
    """Bicubic-resize the grid part of a (1, prefix+N0, D) position
    embedding (`prefix` rows of the class and register tokens first) to
    the (h // patch, w // patch) patch grid, in f32, with JAX's weights
    (`snuffy_tpu/models/vit.py` `interpolate_pos_encoding`). Returned as
    it is when the input has N0 patches."""
    n0 = pos_embed.shape[1] - prefix
    if n_patches == n0:
        return pos_embed
    dim = pos_embed.shape[-1]
    g0 = int(round(math.sqrt(n0)))
    gw, gh = w // patch_size, h // patch_size
    grid = pos_embed[0, prefix:].float().reshape(g0, g0, dim)
    wh = bicubic_weights(g0, gh).to(grid.device)
    ww = bicubic_weights(g0, gw).to(grid.device)
    grid = torch.einsum("oh,hwd,pw->opd", wh, grid, ww)
    return torch.cat([pos_embed[:, :prefix].float(),
                      grid.reshape(1, gh * gw, dim)], dim=1)


def class_plus_mean(y: torch.Tensor, prefix: int) -> torch.Tensor:
    """Tokens (B, n, D) after the final LayerNorm → [y₀ | the mean of the
    patch tokens] (B, 2D): the `prefix` class and register tokens are left
    out of the mean (Virchow2's embedding)."""
    return torch.cat([y[:, 0], y[:, prefix:].mean(dim=1)], dim=-1)


class VisionTransformer(nn.Module):
    """ViT backbone → CLS embedding (B, D) in float32, or with
    `pool="cls_mean"` the CLS and mean patch embedding (B, 2D)."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, use_adapter: bool = False,
                 adapter_bottleneck: int = 64, adapter_scale: float = 0.1,
                 adapter_learnable_scale: bool = False,
                 adapter_layernorm_option: str = "none",
                 compute_dtype: str = "float32", seed: int = 0,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, adapter_dropout: float = 0.1,
                 pack_mode: str = "masked", img_size: int = 224,
                 reg_tokens: int = 0, init_values: Optional[float] = None,
                 mlp: str = "gelu", pool: str = "cls"):
        super().__init__()
        if attn_drop_rate:
            raise ValueError("attn_drop_rate > 0: the dense attention kernel "
                             "draws no dropout on its probabilities")
        if pack_mode not in ("masked", "blocked"):
            raise ValueError(f"pack_mode {pack_mode!r}")
        if mlp not in ("gelu", "swiglu_packed"):
            raise ValueError(f"mlp {mlp!r}")
        if pool not in ("cls", "cls_mean"):
            raise ValueError(f"pool {pool!r}")
        self.embed_dim = embed_dim
        self.num_features = embed_dim * (2 if pool == "cls_mean" else 1)
        self.pool = pool
        self.num_prefix = 1 + reg_tokens
        self.compute_dtype = compute_dtype
        self.drop_rate = drop_rate
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.reg_token = (nn.Parameter(torch.zeros(1, reg_tokens, embed_dim))
                          if reg_tokens else None)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, self.num_prefix + (img_size // patch_size) ** 2, embed_dim))
        adapter = (dict(bottleneck=adapter_bottleneck, scale=adapter_scale,
                        learnable_scale=adapter_learnable_scale,
                        layernorm_option=adapter_layernorm_option,
                        dropout=adapter_dropout)
                   if use_adapter else None)
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, adapter,
                  drop_rate, float(dpr[i]), init_values,
                  mlp == "swiglu_packed")
            for i in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        tokens = (self.cls_token, self.pos_embed)
        if self.reg_token is not None:
            tokens += (self.reg_token,)
        init_weights(self, tokens, torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor, pack: int = 1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) → (B, num_features) f32. In train mode the dropouts
        draw from `generator` (on x's device); `pack` > 1 packs that many
        images a sequence (module docstring) and needs B % pack == 0."""
        dtype = (torch.bfloat16 if self.compute_dtype == "bfloat16"
                 else torch.float32)
        run = Run(self.training, generator, pack)
        b, h_img, w_img, _ = x.shape
        x = self.patch_embed(x, dtype)
        pe = interpolate_pos_encoding(self.pos_embed, x.shape[1], w_img,
                                      h_img, self.patch_embed.patch_size,
                                      self.num_prefix)
        prefix = [self.cls_token.to(dtype).expand(b, -1, -1)]
        if self.reg_token is not None:
            prefix.append(self.reg_token.to(dtype).expand(b, -1, -1))
        x = _dropout(torch.cat(prefix + [x], dim=1) + pe.to(dtype),
                     self.drop_rate, run)
        seq = x.shape[1]
        if pack > 1:
            if b % pack:
                raise ValueError(f"batch {b} not divisible by pack={pack}")
            x = x.reshape(b // pack, pack * seq, self.embed_dim)
        for blk in self.blocks:
            x = blk(x, dtype, run)
        if pack > 1:
            x = x.reshape(b, seq, self.embed_dim)
        if self.pool == "cls_mean":
            return class_plus_mean(layer_norm(x, self.norm, dtype).float(),
                                   self.num_prefix)
        # LayerNorm is per token: normalise the CLS token only.
        return layer_norm(x[:, 0], self.norm, dtype).float()


def vit_tiny(**kw) -> VisionTransformer:
    return VisionTransformer(embed_dim=192, depth=12, num_heads=3, **kw)


def vit_small(**kw) -> VisionTransformer:
    return VisionTransformer(embed_dim=384, depth=12, num_heads=6, **kw)


def vit_base(**kw) -> VisionTransformer:
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12, **kw)


def vit_large(**kw) -> VisionTransformer:
    return VisionTransformer(embed_dim=1024, depth=24, num_heads=16, **kw)


def vit_huge_patch14_reg4(**kw) -> VisionTransformer:
    """Virchow2's backbone (its model card's timm arguments): ViT-H/14 at
    224², 1280 wide, 32 blocks of 16 heads of 80, 4 registers, LayerScale
    from 1e-5, packed SwiGLU of 6832 = int(1280 · 5.3375), the 2560-d
    class-plus-mean embedding."""
    return VisionTransformer(patch_size=14, embed_dim=1280, depth=32,
                             num_heads=16, mlp_ratio=5.3375, reg_tokens=4,
                             init_values=1e-5, mlp="swiglu_packed",
                             pool="cls_mean", **kw)


class BatchNorm(nn.Module):
    """flax's `BatchNorm(momentum=0.9, epsilon=1e-5)` over the rows of (N,
    C), under torch BatchNorm1d's names (`weight`, `bias`, `running_mean`,
    `running_var`, `num_batches_tracked`). Training normalises with the
    batch's mean and its biased variance E[x²] − E[x]² (clipped at 0) and
    moves the running averages by 0.1 toward them; the running variance
    takes the biased batch variance, where torch's takes the unbiased
    one. With `mesh` set, the batch is every rank's rows: f32 sums, sums
    of squares and the count all-reduced over the batch axes, with
    autograd through them (each rank's gradient of the sums is summed
    too), so the running statistics are the same bits on every rank."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    # a mesh (`parallel/mesh.py`) whose batch axes hold the batch's rows:
    # training statistics over every rank's rows (the reference's
    # SyncBatchNorm), set by the DINO trainer
    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.mesh is not None and self.mesh.size > 1:
            from snuffy_tpu_torch.parallel.collectives import sum_over

            xf = x.float()
            c = x.shape[1]
            sums = sum_over(torch.cat([xf.sum(dim=0), (xf * xf).sum(dim=0),
                                       xf.new_full((1,), x.shape[0])]),
                            self.mesh, "batch", "BatchNorm sums")
            mean = sums[:c] / sums[-1]
            var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)
            mean, var = mean.to(x.dtype), var.to(x.dtype)
        elif self.training:
            mean = x.mean(dim=0)
            var = ((x * x).mean(dim=0) - mean * mean).clamp_min(0.0)
        if self.training:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class WeightNormLinear(nn.Module):
    """A bias-free linear layer weight-normed by rows: w = v / (‖v_row‖ +
    1e-12) · g. With `fixed_g`, g is 1 whatever `weight_g` holds."""

    def __init__(self, in_dim: int, out_dim: int, fixed_g: bool):
        super().__init__()
        self.fixed_g = fixed_g
        self.weight_g = nn.Parameter(torch.ones(out_dim, 1),
                                     requires_grad=not fixed_g)
        self.weight_v = nn.Parameter(torch.zeros(out_dim, in_dim))

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        w = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-12)
        return w if self.fixed_g else w * self.weight_g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight().t()


class DINOHead(nn.Module):
    """3-layer MLP (optional BatchNorm) → L2 norm → weight-normed linear
    (the JAX `DINOHead`; reference dino_adapter/
    vision_transformer_with_adapter.py:279-314). In f32. Train mode
    normalises the BatchNorms with batch statistics and moves their
    running averages; eval mode uses the running averages. Init as JAX's:
    trunc_normal(0.02) weights and `weight_v`, zero biases, g = 1."""

    def __init__(self, in_dim: int, out_dim: int = 65536,
                 hidden_dim: int = 2048, bottleneck_dim: int = 256,
                 use_bn: bool = False, norm_last_layer: bool = True,
                 seed: int = 0):
        super().__init__()
        self.use_bn = use_bn
        self.norm_last_layer = norm_last_layer
        layers = []
        dims = (in_dim, hidden_dim, hidden_dim, bottleneck_dim)
        for i in range(3):
            layers.append(nn.Linear(dims[i], dims[i + 1]))
            if i < 2:
                if use_bn:
                    layers.append(BatchNorm(dims[i + 1]))
                layers.append(nn.GELU())
        self.mlp = nn.Sequential(*layers)
        self.last_layer = WeightNormLinear(bottleneck_dim, out_dim,
                                           fixed_g=norm_last_layer)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for t in [m.weight for m in self.mlp if isinstance(m, nn.Linear)
                      ] + [self.last_layer.weight_v]:
                nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
                t.mul_(0.02)
            for m in self.mlp:
                if isinstance(m, nn.Linear):
                    m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mlp(x)
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        return self.last_layer(x)
