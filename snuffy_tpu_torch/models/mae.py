"""The Masked-Autoencoder ViT with parallel adapters, in PyTorch.

Port of `snuffy_tpu/models/mae.py`. The encoder (`patch_embed`,
`cls_token`, the adapter-equipped pre-norm `blocks` and `norm`) serves
extraction: `forward` is `embed_tokens` (masking off, mean of the patch
tokens, then norm; the reference's `models_mae_normal.py:155-176`).

With `with_decoder`, the model also holds the decoder that MAE
pretraining trains (`decoder_embed`, `mask_token`, `decoder_blocks`, whose
adapter bottleneck scales by decoder_embed_dim / embed_dim, `decoder_norm`,
`decoder_pred`), and `forward_pretrain` runs the full forward → (loss,
pred, mask): `random_masking` keeps a per-sample subset, the encoder sees
it (packed `pack` images a sequence), the decoder sees every position
with mask tokens in the removed ones, and the loss is the mean squared
error over the removed patches, optionally per-patch normalised
(`norm_pix_loss`), divided by max(sum(mask), 1). Without the flag, the
state dict is the encoder's alone.

Parameter names are the MAE checkpoint's (`cls_token`, `mask_token`,
`patch_embed.proj`, `blocks.{i}...`, `norm`, `decoder_embed`,
`decoder_blocks.{i}...`, `decoder_norm`, `decoder_pred`). The 2-D sin-cos
grids are fixed, non-persistent buffers built in numpy
(`models/pos_embed.py`), so they are in no state dict.

The dtypes are the JAX model's: `PatchEmbed` has no dtype there, so the
patch embedding (of an image already rounded to bf16 by the trainer) and
the residual streams run in f32; each block computes in the compute dtype
(its LayerNorms return it, its products take it) and adds its branches to
the f32 stream; `norm`, `decoder_embed`, `decoder_norm` and `decoder_pred`
run in f32. The target is `patchify` of the input in its own dtype; under
`norm_pix_loss` its mean and variance are taken in f32 and rounded to
that dtype, as jnp's are.

Training (`model.train()`, a `generator` on the input's device) draws the
adapters' dropout (0.1, hard-wired in the JAX `Block`; each adapter's
`dropout` attribute holds it). Packing folds the segments into the dense
kernel's z axis: the JAX `pack_mode='blocked'`; its `'masked'` mode is the
same math (see `models/vit.py`), so the model takes no mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from snuffy_tpu_torch.models.layers import LN_EPS, layer_norm, linear
from snuffy_tpu_torch.models.pos_embed import sincos_2d
from snuffy_tpu_torch.models.vit import (
    NO_CARRY,
    Block,
    PatchEmbed,
    Run,
    add_carry,
    init_weights,
)


class MaskedAutoencoderViT(nn.Module):
    """MAE encoder → mean-pooled, normed embedding (B, D) in f32; with
    `with_decoder`, the pretraining forward too."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 decoder_embed_dim: int = 512, decoder_depth: int = 8,
                 decoder_num_heads: int = 16, mlp_ratio: float = 4.0,
                 norm_pix_loss: bool = False, use_adapter: bool = True,
                 adapter_bottleneck: int = 64, adapter_scale: float = 0.1,
                 adapter_learnable_scale: bool = False,
                 adapter_layernorm_option: str = "none",
                 compute_dtype: str = "float32", seed: int = 0,
                 with_decoder: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.grid = img_size // patch_size
        self.compute_dtype = compute_dtype
        self.norm_pix_loss = norm_pix_loss
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_buffer(
            "pos_embed", torch.from_numpy(sincos_2d(embed_dim, self.grid)),
            persistent=False)

        def adapter(bottleneck):
            return (dict(bottleneck=bottleneck, scale=adapter_scale,
                         learnable_scale=adapter_learnable_scale,
                         layernorm_option=adapter_layernorm_option)
                    if use_adapter else None)

        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, True,
                  adapter(adapter_bottleneck))
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        gen = torch.Generator().manual_seed(seed)
        init_weights(self, (self.cls_token,), gen)
        if not with_decoder:
            return
        self.decoder_embed = nn.Linear(embed_dim, decoder_embed_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_embed_dim))
        dec_bottleneck = max(
            1, int(adapter_bottleneck * decoder_embed_dim / embed_dim))
        self.decoder_blocks = nn.ModuleList(
            Block(decoder_embed_dim, decoder_num_heads, mlp_ratio, True,
                  adapter(dec_bottleneck))
            for _ in range(decoder_depth))
        self.decoder_norm = nn.LayerNorm(decoder_embed_dim, eps=LN_EPS)
        self.decoder_pred = nn.Linear(decoder_embed_dim,
                                      patch_size ** 2 * 3)
        self.register_buffer(
            "decoder_pos_embed",
            torch.from_numpy(sincos_2d(decoder_embed_dim, self.grid)),
            persistent=False)
        # the encoder's init is the extraction model's; the decoder's
        # draws follow it
        init_weights(nn.ModuleList([self.decoder_embed, self.decoder_blocks,
                                    self.decoder_pred]),
                     (self.mask_token,), gen)

    @property
    def dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        """`embed_tokens`: (B, H, W, 3) → (B, D) f32."""
        pe = self.pos_embed
        x = self.patch_embed(imgs, torch.float32) + pe[:, 1:]
        cls = (self.cls_token + pe[:, :1]).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        for blk in self.blocks:
            x = add_carry(*blk(x, NO_CARRY, self.dtype))
        pooled = x[:, 1:].float().mean(dim=1)
        return layer_norm(pooled, self.norm, torch.float32)

    # ------------------------------------------------------------ patches

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, N, p²·3), each patch's pixels row by row."""
        p, g = self.patch_size, self.grid
        x = imgs.reshape(imgs.shape[0], g, p, g, p, 3)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(imgs.shape[0], g * g,
                                                    p * p * 3)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, p²·3) → (B, H, W, 3)."""
        p, g = self.patch_size, self.grid
        x = x.reshape(x.shape[0], g, g, p, p, 3)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(x.shape[0], g * p, g * p,
                                                    3)

    # ------------------------------------------------------------- masking

    @staticmethod
    def random_masking(x: torch.Tensor, mask_ratio: float,
                       noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Keep int(N·(1 − mask_ratio)) tokens a sample, those of least
        uniform `noise` (B, N) (drawn from `generator` on x's device when
        not given; stable sorts, as jnp.argsort) → (x_keep, mask (B, N)
        f32, 1 where removed, ids_restore)."""
        b, n, d = x.shape
        len_keep = int(n * (1 - mask_ratio))
        if noise is None:
            noise = torch.rand((b, n), generator=generator, device=x.device)
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :len_keep]
        x_keep = torch.gather(x, 1, ids_keep[..., None].expand(-1, -1, d))
        mask = torch.ones((b, n), device=x.device)
        mask[:, :len_keep] = 0.0
        return x_keep, torch.gather(mask, 1, ids_restore), ids_restore

    # ------------------------------------------------------------- forward

    def forward_pretrain(self, imgs: torch.Tensor, mask_ratio: float = 0.75,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         pack: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The full MAE forward (module docstring) → (loss f32 scalar, pred
        (B, N, p²·3) f32, mask (B, N) f32). `pack` > 1 folds groups of
        that many masked images into one encoder sequence (B % pack == 0);
        the decoder runs unpacked. In train mode the adapters' dropout
        draws from `generator`, after the masking noise."""
        pe = self.pos_embed
        x = self.patch_embed(imgs, torch.float32) + pe[:, 1:]
        x, mask, ids_restore = self.random_masking(x, mask_ratio, noise,
                                                   generator)
        cls = (self.cls_token + pe[:, :1]).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        b, n_vis, _ = x.shape
        if pack > 1:
            if b % pack:
                raise ValueError(f"batch {b} not divisible by pack={pack}")
            x = x.reshape(b // pack, pack * n_vis, self.embed_dim)
        run = Run(self.training, generator, pack)
        for blk in self.blocks:
            x = add_carry(*blk(x, NO_CARRY, self.dtype, run))
        latent = layer_norm(x, self.norm, torch.float32)
        if pack > 1:
            latent = latent.reshape(b, n_vis, self.embed_dim)

        y = linear(latent, self.decoder_embed, torch.float32)
        dim = y.shape[-1]
        n_masked = ids_restore.shape[1] + 1 - y.shape[1]
        y_ = torch.cat([y[:, 1:], self.mask_token.expand(b, n_masked, -1)],
                       dim=1)
        y_ = torch.gather(y_, 1, ids_restore[..., None].expand(-1, -1, dim))
        y = torch.cat([y[:, :1], y_], dim=1) + self.decoder_pos_embed
        run = Run(self.training, generator, 1)
        for blk in self.decoder_blocks:
            y = add_carry(*blk(y, NO_CARRY, self.dtype, run))
        y = layer_norm(y, self.decoder_norm, torch.float32)
        pred = linear(y, self.decoder_pred, torch.float32)[:, 1:]

        target = self.patchify(imgs)
        if self.norm_pix_loss:
            t32 = target.float()
            mu = t32.mean(dim=-1, keepdim=True).to(target.dtype)
            var = t32.var(dim=-1, unbiased=False, keepdim=True).to(
                target.dtype)
            target = (target - mu) / torch.sqrt(var + 1e-6)
        diff = pred - target
        per_patch = (diff * diff).mean(dim=-1)
        loss = (per_patch * mask).sum() / mask.sum().clamp_min(1.0)
        return loss, pred, mask


def mae_vit_base_patch16(**kw) -> MaskedAutoencoderViT:
    return MaskedAutoencoderViT(
        patch_size=16, embed_dim=768, depth=12, num_heads=12,
        decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=16, **kw)


def mae_vit_large_patch16(**kw) -> MaskedAutoencoderViT:
    return MaskedAutoencoderViT(
        patch_size=16, embed_dim=1024, depth=24, num_heads=16,
        decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=16, **kw)


def mae_vit_huge_patch14(**kw) -> MaskedAutoencoderViT:
    return MaskedAutoencoderViT(
        patch_size=14, embed_dim=1280, depth=32, num_heads=16,
        decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=16, **kw)
