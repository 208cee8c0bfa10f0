"""The Masked-Autoencoder ViT's encoder and its extraction contract, in
PyTorch.

Port of the encoder half of `snuffy_tpu/models/mae.py`: `patch_embed`,
`cls_token`, the adapter-equipped pre-norm `blocks` and `norm`, with
`embed_tokens` (masking off, mean of the patch tokens, then norm; the
reference's `models_mae_normal.py:155-176`) as the forward. The decoder,
`random_masking`, `patchify` and the loss belong to MAE pretraining and
are not here: a checkpoint's decoder keys and `mask_token` go unused.

Parameter names are the MAE checkpoint's (`cls_token`,
`patch_embed.proj`, `blocks.{i}...`, `norm`). The 2-D sin-cos position
grid is a fixed, non-persistent buffer built in numpy
(`models/pos_embed.py`), so it is in no state dict.

The dtypes are the JAX model's: `PatchEmbed` has no dtype there, so the
patch embedding and the residual stream run in f32; each block computes
in the compute dtype (its LayerNorms return it, its products take it) and
adds its branches to the f32 stream; the mean pool and `norm` run in f32.
"""

from __future__ import annotations

import torch
from torch import nn

from snuffy_tpu_torch.models.layers import LN_EPS, layer_norm
from snuffy_tpu_torch.models.pos_embed import sincos_2d
from snuffy_tpu_torch.models.vit import Block, PatchEmbed, init_weights


class MaskedAutoencoderViT(nn.Module):
    """MAE encoder → mean-pooled, normed embedding (B, D) in f32."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, use_adapter: bool = True,
                 adapter_bottleneck: int = 64, adapter_scale: float = 0.1,
                 adapter_learnable_scale: bool = False,
                 adapter_layernorm_option: str = "none",
                 compute_dtype: str = "float32", seed: int = 0):
        super().__init__()
        self.embed_dim = embed_dim
        self.compute_dtype = compute_dtype
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(sincos_2d(embed_dim, img_size // patch_size)),
            persistent=False)
        adapter = (dict(bottleneck=adapter_bottleneck, scale=adapter_scale,
                        learnable_scale=adapter_learnable_scale,
                        layernorm_option=adapter_layernorm_option)
                   if use_adapter else None)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, True, adapter)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        init_weights(self, (self.cls_token,),
                     torch.Generator().manual_seed(seed))

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        """`embed_tokens`: (B, H, W, 3) → (B, D) f32."""
        dtype = (torch.bfloat16 if self.compute_dtype == "bfloat16"
                 else torch.float32)
        pe = self.pos_embed
        x = self.patch_embed(imgs, torch.float32) + pe[:, 1:]
        cls = (self.cls_token + pe[:, :1]).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        for blk in self.blocks:
            x = blk(x, dtype)
        pooled = x[:, 1:].float().mean(dim=1)
        return layer_norm(pooled, self.norm, torch.float32)


def mae_vit_base_patch16(**kw) -> MaskedAutoencoderViT:
    return MaskedAutoencoderViT(patch_size=16, embed_dim=768, depth=12,
                                num_heads=12, **kw)


def mae_vit_large_patch16(**kw) -> MaskedAutoencoderViT:
    return MaskedAutoencoderViT(patch_size=16, embed_dim=1024, depth=24,
                                num_heads=16, **kw)
