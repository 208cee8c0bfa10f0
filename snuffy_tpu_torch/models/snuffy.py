"""Snuffy sparse-transformer MIL aggregator (binary), in PyTorch.

Port of `snuffy_tpu/models/snuffy.py`. A bag is a static
(N_pad, d) tensor with an (N_pad,) bool mask; with `segments` = k > 1 the
rows hold k equal-length bags packed on the row axis and each bag's rows
attend only to its own slots (one forward at GEMM height k·N).

Module names follow the reference `.pth` layout
(`snuffy_tpu/embed/torch_export.py`), so a state dict exported from the
JAX parameters, or a reference checkpoint, loads with `strict=True`.

Kept from the JAX model:
  * keys project the PRE-norm selected rows, q and v project LayerNorm(x),
    and the attention residual is the pre-norm selected rows;
  * q and v share one d→2d GEMM (the parameters stay separate);
  * LayerNorm eps is 1e-6 (flax's default), stats and affine in f32;
  * under bf16 the instance logits come from the f32 feats, the residual
    stream runs bf16 and the masked mean pool accumulates in f32;
  * the top share is chosen once per forward, the random share per layer.

In training mode (`model.train()`) the forward is differentiable and runs
the three dropouts of the JAX model: on the attention probabilities
(`attention_dropout`, the kernels' hash with one seed per layer call), on
the attention output and the FFN output (`encoder_dropout`), and inside
the FFN after the activation (`encoder_dropout` for the binary model).
The hash seeds come from a CPU generator, so no device value is read back
each layer (JAX draws them on the device). Multiclass, mesh, sp, tp and
remat are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.models.layers import LN_EPS, dropout, layer_norm, linear
from snuffy_tpu_torch.ops.fused_attention import (
    fused_packed_inverted_sparse_attention,
)
from snuffy_tpu_torch.ops.init import init_linear
from snuffy_tpu_torch.ops.selection import (
    PreparedSelection,
    binary_selection_draw,
    binary_selection_prepare,
    packed_selection_draw,
    packed_selection_prepare,
)

ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "selu": F.selu,
}


def compute_dtype_of(cfg: SnuffyModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


class FCLayer(nn.Module):
    """Instance classifier (reference key `i_classifier.fc.0`)."""

    def __init__(self, feats_size: int, num_classes: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(feats_size, num_classes))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.fc(feats)


class MultiHeadedAttention(nn.Module):
    """Projections around the inverted sparse attention; `linears` are
    wq, wk, wv, wo in the reference's order."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        if d % num_heads:
            raise ValueError("feats_size must be divisible by num_heads")
        self.num_heads = num_heads
        self.linears = nn.ModuleList(nn.Linear(d, d) for _ in range(4))

    def forward(self, normed, key_tokens, slot_valid, q_valid, segments,
                dtype, dropout_rate=0.0, dropout_seed=None):
        d = normed.shape[1]
        h, dk = self.num_heads, d // self.num_heads
        wq, wk, wv, wo = self.linears

        def split_heads(t):  # (L, d) -> (h, L, dk)
            return t.reshape(t.shape[0], h, dk).transpose(0, 1).contiguous()

        qv = F.linear(
            normed.to(dtype),
            torch.cat([wq.weight, wv.weight]).to(dtype),
            torch.cat([wq.bias, wv.bias]).to(dtype),
        )
        q, v = split_heads(qv[:, :d]), split_heads(qv[:, d:])
        k = split_heads(linear(key_tokens, wk, dtype))
        out = fused_packed_inverted_sparse_attention(
            q, k, v, slot_valid, q_valid, segments,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
        )
        out = out.transpose(0, 1).reshape(out.shape[1], d)
        return linear(out, wo, dtype)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d: int, mult: int, activation: str):
        super().__init__()
        self.w_1 = nn.Linear(d, d * mult)
        self.w_2 = nn.Linear(d * mult, d)
        self.act = ACTIVATIONS[activation]

    def forward(self, x, dtype, rate=0.0, generator=None):
        hidden = dropout(self.act(linear(x, self.w_1, dtype)), rate, generator)
        return linear(hidden, self.w_2, dtype)


class SublayerConnection(nn.Module):
    """Holds the pre-norm of one residual branch (reference
    `sublayer.{0,1}.norm`); its dropout runs in `EncoderLayer`."""

    def __init__(self, d: int):
        super().__init__()
        self.norm = nn.LayerNorm(d, eps=LN_EPS)


class EncoderLayer(nn.Module):
    """Select Λ rows, attend, scatter back, FFN."""

    def __init__(self, cfg: SnuffyModelConfig):
        super().__init__()
        d = cfg.feats_size
        self.cfg = cfg
        self.self_attn = MultiHeadedAttention(d, cfg.num_heads)
        self.feed_forward = PositionwiseFeedForward(d, cfg.mlp_multiplier,
                                                    cfg.activation)
        self.sublayer = nn.ModuleList(SublayerConnection(d) for _ in range(2))

    def forward(self, x, prep: PreparedSelection, mask, segments, generator,
                seed_generator, dtype):
        n, d = x.shape
        cfg = self.cfg
        attn_rate = cfg.attention_dropout if self.training else 0.0
        enc_rate = cfg.encoder_dropout if self.training else 0.0
        seed = None
        if attn_rate > 0.0:
            seed = int(torch.randint(0, 2**31 - 1, (),
                                     generator=seed_generator))
        if segments > 1:
            sel = packed_selection_draw(generator, prep, cfg.k_rand,
                                        n // segments)
        else:
            sel = binary_selection_draw(generator, prep, cfg.k_rand)
        # Keys and the residual read the PRE-norm selected rows.
        sel_tokens = x.index_select(0, sel.indices)
        normed = layer_norm(x, self.sublayer[0].norm, dtype)
        attn = self.self_attn(normed, sel_tokens, sel.slot_valid, mask,
                              segments, dtype, attn_rate, seed)
        new_sel = sel_tokens + dropout(attn, enc_rate, generator)
        # Dead slots scatter into one extra row that is then dropped; out
        # of place, so the gradient reaches both x and new_sel.
        scatter_idx = torch.where(sel.slot_valid, sel.indices,
                                  torch.full_like(sel.indices, n))
        y = torch.cat([x, x.new_zeros(1, d)]).index_copy(
            0, scatter_idx, new_sel)[:n]
        # The binary model's FFN dropout is encoder_dropout.
        ff = self.feed_forward(layer_norm(y, self.sublayer[1].norm, dtype),
                               dtype, enc_rate, generator)
        return y + dropout(ff, enc_rate, generator)


class Encoder(nn.Module):
    def __init__(self, cfg: SnuffyModelConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.feats_size, eps=LN_EPS)

    def forward(self, x, c, mask, segments, generator, seed_generator, dtype):
        n = x.shape[0]
        c = c.detach()  # the selection passes no gradient
        if segments > 1:
            n_seg = n // segments
            prep = packed_selection_prepare(
                c[:, 0].reshape(segments, n_seg), mask.reshape(segments, n_seg),
                min(self.cfg.k_top, n_seg),
            )
        else:
            prep = binary_selection_prepare(c[:, 0], mask,
                                            min(self.cfg.k_top, n))
        for layer in self.layers:
            x = layer(x, prep, mask, segments, generator, seed_generator,
                      dtype)
        return layer_norm(x, self.norm, dtype)


class BClassifier(nn.Module):
    """Encoder → masked mean pool (f32) → linear bag head."""

    def __init__(self, cfg: SnuffyModelConfig):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.linear = nn.Linear(cfg.feats_size, cfg.num_classes)

    def forward(self, x, c, mask, segments, generator, seed_generator,
                dtype):
        enc = self.encoder(x, c, mask, segments, generator, seed_generator,
                           dtype)
        k = segments
        enc_b = enc.reshape(k, enc.shape[0] // k, -1)
        mask_b = mask.reshape(k, -1)
        denom = mask_b.sum(dim=1).clamp_min(1).float()
        pooled = (enc_b * mask_b[:, :, None].to(enc.dtype)).sum(
            dim=1, dtype=torch.float32) / denom[:, None]
        bag_logits = self.linear(pooled)                  # (k, C)
        return bag_logits if segments > 1 else bag_logits[0]


class MILNet(nn.Module):
    """i_classifier + b_classifier.

    forward(feats (N, d), mask (N,) bool, segments=1, generator=None,
            seed_generator=None) →
        (ins_logits (N, C) f32, bag_logits (C,) f32 — (k, C) when packed)
    `generator` lives on the feats' device and draws the random share and,
    in training mode, the encoder dropout; `seed_generator`, a CPU
    generator, draws the attention-dropout seeds in training mode. None
    takes torch's default generator.
    """

    def __init__(self, cfg: SnuffyModelConfig, seed: int = 0):
        super().__init__()
        if cfg.multiclass:
            raise NotImplementedError(
                "multiclass Snuffy is not ported yet (ROADMAP.md Queue 1, "
                "slice 2)"
            )
        self.cfg = cfg
        self.i_classifier = FCLayer(cfg.feats_size, cfg.num_classes)
        self.b_classifier = BClassifier(cfg)
        gen = torch.Generator().manual_seed(seed)
        for name, mod in self.named_modules():
            if isinstance(mod, nn.Linear):
                init = (cfg.weight_init_i if name.startswith("i_classifier")
                        else cfg.weight_init_b)
                init_linear(mod, init, gen)

    def forward(
        self,
        feats: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        segments: int = 1,
        generator: Optional[torch.Generator] = None,
        seed_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if mask is None:
            mask = torch.ones(feats.shape[0], dtype=torch.bool,
                              device=feats.device)
        # the kernel takes a contiguous bool row mask
        mask = mask.to(device=feats.device, dtype=torch.bool).contiguous()
        dtype = compute_dtype_of(self.cfg)
        feats = feats.float() * mask[:, None].float()
        ins_logits = self.i_classifier(feats)
        bag_logits = self.b_classifier(feats.to(dtype), ins_logits, mask,
                                       segments, generator, seed_generator,
                                       dtype)
        return ins_logits, bag_logits


def build_milnet(cfg: SnuffyModelConfig, seed: int = 0,
                 device: Optional[torch.device] = None) -> MILNet:
    """Seeded MILNet in eval mode on `device`: the card unless the caller
    passes another."""
    return MILNet(cfg, seed).to(device or torch.device("cuda")).eval()
