"""Plain float32 Virchow2 tile embedder (Zimmermann et al. 2024,
arXiv:2408.13985; huggingface.co/paige-ai/Virchow2, its model card and
config.json: timm `vit_huge_patch14_224`, `reg_tokens` 4, `mlp_ratio`
5.3375, `init_values` 1e-5, `mlp_layer` SwiGLUPacked with SiLU,
`global_pool` "").

Images come as uint8 (B, H, W, 3), are scaled to [0, 1] and normalised by
ImageNet's mean and std. The patch projection is the stride-14 convolution
written as one product over (channel, row, column) patches. The sequence
is [class, 4 registers, patches] plus the position table; pre-norm blocks
with LayerNorm eps 1e-6 and qkv bias:

  x ← x + γ₁ ⊙ proj(softmax(q·kᵀ/√80)·v), q, k, v = qkv(LN₁(x))
  x ← x + γ₂ ⊙ fc2(SiLU(a) ⊙ b),  [a | b] = fc1(LN₂(x)) split in halves

and the embedding is [LN(x)₀ | mean of LN(x) over the patch tokens], the
registers left out (2 · dim wide). Parameter names are timm's under
`backbone.`, with the linear instance head `head.` beside them.

Departures from the published model:
  * γ₁, γ₂ are drawn as the benchmark's LayerNorm scales (1 ± 0.1), not
    the published init 1e-5, which would make every seeded random branch
    vanish and leave the check blind to the blocks;
  * the position table has a row for the class token, each register and
    each patch (timm's default `no_embed_class=False`: concatenate, then
    add), 1 + 4 + 256 rows at 224²; the published checkpoint's shape
    decides this, and it is not in the repository.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.common import dense, identity, layer_norm

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def hidden(e: dict) -> int:
    """fc1's width (both halves): int(dim · mlp_ratio), timm's rule."""
    return int(e["dim"] * e["mlp_ratio"])


def param_spec(e: dict):
    """[(name, shape, kind)] of the embedder `e` (a config's `embedder`)."""
    d, p, h = e["dim"], e["patch"], hidden(e)
    n_tok = 1 + e["reg_tokens"] + (e["img_size"] // p) ** 2
    spec = [("backbone.cls_token", (1, 1, d), "token"),
            ("backbone.reg_token", (1, e["reg_tokens"], d), "token"),
            ("backbone.pos_embed", (1, n_tok, d), "token"),
            ("backbone.patch_embed.proj.weight", (d, 3, p, p), "weight"),
            ("backbone.patch_embed.proj.bias", (d,), "bias")]
    for i in range(e["depth"]):
        b = f"backbone.blocks.{i}."
        spec += [(b + "norm1.weight", (d,), "ln_weight"),
                 (b + "norm1.bias", (d,), "bias"),
                 (b + "attn.qkv.weight", (3 * d, d), "weight"),
                 (b + "attn.qkv.bias", (3 * d,), "bias"),
                 (b + "attn.proj.weight", (d, d), "weight"),
                 (b + "attn.proj.bias", (d,), "bias"),
                 (b + "ls1.gamma", (d,), "ln_weight"),
                 (b + "norm2.weight", (d,), "ln_weight"),
                 (b + "norm2.bias", (d,), "bias"),
                 (b + "mlp.fc1.weight", (h, d), "weight"),
                 (b + "mlp.fc1.bias", (h,), "bias"),
                 (b + "mlp.fc2.weight", (d, h // 2), "weight"),
                 (b + "mlp.fc2.bias", (d,), "bias"),
                 (b + "ls2.gamma", (d,), "ln_weight")]
    spec += [("backbone.norm.weight", (d,), "ln_weight"),
             ("backbone.norm.bias", (d,), "bias"),
             ("head.weight", (e["num_classes"], 2 * d), "weight"),
             ("head.bias", (e["num_classes"],), "bias")]
    return spec


def embed(w: dict, images: torch.Tensor, e: dict, q=identity) -> torch.Tensor:
    """uint8 (B, H, W, 3) → (B, 2·dim) float32 class-plus-mean
    embeddings."""
    x = images.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    x = (x - mean) / std
    b, hh, ww, c = x.shape
    p, d, heads = e["patch"], e["dim"], e["heads"]
    gh, gw = hh // p, ww // p
    x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
    x = x.reshape(b, gh * gw, c * p * p)
    x = dense(x, w["backbone.patch_embed.proj.weight"].reshape(d, -1),
              w["backbone.patch_embed.proj.bias"], q)
    x = torch.cat([w["backbone.cls_token"].expand(b, -1, -1),
                   w["backbone.reg_token"].expand(b, -1, -1), x], dim=1)
    x = x + w["backbone.pos_embed"]
    n, dk = x.shape[1], d // heads
    for i in range(e["depth"]):
        pre = f"backbone.blocks.{i}."
        h = layer_norm(x, w[pre + "norm1.weight"], w[pre + "norm1.bias"])
        qkv = dense(h, w[pre + "attn.qkv.weight"], w[pre + "attn.qkv.bias"], q)
        qh, kh, vh = qkv.reshape(b, n, 3, heads, dk).permute(2, 0, 3, 1, 4)
        scores = torch.matmul(q(qh), q(kh).transpose(-1, -2)) * dk ** -0.5
        attn = torch.matmul(q(torch.softmax(scores, dim=-1)), q(vh))
        attn = attn.transpose(1, 2).reshape(b, n, d)
        x = x + w[pre + "ls1.gamma"] * dense(
            attn, w[pre + "attn.proj.weight"], w[pre + "attn.proj.bias"], q)
        h = layer_norm(x, w[pre + "norm2.weight"], w[pre + "norm2.bias"])
        a, g = dense(h, w[pre + "mlp.fc1.weight"], w[pre + "mlp.fc1.bias"],
                     q).chunk(2, dim=-1)
        x = x + w[pre + "ls2.gamma"] * dense(
            F.silu(a) * g, w[pre + "mlp.fc2.weight"], w[pre + "mlp.fc2.bias"],
            q)
    y = layer_norm(x, w["backbone.norm.weight"], w["backbone.norm.bias"])
    return torch.cat([y[:, 0], y[:, 1 + e["reg_tokens"]:].mean(dim=1)],
                     dim=-1)
