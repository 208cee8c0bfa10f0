"""Plain float32 ViT (DINO ViT-S/16, Caron et al. 2021, arXiv:2104.14294).

Pre-norm blocks: x + attn(LN(x)), then x + MLP(LN(x)) with exact GELU;
the class token's final LayerNorm is the embedding. Images come as uint8
(B, H, W, 3) and are scaled to [0, 1]; the patch projection is the
stride-p convolution written as one product over (channel, row, column)
patches. Parameter names are the DINO/timm ones under `backbone.`, with
the linear instance head `head.` beside them.
"""

from __future__ import annotations

import torch

from benchmark.reference.common import dense, identity, layer_norm


def param_spec(e: dict):
    """[(name, shape, kind)] of the embedder `e` (a config's `embedder`)."""
    d, p = e["dim"], e["patch"]
    hidden = d * e["mlp_ratio"]
    n_tok = 1 + (e["img_size"] // p) ** 2
    spec = [("backbone.cls_token", (1, 1, d), "token"),
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
                 (b + "norm2.weight", (d,), "ln_weight"),
                 (b + "norm2.bias", (d,), "bias"),
                 (b + "mlp.fc1.weight", (hidden, d), "weight"),
                 (b + "mlp.fc1.bias", (hidden,), "bias"),
                 (b + "mlp.fc2.weight", (d, hidden), "weight"),
                 (b + "mlp.fc2.bias", (d,), "bias")]
    spec += [("backbone.norm.weight", (d,), "ln_weight"),
             ("backbone.norm.bias", (d,), "bias"),
             ("head.weight", (e["num_classes"], d), "weight"),
             ("head.bias", (e["num_classes"],), "bias")]
    return spec


def embed(w: dict, images: torch.Tensor, e: dict, q=identity) -> torch.Tensor:
    """uint8 (B, H, W, 3) → (B, dim) float32 class-token embeddings."""
    x = images.float() / 255.0
    b, hh, ww, c = x.shape
    p, d, heads = e["patch"], e["dim"], e["heads"]
    gh, gw = hh // p, ww // p
    x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
    x = x.reshape(b, gh * gw, c * p * p)
    x = dense(x, w["backbone.patch_embed.proj.weight"].reshape(d, -1),
              w["backbone.patch_embed.proj.bias"], q)
    x = torch.cat([w["backbone.cls_token"].expand(b, -1, -1), x], dim=1)
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
        x = x + dense(attn, w[pre + "attn.proj.weight"],
                      w[pre + "attn.proj.bias"], q)
        h = layer_norm(x, w[pre + "norm2.weight"], w[pre + "norm2.bias"])
        h = torch.nn.functional.gelu(
            dense(h, w[pre + "mlp.fc1.weight"], w[pre + "mlp.fc1.bias"], q))
        x = x + dense(h, w[pre + "mlp.fc2.weight"], w[pre + "mlp.fc2.bias"], q)
    return layer_norm(x[:, 0], w["backbone.norm.weight"],
                      w["backbone.norm.bias"])
