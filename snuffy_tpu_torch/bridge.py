"""Weights between the JAX package, reference `.pth` files and the port.

  milnet_from_jax(params, cfg)  flax MILNet params → port MILNet, loaded
                                strict through the JAX package's own
                                reference exporter
  vit_from_jax(params)          flax ViT params → DINO-keyed numpy state
                                dict (the inverse of
                                snuffy_tpu/embed/torch_import.py:import_vit)
  load_reference_pth(path)      a reference/DINO `.pth` → state dict of
                                tensors, `module.`/`backbone.` stripped

Only `milnet_from_jax` touches the JAX package, and only inside the call:
its caller already holds JAX parameters.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from snuffy_tpu.configs import SnuffyModelConfig
from snuffy_tpu_torch.models.snuffy import MILNet, build_milnet


def milnet_from_jax(params: dict, cfg: SnuffyModelConfig,
                    device: Optional[torch.device] = None) -> MILNet:
    from snuffy_tpu.embed.torch_export import export_milnet

    model = build_milnet(cfg, device=device)
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in export_milnet(params).items()}
    model.load_state_dict(sd, strict=True)
    return model


def vit_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """Dense kernels (in, out) → weights (out, in); conv kernels
    (kh, kw, in, out) → (out, in, kh, kw); LayerNorm scale → weight."""
    def f32(x):
        return np.array(x, np.float32)  # a writable, contiguous copy

    sd: Dict[str, np.ndarray] = {
        "cls_token": f32(params["cls_token"]),
        "pos_embed": f32(params["pos_embed"]),
        "patch_embed.proj.weight": f32(np.transpose(
            params["patch_embed"]["proj"]["kernel"], (3, 2, 0, 1))),
        "patch_embed.proj.bias": f32(params["patch_embed"]["proj"]["bias"]),
        "norm.weight": f32(params["norm"]["scale"]),
        "norm.bias": f32(params["norm"]["bias"]),
    }
    depth = sum(1 for k in params if k.startswith("blocks_"))
    for i in range(depth):
        blk, pre = params[f"blocks_{i}"], f"blocks.{i}"
        for ln in ("norm1", "norm2"):
            sd[f"{pre}.{ln}.weight"] = f32(blk[ln]["scale"])
            sd[f"{pre}.{ln}.bias"] = f32(blk[ln]["bias"])
        for path, key in ((("attn", "qkv"), "attn.qkv"),
                          (("attn", "proj"), "attn.proj"),
                          (("mlp", "fc1"), "mlp.fc1"),
                          (("mlp", "fc2"), "mlp.fc2")):
            dense = blk[path[0]][path[1]]
            sd[f"{pre}.{key}.weight"] = f32(np.asarray(dense["kernel"]).T)
            if "bias" in dense:
                sd[f"{pre}.{key}.bias"] = f32(dense["bias"])
    return sd


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """Load a state dict on the CPU, unwrapping a 'state_dict', 'model' or
    'teacher' container as the reference loaders do, and strip `module.`
    and `backbone.` prefixes."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for container in ("state_dict", "model", "teacher"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(container), dict):
            ckpt = ckpt[container]
            break
    out = {}
    for k, v in ckpt.items():
        if not isinstance(v, torch.Tensor):
            continue
        for prefix in ("module.", "backbone."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        out[k] = v
    return out
