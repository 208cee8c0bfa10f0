"""Weights between the JAX package, reference `.pth` files and the port.

  milnet_from_jax(params, cfg)  flax MILNet params → port MILNet, loaded
                                strict through `milnet_state_dict`
  milnet_state_dict(params)     flax MILNet params → reference-keyed numpy
                                state dict (the map of
                                snuffy_tpu/embed/torch_export.py:28-59)
  vit_from_jax(params)          flax ViT params (± adapter) → DINO-keyed
                                numpy state dict (the inverse of
                                snuffy_tpu/embed/torch_import.py:import_vit)
  load_reference_pth(path)      a reference/DINO `.pth` → state dict of
                                tensors, `module.`/`backbone.` stripped
  load_vit_weights(model, path) a DINO(-adapter) `.pth` onto a port ViT,
                                not strict, with the matched/mismatched
                                audit of the root compute_feats.py

A parameter tree is nested dicts of arrays: numpy arrays, or any array
that converts with `np.asarray`. Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.models.snuffy import MILNet, build_milnet


def _f32(x) -> np.ndarray:
    return np.array(x, np.float32)  # a writable, contiguous copy


def milnet_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """flax MILNet tree → reference `.pth` names (reference snuffy.py's
    module tree); kernels (in, out) become weights (out, in)."""
    def dense(tree, name):
        sd[f"{name}.weight"] = _f32(np.asarray(tree["kernel"]).T)
        sd[f"{name}.bias"] = _f32(tree["bias"])

    def norm(tree, name):
        sd[f"{name}.weight"] = _f32(tree["scale"])
        sd[f"{name}.bias"] = _f32(tree["bias"])

    sd: Dict[str, np.ndarray] = {}
    dense(params["i_classifier"]["fc"], "i_classifier.fc.0")
    bc = params["b_classifier"]
    enc = bc["encoder"]
    depth = sum(1 for k in enc if k.startswith("layer_"))
    for i in range(depth):
        layer, pre = enc[f"layer_{i}"], f"b_classifier.encoder.layers.{i}"
        for j, nm in enumerate(("wq", "wk", "wv", "wo")):
            dense(layer["attn"][nm], f"{pre}.self_attn.linears.{j}")
        dense(layer["ff"]["w1"], f"{pre}.feed_forward.w_1")
        dense(layer["ff"]["w2"], f"{pre}.feed_forward.w_2")
        norm(layer["ln_attn"], f"{pre}.sublayer.0.norm")
        norm(layer["ln_ff"], f"{pre}.sublayer.1.norm")
    norm(enc["ln_final"], "b_classifier.encoder.norm")
    dense(bc["linear"], "b_classifier.linear")
    return sd


def milnet_from_jax(params: dict, cfg: SnuffyModelConfig,
                    device: Optional[torch.device] = None) -> MILNet:
    """A port MILNet in eval mode on `device` (the card unless the caller
    passes another) holding the flax parameters."""
    model = build_milnet(cfg, device=device)
    sd = {k: torch.from_numpy(v) for k, v in milnet_state_dict(params).items()}
    model.load_state_dict(sd, strict=True)
    return model


def vit_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """Dense kernels (in, out) → weights (out, in); conv kernels
    (kh, kw, in, out) → (out, in, kh, kw); LayerNorm scale → weight."""
    sd: Dict[str, np.ndarray] = {
        "cls_token": _f32(params["cls_token"]),
        "pos_embed": _f32(params["pos_embed"]),
        "patch_embed.proj.weight": _f32(np.transpose(
            params["patch_embed"]["proj"]["kernel"], (3, 2, 0, 1))),
        "patch_embed.proj.bias": _f32(params["patch_embed"]["proj"]["bias"]),
        "norm.weight": _f32(params["norm"]["scale"]),
        "norm.bias": _f32(params["norm"]["bias"]),
    }
    depth = sum(1 for k in params if k.startswith("blocks_"))
    for i in range(depth):
        blk, pre = params[f"blocks_{i}"], f"blocks.{i}"
        for ln in ("norm1", "norm2"):
            sd[f"{pre}.{ln}.weight"] = _f32(blk[ln]["scale"])
            sd[f"{pre}.{ln}.bias"] = _f32(blk[ln]["bias"])
        for path, key in ((("attn", "qkv"), "attn.qkv"),
                          (("attn", "proj"), "attn.proj"),
                          (("mlp", "fc1"), "mlp.fc1"),
                          (("mlp", "fc2"), "mlp.fc2")):
            dense = blk[path[0]][path[1]]
            sd[f"{pre}.{key}.weight"] = _f32(np.asarray(dense["kernel"]).T)
            if "bias" in dense:
                sd[f"{pre}.{key}.bias"] = _f32(dense["bias"])
        if "adaptmlp" in blk:
            ad, apre = blk["adaptmlp"], f"{pre}.adaptmlp"
            for name, key in (("down", "down_proj"), ("up", "up_proj")):
                sd[f"{apre}.{key}.weight"] = _f32(
                    np.asarray(ad[name]["kernel"]).T)
                sd[f"{apre}.{key}.bias"] = _f32(ad[name]["bias"])
            if "scale" in ad:
                sd[f"{apre}.scale"] = _f32(ad["scale"])
            if "ln" in ad:
                sd[f"{apre}.adapter_layer_norm_before.weight"] = _f32(
                    ad["ln"]["scale"])
                sd[f"{apre}.adapter_layer_norm_before.bias"] = _f32(
                    ad["ln"]["bias"])
    return sd


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """Load a state dict on the CPU, unwrapping a 'state_dict', 'model' or
    'teacher' container as the reference loaders do, and strip `module.`
    and `backbone.` prefixes. The load stays `weights_only`, with
    `argparse.Namespace` allowed: a DINO training checkpoint stores its
    arguments as one beside `teacher` and `student`."""
    with torch.serialization.safe_globals([argparse.Namespace]):
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


def load_vit_weights(model: torch.nn.Module, path: str
                     ) -> Tuple[List[str], List[str]]:
    """Overlay a DINO(-adapter) `.pth` onto `model` as the root
    compute_feats.py does (import_vit + check_layers + merge_into): every
    parameter whose name and shape the checkpoint holds is copied, the rest
    (adapter keys absent from a plain DINO checkpoint, say) keep their
    init. Prints the audit and returns (matched, mismatched) names."""
    sd = load_reference_pth(path)
    own = model.state_dict()
    matched = [k for k, v in own.items()
               if k in sd and tuple(sd[k].shape) == tuple(v.shape)]
    mismatched = [k for k in own if k not in matched]
    print(f"layer audit: {len(matched)} matched, {len(mismatched)} "
          f"missing/mismatched, {len(set(sd) - set(own))} unused in "
          f"{path}")
    for k in mismatched:
        have = tuple(sd[k].shape) if k in sd else "absent"
        print(f"  missing: {k} (model {tuple(own[k].shape)}, "
              f"checkpoint {have})")
    model.load_state_dict({k: sd[k] for k in matched}, strict=False)
    return matched, mismatched
