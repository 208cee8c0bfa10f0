"""Weights between the JAX package, reference `.pth` files and the port.

  milnet_from_jax(params, cfg)  flax MILNet params → port MILNet, loaded
                                strict through `milnet_state_dict`
  milnet_state_dict(params)     flax MILNet params → reference-keyed numpy
                                state dict (the map of
                                snuffy_tpu/embed/torch_export.py:28-59)
  dsmil_from_jax(params, ...)   flax DSMIL MILNet params → port DSMIL
                                MILNet, loaded strict through
                                `dsmil_state_dict` (the reference names)
  vit_from_jax(params)          flax ViT params (± adapter) → DINO-keyed
                                numpy state dict (the inverse of
                                snuffy_tpu/embed/torch_import.py:import_vit)
  resnet_from_jax(params)       flax ResNet18/50 params → torchvision-keyed
                                numpy state dict
  mae_from_jax(params)          flax MAE params → MAE-keyed numpy state
                                dict of the encoder
  mae_pretrain_from_jax(params) the same with `mask_token` and the decoder
                                (a `with_decoder` model's state dict)
  dino_head_state_dict(params)  flax DINOHead params (+ batch stats) →
                                the reference's DINOHead names
  dino_from_jax(state)          a JAX `DINOState`'s student and teacher
                                (backbone + head, BN stats) and centre →
                                `MultiCropWrapper` state dicts
  load_reference_pth(path)      a reference/DINO `.pth` → state dict of
                                tensors, `module.`/`backbone.` stripped
  load_vit_weights(model, path) a DINO(-adapter) `.pth` onto a port ViT,
                                not strict, with the matched/mismatched
                                audit of the root compute_feats.py

A parameter tree is nested dicts of arrays: numpy arrays, or any array
that converts with `np.asarray`. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.embed import torch_import
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


def dsmil_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """flax DSMIL MILNet tree → the reference dsmil.py names: q1/q2 →
    `b_classifier.q.0`/`.q.2` (`b_classifier.q` without q2), v →
    `b_classifier.v.1`, the Conv1d kernel (C, C, V) as it is."""
    def dense(tree, name):
        sd[f"{name}.weight"] = _f32(np.asarray(tree["kernel"]).T)
        sd[f"{name}.bias"] = _f32(tree["bias"])

    sd: Dict[str, np.ndarray] = {}
    dense(params["i_classifier"]["fc"], "i_classifier.fc.0")
    bc = params["b_classifier"]
    if "q2" in bc:
        dense(bc["q1"], "b_classifier.q.0")
        dense(bc["q2"], "b_classifier.q.2")
    else:
        dense(bc["q1"], "b_classifier.q")
    if "v" in bc:
        dense(bc["v"], "b_classifier.v.1")
    sd["b_classifier.fcc.weight"] = _f32(bc["fcc_kernel"])
    sd["b_classifier.fcc.bias"] = _f32(bc["fcc_bias"])
    return sd


def dsmil_from_jax(params: dict, feats_size: int, num_classes: int = 1,
                   nonlinear: bool = True, passing_v: bool = False,
                   device: Optional[torch.device] = None):
    """A port DSMIL MILNet in eval mode on `device` (the card unless the
    caller passes another) holding the flax parameters."""
    from snuffy_tpu_torch.models.dsmil import MILNet as DsmilNet

    model = DsmilNet(feats_size, num_classes, nonlinear=nonlinear,
                     passing_v=passing_v)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           dsmil_state_dict(params).items()}, strict=True)
    return model.to(device or torch.device("cuda")).eval()


def _dense(sd: Dict[str, np.ndarray], tree: dict, name: str) -> None:
    sd[f"{name}.weight"] = _f32(np.asarray(tree["kernel"]).T)
    sd[f"{name}.bias"] = _f32(tree["bias"])


def _vit_blocks(sd: Dict[str, np.ndarray], params: dict,
                stack: str = "blocks") -> None:
    """The flax `{stack}_{i}` Blocks → `{stack}.{i}.*`."""
    depth = sum(1 for k in params if k.startswith(f"{stack}_"))
    for i in range(depth):
        blk, pre = params[f"{stack}_{i}"], f"{stack}.{i}"
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


def _conv_weight(kernel) -> np.ndarray:
    """flax conv kernel (kh, kw, in, out) → weight (out, in, kh, kw)."""
    return _f32(np.transpose(kernel, (3, 2, 0, 1)))


def vit_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """Dense kernels (in, out) → weights (out, in); conv kernels
    (kh, kw, in, out) → (out, in, kh, kw); LayerNorm scale → weight."""
    sd: Dict[str, np.ndarray] = {
        "cls_token": _f32(params["cls_token"]),
        "pos_embed": _f32(params["pos_embed"]),
        "patch_embed.proj.weight": _conv_weight(
            params["patch_embed"]["proj"]["kernel"]),
        "patch_embed.proj.bias": _f32(params["patch_embed"]["proj"]["bias"]),
        "norm.weight": _f32(params["norm"]["scale"]),
        "norm.bias": _f32(params["norm"]["bias"]),
    }
    _vit_blocks(sd, params)
    return sd


def mae_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """The MAE encoder's tensors under the MAE checkpoint's names, by
    `vit_from_jax`'s map; the decoder, `mask_token` and the fixed sin-cos
    grid (no parameter in either framework) are left out."""
    sd: Dict[str, np.ndarray] = {
        "cls_token": _f32(params["cls_token"]),
        "patch_embed.proj.weight": _conv_weight(
            params["patch_embed"]["proj"]["kernel"]),
        "patch_embed.proj.bias": _f32(params["patch_embed"]["proj"]["bias"]),
        "norm.weight": _f32(params["norm"]["scale"]),
        "norm.bias": _f32(params["norm"]["bias"]),
    }
    _vit_blocks(sd, params)
    return sd


def mae_pretrain_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """A flax MAE's tensors, the decoder's included, under the MAE
    checkpoint's names: `mae_from_jax`'s encoder, `mask_token`,
    `decoder_embed`, `decoder_blocks_i` → `decoder_blocks.i`,
    `decoder_norm` and `decoder_pred`."""
    sd = mae_from_jax(params)
    sd["mask_token"] = _f32(params["mask_token"])
    _dense(sd, params["decoder_embed"], "decoder_embed")
    _vit_blocks(sd, params, "decoder_blocks")
    sd["decoder_norm.weight"] = _f32(params["decoder_norm"]["scale"])
    sd["decoder_norm.bias"] = _f32(params["decoder_norm"]["bias"])
    _dense(sd, params["decoder_pred"], "decoder_pred")
    return sd


_HEAD_LINEARS = {False: (0, 2, 4), True: (0, 3, 6)}


def dino_head_state_dict(params: dict, bn_stats: Optional[dict] = None
                         ) -> Dict[str, np.ndarray]:
    """flax DINOHead params → the port's (the reference's) names:
    `mlp_i` → `mlp.{0,2,4}` (with BatchNorm `mlp.{0,3,6}`, `bn_i` →
    `mlp.{1,4}` with `bn_stats`' mean/var as the running statistics),
    `last_layer_v` (in, out) → `last_layer.weight_v` (out, in),
    `last_layer_g` (out,) → `last_layer.weight_g` (out, 1), ones where the
    head has no g (`norm_last_layer`)."""
    use_bn = "bn_0" in params
    sd: Dict[str, np.ndarray] = {}
    for i, idx in enumerate(_HEAD_LINEARS[use_bn]):
        sd[f"mlp.{idx}.weight"] = _f32(np.asarray(
            params[f"mlp_{i}"]["kernel"]).T)
        sd[f"mlp.{idx}.bias"] = _f32(params[f"mlp_{i}"]["bias"])
    if use_bn:
        for i, idx in enumerate((1, 4)):
            bn, stats = params[f"bn_{i}"], (bn_stats or {}).get(f"bn_{i}", {})
            sd[f"mlp.{idx}.weight"] = _f32(bn["scale"])
            sd[f"mlp.{idx}.bias"] = _f32(bn["bias"])
            width = sd[f"mlp.{idx}.weight"].shape[0]
            sd[f"mlp.{idx}.running_mean"] = _f32(
                stats.get("mean", np.zeros(width)))
            sd[f"mlp.{idx}.running_var"] = _f32(
                stats.get("var", np.ones(width)))
            sd[f"mlp.{idx}.num_batches_tracked"] = np.array(0, np.int64)
    v = _f32(np.asarray(params["last_layer_v"]).T)
    sd["last_layer.weight_v"] = v
    g = params.get("last_layer_g")
    sd["last_layer.weight_g"] = (_f32(np.asarray(g).reshape(-1, 1))
                                 if g is not None
                                 else np.ones((v.shape[0], 1), np.float32))
    return sd


def dino_student_state_dict(tree: dict, bn_stats: Optional[dict] = None
                            ) -> Dict[str, np.ndarray]:
    """{'backbone': flax ViT, 'head': flax DINOHead} → a
    `MultiCropWrapper`'s names (`backbone.*` by `vit_from_jax`, `head.*`
    by `dino_head_state_dict`)."""
    sd = {f"backbone.{k}": v for k, v in vit_from_jax(tree["backbone"])
          .items()}
    sd.update({f"head.{k}": v for k, v in
               dino_head_state_dict(tree["head"], bn_stats).items()})
    return sd


def dino_from_jax(state) -> Dict[str, object]:
    """A JAX `DINOState` (or a mapping with its fields) → {'student': sd,
    'teacher': sd, 'center': (1, out_dim) f32}: numpy state dicts that
    load strictly into the port's student and teacher
    (`ssl.dino.MultiCropWrapper`), BatchNorm running statistics from
    `bn_stats`."""
    get = (state.get if isinstance(state, dict)
           else lambda k, d=None: getattr(state, k, d))
    bn = get("bn_stats") or {}
    return {
        "student": dino_student_state_dict(get("student"),
                                           bn.get("student")),
        "teacher": dino_student_state_dict(get("teacher"),
                                           bn.get("teacher")),
        "center": _f32(get("center")),
    }


def resnet_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """flax ResNet18/ResNet50 params → torchvision names: `layer{i}_{j}`
    → `layer{i}.{j}`, `downsample_conv`/`downsample_bn` →
    `downsample.0`/`.1`, conv kernels (kh, kw, in, out) → (out, in, kh,
    kw), FrozenBatchNorm's scale/bias/mean/var → weight/bias/running_mean/
    running_var (InstanceNorm has none)."""
    bn = {"scale": "weight", "bias": "bias", "mean": "running_mean",
          "var": "running_var"}

    def module(tree: dict, name: str) -> None:
        if "kernel" in tree:
            sd[f"{name}.weight"] = _conv_weight(tree["kernel"])
        else:
            for k, v in tree.items():
                sd[f"{name}.{bn[k]}"] = _f32(v)

    sd: Dict[str, np.ndarray] = {}
    for top, tree in params.items():
        if not top.startswith("layer"):
            module(tree, top)
            continue
        name = top.replace("_", ".")
        for sub, leaf in tree.items():
            sub = {"downsample_conv": "downsample.0",
                   "downsample_bn": "downsample.1"}.get(sub, sub)
            module(leaf, f"{name}.{sub}")
    return sd


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """Load a state dict on the CPU, unwrapping a 'state_dict', 'model' or
    'teacher' container as the reference loaders do, and strip `module.`
    and `backbone.` prefixes (`embed.torch_import`; still `weights_only`,
    with `argparse.Namespace` allowed for a DINO training checkpoint's
    arguments)."""
    return torch_import.strip_prefixes(
        torch_import.load_torch_state_dict(path))


def load_vit_weights(model: torch.nn.Module, path: str
                     ) -> Tuple[List[str], List[str]]:
    """Overlay a DINO(-adapter) `.pth` onto `model` as the root
    compute_feats.py does (import_vit + check_layers + merge_into): every
    parameter whose name and shape the checkpoint holds is copied, the rest
    (adapter keys absent from a plain DINO checkpoint, say) keep their
    init. Prints the audit and returns (matched, mismatched) names."""
    return torch_import.load_embedder_weights(model, path, "DINO",
                                              "vit_small")
