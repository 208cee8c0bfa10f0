"""PyTorch `.pth` checkpoints → state dicts under the port's names.

Port of `snuffy_tpu/embed/torch_import.py` (the reference's per-embedder
loading, reference compute_feats.py:449-518: container unwrapping, prefix
stripping, the `check_layers` audit, positional re-zipping for the
DSMIL-SimCLR weights). The port's modules carry the checkpoints' own
names (torchvision's for the ResNets, DINO's/timm's for the ViT, MAE's for
the MAE encoder), so each importer selects and renames nothing: it keeps
the tensors its model family takes. `merge_into` overlays them onto a
model non-strictly, as the JAX `merge_into` overlays a flax tree: what the
checkpoint lacks keeps its initial value.

Loading stays `weights_only`, with `argparse.Namespace` allowed: a DINO
training checkpoint stores its arguments as one beside `teacher`. A full
DINO training checkpoint (student and teacher, backbone and head) loads
through `load_torch_full_checkpoint` and `import_dino_student_teacher`,
the head filtered by `import_dino_head` as the reference filters it. MAE
pretraining's `--finetune` takes the decoder too (`import_mae_pretrain`);
extraction's `import_mae` keeps to the encoder.
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, List, Tuple

import torch
from torch import nn

from snuffy_tpu_torch.utils.tables import print_layer_audit

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> StateDict:
    """Load on the CPU and unwrap a 'state_dict', 'model' or 'teacher'
    container as the reference loaders do; keep the tensors."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for container in ("state_dict", "model", "teacher"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(container), dict):
            ckpt = ckpt[container]
            break
    return {k: v for k, v in ckpt.items() if isinstance(v, torch.Tensor)}


def strip_prefixes(sd: StateDict, prefixes=("module.", "backbone.")
                   ) -> StateDict:
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def _depth(sd: StateDict, stack: str) -> int:
    return 1 + max(int(m.group(1)) for k in sd
                   if (m := re.match(rf"{stack}\.(\d+)\.", k)))


def _take(sd: StateDict, names) -> StateDict:
    return {k: sd[k] for k in names if k in sd}


_VIT_BLOCK = ("norm1.weight", "norm1.bias", "attn.qkv.weight",
              "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
              "ls1.gamma", "norm2.weight", "norm2.bias", "mlp.fc1.weight",
              "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias", "ls2.gamma",
              "adaptmlp.down_proj.weight", "adaptmlp.down_proj.bias",
              "adaptmlp.up_proj.weight", "adaptmlp.up_proj.bias",
              "adaptmlp.scale", "adaptmlp.adapter_layer_norm_before.weight",
              "adaptmlp.adapter_layer_norm_before.bias")
_PATCH = ("patch_embed.proj.weight", "patch_embed.proj.bias")
_NORM = ("norm.weight", "norm.bias")


def _blocks(sd: StateDict, stack: str = "blocks") -> list:
    if not any(k.startswith(f"{stack}.") for k in sd):
        return []
    return [f"{stack}.{i}.{n}" for i in range(_depth(sd, stack))
            for n in _VIT_BLOCK]


def import_vit(sd: StateDict) -> StateDict:
    """DINO-style ViT (± adapter), or timm's Virchow2 (registers,
    LayerScale) → the port's `VisionTransformer`."""
    sd = strip_prefixes(sd)
    return _take(sd, ("cls_token", "reg_token", "pos_embed", *_PATCH,
                      *_blocks(sd), *_NORM))


def import_mae(sd: StateDict) -> StateDict:
    """MAE (± adapter) → the port's `MaskedAutoencoderViT`: the encoder.
    The decoder, `mask_token` and the fixed sin-cos grids are not taken
    (the reference deletes the decoder for extraction,
    compute_feats.py:344)."""
    sd = strip_prefixes(sd)
    return _take(sd, ("cls_token", *_PATCH, *_blocks(sd), *_NORM))


def import_mae_pretrain(sd: StateDict) -> StateDict:
    """MAE (± adapter) → the port's `MaskedAutoencoderViT` built
    `with_decoder`: the encoder and, where the checkpoint has them,
    `mask_token`, `decoder_embed`, the decoder blocks, `decoder_norm` and
    `decoder_pred` (the JAX `import_mae`, which pretraining's
    `--finetune` uses). The fixed sin-cos grids are not taken."""
    sd = strip_prefixes(sd)
    return _take(sd, ("cls_token", *_PATCH, *_blocks(sd), *_NORM,
                      "mask_token", "decoder_embed.weight",
                      "decoder_embed.bias", *_blocks(sd, "decoder_blocks"),
                      "decoder_norm.weight", "decoder_norm.bias",
                      "decoder_pred.weight", "decoder_pred.bias"))


_BN = ("weight", "bias", "running_mean", "running_var")


def _resnet(sd: StateDict, blocks, convs, norm: str) -> StateDict:
    """torchvision resnet names: the convs always, the BatchNorms' weight,
    bias and running stats with `norm="batch"` (InstanceNorm has none); a
    block's downsample norm only with its conv, as JAX takes them."""
    sd = strip_prefixes(sd)
    conv_names, bn_names = ["conv1"], ["bn1"]
    for li, count in enumerate(blocks, start=1):
        for bi in range(count):
            tp = f"layer{li}.{bi}"
            conv_names += [f"{tp}.{c}" for c in convs]
            bn_names += [f"{tp}.bn{j}" for j in range(1, len(convs) + 1)]
            if f"{tp}.downsample.0.weight" in sd:
                conv_names.append(f"{tp}.downsample.0")
                bn_names.append(f"{tp}.downsample.1")
    names = [f"{c}.weight" for c in conv_names]
    if norm == "batch":
        names += [f"{bn}.{p}" for bn in bn_names for p in _BN]
    return _take(sd, names)


def import_resnet18(sd: StateDict, norm: str = "instance") -> StateDict:
    """torchvision resnet18 → the port's `ResNet18`."""
    return _resnet(sd, (2, 2, 2, 2), ("conv1", "conv2"), norm)


def import_resnet50(sd: StateDict) -> StateDict:
    """torchvision resnet50 (the DINO ResNet-50 release) → the port's
    `ResNet50`, frozen BatchNorm off the running stats."""
    return _resnet(sd, (3, 4, 6, 3), ("conv1", "conv2", "conv3"), "batch")


def positional_rezip(sd: StateDict, template: StateDict) -> StateDict:
    """DSMIL-SimCLR weights ship under foreign key names; the reference
    re-zips values onto the target model's key order positionally
    (compute_feats.py:493-518). Shapes must match pairwise."""
    values = list(sd.values())
    keys = list(template.keys())
    if len(values) != len(keys):
        raise ValueError(
            f"positional rezip needs equal counts: {len(values)} vs {len(keys)}"
        )
    out = {}
    for k, v in zip(keys, values):
        if tuple(template[k].shape) != tuple(v.shape):
            raise ValueError(
                f"shape mismatch at {k}: {template[k].shape} vs {v.shape}"
            )
        out[k] = v
    return out


def check_layers(imported: StateDict, target: StateDict
                 ) -> Tuple[List[str], List[str]]:
    """Shape audit (reference utils.py:352-422): the target's names, in its
    order, split into those the import holds at the same shape (matched)
    and the rest (mismatched)."""
    matched, mismatched = [], []
    for k, v in target.items():
        if k in imported and tuple(imported[k].shape) == tuple(v.shape):
            matched.append(k)
        else:
            mismatched.append(k)
    return matched, mismatched


def merge_into(model: nn.Module, imported: StateDict) -> nn.Module:
    """Copy every imported tensor whose name and shape the model holds
    (the reference's strict=False load); the rest keep their values."""
    matched, _ = check_layers(imported, model.state_dict())
    model.load_state_dict({k: imported[k] for k in matched}, strict=False)
    return model


def overlay_checkpoint(model: nn.Module, imported: StateDict,
                       checkpoint: StateDict, source: str
                       ) -> Tuple[List[str], List[str]]:
    """`check_layers` + `merge_into` with the audit printed: one summary
    line (matched, missing or mismatched, and the checkpoint's tensors the
    model does not take) and the `print_layer_audit` table. Returns
    (matched, mismatched)."""
    matched, mismatched = check_layers(imported, model.state_dict())
    unused = len(set(strip_prefixes(checkpoint)) - set(matched))
    print(f"layer audit: {len(matched)} matched, {len(mismatched)} "
          f"missing/mismatched, {unused} unused in {source}")
    print_layer_audit(matched, mismatched)
    merge_into(model, imported)
    return matched, mismatched


def load_embedder_weights(model: nn.Module, path: str, embedder: str,
                          backbone: str, norm_layer: str = "instance"
                          ) -> Tuple[List[str], List[str]]:
    """A `.pth` onto an embedder's backbone, the importer picked by the
    family the flags name, in the root compute_feats.py's order
    (`build_and_load_embedder`): resnet18, else MAE, else a DINO ViT."""
    sd = load_torch_state_dict(path)
    if backbone == "resnet18":
        imported = import_resnet18(sd, norm_layer)
    elif embedder.upper() == "MAE":
        imported = import_mae(sd)
    else:
        imported = import_vit(sd)
    return overlay_checkpoint(model, imported, sd, path)


def load_torch_full_checkpoint(path: str) -> Dict[str, StateDict]:
    """A full DINO training checkpoint {'student': sd, 'teacher': sd, ...}
    → {'student': sd, 'teacher': sd} of tensors (reference
    dino_adapter/main_dino_adapter.py:239-243). Parts absent from the
    file are absent from the result, so a plain backbone `.pth` gives {}."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for part in ("student", "teacher"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(part), dict):
            out[part] = {k: v for k, v in ckpt[part].items()
                         if isinstance(v, torch.Tensor)}
    return out


# DINOHead Sequential indices by role: the three Linears, and with
# use_bn_in_head the two BatchNorms (GELUs between; reference
# dino_adapter/vision_transformer_with_adapter.py:287-297).
_HEAD_LINEARS = {False: (0, 2, 4), True: (0, 3, 6)}
_HEAD_NORMS = (1, 4)


def import_dino_head(sd: StateDict, template: StateDict,
                     random_head: bool = False,
                     norm_last_layer: bool = True) -> StateDict:
    """DINOHead tensors ('head.' stripped) → those of a head whose state
    dict is `template`, with the reference's full-checkpoint filtering
    (main_dino_adapter.py:246-305), as the JAX `import_dino_head`:

      * a tensor whose shape disagrees with the template's (another
        out_dim, say) is dropped, and everything with `random_head`;
        dropped tensors keep the model's values;
      * the Linears and BatchNorm scales map by role between the plain
        (`mlp.{0,2,4}`) and BatchNorm (`mlp.{0,3,6}`, `mlp.{1,4}`)
        layouts; a BatchNorm's running statistics are not taken (they
        restart, as the JAX import leaves them in the init's collection);
      * a plain `last_layer.weight` counts as `weight_v` (the published
        vit_base checkpoint, main_dino_adapter.py:253-254,283-288);
        `weight_g` is taken only beside `weight_v` and only into a head
        whose g trains (`norm_last_layer` False)."""
    out: StateDict = {}

    def try_set(name: str, t: torch.Tensor) -> None:
        want = template.get(name)
        if not random_head and want is not None and want.shape == t.shape:
            out[name] = t

    src_bn = any(k.endswith("running_mean") for k in sd)
    dst_bn = any(k.endswith("running_mean") for k in template)
    for src, dst in zip(_HEAD_LINEARS[src_bn], _HEAD_LINEARS[dst_bn]):
        for p in ("weight", "bias"):
            if f"mlp.{src}.{p}" in sd:
                try_set(f"mlp.{dst}.{p}", sd[f"mlp.{src}.{p}"])
    if src_bn and dst_bn:
        for i in _HEAD_NORMS:
            for p in ("weight", "bias"):
                if f"mlp.{i}.{p}" in sd:
                    try_set(f"mlp.{i}.{p}", sd[f"mlp.{i}.{p}"])
    v = sd.get("last_layer.weight_v", sd.get("last_layer.weight"))
    if v is not None:
        try_set("last_layer.weight_v", v)
    if ("last_layer.weight_g" in sd and "last_layer.weight_v" in sd
            and not norm_last_layer):
        try_set("last_layer.weight_g", sd["last_layer.weight_g"])
    return out


def import_dino_student_teacher(parts: Dict[str, StateDict],
                                student_template: StateDict,
                                teacher_template: StateDict,
                                random_head: bool = False,
                                norm_last_layer: bool = True
                                ) -> Dict[str, StateDict]:
    """A full checkpoint's student and teacher → for each part it holds,
    the tensors to overlay (`backbone.*` by `import_vit`, `head.*` by
    `import_dino_head`) onto a `MultiCropWrapper` with that state dict,
    non-strictly (reference main_dino_adapter.py:239-311)."""
    out = {}
    for name, template in (("student", student_template),
                           ("teacher", teacher_template)):
        sd = parts.get(name)
        if sd is None:
            continue
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in sd.items()}
        backbone = {k[len("backbone."):]: v for k, v in sd.items()
                    if k.startswith("backbone.")}
        head = {k[len("head."):]: v for k, v in sd.items()
                if k.startswith("head.")}
        imported: StateDict = {}
        if backbone:
            imported.update({f"backbone.{k}": v for k, v in
                             import_vit(backbone).items()})
        if head:
            head_template = {k[len("head."):]: v for k, v in template.items()
                             if k.startswith("head.")}
            imported.update({f"head.{k}": v for k, v in import_dino_head(
                head, head_template, random_head,
                norm_last_layer).items()})
        out[name] = imported
    return out
