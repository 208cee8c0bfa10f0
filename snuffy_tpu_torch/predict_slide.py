"""Slide inference CLI on the GPU: WSI → tiles → embedder → Snuffy MIL.

The port of the root `predict_slide.py`, with its flags and defaults
(SimCLR ResNet-18 with InstanceNorm, bf16, into a d=512 MILNet: 4 heads,
Λ=200, ρ=0, depth 1) plus the port's own: `--device` (default cuda;
there is no silent fall back to the CPU) and the embedder's
`--patch_size`, `--use_adapter`, `--ffn_num` and `--adapter_ffn_scalar`
(the root CLI fixes them at 16, off, 64 and 4.0, its defaults here), so
the Camelyon16 ViT-S/8 + adapter can serve. Run from the repository root:

  python -m snuffy_tpu_torch.predict_slide --slide tumor_001.tif
  python -m snuffy_tpu_torch.predict_slide --slide tumor_001.tif \
      --embedder DINO --backbone vit_small --feats_size 384 \
      --embedder_weights dino_vits16.pth --aggregator_weights milnet.pth
  python -m snuffy_tpu_torch.predict_slide --slide tumor_001.tif \
      --embedder Virchow2 --backbone vit_huge_patch14_reg4 \
      --feats_size 2560 --num_heads 20 --embedder_weights virchow2.pth

Virchow2 (timm's ViT-H/14 with registers; its 2560-d class-plus-mean
embeddings) is ImageNet-normalised whatever `--transform` says, and
ignores `--patch_size` and the adapter's flags.
`--aggregator_weights` takes a reference-format `.pth` (a flax `.msgpack`
converts with tools/export_torch_checkpoint.py). `--embedder_weights`
takes a `.pth` of the family the flags name (a torchvision ResNet-18, an
MAE encoder, a DINO ViT such as a training checkpoint's teacher, or the
`embedder.pth` of an extraction), overlaid as the root CLI does: every
tensor whose name and shape match, with the layer audit printed. Without
them the weights are seeded. `--prefetch` and `--scaled_decode` steer the
streaming slide path. Prints one JSON line per slide, its timings and
`decode_path` included.
"""

from __future__ import annotations

import argparse
import glob
import json

import torch

from snuffy_tpu_torch.bridge import load_reference_pth
from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.embed.registry import build_embedder
from snuffy_tpu_torch.embed.torch_import import load_embedder_weights
from snuffy_tpu_torch.models.snuffy import build_milnet
from snuffy_tpu_torch.pipeline.slide_inference import predict_slide
from snuffy_tpu_torch.tiling.deepzoom import TilerConfig

# The root CLI fixes the ResNet's norm (predict_slide.py:70-77).
NORM_LAYER = "instance"


def get_args_parser():
    """The root `predict_slide.py`'s flags (names, defaults, types and
    choices; tests/test_torch_copies.py holds them to it), the root
    script's help rewritten for the port, then the port's own flags."""
    p = argparse.ArgumentParser("Snuffy end-to-end slide inference")
    p.add_argument("--slide", required=True,
                   help="slide TIF path or glob (batch serving)")
    p.add_argument("--embedder", default="SimCLR", type=str)
    p.add_argument("--backbone", default="resnet18", type=str)
    p.add_argument("--embedder_weights", default=None, type=str)
    p.add_argument("--aggregator_weights", default=None, type=str)
    p.add_argument("--feats_size", default=512, type=int)
    p.add_argument("--num_classes", default=1, type=int)
    p.add_argument("--num_heads", default=4, type=int)
    p.add_argument("--big_lambda", default=200, type=int)
    p.add_argument("--random_patch_share", default=0.0, type=float)
    p.add_argument("--depth", default=1, type=int)
    p.add_argument("--tile_size", default=256, type=int)
    p.add_argument("--embed_size", default=224, type=int)
    p.add_argument("--embed_batch", default=256, type=int)
    p.add_argument("--background_t", default=15.0, type=float)
    p.add_argument("--objective", default=40.0, type=float)
    p.add_argument("--base_mag", default=20.0, type=float)
    p.add_argument("--workers", default=8, type=int)
    p.add_argument("--transform", default=0, type=int,
                   help="1 → ImageNet normalisation inside the embedder (the "
                        "reference's intent; the root CLI accepts the flag "
                        "and leaves the images as they are), 0 → none")
    p.add_argument("--bf16", default=1, type=int)
    p.add_argument("--prefetch", default=None, type=int, choices=[0, 1],
                   help="read the next block of grid rows in a thread while "
                        "the current one uploads and embeds: unset or 1 = "
                        "on, 0 = off")
    p.add_argument("--scaled_decode", default=None, type=int, choices=[0, 1],
                   help="decode JPEG tiles straight at embed_size by "
                        "libjpeg's M/8 scaled IDCT where the level allows "
                        "it: unset or 1 = when eligible, 0 = never (decode "
                        "at tile_size, resize on the device)")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; cuda raises when no GPU is present")
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--use_adapter", default=0, type=int, choices=[0, 1])
    p.add_argument("--ffn_num", default=64, type=int,
                   help="adapter bottleneck width")
    p.add_argument("--adapter_ffn_scalar", default=4.0, type=float)
    return p


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name} but torch.cuda.is_available() is false"
        )
    return device


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    device = resolve_device(args.device)
    dtype = "bfloat16" if args.bf16 else "float32"

    embedder = build_embedder(
        args.embedder, args.backbone, num_classes=args.num_classes,
        patch_size=args.patch_size, use_adapter=bool(args.use_adapter),
        adapter_ffn_num=args.ffn_num,
        adapter_ffn_scalar=args.adapter_ffn_scalar, norm_layer=NORM_LAYER,
        compute_dtype=dtype, imagenet_norm=bool(args.transform),
        device=device,
    )
    if args.embedder_weights:
        load_embedder_weights(embedder.backbone, args.embedder_weights,
                              args.embedder, args.backbone, NORM_LAYER)

    cfg = SnuffyModelConfig(
        feats_size=args.feats_size, num_classes=args.num_classes,
        num_heads=args.num_heads, big_lambda=args.big_lambda,
        random_patch_share=args.random_patch_share, depth=args.depth,
        compute_dtype=dtype,
    )
    milnet = build_milnet(cfg, device=device)
    if args.aggregator_weights:
        if args.aggregator_weights.endswith(".msgpack"):
            raise ValueError(
                f"{args.aggregator_weights} is a flax checkpoint; convert it "
                "to a reference .pth with tools/export_torch_checkpoint.py"
            )
        milnet.load_state_dict(load_reference_pth(args.aggregator_weights),
                               strict=True)

    tiler_cfg = TilerConfig(
        tile_size=args.tile_size, background_threshold=args.background_t,
        objective_power=args.objective, base_mag=args.base_mag,
    )
    preds = []
    for slide_path in sorted(glob.glob(args.slide)) or [args.slide]:
        pred = predict_slide(
            slide_path, embedder, milnet, tiler_cfg=tiler_cfg,
            embed_batch=args.embed_batch, embed_size=args.embed_size,
            workers=args.workers,
            prefetch=None if args.prefetch is None else bool(args.prefetch),
            scaled_decode=(None if args.scaled_decode is None
                           else bool(args.scaled_decode)),
        )
        print(json.dumps({"slide": slide_path, "bag_score": pred.bag_score,
                          **pred.timings}))
        preds.append(pred)
    return preds if len(preds) > 1 else preds[0]


if __name__ == "__main__":
    main()
