"""Single-slide inference CLI on the GPU: WSI → tiles → DINO ViT → Snuffy.

The port of the root `predict_slide.py`, with its flags plus `--device`
(default cuda; there is no silent fall back to the CPU). Run from the
repository root:

  python -m snuffy_tpu_torch.predict_slide --slide tumor_001.tif \
      --embedder DINO --backbone vit_small --feats_size 384 \
      --embedder_weights dino_vits16.pth --aggregator_weights milnet.pth

`--aggregator_weights` takes a reference-format `.pth` (a flax `.msgpack`
converts with tools/export_torch_checkpoint.py); `--embedder_weights`
takes a DINO `.pth`. Without them the weights are seeded. Prints one JSON
line per slide.
"""

from __future__ import annotations

import glob
import json

import torch

from snuffy_tpu.configs import SnuffyModelConfig
from snuffy_tpu.tiling.deepzoom import TilerConfig
from snuffy_tpu_torch.bridge import load_reference_pth
from snuffy_tpu_torch.embed.registry import build_embedder
from snuffy_tpu_torch.models.snuffy import build_milnet
from snuffy_tpu_torch.pipeline.slide_inference import predict_slide


def get_args_parser():
    from predict_slide import get_args_parser as root_parser

    p = root_parser()
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; cuda raises when no GPU is present")
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
        compute_dtype=dtype, imagenet_norm=bool(args.transform),
        device=device,
    )
    if args.embedder_weights:
        embedder.backbone.load_state_dict(
            load_reference_pth(args.embedder_weights), strict=True)

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
        )
        print(json.dumps({"slide": slide_path, "bag_score": pred.bag_score,
                          **pred.timings}))
        preds.append(pred)
    return preds if len(preds) > 1 else preds[0]


if __name__ == "__main__":
    main()
