"""ROI heat-map CLI on the GPU: the port of the root `roi.py` (reference
roi.py:121-378), with its flags and defaults plus `--device` (default
cuda; there is no silent fall back to the CPU). Each bag directory's
patches are embedded (`compute_feats.build_and_load_embedder`,
`embed.pipeline.compute_bag_feats`), scored by the Snuffy MILNet, and the
instance scores drawn over the slide's thumbnail with the tumour contour
(`viz.heatmap`), one PNG a bag:

  python -m snuffy_tpu_torch.roi --aggregator_weights milnet.pth \
      --num_heads 4 --bags_path "datasets/camelyon16/single/fold1/test/1_tumor/*" \
      --slides_path datasets/camelyon16/1_tumor --masks_path masks/

The defaults are the root's, f32 throughout: SimCLR ResNet-18 into a
d=512 MILNet with 6 heads, Λ=200, depth 5. 512 is not a multiple of 6, so
at its defaults the CLI refuses before it reads a bag, as the root one
does: pass --num_heads 4 (or 8), or --feats_size 384 with the ViT-S/16.
`--aggregator_weights` takes a reference-format `.pth` (a flax `.msgpack`
converts with tools/export_torch_checkpoint.py). Thumbnails and masks are
read through the port's libtiff reader at `--thumb_level` (the deepest
page when the file has fewer). Prints one line and returns one record per
bag: its PNG, bag score, instance scores, and embed and classify seconds.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from snuffy_tpu_torch.bridge import load_reference_pth
from snuffy_tpu_torch.compute_feats import build_and_load_embedder
from snuffy_tpu_torch.data.bucketing import pad_bag
from snuffy_tpu_torch.embed.pipeline import compute_bag_feats, parse_position
from snuffy_tpu_torch.predict_slide import resolve_device
from snuffy_tpu_torch.snuffy import SnuffyModelConfig, build_milnet
from snuffy_tpu_torch.eval.froc import TUMOR_LABEL
from snuffy_tpu_torch.viz.heatmap import resize_nearest, visualize_attentions


def get_args_parser():
    """The root roi.py's flags (help shortened), plus --device."""
    p = argparse.ArgumentParser("Snuffy ROI heatmaps (TPU-native)")
    p.add_argument("--embedder", default="SimCLR", type=str)
    p.add_argument("--backbone", default="resnet18", type=str)
    p.add_argument("--embedder_weights", default=None, type=str)
    p.add_argument("--aggregator_weights", required=True, type=str,
                   help="MIL run checkpoint (a reference .pth)")
    p.add_argument("--num_classes", default=1, type=int)
    p.add_argument("--feats_size", default=512, type=int)
    p.add_argument("--num_heads", default=6, type=int)
    p.add_argument("--big_lambda", default=200, type=int)
    p.add_argument("--random_patch_share", default=0.0, type=float)
    p.add_argument("--depth", default=5, type=int)
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--bags_path", required=True,
                   help="glob of bag dirs, e.g. datasets/camelyon16/single/fold1/test/1_tumor/*")
    p.add_argument("--slides_path", default=None,
                   help="folder of original WSI TIFs for thumbnails")
    p.add_argument("--masks_path", default=None,
                   help="folder of {slide}_mask.tif files for contours")
    p.add_argument("--thumb_level", default=3, type=int)
    p.add_argument("--output", default="roi_output", type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; cuda raises when no GPU is present")
    return p


def read_thumbnail(tif: str, level: int) -> np.ndarray:
    """(H, W) uint8 gray thumbnail: the RGB mean, truncated."""
    from snuffy_tpu_torch.native import NativeSlide

    with NativeSlide(tif) as s:
        lvl = min(level, s.level_count - 1)
        w, h = s.level_dimensions(lvl)
        rgb = s.read_region(lvl, 0, 0, w, h)
    return rgb.mean(axis=-1).astype(np.uint8)


def read_tumor_mask(tif: str, level: int, size) -> np.ndarray:
    """(H, W) uint8 tumour mask (label 2) of `tif` at `level`, resized to
    `size` = (H, W) by nearest neighbour."""
    from snuffy_tpu_torch.native import NativeSlide

    with NativeSlide(tif) as s:
        lvl = min(level, s.level_count - 1)
        w, h = s.level_dimensions(lvl)
        lab = s.read_label_region(lvl, 0, 0, w, h)
    return resize_nearest((lab == TUMOR_LABEL).astype(np.uint8),
                          size[1], size[0])


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = SnuffyModelConfig(
        feats_size=args.feats_size, num_classes=args.num_classes,
        num_heads=args.num_heads, big_lambda=args.big_lambda,
        random_patch_share=args.random_patch_share, depth=args.depth,
    )
    milnet = build_milnet(cfg, device=device)   # refuses d % h ≠ 0
    if args.aggregator_weights.endswith(".msgpack"):
        raise ValueError(
            f"{args.aggregator_weights} is a flax checkpoint; convert it "
            "to a reference .pth with tools/export_torch_checkpoint.py"
        )
    milnet.load_state_dict(load_reference_pth(args.aggregator_weights),
                           strict=True)
    emb_args = argparse.Namespace(
        embedder=args.embedder, backbone=args.backbone,
        weights=args.embedder_weights, num_classes=args.num_classes,
        patch_size=16, use_adapter=False, ffn_num=64,
        adapter_ffn_scalar=4.0, norm_layer="instance",
        compute_dtype="float32",
    )
    embedder = build_and_load_embedder(emb_args, device)

    bag_dirs = sorted(d for d in glob.glob(args.bags_path) if os.path.isdir(d))
    print(f"{len(bag_dirs)} bags")
    records = []
    for bag_dir in bag_dirs:
        slide = os.path.basename(bag_dir)
        patches = sorted(
            glob.glob(os.path.join(bag_dir, "*.jpg"))
            + glob.glob(os.path.join(bag_dir, "*.jpeg"))
        )
        if not patches:
            continue
        t0 = time.perf_counter()
        feats = compute_bag_feats(embedder, patches, args.batch_size)
        t1 = time.perf_counter()
        padded, mask = pad_bag(feats.astype(np.float32))
        with torch.inference_mode():
            ins_logits, bag_logits = milnet(
                torch.from_numpy(padded).to(device),
                torch.from_numpy(mask).to(device))
            scores = torch.sigmoid(ins_logits)[: len(patches), 0].cpu().numpy()
            bag_score = float(torch.sigmoid(bag_logits)[0])
        t2 = time.perf_counter()
        positions = [parse_position(p) or "0_0" for p in patches]

        slide_gray = tumor_mask = None
        if args.slides_path:
            tif = os.path.join(args.slides_path, f"{slide}.tif")
            if os.path.exists(tif):
                slide_gray = read_thumbnail(tif, args.thumb_level)
        if args.masks_path and slide_gray is not None:
            mtif = os.path.join(args.masks_path, f"{slide}_mask.tif")
            if os.path.exists(mtif):
                tumor_mask = read_tumor_mask(mtif, args.thumb_level,
                                             slide_gray.shape)

        out_path = os.path.join(args.output, f"{slide}.png")
        visualize_attentions(scores, positions, out_path, slide_gray,
                             tumor_mask)
        print(f"{slide}: bag score {bag_score:.3f} → {out_path} "
              f"(embed {t1 - t0:.3f} s, classify {t2 - t1:.3f} s, "
              f"{len(patches)} tiles)")
        records.append({"bag": bag_dir, "png": out_path,
                        "bag_score": bag_score, "scores": scores,
                        "positions": positions, "embed_s": t1 - t0,
                        "classify_s": t2 - t1})
    return records


if __name__ == "__main__":
    main()
