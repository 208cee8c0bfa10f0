"""Camelyon16 tiling CLI: the port of the root `deepzoom_tiler_camelyon16.py`
(reference deepzoom_tiler_camelyon16.py:296-353 flags), with its flags and
defaults. Run from the directory that holds `datasets/`:

  python -m snuffy_tpu_torch.deepzoom_tiler_camelyon16 -d camelyon16

Slides under `datasets/<dataset>/{0_normal,1_tumor}/*.tif` are tiled at the
target magnification into `datasets/<dataset>/single/<class>/<slide>/
{col}_{row}-{level}.jpeg`; tumour-patch labels from the XML annotations in
`datasets/<dataset>/annotations/` are appended to
`datasets/<dataset>/tile_label.csv` by one writer. The port's libtiff
reader and libjpeg writer do the work; nothing runs on the card.
"""

from __future__ import annotations

import argparse
import glob
import os

from snuffy_tpu_torch.tiling.deepzoom import (
    TilerConfig,
    append_tile_labels,
    tile_slide_nested,
)


def get_args_parser():
    p = argparse.ArgumentParser(description="Patch extraction for camelyon16")
    p.add_argument("-d", "--dataset", type=str, default="camelyon16")
    p.add_argument("-e", "--overlap", type=int, default=0,
                   help="Overlap of adjacent tiles [0]")
    p.add_argument("-f", "--format", type=str, default="jpeg",
                   choices=["jpeg", "png"])
    p.add_argument("-m", "--magnifications", type=int, nargs="+",
                   default=(0,),
                   help="levels below base_mag to tile; two levels build "
                        "the nested-bag pyramid (reference "
                        "deepzoom_tiler_camelyon16.py:256-295)")
    p.add_argument("-v", "--slide_format", type=str, default="tif")
    p.add_argument("-j", "--workers", type=int, default=8)
    p.add_argument("-q", "--quality", type=int, default=75)
    p.add_argument("-s", "--tile_size", type=int, default=256)
    p.add_argument("-b", "--base_mag", type=float, default=20)
    p.add_argument("-o", "--objective", type=float, default=20)
    p.add_argument("-t", "--background_t", type=int, default=20)
    p.add_argument("--datasets_path", type=str, default="datasets")
    return p


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    cfg = TilerConfig(
        tile_size=args.tile_size,
        quality=args.quality,
        background_threshold=args.background_t,
        objective_power=args.objective,
        base_mag=args.base_mag,
        workers=args.workers,
        name_with_level=True,
        overlap=args.overlap,
        image_format=args.format,
    )
    base = os.path.join(args.datasets_path, args.dataset)
    out_base = os.path.join(base, "single")
    tile_label_csv = os.path.join(base, "tile_label.csv")
    slides = sorted(
        glob.glob(os.path.join(base, "0_normal", f"*.{args.slide_format}"))
        + glob.glob(os.path.join(base, "1_tumor", f"*.{args.slide_format}"))
    )
    print(f"{len(slides)} slides to tile")
    for slide_path in slides:
        cls = os.path.basename(os.path.dirname(slide_path))
        slide = os.path.splitext(os.path.basename(slide_path))[0]
        out_dir = os.path.join(out_base, cls, slide)
        xml = os.path.join(base, "annotations", f"{slide}.xml")
        kept = tile_slide_nested(
            slide_path, out_dir, cfg,
            annotation_xml=xml if cls == "1_tumor" else None,
            mag_levels=tuple(args.magnifications),
        )
        append_tile_labels(tile_label_csv, slide, kept)
        print(f"{slide}: kept {len(kept)} tiles")
    return slides


if __name__ == "__main__":
    main()
