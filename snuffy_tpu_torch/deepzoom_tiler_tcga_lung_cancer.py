"""TCGA lung tiling CLI: the port of the root
`deepzoom_tiler_tcga_lung_cancer.py` (reference
deepzoom_tiler_tcga_lung_cancer.py), with its flags and defaults. The
Camelyon16 tiler's pipeline without annotations and with `{col}_{row}.jpeg`
names (no level suffix); a slide that fails is logged and skipped (the
reference's per-tile try/except, deepzoom_tiler_tcga_lung_cancer.py:53-64).

  python -m snuffy_tpu_torch.deepzoom_tiler_tcga_lung_cancer -d tcga
"""

from __future__ import annotations

import argparse
import glob
import os

from snuffy_tpu_torch.tiling.deepzoom import TilerConfig, tile_slide


def get_args_parser():
    p = argparse.ArgumentParser(description="Patch extraction for TCGA lung")
    p.add_argument("-d", "--dataset", type=str, default="tcga")
    p.add_argument("-e", "--overlap", type=int, default=0,
                   help="Overlap of adjacent tiles [0]")
    p.add_argument("-f", "--format", type=str, default="jpeg",
                   choices=["jpeg", "png"])
    p.add_argument("-v", "--slide_format", type=str, default="svs")
    p.add_argument("-j", "--workers", type=int, default=8)
    p.add_argument("-q", "--quality", type=int, default=75)
    p.add_argument("-s", "--tile_size", type=int, default=256)
    p.add_argument("-b", "--base_mag", type=float, default=20)
    p.add_argument("-o", "--objective", type=float, default=40)
    p.add_argument("-t", "--background_t", type=int, default=15)
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
        name_with_level=False,
        overlap=args.overlap,
        image_format=args.format,
    )
    base = os.path.join(args.datasets_path, args.dataset)
    out_base = os.path.join(base, "single")
    classes = ("0_luad", "1_lusc")
    slides = sorted(
        p for cls in classes
        for p in glob.glob(os.path.join(base, cls, f"*.{args.slide_format}"))
    )
    print(f"{len(slides)} slides to tile")
    done = []
    for slide_path in slides:
        cls = os.path.basename(os.path.dirname(slide_path))
        slide = os.path.splitext(os.path.basename(slide_path))[0]
        out_dir = os.path.join(out_base, cls, slide)
        try:
            kept = tile_slide(slide_path, out_dir, cfg)
            print(f"{slide}: kept {len(kept)} tiles")
            done.append(slide)
        except Exception as e:  # per-slide resilience
            print(f"{slide}: FAILED ({type(e).__name__}: {e})")
    return done


if __name__ == "__main__":
    main()
