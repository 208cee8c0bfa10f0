"""Camelyon16 FROC CLI: the port of the root `froc.py` (reference
froc.py:350-394), with its flags, reading the CSVs with the csv module and
the masks with the port's libtiff reader:

  python -m snuffy_tpu_torch.froc --reference reference.csv \
      --masks masks/ --detections detections/ --result froc.csv

Inputs: a reference CSV with columns [image, type], a masks folder with
`{image}_mask.tif`, and a detections folder with one `{image}.csv` per
slide, columns [p, x, y] at WSI level 0. Nothing runs on the card.
"""

from __future__ import annotations

import argparse
import csv
import os

from snuffy_tpu_torch.eval.froc import (
    EvalMaskCache,
    froc_for_slides,
    plot_froc,
    save_results,
)


def get_args_parser():
    p = argparse.ArgumentParser("CAMELYON16 FROC evaluation (ASAP-free)")
    p.add_argument("--reference", required=True,
                   help="CSV with columns [image, type]")
    p.add_argument("--masks", required=True, help="folder of {image}_mask.tif")
    p.add_argument("--detections", required=True,
                   help="folder of {image}.csv with columns [p, x, y]")
    p.add_argument("--result", default=None, help="output CSV path")
    p.add_argument("--plot", default=None, help="output FROC plot path")
    p.add_argument("--level", default=5, type=int,
                   help="evaluation mask level")
    p.add_argument("--include_itcs", action="store_true")
    p.add_argument("--cache_dir", default=None,
                   help="persist computed evaluation masks as npz here — "
                        "repeated sweeps against the same test masks skip "
                        "the distance-transform/labeling recompute (the "
                        "working version of the reference's vestigial "
                        "use_cache flag, froc.py:450-451)")
    return p


def read_rows(path: str):
    """A CSV with a header row → one dict per row."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def check_plot_backend() -> None:
    """`--plot` draws with matplotlib: refuse it before any work where
    matplotlib cannot be imported, instead of failing after the scoring."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"--plot needs matplotlib, which cannot be imported "
                         f"here ({e}); run without --plot") from e


def main(argv=None):
    args = get_args_parser().parse_args(argv)
    if args.plot:
        check_plot_backend()
    detections, types = {}, {}
    for row in read_rows(args.reference):
        image = os.path.splitext(str(row["image"]))[0]
        det_csv = os.path.join(args.detections, f"{image}.csv")
        if not os.path.exists(det_csv):
            continue
        detections[image] = [
            (float(r["p"]), float(r["x"]), float(r["y"]))
            for r in read_rows(det_csv)
        ]
        types[image] = str(row["type"]).lower()

    def mask_for(slide):
        return os.path.join(args.masks, f"{slide}_mask.tif")

    cache = EvalMaskCache(args.cache_dir) if args.cache_dir else None
    score, avg_fps, sens = froc_for_slides(
        detections, mask_for, types,
        evaluation_mask_level=args.level,
        include_itcs=args.include_itcs,
        mask_cache=cache,
    )
    print(f"Score: {score}")
    if args.result:
        save_results(args.result, avg_fps, sens)
    if args.plot:
        plot_froc(avg_fps, sens, args.plot)
    return score


if __name__ == "__main__":
    main()
