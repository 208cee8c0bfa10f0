"""Organize downloaded CAMELYON16 TIFs into the class layout the tiler
expects: the port of the root `move_camelyon16_tifs.py` (L0 of SURVEY.md
§1), with its flags and defaults, standard library only:

  python -m snuffy_tpu_torch.move_camelyon16_tifs [--src DIR] [--dst DIR] [--move]

normal_*.tif → 0_normal/, tumor_*.tif and test_*.tif → 1_tumor/ (test
slides are classified by reference.csv at split time), symlinked unless
`--move`; a slide already in place is left as it is. Nothing runs on the
card.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--src", default="downloads/camelyon16")
    p.add_argument("--dst", default="datasets/camelyon16")
    p.add_argument("--move", action="store_true",
                   help="move instead of symlink")
    args = p.parse_args(argv)

    os.makedirs(os.path.join(args.dst, "0_normal"), exist_ok=True)
    os.makedirs(os.path.join(args.dst, "1_tumor"), exist_ok=True)
    n = 0
    for tif in sorted(glob.glob(os.path.join(args.src, "**", "*.tif"),
                                recursive=True)):
        name = os.path.basename(tif)
        cls = "0_normal" if name.startswith("normal") else "1_tumor"
        dst = os.path.join(args.dst, cls, name)
        if os.path.exists(dst):
            continue
        if args.move:
            shutil.move(tif, dst)
        else:
            os.symlink(os.path.abspath(tif), dst)
        n += 1
    print(f"Done. {n} slides organized into {args.dst}.")
    return n


if __name__ == "__main__":
    main()
