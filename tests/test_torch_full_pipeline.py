"""The five-stage pipeline through the port's CLIs only: tile → split →
extract features → train MIL → ROI heat map (tests/test_full_pipeline.py
on the port), and the TCGA multiclass pipeline (tile → patient folds →
fold split → extract → multiclass training).

Each pipeline runs in a subprocess that blocks jax, snuffy_tpu, pandas,
scikit-learn, PIL and cv2, on the CPU (`--device cpu`); each stage reads
only what the previous one wrote. The slides are written here with the
port's writer.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np

from tests.test_torch_tiling import write_slide, write_xml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "snuffy_tpu", "pandas",
           "sklearn", "cv2", "PIL")


def run_blocked(cwd, body):
    code = "import sys\n" + textwrap.dedent(f"""
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
    """) + textwrap.dedent(body) + textwrap.dedent(f"""
        leaked = [m for m, mod in sys.modules.items()
                  if m.split(".")[0] in {BLOCKED!r} and mod is not None]
        assert not leaked, leaked
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_five_stage_pipeline(tmp_path):
    base = tmp_path / "datasets" / "camelyon16"
    for d in ("0_normal", "1_tumor", "annotations"):
        (base / d).mkdir(parents=True)
    for i in range(2):
        for cls, prefix in (("0_normal", "normal"), ("1_tumor", "tumor")):
            write_slide(str(base / cls / f"{prefix}_{i:03}.tif"), seed=i,
                        levels=(2, 4, 8), quality=80)
        write_xml(str(base / "annotations" / f"tumor_{i:03}.xml"),
                  [[(256, 256), (700, 256), (700, 700), (256, 700)]])
        lab = np.zeros((1024, 1024), np.uint8)
        lab[256:700, 256:700] = 2
        os.makedirs(tmp_path / "masks", exist_ok=True)
        from snuffy_tpu_torch import native

        native.write_tiled_tiff_gray(
            str(tmp_path / "masks" / f"tumor_{i:03}_mask.tif"),
            [lab] + [lab[::k, ::k].copy() for k in (2, 4, 8)])
    out = run_blocked(str(tmp_path), """
        import glob, json, os, shutil
        from snuffy_tpu_torch import (compute_feats, deepzoom_tiler_camelyon16,
                                      roi)
        from snuffy_tpu_torch.data.splits import apply_split
        from snuffy_tpu_torch.train import cli

        # 1: tiling
        deepzoom_tiler_camelyon16.main(["-j", "0", "-t", "5"])
        base = "datasets/camelyon16"
        assert os.path.exists(f"{base}/tile_label.csv")
        # 2: split (the test split reuses the validation slides)
        apply_split(f"{base}/single",
                    {"train": ["normal_000", "tumor_000"],
                     "validation": ["normal_001", "tumor_001"]})
        for cls in ("0_normal", "1_tumor"):
            src = f"{base}/single/fold1/validation/{cls}"
            for slide in os.listdir(src):
                shutil.copytree(f"{src}/{slide}",
                                f"{base}/single/fold1/test/{cls}/{slide}")
        # 3: extraction
        compute_feats.main(["--batch_size=4", "--num_workers=0",
                            "--dataset=camelyon16", "--fold=fold1",
                            "--device=cpu"])
        assert os.path.exists("embeddings/camelyon16/SimCLR/camelyon16.csv")
        # 4: training
        summary = cli.main([
            "--dataset=camelyon16", "--embedding=SimCLR", "--feats_size=512",
            "--num_heads=2", "--big_lambda=4", "--num_epochs=2", "--lr=1e-3",
            "--optimizer=adamw", "--use_mp=0", "--use_pallas=0",
            "--wandb_run=e2e", "--device=cpu"])
        assert summary["best_epoch"] >= 1
        ckpts = sorted(glob.glob("runs/camelyon16/e2e/*.pth"))
        ckpts = [c for c in ckpts if "single_weight" not in c]
        # 5: ROI heat maps
        records = roi.main([
            "--aggregator_weights", ckpts[0], "--num_heads", "2",
            "--big_lambda", "4", "--depth", "1", "--batch_size", "4",
            "--bags_path", f"{base}/single/fold1/test/1_tumor/*",
            "--slides_path", f"{base}/1_tumor", "--masks_path", "masks",
            "--output", "roi_output", "--device", "cpu"])
        print(json.dumps({"bags": len(records),
                          "pngs": sorted(os.listdir("roi_output")),
                          "scores": [float(s) for s in records[0]["scores"]],
                          "best": summary["best_epoch"]}))
    """)
    result = json.loads(out.strip().splitlines()[-1])
    assert result["bags"] == 1 and result["pngs"] == ["tumor_001.png"]
    assert all(0.0 <= s <= 1.0 for s in result["scores"])
    from snuffy_tpu_torch.viz.png import read_png

    img = read_png(str(tmp_path / "roi_output" / "tumor_001.png"))
    assert img.shape == (128, 128, 4)
    assert (img[..., :3] == (0, 255, 0)).all(-1).any()   # the contour


def test_tcga_multiclass_pipeline(tmp_path):
    base = tmp_path / "datasets" / "tcga"
    slides = []
    for cls in ("0_luad", "1_lusc"):
        (base / cls).mkdir(parents=True)
        for i in range(3):
            name = f"TCGA-{cls[2:]}-{i:02}"
            write_slide(str(base / cls / f"{name}.tif"), seed=i + len(cls),
                        quality=80)
            slides.append(name)
    with open(base / "patients.csv", "w") as f:
        f.write("patient,slide\n" + "".join(f"{s},{s}\n" for s in slides))
    out = run_blocked(str(tmp_path), """
        import json, os
        from snuffy_tpu_torch import compute_feats
        from snuffy_tpu_torch import deepzoom_tiler_tcga_lung_cancer as tiler
        from snuffy_tpu_torch.data.splits import (apply_split,
                                                  split_from_fold_csv,
                                                  tcga_patient_folds)
        from snuffy_tpu_torch.train import cli

        tiler.main(["-j", "0", "-t", "5", "-o", "20", "-b", "20",
                    "--slide_format", "tif"])
        base = "datasets/tcga"
        tiles = os.listdir(f"{base}/single/0_luad/TCGA-luad-00")
        assert tiles and all(t.count("_") == 1 and "-" not in t
                             for t in tiles)
        folds = tcga_patient_folds(f"{base}/patients.csv", f"{base}/folds",
                                   n_splits=3)
        split = split_from_fold_csv(folds[0])
        assert set(split) == {"train", "validation", "test"}
        assert not set(split["train"]) & set(split["test"])
        apply_split(f"{base}/single",
                    {"train": ["TCGA-luad-00", "TCGA-lusc-00"],
                     "validation": ["TCGA-luad-01", "TCGA-lusc-01"],
                     "test": ["TCGA-luad-02", "TCGA-lusc-02"]},
                    classes=("0_luad", "1_lusc"), fold=1)
        compute_feats.main(["--batch_size=4", "--num_workers=0",
                            "--num_classes=2", "--dataset=tcga",
                            "--fold=fold1", "--device=cpu"])
        summary = cli.main([
            "--dataset=tcga", "--embedding=SimCLR", "--feats_size=512",
            "--arch=snuffy_multiclass", "--num_classes=2", "--num_heads=2",
            "--big_lambda=4", "--random_patch_share=0.5", "--num_epochs=2",
            "--lr=1e-3", "--optimizer=adamw", "--use_mp=0",
            "--use_pallas=0", "--wandb_run=tcga_e2e", "--device=cpu"])
        print(json.dumps(summary["test_best"]["epoch_test_best_aucs"]))
    """)
    assert len(json.loads(out.strip().splitlines()[-1])) == 2
