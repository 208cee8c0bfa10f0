"""The port's slide CLI and extraction with cv2 and PIL out of reach, and
the CLI's weight loading and flags.

The card's machine need not have cv2 or PIL: the slide CLI (every
`--prefetch` × `--scaled_decode`) and `extract_dataset` run in a
subprocess whose imports of cv2, PIL, pandas, JAX and `snuffy_tpu` raise,
and the extraction CSVs are held to the JAX `extract_dataset`'s. Then
`load_reference_pth` on a DINO training checkpoint (its `args` is an
`argparse.Namespace`), `--embedder_weights` overlaid non-strictly (a DINO
teacher with its projection head; an extraction's adapter `embedder.pth`
with `--patch_size 8 --use_adapter 1`), and what `--transform` does.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from snuffy_tpu import native as jax_native
from snuffy_tpu_torch import native
from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.embed.registry import build_embedder
from snuffy_tpu_torch.models.snuffy import build_milnet
from snuffy_tpu_torch.pipeline.slide_inference import predict_slide
from snuffy_tpu_torch.tiling.deepzoom import TilerConfig
from tests.test_torch_serve import REPO
from tests.test_torch_slide import make_jpeg_slide

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason="native slide reader unavailable (g++, libtiff or libjpeg)")

BLOCK = textwrap.dedent("""
    import sys
    BLOCKED = ("cv2", "PIL", "pandas", "jax", "jaxlib", "flax", "optax",
               "snuffy_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
""")
LEAKS = ("leaked = [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
         "assert not leaked, leaked\n")
CFG = SnuffyModelConfig(feats_size=384, num_heads=2, big_lambda=8, depth=1)
CLI = ["--embedder", "DINO", "--backbone", "vit_small", "--feats_size",
       "384", "--big_lambda", "8", "--num_heads", "2", "--tile_size", "256",
       "--embed_size", "224", "--embed_batch", "4", "--background_t", "5",
       "--objective", "20", "--base_mag", "20", "--workers", "0", "--bf16",
       "0", "--device", "cpu"]


def run_blocked(code: str) -> subprocess.CompletedProcess:
    out = subprocess.run([sys.executable, "-c", BLOCK + code + LEAKS],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    return out


@pytest.fixture
def slide_and_weights(tmp_path):
    slide = str(tmp_path / "tumor_001.tif")
    tissue, _ = make_jpeg_slide(slide, grid=3)
    weights = str(tmp_path / "milnet.pth")
    torch.save(build_milnet(CFG, seed=5, device="cpu").state_dict(), weights)
    return slide, weights, tissue


def test_slide_cli_runs_without_cv2_and_pil(slide_and_weights):
    slide, weights, tissue = slide_and_weights
    runs = [(p, s) for p in (0, 1) for s in (0, 1)]
    code = textwrap.dedent(f"""
        from snuffy_tpu_torch import predict_slide as cli
        for p, s in {runs!r}:
            cli.main({CLI!r} + ["--slide", {slide!r}, "--aggregator_weights",
                     {weights!r}, "--prefetch", str(p), "--scaled_decode",
                     str(s)])
    """)
    lines = [json.loads(line) for line in
             run_blocked(code).stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 4
    for (p, s), rec in zip(runs, lines):
        assert rec["decode_path"] == ("grid_jpeg_scaled" if s else "grid")
        assert rec["n_patches"] == len(tissue)
        assert 0.0 <= rec["bag_score"] <= 1.0
        for key in ("read_filter_s", "read_decode_s", "embed_s",
                    "classify_s", "total_s"):
            assert rec[key] >= 0.0
    # prefetch does not change what is computed
    assert lines[0]["bag_score"] == lines[2]["bag_score"]
    assert lines[1]["bag_score"] == lines[3]["bag_score"]


def test_extract_dataset_runs_without_pil_and_matches_jax(tmp_path):
    from snuffy_tpu.embed.pipeline import extract_dataset as jax_extract
    from snuffy_tpu.embed.registry import Embedder as JaxEmbedder
    from snuffy_tpu_torch.bridge import vit_from_jax
    from tests.test_torch_extract import (
        SMALL,
        TOL,
        jax_small,
        make_jpeg_tree,
        read_csv,
    )

    data = str(tmp_path / "data")
    make_jpeg_tree(data)   # PIL writes the tree; the port only reads it
    jm, params = jax_small()
    weights = str(tmp_path / "vit.pth")
    torch.save({k: torch.from_numpy(v)
                for k, v in vit_from_jax(params).items()}, weights)
    kw = dict(class_labels={"0_normal": 0, "1_tumor": 1},
              tile_label_csv=os.path.join(data, "tile_label.csv"),
              batch_size=4)
    out = str(tmp_path / "port")
    code = textwrap.dedent(f"""
        import torch
        from snuffy_tpu_torch.embed.pipeline import extract_dataset
        from snuffy_tpu_torch.embed.registry import Embedder
        from snuffy_tpu_torch.models.vit import VisionTransformer
        vit = VisionTransformer(**{SMALL!r})
        vit.load_state_dict(torch.load({weights!r}), strict=True)
        rows = extract_dataset(Embedder(vit.eval(), 32, 2).eval(), {data!r},
                               "fold1", {out!r}, **{kw!r})
        print(len(rows))
    """)
    assert run_blocked(code).stdout.split()[-1] == "8"

    jemb = JaxEmbedder(lambda p, im: jm.apply({"params": p}, im, True),
                       32, 2, params=params)
    jemb.init_head(0)
    jax_out = str(tmp_path / "jax")
    want = jax_extract(jemb, data, "fold1", jax_out, use_mesh=False, **kw)
    assert len(want) == 8
    for jpath, _ in want:
        path = os.path.join(out, os.path.relpath(jpath, jax_out))
        header, rows = read_csv(path)
        jheader, jrows = read_csv(jpath)
        assert header == jheader
        assert [r[-2:] for r in rows] == [r[-2:] for r in jrows]
        np.testing.assert_allclose(
            np.array([r[:-2] for r in rows], np.float32),
            np.array([r[:-2] for r in jrows], np.float32), **TOL["float32"])


def dino_checkpoint(path, state_dict, head=True):
    """A DINO `checkpoint.pth`'s layout (main_dino.py's save_dict)."""
    teacher = {f"backbone.{k}": v for k, v in state_dict.items()}
    if head:   # the DINO projection head, which no embedder has
        gen = torch.Generator().manual_seed(1)
        teacher["head.mlp.0.weight"] = torch.randn((32, 384), generator=gen)
        teacher["head.last_layer.weight_g"] = torch.ones((64, 1))
    torch.save({"student": {f"module.{k}": v for k, v in teacher.items()},
                "teacher": teacher, "optimizer": {"lr": 0.1}, "epoch": 3,
                "args": argparse.Namespace(arch="vit_small", patch_size=16,
                                           out_dim=65536)}, path)


def test_load_reference_pth_reads_a_dino_training_checkpoint(tmp_path):
    from snuffy_tpu.embed.torch_import import (
        load_torch_state_dict,
        strip_prefixes,
    )
    from snuffy_tpu_torch.bridge import load_reference_pth

    sd = build_embedder("DINO", "vit_small", device="cpu"
                        ).backbone.state_dict()
    path = str(tmp_path / "checkpoint.pth")
    dino_checkpoint(path, sd)
    with pytest.raises(pickle.UnpicklingError):   # the Namespace
        torch.load(path, map_location="cpu", weights_only=True)
    got = load_reference_pth(path)
    want = strip_prefixes(load_torch_state_dict(path))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert "head.mlp.0.weight" in got and "cls_token" in got


def audit_of(out: str):
    line = next(x for x in out.splitlines() if x.startswith("layer audit"))
    return [int(w) for w in line.split() if w.isdigit()][:3]


def test_cli_overlays_a_dino_teacher_with_its_head(slide_and_weights,
                                                   tmp_path, capsys):
    from snuffy_tpu_torch import predict_slide as cli

    slide, weights, _ = slide_and_weights
    sd = build_embedder("DINO", "vit_small", seed=7, device="cpu"
                        ).backbone.state_dict()
    ckpt = str(tmp_path / "checkpoint.pth")
    dino_checkpoint(ckpt, sd)
    args = CLI + ["--slide", slide, "--aggregator_weights", weights]
    seeded = cli.main(args)
    loaded = cli.main(args + ["--embedder_weights", ckpt])
    matched, missing, unused = audit_of(capsys.readouterr().out)
    assert (matched, missing, unused) == (len(sd), 0, 2)
    assert loaded.positions == seeded.positions
    assert loaded.bag_score != seeded.bag_score


def test_cli_serves_an_adapter_extractions_embedder(slide_and_weights,
                                                    tmp_path, capsys):
    """compute_feats saves `embedder.backbone.state_dict()` as
    embedder.pth; with --patch_size 8 --use_adapter 1 the slide CLI builds
    that ViT-S/8 + adapter and takes every tensor of it."""
    from snuffy_tpu_torch import predict_slide as cli

    slide, weights, tissue = slide_and_weights
    emb = build_embedder("DINO", "vit_small", patch_size=8, use_adapter=True,
                         seed=3, device="cpu")
    path = str(tmp_path / "embedder.pth")
    torch.save(emb.backbone.state_dict(), path)
    pred = cli.main(CLI + ["--slide", slide, "--aggregator_weights", weights,
                           "--embedder_weights", path, "--patch_size", "8",
                           "--use_adapter", "1"])
    out = capsys.readouterr().out
    assert audit_of(out) == [len(emb.backbone.state_dict()), 0, 0]
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["n_patches"] == len(tissue) == len(pred.positions)
    assert rec["decode_path"] == "grid_jpeg_scaled"


def test_cli_transform_normalises_in_the_embedder(slide_and_weights):
    """--transform 1 puts ImageNet normalisation in the embedder and moves
    the scores; --transform 0 gives the un-normalised embedder's."""
    from snuffy_tpu_torch import predict_slide as cli

    slide, weights, _ = slide_and_weights
    args = CLI + ["--slide", slide, "--aggregator_weights", weights]
    plain, normed = (cli.main(args + ["--transform", t]) for t in "01")
    embedder = build_embedder("DINO", "vit_small", num_classes=1,
                              imagenet_norm=False, device="cpu")
    milnet = build_milnet(CFG, device="cpu")
    milnet.load_state_dict(torch.load(weights))
    want = predict_slide(slide, embedder, milnet,
                         TilerConfig(tile_size=256, background_threshold=5.0,
                                     objective_power=20.0, base_mag=20.0),
                         embed_batch=4, embed_size=224, workers=0)
    assert plain.bag_score == want.bag_score
    np.testing.assert_array_equal(plain.instance_scores,
                                  want.instance_scores)
    assert normed.positions == plain.positions
    assert not np.allclose(normed.instance_scores, plain.instance_scores)
    assert "ImageNet" in cli.get_args_parser().format_help()
