"""The two root CLIs at their default embedders, the port's against the JAX
package's, in f32 on the same weights.

`predict_slide.main` runs SimCLR ResNet-18 (InstanceNorm) into the
d=512 MILNet (4 heads, Λ=200, ρ=0, depth 1) on a small JPEG-tiled slide:
the embedder and MILNet flags stay at the root's defaults; both CLIs load
one seeded ResNet-18 `.pth` under torchvision's names, and one seeded
MILNet as the JAX `.msgpack` and its reference `.pth`. `compute_feats.main`
runs SimCLR (the default) and MAE ViT-B/16 on a JPEG tree of 4 tiles; both
CLIs load the same `.pth` and their CSVs are held together. ResNet-18 and
ViT-B/16 run at full width here only, on a handful of tiles.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import compute_feats as root_feats
import predict_slide as root_slide
from snuffy_tpu import native as jax_native
from snuffy_tpu.configs import SnuffyModelConfig
from snuffy_tpu.models.mae import mae_vit_base_patch16
from snuffy_tpu.models.resnet import ResNet18 as JaxResNet18
from snuffy_tpu.models.snuffy import init_milnet_params
from snuffy_tpu_torch import compute_feats, native, predict_slide
from snuffy_tpu_torch.bridge import (
    mae_from_jax,
    milnet_state_dict,
    resnet_from_jax,
)
from tests.test_torch_extract import make_jpeg_tree
from tests.test_torch_slide import make_jpeg_slide

# f32 both sides: convolutions, GEMMs and sums in other orders.
TOL = dict(rtol=1e-4, atol=1e-4)


def drawn(shapes, seed):
    """A parameter tree of `shapes` drawn from a numpy seed: kernels
    N(0, 1/fan_in), LayerNorm scales near 1, the rest small."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key, shape = path[-1].key, tuple(leaf.shape)
        if key == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape, dtype=np.float32)
                    / np.float32(np.sqrt(fan_in)))
        if key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape, dtype=np.float32))
        return 0.02 * rng.standard_normal(shape, dtype=np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def resnet18_pth(path, seed=0):
    shapes = jax.eval_shape(JaxResNet18().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))["params"]
    sd = resnet_from_jax(drawn(shapes, seed))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)


def mae_b16_pth(path, seed=0):
    """The encoder of MAE ViT-B/16 under MAE's names (no decoder: the
    JAX importer takes a checkpoint without one)."""
    model = mae_vit_base_patch16(use_adapter=False)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": key, "masking": key}, jnp.zeros((1, 224, 224, 3)), 0.75,
        True))["params"]
    encoder = {k: v for k, v in shapes.items()
               if not k.startswith("decoder") and k != "mask_token"}
    sd = mae_from_jax(drawn(encoder, seed))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)


@pytest.mark.skipif(not (native.available() and jax_native.available()),
                    reason="native slide reader unavailable (g++, libtiff "
                           "or libjpeg)")
def test_predict_slide_default_embedder_matches_jax(tmp_path):
    slide = str(tmp_path / "tumor_001.tif")
    make_jpeg_slide(slide, grid=4)
    embedder = str(tmp_path / "resnet18.pth")
    resnet18_pth(embedder)
    cfg = SnuffyModelConfig(feats_size=512, num_classes=1, num_heads=4,
                            big_lambda=200, random_patch_share=0.0, depth=1,
                            compute_dtype="float32")
    params = jax.tree_util.tree_map(np.asarray,
                                    init_milnet_params(cfg, 3, n_example=64))
    msgpack, pth = str(tmp_path / "milnet.msgpack"), str(tmp_path /
                                                         "milnet.pth")
    with open(msgpack, "wb") as f:
        f.write(serialization.to_bytes({"params": params,
                                        "w": np.float32(0.5),
                                        "step": np.int32(0)}))
    torch.save({k: torch.from_numpy(v)
                for k, v in milnet_state_dict(params).items()}, pth)
    args = ["--slide", slide, "--bf16", "0", "--embedder_weights", embedder,
            "--embed_batch", "4", "--background_t", "5"]

    want = root_slide.main(args + ["--aggregator_weights", msgpack])
    got = predict_slide.main(args + ["--aggregator_weights", pth,
                                     "--device", "cpu"])
    assert got.positions == want.positions and len(got.positions) >= 3
    assert got.timings["decode_path"] == want.timings["decode_path"]
    np.testing.assert_allclose(got.instance_scores, want.instance_scores,
                               **TOL)
    assert abs(got.bag_score - want.bag_score) <= 1e-4


def read_rows(path):
    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    return header, rows


@pytest.mark.parametrize("flags, writer", [
    ([], resnet18_pth),
    (["--embedder", "MAE", "--backbone", "mae_vit_base_patch16"],
     mae_b16_pth),
])
def test_compute_feats_matches_jax(tmp_path, flags, writer):
    data = str(tmp_path / "datasets")
    make_jpeg_tree(os.path.join(data, "camelyon16"),
                   bags=(("train", "1_tumor", 2),))
    weights = str(tmp_path / "embedder.pth")
    writer(weights)
    args = flags + ["--weights", weights, "--compute_dtype", "float32",
                    "--batch_size", "8", "--num_workers", "0",
                    "--datasets_path", data]
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    want = root_feats.main(args + ["--embeddings_path", jax_out])
    got = compute_feats.main(args + ["--embeddings_path", out,
                                     "--device", "cpu"])
    rel = sorted((os.path.relpath(p, out), c) for p, c in got)
    assert rel == sorted((os.path.relpath(p, jax_out), c) for p, c in want)
    assert len(rel) == 2
    dim = 512 if not flags else 768
    for path, _ in rel:
        header, rows = read_rows(os.path.join(out, path))
        jheader, jrows = read_rows(os.path.join(jax_out, path))
        assert header == jheader and len(header) == dim + 2
        assert [r[-2:] for r in rows] == [r[-2:] for r in jrows]
        np.testing.assert_allclose(
            np.array([r[:-2] for r in rows], np.float32),
            np.array([r[:-2] for r in jrows], np.float32), **TOL)
    saved = torch.load(os.path.join(out, "camelyon16",
                                    flags[1] if flags else "SimCLR",
                                    "embedder.pth"))
    src = torch.load(weights)
    assert all(torch.equal(saved[k], src[k]) for k in saved)
