"""The port's DINO-adapter ViT and its extraction path vs the JAX package.

A small ViT-S/8-shaped model (patch 8, 224² input so 785 tokens, width 32,
depth 2, 2 heads) with the parallel adapter crosses from JAX through
`bridge.vit_from_jax`; its adapters' up-projections are drawn non-zero,
because at init they are zeros and the adapter then adds exactly 0. The
extraction pipeline runs on a tmp tree of JPEGs against the JAX
`extract_dataset` + `save_class_features`, and the CLI end to end.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snuffy_tpu.embed.registry import Embedder as JaxEmbedder
from snuffy_tpu.models.vit import VisionTransformer as JaxViT
from snuffy_tpu_torch.bridge import load_vit_weights, vit_from_jax
from snuffy_tpu_torch.embed.registry import Embedder, build_embedder
from snuffy_tpu_torch.models.vit import VisionTransformer
from snuffy_tpu_torch.ops.kernels import DENSE

SMALL = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2,
             use_adapter=True, adapter_bottleneck=8, adapter_scale=4.0)
# f32: sums in other orders through 2 blocks of 785 tokens. bf16: the JAX
# MHSA rounds its scores to bf16 before the softmax (snuffy_tpu/models/
# vit.py:118-120), the port's dense attention keeps them in f32, and the
# two round activations at other places (LayerNorm, softmax).
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def jax_small(dtype="float32", seed=0, **kw):
    model = JaxViT(compute_dtype=dtype, **{**SMALL, **kw})
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 224, 224, 3)))["params"]
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(np.asarray, params)
    for name, blk in params.items():
        if name.startswith("blocks_"):
            up = blk["adaptmlp"]["up"]
            up["kernel"] = rng.standard_normal(up["kernel"].shape).astype(
                np.float32) * 0.2
            up["bias"] = rng.standard_normal(up["bias"].shape).astype(
                np.float32) * 0.1
            if "scale" in blk["adaptmlp"]:
                blk["adaptmlp"]["scale"] = np.array([0.7], np.float32)
    return model, params


def torch_small(params, dtype="float32", **kw):
    model = VisionTransformer(compute_dtype=dtype, **{**SMALL, **kw})
    model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in vit_from_jax(params).items()},
        strict=True)
    return model.eval()


def tiles(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, 224, 224, 3)).astype(np.uint8)


@pytest.mark.parametrize("dtype, kw", [
    ("float32", {}),
    ("bfloat16", {}),
    ("float32", dict(adapter_layernorm_option="in",
                     adapter_learnable_scale=True)),
    ("float32", dict(adapter_layernorm_option="out")),
])
def test_s8_adapter_vit_matches_jax(dtype, kw):
    jm, params = jax_small(dtype, **kw)
    x = tiles().astype(np.float32) / 255.0
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), True))
    model = torch_small(params, dtype, **kw)
    before = DENSE.launches
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert DENSE.launches == before   # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


def test_adapter_branch_is_live_and_zero_at_init():
    """Drawn up-projections change the output; at init (up = 0) the
    adapter model equals the same model without adapters."""
    _, params = jax_small()
    with_adapter = torch_small(params)
    plain_sd = {k: v for k, v in with_adapter.state_dict().items()
                if ".adaptmlp." not in k}
    plain = VisionTransformer(compute_dtype="float32", **{
        **SMALL, "use_adapter": False})
    plain.load_state_dict(plain_sd, strict=True)
    x = torch.from_numpy(tiles(n=1).astype(np.float32) / 255.0)
    fresh = VisionTransformer(seed=3, **SMALL).eval()
    fresh_plain = VisionTransformer(seed=3, **{**SMALL, "use_adapter": False})
    fresh_plain.load_state_dict(
        {k: v for k, v in fresh.state_dict().items()
         if ".adaptmlp." not in k}, strict=True)
    with torch.inference_mode():
        assert not torch.allclose(with_adapter(x), plain.eval()(x))
        assert torch.equal(fresh(x), fresh_plain.eval()(x))
    for blk in fresh.blocks:
        assert torch.count_nonzero(blk.adaptmlp.up_proj.weight) == 0
        std = float(blk.adaptmlp.down_proj.weight.detach().std())
        assert abs(std - (3 * 32) ** -0.5) < 0.2 * (3 * 32) ** -0.5


def test_non_strict_loader_keeps_missing_adapter_keys(tmp_path, capsys):
    """A plain DINO checkpoint onto an adapter ViT: every DINO tensor is
    copied, the adapter keys keep their init and are reported."""
    src = VisionTransformer(seed=1, **{**SMALL, "use_adapter": False})
    dst = VisionTransformer(seed=2, **SMALL)
    init_up = dst.blocks[0].adaptmlp.down_proj.weight.clone()
    path = tmp_path / "dino.pth"
    torch.save({"teacher": {f"module.backbone.{k}": v
                            for k, v in src.state_dict().items()}}, path)
    matched, mismatched = load_vit_weights(dst, str(path))
    assert set(matched) == set(src.state_dict())
    assert mismatched and all(".adaptmlp." in k for k in mismatched)
    assert torch.equal(dst.pos_embed, src.pos_embed)
    assert torch.equal(dst.blocks[0].adaptmlp.down_proj.weight, init_up)
    out = capsys.readouterr().out
    assert "missing: blocks.0.adaptmlp.down_proj.weight" in out


def make_jpeg_tree(root, bags=(("train", "0_normal", 3),
                               ("train", "1_tumor", 5),
                               ("test", "0_normal", 2),
                               ("test", "1_tumor", 1))):
    from PIL import Image

    rng = np.random.default_rng(0)
    labels = []
    for split, cls, count in bags:
        for b in range(2):
            slide = f"{cls}_{split}_{b}"
            bag_dir = os.path.join(root, "single", "fold1", split, cls, slide)
            os.makedirs(bag_dir)
            for p in range(count):
                size = 224 if p % 2 else 160   # some tiles are resized
                arr = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
                Image.fromarray(arr).save(
                    os.path.join(bag_dir, f"{p}_{p + 3}.jpeg"))
                labels.append((f"{slide}_{p}_{p + 3}", p % 2))
    with open(os.path.join(root, "tile_label.csv"), "w") as f:
        f.writelines(f"{k},{v}\n" for k, v in labels)


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_extract_dataset_matches_jax(tmp_path):
    from snuffy_tpu.embed.pipeline import extract_dataset as jax_extract
    from snuffy_tpu.embed.pipeline import (
        save_class_features as jax_save_class_features,
    )
    from snuffy_tpu_torch.embed.pipeline import (
        extract_dataset,
        save_class_features,
    )

    data = str(tmp_path / "data")
    make_jpeg_tree(data)
    jm, params = jax_small()
    jemb = JaxEmbedder(lambda p, im: jm.apply({"params": p}, im, True),
                       32, 2, params=params)
    jemb.init_head(0)
    classes = {"0_normal": 0, "1_tumor": 1}
    kw = dict(class_labels=classes,
              tile_label_csv=os.path.join(data, "tile_label.csv"),
              batch_size=4)
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_extract(jemb, data, "fold1", jax_out, use_mesh=False, **kw)
    emb = Embedder(torch_small(params), 32, 2).eval()
    got = extract_dataset(emb, data, "fold1", out, **kw)

    rel = [(os.path.relpath(p, out), c) for p, c in got]
    assert rel == [(os.path.relpath(p, jax_out), c) for p, c in want]
    assert len(rel) == 8
    for (path, _), (jpath, _) in zip(got, want):
        header, rows = read_csv(path)
        jheader, jrows = read_csv(jpath)
        assert header == jheader and header[-2:] == ["label", "position"]
        assert [r[-2:] for r in rows] == [r[-2:] for r in jrows]
        np.testing.assert_allclose(
            np.array([r[:-2] for r in rows], np.float32),
            np.array([r[:-2] for r in jrows], np.float32), **TOL["float32"])

    shuffled = save_class_features(out, "camelyon16.csv")
    jax_df = jax_save_class_features(jax_out, "camelyon16.csv")
    assert [(os.path.relpath(p, out), c) for p, c in shuffled] == [
        (os.path.relpath(p, jax_out), c)
        for p, c in zip(jax_df.iloc[:, 0], jax_df["label"])]
    for name in ("camelyon16.csv", os.path.join("train", "1_tumor.csv")):
        header, rows = read_csv(os.path.join(out, name))
        jheader, jrows = read_csv(os.path.join(jax_out, name))
        assert header == jheader
        assert [(os.path.relpath(p, out), c) for p, c in rows] == [
            (os.path.relpath(p, jax_out), c) for p, c in jrows]


def test_embed_tiles_pads_the_tail_batch():
    from snuffy_tpu_torch.embed.pipeline import embed_tiles

    _, params = jax_small()
    emb = Embedder(torch_small(params), 32, 2).eval()
    x = tiles(n=5, seed=4)
    got = embed_tiles(emb, x, batch_size=2)
    with torch.inference_mode():
        want, _ = emb(torch.from_numpy(x))
    assert got.shape == (5, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


def test_compute_feats_cli_end_to_end(tmp_path, monkeypatch):
    """Two runs of the CLI on the CPU at ViT-S/16 + adapter: the second
    loads a changed copy of the first's embedder.pth with --weights, saves
    exactly it and writes other features; a third at the defaults runs
    SimCLR ResNet-18."""
    from snuffy_tpu_torch import compute_feats as cli

    monkeypatch.chdir(tmp_path)
    make_jpeg_tree(str(tmp_path / "datasets" / "camelyon16"),
                   bags=(("train", "0_normal", 2), ("train", "1_tumor", 3)))
    args = ["--embedder", "DINO", "--backbone", "vit_small",
            "--patch_size", "16", "--use_adapter", "--batch_size", "3",
            "--num_workers", "0", "--compute_dtype", "float32",
            "--device", "cpu"]
    rows = cli.main(args)
    out = tmp_path / "embeddings" / "camelyon16" / "DINO"
    assert len(rows) == 4 and (out / "embedder.pth").exists()
    _, ds = read_csv(out / "camelyon16.csv")
    assert sorted(ds) == sorted([p, str(c)] for p, c in rows)
    sd = torch.load(out / "embedder.pth")
    assert "blocks.0.adaptmlp.up_proj.weight" in sd and "cls_token" in sd

    gen = torch.Generator().manual_seed(0)
    for i in range(12):   # the adapters now add something
        key = f"blocks.{i}.adaptmlp.up_proj.weight"
        sd[key] = 0.05 * torch.randn(sd[key].shape, generator=gen)
    torch.save({"teacher": {f"module.backbone.{k}": v
                            for k, v in sd.items()}}, tmp_path / "new.pth")
    rows2 = cli.main(args + ["--weights", str(tmp_path / "new.pth"),
                             "--version_name", "again"])
    saved = torch.load(tmp_path / "embeddings" / "camelyon16" / "DINO_again"
                       / "embedder.pth")
    assert all(torch.equal(saved[k], sd[k]) for k in sd)
    for (p, _), (p2, _) in zip(rows, rows2):
        (h, r), (h2, r2) = read_csv(p), read_csv(p2)
        assert h == h2 and [x[-2:] for x in r] == [x[-2:] for x in r2]
        assert not np.allclose(np.array([x[:-2] for x in r], np.float32),
                               np.array([x[:-2] for x in r2], np.float32))
    # the default embedder, SimCLR ResNet-18, writes 512-d features
    rows3 = cli.main(["--batch_size", "3", "--num_workers", "0",
                      "--compute_dtype", "float32", "--device", "cpu"])
    header, body = read_csv(rows3[0][0])
    assert len(rows3) == 4 and header[:2] == ["0", "1"] and \
        header[512:] == ["label", "position"]
    assert "layer1.0.conv1.weight" in torch.load(
        tmp_path / "embeddings" / "camelyon16" / "SimCLR" / "embedder.pth")


def test_build_embedder_takes_the_jax_adapter_arguments():
    emb = build_embedder("DINO", "vit_small", patch_size=8, use_adapter=True,
                         adapter_ffn_num=64, adapter_ffn_scalar=4.0,
                         device="cpu")
    vit = emb.backbone
    assert vit.pos_embed.shape == (1, 785, 384) and len(vit.blocks) == 12
    ad = vit.blocks[11].adaptmlp
    assert ad.down_proj.weight.shape == (64, 384) and ad.scale == 4.0
    assert build_embedder("DINO", "vit_small", device="cpu"
                          ).backbone.blocks[0].adaptmlp is None
    # img_size sizes the MAE's grid only: the ViT keeps its 224² grid and
    # resizes it to the input's (built on the meta device: shapes only)
    meta = torch.device("meta")
    with meta:
        vit = build_embedder("DINO", "vit_small", img_size=256,
                             device=meta).backbone
    assert vit.pos_embed.shape == (1, 197, 384)
