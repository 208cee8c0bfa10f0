"""The port's serving slice end to end vs the JAX package.

predict_tiles (resize, embed, classify) against the JAX embed + MILNet
pair of the root predict_slide.py; the packed eval epoch against
`SnuffyTrainer.run_eval_epoch`; the package importing with JAX blocked;
and the slide CLI on a synthetic slide. ρ=0 and f32 throughout, so both
sides select the same slots.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snuffy_tpu.configs import MILTrainConfig, SnuffyModelConfig
from snuffy_tpu.data.bucketing import pad_bag
from snuffy_tpu.embed.registry import Embedder as JaxEmbedder
from snuffy_tpu.models.snuffy import build_milnet as jax_build_milnet
from snuffy_tpu.models.snuffy import init_milnet_params
from snuffy_tpu.models.vit import VisionTransformer as JaxViT
from snuffy_tpu.pipeline.slide_inference import _wrap_device_resize
from snuffy_tpu.train.runner import bucket_bags
from snuffy_tpu.train.trainer import SnuffyTrainer as JaxTrainer
from snuffy_tpu_torch.bridge import milnet_from_jax, vit_from_jax
from snuffy_tpu_torch.embed.registry import Embedder
from snuffy_tpu_torch.models.snuffy import build_milnet
from snuffy_tpu_torch.models.vit import VisionTransformer
from snuffy_tpu_torch.pipeline.slide_inference import predict_tiles
from snuffy_tpu_torch.train.trainer import SnuffyTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2)
CFG = SnuffyModelConfig(
    feats_size=64, num_classes=1, num_heads=2, big_lambda=16,
    random_patch_share=0.0, depth=2, activation="gelu", use_pallas=False,
)
# f32 both sides; the ViT, resize and MILNet sums run in other orders.
TOL = dict(rtol=1e-4, atol=1e-5)


def test_predict_tiles_matches_the_jax_pair():
    rng = np.random.default_rng(0)
    tiles = rng.integers(0, 256, (19, 256, 256, 3)).astype(np.uint8)

    jvit = JaxViT(**VIT)
    vparams = jvit.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 224, 224, 3)))["params"]
    jemb = JaxEmbedder(lambda p, im: jvit.apply({"params": p}, im, True),
                       64, 1, params=vparams)
    jemb.init_head(0)
    embed_fn = _wrap_device_resize(jemb.jit_apply(), 224)
    mparams = init_milnet_params(CFG, seed=0, n_example=64)
    jmodel = jax_build_milnet(CFG)

    @jax.jit
    def milnet_apply(p, feats, mask):  # root predict_slide.py:97-103
        ins_logits, bag_logits, _ = jmodel.apply(
            {"params": p}, feats, mask, True,
            rngs={"sparse": jax.random.PRNGKey(0)})
        return jax.nn.sigmoid(ins_logits[:, 0]), jax.nn.sigmoid(bag_logits[0])

    feats, _ = embed_fn(vparams, jemb.head_params, jnp.asarray(tiles))
    padded, mask = pad_bag(np.asarray(feats, np.float32))
    want_ins, want_bag = milnet_apply(mparams, jnp.asarray(padded),
                                      jnp.asarray(mask))

    vit = VisionTransformer(**VIT)
    vit.load_state_dict({k: torch.from_numpy(v)
                         for k, v in vit_from_jax(vparams).items()})
    embedder = Embedder(vit, 64, 1).eval()
    milnet = milnet_from_jax(mparams, CFG, device="cpu")
    pred = predict_tiles(torch.from_numpy(tiles), embedder, milnet,
                         embed_batch=8, embed_size=224)
    assert pred.timings["n_patches"] == 19
    assert {"embed_s", "classify_s", "total_s"} <= set(pred.timings)
    assert pred.instance_scores.shape == (19,)
    np.testing.assert_allclose(pred.instance_scores, np.asarray(want_ins)[:19],
                               **TOL)
    np.testing.assert_allclose(pred.bag_score, float(want_bag), **TOL)


def test_predict_tiles_empty_bag():
    vit = VisionTransformer(**VIT)
    pred = predict_tiles(torch.zeros((0, 224, 224, 3), dtype=torch.uint8),
                         Embedder(vit, 64, 1).eval(),
                         build_milnet(CFG, device="cpu"))
    assert pred.bag_score == 0.0 and pred.timings["n_patches"] == 0


def test_run_eval_epoch_matches_jax():
    """11 bags in one bucket: a chunk of 8 and a tail of 3 padded with 5
    dummy bags, plus a second bucket of 2 bags."""
    rng = np.random.default_rng(1)
    lengths = list(rng.integers(20, 24, 11)) + [36, 33]
    feats = [rng.standard_normal((n, 64)).astype(np.float32) for n in lengths]
    labels = [np.array([float(i % 2)], np.float32) for i in range(13)]
    bucketed = bucket_bags(labels, feats, rng=np.random.default_rng(0))
    assert sorted(len(v[3]) for v in bucketed.values()) == [2, 11]

    cfg = dataclasses.replace(MILTrainConfig(), model=CFG)
    jt = JaxTrainer(cfg)
    state = jt.init_state(0)
    want = jt.run_eval_epoch(state, bucketed, seed=7)

    tt = SnuffyTrainer(cfg, "cpu",
                       model=milnet_from_jax(state.params, CFG, device="cpu"),
                       w=float(state.w))
    got = tt.run_eval_epoch(bucketed, seed=7)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    assert len(got[2]) == len(want[2]) == 13
    for g, w in zip(got[2], want[2]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_package_imports_with_jax_blocked():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        # the card's machine has none of these; PIL only inside workers
        BLOCKED = ("jax", "jaxlib", "flax", "optax", "snuffy_tpu", "pandas",
                   "sklearn", "PIL", "cv2", "matplotlib")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import snuffy_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            snuffy_tpu_torch.__path__, "snuffy_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not leaked, leaked
        print(len(names))
        print(" ".join(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.strip().splitlines()[-2:]
    assert int(count) >= 20
    for new in ("ops.kernels", "ops.dense_attention", "embed.pipeline",
                "compute_feats", "tools.profile_vit_attention",
                "eval.metrics", "data.mil_pickle", "utils.logging",
                "train.runner", "train.cli", "train.__main__",
                "models.resnet", "models.mae", "models.pos_embed",
                "embed.torch_import", "hubconf", "utils.tables",
                "tiling.deepzoom", "deepzoom_tiler_camelyon16",
                "deepzoom_tiler_tcga_lung_cancer", "data.splits",
                "datasets.camelyon16.n_shot_dataset_maker",
                "datasets.camelyon16.train_validation_test_reverse_camelyon",
                "datasets.camelyon16.train_validation_test_splitter_camelyon",
                "datasets.mil_dataset.mil_cross_validation",
                "datasets.tcga.fold_generator",
                "datasets.tcga.n_shot_dataset_maker_tcga",
                "datasets.tcga.train_validation_test_reverse_tcga",
                "datasets.tcga.train_validation_test_splitter_tcga",
                "eval.froc", "froc", "models.dsmil", "snuffy",
                "snuffy_multiclass", "viz.png", "viz.heatmap", "roi",
                "ssl.augment", "ssl.dino", "main_dino_adapter",
                "ssl.adam", "ssl.mae_trainer", "main_pretrain_adapter"):
        assert f"snuffy_tpu_torch.{new}" in names.split()


def test_chip_smoke_names_no_module_of_the_jax_package():
    """chip_smoke.py takes everything, the shared configs included, from
    the port; it names no `snuffy_tpu` module (its functions import
    lazily, so the blocked import above does not see them)."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "snuffy_tpu_torch" in roots
    assert not roots & {"snuffy_tpu", "jax", "jaxlib", "flax", "optax"}, names


def test_predict_slide_cli_on_a_synthetic_slide(tmp_path):
    from snuffy_tpu import native

    if not native.available():
        pytest.skip("native slide reader unavailable")
    from tests.test_tiling import make_slide

    slide = str(tmp_path / "tumor_001.tif")
    make_slide(slide)
    cfg = SnuffyModelConfig(feats_size=384, num_heads=2, big_lambda=8,
                            depth=1)
    weights = str(tmp_path / "milnet.pth")
    torch.save(build_milnet(cfg, seed=5, device="cpu").state_dict(), weights)
    args = [
        "--slide", slide, "--embedder", "DINO", "--backbone", "vit_small",
        "--feats_size", "384", "--big_lambda", "8", "--num_heads", "2",
        "--tile_size", "256", "--embed_size", "224", "--embed_batch", "4",
        "--background_t", "5", "--objective", "20", "--base_mag", "20",
        "--workers", "0", "--bf16", "0", "--device", "cpu",
    ]
    out = subprocess.run(
        [sys.executable, "-m", "snuffy_tpu_torch.predict_slide", *args,
         "--aggregator_weights", weights],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert 0.0 <= rec["bag_score"] <= 1.0
    assert rec["n_patches"] > 0 and rec["total_s"] > 0

    from snuffy_tpu_torch import predict_slide as cli

    with pytest.raises(ValueError, match="export_torch_checkpoint"):
        cli.main(args + ["--aggregator_weights", str(tmp_path / "x.msgpack")])
