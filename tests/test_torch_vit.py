"""Port's DINO ViT and embedder vs the JAX package.

A small ViT (dim 64, depth 2, 2 heads, patch 16, 224² input) crosses from
JAX through `bridge.vit_from_jax` (strict load); uint8 tiles are cast and
normalised on the model's device by the port's Embedder and by the JAX
`Embedder.jit_apply`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snuffy_tpu.embed.registry import Embedder as JaxEmbedder
from snuffy_tpu.models.vit import VisionTransformer as JaxViT
from snuffy_tpu_torch.bridge import load_reference_pth, vit_from_jax
from snuffy_tpu_torch.embed.registry import Embedder, build_embedder
from snuffy_tpu_torch.models.vit import VisionTransformer

SMALL = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2)
# f32: sums in other orders through 2 blocks. bf16: activations rounded at
# other places (LayerNorm, softmax) in the two frameworks.
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def jax_small(dtype):
    model = JaxViT(compute_dtype=dtype, **SMALL)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 224, 224, 3)))["params"]
    return model, params


def torch_small(params, dtype):
    model = VisionTransformer(compute_dtype=dtype, **SMALL)
    model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in vit_from_jax(params).items()},
        strict=True)
    return model.eval()


def tiles(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, 224, 224, 3)).astype(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_cls_matches_jax(dtype):
    jm, params = jax_small(dtype)
    x = tiles().astype(np.float32) / 255.0
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), True))
    with torch.inference_mode():
        got = torch_small(params, dtype)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_dtype_reaches_every_block(dtype):
    """The bf16 tolerance above would also pass an f32 run: check that the
    patch embedding, every attention and MLP branch and every block's
    residual stream run in the compute dtype."""
    model = VisionTransformer(compute_dtype=dtype, **SMALL).eval()
    seen = []
    mods = [model.patch_embed] + [m for blk in model.blocks
                                  for m in (blk.attn, blk.mlp, blk)]
    for m in mods:
        m.register_forward_hook(lambda mod, args, out: seen.append(out.dtype))
    with torch.inference_mode():
        out = model(torch.from_numpy(tiles(n=1).astype(np.float32) / 255.0))
    assert out.dtype == torch.float32
    assert seen == [getattr(torch, dtype)] * len(mods)


@pytest.mark.parametrize("imagenet_norm", [False, True])
def test_embedder_uint8_matches_jax_jit_apply(imagenet_norm):
    jm, params = jax_small("float32")
    jemb = JaxEmbedder(lambda p, im: jm.apply({"params": p}, im, True),
                       64, 2, params=params)
    jemb.init_head(0)
    x = tiles(seed=1)
    want_f, want_l = jemb.jit_apply(imagenet_norm)(
        params, jemb.head_params, jnp.asarray(x))

    emb = Embedder(torch_small(params, "float32"), 64, 2, imagenet_norm)
    with torch.no_grad():
        emb.head.weight.copy_(torch.from_numpy(
            np.array(jemb.head_params["kernel"]).T))
    with torch.inference_mode():
        feats, logits = emb.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_f),
                               **TOL["float32"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_l),
                               **TOL["float32"])


def test_profile_flop_count_matches_torch_flop_counter():
    """The ViT FLOPs that profile_serve divides by its device time are the
    ones torch counts for the model's matmuls."""
    from torch.utils.flop_counter import FlopCounterMode

    from snuffy_tpu_torch.tools.profile_serve import vit_flops_per_tile

    model = VisionTransformer(**SMALL).eval()
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model(torch.zeros(1, 224, 224, 3))
    assert counter.get_total_flops() == vit_flops_per_tile(
        dim=64, depth=2, patch=16, size=224)


def test_other_grid_sizes_raise_instead_of_differing():
    """Another patch grid neither raises nor differs: the position grid is
    resized with JAX's bicubic weights (tests/test_torch_pos_interp.py),
    and a 64² input (4×4 patches, a downscale from 14×14) gives the JAX
    model's embedding."""
    jm, params = jax_small("float32")
    x = tiles(n=2)[:, :64, :64].astype(np.float32) / 255.0
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), True))
    with torch.inference_mode():
        got = torch_small(params, "float32")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])


def test_unported_embedders_name_their_roadmap_item():
    """SimCLR and MAE build now; the one embedder left unported is the
    DINO XCiT hub entry, whose models were never written."""
    from snuffy_tpu_torch.hubconf import load_dino_xcit

    meta = torch.device("meta")   # shapes only: no weights drawn
    for name, backbone, dim in (("SimCLR", "resnet18", 512),
                                ("MAE", "mae_vit_base_patch16", 768)):
        with meta:
            emb = build_embedder(name, backbone, device=meta)
        assert emb.head.in_features == dim
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_dino_xcit("dino_xcit_small_12_p16")


def test_dino_state_dict_loads_strict_through_prefixes(tmp_path):
    """A DINO-style checkpoint (keys under `module.backbone.` inside a
    'teacher' container) loads strict after load_reference_pth."""
    dst = VisionTransformer(seed=1, **SMALL)
    src = VisionTransformer(seed=2, **SMALL)
    assert not torch.equal(dst.pos_embed, src.pos_embed)
    path = tmp_path / "dino.pth"
    torch.save({"teacher": {f"module.backbone.{k}": v
                            for k, v in src.state_dict().items()}}, path)
    dst.load_state_dict(load_reference_pth(str(path)), strict=True)
    assert torch.equal(dst.pos_embed, src.pos_embed)
