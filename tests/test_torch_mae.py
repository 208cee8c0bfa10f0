"""The port's MAE encoder (`embed_tokens`) vs the JAX package.

A small MAE (64-d, depth 2, 4 heads, patch 8, 32² images) crosses from
JAX through `bridge.mae_from_jax`, with and without the parallel adapter
(its up-projections drawn non-zero: at init they are zeros and the adapter
adds exactly 0). `import_mae` of a written `.pth` that carries the decoder
gives the same features and reports the decoder as unused. The ViT-B/16
and ViT-L/16 factories' encoder shapes equal JAX's (shapes only: the JAX
side by `jax.eval_shape`, the port's on the meta device).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snuffy_tpu.embed import torch_import as jax_ti
from snuffy_tpu.models import mae as jax_mae
from snuffy_tpu_torch.bridge import mae_from_jax
from snuffy_tpu_torch.embed import torch_import as ti
from snuffy_tpu_torch.models import mae, vit

SMALL = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
             adapter_bottleneck=8, adapter_scale=4.0)
JAX_DECODER = dict(decoder_embed_dim=32, decoder_depth=1,
                   decoder_num_heads=2)
# f32: max |port − JAX| within 1e-4 of max |JAX|, sums in other orders
# through 2 blocks. bf16: the ViT parity's elementwise tolerance (the JAX
# MHSA rounds its scores to bf16, the port's dense attention keeps f32).
F32_REL = 1e-4
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def jax_small(use_adapter, dtype="float32", seed=0, **kw):
    model = jax_mae.MaskedAutoencoderViT(
        use_adapter=use_adapter, compute_dtype=dtype,
        **{**SMALL, **JAX_DECODER, **kw})
    key = jax.random.PRNGKey(seed)
    params = model.init({"params": key, "masking": key},
                        jnp.zeros((1, 32, 32, 3)), 0.75, True)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed + 100)
    for name, blk in params.items():
        if name.startswith("blocks_") and "adaptmlp" in blk:
            up = blk["adaptmlp"]["up"]
            up["kernel"] = (0.2 * rng.standard_normal(up["kernel"].shape)
                            ).astype(np.float32)
            up["bias"] = (0.1 * rng.standard_normal(up["bias"].shape)
                          ).astype(np.float32)
    return model, params


def port_small(params, use_adapter, dtype="float32", **kw):
    model = mae.MaskedAutoencoderViT(use_adapter=use_adapter,
                                     compute_dtype=dtype, **{**SMALL, **kw})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           mae_from_jax(params).items()}, strict=True)
    return model.eval()


def images(n=3, seed=0):
    return np.random.default_rng(seed).random((n, 32, 32, 3),
                                              dtype=np.float32)


def jax_embed(model, params, x):
    return np.asarray(jax_mae.embed(model, {"params": params},
                                    jnp.asarray(x)))


@pytest.mark.parametrize("use_adapter, kw", [
    (False, {}),
    (True, {}),
    (True, dict(adapter_layernorm_option="in",
                adapter_learnable_scale=True)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_tokens_matches_jax(use_adapter, kw, dtype):
    jm, params = jax_small(use_adapter, dtype, **kw)
    x = images()
    want = jax_embed(jm, params, x)
    with torch.inference_mode():
        got = port_small(params, use_adapter, dtype, **kw)(
            torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 64)
    if dtype == "float32":
        err = float(np.abs(got.numpy() - want).max())
        assert err <= F32_REL * float(np.abs(want).max()), err
    else:
        np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)


def test_dtypes_follow_jax():
    """bf16: the patch embedding and every block's output (the residual
    stream) stay f32, the attention and MLP branches run in bf16, and the
    embedding leaves in f32."""
    model = mae.MaskedAutoencoderViT(use_adapter=True,
                                     compute_dtype="bfloat16", **SMALL)
    seen = []
    mods = [model.patch_embed] + [m for blk in model.blocks
                                  for m in (blk.attn, blk.mlp, blk.adaptmlp,
                                            blk)]
    blocks = list(model.blocks)

    def record(mod, a, out):
        # a block returns (its residual stream, what it carries to the
        # next norm: nothing with an adapter)
        if mod in blocks:
            assert out[1] == vit.NO_CARRY
            out = out[0]
        seen.append(out.dtype)

    for m in mods:
        m.register_forward_hook(record)
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(images(n=1)))
    f32, bf16 = torch.float32, torch.bfloat16
    assert out.dtype == f32
    assert seen == [f32] + [bf16, bf16, bf16, f32] * 2


def test_sincos_grid_is_a_fixed_buffer():
    model = mae.MaskedAutoencoderViT(**SMALL)
    assert "pos_embed" not in model.state_dict()
    assert "pos_embed" not in dict(model.named_parameters())
    from snuffy_tpu.models.pos_embed import sincos_2d

    np.testing.assert_array_equal(model.pos_embed.numpy(), sincos_2d(64, 4))


def test_import_mae_takes_the_encoder_and_reports_the_decoder(tmp_path,
                                                              capsys):
    """A `.pth` in MAE's own layout (encoder, pos_embed, mask_token and the
    decoder, in a 'model' container) through `import_mae` on both sides:
    the same features; the decoder, mask_token and the fixed grids are
    counted unused."""
    jm, params = jax_small(True)
    sd = {k: torch.from_numpy(v) for k, v in mae_from_jax(params).items()}
    extra = {"pos_embed": (1, 17, 64), "mask_token": (1, 1, 32),
             "decoder_pos_embed": (1, 17, 32),
             "decoder_embed.weight": (32, 64), "decoder_embed.bias": (32,),
             "decoder_norm.weight": (32,), "decoder_norm.bias": (32,),
             "decoder_pred.weight": (192, 32), "decoder_pred.bias": (192,)}
    for name, shape in (
            ("norm1.weight", (32,)), ("norm1.bias", (32,)),
            ("attn.qkv.weight", (96, 32)), ("attn.qkv.bias", (96,)),
            ("attn.proj.weight", (32, 32)), ("attn.proj.bias", (32,)),
            ("norm2.weight", (32,)), ("norm2.bias", (32,)),
            ("mlp.fc1.weight", (128, 32)), ("mlp.fc1.bias", (128,)),
            ("mlp.fc2.weight", (32, 128)), ("mlp.fc2.bias", (32,))):
        extra[f"decoder_blocks.0.{name}"] = shape
    gen = torch.Generator().manual_seed(0)
    for k, shape in extra.items():
        sd[k] = torch.randn(shape, generator=gen)
    path = str(tmp_path / "mae.pth")
    torch.save({"model": sd}, path)

    _, fresh = jax_small(True, seed=5)
    jtree = jax_ti.import_mae(jax_ti.load_torch_state_dict(path))
    x = images(seed=1)
    want = jax_embed(jm, jax_ti.merge_into(fresh, jtree), x)

    model = mae.MaskedAutoencoderViT(use_adapter=True, seed=5, **SMALL)
    matched, mismatched = ti.load_embedder_weights(
        model, path, "MAE", "mae_vit_base_patch16")
    out = capsys.readouterr().out
    assert mismatched == [] and len(matched) == len(model.state_dict())
    assert f"0 missing/mismatched, {len(extra)} unused" in out
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= F32_REL * np.abs(want).max()


def port_name_and_shape(path, shape):
    """A flax encoder leaf's name and shape under the port's (MAE's) names:
    `blocks_i` → `blocks.i`, Dense kernels (in, out) → weights (out, in),
    the patch conv (kh, kw, in, out) → (out, in, kh, kw), LayerNorm scale
    → weight, the adapter's down/up/ln → down_proj/up_proj/
    adapter_layer_norm_before."""
    names = {"down": "down_proj", "up": "up_proj",
             "ln": "adapter_layer_norm_before", "scale": "weight",
             "kernel": "weight"}
    parts = [p.replace("blocks_", "blocks.") for p in path]
    if parts[-2:] == ["adaptmlp", "scale"]:
        return ".".join(parts), shape
    if parts[-1] == "kernel":
        shape = ((shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4
                 else shape[::-1])
    return ".".join(names.get(p, p) for p in parts), shape


@pytest.mark.parametrize("name", ["mae_vit_base_patch16",
                                  "mae_vit_large_patch16"])
@pytest.mark.parametrize("use_adapter", [False, True])
def test_factories_have_the_jax_encoder_shapes(name, use_adapter):
    jm = getattr(jax_mae, name)(use_adapter=use_adapter)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: jm.init({"params": key, "masking": key},
                        jnp.zeros((1, 224, 224, 3)), 0.75, True))["params"]
    want = dict(
        port_name_and_shape([str(p.key) for p in path], tuple(leaf.shape))
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
        if not (path[0].key.startswith("decoder")
                or path[0].key == "mask_token"))
    with torch.device("meta"):
        model = getattr(mae, name)(use_adapter=use_adapter)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert tuple(model.pos_embed.shape) == (1, 197, jm.embed_dim)
