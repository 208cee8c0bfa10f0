"""The ViT's position-grid resize vs `jax.image.resize(..., "bicubic")`.

The port builds the resize's weight matrices in numpy from jax.image's
definition (Keys' cubic with a = −0.5, half-pixel centres, the kernel
widened by the scale on a downscale, weights renormalised at the edges)
and applies them in f32. The matrices are held bit for bit to jax.image's
own, the resized grids to `jax.image.resize` up and down, and ViT-S/16
(depth 2) at 256² and 192² input to the JAX model in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from snuffy_tpu.models.vit import VisionTransformer as JaxViT
from snuffy_tpu.models.vit import interpolate_pos_encoding as jax_interp
from snuffy_tpu_torch.bridge import vit_from_jax
from snuffy_tpu_torch.models.vit import (
    VisionTransformer,
    bicubic_weights,
    interpolate_pos_encoding,
)

GRIDS = [(14, 16), (14, 12), (14, 28), (7, 5)]


@pytest.mark.parametrize("g0, g", GRIDS)
def test_weights_are_jax_image_weights_bit_for_bit(g0, g):
    want = jax_scale.compute_weight_mat(g0, g, g / g0, 0.0,
                                        jax_scale._fill_keys_cubic_kernel,
                                        True)
    got = bicubic_weights(g0, g)
    assert got.dtype == torch.float32 and got.shape == (g, g0)
    np.testing.assert_array_equal(got.numpy().T, np.asarray(want))


@pytest.mark.parametrize("g0, g", GRIDS)
def test_resize_matches_jax_image_resize(g0, g):
    """Up (14→16, 14→28) and down (14→12, 7→5), square and not. The
    grids are drawn at 5× the scale the ViT initialises them at
    (σ = 0.1 against trunc_normal 0.02), within 1e-6 absolute of JAX. At
    unit scale JAX's own f32 contraction lies ≈ 2e-6 from an f64 one (8
    f32 ulps), so the port is also held to f64 there, within 5e-7."""
    rng = np.random.default_rng(g0 * 100 + g)
    for gh, gw in ((g, g), (g, g0 + 1)):
        pe = (0.1 * rng.standard_normal((1, 1 + g0 * g0, 24))
              ).astype(np.float32)
        want = np.asarray(jax_interp(jnp.asarray(pe), gh * gw, gw * 16,
                                     gh * 16, 16))
        got = interpolate_pos_encoding(torch.from_numpy(pe), gh * gw,
                                       gw * 16, gh * 16, 16)
        assert got.shape == want.shape == (1, 1 + gh * gw, 24)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

        unit = rng.standard_normal((1, 1 + g0 * g0, 24)).astype(np.float32)
        wh = bicubic_weights(g0, gh).double().numpy()
        ww = bicubic_weights(g0, gw).double().numpy()
        f64 = np.einsum("oh,hwd,pw->opd", wh,
                        unit[0, 1:].reshape(g0, g0, 24).astype(np.float64),
                        ww).reshape(gh * gw, 24)
        got = interpolate_pos_encoding(torch.from_numpy(unit), gh * gw,
                                       gw * 16, gh * 16, 16)[0, 1:]
        np.testing.assert_allclose(got.numpy(), f64, rtol=0, atol=5e-7)


def test_the_grid_it_was_trained_at_is_left_as_it_is():
    pe = torch.randn(1, 197, 8)
    assert interpolate_pos_encoding(pe, 196, 224, 224, 16) is pe


SMALL = dict(patch_size=16, embed_dim=384, depth=2, num_heads=6)


@pytest.mark.parametrize("size", [256, 192])
def test_vit_s16_at_other_sizes_matches_jax(size):
    jm = JaxViT(compute_dtype="float32", **SMALL)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 224, 224, 3)))["params"]
    model = VisionTransformer(compute_dtype="float32", **SMALL)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           vit_from_jax(params).items()}, strict=True)
    x = np.random.default_rng(size).random((2, size, size, 3),
                                           dtype=np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), True))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 384)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
