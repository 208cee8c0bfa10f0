"""The port's batched DINO augmentation against `snuffy_tpu/ssl/augment.py`.

Seeded draws cannot match across frameworks, so each JAX op's draws are
recomputed from its key by the same split tree the JAX code walks
(`augment.py:35-46` the crop, `:106` the flip, `:113-128` the jitter,
`:139` grayscale, `:145-150,165` the blur, `:172` solarization,
`:181-198,229-243` the views) and fed to the port's *apply*; the port's
own draws are held by structure and statistics. f32; outputs within
1e-5 absolute (images in [0, 1], normalised views within 1e-5 of the
std-scaled range).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snuffy_tpu.ssl import augment as jaug
from snuffy_tpu_torch.ssl import augment

TOL = 1e-5


def u(key, lo=0.0, hi=1.0):
    return jax.random.uniform(key, (), minval=lo, maxval=hi)


def crop_draws(k, scale):
    k1, k2, k3, k4 = jax.random.split(k, 4)
    return {"area": u(k1, *scale),
            "log_ratio": u(k2, jnp.log(3 / 4), jnp.log(4 / 3)),
            "y": u(k3), "x": u(k4)}


def jitter_draws(k):
    ka, kb, kc, kd, ke = jax.random.split(k, 5)
    return {"bright": u(ka, -0.4, 0.4), "contrast": u(kb, -0.4, 0.4),
            "sat": u(kc, -0.2, 0.2), "hue": u(kd, -0.1, 0.1),
            "jitter": jax.random.bernoulli(ke, 0.8)}


def blur_draws(k, p):
    k1, k2 = jax.random.split(k)
    return {"sigma": u(k1, 0.1, 2.0), "blur": jax.random.bernoulli(k2, p)}


def global_draws(k, blur_p, solar_p):
    k = jax.random.split(k, 6)
    d = crop_draws(k[0], (0.4, 1.0))
    d["flip"] = jax.random.bernoulli(k[1], 0.5)
    d.update(jitter_draws(k[2]))
    d["gray"] = jax.random.bernoulli(k[3], 0.2)
    d.update(blur_draws(k[4], blur_p))
    d["solar"] = jax.random.bernoulli(k[5], solar_p)
    return d


def local_draws(k):
    k = jax.random.split(k, 5)
    d = crop_draws(k[0], (0.05, 0.4))
    d["flip"] = jax.random.bernoulli(k[1], 0.5)
    d.update(jitter_draws(k[2]))
    d["gray"] = jax.random.bernoulli(k[3], 0.2)
    d.update(blur_draws(k[4], 0.5))
    d["solar"] = jnp.asarray(False)
    return d


def stack(draws):
    """[{name: scalar}] → {name: (n,) torch tensor}."""
    return {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in draws]))
            for k in draws[0]}


def jax_multicrop_draws(key, b, n_local):
    """The draws `jaug.dino_multicrop_batch` takes from `key`, in the
    port's layout (view-major)."""
    kg1, kg2, kl = jax.random.split(key, 3)
    g = [global_draws(k, 1.0, 0.0) for k in jax.random.split(kg1, b)]
    g += [global_draws(k, 0.1, 0.2) for k in jax.random.split(kg2, b)]
    loc = [local_draws(kk) for k in jax.random.split(kl, n_local)
           for kk in jax.random.split(k, b)]
    return stack(g), (stack(loc) if loc else {})


def images(n, h=40, w=36, seed=0):
    return np.random.default_rng(seed).random((n, h, w, 3)).astype(
        np.float32)


def keys(n, seed=1):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_linspace_grid_is_jaxs():
    for out in (1, 2, 16, 96, 224):
        np.testing.assert_array_equal(augment.linspace01(out).numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, out)))


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("scale", [(0.4, 1.0), (0.05, 0.4), (0.001, 0.002)])
def test_random_resized_crop_matches_jax(method, scale):
    """(0.001, 0.002) makes both sides clip to 8 px."""
    imgs, ks = images(6), keys(6)
    want = jax.vmap(lambda k, im: jaug.random_resized_crop(
        k, im, 24, scale=scale, method=method))(ks, jnp.asarray(imgs))
    d = stack([crop_draws(k, scale) for k in ks])
    got = augment.random_resized_crop(torch.from_numpy(imgs),
                                      torch.arange(6), d, 24, method)
    close(got, want)


def test_hflip_grayscale_solarization_match_jax():
    imgs, ks = images(8, 12, 10), keys(8, 2)
    x = jnp.asarray(imgs)
    t = torch.from_numpy(imgs)
    for jfn, pfn, p in ((jaug.random_hflip, augment.hflip, 0.5),
                        (jaug.random_grayscale, augment.grayscale, 0.2),
                        (jaug.solarization, augment.solarization, 0.5)):
        want = jax.vmap(lambda k, im: jfn(k, im, p=p))(ks, x)
        draw = torch.from_numpy(np.stack([np.asarray(
            jax.random.bernoulli(k, p)) for k in ks]))
        close(pfn(t, draw), want)


def test_color_jitter_matches_jax():
    imgs, ks = images(10, 16, 16, 3), keys(10, 3)
    want = jax.vmap(jaug.color_jitter)(ks, jnp.asarray(imgs))
    d = stack([jitter_draws(k) for k in ks])
    assert d["jitter"].any() and not d["jitter"].all()
    close(augment.color_jitter(torch.from_numpy(imgs), d), want)


@pytest.mark.parametrize("p", [1.0, 0.5])
def test_gaussian_blur_matches_jax(p):
    imgs, ks = images(8, 20, 14, 4), keys(8, 4)
    want = jax.vmap(lambda k, im: jaug.gaussian_blur(k, im, p=p))(
        ks, jnp.asarray(imgs))
    d = stack([blur_draws(k, p) for k in ks])
    close(augment.gaussian_blur(torch.from_numpy(imgs), d["sigma"],
                                d["blur"]), want)


def test_normalize_matches_jax():
    imgs = images(3, 5, 5, 5)
    close(augment.normalize(torch.from_numpy(imgs)),
          jaug.normalize(jnp.asarray(imgs)))


@pytest.mark.parametrize("b, n_local", [(3, 2), (2, 0)])
def test_dino_multicrop_batch_matches_jax(b, n_local):
    """The whole multi-crop batch from uint8 images, the JAX draws
    pinned: every global and local view within 1e-5."""
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (b, 48, 40, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    jg, jl = jaug.dino_multicrop_batch(
        key, jnp.asarray(u8, jnp.float32) / 255.0, n_local=n_local,
        global_size=32, local_size=16)
    g, loc = augment.dino_multicrop_batch(
        torch.from_numpy(u8), None, n_local=n_local, global_size=32,
        local_size=16, draws=jax_multicrop_draws(key, b, n_local))
    assert g.shape == (2, b, 32, 32, 3) and loc.shape == (n_local, b, 16,
                                                          16, 3)
    close(g, jg)
    close(loc, jl)


def test_port_draws_structure_and_statistics():
    """The port's own draws: ranges, and each Bernoulli's rate within
    0.02 of its probability over 20000 crops (4.5 sigma at p = 0.5)."""
    gen = torch.Generator().manual_seed(0)
    b, n_local = 10000, 2
    g, loc = augment.multicrop_draws(gen, b, n_local,
                                     device=torch.device("cpu"))
    for d, scale in ((g, (0.4, 1.0)), (loc, (0.05, 0.4))):
        assert d["area"].min() >= scale[0] and d["area"].max() < scale[1]
        assert abs(float(d["area"].mean()) - sum(scale) / 2) < 0.01
        assert d["log_ratio"].min() >= math.log(3 / 4) - 1e-6
        assert d["log_ratio"].max() < math.log(4 / 3)
        assert d["sigma"].min() >= 0.1 and d["sigma"].max() < 2.0
        for key, p in (("flip", 0.5), ("jitter", 0.8), ("gray", 0.2)):
            assert abs(float(d[key].float().mean()) - p) < 0.02, key
    v1, v2 = slice(0, b), slice(b, 2 * b)
    assert bool(g["blur"][v1].all()) and not bool(g["solar"][v1].any())
    assert abs(float(g["blur"][v2].float().mean()) - 0.1) < 0.02
    assert abs(float(g["solar"][v2].float().mean()) - 0.2) < 0.02
    assert abs(float(loc["blur"].float().mean()) - 0.5) < 0.02
    assert not bool(loc["solar"].any())


def test_port_crops_stay_in_their_windows():
    """A crop of an image whose pixel values are its row index spans
    exactly its window's rows: the grid's ends are the window's."""
    h, w, out = 64, 48, 16
    ramp = np.broadcast_to(np.arange(h, dtype=np.float32)[None, :, None,
                                                          None],
                           (4, h, w, 3)).copy()
    gen = torch.Generator().manual_seed(3)
    d = augment.draw_views(gen, 4, (0.05, 1.0), 0.0, 0.0,
                           torch.device("cpu"))
    ys, _ = augment.crop_grid(h, w, d["area"], d["log_ratio"], d["y"],
                              d["x"], out)
    crop = augment.random_resized_crop(torch.from_numpy(ramp),
                                       torch.arange(4), d, out)
    np.testing.assert_allclose(crop[:, :, 0, 0].numpy(), ys.numpy(),
                               atol=1e-4)
    assert float(ys.min()) >= 0 and float(ys.max()) <= h - 1


def test_multicrop_from_the_generator_is_deterministic():
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 40, 40, 3), dtype=np.uint8))
    outs = [augment.dino_multicrop_batch(
        u8, torch.Generator().manual_seed(9), n_local=2, global_size=24,
        local_size=16) for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
