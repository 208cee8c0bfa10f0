"""The port's own copies of the JAX package's JAX-free modules.

The port imports nothing of `snuffy_tpu`; these tests hold each copy to
its original: the config dataclasses field by field, the bucketing, the
bridge's MILNet name map against the JAX exporter, and the slide reader
on a synthetic slide.
"""

import dataclasses

import numpy as np
import pytest

from snuffy_tpu import configs as jax_configs
from snuffy_tpu.data import bucketing as jax_bucketing
from snuffy_tpu.embed.torch_export import export_milnet
from snuffy_tpu.models.snuffy import init_milnet_params
from snuffy_tpu.tiling import deepzoom as jax_deepzoom
from snuffy_tpu_torch import configs
from snuffy_tpu_torch.bridge import milnet_state_dict
from snuffy_tpu_torch.data import bucketing
from snuffy_tpu_torch.tiling import deepzoom


def defaults(cls):
    out = []
    for f in dataclasses.fields(cls):
        value = (f.default_factory() if f.default_factory
                 is not dataclasses.MISSING else f.default)
        if dataclasses.is_dataclass(value):
            value = dataclasses.asdict(value)
        out.append((f.name, f.type, value))
    return out


@pytest.mark.parametrize("name", ["SnuffyModelConfig", "OptimizerConfig",
                                  "MILTrainConfig"])
def test_configs_have_the_jax_fields_and_defaults(name):
    ours, theirs = getattr(configs, name), getattr(jax_configs, name)
    assert defaults(ours) == defaults(theirs)
    assert ours.__dataclass_params__.frozen


@pytest.mark.parametrize("share", [0.0, 0.25, 0.5, 1.0])
def test_model_config_counts_match(share):
    kw = dict(big_lambda=513, random_patch_share=share)
    ours = configs.SnuffyModelConfig(**kw)
    theirs = jax_configs.SnuffyModelConfig(**kw)
    assert (ours.k_top, ours.k_rand, ours.top_share) == (
        theirs.k_top, theirs.k_rand, theirs.top_share)


def test_tiler_config_and_read_level_match():
    assert defaults(deepzoom.TilerConfig) == defaults(jax_deepzoom.TilerConfig)

    class Slide:
        level_count = 3

        def level_downsample(self, level):
            return (1.0, 2.0, 4.0)[level]

    for target in (1.0, 1.5, 2.0, 3.0, 8.0):
        assert deepzoom.pick_read_level(Slide(), target) == \
            jax_deepzoom.pick_read_level(Slide(), target)
    tile = np.random.default_rng(0).integers(0, 256, (64, 64, 3), np.uint8)
    assert deepzoom.edge_energy(tile) == jax_deepzoom.edge_energy(tile)


def test_bucketing_matches():
    assert bucketing.DEFAULT_BUCKETS == jax_bucketing.DEFAULT_BUCKETS
    for n in (0, 15, 16, 100, 10000, 49151):
        assert bucketing.bucket_length(n) == jax_bucketing.bucket_length(n)
    with pytest.raises(ValueError):
        bucketing.bucket_length(49152)
    feats = np.random.default_rng(1).standard_normal((37, 5), np.float32)
    for a, b in zip(bucketing.pad_bag(feats), jax_bucketing.pad_bag(feats)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bridge_name_map_is_the_jax_exporter():
    cfg = jax_configs.SnuffyModelConfig(feats_size=16, num_heads=2,
                                        big_lambda=4, depth=3)
    params = init_milnet_params(cfg, seed=2, n_example=16)
    want = export_milnet(params)
    got = milnet_state_dict(params)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == np.float32 and got[name].flags.writeable
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("workers", [1, 2])
def test_read_slide_tiles_matches_jax(tmp_path, workers):
    from snuffy_tpu import native as jax_native
    from snuffy_tpu.pipeline.slide_inference import (
        read_slide_tiles as jax_read,
    )
    from snuffy_tpu_torch import native
    from snuffy_tpu_torch.pipeline.slide_inference import read_slide_tiles
    from tests.test_tiling import make_slide

    if not (native.available() and jax_native.available()):
        pytest.skip("native slide reader unavailable (g++ or libtiff)")
    assert native.BUILD_DIR.name == "snuffy_tpu_torch"
    slide = str(tmp_path / "slide.tif")
    make_slide(slide)
    for cfg in (deepzoom.TilerConfig(background_threshold=5.0),
                deepzoom.TilerConfig(tile_size=128, objective_power=40.0,
                                     base_mag=10.0)):
        jcfg = jax_deepzoom.TilerConfig(**dataclasses.asdict(cfg))
        tiles, positions = read_slide_tiles(slide, cfg, workers)
        want_tiles, want_positions = jax_read(slide, jcfg, 1)
        assert len(positions) > 0
        assert positions == want_positions
        np.testing.assert_array_equal(tiles, want_tiles)
    with pytest.raises(FileNotFoundError):
        native.NativeSlide(str(tmp_path / "missing.tif"))
