"""The port's own copies of the JAX package's JAX-free modules.

The port imports nothing of `snuffy_tpu`; these tests hold each copy to
its original: the config dataclasses field by field, the bucketing, the
bridge's MILNet name map against the JAX exporter, and the slide reader
on a synthetic slide.
"""

import dataclasses
import os
import subprocess
import sys

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def test_position_and_patch_label_parsers_match(tmp_path):
    from snuffy_tpu.embed import pipeline as jax_pipeline
    from snuffy_tpu_torch.embed import pipeline

    for name in ("12_34.jpeg", "a/b/0_7-3.JPG", "5_6.jpg", "x.jpeg",
                 "1_2.png", "7_8-9.jpeg"):
        assert pipeline.parse_position(name) == \
            jax_pipeline.parse_position(name)
    path = tmp_path / "tile_label.csv"
    path.write_text("s_1_2,1\ns_3_4,0\nt_1_2,1\ns_1_2,1\n")
    assert pipeline.load_patch_labels(str(path)) == \
        jax_pipeline.load_patch_labels(str(path))
    path.write_text("s_1_2,1\ns_1_2,0\n")
    for mod in (pipeline, jax_pipeline):
        with pytest.raises(ValueError, match="conflicting"):
            mod.load_patch_labels(str(path))


def test_bag_listing_and_csv_writers_match(tmp_path):
    from snuffy_tpu.embed import pipeline as jax_pipeline
    from snuffy_tpu_torch.embed import pipeline

    for bag in ("train/0_n/s0", "train/1_t/s1", "test/0_n/s2", "empty"):
        (tmp_path / "single" / "f1" / bag).mkdir(parents=True)
    for bag, name in (("train/0_n/s0", "1_2.jpeg"),
                      ("train/1_t/s1", "3_4.jpg"), ("test/0_n/s2", "5_6.jpeg")):
        (tmp_path / "single" / "f1" / bag / name).write_bytes(b"")
    assert pipeline.list_bags(str(tmp_path), "f1") == \
        jax_pipeline.list_bags(str(tmp_path), "f1")

    rng = np.random.default_rng(5)
    feats = (rng.standard_normal((9, 6))
             * 10.0 ** rng.integers(-9, 5, (9, 6))).astype(np.float32)
    feats[0, :2] = (0.0, -0.0)
    positions = [f"{i}_{i + 1}" for i in range(9)]
    labels = [i % 2 for i in range(9)]
    for args in ((feats,), (feats, positions, labels)):
        ours, theirs = tmp_path / "o" / "bag.csv", tmp_path / "t" / "bag.csv"
        pipeline.write_bag_csv(str(ours), *args)
        jax_pipeline.write_bag_csv(str(theirs), *args)
        assert ours.read_bytes() == theirs.read_bytes()
    rows = [("a/b.csv", 1), ("c,d.csv", 0)]
    pipeline.write_dataset_csv(str(tmp_path / "o" / "ds.csv"), rows)
    jax_pipeline.write_dataset_csv(str(tmp_path / "t" / "ds.csv"), rows)
    assert (tmp_path / "o" / "ds.csv").read_bytes() == \
        (tmp_path / "t" / "ds.csv").read_bytes()


@pytest.mark.parametrize("n, seed", [(1, 0), (7, 0), (12, 3), (200, 11)])
def test_save_class_features_matches_pandas_order(tmp_path, n, seed):
    from snuffy_tpu.embed import pipeline as jax_pipeline
    from snuffy_tpu_torch.embed import pipeline

    for root in ("o", "t"):
        for i in range(n):
            split, cls = ("train", "test")[i % 2], ("0_n", "1_t", "2_x")[i % 3]
            d = tmp_path / root / split / cls
            d.mkdir(parents=True, exist_ok=True)
            (d / f"slide_{i}.csv").write_text("0\n")
    ours = pipeline.save_class_features(str(tmp_path / "o"), "ds.csv",
                                        seed=seed)
    theirs = jax_pipeline.save_class_features(str(tmp_path / "t"), "ds.csv",
                                              seed=seed)
    assert [(os.path.relpath(p, tmp_path / "o"), c) for p, c in ours] == [
        (os.path.relpath(p, tmp_path / "t"), c)
        for p, c in zip(theirs.iloc[:, 0], theirs["label"])]
    for name in ["ds.csv"] + [f"{s}/{c}.csv" for s in ("train", "test")
                              for c in ("0_n", "1_t", "2_x")]:
        o, t = tmp_path / "o" / name, tmp_path / "t" / name
        assert o.exists() == t.exists()
        if o.exists():
            assert o.read_text().replace(str(tmp_path / "o"), "") == \
                t.read_text().replace(str(tmp_path / "t"), "")
    assert pipeline.save_class_features(str(tmp_path / "o"), "x.csv",
                                        droped=1) is None


def test_compute_feats_flags_are_the_root_flags():
    import compute_feats as root_cli

    from snuffy_tpu_torch import compute_feats

    def flags(parser):
        return {a.dest: (a.option_strings, a.default, a.type, a.choices,
                         a.nargs, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    ours = flags(compute_feats.get_args_parser())
    assert ours.pop("device")[1] == "cuda"
    assert ours == flags(root_cli.get_args_parser())


def test_config_helpers_match():
    assert configs.HISTOPATHOLOGY_DATASETS == \
        jax_configs.HISTOPATHOLOGY_DATASETS
    assert configs.MIL_DATASETS == jax_configs.MIL_DATASETS
    assert configs.MIL_DATASET_FEATS_SIZE == jax_configs.MIL_DATASET_FEATS_SIZE
    for value in ("[0.5, 0.9]", "['xavier_normal', 'kaiming_uniform', 'x']",
                  ["[1,", " 2]"], (0.1, 0.2)):
        assert configs.parse_literal_flag(value) == \
            jax_configs.parse_literal_flag(value)
    for dataset in ("musk1", "musk2", "elephant", "camelyon16", "tcga"):
        assert configs.resolve_feats_size(dataset, 384) == \
            jax_configs.resolve_feats_size(dataset, 384)
    cfg = configs.replace(configs.MILTrainConfig(), seed=9, run_name="r")
    assert (cfg.seed, cfg.run_name) == (9, "r")


def test_logging_matches(tmp_path):
    from snuffy_tpu.utils import logging as jax_logging
    from snuffy_tpu_torch.utils import logging

    row = {"epoch": 3, "lr": 1e-3, "epoch_train_loss": 0.5,
           "epoch_valid_aucs": [0.25, 0.75], "epoch_test_best_feat_aucs":
           (0.5,), "step_train_loss": 2.0, "time_s": 1.5,
           "epoch_valid_ece": np.float32(0.125)}
    assert logging.to_wandb_format(row) == jax_logging.to_wandb_format(row)
    for module, name in ((logging, "port"), (jax_logging, "jax")):
        log = module.MetricsLogger(str(tmp_path / name / "m.jsonl"))
        log.log(row)
        log.log({"epoch_test_last_aucs": [1.0]})
    assert (tmp_path / "port" / "m.jsonl").read_text() == \
        (tmp_path / "jax" / "m.jsonl").read_text()
    logging.MetricsLogger().log(row)  # no path: nothing written


def test_load_mil_data_matches(tmp_path):
    import pickle

    from snuffy_tpu.data import mil_pickle as jax_mil
    from snuffy_tpu_torch.data import mil_pickle

    rng = np.random.default_rng(0)
    bags = [[(-1, 0, 1, 2)[b % 4],
             np.array(list(rng.standard_normal((int(n), 230))), dtype=object)]
            for b, n in enumerate(rng.integers(2, 9, 30))]
    os.makedirs(tmp_path / "Elephant")
    with open(tmp_path / "Elephant" / "data_100x100_5folds_0.2split.pkl",
              "wb") as f:
        pickle.dump(bags, f)
    for fold in (0, 4):
        got = mil_pickle.load_mil_data("elephant", 230, 5, fold, 0.2,
                                       mil_datasets_base_path=str(tmp_path))
        want = jax_mil.load_mil_data("elephant", 230, 5, fold, 0.2,
                                     mil_datasets_base_path=str(tmp_path))
        for g, w in zip(got, want):
            assert g[2:] == w[2:] == (None, None)
            for a, b in zip(g[0] + g[1], w[0] + w[1]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert len(g[0]) == len(w[0]) > 0


def test_train_flags_are_the_root_flags():
    import train as root_cli

    from snuffy_tpu_torch.train import cli

    def flags(parser):
        return {a.dest: (a.option_strings, a.default, a.type, a.choices,
                         a.nargs, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    ours = flags(cli.get_args_parser())
    assert ours.pop("device")[1] == "cuda"
    assert ours == flags(root_cli.get_args_parser())


def test_slide_cli_flags_are_the_root_flags(monkeypatch):
    """The port's slide CLI builds its parser with the root script out of
    reach (`predict_slide` blocked), and its flags are the root's, plus
    the port's own."""
    from snuffy_tpu_torch import predict_slide as port_cli

    def flags(parser):
        return {a.dest: (a.option_strings, a.default, a.type, a.choices,
                         a.nargs, a.required, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    with monkeypatch.context() as m:
        m.setitem(sys.modules, "predict_slide", None)
        ours = flags(port_cli.get_args_parser())
    import predict_slide as root_cli

    assert ours.pop("device")[1] == "cuda"
    own = {name: ours.pop(name)[1] for name in
           ("patch_size", "use_adapter", "ffn_num", "adapter_ffn_scalar")}
    assert own == dict(patch_size=16, use_adapter=0, ffn_num=64,
                       adapter_ffn_scalar=4.0)
    assert ours == flags(root_cli.get_args_parser())


def test_slide_cli_runs_without_the_repository_root(tmp_path):
    """`python -m snuffy_tpu_torch.predict_slide --help` from a directory
    that holds the package and no root script: the port's CLI needs no
    file of the repository outside its package."""
    os.symlink(os.path.join(REPO, "snuffy_tpu_torch"),
               tmp_path / "snuffy_tpu_torch")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "snuffy_tpu_torch.predict_slide", "--help"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "--slide" in out.stdout and "--scaled_decode" in out.stdout


@pytest.mark.parametrize("module", ["models.pos_embed", "utils.tables"])
def test_verbatim_copies_are_their_originals(module):
    """`models/pos_embed.py` and `utils/tables.py` import nothing of JAX;
    the port keeps them byte for byte."""
    import importlib

    ours = importlib.import_module(f"snuffy_tpu_torch.{module}")
    theirs = importlib.import_module(f"snuffy_tpu.{module}")
    with open(ours.__file__, "rb") as a, open(theirs.__file__, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("dim, grid, cls", [(64, 4, True), (768, 14, True),
                                            (1024, 14, False), (12, 7, True)])
def test_sincos_grid_matches(dim, grid, cls):
    from snuffy_tpu.models import pos_embed as jax_pos_embed
    from snuffy_tpu_torch.models import pos_embed

    got = pos_embed.sincos_2d(dim, grid, cls)
    want = jax_pos_embed.sincos_2d(dim, grid, cls)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_layer_audit_tables_match(capsys):
    from snuffy_tpu.utils import tables as jax_tables
    from snuffy_tpu_torch.utils import tables

    matched = [f"blocks.{i}.w" for i in range(5)]
    for mismatched in ([], [f"m{i}" for i in range(3)],
                       [f"m{i}" for i in range(25)]):
        assert tables.print_layer_audit(matched, mismatched) == \
            jax_tables.print_layer_audit(matched, mismatched)
    assert tables.print_table({"a": 1, "bb": 2.5}) == \
        jax_tables.print_table({"a": 1, "bb": 2.5})
    capsys.readouterr()


def test_build_embedder_takes_the_jax_arguments_and_defaults():
    """The JAX `build_embedder`'s parameters, in its order and with its
    defaults (SimCLR/resnet18, norm_layer), then the port's
    `imagenet_norm` (the JAX `Embedder.jit_apply`'s argument) and
    `device`."""
    import inspect

    from snuffy_tpu.embed import registry as jax_registry
    from snuffy_tpu_torch.embed import registry

    ours = inspect.signature(registry.build_embedder).parameters
    theirs = inspect.signature(jax_registry.build_embedder).parameters
    assert [(p.name, p.default, p.kind) for p in theirs.values()] == \
        [(p.name, p.default, p.kind) for p in ours.values()][:len(theirs)]
    assert list(ours)[len(theirs):] == ["imagenet_norm", "device"]
    assert registry.EMBEDDER_FEAT_DIMS == jax_registry.EMBEDDER_FEAT_DIMS


def test_evaluation_copies_match():
    """The constants the FROC, the splits, the MIL pickles and the heat
    maps copy from the JAX package (and matplotlib's jet segments)."""
    import matplotlib._cm

    from snuffy_tpu.data import mil_pickle as jax_mil
    from snuffy_tpu.data import splits as jax_splits
    from snuffy_tpu.eval import froc as jax_froc
    from snuffy_tpu.viz import heatmap as jax_heatmap
    from snuffy_tpu_torch.data import mil_pickle, splits
    from snuffy_tpu_torch.eval import froc
    from snuffy_tpu_torch.viz import heatmap

    for name in ("TUMOR_LABEL", "DILATION_DISTANCE_UM", "ITC_DIAMETER_UM",
                 "TARGET_FPS"):
        assert getattr(froc, name) == getattr(jax_froc, name), name
    np.testing.assert_array_equal(froc.EIGHT_CONNECTED,
                                  jax_froc.EIGHT_CONNECTED)
    assert heatmap._POS_RE.pattern == jax_heatmap._POS_RE.pattern
    assert splits.SPLIT_NAMES == jax_splits.SPLIT_NAMES
    assert mil_pickle.MIL_DATASET_REGISTRY == jax_mil.MIL_DATASET_REGISTRY
    assert mil_pickle.MIL_FILE_STEMS == jax_mil.MIL_FILE_STEMS
    assert mil_pickle.MIL_FOLDER_NAMES == jax_mil.MIL_FOLDER_NAMES
    assert {k: tuple(map(tuple, v)) for k, v in heatmap.JET_DATA.items()} \
        == {k: tuple(map(tuple, v))
            for k, v in matplotlib._cm._jet_data.items()}


def test_tiler_grid_and_levels_match(tmp_path):
    """`_grid`'s read size and grid, and `pick_read_level`'s level and
    residual, at pyramids whose level ratio is not whole."""
    class Slide:
        def __init__(self, dims):
            self.dims = dims
            self.level_count = len(dims)

        def level_dimensions(self, level):
            return self.dims[level]

        def level_downsample(self, level):
            return self.dims[0][0] / self.dims[level][0]

    for dims in ([(1536, 1536), (512, 512)], [(3001, 3999), (1500, 1999),
                                               (750, 999)]):
        s = Slide(dims)
        for target in (1.0, 2.0, 4.0, 8.0):
            level, residual = deepzoom.pick_read_level(s, target)
            assert (level, residual) == jax_deepzoom.pick_read_level(s,
                                                                     target)
            assert deepzoom._grid(s, level, residual, 256) == \
                jax_deepzoom._grid(s, level, residual, 256)


# ------------------------------------------ the DINO pretraining slice's


def test_ssl_schedules_match():
    from snuffy_tpu.ssl import schedules as jax_sched
    from snuffy_tpu_torch.ssl import schedules

    for args in ((1.0, 0.1, 10, 10, 2), (5e-4, 1e-6, 3, 7, 0),
                 (0.996, 1.0, 4, 0, 0), (0.04, 0.4, 1, 5, 1, 0.01)):
        ours, theirs = (m.cosine_iter_schedule(*args)
                        for m in (schedules, jax_sched))
        assert [ours(i) for i in range(60)] == [theirs(i) for i in range(60)]
    for args in ((1.0, 0.0, 10, 2), (1e-3, 1e-6, 5, 0)):
        ours, theirs = (m.mae_lr_schedule(*args)
                        for m in (schedules, jax_sched))
        assert [ours(e / 3) for e in range(40)] == [theirs(e / 3)
                                                    for e in range(40)]


def test_retrieval_matches():
    from snuffy_tpu.ssl import retrieval as jax_ret
    from snuffy_tpu_torch.ssl import retrieval

    rng = np.random.default_rng(0)
    train = rng.normal(size=(60, 8))
    labels = rng.integers(0, 3, 60)
    test = rng.normal(size=(15, 8))
    np.testing.assert_array_equal(
        retrieval.knn_classify(train, labels, test, k=7),
        jax_ret.knn_classify(train, labels, test, k=7))
    ours, theirs = retrieval.PCA(4, 0.5), jax_ret.PCA(4, 0.5)
    ours.train_pca(train)
    theirs.train_pca(train)
    np.testing.assert_array_equal(ours.apply(test), theirs.apply(test))
    ranks = np.array([0, 3, 9])
    assert retrieval.compute_ap(ranks, 3) == jax_ret.compute_ap(ranks, 3)
    positives = [{0, 1, 2}, {5, 7}]
    assert retrieval.retrieval_map(test[:2], train, positives) == \
        jax_ret.retrieval_map(test[:2], train, positives)
    assert retrieval.compute_map([np.arange(10)], [{3}]) == \
        jax_ret.compute_map([np.arange(10)], [{3}])


def test_bool_flag_matches():
    import argparse

    for value in ("on", "OFF", "true", "False", "0", "1", True, False):
        assert configs.bool_flag(value) == jax_configs.bool_flag(value)
    for value in ("maybe", "", "2"):
        for fn in (configs.bool_flag, jax_configs.bool_flag):
            with pytest.raises(argparse.ArgumentTypeError):
                fn(value)


def test_truncate_log_past_epoch_matches(tmp_path):
    from snuffy_tpu.utils import logging as jax_logging
    from snuffy_tpu_torch.utils import logging

    rows = ['{"epoch": 0, "train_loss": 1.0}', '{"epoch": 1}',
            '{"note": "no epoch field"}', "not json at all", "",
            '{"epoch": 2, "x": 0.8}', '{"epoch": "3"}', '{"epoch": 1.5}']
    for name in ("port", "jax"):
        (tmp_path / name).write_text("\n".join(rows))
    for resume in (2, 1, 0):
        assert logging.truncate_log_past_epoch(
            str(tmp_path / "port"), resume) == \
            jax_logging.truncate_log_past_epoch(str(tmp_path / "jax"),
                                                resume)
        assert (tmp_path / "port").read_text() == \
            (tmp_path / "jax").read_text()
    assert logging.truncate_log_past_epoch(str(tmp_path / "none"), 1) == 0


def test_meters_match_on_one_process():
    from snuffy_tpu.utils import metrics_sync as jax_ms
    from snuffy_tpu_torch.utils import metrics_sync

    values = [0.5, 2.0, 1.25, 3.0, 0.75]
    for window in (3, 20):
        ours = metrics_sync.SmoothedValue(window, "{median} {avg} {max}")
        theirs = jax_ms.SmoothedValue(window, "{median} {avg} {max}")
        for i, v in enumerate(values):
            ours.update(v, n=i + 1)
            theirs.update(v, n=i + 1)
        ours.synchronize_between_processes()
        theirs.synchronize_between_processes()
        for attr in ("median", "avg", "global_avg", "max", "value",
                     "count", "total"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
        assert str(ours) == str(theirs)
    ml, jml = metrics_sync.MetricLogger(" | "), jax_ms.MetricLogger(" | ")
    for v in values:
        ml.update(loss=v, lr=v / 10)
        jml.update(loss=v, lr=v / 10)
    ml.synchronize_between_processes()
    assert str(ml) == str(jml)
    assert ml.global_averages() == jml.global_averages()
    assert ml.loss.median == jml.loss.median
    with pytest.raises(AttributeError):
        ml.missing
    row = {"epoch": 3, "train_loss": 0.5, "val_loss": None}
    assert metrics_sync.sync_epoch_row(row, 4) == jax_ms.sync_epoch_row(
        row, 4)
    assert metrics_sync.global_min_int(7) == jax_ms.global_min_int(7) == 7


def test_list_image_folder_matches(tmp_path):
    from snuffy_tpu.ssl import data as jax_data
    from snuffy_tpu_torch.ssl import data

    for rel in ("b/x.jpeg", "a/1.png", "a/deep/2.jpg", "a/0.JPG", "c.jpeg",
                "b/y.txt", "empty/.keep"):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"")
    assert data.list_image_folder(str(tmp_path)) == \
        jax_data.list_image_folder(str(tmp_path))


def test_dino_cli_flags_are_the_root_flags(monkeypatch):
    """The port's DINO CLI builds its parser with the root script out of
    reach, and its flags are the root's plus --device (`bool_flag` is the
    port's copy: types compare by name)."""
    from snuffy_tpu_torch import main_dino_adapter as port_cli

    def flags(parser):
        return {a.dest: (a.option_strings, a.default,
                         getattr(a.type, "__name__", a.type), a.choices,
                         a.nargs, a.required, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    with monkeypatch.context() as m:
        m.setitem(sys.modules, "main_dino_adapter", None)
        ours = flags(port_cli.get_args_parser())
    import main_dino_adapter as root_cli

    assert ours.pop("device")[1] == "cuda"
    assert ours == flags(root_cli.get_args_parser())


# ------------------------------------------- the MAE pretraining slice's


def test_mae_cli_flags_are_the_root_flags(monkeypatch):
    """The port's MAE CLI builds its parser with the root script out of
    reach, and its flags are the root's plus --device (`bool_flag` is the
    port's copy: types compare by name)."""
    from snuffy_tpu_torch import main_pretrain_adapter as port_cli

    def flags(parser):
        return {a.dest: (a.option_strings, a.default,
                         getattr(a.type, "__name__", a.type), a.choices,
                         a.nargs, a.required, type(a).__name__)
                for a in parser._actions if a.dest != "help"}

    with monkeypatch.context() as m:
        m.setitem(sys.modules, "main_pretrain_adapter", None)
        ours = flags(port_cli.get_args_parser())
    import main_pretrain_adapter as root_cli

    assert ours.pop("device")[1] == "cuda"
    assert ours == flags(root_cli.get_args_parser())


def test_mae_trainer_helpers_match():
    from snuffy_tpu.ssl import mae_trainer as jax_trainer
    from snuffy_tpu_torch.ssl import mae_trainer

    for args in ((1e-3, 64), (1.5e-4, 32, 2), (1e-3, 64, 1, 4), (5e-4, 7)):
        assert mae_trainer.effective_lr(*args) == \
            jax_trainer.effective_lr(*args)
    for fn in (mae_trainer.host_check_finite, jax_trainer.host_check_finite):
        fn(1.0)
        for bad in (float("nan"), float("inf"), -float("inf")):
            with pytest.raises(FloatingPointError,
                               match=f"Loss is {bad}, stopping training"):
                fn(bad)


@pytest.mark.parametrize("procs", [1, 2, 3, 4, 8])
def test_mesh_factoring_matches(procs):
    """`MeshSpec`, `factor_devices` and `validate_spec` (copied into
    `parallel/mesh.py`): every device count a process count divides, the
    refusals, and the tp validation."""
    from snuffy_tpu.parallel import mesh as jax_mesh
    from snuffy_tpu_torch.parallel import mesh

    assert [(f.name, f.type, f.default) for f in dataclasses.fields(
        mesh.MeshSpec)] == [(f.name, f.type, f.default)
                            for f in dataclasses.fields(jax_mesh.MeshSpec)]
    for n in range(1, 65):
        if n % procs:
            for m in (mesh, jax_mesh):
                with pytest.raises(ValueError, match="do not split evenly"):
                    m.factor_devices(n, procs)
            continue
        ours, theirs = mesh.factor_devices(n, procs), \
            jax_mesh.factor_devices(n, procs)
        assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
        assert ours.n_devices == theirs.n_devices == n
    for tp, heads, hidden in ((2, 4, 8), (2, 3, None), (4, 8, 6), (3, 6, 9)):
        spec, jspec = mesh.MeshSpec(tp=tp), jax_mesh.MeshSpec(tp=tp)
        errs = []
        for m, s in ((mesh, spec), (jax_mesh, jspec)):
            try:
                m.validate_spec(s, heads, hidden)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("procs", [2, 3])
def test_metric_sync_across_processes_matches(monkeypatch, procs):
    """`sync_metrics`, `sync_epoch_row`, `global_min_int` and the meters'
    sync with P processes simulated the JAX tests' way (the all-gather
    monkeypatched in both modules): count-weighted, None on some ranks,
    sums."""
    from snuffy_tpu.utils import metrics_sync as jax_ms
    from snuffy_tpu_torch.utils import metrics_sync

    rows = {}

    def gather(vals):
        # this process's row, then rows the other ranks would send
        key = len(vals)
        extra = rows.setdefault(key, np.random.default_rng(key).uniform(
            0.5, 3.0, (procs - 1, key)))
        extra = np.where(np.arange(key) % 3 == 2, np.nan, extra)
        return np.vstack([vals, extra])

    for m in (jax_ms, metrics_sync):
        monkeypatch.setattr(m, "_process_count", lambda: procs)
        monkeypatch.setattr(m, "_allgather_rows", gather)
    monkeypatch.setattr(jax_ms.jax, "process_index", lambda: 0)
    row = {"train_loss": 1.25, "val_loss": None, "acc": 0.5, "n": 4.0,
           "name": "kept"}
    for kw in ({}, {"average": False}, {"weight_key": "n"}):
        assert metrics_sync.sync_metrics(row, **kw) == jax_ms.sync_metrics(
            row, **kw), kw
    epoch = {"epoch": 2, "train_loss": 0.75, "val_loss": 1.5}
    assert metrics_sync.sync_epoch_row(epoch, 3) == jax_ms.sync_epoch_row(
        epoch, 3)
    assert metrics_sync.global_min_int(9) == jax_ms.global_min_int(9)
    ours, theirs = metrics_sync.SmoothedValue(), jax_ms.SmoothedValue()
    for m in (ours, theirs):
        m.update(2.0, n=3)
        m.synchronize_between_processes()
    assert (ours.count, ours.total) == (theirs.count, theirs.total)


def test_bag_table_splits_match():
    """The row splits against `split_dataframe_by_*` on a DataFrame of the
    same rows: 'valid' is a prefix of 'validation', a path outside the
    prefix goes nowhere."""
    import pandas as pd

    from snuffy_tpu.data.bags import (
        split_dataframe_by_folder,
        split_dataframe_by_ratio,
    )
    from snuffy_tpu_torch.data.bags import (
        split_rows_by_folder,
        split_rows_by_ratio,
    )

    prefix = "./embeddings/camelyon16/dino"
    rows = [[f"{prefix}/{folder}/slide_{i}.csv", i % 2]
            for i, folder in enumerate(
                ("train", "valid", "test", "validation", "trainer", "test",
                 "train", "other", "valid"))]
    rows.append(["embeddings/camelyon16/dino/train/x.csv", 1])

    def table(df):
        return df.values.tolist()

    df = pd.DataFrame(rows, columns=["bag_path", "label"])
    got = split_rows_by_folder(rows, prefix)
    assert [len(s) for s in got] == [3, 3, 2]
    assert list(got) == [table(s) for s in
                         split_dataframe_by_folder(df, prefix)]
    for n in (0, 1, 2, 5, 10):
        df = pd.DataFrame(rows[:n], columns=["bag_path", "label"])
        for split in (0.0, 0.2, 1 / 3, 0.5, 1.0):
            assert list(split_rows_by_ratio(rows[:n], split)) == [
                table(s) for s in split_dataframe_by_ratio(df, split)]


@pytest.mark.parametrize("imagenet", [True, False])
def test_normalize_batch_matches(imagenet):
    from snuffy_tpu.embed import pipeline as jax_pipeline
    from snuffy_tpu_torch.embed import pipeline, registry

    batch = np.random.default_rng(5).integers(
        0, 256, (3, 16, 16, 3)).astype(np.uint8)
    got = pipeline.normalize_batch(batch, imagenet)
    want = jax_pipeline.normalize_batch(batch, imagenet)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got is batch) == (want is batch) == (not imagenet)
    for name in ("IMAGENET_MEAN", "IMAGENET_STD"):
        ours, theirs = getattr(pipeline, name), getattr(jax_pipeline, name)
        assert ours.dtype == theirs.dtype and ours.tobytes() == theirs.tobytes()
        assert np.array_equal(np.float32(getattr(registry, name)), ours)


@pytest.mark.parametrize("move", [False, True])
def test_move_camelyon16_tifs_matches(tmp_path, capsys, move):
    """The port's copy and the root script on two copies of one download
    tree: the same files moved or linked, the same count returned, a slide
    already in place left as it is."""
    import importlib

    from snuffy_tpu_torch import move_camelyon16_tifs

    root_script = importlib.import_module("move_camelyon16_tifs")
    layout = ("a/normal_001.tif", "a/b/tumor_002.tif", "test_003.tif",
              "normal_004.tif", "notes.txt", "a/tumor_005.tiff",
              "b/normal_006.tif")

    def tree(side):
        base = tmp_path / side
        for rel in layout:
            path = base / "src" / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(rel)
        (base / "dst" / "0_normal").mkdir(parents=True)
        (base / "dst" / "0_normal" / "normal_006.tif").write_text("kept")
        return base

    def listing(base):
        out = []
        for dirpath, _, files in sorted(os.walk(base)):
            for name in sorted(files):
                path = os.path.join(dirpath, name)
                target = (os.path.relpath(os.readlink(path), base)
                          if os.path.islink(path) else None)
                with open(path) as f:
                    out.append((os.path.relpath(path, base), target, f.read()))
        return out

    counts = []
    for side, module in (("port", move_camelyon16_tifs),
                         ("root", root_script)):
        base = tree(side)
        argv = ["--src", str(base / "src"), "--dst", str(base / "dst")]
        counts.append(module.main(argv + (["--move"] if move else [])))
    assert counts[0] == counts[1] == 4
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].replace("port", "root") == printed[1]
    assert listing(tmp_path / "port") == listing(tmp_path / "root")
