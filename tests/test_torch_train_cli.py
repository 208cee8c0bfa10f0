"""The port's training CLI (`python -m snuffy_tpu_torch.train`) against the
root train.py, mirroring tests/test_cli.py's recipes: the camelyon16
embeddings layout, the 'official' ratio split, musk1's k-fold pickle and
multiclass TCGA.

The port's CLI runs in a subprocess with jax, snuffy_tpu, pandas,
sklearn, cv2 and PIL blocked (the card's machine has none of them but
cv2 and PIL), on the CPU. Both CLIs load the same trees into the same
bags, bit for bit; their runs differ in weights (each package draws its
own initial weights) and attention-dropout draws, so the summaries are
held to the same structure: keys, epochs, metrics, classes and files.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from snuffy_tpu_torch.embed.pipeline import (
    save_class_features,
    write_bag_csv,
    write_dataset_csv,
)
from snuffy_tpu_torch.train import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "snuffy_tpu", "pandas",
           "sklearn", "cv2", "PIL")
D = 16
COMMON = ["--feats_size=16", "--num_heads=2", "--big_lambda=8",
          "--random_patch_share=0.5", "--num_epochs=2", "--lr=2e-3",
          "--optimizer=adamw", "--use_pallas=0", "--wandb_run=run"]


def bag(rng, n, y, c):
    x = rng.standard_normal((n, D)).astype(np.float32)
    if y:
        x[: max(2, n // 4)] += 2.0 * y
    return x


def write_tree(root, dataset, embedding, c=1, sizes=(17, 18, 19),
               labelled_test=True):
    """embeddings/<dataset>/<embedding>/{train,valid,test}/<class>/*.csv and
    the shuffled <dataset>.csv; 8, 4 and 4 bags in one bucket (the JAX
    eval of a multiclass bucket of one bag raises), the test bags with
    label/position columns where `labelled_test` (Camelyon16's test
    slides have tile labels, TCGA's none)."""
    rng = np.random.default_rng(len(dataset) + c)
    out = os.path.join(root, "embeddings", dataset, embedding)
    for split, count in (("train", 8), ("valid", 4), ("test", 4)):
        for i in range(count):
            y = i % max(c, 2)
            n = sizes[i % len(sizes)]
            path = os.path.join(out, split, f"class{y}", f"{split}_{i}.csv")
            x = bag(rng, n, y, c)
            if split == "test" and labelled_test:
                write_bag_csv(path, x, [f"{j}_{i}" for j in range(n)],
                              [int(y > 0 and j < n // 4) for j in range(n)])
            else:
                write_bag_csv(path, x)
    save_class_features(out, f"{dataset}.csv", seed=1)


def write_official(root):
    rng = np.random.default_rng(3)
    out = os.path.join(root, "embeddings", "camelyon16", "official")
    rows = []
    for i in range(20):
        path = os.path.join(out, f"bag_{i}.csv")
        write_bag_csv(path, bag(rng, (17, 19)[i % 2], i % 2, 1))
        rows.append((path, i % 2))
    write_dataset_csv(os.path.join(out, "Camelyon16.csv"), rows)


def write_musk1(root):
    """The k-fold pickle in the JAX package's format: [label, array of
    166-d instance vectors] bags."""
    rng = np.random.default_rng(5)
    bags = [[b % 2, np.array(list(rng.standard_normal((int(n), 166))),
                             dtype=object)]
            for b, n in enumerate(rng.integers(4, 12, 24))]
    folder = os.path.join(root, "datasets", "mil_dataset", "Musk")
    os.makedirs(folder)
    with open(os.path.join(folder, "musk1norm_4folds_0.25split.pkl"),
              "wb") as f:
        pickle.dump(bags, f)


RECIPES = {
    "camelyon16": (lambda root: write_tree(root, "camelyon16", "dino"),
                   ["--dataset=camelyon16", "--embedding=dino",
                    "--arch=snuffy", "--soft_average=1"]),
    "official": (write_official,
                 ["--dataset=camelyon16", "--embedding=official",
                  "--arch=snuffy", "--split=0.4"]),
    "musk1": (write_musk1,
              ["--dataset=musk1", "--arch=snuffy", "--num_heads=2",
               "--cv_num_folds=4", "--cv_valid_ratio=0.25",
               "--soft_average=1"]),
    "tcga": (lambda root: write_tree(root, "tcga", "dino", c=2,
                                     labelled_test=False),
             ["--dataset=tcga", "--embedding=dino",
              "--arch=snuffy_multiclass", "--num_classes=2"]),
}


def port_cli(cwd, argv):
    code = textwrap.dedent(f"""
        import sys
        # absent, as on a machine without them: importing them raises,
        # importlib.util.find_spec (torch's optional-module probes) says None
        BLOCKED = {BLOCKED!r}
        for name in BLOCKED:
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        import runpy
        sys.argv = ["train"] + {list(argv)!r}
        runpy.run_module("snuffy_tpu_torch.train", run_name="__main__")
        leaked = [m for m, mod in sys.modules.items()
                  if m.split(".")[0] in BLOCKED and mod is not None]
        assert not leaked, leaked
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def read_run(cwd, dataset):
    run_dir = os.path.join(cwd, "runs", dataset, "run")
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return summary, rows, sorted(os.listdir(run_dir))


def to_jax_cfg(cfg):
    from snuffy_tpu import configs as jax_configs

    d = dataclasses.asdict(cfg)
    return jax_configs.MILTrainConfig(
        model=jax_configs.SnuffyModelConfig(**d.pop("model")),
        optim=jax_configs.OptimizerConfig(**d.pop("optim")), **d)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_load_datasets_gives_the_jax_bags(tmp_path, monkeypatch, recipe):
    import train as root_cli

    write, argv = RECIPES[recipe]
    write(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    cfg = cli.build_config(cli.get_args_parser().parse_args(
        COMMON + argv + ["--use_mp=0"]))
    got = cli.load_datasets(cfg)
    want = root_cli.load_datasets(to_jax_cfg(cfg))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g) == len(w) and len(g[0]) == len(w[0]) > 0
        for a, b in zip(g[0], w[0]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(g[1], w[1]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
        assert (g[2] is None) == (w[2] is None)
        if w[2] is not None:
            for a, b in zip(g[2], w[2]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        assert g[3] == (None if w[3] is None else [list(p) for p in w[3]])
        assert g[4:] == w[4:]


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_cli_runs_with_jax_blocked(tmp_path, monkeypatch, recipe):
    """The port's run end to end; for camelyon16 (instance metrics) and
    tcga (two classes) the root CLI runs too, and the summaries, metrics
    rows and kept files have the same structure. The other two differ
    from camelyon16's only in their loader, held above."""
    import train as root_cli

    write, argv = RECIPES[recipe]
    os.makedirs(tmp_path / "port")
    write(str(tmp_path / "port"))
    # the port packs 2 bags a step (the JAX package's packed multiclass
    # step takes NaN gradients from a dummy bag), with a spawned loader
    stdout = port_cli(tmp_path / "port", COMMON + argv + [
        "--device", "cpu", "--bag_batch_size=2", "--use_mp=1",
        "--num_processes=2"])
    dataset = argv[0].split("=")[1]
    got, rows, files = read_run(tmp_path / "port", dataset)
    assert "Num Bags" in stdout and "best epoch" in stdout
    assert got["best_epoch"] >= 1 and len(got["history"]) == 2
    assert all(np.isfinite(h["epoch_train_loss"])
               and np.isfinite(h["epoch_valid_loss"]) for h in got["history"])
    c = 2 if recipe == "tcga" else 1
    for tag in ("test_best", "test_last"):
        aucs = got[tag][f"epoch_{tag}_aucs"]
        assert len(aucs) == c and all(0.0 <= a <= 1.0 for a in aucs)
    keep = {got["best_epoch"], 2}
    assert files == sorted(
        [f"{e}.pth" for e in keep]
        + [f"{e}_single_weight_parameter.pth" for e in keep]
        + [f"thresholds_{e}.txt" for e in keep]
        + ["metrics.jsonl", "summary.json"])
    timings = got["timings"]
    assert timings["load_s"] > 0 and len(timings["epochs"]) == 2
    assert {"train_s", "valid_s", "metrics_s", "checkpoint_s"} <= set(
        timings["epochs"][0])
    if recipe not in ("camelyon16", "tcga"):
        return

    os.makedirs(tmp_path / "jax")
    write(str(tmp_path / "jax"))
    monkeypatch.chdir(tmp_path / "jax")
    want = json.loads(json.dumps(root_cli.main(COMMON + argv + ["--use_mp=0"]),
                                 default=float))
    _, want_rows, _ = read_run(tmp_path / "jax", dataset)
    assert got.keys() - {"timings"} == want.keys()
    for g, w in zip(got["history"], want["history"]):
        assert g.keys() == w.keys()
    for tag in ("test_best", "test_last"):
        assert got[tag].keys() == want[tag].keys()
    assert [r.keys() for r in rows] == [r.keys() for r in want_rows]


@pytest.mark.parametrize("flags, reason", [
    (["--bag_batch_impl=vmap"], "vmap"),
    (["--use_pallas=0"], "kernels"),
    (["--gpu_index", "0", "1"], "one card"),
])
def test_refused_flags_raise_with_the_reason(flags, reason):
    args = cli.get_args_parser().parse_args(flags)
    with pytest.raises(ValueError, match=reason):
        cli.resolve_device(args)


@pytest.mark.parametrize("flags, field, value", [
    (["--use_mesh=1", "--bag_batch_size=4"], "use_mesh", 1),
    (["--remat=1"], "remat", True),
])
def test_mesh_and_remat_flags_reach_the_config(flags, field, value):
    """--use_mesh 1 (the dp×sp×tp factoring over torchrun's ranks) and
    --remat 1 run: the device resolves and the flag reaches the config."""
    args = cli.get_args_parser().parse_args(flags + ["--device=cpu"])
    assert str(cli.resolve_device(args)) == "cpu"
    cfg = cli.build_config(args)
    assert getattr(cfg.model if field == "remat" else cfg, field) == value


def test_device_flags():
    parse = cli.get_args_parser().parse_args
    assert cli.resolve_device(parse([])) == __import__("torch").device(
        "cuda", 0)
    assert str(cli.resolve_device(parse(["--gpu_index", "3"]))) == "cuda:3"
    cpu = parse(["--device", "cpu", "--use_pallas=0", "--gpu_index", "0",
                 "1"])
    assert str(cli.resolve_device(cpu)) == "cpu"
