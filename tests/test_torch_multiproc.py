"""The port's data parallelism over two real processes (gloo on the CPU).

Each module fixture runs one scenario of
`snuffy_tpu_torch/tools/multiproc_worker.py` on 2 spawned ranks (the
counterpart of tests/test_multihost_real.py), each rank limited to 120 s
so that a collective one rank never joins fails the test instead of
hanging the suite. Held:

  * the bootstrap from torchrun's environment and the host-side agreement
    (`global_min_int`, count-weighted `sync_metrics` with a value on one
    rank only, `sync_epoch_row`'s writer, the meters);
  * the packed MIL step over 2 ranks against 1 rank stepping the same 8
    bags from the same weights, f32, ρ = 0, no dropout: losses, bag
    scores, instance scores, the gradients before the clip, then the
    parameters (a tail batch included, whose last rank holds only
    zero-weight dummy bags); the replicas bitwise equal after each
    scenario;
  * two DINO and two MAE steps over 2 ranks (batch 4 a rank) against 1
    rank on the 8 images, the gradients each update receives included
    (Adam's step and MIL's clip do not see a gradient's scale: these
    do);
  * the DINO and MAE CLIs and the MIL Runner on 2 ranks, with unequal
    per-rank validation counts: no hang, the same steps everywhere, and
    every file written by rank 0 alone;
  * the extraction CLI on 2 ranks: the same files, byte for byte, as one
    process writes (a nested and a flat layout).
"""

import filecmp
import os

import numpy as np
import pytest

from snuffy_tpu_torch.tools.multiproc_worker import (
    CENTER_TOL,
    GRAD_TOL,
    LOSS_TOL,
    MIL_LR,
    PARAM_SHARE,
    PARAM_TOL,
    SSL_LR,
    SSL_STEPS,
    extract_flags,
    launch,
)

F32 = "float32"


@pytest.fixture(scope="module")
def mil(tmp_path_factory):
    return launch("mil", str(tmp_path_factory.mktemp("mil")))


@pytest.fixture(scope="module")
def dino(tmp_path_factory):
    return launch("dino", str(tmp_path_factory.mktemp("dino")))


@pytest.fixture(scope="module")
def mae(tmp_path_factory):
    return launch("mae", str(tmp_path_factory.mktemp("mae")))


def same_on_both(results, *keys):
    for key in keys:
        a, b = (r for r in results)
        for k in key.split("."):
            a, b = a[k], b[k]
        assert a == b, key


def held_params(worst_share, lr, steps):
    worst, share = worst_share
    assert worst <= 2 * lr * steps
    assert share >= PARAM_SHARE


def test_bootstrap_and_host_side_agreement(mil):
    r0, r1 = mil
    for r, rank in ((r0, 0), (r1, 1)):
        assert (r["rank"], r["world"], r["backend"]) == (rank, 2, "gloo")
        assert r["global_min"] == 3          # min(5, 3) on every rank
        n, train, val = r["sync"]
        assert n == 7.0 and abs(train - (2 * 3 + 3 * 4) / 7) < 1e-12
        assert val == 7.0                    # rank 1's value alone
        row, writer = r["epoch_row"]
        assert writer == (rank == 0) and row["epoch"] == 3
        assert row["n_train_batches"] == 3.0
        assert abs(row["train_loss"] - (1 * 1 + 2 * 2) / 3) < 1e-12
        assert r["meter"] == [4, 6.0]
        assert r["mesh_mean"] == 1.5
    assert r0["batch_slice"] == [0, 4] and r1["batch_slice"] == [4, 8]


def test_mil_packed_step_over_two_ranks_is_the_one_rank_step(mil):
    r0, _ = mil
    assert r0["mil_dtype"] == F32
    for step in r0["mil_errors"]:         # full batch, then the tail batch
        assert max(step) <= LOSS_TOL[F32], step
    assert len(r0["mil_grads"]) == 2
    assert max(r0["mil_grads"]) <= GRAD_TOL[F32], r0["mil_grads"]
    held_params(r0["mil_params"], MIL_LR, 2)
    same_on_both(mil, "mil_digest", "mil_rand_digest", "mil_rand_order")
    assert r0["mil_rand_finite"]
    assert sorted(r0["mil_rand_order"]) == list(range(8))


def test_runner_on_two_ranks_writes_from_rank_0(mil):
    r0, r1 = mil
    assert r1["runner"]["writes"] == []
    written = r0["runner"]["writes"]
    run = "runs/camelyon16/run_seed1/"
    for name in ("1.pth", "2_single_weight_parameter.pth", "thresholds_2.txt",
                 "summary.json"):
        assert run + name in written
    assert "runs/metrics.jsonl" in written
    same_on_both(mil, "runner.best_epoch", "runner.best_valid_auc",
                 "runner.digest")


def test_dino_steps_over_two_ranks_are_the_one_rank_steps(dino):
    r0, _ = dino
    loss, loss1 = r0["dino_loss"]
    assert abs(loss - loss1) <= LOSS_TOL[F32] * abs(loss1)
    assert r0["dino_center"] <= CENTER_TOL[F32]
    assert len(r0["dino_grads"]) == SSL_STEPS
    assert max(r0["dino_grads"]) <= GRAD_TOL[F32], r0["dino_grads"]
    held_params(r0["dino_student"], SSL_LR, SSL_STEPS)
    held_params(r0["dino_teacher"], SSL_LR, SSL_STEPS)
    same_on_both(dino, "dino_digest")
    assert len(r0["dino_buckets"]) >= 1


def test_dino_cli_on_two_ranks_writes_once(dino):
    """18 images (2 steps of 4 a rank an epoch), 15 validation ones (2
    batches on rank 0, 1 on rank 1: the ranks agree on 1), 2 epochs."""
    r0, r1 = dino
    assert r0["dino_cli"]["steps"] == r1["dino_cli"]["steps"] == 4
    assert r1["dino_cli"]["writes"] == []
    assert {"dino/log.txt", "dino/checkpoint0000.pth"} <= set(
        r0["dino_cli"]["writes"])
    same_on_both(dino, "dino_cli.digest")


def test_mae_steps_over_two_ranks_are_the_one_rank_steps(mae):
    r0, _ = mae
    loss, loss1 = r0["mae_loss"]
    assert abs(loss - loss1) <= LOSS_TOL[F32] * abs(loss1)
    assert len(r0["mae_grads"]) == SSL_STEPS
    assert max(r0["mae_grads"]) <= GRAD_TOL[F32], r0["mae_grads"]
    held_params(r0["mae_params"], SSL_LR, SSL_STEPS)
    same_on_both(mae, "mae_digest")


def test_mae_cli_on_two_ranks_writes_once(mae):
    r0, r1 = mae
    assert r0["mae_cli"]["steps"] == r1["mae_cli"]["steps"] == 4
    assert r1["mae_cli"]["writes"] == []
    assert {"mae/log.txt", "mae/checkpoint.pth.tmp"} <= set(
        r0["mae_cli"]["writes"])
    same_on_both(mae, "mae_cli.digest")


def jpeg_trees(root):
    """camelyon16: 5 bags under split/class (train 2 + 2, test 1, so the
    ranks take 3 and 2); tcga: 3 bags under class alone (the flat
    dataset CSV); 2 tiles a bag, with tile labels."""
    from snuffy_tpu_torch import native

    rng = np.random.default_rng(0)
    layouts = {"camelyon16": [("train", "0_normal"), ("train", "0_normal"),
                              ("train", "1_tumor"), ("train", "1_tumor"),
                              ("test", "1_tumor")],
               "tcga": [("luad",), ("luad",), ("lusc",)]}
    for name, bags in layouts.items():
        labels = []
        for b, where in enumerate(bags):
            slide = f"slide{b}"
            bag = os.path.join(root, name, "single", "fold1", *where, slide)
            os.makedirs(bag)
            for p in range(2):
                native.write_jpeg(os.path.join(bag, f"{p}_{p + 1}.jpeg"),
                                  rng.integers(0, 256, (48, 48, 3),
                                               np.uint8))
                labels.append(f"{slide}_{p}_{p + 1},{p}\n")
        with open(os.path.join(root, name, "tile_label.csv"), "w") as f:
            f.writelines(labels)


def test_extraction_on_two_ranks_writes_one_process_bytes(tmp_path,
                                                          monkeypatch):
    from snuffy_tpu_torch import compute_feats

    jpeg_trees(str(tmp_path / "datasets"))
    r0, r1 = launch("extract", str(tmp_path))
    os.makedirs(tmp_path / "one")
    monkeypatch.chdir(tmp_path / "one")
    want = {}
    for name in ("camelyon16", "tcga"):
        want[name] = [list(r) for r in compute_feats.main(
            extract_flags("tiny") + [
                "--datasets_path", str(tmp_path / "datasets"),
                "--dataset", name, "--device", "cpu"])]
    assert r0["extract_rows"] == r1["extract_rows"] == want
    one, two = tmp_path / "one" / "embeddings", tmp_path / "ranks" / \
        "embeddings"
    files = sorted(os.path.relpath(os.path.join(d, f), one)
                   for d, _, fs in os.walk(one) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), two)
                           for d, _, fs in os.walk(two) for f in fs)
    csvs = [f for f in files if f.endswith(".csv")]
    assert len(csvs) == 5 + 3 + 1 + 3 + 1   # bags, class CSVs, datasets
    _, bad, missing = filecmp.cmpfiles(one, two, csvs, shallow=False)
    assert not bad and not missing
    # each rank wrote its own bags' CSVs; rank 0 alone the rest
    bag_csvs = {os.path.join("ranks", r[0])
                for rows in want.values() for r in rows}
    assert set(r1["extract_writes"]) < bag_csvs
    assert set(r0["extract_writes"]) - bag_csvs >= {
        os.path.join("ranks", "embeddings", "camelyon16", "DINO", f)
        for f in ("camelyon16.csv", "embedder.pth")}
    assert set(r0["extract_writes"]) | set(r1["extract_writes"]) >= bag_csvs
