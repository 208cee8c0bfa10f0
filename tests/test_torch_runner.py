"""The port's epoch Runner against the JAX Runner.

From the same initial weights (the JAX `init_state(seed)` parameters,
carried across with `bridge.milnet_state_dict`), both runners train 3
epochs on the same small synthetic bags, validate, test at the best and
last epochs and clean up. f32, ρ=0 and every dropout 0 (the multiclass
FFN's inner 0.1 too), so both select the same slots and draw nothing; the
multiclass case pins the random half of its selection to the same rows
in both (its draw ignores ρ). Losses,
AUCs, thresholds and accuracies agree at rtol 1e-4 (f32 sums in other
orders over a few Adam steps), `best_epoch` exactly.
"""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from snuffy_tpu import native as jax_native
from snuffy_tpu.configs import MILTrainConfig as JaxMILTrainConfig
from snuffy_tpu.configs import OptimizerConfig as JaxOptimizerConfig
from snuffy_tpu.configs import SnuffyModelConfig as JaxSnuffyModelConfig
from snuffy_tpu.train.runner import Runner as JaxRunner
from snuffy_tpu.train.schedules import make_epoch_schedule
from snuffy_tpu.train.trainer import SnuffyTrainer as JaxTrainer
from snuffy_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from snuffy_tpu_torch import configs, native
from snuffy_tpu_torch.bridge import load_reference_pth, milnet_state_dict
from snuffy_tpu_torch.models.snuffy import build_milnet
from snuffy_tpu_torch.train.runner import Runner
from snuffy_tpu_torch.train.trainer import SnuffyTrainer
from snuffy_tpu_torch.utils.logging import MetricsLogger
from tests.test_torch_snuffy_model import pin_the_draws

RTOL = 1e-4
EPOCHS = 3


def to_port(cfg: JaxMILTrainConfig) -> configs.MILTrainConfig:
    d = dataclasses.asdict(cfg)
    return configs.MILTrainConfig(
        model=configs.SnuffyModelConfig(**d.pop("model")),
        optim=configs.OptimizerConfig(**d.pop("optim")), **d)


def split(rng, count, c, d, instance_labels=False):
    """Bags of 17-22 rows, two or more in each of the 20 and 24 buckets
    (the JAX eval of a multiclass bucket of one bag raises); positives
    carry a shifted direction in a few rows."""
    direction = np.linspace(-1.0, 1.0, d).astype(np.float32)
    labels, feats, ins = [], [], []
    for i in range(count):
        n = (17, 18, 21, 22)[i % 4]
        x = rng.standard_normal((n, d)).astype(np.float32)
        y = i % max(c, 2)
        k = max(2, n // 4)
        if y:
            x[:k] += 1.5 * y * direction
        labels.append(np.array([float(y)], np.float32) if c == 1
                      else np.eye(c, dtype=np.float32)[y])
        feats.append(x)
        ins.append((np.arange(n) < k).astype(np.int64) * int(y > 0))
    return labels, feats, (ins if instance_labels else None), None


def jax_config(tmp_path, side, c, batch, **kw):
    model = JaxSnuffyModelConfig(
        feats_size=16, num_classes=c, num_heads=2, big_lambda=8,
        random_patch_share=0.0, mlp_multiplier=2, depth=1,
        encoder_dropout=0.0, attention_dropout=0.0, use_pallas=False,
        multiclass=c > 1)
    return JaxMILTrainConfig(
        model=model, optim=JaxOptimizerConfig(optimizer="adamw", lr=5e-3),
        num_epochs=EPOCHS, dataset="camelyon16", bag_batch_size=batch,
        use_mesh=0, soft_average=True, seed=4, run_name="run",
        save_path=str(tmp_path / side),
        camelyon16_mask_path=str(tmp_path / "no_masks"), **kw)


def run_both(tmp_path, c, batch):
    rng = np.random.default_rng(c + batch)
    data = [split(rng, 8, c, 16), split(rng, 6, c, 16),
            split(rng, 6, c, 16, instance_labels=c == 1)]
    jcfg = jax_config(tmp_path, "jax", c, batch)
    jt = JaxTrainer(jcfg)
    params = jt.init_state(jcfg.seed).params
    schedule = make_epoch_schedule("cosine", jcfg.optim.lr, EPOCHS, 5e-6)
    want = JaxRunner(jcfg, jt, *data, JaxMetricsLogger(
        str(tmp_path / "jax" / "metrics.jsonl"))).run(schedule)

    pcfg = to_port(dataclasses.replace(jcfg, save_path=str(tmp_path / "port")))
    tt = SnuffyTrainer(pcfg, "cpu", model=build_milnet(
        pcfg.model, device="cpu", ffn_dropout=0.0))
    start = {k: torch.from_numpy(v)
             for k, v in milnet_state_dict(params).items()}
    tt.init_state = lambda seed: tt.load(start, 0.5)
    runner = Runner(pcfg, tt, *data, MetricsLogger(
        str(tmp_path / "port" / "metrics.jsonl")))
    got = runner.run(schedule)
    return got, want, runner


def assert_results_agree(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if key == "time_s":
            continue
        if isinstance(w, list):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6,
                                       err_msg=key)
        elif key.endswith("accuracy") or key == "epoch":
            assert g == w, key
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-6,
                                       err_msg=key)


# Multiclass runs serial steps: the JAX package's packed multiclass step
# takes NaN gradients from a bag with no valid row (a tail chunk's dummy
# bag), see test_packed_multiclass_step_with_a_dummy_bag_stays_finite.
@pytest.mark.parametrize("c, batch", [(1, 1), (1, 3), (2, 1)])
def test_runner_matches_jax(tmp_path, monkeypatch, c, batch):
    if c > 1:
        # the multiclass FFN's inner dropout (0.1) off on both sides
        from snuffy_tpu.models.snuffy import MILNet as JaxMILNet

        monkeypatch.setattr(JaxMILNet, "_ffn_dropout", lambda self: 0.0)
        pin_the_draws(monkeypatch)
    got, want, runner = run_both(tmp_path, c, batch)
    assert got["best_epoch"] == want["best_epoch"] >= 1
    np.testing.assert_allclose(got["best_valid_auc"], want["best_valid_auc"],
                               rtol=RTOL)
    assert len(got["history"]) == len(want["history"]) == EPOCHS
    for g, w in zip(got["history"], want["history"]):
        assert_results_agree(g, w)
    for tag in ("test_best", "test_last"):
        assert_results_agree(got[tag], want[tag])
    if c == 1:
        assert "epoch_test_best_feat_aucs" in got["test_best"]
    else:
        assert len(got["test_best"]["epoch_test_best_aucs"]) == c
        pw = runner.trainer.pos_weight
        assert pw.shape == (c,) and pw.dtype == torch.float32

    # metrics.jsonl: the JAX keys, row by row
    rows = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "metrics.jsonl") as f:
            rows[side] = [json.loads(line) for line in f]
    assert [r.keys() for r in rows["port"]] == [r.keys() for r in rows["jax"]]

    # files: the best and last epochs' checkpoint, w and thresholds only
    keep = sorted({got["best_epoch"], EPOCHS})
    port_dir = tmp_path / "port" / "camelyon16" / "run"
    jax_dir = tmp_path / "jax" / "camelyon16" / "run"
    assert sorted(os.listdir(port_dir)) == sorted(
        [f"{e}.pth" for e in keep]
        + [f"{e}_single_weight_parameter.pth" for e in keep]
        + [f"thresholds_{e}.txt" for e in keep] + ["summary.json"])
    assert sorted(f for f in os.listdir(jax_dir) if f.startswith("thr")) == \
        sorted(f for f in os.listdir(port_dir) if f.startswith("thr"))
    for e in keep:
        with open(port_dir / f"thresholds_{e}.txt") as f:
            th = json.load(f)
        with open(jax_dir / f"thresholds_{e}.txt") as f:
            jth = json.load(f)
        assert th.keys() == jth.keys() and th["epoch"] == jth["epoch"] == e
        for key in ("auc", "thresholds_optimal", "single_weight_parameter"):
            np.testing.assert_allclose(th[key], jth[key], rtol=RTOL)
    with open(port_dir / "summary.json") as f:
        summary = json.load(f)
    assert summary.keys() - {"timings"} == want.keys()
    assert len(summary["timings"]["epochs"]) == EPOCHS


def test_checkpoint_round_trips_as_a_reference_pth(tmp_path):
    cfg = to_port(jax_config(tmp_path, "port", 1, 1))
    data = split(np.random.default_rng(0), 4, 1, 16)
    trainer = SnuffyTrainer(cfg, "cpu")
    runner = Runner(cfg, trainer, data, data, data)
    with torch.no_grad():
        trainer.w.fill_(0.3125)
        for p in trainer.model.parameters():
            p.add_(0.5)
    runner.save_checkpoint(7, {"epoch_valid_aucs": [0.5],
                               "epoch_valid_thresholds_optimal": [0.25]})
    saved, w = trainer.state_dict()
    path = os.path.join(runner.save_dir, "7.pth")
    model = build_milnet(cfg.model, seed=9, device="cpu")
    model.load_state_dict(load_reference_pth(path), strict=True)
    assert all(torch.equal(a, saved[k])
               for k, a in model.state_dict().items())
    assert float(torch.load(os.path.join(
        runner.save_dir, "7_single_weight_parameter.pth"))) == 0.3125
    trainer.init_state(cfg.seed)
    assert trainer.w.item() == 0.5
    assert not torch.equal(trainer.model.i_classifier.fc[0].weight,
                           saved["i_classifier.fc.0.weight"])
    runner.load_checkpoint(7)
    assert trainer.w.item() == w == 0.3125
    assert all(torch.equal(a, saved[k])
               for k, a in trainer.model.state_dict().items())
    assert runner.load_thresholds(7)["thresholds_optimal"] == [0.25]
    for e in (1, 2):
        runner.save_checkpoint(e, {})
    runner.clean_up({2, 7})
    assert sorted(os.listdir(runner.save_dir)) == [
        "2.pth", "2_single_weight_parameter.pth", "7.pth",
        "7_single_weight_parameter.pth", "thresholds_2.txt",
        "thresholds_7.txt"]


def write_masks(masks, names, width=12288, height=1024):
    """Camelyon16-style mask pyramids (levels 0-5, spacing 0.243 µm) with
    a tumour over the patches at columns 0-5 of row 0 (x < 3072, y < 512
    at level 0) and an ITC-sized speck further along."""
    arr = np.zeros((height, width), np.uint8)
    arr[:512, :3072] = 2
    arr[700:704, 9000:9004] = 2
    levels = [arr]
    for _ in range(5):
        levels.append(levels[-1][::2, ::2].copy())
    for name in names:
        native.write_tiled_tiff_gray(str(masks / f"{name}_mask.tif"), levels,
                                     tile=256, spacing_um=0.243)


def test_the_froc_gate_raises_where_jax_would_score(tmp_path, monkeypatch):
    """The name is kept from the port that raised here. Where the JAX
    runner scores the Camelyon16 FROC (the test split, masks and
    reference.csv present), the port's `evaluate` scores it too, and
    `_camelyon16_froc` gives the JAX runner's score on the same instance
    scores, order and threshold; without the masks the gate stays closed,
    as in the JAX runner."""
    from types import SimpleNamespace

    monkeypatch.setattr(jax_native, "NativeSlide", native.NativeSlide)
    monkeypatch.setattr(jax_native, "available", lambda: True)
    masks = tmp_path / "masks"
    masks.mkdir()
    names = ["test_000", "test_001", "test_002", "test_003"]
    write_masks(masks, names[1::2])
    reference = tmp_path / "reference.csv"
    reference.write_text("image,type\ntest_000.tif,Normal\n"
                         "test_001.tif,Tumor\ntest_002.tif,normal\n"
                         "test_003.tif,tumor\n")
    jcfg = dataclasses.replace(
        jax_config(tmp_path, "port", 1, 1),
        camelyon16_mask_path=str(masks), camelyon16_reference=str(reference))
    cfg = to_port(jcfg)
    labels, feats, ins, _ = split(np.random.default_rng(1), 4, 1, 16,
                                  instance_labels=True)
    positions = [[f"{j}_0" for j in range(len(f))] for f in feats]
    data = (labels, feats, ins, positions, names)
    runner = Runner(cfg, SnuffyTrainer(cfg, "cpu"), data, data, data)
    assert not any("froc" in k
                   for k in runner.evaluate(data, 1, "epoch_valid"))
    seen = []
    real = runner._camelyon16_froc
    runner._camelyon16_froc = lambda *a: seen.append(a) or real(*a)
    res = runner.evaluate(data, 1, "epoch_test_best")
    (call,) = seen
    want = JaxRunner._camelyon16_froc(SimpleNamespace(cfg=jcfg), *call)
    assert res["epoch_test_best_challenge_froc_score"] == want
    assert call[3] == res["epoch_test_best_feat_thresholds_optimal"][0]
    # a predefined threshold (the saved best epoch's) is the one used
    seen.clear()
    res = runner.evaluate(data, 1, "epoch_test_best",
                          predefined_feats_thresholds=[0.25])
    assert seen[0][3] == 0.25
    assert res["epoch_test_best_challenge_froc_score"] == \
        JaxRunner._camelyon16_froc(SimpleNamespace(cfg=jcfg), *seen[0])
    # without the masks the gate stays closed, as in the JAX runner
    runner.cfg = dataclasses.replace(cfg, camelyon16_mask_path=str(
        tmp_path / "absent"))
    res = runner.evaluate(data, 1, "epoch_test_best")
    assert "epoch_test_best_feat_aucs" in res
    assert "epoch_test_best_challenge_froc_score" not in res


def test_camelyon16_froc_from_runner(tmp_path):
    """tests/test_runner_froc.py's case on the port: detections from
    instance scores and positions, scored against a mask TIFF on disk."""
    masks = tmp_path / "masks"
    masks.mkdir()
    arr = np.zeros((2048, 2048), np.uint8)
    arr[:1200, :1200] = 2
    native.write_tiled_tiff_gray(str(masks / "tumor_001_mask.tif"),
                                 [arr] + [arr[::2 ** k, ::2 ** k].copy()
                                          for k in range(1, 6)], tile=64)
    ref_csv = tmp_path / "reference.csv"
    ref_csv.write_text("image,type\ntumor_001.tif,tumor\n"
                       "normal_001.tif,normal\n")
    cfg = configs.MILTrainConfig(
        model=configs.SnuffyModelConfig(feats_size=8, num_heads=2,
                                        big_lambda=4),
        dataset="camelyon16",
        camelyon16_mask_path=str(masks),
        camelyon16_reference=str(ref_csv),
        save_path=str(tmp_path / "runs"),
    )
    dummy = ([np.array([1.0])], [np.zeros((4, 8), np.float32)], None, None)
    runner = Runner(cfg, SnuffyTrainer(cfg, "cpu"), dummy, dummy, dummy)
    # two bags: the tumour slide with one hit and one miss, the normal
    # slide with one false positive
    data = (
        [np.array([1.0]), np.array([0.0])],
        [np.zeros((2, 8), np.float32), np.zeros((1, 8), np.float32)],
        [[1, 0], [0]],
        [["0_0", "2_2"], ["1_1"]],          # positions col_row
        ["tumor_001", "normal_001"],
    )
    ins_list = [np.array([0.9, 0.8]), np.array([0.6])]
    order = np.array([0, 1])
    # patch (0, 0)'s centre (256, 256) lies in the 1200 px tumour: the
    # region is found and the curve reaches sensitivity 1
    score = runner._camelyon16_froc(data, ins_list, order, feat_threshold=0.5)
    assert 0.0 < score <= 1.0
    # with the threshold above every score nothing is detected
    assert runner._camelyon16_froc(data, ins_list, order,
                                   feat_threshold=0.95) == 0.0


def test_packed_multiclass_step_with_a_dummy_bag_stays_finite(monkeypatch):
    """A packed chunk whose last bag has no valid row (the padding of a
    tail chunk). The JAX model gathers that bag's dead slots at the
    sentinel row N, past the packed rows, where `jnp.take` fills NaN, and
    its training step's gradient turns NaN (its multiclass runs above take
    serial steps for that reason). The port points dead slots at an
    in-range row: its gradient stays finite and the real bag's logits
    match the JAX forward's."""
    import jax
    import jax.numpy as jnp

    from snuffy_tpu.models.snuffy import MILNet as JaxMILNet
    from snuffy_tpu.models.snuffy import build_milnet as jax_build_milnet
    from snuffy_tpu.models.snuffy import init_milnet_params
    from snuffy_tpu_torch.train.losses import packed_mixed_mil_loss

    monkeypatch.setattr(JaxMILNet, "_ffn_dropout", lambda self: 0.0)
    cfg = jax_config(Path("."), "port", 2, 2).model
    params = init_milnet_params(cfg, seed=4, n_example=24)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((48, 16)).astype(np.float32)
    mask = np.concatenate([np.arange(24) < n for n in (20, 0)])
    labels = np.array([[0, 1], [0, 0]], np.float32)
    _, want_bag, _ = jax_build_milnet(cfg, segments=2).apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(mask), True,
        rngs={"sparse": jax.random.PRNGKey(0)})

    model = build_milnet(cfg, device="cpu", ffn_dropout=0.0).train()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           milnet_state_dict(params).items()})
    ins, bag = model(torch.from_numpy(feats), torch.from_numpy(mask),
                     segments=2)
    losses, _ = packed_mixed_mil_loss(
        ins, bag, torch.from_numpy(labels), torch.from_numpy(mask), 0.5,
        segments=2)
    (losses * torch.tensor([1.0, 0.0])).sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    np.testing.assert_allclose(bag.detach().numpy()[0],
                               np.asarray(want_bag)[0], rtol=1e-5, atol=1e-5)
