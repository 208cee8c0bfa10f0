"""The port's MAE-adapter pretraining CLI on the CPU (`--device cpu`).

Mirrors `tests/test_ssl_cli.py` (the smoke run, the previous best
deleted, `bool_flag`) on tiny factories (32² images, patch 8, width 32,
depth 1; decoder width 16, depth 1), and adds: the checkpoints' layout,
loaded with `weights_only=True`; resume with and without the optimizer's
state; `--finetune` from a written MAE-layout `.pth`, with and without
linears from scratch, against the JAX CLI on the same file (the tensors
the file gives equal, bit for bit); the written best checkpoint loading
into the port's extraction CLI with every encoder layer matched, its
features equal to the trained encoder's.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from snuffy_tpu_torch import main_pretrain_adapter as cli
from snuffy_tpu_torch.models import mae as mae_mod
from snuffy_tpu_torch.ssl import mae_trainer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TINY = dict(patch_size=8, embed_dim=32, depth=1, num_heads=2,
            decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2,
            mlp_ratio=2.0)


def tiny(**kw):
    kw.pop("patch_size", None)
    return mae_mod.MaskedAutoencoderViT(**TINY, **kw)


@pytest.fixture
def tiny_factory(monkeypatch):
    monkeypatch.setattr(mae_mod, "mae_vit_base_patch16", tiny)
    return tiny


def image_folder(root, n_per_class=10, size=32, seed=0):
    from snuffy_tpu_torch import native

    rng = np.random.default_rng(seed)
    for cls in ("a", "b"):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i in range(n_per_class):
            arr = (rng.random((size, size, 3)) * 255).astype(np.uint8)
            native.write_jpeg(os.path.join(root, cls, f"{i}.jpeg"), arr)
    return root


def argv(tmp_path, *extra, device="cpu"):
    data = str(tmp_path / "imgs")
    if not os.path.isdir(data):
        image_folder(data)
    return ["--model=mae_vit_base_patch16", "--batch_size=4",
            f"--data_path={data}", f"--output_dir={tmp_path}/out",
            "--num_workers=0", "--input_size=32", "--warmup_epochs=1",
            "--max_steps_per_epoch=2",
            *([f"--device={device}"] if device else []), *extra]


def log_rows(tmp_path):
    with open(tmp_path / "out" / "log.txt") as f:
        return [json.loads(line) for line in f.read().strip().splitlines()]


def test_mae_cli_smoke(tmp_path, tiny_factory):
    """2 epochs with validation: two finite rows, the rolling and one best
    checkpoint in the reference's layout, frozen tensors bit for bit."""
    timings = {}
    start = tiny(with_decoder=True).state_dict()
    state = cli.main(argv(tmp_path, "--epochs=2",
                          f"--valid_data_path={tmp_path}/imgs"), timings)
    log = log_rows(tmp_path)
    assert [r["epoch"] for r in log] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
               for r in log)
    assert state.step == 4 and timings["steps"] == 4
    assert {"decode_s", "augment_s", "forward_s", "backward_s",
            "update_s"} <= set(timings)
    out = tmp_path / "out"
    best = [f for f in os.listdir(out) if f.startswith("checkpoint-best-")]
    assert len(best) == 1
    assert sorted(os.listdir(out)) == sorted(["checkpoint.pth", "log.txt",
                                              *best])
    ckpt = torch.load(out / "checkpoint.pth", weights_only=True)
    assert set(ckpt) == {"model", "optimizer", "step", "epoch", "args"}
    assert (ckpt["epoch"], ckpt["step"]) == (1, 4)
    assert ckpt["args"]["input_size"] == 32
    assert int(ckpt["optimizer"]["count"]) == 4
    trains = mae_trainer.mae_trainable_mask(state.model, True, True)
    assert set(ckpt["optimizer"]["exp_avg"]) == {k for k, t in trains.items()
                                                 if t}
    model = ckpt["model"]
    assert "mask_token" in model and "decoder_pred.weight" in model
    for k, v in start.items():
        if trains[k]:
            continue
        assert torch.equal(model[k], v), k
    for k in ("blocks.0.adaptmlp.up_proj.weight",
              "decoder_blocks.0.adaptmlp.up_proj.weight",
              "decoder_embed.weight", "decoder_pred.weight"):
        assert not torch.equal(model[k], start[k]), k
    epoch = int(best[0].removeprefix("checkpoint-best-").removesuffix(".pth"))
    assert epoch == int(np.argmin([r["val_loss"] for r in log]))


def test_the_previous_best_is_deleted(tmp_path, tiny_factory, monkeypatch):
    """Val losses 3 then 2 (the trainer's eval_loss replaced; 5 batches
    of 4 an epoch): epoch 1's best replaces epoch 0's."""
    vals = iter([3.0] * 5 + [2.0] * 5)
    monkeypatch.setattr(mae_trainer.MAETrainer, "eval_loss",
                        lambda self, *a, **k: next(vals))
    cli.main(argv(tmp_path, "--epochs=2", "--max_steps_per_epoch=1",
                  f"--valid_data_path={tmp_path}/imgs"))
    out = tmp_path / "out"
    assert [f for f in os.listdir(out) if "best" in f] == [
        "checkpoint-best-1.pth"]
    assert [r["val_loss"] for r in log_rows(tmp_path)] == [3.0, 2.0]
    best = torch.load(out / "checkpoint-best-1.pth", weights_only=True)
    assert best["epoch"] == 1 and "optimizer" in best


def test_mae_cli_resume_restores_opt_state(tmp_path, tiny_factory):
    state1 = cli.main(argv(tmp_path, "--epochs=2"))
    ckpt = torch.load(tmp_path / "out" / "checkpoint.pth", weights_only=True)
    live = state1.opt_state
    assert any(bool(v.abs().sum() > 0) for v in live["exp_avg"].values())
    for key in ("exp_avg", "exp_avg_sq"):
        for name, v in live[key].items():
            assert torch.equal(ckpt["optimizer"][key][name], v), name
    for k, v in state1.model.state_dict().items():
        assert torch.equal(ckpt["model"][k], v), k
    state2 = cli.main(argv(tmp_path, "--epochs=3"))
    assert state2.step == 6 and int(state2.opt_state["count"]) == 6
    assert [r["epoch"] for r in log_rows(tmp_path)] == [0, 1, 2]


def test_mae_cli_resume_without_optimizer_state(tmp_path, tiny_factory,
                                                capsys):
    cli.main(argv(tmp_path, "--epochs=1", "--max_steps_per_epoch=1"))
    path = tmp_path / "out" / "checkpoint.pth"
    ckpt = torch.load(path, weights_only=True)
    del ckpt["optimizer"]
    torch.save(ckpt, path)
    state = cli.main(argv(tmp_path, "--epochs=2", "--max_steps_per_epoch=1"))
    assert state.step == 2 and int(state.opt_state["count"]) == 1
    assert "without optimizer state" in capsys.readouterr().out


def test_bool_flags_and_the_composite_flag(tmp_path, tiny_factory):
    args = cli.get_args_parser().parse_args(
        ["--use_adapter", "0", "--device_augment", "false"])
    assert args.use_adapter is False and args.device_augment is False
    with pytest.raises(SystemExit):
        cli.get_args_parser().parse_args(["--use_adapter", "maybe"])
    trainer = cli.build_trainer(cli.get_args_parser().parse_args(
        argv(tmp_path, "--train_linears__linears_from_scratch",
             "[False, True]")), torch.device("cpu"))
    assert trainer.train_decoder_linears is False
    assert trainer.augment is True and trainer.mask_ratio == 0.75


def test_no_gpu_raises_for_the_default_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(argv(tmp_path, "--epochs=1", device=None))


# ------------------------------------------------------------- --finetune


def published_checkpoint(path):
    """A published MAE `.pth` of the tiny model (no adapters, the fixed
    grids as the reference stores them) from seeded weights, in a
    'model' container."""
    model = tiny(use_adapter=False, with_decoder=True, seed=11)
    gen = torch.Generator().manual_seed(12)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
          for k, v in model.state_dict().items()}
    sd["pos_embed"] = model.pos_embed.clone()
    sd["decoder_pos_embed"] = model.decoder_pos_embed.clone()
    torch.save({"model": sd}, path)
    return sd


@pytest.fixture
def jax_tiny_factory(monkeypatch):
    from snuffy_tpu.models import mae as jax_mae

    def jtiny(**kw):
        kw.pop("patch_size", None)
        return jax_mae.MaskedAutoencoderViT(**TINY, **kw)

    monkeypatch.setattr(jax_mae, "mae_vit_base_patch16", jtiny)


@pytest.mark.parametrize("scratch", [False, True])
def test_finetune_matches_the_jax_cli(tmp_path, tiny_factory,
                                      jax_tiny_factory, scratch):
    """Both CLIs (0 epochs) on the same `.pth`: the encoder, mask token and
    decoder the file gives are the JAX CLI's, bit for bit; with linears
    from scratch `decoder_embed`/`decoder_pred` keep the port's init, as
    do the adapters the file lacks."""
    import jax

    import main_pretrain_adapter as jax_cli
    from snuffy_tpu_torch.bridge import mae_pretrain_from_jax

    path = str(tmp_path / "mae.pth")
    src = published_checkpoint(path)
    extra = [f"--finetune={path}", "--epochs=0",
             f"--train_linears__linears_from_scratch=[True, {scratch}]"]
    ours = cli.main(argv(tmp_path, *extra)).model.state_dict()
    fresh = cli.build_trainer(cli.get_args_parser().parse_args(
        argv(tmp_path)), torch.device("cpu")).model.state_dict()
    jargs = jax_cli.get_args_parser().parse_args(argv(tmp_path, *extra,
                                                      device=None))
    theirs = mae_pretrain_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_cli.train_mae(jargs).params))
    assert set(theirs) == set(ours)
    for k, v in ours.items():
        linear = k.split(".")[0] in ("decoder_embed", "decoder_pred")
        if "adaptmlp" in k or (scratch and linear):
            assert torch.equal(v, fresh[k]), k
        else:
            np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
            assert torch.equal(v, src[k]), k


def test_import_mae_pretrain_matches_jax_and_extraction_keeps_the_encoder():
    """The decoder-aware importer takes what the JAX `import_mae` takes;
    the extraction importer still takes the encoder alone."""
    from snuffy_tpu.embed import torch_import as jti
    from snuffy_tpu_torch.bridge import mae_pretrain_from_jax
    from snuffy_tpu_torch.embed import torch_import as ti

    model = tiny(use_adapter=True, with_decoder=True, seed=3)
    sd = dict(model.state_dict())
    sd["pos_embed"] = model.pos_embed
    got = ti.import_mae_pretrain(sd)
    want = mae_pretrain_from_jax(jti.import_mae(
        {k: v.numpy() for k, v in sd.items()}))
    assert set(got) == set(want) == set(model.state_dict())
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    enc = ti.import_mae(sd)
    assert not any(k.startswith(("decoder", "mask_token")) for k in enc)
    assert set(enc) == set(tiny(use_adapter=True).state_dict())


# ------------------------------------------------ into the extraction CLI


def test_best_checkpoint_loads_into_compute_feats(tmp_path, tiny_factory,
                                                  monkeypatch, capsys):
    """checkpoint-best-N.pth into `compute_feats --embedder MAE --backbone
    mae_vit_base_patch16 --use_adapter --weights ...`: every encoder layer
    matched, the decoder and mask token counted unused, and the CSV
    features equal to the trained encoder's on the same decoded tiles
    (f32, bit for bit)."""
    from snuffy_tpu_torch import compute_feats
    from snuffy_tpu_torch.embed import registry
    from snuffy_tpu_torch.embed.pipeline import decode_batch, embed_tiles

    monkeypatch.setattr(registry, "mae_vit_base_patch16", tiny)
    state = cli.main(argv(tmp_path, "--epochs=1"))
    (best,) = [f for f in os.listdir(tmp_path / "out") if "best" in f]
    weights = str(tmp_path / "out" / best)
    bag = tmp_path / "datasets" / "c16" / "single" / "fold1" / "train" / \
        "1_tumor" / "slide_1"
    image_folder(str(bag.parent.parent / "tmp"), n_per_class=3, size=40)
    bag.mkdir(parents=True)
    tiles = sorted((bag.parent.parent / "tmp").rglob("*.jpeg"))
    for i, t in enumerate(tiles):
        os.replace(t, bag / f"{i}_{i + 1}.jpeg")
    capsys.readouterr()
    rows = compute_feats.main([
        "--embedder", "MAE", "--backbone", "mae_vit_base_patch16",
        "--use_adapter", "--weights", weights, "--dataset", "c16",
        "--datasets_path", str(tmp_path / "datasets"), "--embeddings_path",
        str(tmp_path / "emb"), "--num_workers", "0", "--batch_size", "4",
        "--compute_dtype", "float32", "--device", "cpu"])
    audit = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("layer audit")]
    full = state.model.state_dict()
    encoder = [k for k in full if not k.startswith(("decoder", "mask_"))]
    assert audit == [f"layer audit: {len(encoder)} matched, 0 "
                     f"missing/mismatched, {len(full) - len(encoder)} unused "
                     f"in {weights}"]
    (csv_path, _), = rows
    with open(csv_path) as f:
        feats = np.array([line.split(",")[:32] for line in
                          f.read().splitlines()[1:]], np.float32)
    paths = sorted(str(p) for p in bag.glob("*.jpeg"))
    emb = registry.build_embedder("MAE", "mae_vit_base_patch16",
                                  use_adapter=True, device="cpu")
    emb.backbone.load_state_dict({k: full[k] for k in encoder})
    want = embed_tiles(emb, decode_batch(paths, 224), 4)
    np.testing.assert_array_equal(feats, want)
