"""The port's DINO-adapter pretraining CLI on the CPU (`--device cpu`).

Mirrors `tests/test_ssl_cli.py` (the smoke run, the resume with the
optimizer's state, `bool_flag`) on tiny factories, and adds: the
`checkpoint.pth` layout loaded with `weights_only=True`;
`--full_checkpoint` from a reference-layout `.pth` (with and without
`--random_head`) and from a plain backbone `.pth`, against the JAX CLI
on the same file; the head filter against the JAX `import_dino_head`;
the written checkpoint's teacher loading into the port's extraction CLI
with every layer matched, its features equal to the teacher backbone's.
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

from snuffy_tpu_torch import main_dino_adapter as cli
from snuffy_tpu_torch.models import vit as vit_mod

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TINY = dict(patch_size=8, embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0)


def tiny(**kw):
    kw.pop("patch_size", None)
    return vit_mod.VisionTransformer(**TINY, **kw)


@pytest.fixture
def tiny_factories(monkeypatch):
    for name in ("vit_tiny", "vit_small"):
        monkeypatch.setattr(vit_mod, name, tiny)
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
    return ["--arch=vit_tiny", "--batch_size_per_gpu=4",
            f"--data_path={data}", f"--output_dir={tmp_path}/out",
            "--num_workers=0", "--img_size=32", "--global_size=32",
            "--local_size=16", "--local_crops_number=2", "--out_dim=32",
            "--warmup_epochs=1", "--max_steps_per_epoch=2",
            *([f"--device={device}"] if device else []), *extra]


def log_rows(tmp_path):
    with open(tmp_path / "out" / "log.txt") as f:
        return [json.loads(line) for line in f.read().strip().splitlines()]


def test_dino_cli_smoke(tmp_path, tiny_factories):
    timings = {}
    state = cli.main(argv(tmp_path, "--epochs=2",
                          f"--valid_data_path={tmp_path}/imgs"), timings)
    log = log_rows(tmp_path)
    assert len(log) == 2 and log[-1]["val_loss"] is not None
    assert all(np.isfinite(r["train_loss"]) for r in log)
    assert state.step == 4 and timings["steps"] == 4
    assert {"decode_s", "augment_s", "forward_s", "backward_s",
            "update_s"} <= set(timings)
    out = tmp_path / "out"
    assert sorted(os.listdir(out)) == ["checkpoint.pth", "checkpoint0000.pth",
                                       "log.txt"]
    ckpt = torch.load(out / "checkpoint.pth", weights_only=True)
    assert set(ckpt) == {"student", "teacher", "optimizer", "dino_loss",
                         "step", "epoch", "args"}
    assert (ckpt["epoch"], ckpt["step"]) == (2, 4)
    assert ckpt["args"]["out_dim"] == 32
    assert "backbone.blocks.0.adaptmlp.down_proj.weight" in ckpt["teacher"]
    assert ckpt["teacher"]["head.last_layer.weight_v"].shape == (32, 256)
    assert ckpt["dino_loss"]["center"].shape == (1, 32)
    assert int(ckpt["optimizer"]["count"]) == 4


def test_dino_cli_resume_restores_opt_state(tmp_path, tiny_factories):
    state1 = cli.main(argv(tmp_path, "--epochs=2"))
    ckpt = torch.load(tmp_path / "out" / "checkpoint.pth", weights_only=True)
    live = state1.opt_state
    assert any(bool(v.abs().sum() > 0) for v in live["exp_avg"].values())
    for key in ("exp_avg", "exp_avg_sq"):
        for name, v in live[key].items():
            assert torch.equal(ckpt["optimizer"][key][name], v), name
    assert int(ckpt["optimizer"]["count"]) == int(live["count"]) == 4
    state2 = cli.main(argv(tmp_path, "--epochs=3"))
    assert state2.step == 6 and int(state2.opt_state["count"]) == 6
    assert [r["epoch"] for r in log_rows(tmp_path)] == [0, 1, 2]


def test_dino_cli_resume_without_optimizer_state(tmp_path, tiny_factories):
    cli.main(argv(tmp_path, "--epochs=1", "--max_steps_per_epoch=1"))
    path = tmp_path / "out" / "checkpoint.pth"
    ckpt = torch.load(path, weights_only=True)
    del ckpt["optimizer"]
    torch.save(ckpt, path)
    state = cli.main(argv(tmp_path, "--epochs=2", "--max_steps_per_epoch=1"))
    assert state.step == 2 and int(state.opt_state["count"]) == 1


def test_bool_flag_parsing():
    args = cli.get_args_parser().parse_args(
        ["--norm_last_layer", "False", "--use_adapter", "false",
         "--use_bn_in_head", "true"])
    assert args.norm_last_layer is False
    assert args.use_adapter is False
    assert args.use_bn_in_head is True
    with pytest.raises(SystemExit):
        cli.get_args_parser().parse_args(["--norm_last_layer", "maybe"])


def test_no_gpu_raises_for_the_default_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(argv(tmp_path, "--epochs=1", device=None))


# ------------------------------------------------------ --full_checkpoint


def seeded_checkpoint(path, out_dim=32, use_bn=False, plain=False):
    """A reference-layout training checkpoint of the tiny model from
    seeded weights (teacher ≠ student), with an argparse Namespace beside
    them; or, `plain`, the student's backbone alone."""
    from snuffy_tpu_torch.ssl.dino import DINOTrainer

    t = DINOTrainer(tiny(use_adapter=True, adapter_bottleneck=64,
                         adapter_scale=4.0, seed=11),
                    out_dim=out_dim, use_bn_in_head=use_bn, n_local_crops=2)
    s = t.init_state(11)
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for net, scale in ((s.student, 0.05), (s.teacher, 0.07)):
            for p in net.parameters():
                p.add_(scale * torch.randn(p.shape, generator=gen))
    if plain:
        torch.save(s.student.backbone.state_dict(), path)
    else:
        torch.save({"student": {f"module.{k}": v for k, v in
                                s.student.state_dict().items()},
                    "teacher": s.teacher.state_dict(),
                    "args": argparse.Namespace(arch="vit_small")}, path)
    return s


@pytest.fixture
def jax_tiny_factories(monkeypatch):
    from snuffy_tpu.models import vit as jvit

    def jtiny(**kw):
        kw.pop("patch_size", None)
        return jvit.VisionTransformer(**TINY, **kw)

    for name in ("vit_tiny", "vit_small"):
        monkeypatch.setattr(jvit, name, jtiny)


@pytest.mark.parametrize("kind", ["full", "random_head", "plain"])
def test_full_checkpoint_matches_the_jax_cli(tmp_path, tiny_factories,
                                             jax_tiny_factories, kind):
    """Both CLIs (0 epochs) on the same seeded `.pth`: the tensors the
    file gives are the JAX CLI's, the rest keep the port's init."""
    import jax

    import main_dino_adapter as jax_cli
    from snuffy_tpu_torch.bridge import dino_from_jax

    path = str(tmp_path / "ref.pth")
    src = seeded_checkpoint(path, plain=kind == "plain")
    extra = [f"--full_checkpoint={path}", "--epochs=0"]
    if kind == "random_head":
        extra.append("--random_head=1")
    ours = cli.main(argv(tmp_path, *extra))
    fresh = cli.build_trainer(cli.get_args_parser().parse_args(
        argv(tmp_path)), torch.device("cpu")).init_state(0)
    jargs = jax_cli.get_args_parser().parse_args(argv(tmp_path, *extra,
                                                      device=None))
    theirs = dino_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_cli.train_dino(jargs)._asdict()))
    for part in ("student", "teacher"):
        got = getattr(ours, part).state_dict()
        from_file = src.student if (kind == "plain" or part == "student") \
            else src.teacher
        for k, v in got.items():
            if k.endswith("num_batches_tracked"):
                continue
            # a fixed g (norm_last_layer) is never taken
            take = k.startswith("backbone.") or (
                kind == "full" and not k.endswith("weight_g"))
            if take:
                np.testing.assert_array_equal(v.numpy(), theirs[part][k],
                                              err_msg=k)
                assert torch.equal(v, from_file.state_dict()[k]), k
            else:
                assert torch.equal(v, fresh.student.state_dict()[k]), k


@pytest.mark.parametrize("case", ["same", "out_dim", "random_head",
                                  "plain_weight", "bn_into_plain",
                                  "plain_into_bn", "free_g"])
def test_import_dino_head_matches_jax(case):
    """Which head tensors the filter takes, and their values, against the
    JAX `import_dino_head` on the same state dict."""
    from snuffy_tpu.embed import torch_import as jti
    from snuffy_tpu.models.vit import DINOHead as JaxHead
    from snuffy_tpu_torch.bridge import dino_head_state_dict
    from snuffy_tpu_torch.embed import torch_import as ti
    import jax
    import jax.numpy as jnp

    src_bn = case == "bn_into_plain"
    dst_bn = case == "plain_into_bn"
    norm_last = case != "free_g"
    src = vit_mod.DINOHead(32, 48 if case == "out_dim" else 32, 24, 16,
                           use_bn=src_bn, norm_last_layer=norm_last, seed=3)
    sd = {k: v.clone() for k, v in src.state_dict().items()}
    if case == "plain_weight":
        sd["last_layer.weight"] = sd.pop("last_layer.weight_v")
        del sd["last_layer.weight_g"]
    if case == "free_g":
        sd["last_layer.weight_g"] = torch.rand(32, 1)
    dst = vit_mod.DINOHead(32, 32, 24, 16, use_bn=dst_bn,
                           norm_last_layer=norm_last, seed=4)
    got = ti.import_dino_head(sd, dst.state_dict(), case == "random_head",
                              norm_last)
    jhead = JaxHead(out_dim=32, hidden_dim=24, bottleneck_dim=16,
                    use_bn=dst_bn, norm_last_layer=norm_last)
    # NaN where the import takes nothing
    template = jax.tree_util.tree_map(
        lambda x: np.full(np.shape(x), np.nan, np.float32),
        jhead.init(jax.random.PRNGKey(0), jnp.zeros((1, 32)))["params"])
    want = jti.import_dino_head({k: v.numpy() for k, v in sd.items()},
                                template, case == "random_head")
    as_port = dino_head_state_dict(jti.merge_into(template, want))
    # (a head with a fixed g has no g in the JAX tree: the bridge fills 1)
    taken = {k for k, v in as_port.items() if "running" not in k
             and "num_batches" not in k and not np.isnan(v).any()
             and not (norm_last and k.endswith("weight_g"))}
    assert set(got) == taken
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), as_port[k])


# ------------------------------------------------ into the extraction CLI


def test_checkpoint_loads_into_compute_feats(tmp_path, tiny_factories,
                                             monkeypatch, capsys):
    """The written checkpoint.pth into `compute_feats --embedder DINO
    --backbone vit_small --use_adapter --weights ...`: every layer
    matched, and the CSV features equal the trained teacher's backbone on
    the same decoded tiles (f32, bit for bit)."""
    from snuffy_tpu_torch import compute_feats
    from snuffy_tpu_torch.embed import registry
    from snuffy_tpu_torch.embed.pipeline import decode_batch, embed_tiles

    monkeypatch.setattr(registry, "vit_small", tiny)
    state = cli.main(argv(tmp_path, "--epochs=1"))
    bag = tmp_path / "datasets" / "c16" / "single" / "fold1" / "train" / \
        "1_tumor" / "slide_1"
    image_folder(str(bag.parent.parent / "tmp"), n_per_class=3, size=40)
    bag.mkdir(parents=True)
    tiles = sorted((bag.parent.parent / "tmp").rglob("*.jpeg"))
    for i, t in enumerate(tiles):
        os.replace(t, bag / f"{i}_{i + 1}.jpeg")
    capsys.readouterr()
    rows = compute_feats.main([
        "--embedder", "DINO", "--backbone", "vit_small", "--patch_size",
        "8", "--use_adapter", "--weights",
        str(tmp_path / "out" / "checkpoint.pth"), "--dataset", "c16",
        "--datasets_path", str(tmp_path / "datasets"), "--embeddings_path",
        str(tmp_path / "emb"), "--num_workers", "0", "--batch_size", "4",
        "--compute_dtype", "float32", "--device", "cpu"])
    audit = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("layer audit")]
    n = len(state.teacher.backbone.state_dict())
    assert audit == [f"layer audit: {n} matched, 0 missing/mismatched, "
                     f"{len(state.teacher.head.state_dict())} unused in "
                     f"{tmp_path / 'out' / 'checkpoint.pth'}"]
    (csv_path, _), = rows
    with open(csv_path) as f:
        feats = np.array([line.split(",")[:32] for line in
                          f.read().splitlines()[1:]], np.float32)
    paths = sorted(str(p) for p in bag.glob("*.jpeg"))
    emb = registry.build_embedder("DINO", "vit_small", patch_size=8,
                                  use_adapter=True, device="cpu")
    emb.backbone.load_state_dict({k[len("backbone."):]: v for k, v in
                                  state.teacher.state_dict().items()
                                  if k.startswith("backbone.")})
    want = embed_tiles(emb, decode_batch(paths, 224), 4)
    np.testing.assert_array_equal(feats, want)
