"""The port's checkpoint importers and hub entries vs the JAX package's.

`load_torch_state_dict`'s container unwrapping, `strip_prefixes`,
`positional_rezip` with its two errors, the matched and mismatched lists
of `check_layers` against JAX's on the same partial checkpoints (names
mapped from flax paths to torchvision's and DINO's), and `hubconf`: the
path it reads, the `FileNotFoundError` naming the official URL, a
ResNet-50 read from a `.pth` it finds, and the XCiT entry raising.
"""

import argparse
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hubconf as root_hub
from snuffy_tpu.embed import torch_import as jax_ti
from snuffy_tpu.models.resnet import ResNet18 as JaxResNet18
from snuffy_tpu.models.resnet import ResNet50 as JaxResNet50
from snuffy_tpu.models.vit import VisionTransformer as JaxViT
from snuffy_tpu_torch import hubconf
from snuffy_tpu_torch.bridge import resnet_from_jax, vit_from_jax
from snuffy_tpu_torch.embed import torch_import as ti
from snuffy_tpu_torch.models.resnet import ResNet18, ResNet50
from snuffy_tpu_torch.models.vit import VisionTransformer


def tensors(names, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn((2, 3), generator=gen) for k in names}


@pytest.mark.parametrize("container", [None, "state_dict", "model",
                                       "teacher"])
def test_load_torch_state_dict_unwraps_as_jax_does(tmp_path, container):
    sd = tensors(["module.backbone.a", "b"])
    payload = dict(sd) if container is None else {
        container: dict(sd), "epoch": 3, "student": tensors(["x"], 1),
        "args": argparse.Namespace(lr=0.1)}
    if container is None:
        payload["note"] = "not a tensor"
    path = str(tmp_path / "ckpt.pth")
    torch.save(payload, path)
    got = ti.load_torch_state_dict(path)
    assert list(got) == ["module.backbone.a", "b"]
    if container != "teacher":   # JAX's torch.load refuses no pickle
        want = jax_ti.load_torch_state_dict(path)
        assert list(want) == list(got)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_load_stays_weights_only(tmp_path):
    path = str(tmp_path / "evil.pth")
    torch.save({"state_dict": {"a": torch.ones(1)},
                "hook": re.compile("x")}, path)
    with pytest.raises(Exception, match="weights_only|Unsupported global"):
        ti.load_torch_state_dict(path)


def test_strip_prefixes_matches_jax():
    names = ["module.backbone.blocks.0.x", "backbone.cls_token",
             "module.norm.weight", "head.w", "backbone.module.y"]
    got = ti.strip_prefixes(tensors(names))
    want = jax_ti.strip_prefixes({k: np.zeros(1) for k in names})
    assert list(got) == list(want)
    assert list(ti.strip_prefixes(tensors(names), ("head.",))) == list(
        jax_ti.strip_prefixes({k: 0 for k in names}, ("head.",)))


def test_positional_rezip_and_its_two_errors():
    template = {"conv1.weight": torch.zeros(4, 3), "bn.bias": torch.zeros(4)}
    foreign = {"features.0.w": torch.ones(4, 3), "features.1.b":
               torch.full((4,), 2.0)}
    got = ti.positional_rezip(foreign, template)
    want = jax_ti.positional_rezip(
        {k: v.numpy() for k, v in foreign.items()},
        {k: v.numpy() for k, v in template.items()})
    assert list(got) == list(want) == ["conv1.weight", "bn.bias"]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for mod, sd in ((ti, foreign), (jax_ti, {k: v.numpy()
                                            for k, v in foreign.items()})):
        short = dict(list(sd.items())[:1])
        with pytest.raises(ValueError, match="equal counts"):
            mod.positional_rezip(short, template)
        swapped = dict(reversed(list(sd.items())))
        with pytest.raises(ValueError, match="shape mismatch at conv1"):
            mod.positional_rezip(swapped, template)


def flax_to_port(path: str) -> str:
    """A flax leaf path ('layer2_0/downsample_bn/mean', 'blocks_1/attn/
    qkv/kernel') → the port's (torchvision's, DINO's) name."""
    names = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
             "var": "running_var", "downsample_conv": "downsample.0",
             "downsample_bn": "downsample.1"}
    parts = path.split("/")
    parts[0] = re.sub(r"^(layer\d|blocks)_(\d+)$", r"\1.\2", parts[0])
    return ".".join(names.get(p, p) for p in parts)


def flat_paths(tree):
    return ["/".join(str(p.key) for p in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def partial_checkpoint(sd, drop, reshape):
    """Leave out the tensors whose names match `drop` and give those that
    match `reshape` one more row (what the JAX importers take: they need
    every conv and block tensor present, at any shape)."""
    return {k: (torch.zeros((v.shape[0] + 1,) + v.shape[1:])
                if re.search(reshape, k) else torch.from_numpy(v) * 0.5)
            for k, v in sd.items() if not re.search(drop, k)}


@pytest.mark.parametrize("case", ["resnet18-instance", "resnet18-batch",
                                  "resnet50", "vit"])
def test_check_layers_lists_match_jax(tmp_path, case):
    x = jnp.zeros((1, 32, 32, 3))
    if case == "vit":
        jm = JaxViT(patch_size=16, embed_dim=32, depth=2, num_heads=2)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
        params = jax.tree_util.tree_map(np.asarray, params["params"])
        full, model = vit_from_jax(params), VisionTransformer(
            patch_size=16, embed_dim=32, depth=2, num_heads=2)
    else:
        arch, _, norm = case.partition("-")
        jax_cls, cls = ((JaxResNet18, ResNet18) if arch == "resnet18"
                        else (JaxResNet50, ResNet50))
        norm = norm or "batch"
        shapes = jax.eval_shape(jax_cls(norm=norm).init,
                                jax.random.PRNGKey(0), x)["params"]
        params = jax.tree_util.tree_map(
            lambda s: np.ones(s.shape, np.float32), shapes)
        full, model = resnet_from_jax(params), cls(norm=norm)
    if case == "vit":
        sd = partial_checkpoint(full, r"^norm\.|blocks\.0\.attn\.qkv\.bias",
                                r"blocks\.1\.mlp\.fc1\.weight")
    else:
        sd = partial_checkpoint(full, r"^bn1\.|layer3\.0\.downsample\.0|"
                                r"layer2\.1\.bn2", r"layer1\.0\.conv2")
    sd["fc.weight"] = torch.zeros(3, 3)
    path = str(tmp_path / "ckpt.pth")
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)

    jsd = jax_ti.load_torch_state_dict(path)
    psd = ti.load_torch_state_dict(path)
    if case == "vit":
        jimp, imp = jax_ti.import_vit(jsd), ti.import_vit(psd)
    elif case == "resnet50":
        jimp, imp = jax_ti.import_resnet50(jsd), ti.import_resnet50(psd)
    else:
        jimp = jax_ti.import_resnet18(jsd, norm)
        imp = ti.import_resnet18(psd, norm)
    jmatched, jmismatched = jax_ti.check_layers(jimp, params)
    matched, mismatched = ti.check_layers(imp, model.state_dict())
    assert mismatched and matched
    assert sorted(matched) == sorted(flax_to_port(p) for p in jmatched)
    assert sorted(mismatched) == sorted(flax_to_port(p)
                                        for p in jmismatched)
    assert sorted(flat_paths(params)) == sorted(flat_paths(
        jax_ti.merge_into(params, jimp)))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    ti.merge_into(model, imp)
    after = model.state_dict()
    for k in matched:
        assert torch.equal(after[k], imp[k]), k
    for k in mismatched:
        assert torch.equal(after[k], before[k]), k


def test_hub_registry_is_the_roots():
    assert hubconf.DINO_CHECKPOINTS == root_hub.DINO_CHECKPOINTS
    assert hubconf.MAE_CHECKPOINTS == root_hub.MAE_CHECKPOINTS
    assert hubconf._ARCH == root_hub._ARCH


@pytest.mark.parametrize("call, name", [
    (lambda d: hubconf.load_dino_backbone("dino_vits8", d, device="cpu"),
     "dino_vits8"),
    (lambda d: hubconf.load_dino_resnet50(d, device="cpu"), "dino_resnet50"),
])
def test_hub_names_the_url_of_a_missing_file(tmp_path, call, name):
    with pytest.raises(FileNotFoundError) as err:
        call(str(tmp_path))
    msg = str(err.value)
    assert str(tmp_path / f"{name}.pth") in msg
    assert hubconf.DINO_CHECKPOINTS[name] in msg
    with pytest.raises(FileNotFoundError) as jerr:
        (root_hub.load_dino_backbone(name, str(tmp_path))
         if name != "dino_resnet50"
         else root_hub.load_dino_resnet50(str(tmp_path)))
    assert str(jerr.value) == msg


def test_hub_reads_weights_dir_name_pth(tmp_path, capsys):
    """dino_resnet50.pth (torchvision names, with fc and
    num_batches_tracked) through load_dino_resnet50: every tensor taken,
    the three extra ones counted unused."""
    with torch.device("meta"):
        shapes = ResNet50().state_dict()
    gen = torch.Generator().manual_seed(3)
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in shapes.items()}
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    sd["bn1.num_batches_tracked"] = torch.tensor(5)
    torch.save(sd, tmp_path / "dino_resnet50.pth")
    model = hubconf.load_dino_resnet50(str(tmp_path), device="cpu")
    assert not model.training
    got = model.state_dict()
    assert sorted(got) == sorted(shapes)
    for k in shapes:
        assert torch.equal(got[k], sd[k]), k
    assert "265 matched, 0 missing/mismatched, 3 unused" in \
        capsys.readouterr().out


def test_xcit_entry_raises_with_its_reason():
    with pytest.raises(NotImplementedError, match="never written"):
        hubconf.load_dino_xcit("dino_xcit_small_12_p16")
    with pytest.raises(ModuleNotFoundError, match="xcit"):
        root_hub.load_dino_xcit("dino_xcit_small_12_p16")
