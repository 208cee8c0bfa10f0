"""The port's ResNet-18 (SimCLR) and ResNet-50 (DINO) vs the JAX package.

Batch 2 of seeded 64² images through the flax models and the port's, the
weights carried across by `bridge.resnet_from_jax` (strict load). Frozen
BatchNorm's running stats, weight and bias are drawn away from their init
so the norm is live. A state dict under torchvision's names loads with
`strict=True`, and the port's importers give the JAX importers' features
from the same `.pth`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snuffy_tpu.embed import torch_import as jax_ti
from snuffy_tpu.models.resnet import ResNet18 as JaxResNet18
from snuffy_tpu.models.resnet import ResNet50 as JaxResNet50
from snuffy_tpu_torch.bridge import resnet_from_jax
from snuffy_tpu_torch.embed import torch_import as ti
from snuffy_tpu_torch.models.resnet import ResNet18, ResNet50

SIZE = 64
# f32: max |port − JAX| within 1e-4 of max |JAX| (sums in other orders
# through 8 or 16 blocks). bf16: the two frameworks round each conv's
# output to bf16 from f32 sums taken in other orders, which the norms then
# rescale; at 64² the last stage's InstanceNorm runs over 2×2 positions,
# where JAX's own bf16 and f32 runs differ by 0.16 of max |out|. The
# existing ViT bf16 parity's elementwise rtol/atol.
F32_REL = 1e-4
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
MODELS = {"resnet18": (JaxResNet18, ResNet18), "resnet50": (JaxResNet50,
                                                            ResNet50)}


def jax_params(arch, norm, dtype="float32", seed=0):
    """The flax model and its parameter tree drawn from a numpy seed (the
    shapes from `jax.eval_shape`, which compiles nothing): conv kernels
    N(0, 1/fan_in), each FrozenBatchNorm's statistics and affine away
    from their init."""
    model = MODELS[arch][0](norm=norm, compute_dtype=dtype)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key, shape = path[-1].key, leaf.shape
        if key == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:3]))
        elif key in ("scale", "var"):
            v = 0.5 + rng.random(shape)
        else:   # mean, bias
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def port_model(arch, norm, params, dtype="float32"):
    model = MODELS[arch][1](norm=norm, compute_dtype=dtype)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           resnet_from_jax(params).items()}, strict=True)
    return model.eval()


def images(seed=0):
    return np.random.default_rng(seed).random((2, SIZE, SIZE, 3),
                                              dtype=np.float32)


@pytest.mark.parametrize("arch, norm", [("resnet18", "instance"),
                                        ("resnet18", "batch"),
                                        ("resnet50", "batch")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_matches_jax(arch, norm, dtype):
    jm, params = jax_params(arch, norm, dtype)
    x = images()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.inference_mode():
        got = port_model(arch, norm, params, dtype)(torch.from_numpy(x))
    dim = 512 if arch == "resnet18" else 2048
    assert got.dtype == torch.float32 and got.shape == (2, dim)
    if dtype == "float32":
        err = float(np.abs(got.numpy() - want).max())
        assert err <= F32_REL * float(np.abs(want).max()), err
    else:
        np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)


def test_dtypes_follow_jax():
    """Under bf16 every conv runs in bf16 and returns bf16; the norms, the
    blocks' outputs (the residual stream) and the pool are f32."""
    model = ResNet18(norm="instance", compute_dtype="bfloat16").eval()
    seen = {"conv": [], "block": [], "norm": []}
    orig = torch.nn.functional.conv2d

    def spy(x, w, *a, **k):
        seen["conv"].append((x.dtype, w.dtype))
        return orig(x, w, *a, **k)

    for mod in model.modules():
        kind = ("block" if type(mod).__name__ == "BasicBlock" else
                "norm" if type(mod).__name__ == "InstanceNorm" else None)
        if kind:
            mod.register_forward_hook(
                lambda m, a, out, kind=kind: seen[kind].append(out.dtype))
    torch.nn.functional.conv2d = spy
    try:
        with torch.inference_mode():
            out = model(torch.from_numpy(images()))
    finally:
        torch.nn.functional.conv2d = orig
    assert out.dtype == torch.float32
    assert seen["conv"] == [(torch.bfloat16, torch.bfloat16)] * 20
    assert seen["block"] == [torch.float32] * 8
    assert seen["norm"] == [torch.float32] * 20


def torchvision_names(arch, norm):
    """The state-dict names of torchvision's resnet18/50 with fc removed
    (BatchNorm with num_batches_tracked; InstanceNorm2d without affine or
    running stats has none)."""
    blocks = (2, 2, 2, 2) if arch == "resnet18" else (3, 4, 6, 3)
    nconv = 2 if arch == "resnet18" else 3
    bn = (["weight", "bias", "running_mean", "running_var",
           "num_batches_tracked"] if norm == "batch" else [])
    names = ["conv1.weight"] + [f"bn1.{p}" for p in bn]
    for li, count in enumerate(blocks, start=1):
        for bi in range(count):
            pre = f"layer{li}.{bi}"
            for j in range(1, nconv + 1):
                names.append(f"{pre}.conv{j}.weight")
                names += [f"{pre}.bn{j}.{p}" for p in bn]
            if bi == 0 and (li > 1 or arch == "resnet50"):
                names.append(f"{pre}.downsample.0.weight")
                names += [f"{pre}.downsample.1.{p}" for p in bn]
    return names


@pytest.mark.parametrize("arch, norm", [("resnet18", "instance"),
                                        ("resnet18", "batch"),
                                        ("resnet50", "batch")])
def test_torchvision_state_dict_loads_strict(arch, norm):
    model = MODELS[arch][1](norm=norm)
    names = torchvision_names(arch, norm)
    own = model.state_dict()
    assert sorted(own) == sorted(n for n in names
                                 if "num_batches_tracked" not in n)
    gen = torch.Generator().manual_seed(0)
    sd = {n: (torch.tensor(7) if n.endswith("num_batches_tracked") else
              torch.randn(own[n].shape, generator=gen)) for n in names}
    model.load_state_dict(sd, strict=True)
    for n, v in model.state_dict().items():
        assert torch.equal(v, sd[n]), n


@pytest.mark.parametrize("arch, norm", [("resnet18", "instance"),
                                        ("resnet18", "batch"),
                                        ("resnet50", "batch")])
def test_importers_give_the_jax_importers_features(tmp_path, arch, norm):
    """One torchvision-named `.pth` (in a 'state_dict' container under
    `module.`, with an fc head) through the JAX importer onto the flax
    model and through the port's onto the port's model: the same
    features."""
    jm, params = jax_params(arch, norm, seed=3)
    sd = {k: torch.from_numpy(v) for k, v in resnet_from_jax(params).items()}
    sd["fc.weight"], sd["fc.bias"] = torch.ones(5, 512), torch.zeros(5)
    path = str(tmp_path / "resnet.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               path)

    jsd = jax_ti.load_torch_state_dict(path)
    if arch == "resnet18":
        jtree, tree = jax_ti.import_resnet18(jsd, norm), ti.import_resnet18(
            ti.load_torch_state_dict(path), norm)
    else:
        jtree, tree = jax_ti.import_resnet50(jsd), ti.import_resnet50(
            ti.load_torch_state_dict(path))
    _, fresh = jax_params(arch, norm, seed=4)
    jmerged = jax_ti.merge_into(fresh, jtree)
    x = images(seed=1)
    want = np.asarray(jm.apply({"params": jmerged}, jnp.asarray(x)))

    model = MODELS[arch][1](norm=norm, seed=4)
    ti.merge_into(model, tree)
    assert "fc.weight" not in tree
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= F32_REL * np.abs(want).max()
