"""The fused residual sum, LayerScale and LayerNorm (`ops/residual_norm.py`)
on the CPU: its plain version is the composed ops the ViT block ran, bit
for bit; the ViT's forward through it equals its composed forward bit for
bit, with 2 · depth + 1 fused norms a forward where no gradient is recorded
and no stochastic depth is drawn, and none otherwise; the wrapper's checks;
the kernel's name in a trace is its own. The kernel itself runs on the card
(`tests/test_torch_residual_norm_card.py`).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.embed.registry import Embedder
from snuffy_tpu_torch.models import layers, vit
from snuffy_tpu_torch.models.snuffy import build_milnet
from snuffy_tpu_torch.ops import kernels
from snuffy_tpu_torch.ops.residual_norm import MAX_D, residual_norm
from snuffy_tpu_torch.pipeline.slide_inference import predict_tiles

CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"


def composed(x, ln, dtype, b=None, ls=None):
    """The block's ops around a norm as the ViT block ran them before the
    fused norm: LayerScale's module, the add, `layers.layer_norm`."""
    s = x
    if b is not None:
        s = x + (b if ls is None else ls(b))
    return s, layers.layer_norm(s, ln, dtype)


def norm_inputs(d, dtype, seed=0, rows=37, stream=None):
    """x in the stream's dtype (the compute dtype where None), b in the
    compute dtype, the norm's and LayerScale's parameters."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((rows, d), generator=gen) * 2 + 3).to(stream or dtype)
    b = torch.randn((rows, d), generator=gen).to(dtype)
    ln = torch.nn.LayerNorm(d, eps=layers.LN_EPS)
    ls = vit.LayerScale(d, 0.5)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * torch.randn(d, generator=gen))
        ln.bias.copy_(0.1 * torch.randn(d, generator=gen))
        ls.gamma.copy_(0.5 * torch.randn(d, generator=gen))
    return x, b, ln, ls


@pytest.mark.parametrize("d", [384, 1280, 131])
@pytest.mark.parametrize("mode", ["x", "x+b", "x+gamma*b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   # an f32 stream with bf16 branches
                                   (torch.float32, torch.bfloat16)],
                         ids=["float32", "bfloat16", "float32-bfloat16"])
def test_plain_version_is_the_composed_ops(dtype, mode, d):
    stream, dtype = dtype if isinstance(dtype, tuple) else (dtype, dtype)
    x, b, ln, ls = norm_inputs(d, dtype, seed=d, stream=stream)
    b = None if mode == "x" else b
    ls = ls if mode == "x+gamma*b" else None
    gamma = None if ls is None else ls.gamma.to(dtype)
    with torch.no_grad():
        want_s, want_y = composed(x, ln, dtype, b, ls)
        s, y = residual_norm(x, ln.weight, ln.bias, ln.eps, b, gamma, dtype)
        s2, y2 = layers.residual_layer_norm(x, ln, dtype, b, gamma)
        s3, y3 = layers.composed_residual_layer_norm(x, ln, dtype, b, gamma)
    for got in ((s, y), (s2, y2), (s3, y3)):
        assert torch.equal(got[0], want_s) and torch.equal(got[1], want_y)
        assert got[0].dtype == stream and got[1].dtype == dtype


SMALL_VIT = dict(patch_size=16, embed_dim=384, depth=2, num_heads=6,
                 img_size=64)
VIRCHOW2_SMALL = dict(patch_size=14, embed_dim=160, depth=2, num_heads=2,
                      mlp_ratio=5.3375, img_size=56, reg_tokens=4,
                      init_values=1e-5, mlp="swiglu_packed", pool="cls_mean")
MODELS = {
    "vits16": (SMALL_VIT, 1),
    "vits16_packed": (SMALL_VIT, 2),
    "virchow2": (VIRCHOW2_SMALL, 1),
    # a large adapter output, so that another order of the closing sum
    # would round otherwise
    "adapter": (dict(SMALL_VIT, use_adapter=True, adapter_scale=4.0), 1),
    # the learnable f32 scale promotes the residual stream to f32 in bf16
    "adapter_learnable": (dict(SMALL_VIT, use_adapter=True,
                               adapter_learnable_scale=True), 1),
}


def small_model(kw, dtype, seed=3):
    """A ViT whose every parameter is moved off its init (LayerScale's γ,
    the adapters' zero up-projections), so that each op shows."""
    model = vit.VisionTransformer(compute_dtype=dtype, seed=seed, **kw)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model.eval()


def images(kw, n=4, seed=1):
    size = kw["img_size"]
    return torch.rand((n, size, size, 3),
                      generator=torch.Generator().manual_seed(seed))


def pre_change_forward(model, x, pack):
    """The ViT's forward as it ran before the fused norm, written out from
    the blocks' input on: each block's LayerScale modules, adds and
    `layers.layer_norm`s, the final norm on the CLS token alone where
    that is the pool."""
    held = {}

    def hold(mod, args):
        held.setdefault("x", args[0])

    hook = model.blocks[0].register_forward_pre_hook(hold)
    with torch.no_grad():
        model(x, pack=pack)
    hook.remove()
    dtype = getattr(torch, model.compute_dtype)
    run = vit.Run(False, None, pack)
    t = held["x"]
    with torch.no_grad():
        for blk in model.blocks:
            a = blk.attn(layers.layer_norm(t, blk.norm1, dtype), dtype, run)
            if blk.ls1 is not None:
                a = blk.ls1(a)
            t = t + a
            y = blk.mlp(layers.layer_norm(t, blk.norm2, dtype), dtype, run)
            if blk.ls2 is not None:
                y = blk.ls2(y)
            out = t + y
            if blk.adaptmlp is not None:
                out = out + blk.adaptmlp(t, dtype, run)
            t = out
        t = t.reshape(x.shape[0], -1, model.embed_dim)
        if model.pool == "cls_mean":
            return vit.class_plus_mean(
                layers.layer_norm(t, model.norm, dtype).float(),
                model.num_prefix)
        return layers.layer_norm(t[:, 0], model.norm, dtype).float()


@pytest.fixture
def norm_calls(monkeypatch):
    """Counts the ViT's calls of the fused norm."""
    calls = []
    real = vit.residual_layer_norm

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(vit, "residual_layer_norm", counted)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MODELS))
def test_fused_forward_is_the_composed_forward(name, dtype, norm_calls):
    """Under no_grad the forward runs 2 · depth + 1 fused norms; it and
    the forward with grad on (the composed ops) give the forward as it ran
    before the fused norm bit for bit."""
    kw, pack = MODELS[name]
    model = small_model(kw, dtype)
    x = images(kw)
    with torch.no_grad():
        fused = model(x, pack=pack)
    assert len(norm_calls) == 2 * kw["depth"] + 1
    del norm_calls[:]
    got = model(x, pack=pack)
    assert not norm_calls and got.requires_grad
    want = pre_change_forward(model, x, pack)
    assert torch.equal(fused, want)
    assert torch.equal(got.detach(), want)


@pytest.mark.parametrize("case", ["grad", "stochastic_depth", "train"])
def test_the_fused_norms_engage_without_gradient_or_stochastic_depth(
        case, norm_calls):
    """Grad on, or stochastic depth drawn in training: the composed ops.
    Training under no_grad with no stochastic depth (dropouts drawn in the
    same order): fused, with the composed forward's output."""
    kw = dict(SMALL_VIT, drop_rate=0.1,
              drop_path_rate=0.1 if case == "stochastic_depth" else 0.0)
    model = small_model(kw, "float32").train()
    x = images(kw)

    def forward():
        return model(x, generator=torch.Generator().manual_seed(9))

    if case == "grad":
        forward()
        assert not norm_calls
        return
    with torch.no_grad():
        got = forward()
    if case == "stochastic_depth":
        assert not norm_calls
        return
    assert len(norm_calls) == 2 * kw["depth"] + 1
    assert torch.equal(got, forward().detach())


def test_predict_tiles_counts_the_kernels_launches():
    """`embed_bag`'s timings carry residual_norm_launches: the kernel's
    launches in the request, none on the CPU, where the plain version
    runs."""
    torch.manual_seed(0)
    model = vit.VisionTransformer(patch_size=16, embed_dim=32, depth=2,
                                  num_heads=2)
    embedder = Embedder(model, 32, 1).eval()
    cfg = SnuffyModelConfig(feats_size=32, num_classes=1, num_heads=2,
                            big_lambda=8, random_patch_share=0.5, depth=2,
                            activation="gelu")
    milnet = build_milnet(cfg, seed=0, device="cpu")
    tiles = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (5, 224, 224, 3)).astype(np.uint8))
    t = predict_tiles(tiles, embedder, milnet, embed_batch=4).timings
    assert t["residual_norm_launches"] == 0


def _refusals():
    x = torch.zeros((4, 8))
    w, bias = torch.ones(8), torch.zeros(8)
    meta = torch.zeros((4, 8), device="meta")
    return {
        "b on another device": (ValueError, (x, w, bias, meta)),
        "x on no supported device": (
            ValueError, (meta, w.to("meta"), bias.to("meta"))),
        "x float16": (TypeError, (x.half(), w, bias)),
        "b of another dtype": (TypeError, (x, w, bias, x.bfloat16())),
        "a bf16 stream under an f32 compute dtype": (
            TypeError, (x.bfloat16(), w, bias, None, None, torch.float32)),
        "compute dtype float16": (TypeError, (x, w, bias, None, None,
                                              torch.float16)),
        "gamma of another dtype": (TypeError,
                                   (x, w, bias, x, torch.ones(8).double())),
        "weight bf16": (TypeError, (x, w.bfloat16(), bias)),
        "gamma without b": (ValueError, (x, w, bias, None, torch.ones(8))),
        "b of another shape": (ValueError, (x, w, bias, x[:3])),
        "gamma of another shape": (ValueError, (x, w, bias, x,
                                                torch.ones(4))),
        "bias of another shape": (ValueError, (x, w, torch.zeros(9))),
        "d past the kernel's": (ValueError, (
            torch.zeros((1, MAX_D + 1)), torch.ones(MAX_D + 1),
            torch.zeros(MAX_D + 1))),
        "x not contiguous": (ValueError, (torch.zeros((8, 4)).t(), w, bias)),
        "b not contiguous": (ValueError, (x, w, bias,
                                          torch.zeros((8, 4)).t())),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    err, (x, w, bias, *rest) = _refusals()[case]
    with pytest.raises(err):
        residual_norm(x, w, bias, 1e-6, *rest)


def test_the_kernels_name_is_its_own_in_a_trace():
    """The benchmark's trace gives a kernel the device time of every
    device function whose name holds one of its passes' fragments: the
    new kernel's fragment is in no other kernel's device functions, nor
    in torch's LayerNorm kernel, and no other kernel's is in its."""
    def device_names(path):
        text = path.read_text()
        return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                              r"\([^)]*\)\s*)?(\w+)", text))

    own = kernels.RESIDUAL_NORM.passes
    assert own == ("residual_norm",)
    names = device_names(CSRC / "residual_norm.cu")
    assert names == {"residual_norm_kernel"}
    others = [k for k in kernels.KERNELS if k is not kernels.RESIDUAL_NORM]
    for k in others:
        other_names = device_names(CSRC / f"{k.name}.cu")
        assert other_names
        assert not any(p in n for p in own for n in other_names)
        assert not any(p in n for p in k.passes for n in names)
    assert not any(p in "vectorized_layer_norm_kernel" for p in own)
