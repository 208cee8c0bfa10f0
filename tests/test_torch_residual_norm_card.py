"""The residual-norm kernel on the card (marked `cuda`; skipped without a
GPU). No JAX here, so the card's machine collects this file:

    python -m pytest --noconftest -m cuda -q \\
        -o "markers=cuda: needs a CUDA GPU" tests/test_torch_residual_norm_card.py

The kernel against its plain version (the composed PyTorch ops on the
card) at Virchow2's rows (256 tiles × 261 tokens, 1280 wide) and ViT-S/16's
(256 × 197, 384 wide), ragged row counts, an odd and the largest widths and
an unaligned base, in bf16, in f32 and with an f32 stream and bf16
branches: the sum s bit for bit, the norm y within one bf16 ulp, or 1e-6
of the row's largest |y| in f32. A ViT-H/14 forward of 256 tiles makes
2 · 32 + 1 launches, and so does a bf16 ViT-S/16 whose adapters' learnable
f32 scale promotes its stream to f32; `predict_tiles` counts them. Two
planted faults, built from a changed copy of the source (γ left
out of the sum; the statistics summed in bf16), fail the same checks.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.embed.registry import Embedder
from snuffy_tpu_torch.models import vit
from snuffy_tpu_torch.models.snuffy import build_milnet
from snuffy_tpu_torch.ops import _build, kernels
from snuffy_tpu_torch.ops.residual_norm import (
    residual_norm,
    residual_norm_reference,
)
from snuffy_tpu_torch.pipeline.slide_inference import predict_tiles

# (label, rows, d): the serve batches of Virchow2 and ViT-S/16, each less
# a few rows (no whole last block of rows), an odd width (the one-element
# body), the widest rows and one past a power of two
SHAPES = [("virchow2", 66816, 1280), ("virchow2 ragged", 66813, 1280),
          ("vits16", 50432, 384), ("vits16 ragged", 50431, 384),
          ("odd d", 777, 1283), ("d 8192", 5, 8192), ("d 8191", 3, 8191)]
MODES = ["x", "x+b", "x+gamma*b"]
# f32: the kernel's two-pass sums against PyTorch's Welford, relative to
# the row's largest |y|
F32_TOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def inputs(rows, d, dtype, mode, dev, seed=0, offset=0, stream=None):
    """A residual stream with a per-row offset (so the mean matters), in
    `stream` (`dtype` where None), a branch and γ in `dtype`, the norm's
    f32 parameters, and `dtype`. `offset` elements in front of x leave
    its base unaligned."""
    stream = stream or dtype
    gen = torch.Generator(dev).manual_seed(seed + rows + d)
    buf = torch.randn((rows * d + offset,), generator=gen, device=dev) * 2
    x = buf[offset:].view(rows, d)
    x += 3 * torch.rand((rows, 1), generator=gen, device=dev)
    x = x.to(stream) if offset == 0 else buf.to(stream)[offset:].view(rows, d)
    b = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
    gamma = (0.5 * torch.randn(d, generator=gen, device=dev)).to(dtype)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    bias = 0.1 * torch.randn(d, generator=gen, device=dev)
    return (x, w, bias, 1e-6,
            None if mode == "x" else b,
            gamma if mode == "x+gamma*b" else None, dtype)


def bf16_ulp(v):
    """One bf16 ulp at |v| (normal numbers; the smallest normal's below)."""
    e = torch.floor(torch.log2(v.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def check(got, want, label):
    """s bit for bit; y within one bf16 ulp of |y| (plus f32 noise of
    2^-18 of the row's largest |y|, where y nearly cancels and its ulp
    shrinks below the f32 sums' rounding), in f32 within F32_TOL of the
    row's largest |y|. Returns the largest error as a share of its limit."""
    (s, y), (s_ref, y_ref) = got, want
    assert torch.equal(s, s_ref), f"{label}: s differs from the plain sum"
    assert bool(torch.isfinite(y.float()).all()), f"{label}: y not finite"
    err = (y.float() - y_ref.float()).abs()
    row = y_ref.float().abs().amax(dim=-1, keepdim=True)
    if y.dtype == torch.bfloat16:
        limit = bf16_ulp(y_ref) + 2.0 ** -18 * row
    else:
        limit = F32_TOL * row
    share = float((err / limit).max())
    assert share <= 1.0, f"{label}: y off by {share} of its limit"
    return share


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   # an f32 stream with bf16 branches
                                   (torch.float32, torch.bfloat16)],
                         ids=["bfloat16", "float32", "float32-bfloat16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("label, rows, d", SHAPES + [("unaligned", 999,
                                                      1280)])
def test_kernel_against_plain(cuda_device, label, rows, d, mode, dtype):
    stream, dtype = dtype if isinstance(dtype, tuple) else (dtype, dtype)
    args = inputs(rows, d, dtype, mode, cuda_device, stream=stream,
                  offset=1 if label == "unaligned" else 0)
    if label == "unaligned":
        assert args[0].data_ptr() % 16 != 0
    before = kernels.RESIDUAL_NORM.launches
    with torch.no_grad():
        got = residual_norm(*args)
        want = residual_norm_reference(*args)
    torch.cuda.synchronize()
    assert kernels.RESIDUAL_NORM.launches == before + 1
    assert got[0].dtype == stream and got[1].dtype == dtype
    worst = check(got, want, f"{label} {mode} {stream} {dtype}")
    print(f"{label} {mode} {stream} {dtype}: worst error {worst!r} of the "
          "limit")
    with torch.no_grad():
        again = residual_norm(*args)
    assert torch.equal(again[1], got[1]), "two launches differ"


def vit_h(dev, monkeypatch):
    """Virchow2's ViT-H/14 on the card in bf16, its seeded host init left
    out: weights N(0, 0.02), γ 0.1, the norms' weight 1."""
    monkeypatch.setattr(vit, "init_weights", lambda *args: None)
    with torch.device(dev):
        model = vit.vit_huge_patch14_reg4(compute_dtype="bfloat16")
    gen = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.fill_(0.1)
            elif ".norm" in name or name.startswith("norm"):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=gen,
                                           device=dev))
    return model.eval()


@pytest.mark.cuda
def test_vit_h_forward_makes_two_launches_a_block_and_one(cuda_device,
                                                          monkeypatch):
    """A ViT-H/14 forward of 256 tiles: 2 · 32 + 1 launches. On 8 tiles
    the fused bf16 forward lies no further (within a fifth) from the same
    model's float32 forward than the composed bf16 one (grad on, no
    launch)."""
    model = vit_h(cuda_device, monkeypatch)
    gen = torch.Generator(cuda_device).manual_seed(1)
    x = torch.rand((256, 224, 224, 3), generator=gen, device=cuda_device)
    with torch.inference_mode():
        before = kernels.RESIDUAL_NORM.launches
        model(x)
        assert kernels.RESIDUAL_NORM.launches - before == 2 * 32 + 1
        fused = model(x[:8])
        model.compute_dtype = "float32"
        exact = model(x[:8])
        model.compute_dtype = "bfloat16"
    before = kernels.RESIDUAL_NORM.launches
    composed = model(x[:8]).detach()
    assert kernels.RESIDUAL_NORM.launches == before

    def rel(a):
        return float((a - exact).norm() / exact.norm())

    print(f"ViT-H bf16 against its float32 forward on 8 tiles: fused "
          f"{rel(fused)!r}, composed {rel(composed)!r}")
    assert rel(fused) <= 1.2 * rel(composed)


@pytest.mark.cuda
def test_an_f32_stream_goes_through_the_kernel(cuda_device, monkeypatch):
    """A bf16 ViT-S/16 with adapters of a learnable f32 scale: their sum
    promotes the stream to f32 from the first block's closing sum on; a
    forward of 256 tiles still makes 2 · 12 + 1 launches, the first
    block's two norms on a bf16 stream, the others on the f32 one, every
    norm's output bf16."""
    seen = []
    norm = vit.residual_layer_norm

    def recorded(*args):
        s, y = norm(*args)
        seen.append((args[0].dtype, y.dtype))
        return s, y

    monkeypatch.setattr(vit, "residual_layer_norm", recorded)
    model = vit.vit_small(patch_size=16, use_adapter=True,
                          adapter_learnable_scale=True,
                          compute_dtype="bfloat16").to(cuda_device).eval()
    gen = torch.Generator(cuda_device).manual_seed(2)
    x = torch.rand((256, 224, 224, 3), generator=gen, device=cuda_device)
    before = kernels.RESIDUAL_NORM.launches
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    assert kernels.RESIDUAL_NORM.launches - before == 2 * 12 + 1
    bf16, f32 = torch.bfloat16, torch.float32
    assert seen == [(bf16, bf16)] * 2 + [(f32, bf16)] * (2 * 11 + 1)
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_predict_tiles_counts_the_launches(cuda_device):
    """Three batches through a 2-block ViT: residual_norm_launches 3 · 5."""
    torch.manual_seed(0)
    model = vit.VisionTransformer(patch_size=16, embed_dim=384, depth=2,
                                  num_heads=6, compute_dtype="bfloat16")
    embedder = Embedder(model, 384, 1).to(cuda_device).eval()
    cfg = SnuffyModelConfig(feats_size=384, num_classes=1, num_heads=4,
                            big_lambda=64, random_patch_share=0.5, depth=2,
                            activation="gelu", compute_dtype="bfloat16")
    milnet = build_milnet(cfg, seed=0, device=cuda_device)
    tiles = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (600, 224, 224, 3)).astype(np.uint8))
    t = predict_tiles(tiles, embedder, milnet, embed_batch=256).timings
    assert t["residual_norm_launches"] == 3 * (2 * 2 + 1)


# each planted fault: (the text of csrc/residual_norm.cu it replaces, what
# replaces it)
FAULTS = {
    "gamma skipped": ("return round_to<T>(__fmul_rn(g, b));",
                      "return round_to<T>(b);"),
    "stats in bf16": (
        "float accumulate(float acc, float v) { return __fadd_rn(acc, v); }",
        "float accumulate(float acc, float v) {\n"
        "  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc, v)));\n"
        "}"),
}


def planted(tmp_path, fault):
    """The kernel's C entry built from a copy of its source with `fault`
    planted."""
    src = (_build.CSRC_DIR / "residual_norm.cu").read_text()
    old, new = FAULTS[fault]
    assert src.count(old) == 1, f"the source no longer holds {old!r}"
    path = tmp_path / "residual_norm.cu"
    path.write_text(src.replace(old, new))
    lib = tmp_path / "libresidual_norm_fault.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(path)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).snuffy_residual_norm
    fn.argtypes = list(kernels.RESIDUAL_NORM.argtypes)
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail_the_checks(cuda_device, tmp_path, fault):
    fn = planted(tmp_path, fault)
    x, w, bias, eps, b, gamma, dtype = inputs(4096, 1280, torch.bfloat16,
                                              "x+gamma*b", cuda_device)
    s, y = torch.empty_like(x), torch.empty_like(x)
    err = fn(x.data_ptr(), b.data_ptr(), gamma.data_ptr(), w.data_ptr(),
             bias.data_ptr(), s.data_ptr(), y.data_ptr(), 4096, 1280,
             kernels.DTYPES[x.dtype], kernels.DTYPES[dtype], eps,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        check((s, y), residual_norm_reference(x, w, bias, eps, b, gamma),
              fault)
