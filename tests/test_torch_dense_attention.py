"""The dense-attention wrapper, its plain version and its CUDA kernel.

On the CPU the plain version is held to the JAX package's function: its
einsum reference, its Pallas kernel and the four TPU probes of the same
function (Pallas in interpret mode), and its gradient to `jax.grad`. The
tests marked `cuda` hold the kernel to the plain version on the card; they
skip without a GPU, and run there (no JAX needed) with

    python -m pytest --noconftest -m cuda -o "markers=cuda: needs a CUDA GPU" \
        tests/test_torch_dense_attention.py
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from snuffy_tpu_torch.ops import dense_attention as da
from snuffy_tpu_torch.ops import kernels
from snuffy_tpu_torch.ops.kernels import BODIES, DENSE, kernel_body
from mma_emulation import (
    tf32x1_product,
    tf32x3_product,
    whole_product,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32: the same f32 sums in other orders. bf16: both sides round p and the
# output to bf16 from f32 values that differ in their last f32 bits, so an
# output may flip by one bf16 ulp: 2^-8 of the largest output.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": 2.0 ** -8}


def qkv(z, n, dk, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((z, n, dk)).astype(np.float32)
            for _ in range(3)]


def bf16_round(xs):
    """numpy f32 arrays rounded to bf16 values, as f32."""
    return [torch.from_numpy(x).bfloat16().float().numpy() for x in xs]


def assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= TOL["bfloat16"] * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_einsum_and_interpret_kernel(dtype):
    """(4, 300, 64), the last 20 keys masked: `tests/test_dense_attention.py`'s
    case, every query row compared."""
    import jax.numpy as jnp

    from snuffy_tpu.ops.experimental.dense_attention import (
        _einsum_reference,
        _kernel_call,
    )

    arrays = qkv(4, 300, 64)
    if dtype == "bfloat16":
        arrays = bf16_round(arrays)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    want_einsum = np.asarray(
        _einsum_reference(jq, jk, jv, 280, 64 ** -0.5).astype(jnp.float32))
    want_kernel = np.asarray(
        _kernel_call(jq, jk, jv, 280, interpret=True).astype(jnp.float32))
    got = da.fused_self_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays), 280)
    assert got.dtype == getattr(torch, dtype) and got.shape == (4, 300, 64)
    got = got.float().numpy()
    for want in (want_einsum, want_kernel):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **TOL["float32"])
        else:
            assert_bf16_close(got, want)


def test_gradient_matches_jax_grad():
    import jax
    import jax.numpy as jnp

    from snuffy_tpu.ops.experimental.dense_attention import (
        fused_self_attention as jax_fused,
    )

    arrays = qkv(3, 70, 32, seed=1)
    w = np.random.default_rng(2).standard_normal((3, 70, 32)).astype(
        np.float32)

    def jax_loss(q, k, v):
        return jnp.sum(jnp.tanh(jax_fused(q, k, v, 61)) * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = da.fused_self_attention(*leaves, 61)
    (torch.tanh(out) * torch.from_numpy(w)).sum().backward()
    for leaf, g in zip(leaves, want):
        # f32 sums in other orders through the softmax's gradient
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-5)


def load_probe(name):
    """A TPU probe under tools/ by path (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PROBES = {
    "P1": ("profile_vit_attention3", "fused_attention"),
    "P2": ("profile_vit_attention4", "fused"),
    "P3": ("profile_vit_attention5", "fused"),
    "P4": ("profile_vit8_attention2", "fused"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("probe", sorted(PROBES))
def test_tpu_probes_compute_the_plain_function(probe, dtype):
    """Each probe runs K5's function on inputs already padded to n=40 with
    33 valid keys (P4's scale is fixed at 64^-0.5, so dk=64), two z a grid
    step; the plain version on the same padded inputs and n_valid agrees
    on every row."""
    import jax.numpy as jnp

    module, fn_name = PROBES[probe]
    fn = getattr(load_probe(module), fn_name)
    arrays = qkv(4, 40, 64, seed=3)
    if dtype == "bfloat16":
        arrays = bf16_round(arrays)
    jdt = getattr(jnp, dtype)
    want = np.asarray(fn(*(jnp.asarray(a, jdt) for a in arrays), 33, bz=2)
                      .astype(jnp.float32))
    got = da.dense_attention_reference(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays), 33)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])
    else:
        assert_bf16_close(got.float().numpy(), want)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, k, v = (torch.from_numpy(a) for a in qkv(2, 65, 16))
    before = DENSE.launches
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = da.fused_self_attention(*leaves, 60)
    assert torch.equal(out, da.dense_attention_reference(q, k, v, 60))
    out.sum().backward()
    assert all(t.grad is not None for t in leaves)
    assert DENSE.launches == before


@pytest.mark.parametrize("bad, err", [
    (dict(n_valid=0), ValueError),        # the JAX kernel and einsum differ
    (dict(n_valid=66), ValueError),
    (dict(dk=300), ValueError),
    (dict(dtype=torch.float16), TypeError),
    (dict(transpose=True), ValueError),
    (dict(shape_k=(2, 64, 16)), ValueError),
    (dict(device="meta"), ValueError),
])
def test_argument_checks(bad, err):
    q, k, v = (torch.from_numpy(a) for a in qkv(2, 65, bad.get("dk", 16)))
    q, k, v = (t.to(bad.get("dtype", torch.float32)) for t in (q, k, v))
    if bad.get("transpose"):
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    if "shape_k" in bad:
        k = torch.zeros(bad["shape_k"])
    if "device" in bad:
        q, k, v = (t.to(bad["device"]) for t in (q, k, v))
    with pytest.raises(err):
        da.fused_self_attention(q, k, v, bad.get("n_valid", 65))


# ---- The f32 tensor-core body: one pass, 3xTF32 products, emulated. ----


def emulate_f32_body(q, k, v, n_valid, product, tile=32):
    """The f32 tensor-core body's arithmetic on (z, n, dk) f32 tensors:
    one pass over the keys in half tiles of 32, scores s·scale·log2 e
    (−1e30 from n_valid on), an online max m and sum l of 2^(x − m), the
    sums of p·v rescaled by 2^(m_old − m_new) and each half tile's p·v
    added as a part of its own, out = sums / l at the end; every product
    (q·kᵀ, p·v) by `product`."""
    z, n, dk = q.shape
    scale_log2 = torch.tensor(dk ** -0.5) * torch.tensor(1.4426950408889634)
    m = torch.full((z, n, 1), -math.inf)
    l = torch.zeros((z, n, 1))
    acc = torch.zeros((z, n, dk))
    for c0 in range(0, n, tile):
        kt, vt = k[:, c0:c0 + tile], v[:, c0:c0 + tile]
        s = product("znd,zkd->znk", q, kt)
        key = torch.arange(c0, c0 + kt.shape[1])
        x = torch.where(key < n_valid, s * scale_log2, torch.tensor(-1e30))
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + product("znk,zkd->znd", p, vt)
        m = m_new
    return acc / l


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


F32_BODY_CASES = [(12, 197, 197, 0), (6, 197, 150, 1), (4, 785, 785, 2),
                  (3, 785, 700, 3)]


@pytest.mark.parametrize("z, n, n_valid, seed", F32_BODY_CASES)
def test_f32_one_pass_kept_whole_is_the_plain_version(z, n, n_valid, seed):
    """With every operand kept whole, the one-pass online softmax (max and
    sums moved tile by tile, divided once at the end) computes
    `dense_attention_reference`'s function to f32 rounding: 3.5e-7-5.8e-7
    of max |plain| at dk=64, ViT-S/16's n=197 and ViT-S/8's n=785, ragged
    n_valid too. f32 rounds p nowhere, so the bf16 body's second sweep
    buys nothing here."""
    q, k, v = (torch.from_numpy(a) for a in qkv(z, n, 64, seed))
    got = emulate_f32_body(q, k, v, n_valid, whole_product)
    assert rel_err(got, da.dense_attention_reference(q, k, v, n_valid)) \
        <= 2.0 ** -20


@pytest.mark.parametrize("z, n, n_valid, seed", F32_BODY_CASES)
def test_f32_body_3xtf32_stays_within_the_f32_tolerance(z, n, n_valid, seed):
    """Every product as 3xTF32 (big·small + small·big + big·big) keeps the
    one-pass body within 2^-18 of max |plain| (5.0e-7-1.3e-6), inside the
    1e-5 that the card's tests and chip_smoke hold f32 to; one TF32
    product (each operand rounded once) moves it by 4.3e-4-9.0e-4, past
    it."""
    q, k, v = (torch.from_numpy(a) for a in qkv(z, n, 64, seed))
    want = da.dense_attention_reference(q, k, v, n_valid)
    assert rel_err(emulate_f32_body(q, k, v, n_valid, tf32x3_product),
                   want) <= 2.0 ** -18
    assert rel_err(emulate_f32_body(q, k, v, n_valid, tf32x1_product),
                   want) > 1e-5  # what 3xTF32 avoids


@pytest.mark.parametrize("dtype, dk, body", [
    (torch.float32, 64, 0), (torch.float32, 8, 0), (torch.float32, 60, 0),
    (torch.float32, 128, 0), (torch.float32, 98, 2), (torch.float32, 132, 2),
    (torch.bfloat16, 64, 1), (torch.bfloat16, 60, 2), (torch.bfloat16, 256, 2),
])
def test_dense_kernel_body_follows_the_dispatch_rule(dtype, dk, body):
    """`launch_dtype` in csrc/dense_attention.cu: f32 with dk ≤ 128 and
    dk % 4 == 0 takes the f32 tensor-core body, bf16 with dk ≤ 128 and
    dk % 8 == 0 the wgmma one, anything else, or an output or input not
    16-byte aligned, the CUDA-core body."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in qkv(2, 9, dk))
    out = torch.empty_like(q)
    assert kernel_body(q, k, v, out) == BODIES[body]
    shifted = torch.empty(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    assert kernel_body(q, k, v, shifted) == BODIES[2]


def test_chip_smoke_tells_the_dense_body_from_the_traced_kernel_names():
    """chip_smoke's phases 4 and 12d check K5's body by the names of the
    device kernels torch.profiler records, and reckon its bound by that
    body: the f32 one over 3xTF32's 165 TFLOP/s, 67 beside it."""
    import chip_smoke

    for body, name in zip(BODIES, (
            "void (anonymous namespace)::dense_attention_tf32_kernel<64>("
            "float const*)",
            "void (anonymous namespace)::dense_attention_wgmma_kernel<64>("
            "CUtensorMap_st)",
            "void (anonymous namespace)::dense_attention_kernel<float, 1>("
            "float const*)")):
        times = [(name, 1.0), ("void at::native::fill_kernel", 1.0)]
        assert chip_smoke.traced_body(kernels, DENSE, times) == body
        chip_smoke.check_body(kernels, DENSE, times, body)
    with pytest.raises(AssertionError):
        chip_smoke.check_body(kernels, DENSE, [(name, 1.0)], BODIES[0])
    from snuffy_tpu_torch.tools.profile_vit_attention import dense_work

    work = dense_work(768, 197, 197, 64, torch.float32)
    assert work == (4 * 768 * 197 * 64 * 4, 4 * 768 * 197 * 197 * 64)
    bound, by, note = chip_smoke.kernel_bound(kernels, BODIES[0], *work)
    assert "67 TFLOP/s" in note
    assert bound == pytest.approx(1e3 * max(work[0] / 3.35e12,
                                            work[1] / (495e12 / 3)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


# On the card both sides sum in f32 (TF32 is off for the plain bmm).
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("z, n, n_valid, dk", [
    (12, 197, 197, 64),    # ViT-S/16, 2 tiles
    (6, 785, 785, 64),     # ViT-S/8
    (4, 300, 280, 64),     # ragged n_valid
    (5, 65, 1, 32),        # one past a tile edge, one valid key
    (2, 100, 90, 1),
    (3, 130, 129, 100),    # bf16: dk not a multiple of 8
    (2, 64, 64, 256),      # the largest dk
    (3, 1, 1, 16),
])
def test_kernel_matches_plain_on_the_card(cuda_device, dtype, z, n, n_valid,
                                          dk):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(z * n + dk)
    q, k, v = (torch.randn((z, n, dk), generator=gen).to(cuda_device, dtype)
               for _ in range(3))
    with torch.inference_mode():
        before = DENSE.launches
        got = da.fused_self_attention(q, k, v, n_valid)
        assert DENSE.launches == before + 1
        want = da.dense_attention_reference(q, k, v, n_valid)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= CARD_TOL[dtype] * max(1.0, float(want.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dk", [32, 64, 96, 128])
@pytest.mark.parametrize("n, n_valid", [
    (1, 1), (16, 16), (65, 60), (197, 197), (256, 200), (257, 257),
    (785, 700),
])
def test_tensor_core_body_edges_on_the_card(cuda_device, n, n_valid, dk):
    """bf16 with dk <= 128 takes the wgmma body: a last key tile of 16,
    32, 48 or 64 keys, warpgroups with no row, K/V held whole (n <= 256)
    or streamed (n > 256), dk padded to 64 or 128 by the loads."""
    gen = torch.Generator().manual_seed(n + dk)
    z = 3
    q, k, v = (torch.randn((z, n, dk), generator=gen).to(cuda_device,
                                                          torch.bfloat16)
               for _ in range(3))
    with torch.inference_mode():
        before = DENSE.launches
        got = da.fused_self_attention(q, k, v, n_valid)
        assert DENSE.launches == before + 1
        want = da.dense_attention_reference(q, k, v, n_valid)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= CARD_TOL[torch.bfloat16] * max(
        1.0, float(want.float().abs().max()))


@pytest.mark.cuda
def test_gradient_on_the_card_is_the_plain_gradient(cuda_device):
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((4, 97, 48), generator=gen).to(cuda_device)
               for _ in range(3))
    g = torch.randn((4, 97, 48), generator=gen).to(cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = DENSE.launches
    da.fused_self_attention(*leaves, 90).backward(g)
    assert DENSE.launches == before + 1
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    da.dense_attention_reference(*ref, 90).backward(g)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def traced_dense_kernels(fn):
    """The names of the device kernels torch.profiler records in fn()."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if "dense_attention" in e.key]


@pytest.mark.cuda
@pytest.mark.parametrize("dk", [8, 32, 60, 64, 96, 128])
@pytest.mark.parametrize("n, n_valid", [
    (1, 1), (63, 63), (64, 64), (65, 65), (197, 197), (256, 256),
    (257, 257), (785, 785), (64, 1), (197, 1), (256, 200), (785, 700),
])
def test_f32_tensor_core_body_edges_on_the_card(cuda_device, n, n_valid, dk):
    """f32 with dk ≤ 128, dk % 4 == 0 takes the one-pass 3xTF32 body: one
    key, a last key tile of 1 to 64 keys (8-key columns past n skipped),
    a 128-row block with warps past n, one valid key, dk padded to 32, 64,
    96 or 128 (dk=60: whole 16-byte chunks, not 32-byte ones); two
    launches bitwise equal."""
    gen = torch.Generator().manual_seed(n + 7 * dk)
    z = 3
    q, k, v = (torch.randn((z, n, dk), generator=gen).to(cuda_device)
               for _ in range(3))
    with torch.inference_mode():
        before = DENSE.launches
        got = da.fused_self_attention(q, k, v, n_valid)
        again = da.fused_self_attention(q, k, v, n_valid)
        assert DENSE.launches == before + 2
        want = da.dense_attention_reference(q, k, v, n_valid)
    torch.cuda.synchronize()
    assert kernel_body(q, k, v, got) == BODIES[0]
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all() and torch.equal(got, again)
    err = float((got - want).abs().max())
    assert err <= CARD_TOL[torch.float32] * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case, body, name", [
    ("f32", 0, "_tf32_kernel"),
    ("f32 unaligned", 2, "dense_attention_kernel<float"),
    ("f32 dk=98", 2, "dense_attention_kernel<float"),
    ("bf16", 1, "_wgmma_kernel"),
])
def test_dense_dispatch_by_traced_kernel_names(cuda_device, case, body,
                                               name):
    """The body `kernel_body` names is the device kernel that runs: the
    f32 one-pass body's is dense_attention_tf32_kernel, and an unaligned
    base or dk % 4 != 0 (98) sends f32 to the CUDA-core body."""
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    dk = 98 if "dk=98" in case else 64
    gen = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn((6, 197, dk), generator=gen).to(cuda_device, dtype)
               for _ in range(3))
    if "unaligned" in case:
        q = torch.empty(q.numel() + 1, dtype=dtype,
                        device=cuda_device)[1:].view(q.shape).copy_(q)
    with torch.inference_mode():
        names = traced_dense_kernels(
            lambda: da.fused_self_attention(q, k, v, 197))
        got = da.fused_self_attention(q, k, v, 197)
        want = da.dense_attention_reference(q, k, v, 197)
    assert kernel_body(q, k, v, got) == BODIES[body]
    assert names and all(name in key for key in names), names
    err = float((got.float() - want.float()).abs().max())
    assert err <= CARD_TOL[dtype] * max(1.0, float(want.float().abs().max()))
