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
import os

import numpy as np
import pytest
import torch

from snuffy_tpu_torch.ops import dense_attention as da
from snuffy_tpu_torch.ops.kernels import DENSE

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
    (3, 130, 129, 100),    # dk not a multiple of 4
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
