"""The sparse-attention wrapper and its CUDA kernels, forward and backward.

On the CPU the wrapper, gradient included, must run the plain versions
and launch nothing. The tests marked `cuda` hold each kernel against its
plain version on the card at ragged shapes; they skip without a GPU,
import no JAX and run on the card with

    python -m pytest --noconftest -m cuda -o "markers=cuda: needs a CUDA GPU" \
        tests/test_torch_fused_attention.py
"""

import numpy as np
import pytest
import torch

from snuffy_tpu_torch.ops import fused_attention as fa
from snuffy_tpu_torch.ops import kernels
from snuffy_tpu_torch.ops.sparse_attention import (
    packed_inverted_sparse_attention,
    packed_inverted_sparse_attention_bwd,
)


def make(h=2, n=100, s=24, dk=16, segments=1, dtype=torch.float32, seed=0,
         device="cpu"):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((h, segments * n, dk), generator=g)
    k = torch.randn((h, segments * s, dk), generator=g)
    v = torch.randn((h, segments * n, dk), generator=g)
    sv = torch.rand(segments * s, generator=g) > 0.3
    qv = torch.rand(segments * n, generator=g) > 0.2
    return [t.to(device=device, dtype=dtype) for t in (q, k, v)] + [
        sv.to(device), qv.to(device)]


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    args = make(segments=2)
    kernels.reset_launches()
    got = fa.fused_packed_inverted_sparse_attention(
        *args, 2, dropout_rate=0.1, dropout_seed=5)
    want = packed_inverted_sparse_attention(*args, 2, dropout_rate=0.1,
                                            dropout_seed=5)
    assert torch.equal(got, want)
    one = fa.fused_inverted_sparse_attention(*make())
    assert one.shape == (2, 24, 16)
    assert fa.FWD.launches == fa.BWD.launches == 0


def test_cpu_gradients_are_the_plain_backward_and_launch_nothing():
    q, k, v, sv, qv = make(segments=2)
    g = torch.randn((2, 48, 16), generator=torch.Generator().manual_seed(9))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kernels.reset_launches()
    out = fa.fused_packed_inverted_sparse_attention(
        *leaves, sv, qv, 2, dropout_rate=0.1, dropout_seed=5)
    out.backward(g)
    want = packed_inverted_sparse_attention_bwd(
        q, k, v, sv, qv, g, 2, dropout_rate=0.1, dropout_seed=5)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    assert fa.FWD.launches == fa.BWD.launches == 0


@pytest.mark.parametrize("bad, err", [
    (dict(dtype=torch.float16), TypeError),
    (dict(mask_dtype=torch.float32), TypeError),
    (dict(transpose=True), ValueError),
    (dict(segments=7), ValueError),
    (dict(dk=300), ValueError),
])
def test_cuda_argument_checks(bad, err):
    """The checks run before any launch, so they are testable on CPU
    tensors."""
    q, k, v, sv, qv = make(dk=bad.get("dk", 16),
                           dtype=bad.get("dtype", torch.float32))
    if "mask_dtype" in bad:
        sv = sv.to(bad["mask_dtype"])
    if bad.get("transpose"):
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(err):
        fa._check_cuda_args(q, k, v, sv, qv, bad.get("segments", 1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


# f32: the same f32 sums in other orders. bf16: one ulp of the output.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    dict(h=2, n=100, s=24, dk=16),               # ragged N, S; small dk
    dict(h=4, n=300, s=512, dk=96, segments=3),  # packed, operating widths
    dict(h=1, n=65, s=65, dk=100),               # one past every tile edge
    dict(h=2, n=64, s=130, dk=256),              # the largest dk
    dict(h=3, n=1, s=1, dk=1),
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernel_matches_plain_on_the_card(cuda_device, dtype, shape, rate):
    segments = shape.get("segments", 1)
    args = make(dtype=dtype, device=cuda_device, **shape)
    kw = dict(dropout_rate=rate, dropout_seed=-77)
    with torch.inference_mode():
        before = fa.FWD.launches
        got = fa.fused_packed_inverted_sparse_attention(*args, segments, **kw)
        assert fa.FWD.launches == before + 1
        want = packed_inverted_sparse_attention(*args, segments, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype] * max(1.0, float(want.float().abs().max()))


@pytest.mark.cuda
def test_kernel_all_dead_segments_stay_finite(cuda_device):
    q, k, v, sv, qv = make(h=2, n=70, s=20, dk=32, segments=3,
                           device=cuda_device)
    sv[20:60] = False      # segments 1 and 2: no live slot
    qv[140:] = False       # segment 2: no live row either
    with torch.inference_mode():
        got = fa.fused_packed_inverted_sparse_attention(q, k, v, sv, qv, 3)
        want = packed_inverted_sparse_attention(q, k, v, sv, qv, 3)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.count_nonzero(got[:, 40:60]) == 0


def grads_on_the_card(args, segments, g, **kw):
    """(out, (dq, dk, dv)) through the autograd Function: one forward and
    one backward launch."""
    leaves = [t.clone().requires_grad_(True) for t in args[:3]]
    fwd, bwd = fa.FWD.launches, fa.BWD.launches
    out = fa.fused_packed_inverted_sparse_attention(*leaves, *args[3:],
                                                    segments, **kw)
    out.backward(g)
    torch.cuda.synchronize()
    assert (fa.FWD.launches, fa.BWD.launches) == (fwd + 1, bwd + 1)
    return out, [t.grad for t in leaves]


def assert_close_to_plain(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * max(1.0, float(want.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    dict(h=2, n=100, s=24, dk=16),               # ragged N, S; small dk
    dict(h=4, n=300, s=512, dk=96, segments=3),  # packed, operating widths
    dict(h=1, n=65, s=65, dk=100),               # one past every tile edge
    dict(h=2, n=64, s=130, dk=256),              # the largest dk
    dict(h=3, n=1, s=1, dk=1),
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_kernel_matches_plain_on_the_card(cuda_device, dtype, shape,
                                                   rate):
    segments = shape.get("segments", 1)
    args = make(dtype=dtype, device=cuda_device, **shape)
    g = torch.randn(args[1].shape, generator=torch.Generator().manual_seed(4)
                    ).to(cuda_device, dtype)
    kw = dict(dropout_rate=rate, dropout_seed=-77)
    _, got = grads_on_the_card(args, segments, g, **kw)
    want = packed_inverted_sparse_attention_bwd(*args, g, segments, **kw)
    for a, b in zip(got, want):
        assert_close_to_plain(a, b, TOL[dtype])


@pytest.mark.cuda
def test_backward_kernel_all_dead_segments(cuda_device):
    """A segment with live rows and no live slot (σ uniform) gets no
    gradient into its dead slots, as in the plain version; a dummy bag
    gets none at all."""
    q, k, v, sv, qv = make(h=2, n=70, s=20, dk=32, segments=3,
                           device=cuda_device)
    sv[20:60] = False      # segments 1 and 2: no live slot
    qv[140:] = False       # segment 2: no live row either
    g = torch.randn((2, 60, 32), device=cuda_device)
    # the gradient arrives transposed, as it does from wo's matmul
    g_t = g.transpose(1, 2).contiguous().transpose(1, 2)
    _, (dq, dk, dv) = grads_on_the_card([q, k, v, sv, qv], 3, g_t)
    want = packed_inverted_sparse_attention_bwd(q, k, v, sv, qv, g, 3)
    for a, b in zip((dq, dk, dv), want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert torch.count_nonzero(dq[:, 70:]) == 0
    assert torch.count_nonzero(dk[:, 20:]) == 0
    assert torch.count_nonzero(dv[:, 140:]) == 0
    assert torch.count_nonzero(dv[:, 70:140]) > 0  # uniform σ still reads v
