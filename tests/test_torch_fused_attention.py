"""The sparse-attention wrapper and its CUDA kernel.

On the CPU the wrapper must run the plain version and launch nothing. The
tests marked `cuda` hold the kernel against the plain version on the card
at ragged shapes; they skip without a GPU, import no JAX and run on the
card with

    python -m pytest --noconftest -m cuda -o "markers=cuda: needs a CUDA GPU" \
        tests/test_torch_fused_attention.py
"""

import numpy as np
import pytest
import torch

from snuffy_tpu_torch.ops import fused_attention as fa
from snuffy_tpu_torch.ops.sparse_attention import (
    packed_inverted_sparse_attention,
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
    fa.reset_launches()
    got = fa.fused_packed_inverted_sparse_attention(
        *args, 2, dropout_rate=0.1, dropout_seed=5)
    want = packed_inverted_sparse_attention(*args, 2, dropout_rate=0.1,
                                            dropout_seed=5)
    assert torch.equal(got, want)
    one = fa.fused_inverted_sparse_attention(*make())
    assert one.shape == (2, 24, 16)
    assert fa.launches == 0


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
        before = fa.launches
        got = fa.fused_packed_inverted_sparse_attention(*args, segments, **kw)
        assert fa.launches == before + 1
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


@pytest.mark.cuda
def test_kernel_refuses_gradients(cuda_device):
    q, k, v, sv, qv = make(device=cuda_device)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        fa.fused_inverted_sparse_attention(q, k, v, sv, qv)
