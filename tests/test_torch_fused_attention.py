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
    dict(h=2, n=1, s=40, dk=96),                 # one row
    dict(h=1, n=1000, s=64, dk=96),              # 16 N splits, the last short
    dict(h=4, n=777, s=512, dk=32),              # 8 N splits, the last empty
    dict(h=4, n=1200, s=1000, dk=96),            # the multiclass CLI's S
    dict(h=2, n=300, s=500, dk=83, segments=2),  # musk1's head width
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
    # bf16 on the tensor cores: the smallest and largest dk, one past a tile
    dict(h=2, n=65, s=129, dk=8),
    dict(h=1, n=129, s=65, dk=128),
    dict(h=2, n=1, s=40, dk=96),                 # one row
    dict(h=1, n=1000, s=64, dk=96),              # 16 N splits, the last short
    dict(h=4, n=777, s=512, dk=32),              # 8 N splits, the last empty
    dict(h=4, n=1200, s=1000, dk=96),            # the multiclass CLI's S
    dict(h=2, n=300, s=500, dk=83, segments=2),  # musk1's head width
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_all_dead_segments(cuda_device, dtype):
    """A segment with live rows and no live slot (σ uniform) gets no
    gradient into its dead slots, as in the plain version; a dummy bag
    gets none at all. Both dtypes run their tensor-core bodies."""
    q, k, v, sv, qv = make(h=2, n=70, s=20, dk=32, segments=3, dtype=dtype,
                           device=cuda_device)
    sv[20:60] = False      # segments 1 and 2: no live slot
    qv[140:] = False       # segment 2: no live row either
    g = torch.randn((2, 60, 32), device=cuda_device).to(dtype)
    # the gradient arrives transposed, as it does from wo's matmul
    g_t = g.transpose(1, 2).contiguous().transpose(1, 2)
    _, (dq, dk, dv) = grads_on_the_card([q, k, v, sv, qv], 3, g_t)
    want = packed_inverted_sparse_attention_bwd(q, k, v, sv, qv, g, 3)
    for a, b in zip((dq, dk, dv), want):
        if dtype == torch.float32:
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=1e-5, atol=1e-5)
        else:
            assert_close_to_plain(a, b, TOL[dtype])
    assert torch.count_nonzero(dq[:, 70:]) == 0
    assert torch.count_nonzero(dk[:, 20:]) == 0
    assert torch.count_nonzero(dv[:, 140:]) == 0
    assert torch.count_nonzero(dv[:, 70:140]) > 0  # uniform σ still reads v


@pytest.mark.parametrize("dtype, dk, body", [
    (torch.float32, 96, 0), (torch.float32, 4, 0), (torch.float32, 128, 0),
    (torch.float32, 83, 2), (torch.float32, 132, 2), (torch.float32, 256, 2),
    (torch.bfloat16, 96, 1), (torch.bfloat16, 8, 1), (torch.bfloat16, 4, 2),
    (torch.bfloat16, 100, 2), (torch.bfloat16, 136, 2),
])
def test_kernel_body_follows_the_dispatch_rule(dtype, dk, body):
    """f32 with dk ≤ 128, dk % 4 == 0 takes the f32 tensor-core body, bf16
    with dk ≤ 128, dk % 8 == 0 the bf16 one, anything else the CUDA-core
    body; so does a base that is not 16-byte aligned."""
    q, k, v = make(dk=dk, dtype=dtype)[:3]
    assert fa.kernel_body(q, k, v) == fa.BODIES[body]
    shifted = torch.empty(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    assert fa.kernel_body(shifted, k, v) == fa.BODIES[2]


@pytest.mark.parametrize("symbol, want", [
    ("_ZN34_GLOBAL__N__4c2ba1_23_sparse_attention_fwd_cu_a20567a321row_stats"
     "_tf32_kernelILi64EEvPKfS2_", "row_stats_tf32_kernel[Li64]"),
    ("_ZN34_GLOBAL__N__e7a0506_23_sparse_attention_fwd_cu_a20567a322slot_"
     "accumulate_kernelI13__nv_bfloat16Li16EEvPKT_",
     "slot_accumulate_kernel[13__nv_bfloat16Li16]"),
    ("_ZN12_GLOBAL__N_122dense_attention_kernelIfEEvv",
     "dense_attention_kernel[f]"),
    ("not_mangled", "not_mangled"),
])
def test_chip_smoke_names_kernels_from_their_mangled_symbols(symbol, want):
    """chip_smoke prints ptxas's registers and spills under each kernel's
    name: the length-prefixed identifier of the symbol, digits and all."""
    import chip_smoke

    assert chip_smoke.kernel_symbol_name(symbol) == want


def test_chip_smoke_tells_the_body_from_the_traced_kernel_names():
    import chip_smoke

    for body, names in zip(fa.BODIES, (
            ["void row_stats_tf32_kernel<96>(float const*)",
             "void split_reduce_kernel<float>(float const*)"],
            ["void slot_accumulate_tc_kernel<96>(bf16 const*)"],
            ["void row_stats_kernel<float>(float const*)"])):
        times = [(name, 1.0) for name in names]
        assert chip_smoke.traced_body(fa, fa.FWD, times) == body
        chip_smoke.check_body(fa, fa.FWD, times, body)
    with pytest.raises(AssertionError):
        chip_smoke.check_body(fa, fa.BWD, [("void row_grad_kernel<float>", 1.0)],
                              fa.BODIES[0])
    bound, by, note = chip_smoke.kernel_bound(fa, fa.BODIES[0], 10**6, 10**10)
    assert by == "operations" and "67 TFLOP/s" in note
    assert bound == pytest.approx(1e3 * 10**10 / (495e12 / 3))


def test_chip_smoke_reports_untraced_passes_where_the_profiler_sees_none(
        monkeypatch):
    """Where torch.profiler records no device time, chip_smoke tries once
    more, then reports the passes as not traced; any other profiler error
    still fails the run, and a trace that comes back is still checked."""
    import chip_smoke
    from snuffy_tpu_torch.utils import profiling

    tries = []

    def empty(fn):
        tries.append(fn)
        raise profiling.NoDeviceTime("the profiler recorded no device "
                                     "time; it cannot trace this GPU")

    monkeypatch.setattr(profiling, "device_profile", empty)
    assert chip_smoke.traced(len) is None and tries == [len, len]
    assert chip_smoke.traced_split(fa, fa.FWD, len, 1,
                                   fa.BODIES[0]) == "device not traced"

    def broken(fn):
        raise RuntimeError("CUPTI failed")

    monkeypatch.setattr(profiling, "device_profile", broken)
    with pytest.raises(RuntimeError, match="CUPTI"):
        chip_smoke.traced(len)

    passes = [("void row_stats_kernel<float>(float const*)", 0.5),
              ("void slot_accumulate_kernel<float, 16>(float const*)", 0.25),
              ("void split_reduce_kernel<float>(float const*)", 0.25)]
    monkeypatch.setattr(profiling, "device_profile",
                        lambda fn: (1.0, [], passes))
    assert chip_smoke.traced_split(
        fa, fa.FWD, len, 1, fa.BODIES[2]).startswith("device 1.0000: ")
    with pytest.raises(AssertionError, match="dispatch rule"):
        chip_smoke.traced_split(fa, fa.FWD, len, 1, fa.BODIES[0])


def test_forward_splits_fill_the_card_and_cover_n():
    """The kernels split N until their slot grid has 256 blocks (8 splits
    at one bag of the operating widths, 1 at 8 packed bags), never into
    more splits than N has 64-row tiles."""
    assert fa.slot_splits(10240, 512, 4) == 8
    assert fa.slot_splits(10240, 512, 4 * 8) == 1
    assert fa.slot_splits(1, 1, 3) == 1
    assert fa.slot_splits(130, 24, 1) == 3
    for n, s, hh in [(10240, 512, 4), (1000, 64, 2), (65, 130, 1)]:
        splits = fa.slot_splits(n, s, hh)
        assert 1 <= splits <= -(-n // 64)
        blocks = -(-s // 64) * hh
        assert splits == 1 or blocks * (splits - 1) < fa.SLOT_MIN_BLOCKS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_eight_segments_dummy_bag_dead_segment(cuda_device, dtype):
    """segments=8 at rate 0.1: segment 6 a dummy bag (no live row or
    slot), segment 7 live rows and no live slot (a uniform σ)."""
    n, s = 300, 64
    q, k, v, sv, qv = make(h=4, n=n, s=s, dk=96, segments=8, dtype=dtype,
                           device=cuda_device)
    qv[6 * n:7 * n] = False
    sv[6 * s:8 * s] = False
    kw = dict(dropout_rate=0.1, dropout_seed=-5)
    with torch.inference_mode():
        got = fa.fused_packed_inverted_sparse_attention(q, k, v, sv, qv, 8,
                                                        **kw)
        want = packed_inverted_sparse_attention(q, k, v, sv, qv, 8, **kw)
    torch.cuda.synchronize()
    assert_close_to_plain(got, want, TOL[dtype])
    assert torch.count_nonzero(got[:, 6 * s:7 * s]) == 0
    assert torch.count_nonzero(got[:, 7 * s:]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [1, 8])
def test_kernel_is_bitwise_repeatable(cuda_device, segments):
    """The splits are summed in a fixed order, without atomics: two
    launches on the same inputs give the same bits."""
    args = make(h=4, n=2000, s=512 // segments, dk=96, segments=segments,
                dtype=torch.bfloat16, device=cuda_device)
    kw = dict(dropout_rate=0.1, dropout_seed=3)
    with torch.inference_mode():
        a = fa.fused_packed_inverted_sparse_attention(*args, segments, **kw)
        b = fa.fused_packed_inverted_sparse_attention(*args, segments, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def max_ulps(got, want):
    """The largest difference of two bf16 tensors in ulps of the larger
    magnitude; values below 2^-8 of max |want|, where the f32 sums cancel
    and f32 noise is more than their own ulp, count in the ulp of 2^-8 max
    |want|. → (ulps, flat index of the worst element)."""
    got, want = got.float(), want.float()
    floor = 2.0 ** -8 * float(want.abs().max())
    big = torch.maximum(got.abs(), want.abs()).clamp_min(floor)
    ulps = (got - want).abs() / torch.exp2(torch.floor(torch.log2(big)) - 7)
    return float(ulps.max()), int(ulps.argmax())


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [1, 8])
def test_backward_kernel_is_bitwise_repeatable(cuda_device, segments):
    """The backward's N splits are summed in a fixed order, without
    atomics: two launches on the same inputs give the same bits."""
    q, k, v, sv, qv = make(h=4, n=2000, s=512 // segments, dk=96,
                           segments=segments, dtype=torch.bfloat16,
                           device=cuda_device)
    g = torch.randn(k.shape, generator=torch.Generator().manual_seed(6)
                    ).to(cuda_device, torch.bfloat16)
    with torch.inference_mode():
        _, row_max, row_scale = fa._fwd_cuda(q, k, v, sv, qv, segments, 0.1, 3)
        a = fa._bwd_cuda(q, k, v, sv, row_max, row_scale, g, segments, 0.1, 3)
        b = fa._bwd_cuda(q, k, v, sv, row_max, row_scale, g, segments, 0.1, 3)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [1, 8])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_backward_is_one_ulp_from_plain_at_operating_widths(
        cuda_device, segments, rate):
    """The backward's bf16 body feeds p̃ and ds to their products as hi +
    lo, so its f32 sums stay within f32 noise of the plain version's:
    after both round to bf16, no element of dq, dk or dv is more than one
    ulp from the plain one (h=4, N=10240, S=512, dk=96; the floor as in
    `max_ulps`)."""
    q, k, v, sv, qv = make(h=4, n=10240, s=512, dk=96, segments=segments,
                           dtype=torch.bfloat16, seed=3, device=cuda_device)
    g = torch.randn(k.shape, generator=torch.Generator().manual_seed(5)
                    ).to(cuda_device, torch.bfloat16)
    kw = dict(dropout_rate=rate, dropout_seed=9)
    _, got = grads_on_the_card([q, k, v, sv, qv], segments, g, **kw)
    want = packed_inverted_sparse_attention_bwd(q, k, v, sv, qv, g, segments,
                                                **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        ulps, worst = max_ulps(a, b)
        assert ulps <= 1.0, (
            f"{name}: {ulps} ulps at {worst}: kernel "
            f"{float(a.flatten()[worst])}, plain {float(b.flatten()[worst])}")


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [1, 8])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("seed", [1, 2])
def test_bf16_kernel_is_one_ulp_from_plain_at_operating_widths(
        cuda_device, segments, rate, seed):
    """The bf16 body feeds p to σᵀv as hi + lo, so its f32 sums stay within
    f32 noise of the plain version's: after both round to bf16, no output
    is more than one ulp from the plain one (h=4, N=10240, S=512, dk=96).
    Outputs below 2^-8 of max |out|, where the sums cancel and f32 noise
    is more than their own ulp, are held to the ulp of 2^-8 max |out|."""
    args = make(h=4, n=10240, s=512, dk=96, segments=segments,
                dtype=torch.bfloat16, seed=seed, device=cuda_device)
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    with torch.inference_mode():
        got = fa.fused_packed_inverted_sparse_attention(*args, segments, **kw)
        want = packed_inverted_sparse_attention(*args, segments, **kw)
    torch.cuda.synchronize()
    ulps, worst = max_ulps(got, want)
    assert ulps <= 1.0, (
        f"{ulps} ulps at {worst}: kernel {float(got.flatten()[worst])}, "
        f"plain {float(want.flatten()[worst])}")


@pytest.mark.cuda
@pytest.mark.parametrize("dk", [64, 96])
@pytest.mark.parametrize("segments", [1, 3])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_tensor_core_body_matches_plain_on_the_card(cuda_device, dk,
                                                        segments, rate):
    """The f32 tensor-core body (3xTF32), forward and backward, within the
    f32 tolerance of the plain versions. Rows 64-127 of each bag are
    invalid, a whole 64-row tile the body skips; with 3 segments, segment
    1 is a dummy bag (no valid row or slot): its outputs and gradients are
    exactly 0."""
    n, s = 300, 100
    q, k, v, sv, qv = make(h=2, n=n, s=s, dk=dk, segments=segments,
                           device=cuda_device)
    assert fa.kernel_body(q, k, v) == fa.BODIES[0]
    for b in range(segments):
        qv[b * n + 64:b * n + 128] = False
    if segments == 3:
        qv[n:2 * n] = False
        sv[s:2 * s] = False
    g = torch.randn(k.shape, generator=torch.Generator().manual_seed(7)
                    ).to(cuda_device)
    kw = dict(dropout_rate=rate, dropout_seed=11)
    out, got = grads_on_the_card([q, k, v, sv, qv], segments, g, **kw)
    with torch.inference_mode():
        want_out = packed_inverted_sparse_attention(q, k, v, sv, qv, segments,
                                                    **kw)
    want = packed_inverted_sparse_attention_bwd(q, k, v, sv, qv, g, segments,
                                                **kw)
    assert_close_to_plain(out.detach(), want_out, TOL[torch.float32])
    for a, b in zip(got, want):
        assert_close_to_plain(a, b, TOL[torch.float32])
    dq, dk_, dv = got
    for b in range(segments):
        assert torch.count_nonzero(dq[:, b * n + 64:b * n + 128]) == 0
        assert torch.count_nonzero(dv[:, b * n + 64:b * n + 128]) == 0
    if segments == 3:
        assert torch.count_nonzero(out[:, s:2 * s]) == 0
        assert torch.count_nonzero(dk_[:, s:2 * s]) == 0
        assert torch.count_nonzero(dq[:, n:2 * n]) == 0
        assert torch.count_nonzero(dv[:, n:2 * n]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [1, 4])
def test_f32_tensor_core_body_is_bitwise_repeatable(cuda_device, segments):
    """The f32 body's N splits, forward and backward, are summed in a
    fixed order, without atomics: two launches give the same bits."""
    q, k, v, sv, qv = make(h=4, n=2000, s=500, dk=96, segments=segments,
                           device=cuda_device)
    g = torch.randn(k.shape, generator=torch.Generator().manual_seed(8)
                    ).to(cuda_device)
    with torch.inference_mode():
        a = fa._fwd_cuda(q, k, v, sv, qv, segments, 0.1, 3)
        b = fa._fwd_cuda(q, k, v, sv, qv, segments, 0.1, 3)
        da = fa._bwd_cuda(q, k, v, sv, a[1], a[2], g, segments, 0.1, 3)
        db = fa._bwd_cuda(q, k, v, sv, a[1], a[2], g, segments, 0.1, 3)
    torch.cuda.synchronize()
    for x, y in zip((*a, *da), (*b, *db)):
        assert torch.equal(x, y)
