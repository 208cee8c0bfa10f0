"""Port's sparse attention, its backward and the dropout hash vs the JAX
package.

The plain PyTorch attention and its backward (the CUDA kernels' oracles)
are held against the JAX einsum oracle and against the JAX fused kernel
and its custom VJP (Pallas, interpret mode on the CPU), dropout included;
the hash is held bit for bit.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snuffy_tpu.ops.pallas_attention import (
    _keep_factor,
    fused_inverted_sparse_attention as jax_fused,
    fused_packed_inverted_sparse_attention as jax_fused_packed,
)
from snuffy_tpu.ops.sparse_attention import (
    inverted_sparse_attention as jax_plain,
    packed_inverted_sparse_attention as jax_plain_packed,
)
from snuffy_tpu_torch.ops.sparse_attention import (
    _softmax_and_factor,
    inverted_sparse_attention,
    keep_factor,
    packed_inverted_sparse_attention,
    packed_inverted_sparse_attention_bwd,
)
from mma_emulation import (
    bf16x3_product,
    split_tf32,
    tf32,
    tf32x1_product,
    tf32x3_product,
    whole_product,
)
from tests.test_torch_fused_attention import max_ulps

# f32 on both sides; the sums run in other orders.
RTOL, ATOL = 1e-5, 1e-6


def make_inputs(h=2, n=100, s=24, dk=16, segments=1, seed=0,
                slot_p=0.3, row_p=0.2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((h, segments * n, dk)).astype(np.float32)
    k = rng.standard_normal((h, segments * s, dk)).astype(np.float32)
    v = rng.standard_normal((h, segments * n, dk)).astype(np.float32)
    slot_valid = rng.random(segments * s) > slot_p
    q_valid = rng.random(segments * n) > row_p
    return q, k, v, slot_valid, q_valid


def to_torch(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def to_jax(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("shape", [
    dict(h=2, n=100, s=24, dk=16),
    dict(h=4, n=130, s=64, dk=96, slot_p=0.5),
    dict(h=1, n=7, s=3, dk=5, row_p=0.0),
])
def test_plain_matches_jax_oracle(shape):
    arrs = make_inputs(**shape)
    want, _ = jax_plain(*to_jax(arrs))
    got = inverted_sparse_attention(*to_torch(arrs))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_packed_plain_matches_jax_oracle():
    arrs = make_inputs(h=2, n=50, s=12, dk=8, segments=3, seed=1)
    want = jax_plain_packed(*to_jax(arrs), 3)
    got = packed_inverted_sparse_attention(*to_torch(arrs), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_packed_equals_per_bag_calls():
    q, k, v, sv, qv = to_torch(make_inputs(h=2, n=40, s=10, dk=8,
                                           segments=3, seed=2))
    got = packed_inverted_sparse_attention(q, k, v, sv, qv, 3)
    for b in range(3):
        rows, slots = slice(40 * b, 40 * (b + 1)), slice(10 * b, 10 * (b + 1))
        one = inverted_sparse_attention(q[:, rows], k[:, slots], v[:, rows],
                                        sv[slots], qv[rows])
        np.testing.assert_allclose(got[:, slots].numpy(), one.numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_dead_rows_slots_and_all_invalid_segment_stay_finite():
    q, k, v, sv, qv = make_inputs(h=2, n=30, s=8, dk=8, segments=3, seed=3)
    sv[8:16] = False          # segment 1: every slot dead, rows live
    sv[16:24] = False         # segment 2: a dummy bag, nothing live
    qv[60:90] = False
    want = jax_plain_packed(*to_jax((q, k, v, sv, qv)), 3)
    got = packed_inverted_sparse_attention(*to_torch((q, k, v, sv, qv)), 3)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert torch.count_nonzero(got[:, 16:24]) == 0   # dead rows add nothing
    # all-dead slots softmax to a uniform row: every slot of segment 1
    # gets the mean of its live rows' values
    rows = torch.from_numpy(qv[30:60])
    mean = torch.from_numpy(v[:, 30:60])[:, rows].sum(1) / 8
    np.testing.assert_allclose(got[:, 8].numpy(), mean.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("seed", [0, 7, -5, 2**31 - 1, -2**31])
def test_keep_factor_bit_exact(seed):
    tile_n, s = 64, 48
    for hh in (0, 3, 17, 4097):
        for i in (0, 2, 31):
            want = np.asarray(_keep_factor(jnp.int32(seed), jnp.int32(hh),
                                           jnp.int32(i), tile_n, s, 0.1))
            got = keep_factor(seed, hh, i * tile_n + torch.arange(tile_n)[:, None],
                              torch.arange(s), 0.1).numpy()
            assert got.dtype == want.dtype == np.float32
            assert np.array_equal(got, want), (seed, hh, i)


def test_keep_factor_rate_and_scale():
    f = keep_factor(11, torch.arange(4)[:, None, None],
                    torch.arange(256)[:, None], torch.arange(64), 0.25)
    assert set(torch.unique(f).tolist()) == {0.0, np.float32(1 / 0.75)}
    assert abs(float((f == 0).float().mean()) - 0.25) < 0.01


@pytest.mark.parametrize("seed", [3, -9])
def test_plain_dropout_matches_jax_fused(seed):
    arrs = make_inputs(h=2, n=100, s=24, dk=16, seed=4)
    want = jax_fused(*to_jax(arrs), dropout_rate=0.1,
                     dropout_seed=jnp.int32(seed), tile_n=128)
    got = inverted_sparse_attention(*to_torch(arrs), dropout_rate=0.1,
                                    dropout_seed=seed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    no_drop = inverted_sparse_attention(*to_torch(arrs))
    assert not torch.allclose(got, no_drop)


def test_packed_plain_dropout_matches_jax_fused():
    arrs = make_inputs(h=2, n=40, s=12, dk=8, segments=3, seed=5)
    want = jax_fused_packed(*to_jax(arrs), 3, dropout_rate=0.1,
                            dropout_seed=jnp.int32(21), tile_n=128)
    got = packed_inverted_sparse_attention(*to_torch(arrs), 3,
                                           dropout_rate=0.1, dropout_seed=21)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_plain_matches_jax_fused_kernel_bf16():
    """bf16 in: products exact in f32 on both sides, output rounded to bf16
    (tolerance: one bf16 ulp, 2^-7 relative)."""
    arrs = make_inputs(h=2, n=64, s=16, dk=16, seed=6)
    want = jax_fused(*[jnp.asarray(a, jnp.bfloat16) for a in arrs[:3]],
                     *to_jax(arrs[3:]), tile_n=128)
    q, k, v, sv, qv = to_torch(arrs)
    got = inverted_sparse_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                    sv, qv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2.0 ** -7, atol=1e-6)


def bwd_inputs(segments, seed=8):
    """h=2, N=70, S=12, dk=24; with segments > 1 the last segment is a
    dummy bag (no live row)."""
    q, k, v, sv, qv = make_inputs(h=2, n=70, s=12, dk=24, segments=segments,
                                  seed=seed)
    if segments > 1:
        qv[-70:] = False
    g = np.random.default_rng(seed + 1).standard_normal(
        (2, segments * 12, 24)).astype(np.float32)
    return (q, k, v, sv, qv), g


def jax_vjp(fn, arrs, g, segments, rate, seed):
    """(dq, dk, dv) of the JAX fused op or of its einsum oracle."""
    q, k, v, sv, qv = to_jax(arrs)
    if fn is jax_plain_packed:
        op = functools.partial(fn, slot_valid=sv, q_valid=qv,
                               segments=segments, dropout_rate=rate)
    elif segments == 1:  # the one-bag entry takes the (1, S) mask blocks
        op = functools.partial(jax_fused, slot_valid=sv, q_valid=qv,
                               dropout_rate=rate,
                               dropout_seed=jnp.int32(seed), tile_n=128)
    else:
        op = functools.partial(fn, slot_valid=sv, q_valid=qv,
                               segments=segments, dropout_rate=rate,
                               dropout_seed=jnp.int32(seed), tile_n=128)
    _, pull = jax.vjp(op, q, k, v)
    return [np.asarray(x) for x in pull(jnp.asarray(g))]


@pytest.mark.parametrize("segments", [1, 3])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_backward_matches_jax_fused_vjp(segments, rate):
    """K2's oracle against jax.vjp of the JAX fused op (its custom VJP is
    the TPU backward kernel); f32, the same hash masks."""
    arrs, g = bwd_inputs(segments)
    want = jax_vjp(jax_fused_packed, arrs, g, segments, rate, 13)
    got = packed_inverted_sparse_attention_bwd(
        *to_torch(arrs), torch.from_numpy(g), segments, dropout_rate=rate,
        dropout_seed=13)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=ATOL)
    if segments > 1:  # the dummy bag gets no gradient
        assert not got[0][:, -70:].any() and not got[2][:, -70:].any()


@pytest.mark.parametrize("segments", [1, 3])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_backward_matches_autograd_of_plain_forward(segments, rate):
    arrs, g = bwd_inputs(segments, seed=9)
    q, k, v, sv, qv = to_torch(arrs)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    packed_inverted_sparse_attention(
        *leaves, sv, qv, segments, dropout_rate=rate, dropout_seed=-4
    ).backward(torch.from_numpy(g))
    got = packed_inverted_sparse_attention_bwd(
        q, k, v, sv, qv, torch.from_numpy(g), segments, dropout_rate=rate,
        dropout_seed=-4)
    for a, leaf in zip(got, leaves):
        np.testing.assert_allclose(a.numpy(), leaf.grad.numpy(), rtol=1e-5,
                                   atol=ATOL)


def test_plain_backward_bf16_returns_the_input_type():
    arrs, g = bwd_inputs(3)
    q, k, v, sv, qv = to_torch(arrs)
    lo = [t.bfloat16() for t in (q, k, v)]
    got = packed_inverted_sparse_attention_bwd(
        *lo, sv, qv, torch.from_numpy(g).bfloat16(), 3)
    want = packed_inverted_sparse_attention_bwd(
        *[t.float() for t in lo], sv, qv, torch.from_numpy(g).bfloat16().float(), 3)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.bfloat16())  # f32 arithmetic, one rounding


def test_dead_slot_segment_backward_follows_the_oracle_not_the_tpu_kernel():
    """Live rows and no live slot: σ is uniform. The TPU backward kernel
    leaves ds unmasked and sends gradient into the dead slots (dq ≠ 0, dk
    of dead slots ≠ 0), although their scores are the constant −1e30; the
    JAX einsum oracle, and the port, send none."""
    arrs, g = bwd_inputs(3, seed=10)
    q, k, v, sv, qv = arrs
    sv[12:24] = False          # segment 1: every slot dead
    qv[70:140] = True          # ... and every row live
    oracle = jax_vjp(jax_plain_packed, arrs, g, 3, 0.0, 0)
    tpu = jax_vjp(jax_fused_packed, arrs, g, 3, 0.0, 0)
    got = packed_inverted_sparse_attention_bwd(
        *to_torch(arrs), torch.from_numpy(g), 3)
    for a, b in zip(got, oracle):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=ATOL)
    rows, slots = slice(70, 140), slice(12, 24)
    assert not got[0][:, rows].any() and not got[1][:, slots].any()
    assert np.abs(tpu[0][:, rows]).max() > 1e-3
    assert np.abs(tpu[1][:, slots]).max() > 1e-3
    # in the other segments the TPU kernel agrees
    for a, b, live in zip(got, tpu, ([0, 2], [0, 2], [0, 2])):
        seg = a.shape[1] // 3
        for i in live:
            part = slice(i * seg, (i + 1) * seg)
            np.testing.assert_allclose(a[:, part].numpy(), b[:, part],
                                       rtol=1e-5, atol=ATOL)


def operating_inputs(segments, seed):
    """Seeded bf16 inputs at the operating widths: h=4, N=10240 rows a bag
    (10000 valid), S=512 slots (~10 % dead), dk=96."""
    h, n, s, dk = 4, 10240, 512, 96
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((h, segments * m, dk))
                                .astype(np.float32)).bfloat16()
               for m in (n, s, n))
    slot_valid = torch.from_numpy(rng.random(segments * s) > 0.1)
    q_valid = (torch.arange(n) < 10000).repeat(segments)
    return q, k, v, slot_valid, q_valid


def segment_sigma_factor(q, k, slot_valid, q_valid, segments, seg, rate,
                         seed):
    """σ and the factor q_valid · keep/(1 − rate) of segment `seg`, f32,
    each (h, 1, N, S): the plain version's, with the hash of folded head
    head·segments + seg. → (rows, slots, σ, factor)."""
    h = q.shape[0]
    n, s = q.shape[1] // segments, k.shape[1] // segments
    rows = slice(seg * n, (seg + 1) * n)
    slots = slice(seg * s, (seg + 1) * s)
    sigma, factor = _softmax_and_factor(q[:, rows], k[:, slots],
                                        slot_valid[slots], q_valid[rows],
                                        1, 0.0, None)
    if rate > 0.0:
        hh = torch.arange(h) * segments + seg
        factor = factor * keep_factor(seed, hh[:, None, None, None],
                                      torch.arange(n)[:, None],
                                      torch.arange(s), rate)
    return rows, slots, sigma, factor


def split_bf16(x):
    """x as a bf16 product takes it in two parts: hi = bf16(x) plus lo =
    bf16(x − hi), as f32."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def once_bf16(x):
    return x.bfloat16().float()


def emulate_forward_kernel_bf16(q, k, v, slot_valid, q_valid, segments,
                                rate, seed=12345):
    """The forward kernel's bf16 tensor-core body, a segment at a time:
    p = σ · factor in f32 (the plain version's), then p as the kernel's
    product σᵀv takes it, hi = bf16(p) plus lo = bf16(p − hi), and as one
    bf16 rounding would. → (plain, kernel, one rounding), the f32 results
    before their cast, each (h, segments·S, dk)."""
    outs = ([], [], [])
    for seg in range(segments):
        rows, _, sigma, factor = segment_sigma_factor(
            q, k, slot_valid, q_valid, segments, seg, rate, seed)
        p = sigma * factor
        for out, pk in zip(outs, (p, split_bf16(p), once_bf16(p))):
            out.append(torch.einsum("hkns,hknd->hksd", pk,
                                    v[:, rows].float()[:, None])[:, 0])
    return tuple(torch.cat(out, dim=1) for out in outs)


def emulate_backward_kernel_bf16(q, k, v, slot_valid, q_valid, g, segments,
                                 rate, seed=12345):
    """The backward kernel's bf16 tensor-core body, a segment at a time.
    p̃ = σ · factor and ds are f32 (the plain version's formulas) and enter
    the products dv = p̃ g, dq = ds k and dk = dsᵀq
      kept whole: the plain version, step for step;
      as the kernel takes them, hi = bf16(x) plus lo = bf16(x − hi), with D
        = v · dv from those f32 sums, and the scale applied after the
        product;
      rounded once: as the kernel, but the operand of each output's
        product (p̃ for dv, ds for dq and dk) one bf16 rounding.
    → (plain, kernel, one rounding), each (dq, dk, dv) in f32 before the
    cast, shaped as q, k and v."""
    scale = 1.0 / math.sqrt(q.shape[2])
    outs = tuple(([], [], []) for _ in range(3))
    for seg in range(segments):
        rows, slots, sigma, factor = segment_sigma_factor(
            q, k, slot_valid, q_valid, segments, seg, rate, seed)
        qb, kb, vb, gb = (x.float()[:, None] for x in (
            q[:, rows], k[:, slots], v[:, rows], g[:, slots]))
        live = slot_valid[slots].float()[None, None, None, :]
        p = sigma * factor
        dsig = torch.einsum("hknd,hksd->hkns", vb, gb) * factor
        # the plain version
        ds = sigma * (dsig - (sigma * dsig).sum(dim=-1, keepdim=True))
        ds = ds * live * scale
        plain = (torch.einsum("hkns,hksd->hknd", ds, kb),
                 torch.einsum("hkns,hknd->hksd", ds, qb),
                 torch.einsum("hkns,hksd->hknd", p, gb))
        # the kernel: D from dv's f32 sums
        dv = torch.einsum("hkns,hksd->hknd", split_bf16(p), gb)
        ds = sigma * (dsig - (vb * dv).sum(dim=-1, keepdim=True)) * live
        kernel, once = ((torch.einsum("hkns,hksd->hknd", form(ds), kb) * scale,
                         torch.einsum("hkns,hknd->hksd", form(ds), qb) * scale)
                        for form in (split_bf16, once_bf16))
        kernel += (dv,)
        once += (torch.einsum("hkns,hksd->hknd", once_bf16(p), gb),)
        for out, grads in zip(outs, (plain, kernel, once)):
            for o, x in zip(out, grads):
                o.append(x[:, 0])
    return tuple(tuple(torch.cat(o, dim=1) for o in out) for out in outs)


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_p_of_the_forward_kernel_stays_within_tolerance(rate):
    """The forward kernel's tensor-core body feeds p = σ · factor to its
    bf16 product σᵀv as hi + lo, two bf16 parts; the plain version keeps p
    in f32. Emulated at the operating widths, one bag, the kernel stays
    within its bf16 tolerance of the plain version, 2^-7 of max |out|; the
    emulation with p kept whole is the plain version, bit for bit."""
    inputs = operating_inputs(1, 11)
    plain, kernel, _ = emulate_forward_kernel_bf16(*inputs, 1, rate)
    want = packed_inverted_sparse_attention(*inputs, 1, dropout_rate=rate,
                                            dropout_seed=12345)
    assert torch.equal(plain.bfloat16(), want)
    assert _rel(kernel.bfloat16().float(), want.float()) <= 2.0 ** -7


@pytest.mark.parametrize("segments, seed", [(1, 12), (1, 13), (8, 11)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_p_keeps_the_forward_kernel_off_two_ulp_flips(segments, rate,
                                                             seed):
    """Both sides round their f32 result to bf16 once: a one-ulp flip
    costs at most 2^-7 of max |out|, a two-ulp flip needs the f32 results
    to differ by 2^-8 of it. p rounded once to bf16 moves them by ~2^-9
    (1.6e-3-2.0e-3 of max |out| at these widths, up to 7.2e-3 after the
    rounding at 8 segments, seed 11); hi + lo keeps them (2.2e-6-2.8e-6)
    256x inside 2^-8, at one bag and at 8 segments, with and without
    dropout."""
    plain, kernel, once = emulate_forward_kernel_bf16(
        *operating_inputs(segments, seed), segments, rate)
    assert _rel(kernel, plain) <= 2.0 ** -16
    assert _rel(once, plain) > 2.0 ** -10  # what the split avoids
    assert _rel(kernel.bfloat16().float(), plain.bfloat16().float()) <= (
        2.0 ** -7)


def operating_gradient(segments, seed):
    """A seeded bf16 output gradient g (h=4, segments·512, 96)."""
    rng = np.random.default_rng(seed + 1000)
    return torch.from_numpy(rng.standard_normal((4, segments * 512, 96))
                            .astype(np.float32)).bfloat16()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_emulation_kept_whole_is_the_plain_version(rate):
    """At the operating widths, one bag: the emulation with p̃ and ds kept
    whole is `packed_inverted_sparse_attention_bwd`, bit for bit after the
    cast."""
    inputs = operating_inputs(1, 11)
    g = operating_gradient(1, 11)
    plain, _, _ = emulate_backward_kernel_bf16(*inputs, g, 1, rate)
    want = packed_inverted_sparse_attention_bwd(
        *inputs, g, 1, dropout_rate=rate, dropout_seed=12345)
    for a, b in zip(plain, want):
        assert torch.equal(a.bfloat16(), b)


@pytest.mark.parametrize("segments, seed", [(1, 12), (1, 13), (8, 11)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_p_and_ds_keep_the_backward_kernel_off_two_ulp_flips(
        segments, rate, seed):
    """The backward kernel's tensor-core body feeds p̃ to dv = p̃ g and ds
    to dq = ds k and dk = dsᵀq as hi + lo. Emulated at the operating
    widths, hi + lo keeps each f32 result within 2^-16 of its largest
    value (2.4e-6-4.4e-6) and every element within one bf16 ulp of the
    plain one after the cast; p̃ or ds rounded once moves them by more
    than 2^-10 (1.5e-3-2.8e-3) and flips elements near 2^-8 of the
    largest by 25-73 ulps, so both keep the split."""
    inputs = operating_inputs(segments, seed)
    plain, kernel, once = emulate_backward_kernel_bf16(
        *inputs, operating_gradient(segments, seed), segments, rate)
    for name, p, kern, one in zip(("dq", "dk", "dv"), plain, kernel, once):
        assert _rel(kern, p) <= 2.0 ** -16, name
        assert max_ulps(kern.bfloat16(), p.bfloat16())[0] <= 1.0, name
        assert _rel(one, p) > 2.0 ** -10, name  # what the split avoids
        assert max_ulps(one.bfloat16(), p.bfloat16())[0] > 2.0, name


# ---- The f32 tensor-core bodies: 3xTF32 products, emulated. ----


def emulate_f32_kernel(q, k, v, slot_valid, q_valid, g, segments, rate,
                       product, kernel_delta, seed=12345):
    """The plain forward and backward, step for step, with every product
    (q·kᵀ, σᵀv; v·gᵀ, p̃ g, ds k, dsᵀq) formed by `product`. With
    `kernel_delta` the backward forms D = v · dv from dv's f32 sums and
    scales dq and dk after their products, as the kernels do; without it,
    D = rowsum(σ · dσ) and the scale goes into ds, as the plain version
    does. → (out, (dq, dk, dv)) in f32, before any cast; g None skips the
    backward."""
    h, kn, dk = q.shape
    n, s = kn // segments, k.shape[1] // segments
    scale = 1.0 / math.sqrt(dk)
    qb, vb = (x.reshape(h, segments, n, dk).float() for x in (q, v))
    kb = k.reshape(h, segments, s, dk).float()
    sv = slot_valid.reshape(segments, s)
    _, factor = _softmax_and_factor(q, k, slot_valid, q_valid, segments,
                                    rate, seed)
    scores = product("hknd,hksd->hkns", qb, kb) * scale
    scores = scores.masked_fill(~sv[None, :, None, :], -1e30)
    sigma = torch.softmax(scores, dim=-1)
    p = sigma * factor
    out = product("hkns,hknd->hksd", p, vb).reshape(h, segments * s, dk)
    if g is None:
        return out, None
    gb = g.reshape(h, segments, s, dk).float()
    live = sv.float()[None, :, None, :]
    dv = product("hkns,hksd->hknd", p, gb)
    dsig = product("hknd,hksd->hkns", vb, gb) * factor
    if kernel_delta:
        ds = sigma * (dsig - (vb * dv).sum(dim=-1, keepdim=True)) * live
        dq = product("hkns,hksd->hknd", ds, kb) * scale
        dkey = product("hkns,hknd->hksd", ds, qb) * scale
    else:
        ds = sigma * (dsig - (sigma * dsig).sum(dim=-1, keepdim=True))
        ds = ds * live * scale
        dq = product("hkns,hksd->hknd", ds, kb)
        dkey = product("hkns,hknd->hksd", ds, qb)
    return out, (dq.reshape(q.shape), dkey.reshape(k.shape),
                 dv.reshape(v.shape))


def cli_inputs(segments, s, seed, n=1024, n_valid=1000):
    """Seeded f32 inputs and output gradient at the training CLI's widths
    (h=4, dk=96, S slots a bag, ~10 % dead), with n rows a bag, n_valid of
    them valid (the CLI's bags have 10240, ~10000 valid: the sums here
    are 10x shorter)."""
    rng = np.random.default_rng(seed)
    h, dk = 4, 96
    q, k, v, g = (torch.from_numpy(rng.standard_normal((h, segments * m, dk))
                                   .astype(np.float32))
                  for m in (n, s, n, s))
    slot_valid = torch.from_numpy(rng.random(segments * s) > 0.1)
    q_valid = (torch.arange(n) < n_valid).repeat(segments)
    return (q, k, v, slot_valid, q_valid), g


@pytest.mark.parametrize("segments", [1, 4])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_emulation_kept_whole_is_the_plain_version(segments, rate):
    """With every operand kept whole (and the plain version's D and
    scale), the emulation of the f32 tensor-core bodies is
    `packed_inverted_sparse_attention` and its backward, bit for bit."""
    inputs, g = cli_inputs(segments, 500, 31)
    out, grads = emulate_f32_kernel(*inputs, g, segments, rate,
                                    whole_product, kernel_delta=False)
    kw = dict(dropout_rate=rate, dropout_seed=12345)
    assert torch.equal(out, packed_inverted_sparse_attention(
        *inputs, segments, **kw))
    want = packed_inverted_sparse_attention_bwd(*inputs, g, segments, **kw)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("segments, s", [(1, 500), (4, 500), (4, 1000)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_3xtf32_products_stay_within_the_f32_tolerance(segments, s,
                                                            rate):
    """The f32 tensor-core bodies form every product as 3xTF32, with D =
    v · dv from dv's f32 sums. Emulated at the training CLI's widths (h=4,
    dk=96; serial S=500, packed ×4 at S=500 and S=1000), with and without
    dropout, out, dq, dk and dv stay within 2^-17 of max |plain| (1.1e-6 to
    1.8e-6), 50x inside the kernels' f32 tolerance of 1e-4 and inside the
    1e-5 that the card's tests hold f32 to. One TF32 product (each operand
    rounded once) moves them by 4.6e-4-8.6e-4, past 1e-4; hi + lo bf16
    parts in three products (twice the tensor cores' rate) hold 1e-4
    (5.2e-6-1.6e-5) but not 1e-5."""
    inputs, g = cli_inputs(segments, s, 41)
    kw = dict(dropout_rate=rate, dropout_seed=12345)
    want = (packed_inverted_sparse_attention(*inputs, segments, **kw),
            *packed_inverted_sparse_attention_bwd(*inputs, g, segments, **kw))

    def errors(product):
        out, grads = emulate_f32_kernel(*inputs, g, segments, rate, product,
                                        kernel_delta=True)
        return [_rel(got, w) for got, w in zip((out, *grads), want)]

    assert max(errors(tf32x3_product)) <= 2.0 ** -17
    assert min(errors(tf32x1_product)) > 1e-4  # what the split avoids
    bf16 = errors(bf16x3_product)
    assert 1e-5 < max(bf16) <= 1e-4  # the cheaper split, not taken


def test_tf32_rounding_and_split():
    """tf32 keeps 11 significant bits, rounding to nearest with ties away
    from zero; big + small, as the tensor cores read them, is x within
    2^-21 |x|."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.14159265])
    assert tf32(x).tolist()[:5] == [1.0, 1.0 + 2.0 ** -10,
                                    1.0 + 2 * 2.0 ** -10,
                                    -(1.0 + 2.0 ** -10), 1.0]
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.standard_normal(10000).astype(np.float32))
    big, small = split_tf32(y)
    for part in (big, small):
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()
    assert float(((big + small - y).abs() / y.abs()).max()) <= 2.0 ** -21


def mma_m16n8k8(a_frag, b_frag):
    """m16n8k8's product from its fragments, lane by lane (g = lane / 4,
    t = lane % 4): a_frag (32, 4) at (g, t), (g + 8, t), (g, t + 4),
    (g + 8, t + 4); b_frag (32, 2) at (k = t, n = g), (t + 4, g). → the
    16 x 8 result."""
    a, b = np.zeros((16, 8), np.int64), np.zeros((8, 8), np.int64)
    for lane in range(32):
        gi, t = lane // 4, lane % 4
        for r, (row, col) in enumerate(((gi, t), (gi + 8, t), (gi, t + 4),
                                        (gi + 8, t + 4))):
            a[row, col] = a_frag[lane, r]
        b[t, gi], b[t + 4, gi] = b_frag[lane]
    return a @ b


@pytest.mark.parametrize("seed", [0, 1])
def test_c_fragment_relabelled_as_a_fragment_leaves_the_product(seed):
    """mma_c_rows_f32: a 16 x 8 tile c held as m16n8's C fragment (lane
    (g, t) has columns 2t, 2t + 1 of rows g, g + 8) enters the next product
    as the A fragment with columns 2t, 2t + 1 taken as k = t, t + 4, and x's
    rows 2t, 2t + 1 loaded as B's rows t, t + 4. Relabelling the summed
    index on both operands leaves c · x unchanged (integers: exact)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-50, 50, (16, 8))
    x = rng.integers(-50, 50, (8, 8))
    a_frag, b_frag = np.zeros((32, 4), np.int64), np.zeros((32, 2), np.int64)
    for lane in range(32):
        gi, t = lane // 4, lane % 4
        c_frag = (c[gi, 2 * t], c[gi, 2 * t + 1], c[gi + 8, 2 * t],
                  c[gi + 8, 2 * t + 1])
        a_frag[lane] = (c_frag[0], c_frag[2], c_frag[1], c_frag[3])
        b_frag[lane] = (x[2 * t, gi], x[2 * t + 1, gi])
    np.testing.assert_array_equal(mma_m16n8k8(a_frag, b_frag), c @ x)
    # without the relabelling of x's rows the product is another one
    plain_b = np.array([(x[lane % 4, lane // 4], x[lane % 4 + 4, lane // 4])
                        for lane in range(32)])
    assert not np.array_equal(mma_m16n8k8(a_frag, plain_b), c @ x)
