"""Port's sparse attention and dropout hash vs the JAX package.

The plain PyTorch attention (the CUDA kernel's oracle) is held against the
JAX einsum oracle and against the JAX fused kernel (Pallas, interpret mode
on the CPU), dropout included; the hash is held bit for bit.
"""

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
    inverted_sparse_attention,
    keep_factor,
    packed_inverted_sparse_attention,
)

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
