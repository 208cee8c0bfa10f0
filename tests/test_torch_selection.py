"""Port's Λ-selection vs the JAX package.

The top share must equal JAX's exactly, ties included. The random share
uses another generator than JAX, so it is checked by its structure:
validity, disjointness from the top share, counts and packed offsets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snuffy_tpu.ops import selection as jsel
from snuffy_tpu_torch.ops import selection as tsel


def test_top_share_matches_jax_with_ties():
    rng = np.random.default_rng(0)
    scores = np.round(rng.standard_normal(200), 1).astype(np.float32)  # ties
    # lax.top_k ranks +0.0 above -0.0, a stable torch sort calls them a
    # tie (as the reference's torch.sort does): keep signed zeros out.
    scores = scores + np.float32(0.0)
    valid = rng.random(200) > 0.2
    for k in (1, 16, 40, 160, 250):
        want = jsel.top_share_selection(jnp.asarray(scores),
                                        jnp.asarray(valid), k)
        got = tsel.top_share_selection(torch.from_numpy(scores),
                                       torch.from_numpy(valid), k)
        np.testing.assert_array_equal(got.slot_valid.numpy(),
                                      np.asarray(want.slot_valid))
        live = np.asarray(want.slot_valid)
        np.testing.assert_array_equal(got.indices.numpy()[live],
                                      np.asarray(want.indices)[live])
        assert got.indices.shape == (k,)


def test_all_equal_scores_take_lowest_indices():
    valid = torch.ones(50, dtype=torch.bool)
    valid[3] = False
    got = tsel.top_share_selection(torch.zeros(50), valid, 5)
    assert got.indices.tolist() == [0, 1, 2, 4, 5]


@pytest.mark.parametrize("n_valid", [100, 30, 10, 0])
def test_random_share_structure(n_valid):
    n, k_top, k_rand = 128, 16, 16
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    valid = torch.arange(n) < n_valid
    prep = tsel.binary_selection_prepare(logits, valid, k_top)
    jprep = jsel.binary_selection_prepare(jnp.asarray(logits.numpy()),
                                          jnp.asarray(valid.numpy()), k_top)
    np.testing.assert_array_equal(prep.remainder.numpy(),
                                  np.asarray(jprep.remainder))
    gen = torch.Generator().manual_seed(3)
    sel = tsel.binary_selection_draw(gen, prep, k_rand)
    assert sel.indices.shape == sel.slot_valid.shape == (k_top + k_rand,)
    top_live = sel.indices[:k_top][sel.slot_valid[:k_top]]
    rand_live = sel.indices[k_top:][sel.slot_valid[k_top:]]
    assert len(top_live) == min(k_top, n_valid)
    assert len(rand_live) == min(k_rand, max(n_valid - k_top, 0))
    assert valid[rand_live].all()
    assert not set(top_live.tolist()) & set(rand_live.tolist())
    assert len(set(rand_live.tolist())) == len(rand_live)


def test_random_share_is_uniform_over_the_remainder():
    n, k_rand = 40, 5
    valid = torch.arange(n) < 30
    prep = tsel.binary_selection_prepare(torch.arange(n).float(), valid, 10)
    gen = torch.Generator().manual_seed(0)
    counts = torch.zeros(n)
    trials = 2000
    for _ in range(trials):
        sel = tsel.binary_selection_draw(gen, prep, k_rand)
        counts[sel.indices[10:]] += 1
    pool = prep.remainder.nonzero().flatten()
    assert counts.sum() == trials * k_rand
    assert counts[~prep.remainder].sum() == 0
    expected = trials * k_rand / len(pool)          # 500 per remaining row
    assert (counts[pool] - expected).abs().max() < 0.2 * expected


def test_packed_selection_offsets_and_per_bag_top_share():
    k, n, k_top, k_rand = 3, 32, 4, 4
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((k, n)).astype(np.float32)
    valid = np.arange(n)[None, :] < np.array([[32], [9], [0]])
    prep = tsel.packed_selection_prepare(torch.from_numpy(logits),
                                         torch.from_numpy(valid), k_top)
    jprep = jsel.packed_selection_prepare(jnp.asarray(logits),
                                          jnp.asarray(valid), k_top)
    np.testing.assert_array_equal(prep.top.slot_valid.numpy(),
                                  np.asarray(jprep.top.slot_valid))
    np.testing.assert_array_equal(prep.remainder.numpy(),
                                  np.asarray(jprep.remainder))
    sel = tsel.packed_selection_draw(torch.Generator().manual_seed(1), prep,
                                     k_rand, n)
    jsel_ = jsel.packed_selection_draw(jax.random.PRNGKey(0), jprep, k_rand,
                                       n)
    s = k_top + k_rand
    assert sel.indices.shape == (k * s,)
    np.testing.assert_array_equal(sel.slot_valid.numpy(),
                                  np.asarray(jsel_.slot_valid))
    for b in range(k):
        idx = sel.indices[b * s:(b + 1) * s][sel.slot_valid[b * s:(b + 1) * s]]
        assert ((idx >= b * n) & (idx < (b + 1) * n)).all()
        assert valid[b][(idx - b * n).numpy()].all()
        top = sel.indices[b * s:b * s + k_top]
        jtop = np.asarray(jsel_.indices)[b * s:b * s + k_top]
        live = np.asarray(jsel_.slot_valid)[b * s:b * s + k_top]
        np.testing.assert_array_equal(top.numpy()[live], jtop[live])


# ------------------------------------------------------------- multiclass

def multiclass_inputs(n, n_valid, c, seed, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32)
    if ties:
        logits = np.round(logits, 1) + np.float32(0.0)
    return logits, np.arange(n) < n_valid


def assert_top_half_is_jaxs(prep, jprep, n):
    """The top half, its validity, ref_dim and the remainder equal JAX's;
    JAX's slots past the union hold the sentinel n, the port's row 0."""
    want = np.asarray(jprep.top.indices)
    np.testing.assert_array_equal(prep.top.indices.numpy(),
                                  np.where(want < n, want, 0))
    np.testing.assert_array_equal(prep.top.slot_valid.numpy(),
                                  np.asarray(jprep.top.slot_valid))
    np.testing.assert_array_equal(prep.ref_dim.numpy(),
                                  np.asarray(jprep.ref_dim))
    np.testing.assert_array_equal(prep.remainder.numpy(),
                                  np.asarray(jprep.remainder))


@pytest.mark.parametrize("n_valid", [0, 3, 12, 16, 40, 64])
@pytest.mark.parametrize("c", [2, 3])
def test_multiclass_top_half_matches_jax(n_valid, c):
    """k_top·C = 8·c: n_valid below, at (c = 2: 16) and above it."""
    n, k_top = 64, 8
    logits, valid = multiclass_inputs(n, n_valid, c, seed=n_valid + c,
                                      ties=n_valid == 40)
    prep = tsel.multiclass_selection_prepare(
        torch.from_numpy(logits), torch.from_numpy(valid), k_top)
    jprep = jsel.multiclass_selection_prepare(
        jnp.asarray(logits), jnp.asarray(valid), k_top)
    assert_top_half_is_jaxs(prep, jprep, n)
    s_half = min(k_top * c, n)
    live = prep.top.indices[prep.top.slot_valid]
    assert len(live) == int(prep.ref_dim)
    assert (live[1:] > live[:-1]).all()          # ascending, distinct
    assert valid[live.numpy()].all()
    assert prep.top.indices.shape == (s_half,)


@pytest.mark.parametrize("n_valid", [0, 5, 20, 64])
def test_multiclass_random_half_structure(n_valid):
    n, c, k_top = 64, 2, 8
    logits, valid = multiclass_inputs(n, n_valid, c, seed=7)
    prep = tsel.multiclass_selection_prepare(
        torch.from_numpy(logits), torch.from_numpy(valid), k_top)
    sel = tsel.multiclass_selection_draw(torch.Generator().manual_seed(2),
                                         prep)
    s_half = min(k_top * c, n)
    assert sel.indices.shape == sel.slot_valid.shape == (2 * s_half,)
    rand = sel.indices[s_half:][sel.slot_valid[s_half:]]
    assert len(rand) == int(prep.ref_dim)        # ref_dim of them
    assert prep.remainder[rand].all()            # from the remainder
    assert len(set(rand.tolist())) == len(rand)  # distinct
    assert not set(rand.tolist()) & set(
        sel.indices[:s_half][sel.slot_valid[:s_half]].tolist())


def test_packed_multiclass_selection_matches_jax():
    """Three bags (64 rows: 64, 10 and 0 valid) with k_top = 40, so
    k_top·C passes the bag length: the slot count is min(k_top·C, N)."""
    k, n, c, k_top = 3, 64, 2, 40
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((k, n, c)).astype(np.float32)
    valid = np.arange(n)[None, :] < np.array([[64], [10], [0]])
    prep = tsel.packed_selection_prepare(torch.from_numpy(logits),
                                         torch.from_numpy(valid), k_top,
                                         multiclass=True)
    jprep = jsel.packed_selection_prepare(jnp.asarray(logits),
                                          jnp.asarray(valid), k_top,
                                          multiclass=True)
    assert_top_half_is_jaxs(prep, jprep, n)
    sel = tsel.packed_selection_draw(torch.Generator().manual_seed(1), prep,
                                     0, n, multiclass=True)
    jsel_ = jsel.packed_selection_draw(jax.random.PRNGKey(0), jprep, 0, n,
                                       multiclass=True)
    s = 2 * min(k_top * c, n)
    assert sel.indices.shape == (k * s,) == np.asarray(jsel_.indices).shape
    np.testing.assert_array_equal(sel.slot_valid.numpy(),
                                  np.asarray(jsel_.slot_valid))
    for b in range(k):
        live = sel.indices[b * s:(b + 1) * s][sel.slot_valid[b * s:(b + 1) * s]]
        assert ((live >= b * n) & (live < (b + 1) * n)).all()
        assert len(set(live.tolist())) == len(live)
        assert len(live) == 2 * int(prep.ref_dim[b])
