"""Port's MILNet and losses vs the JAX package.

The JAX parameters cross through `bridge.milnet_from_jax` (the JAX
package's reference exporter, loaded with strict=True). ρ=0, so both
sides select the same slots. The JAX model runs its einsum attention (the
Pallas kernel's oracle, use_pallas=False) to keep the CPU run short.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snuffy_tpu.configs import SnuffyModelConfig
from snuffy_tpu.models.snuffy import build_milnet as jax_build_milnet
from snuffy_tpu.models.snuffy import init_milnet_params
from snuffy_tpu.train import losses as jax_losses
from snuffy_tpu_torch.bridge import milnet_from_jax
from snuffy_tpu_torch.models.snuffy import build_milnet
from snuffy_tpu_torch.ops.init import WEIGHT_INITS
from snuffy_tpu_torch.train import losses

CFG = SnuffyModelConfig(
    feats_size=32, num_classes=1, num_heads=2, big_lambda=16,
    random_patch_share=0.0, depth=2, activation="gelu", use_pallas=False,
)
# f32 on both sides, sums in other orders. bf16: the residual stream is
# rounded to bf16 at other places in the two frameworks (2 layers).
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def bag(n=100, n_pad=128, d=32, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n_pad, d)).astype(np.float32)
    return feats, np.arange(n_pad) < n


def jax_forward(cfg, params, feats, mask, segments=1):
    ins, bag_logits, _ = jax_build_milnet(cfg, segments=segments).apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(mask), True,
        rngs={"sparse": jax.random.PRNGKey(0)},
    )
    return np.asarray(ins), np.asarray(bag_logits)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_milnet_matches_jax(dtype):
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    params = init_milnet_params(cfg, seed=0, n_example=128)
    feats, mask = bag()
    want_ins, want_bag = jax_forward(cfg, params, feats, mask)
    model = milnet_from_jax(params, cfg, device="cpu")
    with torch.inference_mode():
        ins, bag_logits = model(torch.from_numpy(feats), torch.from_numpy(mask))
    assert ins.dtype == bag_logits.dtype == torch.float32
    assert ins.shape == (128, 1) and bag_logits.shape == (1,)
    # instance logits come from the f32 feats under either stream dtype
    np.testing.assert_allclose(ins.numpy(), want_ins, **TOL["float32"])
    np.testing.assert_allclose(bag_logits.numpy(), want_bag, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compute_dtype_reaches_the_attention(dtype, monkeypatch):
    """The bf16 tolerance above would also pass an f32 run: check that q,
    k and v reach the sparse attention, and leave it, in the compute
    dtype."""
    from snuffy_tpu_torch.models import snuffy as port

    seen = []

    def spy(q, k, v, *args, **kw):
        out = port_attention(q, k, v, *args, **kw)
        seen.append((q.dtype, k.dtype, v.dtype, out.dtype))
        return out

    port_attention = port.fused_packed_inverted_sparse_attention
    monkeypatch.setattr(port, "fused_packed_inverted_sparse_attention", spy)
    model = build_milnet(dataclasses.replace(CFG, compute_dtype=dtype),
                         device="cpu")
    feats, mask = (torch.from_numpy(a) for a in bag())
    with torch.inference_mode():
        model(feats, mask)
    want = getattr(torch, dtype)
    assert seen == [(want,) * 4] * CFG.depth


def test_packed_milnet_matches_jax_packed():
    params = init_milnet_params(CFG, seed=1, n_example=128)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((3 * 128, 32)).astype(np.float32)
    mask = np.concatenate([np.arange(128) < n for n in (100, 0, 57)])
    want_ins, want_bag = jax_forward(CFG, params, feats, mask, segments=3)
    model = milnet_from_jax(params, CFG, device="cpu")
    with torch.inference_mode():
        ins, bag_logits = model(torch.from_numpy(feats),
                                torch.from_numpy(mask), segments=3)
    assert bag_logits.shape == (3, 1) and torch.isfinite(bag_logits).all()
    np.testing.assert_allclose(ins.numpy(), want_ins, **TOL["float32"])
    np.testing.assert_allclose(bag_logits.numpy(), want_bag,
                               **TOL["float32"])


def test_random_share_forward_is_finite_and_seeded():
    cfg = dataclasses.replace(CFG, random_patch_share=0.5)
    model = build_milnet(cfg, seed=3, device="cpu")
    feats, mask = (torch.from_numpy(a) for a in bag(n=40, n_pad=48))
    with torch.inference_mode():
        out = [model(feats, mask, generator=torch.Generator().manual_seed(s))
               for s in (0, 0, 1)]
    assert torch.equal(out[0][1], out[1][1])
    assert torch.isfinite(out[2][1]).all()


def test_training_mode_refuses():
    """A rate of 1 would drop every attention weight: training mode
    refuses it, eval mode (no dropout) runs."""
    cfg = dataclasses.replace(CFG, attention_dropout=1.0)
    model = build_milnet(cfg, device="cpu")
    with torch.inference_mode():
        assert torch.isfinite(model(torch.zeros(16, 32))[1]).all()
    with pytest.raises(ValueError, match="dropout_rate"):
        model.train()(torch.zeros(16, 32))


@pytest.mark.parametrize("name", sorted(WEIGHT_INITS))
def test_every_weight_init_builds_a_model(name):
    cfg = dataclasses.replace(CFG, weight_init_i=name, weight_init_b=name)
    model = build_milnet(cfg, seed=0, device="cpu")
    w = model.b_classifier.encoder.layers[0].feed_forward.w_1.weight.detach()
    assert all(torch.isfinite(p).all() for p in model.parameters())
    feats, mask = (torch.from_numpy(a) for a in bag())
    with torch.inference_mode():
        _, bag_logits = model(feats, mask)
    assert torch.isfinite(bag_logits).all()
    # the JAX distributions: truncated at 2σ where JAX truncates
    fan_in, fan_out = w.shape[1], w.shape[0]
    if name in ("xavier_normal", "kaiming_normal", "trunc_normal",
                "orthogonal"):
        std = {"xavier_normal": (2 / (fan_in + fan_out)) ** 0.5 / 0.8796,
               "kaiming_normal": (2 / fan_in) ** 0.5 / 0.8796}.get(name, 1.0)
        assert float(w.abs().max()) <= 2 * std + 1e-6
    else:
        limit = ((6 / (fan_in + fan_out)) if name == "xavier_uniform"
                 else (6 / fan_in)) ** 0.5
        assert float(w.abs().max()) <= limit


def test_init_variance_matches_jax():
    from snuffy_tpu.ops.init import WEIGHT_INITS as JAX_INITS

    for name in ("xavier_normal", "kaiming_uniform", "orthogonal"):
        t = torch.empty(256, 512)
        WEIGHT_INITS[name](t, torch.Generator().manual_seed(0))
        j = np.asarray(JAX_INITS[name](jax.random.PRNGKey(0), (512, 256),
                                       jnp.float32))
        assert abs(float(t.std()) / float(j.std()) - 1.0) < 0.02, name


def test_losses_match_jax_including_a_dummy_bag():
    rng = np.random.default_rng(4)
    ins = rng.standard_normal((3 * 20, 1)).astype(np.float32)
    bag_logits = rng.standard_normal((3, 1)).astype(np.float32)
    labels = np.array([[1.0], [0.0], [0.0]], np.float32)
    mask = np.concatenate([np.arange(20) < n for n in (20, 7, 0)])
    for pw in (None, 2.5):
        want_l, want_s = jax_losses.packed_mixed_mil_loss(
            jnp.asarray(ins), jnp.asarray(bag_logits), jnp.asarray(labels),
            jnp.asarray(mask), jnp.float32(0.3),
            None if pw is None else jnp.float32(pw), segments=3)
        got_l, got_s = losses.packed_mixed_mil_loss(
            torch.from_numpy(ins), torch.from_numpy(bag_logits),
            torch.from_numpy(labels), torch.from_numpy(mask),
            torch.tensor(0.3), pw, segments=3)
        assert torch.isfinite(got_l).all() and torch.isfinite(got_s).all()
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=1e-6, atol=1e-6)
    one_l, one_s = losses.mixed_mil_loss(
        torch.from_numpy(ins[:20]), torch.from_numpy(bag_logits[0]),
        torch.from_numpy(labels[0]), torch.from_numpy(mask[:20]), 0.3, 2.5)
    np.testing.assert_allclose(one_l.numpy(), got_l[0].numpy(), rtol=1e-6)
    np.testing.assert_allclose(one_s.numpy(), got_s[0].numpy(), rtol=1e-6)


# ------------------------------------------------------------- multiclass

MC = dataclasses.replace(CFG, num_classes=3, multiclass=True, big_lambda=8,
                         random_patch_share=0.5)


def pinned_draw_jax(key, prep):
    """The random half pinned to the first rows of the remainder, so that
    both frameworks attend the same slots."""
    from snuffy_tpu.ops.selection import Selection

    s_half = prep.top.indices.shape[-1]
    order = jnp.argsort(~prep.remainder, axis=-1, stable=True)[..., :s_half]
    avail = jnp.take_along_axis(prep.remainder, order, axis=-1)
    valid = (jnp.arange(s_half) < prep.ref_dim[..., None]) & avail
    return Selection(
        jnp.concatenate([prep.top.indices, order.astype(jnp.int32)], -1),
        jnp.concatenate([prep.top.slot_valid, valid], -1))


def pinned_draw_torch(generator, prep):
    from snuffy_tpu_torch.ops.selection import Selection

    s_half = prep.top.indices.shape[-1]
    order = torch.sort((~prep.remainder).int(), dim=-1,
                       stable=True).indices[..., :s_half]
    avail = prep.remainder.gather(-1, order)
    valid = (torch.arange(s_half) < prep.ref_dim[..., None]) & avail
    return Selection(torch.cat([prep.top.indices, order], -1),
                     torch.cat([prep.top.slot_valid, valid], -1))


def pin_the_draws(monkeypatch):
    from snuffy_tpu.models import snuffy as jax_model
    from snuffy_tpu.ops import selection as jax_sel
    from snuffy_tpu_torch.models import snuffy as port_model
    from snuffy_tpu_torch.ops import selection as port_sel

    monkeypatch.setattr(jax_model, "multiclass_selection_draw",
                        pinned_draw_jax)
    monkeypatch.setattr(jax_sel, "multiclass_selection_draw",
                        pinned_draw_jax)
    monkeypatch.setattr(port_model, "multiclass_selection_draw",
                        pinned_draw_torch)
    monkeypatch.setattr(port_sel, "multiclass_selection_draw",
                        pinned_draw_torch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multiclass_milnet_matches_jax(dtype, monkeypatch):
    pin_the_draws(monkeypatch)
    cfg = dataclasses.replace(MC, compute_dtype=dtype)
    params = init_milnet_params(cfg, seed=2, n_example=128)
    feats, mask = bag(n=100, n_pad=128)
    want_ins, want_bag = jax_forward(cfg, params, feats, mask)
    model = milnet_from_jax(params, cfg, device="cpu")
    with torch.inference_mode():
        ins, bag_logits = model(torch.from_numpy(feats),
                                torch.from_numpy(mask))
    assert ins.shape == (128, 3) and bag_logits.shape == (3,)
    np.testing.assert_allclose(ins.numpy(), want_ins, **TOL["float32"])
    np.testing.assert_allclose(bag_logits.numpy(), want_bag, **TOL[dtype])


def test_packed_multiclass_milnet_matches_jax_packed(monkeypatch):
    """Bags of 100, 0 and 5 valid rows (5 < k_top·C = 12)."""
    pin_the_draws(monkeypatch)
    params = init_milnet_params(MC, seed=3, n_example=128)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((3 * 128, 32)).astype(np.float32)
    mask = np.concatenate([np.arange(128) < n for n in (100, 0, 5)])
    want_ins, want_bag = jax_forward(MC, params, feats, mask, segments=3)
    model = milnet_from_jax(params, MC, device="cpu")
    with torch.inference_mode():
        ins, bag_logits = model(torch.from_numpy(feats),
                                torch.from_numpy(mask), segments=3)
    assert bag_logits.shape == (3, 3) and torch.isfinite(bag_logits).all()
    np.testing.assert_allclose(ins.numpy(), want_ins, **TOL["float32"])
    np.testing.assert_allclose(bag_logits.numpy(), want_bag,
                               **TOL["float32"])


def test_multiclass_random_draw_is_seeded_and_attends_2x_slots(monkeypatch):
    """Unpinned: S = 2·min(k_top·C, N) slots reach the attention, and one
    generator seed gives one result."""
    from snuffy_tpu_torch.models import snuffy as port

    slots = []
    attention = port.fused_packed_inverted_sparse_attention

    def spy(q, k, v, *args, **kw):
        slots.append(k.shape[1])
        return attention(q, k, v, *args, **kw)

    monkeypatch.setattr(port, "fused_packed_inverted_sparse_attention", spy)
    model = build_milnet(MC, seed=4, device="cpu")
    feats, mask = (torch.from_numpy(a) for a in bag(n=40, n_pad=48))
    with torch.inference_mode():
        out = [model(feats, mask, generator=torch.Generator().manual_seed(s))
               for s in (0, 0, 1)]
    assert torch.equal(out[0][1], out[1][1])
    assert torch.isfinite(out[2][1]).all()
    assert slots == [2 * min(MC.k_top * 3, 48)] * (3 * MC.depth)


@pytest.mark.parametrize("multiclass, override, want", [
    (False, None, 0.25), (True, None, 0.1), (True, 0.3, 0.3)])
def test_ffn_dropout_defaults_as_the_jax_model(multiclass, override, want):
    from snuffy_tpu.models.snuffy import MILNet as JaxMILNet

    cfg = dataclasses.replace(CFG, multiclass=multiclass,
                              encoder_dropout=0.25)
    model = build_milnet(cfg, device="cpu", ffn_dropout=override)
    rates = {layer.ffn_dropout for layer in model.b_classifier.encoder.layers}
    assert rates == {want}
    assert JaxMILNet(cfg, ffn_dropout=override)._ffn_dropout() == want
