"""The port's training slice vs the JAX package.

The MILNet training forward (dropouts, gradients), then the trainer:
from the same weights (`bridge.milnet_from_jax`), the port's
`SnuffyTrainer.run_train_epoch` and the JAX one (Pallas in interpret mode
on the CPU) take the same serial and packed steps. f32, ρ=0 and dropout 0
on both sides, so both select the same slots and draw nothing.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from snuffy_tpu.configs import MILTrainConfig as JaxMILTrainConfig
from snuffy_tpu.configs import OptimizerConfig as JaxOptimizerConfig
from snuffy_tpu.configs import SnuffyModelConfig as JaxSnuffyModelConfig
from snuffy_tpu.train.runner import bucket_bags
from snuffy_tpu.train.trainer import SnuffyTrainer as JaxTrainer
from snuffy_tpu_torch import configs
from snuffy_tpu_torch.bridge import milnet_from_jax, milnet_state_dict
from snuffy_tpu_torch.models import layers
from snuffy_tpu_torch.models import snuffy as port
from snuffy_tpu_torch.models.snuffy import build_milnet
from snuffy_tpu_torch.ops.sparse_attention import (
    packed_inverted_sparse_attention,
)
from snuffy_tpu_torch.train.trainer import SnuffyTrainer

MODEL = JaxSnuffyModelConfig(
    feats_size=32, num_classes=1, num_heads=2, big_lambda=8,
    random_patch_share=0.0, depth=2, encoder_dropout=0.0,
    attention_dropout=0.0, activation="gelu",
)


def to_port(cfg: JaxMILTrainConfig) -> configs.MILTrainConfig:
    d = dataclasses.asdict(cfg)
    return configs.MILTrainConfig(
        model=configs.SnuffyModelConfig(**d.pop("model")),
        optim=configs.OptimizerConfig(**d.pop("optim")), **d)


def bag(n=60, n_pad=64, d=32, seed=0, segments=1):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((segments * n_pad, d)).astype(np.float32)
    mask = np.tile(np.arange(n_pad) < n, segments)
    return torch.from_numpy(feats), torch.from_numpy(mask)


# ----------------------------------------------------------- the model

@pytest.mark.parametrize("segments", [1, 2])
def test_training_forward_without_dropout_is_the_eval_forward(segments):
    model = build_milnet(MODEL, seed=2, device="cpu")
    feats, mask = bag(segments=segments)
    with torch.no_grad():
        want = model.eval()(feats, mask, segments)
        got = model.train()(feats, mask, segments)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_attention_dropout_takes_one_hash_seed_per_layer(monkeypatch):
    """Each layer's attention runs the plain version's hash dropout at 0.1
    with a seed drawn from the CPU seed generator."""
    calls = []
    attention = port.fused_packed_inverted_sparse_attention

    def spy(q, k, v, sv, qv, segments, **kw):
        out = attention(q, k, v, sv, qv, segments, **kw)
        calls.append(([t.detach() for t in (q, k, v)], sv, qv, segments,
                      kw, out.detach()))
        return out

    monkeypatch.setattr(port, "fused_packed_inverted_sparse_attention", spy)
    cfg = dataclasses.replace(MODEL, attention_dropout=0.1)
    model = build_milnet(cfg, seed=1, device="cpu").train()
    feats, mask = bag(seed=1, segments=2)
    model(feats, mask, 2, seed_generator=torch.Generator().manual_seed(7))
    draws = torch.Generator().manual_seed(7)
    seeds = [int(torch.randint(0, 2**31 - 1, (), generator=draws))
             for _ in range(cfg.depth)]
    assert [c[4] for c in calls] == [
        dict(dropout_rate=0.1, dropout_seed=s) for s in seeds]
    for (q, k, v), sv, qv, segments, kw, out in calls:
        want = packed_inverted_sparse_attention(q, k, v, sv, qv, segments,
                                                **kw)
        assert torch.equal(out, want)
        assert not torch.equal(out, packed_inverted_sparse_attention(
            q, k, v, sv, qv, segments))


def test_encoder_dropout_keep_share_is_binomial():
    n, rate = 200_000, 0.1
    x = torch.ones(n)
    y = layers.dropout(x, rate, torch.Generator().manual_seed(3))
    kept = y != 0
    share = float(kept.float().mean())
    assert abs(share - (1 - rate)) < 5 * (rate * (1 - rate) / n) ** 0.5
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    again = layers.dropout(x, rate, torch.Generator().manual_seed(3))
    assert torch.equal(y, again)
    assert layers.dropout(x, 0.0, None) is x


def test_training_forward_reaches_every_parameter():
    """Dropouts on, a random share: the loss reaches every parameter, and
    the same generators give the same step."""
    cfg = dataclasses.replace(MODEL, random_patch_share=0.5,
                              encoder_dropout=0.2, attention_dropout=0.1)
    model = build_milnet(cfg, seed=4, device="cpu").train()
    feats, mask = bag(seed=4)
    outs = []
    for _ in range(2):
        model.zero_grad()
        ins, bag_logits = model(
            feats, mask, generator=torch.Generator().manual_seed(1),
            seed_generator=torch.Generator().manual_seed(2))
        (ins.max() + bag_logits.sum()).backward()
        outs.append(bag_logits.detach())
        for name, p in model.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
            assert p.grad.abs().sum() > 0, name
    assert torch.equal(outs[0], outs[1])
    with torch.no_grad():
        assert not torch.equal(outs[0], model.eval()(feats, mask)[1])


@pytest.mark.parametrize("pos_weight", [None, 2.5])
def test_loss_gradients_match_jax(pos_weight):
    """Gradients of the packed mixed loss (a dummy bag included) for the
    instance logits, the bag logits and the mix weight w, against
    jax.grad of the JAX loss."""
    import jax.numpy as jnp

    from snuffy_tpu.train import losses as jax_losses
    from snuffy_tpu_torch.train import losses

    rng = np.random.default_rng(5)
    ins = rng.standard_normal((3 * 20, 1)).astype(np.float32)
    bag_logits = rng.standard_normal((3, 1)).astype(np.float32)
    labels = np.array([[1.0], [0.0], [0.0]], np.float32)
    mask = np.concatenate([np.arange(20) < n for n in (20, 7, 0)])
    bag_w = np.array([1.0, 1.0, 0.0], np.float32)

    def jax_mean(i, b, w):
        pw = None if pos_weight is None else jnp.float32(pos_weight)
        per_bag, _ = jax_losses.packed_mixed_mil_loss(
            i, b, jnp.asarray(labels), jnp.asarray(mask), w, pw, segments=3)
        return jnp.sum(per_bag * bag_w) / jnp.sum(bag_w)

    want = jax.grad(jax_mean, argnums=(0, 1, 2))(
        jnp.asarray(ins), jnp.asarray(bag_logits), jnp.float32(0.3))
    leaves = [torch.tensor(x, requires_grad=True)
              for x in (ins, bag_logits, np.float32(0.3))]
    per_bag, _ = losses.packed_mixed_mil_loss(
        leaves[0], leaves[1], torch.from_numpy(labels),
        torch.from_numpy(mask), leaves[2], pos_weight, segments=3)
    ((per_bag * torch.from_numpy(bag_w)).sum() / bag_w.sum()).backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-7)


# --------------------------------------------------------- the trainer

def bags(count=3, seed=0):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((int(n), 32)).astype(np.float32)
             for n in rng.integers(50, 64, count)]
    labels = [np.array([float(i % 2)], np.float32) for i in range(count)]
    return bucket_bags(labels, feats, rng=np.random.default_rng(1))


# f32 on both sides, sums in other orders. Adam's step is about
# lr·g/(|g| + 1e-8) whatever the size of g, so where a gradient element is
# near zero the two frameworks' rounding moves the parameter by up to a
# good part of lr: at most 1 in 500 elements of a tensor may leave
# PARAM_TOL, each by less than lr (measured: 1 of 1024, 1.1e-4 at lr 1e-2;
# the rest within 2.4e-6, 99.9 % within 4.3e-6).
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=2e-5)
# The key projection's bias adds q_i·b to every score of row i, which the
# softmax cancels: its true gradient is 0, each framework's is rounding
# noise, and Adam turns noise into steps of about ±lr. It is held to
# that bound instead.
KEY_BIAS = "self_attn.linears.1.bias"


@pytest.mark.parametrize("optim, soft_average", [
    (JaxOptimizerConfig(optimizer="adam", lr=1e-2, clip_grad=0.05), False),
    (JaxOptimizerConfig(optimizer="adamw", lr=1e-2, weight_decay=5e-2),
     True),
])
@pytest.mark.parametrize("batch", [1, 2])
def test_trainer_matches_jax(optim, soft_average, batch):
    """3 bags of one 64-row bucket: 3 serial steps, or 2 packed steps of 2
    bags with a dummy bag in the tail chunk."""
    jcfg = JaxMILTrainConfig(model=MODEL, optim=optim,
                             soft_average=soft_average, bag_batch_size=batch,
                             use_mesh=0, seed=3)
    bucketed = bags()
    assert list(bucketed) == [64] and len(bucketed[64][3]) == 3
    jt = JaxTrainer(jcfg)
    state = jt.init_state(jcfg.seed)
    pcfg = to_port(jcfg)
    tt = SnuffyTrainer(pcfg, "cpu",
                       model=milnet_from_jax(state.params, pcfg.model,
                                             device="cpu"),
                       w=float(state.w))
    state, *want = jt.run_train_epoch(state, bucketed, optim.lr,
                                      np.random.default_rng(0), 5)
    got = tt.run_train_epoch(bucketed, optim.lr, np.random.default_rng(0), 5)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **LOSS_TOL)
    assert len(got[2]) == 3
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(a, b, **LOSS_TOL)
    start = milnet_state_dict(jax.device_get(jt.init_state(jcfg.seed).params))
    end = milnet_state_dict(jax.device_get(state.params))
    steps = 3 if batch == 1 else 2
    for name, p in tt.model.state_dict().items():
        assert not np.array_equal(end[name], start[name]), name
        if name.endswith(KEY_BIAS):
            for x in (p.numpy(), end[name]):
                assert np.abs(x - start[name]).max() <= 3 * optim.lr * steps
        else:
            diff = np.abs(p.numpy() - end[name])
            off = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(
                end[name])
            assert off.sum() <= off.size / 500, (name, diff.max())
            assert diff.max() < optim.lr, name
    w = tt.w.item()
    np.testing.assert_allclose(w, float(state.w), rtol=1e-5)
    assert (w != 0.5) == soft_average
    assert 0.0 <= w <= 1.0


def test_bucket_bags_and_schedules_match_jax():
    from snuffy_tpu.train import schedules as jax_schedules
    from snuffy_tpu_torch.train import runner, schedules

    rng = np.random.default_rng(2)
    feats = [rng.standard_normal((int(n), 8)).astype(np.float32)
             for n in (5, 17, 30, 33, 90)]
    labels = [np.array([float(i % 2)], np.float32) for i in range(5)]
    for kw in (dict(), dict(l2norm=True, dropout_patch=0.3)):
        want = bucket_bags(labels, feats, rng=np.random.default_rng(3), **kw)
        got = runner.bucket_bags(labels, feats, rng=np.random.default_rng(3),
                                 **kw)
        assert list(got) == list(want)
        for n_pad in want:
            for a, b in zip(got[n_pad], want[n_pad]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    for name in ("cosine", "cosinewarmup", "none"):
        want = jax_schedules.make_epoch_schedule(name, 2e-4, 40, 5e-6)
        got = schedules.make_epoch_schedule(name, 2e-4, 40, 5e-6)
        assert [got(e) for e in range(41)] == [want(e) for e in range(41)]


def test_trainer_refuses_the_vmap_impl():
    cfg = configs.MILTrainConfig(model=to_port(JaxMILTrainConfig(
        model=MODEL)).model, bag_batch_impl="vmap")
    with pytest.raises(ValueError, match="packed"):
        SnuffyTrainer(cfg, "cpu")
