"""The port's MAE-adapter pretraining pieces against the JAX package's.

A small MAE (32² images, patch 8, width 64, depth 2, 4 heads; decoder
width 32, depth 1, 2 heads; adapter bottleneck 8, the decoder's 4) crosses
from JAX through `bridge.mae_pretrain_from_jax`, its adapters'
up-projections drawn non-zero (zero at init in both, where an adapter adds
exactly 0). Held to the JAX package:

  * `patchify`/`unpatchify`, bit for bit;
  * `random_masking` fed the noise JAX draws from its key
    (`jax.random.uniform(key, (b, n))`): the same ids, mask and kept rows;
  * the forward (loss, pred, mask), with and without `norm_pix_loss`, at
    pack 1 and 2 (JAX `'masked'`, one attention with a block-diagonal
    mask; the port folds the images into the kernel's z): f32 within
    F32_REL of max |JAX| (sums in other orders), bf16 within the ViT
    tests' elementwise 5e-2 (the JAX MHSA rounds its scores to bf16, the
    port's dense attention keeps them f32);
  * `mae_train_augment` on the draws JAX takes from its key
    (`snuffy_tpu/ssl/augment.py:32-38,106,214-218`), within 1e-5;
  * the trainable and no-decay masks;
  * two f32 optimizer steps with dropout off against `jax.value_and_grad`
    and the JAX trainer's `tx` (the JAX step's update), with the frozen
    parameters bit for bit: Adam's moments within STEP_TOL of each
    tensor's max |JAX|; each parameter within Adam's bound (2·lr·steps),
    and STEP_SHARE of its elements within STEP_TOL of its max |JAX| plus
    lr·steps (the rounding of each Adam step's direction: where a gradient
    element is near zero, Adam scales its rounding up to lr).

Dropout draws cannot match across frameworks: on the JAX side flax's
`nn.Dropout` is replaced by a pass-through in the test (the JAX `Block`
hard-wires the adapter's 0.1), the port's adapters run with dropout 0.
Nothing in `snuffy_tpu/` changes. The random share (the masking noise,
the dropout) is held by structure and statistics.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snuffy_tpu.models import mae as jax_mae
from snuffy_tpu.ssl import augment as jaug
from snuffy_tpu.ssl import mae_trainer as jtrainer
from snuffy_tpu_torch.bridge import mae_pretrain_from_jax
from snuffy_tpu_torch.models import mae
from snuffy_tpu_torch.ssl import augment, mae_trainer

SMALL = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
             decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2,
             adapter_bottleneck=8, adapter_scale=4.0)
F32_REL = 1e-5
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
STEP_TOL = 1e-5
STEP_SHARE = 0.999
AUG_TOL = 1e-5


class PassThrough(fnn.Module):
    rate: float = 0.0
    deterministic: object = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", PassThrough)


def jax_small(use_adapter=True, dtype="float32", seed=0, **kw):
    """The JAX model and its params, numpy, the adapters' up drawn (one
    init per configuration; the tests only read the params)."""
    return _jax_small(use_adapter, dtype, seed, tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _jax_small(use_adapter, dtype, seed, kw):
    model = jax_mae.MaskedAutoencoderViT(
        use_adapter=use_adapter, compute_dtype=dtype, **{**SMALL, **dict(kw)})
    key = jax.random.PRNGKey(seed)
    params = jax.jit(lambda k: model.init(
        {"params": k, "masking": k}, jnp.zeros((1, 32, 32, 3)), 0.75,
        True))(key)["params"]
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(seed + 100)
    for name, blk in params.items():
        if "blocks_" in name and "adaptmlp" in blk:
            up = blk["adaptmlp"]["up"]
            up["kernel"] = (0.2 * rng.standard_normal(up["kernel"].shape)
                            ).astype(np.float32)
            up["bias"] = (0.1 * rng.standard_normal(up["bias"].shape)
                          ).astype(np.float32)
    return model, params


def port_small(params, use_adapter=True, dtype="float32", **kw):
    """The port's model holding the JAX params, its adapters' dropout
    off."""
    model = mae.MaskedAutoencoderViT(
        use_adapter=use_adapter, compute_dtype=dtype, with_decoder=True,
        **{**SMALL, **kw})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           mae_pretrain_from_jax(params).items()},
                          strict=True)
    for blk in [*model.blocks, *model.decoder_blocks]:
        if blk.adaptmlp is not None:
            blk.adaptmlp.dropout = 0.0
    return model


def images(n=4, size=32, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 3),
                                              dtype=np.float32)


def rel(got, want):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


def to_np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------- patches, masking


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patchify_and_unpatchify_are_jaxs(dtype):
    jm, params = jax_small()
    x = images(3)
    jx = jnp.asarray(x, dtype)
    want = jm.apply({"params": params}, jx, method=jm.patchify)
    model = mae.MaskedAutoencoderViT(**SMALL)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = model.patchify(tx)
    assert got.shape == (3, 16, 192) and got.dtype == tx.dtype
    np.testing.assert_array_equal(to_np(got), np.asarray(want, np.float32))
    back = jm.apply({"params": params}, want, method=jm.unpatchify)
    assert torch.equal(model.unpatchify(got), tx)
    np.testing.assert_array_equal(to_np(model.unpatchify(got)),
                                  np.asarray(back, np.float32))


@pytest.mark.parametrize("b, n, ratio", [(4, 16, 0.75), (3, 196, 0.75),
                                         (2, 16, 0.5), (2, 10, 0.0)])
def test_random_masking_on_jax_noise(b, n, ratio):
    """The JAX `random_masking` draws uniform(key, (b, n)); the port fed
    that noise keeps the same rows, in the same order, with the same mask
    and ids_restore."""
    jm, params = jax_small()
    key = jax.random.PRNGKey(b * n)
    x = np.random.default_rng(n).normal(size=(b, n, 8)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x), ratio, key,
                    method=jm.random_masking)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (b, n))))
    got = mae.MaskedAutoencoderViT.random_masking(torch.from_numpy(x), ratio,
                                                  noise)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (b, int(n * (1 - ratio)), 8)


def test_random_masking_sorts_ties_stably():
    """Tied noise keeps the earlier position first, as jnp.argsort."""
    noise = torch.tensor([[0.5, 0.25, 0.5, 0.25, 0.0, 0.5]])
    x = torch.arange(6.0).reshape(1, 6, 1)
    keep, mask, restore = mae.MaskedAutoencoderViT.random_masking(x, 0.5,
                                                                  noise)
    shuffle = np.asarray(jnp.argsort(jnp.asarray(noise.numpy()), axis=1))
    np.testing.assert_array_equal(restore.numpy(),
                                  np.argsort(shuffle, axis=1, kind="stable"))
    assert keep.flatten().tolist() == [4.0, 1.0, 3.0]
    assert mask.tolist() == [[1.0, 0.0, 1.0, 0.0, 0.0, 1.0]]


def test_random_masking_draws_from_the_generator():
    """Without noise: len_keep zeros a row, reproducible from the
    generator's seed, and every position kept about equally often."""
    x = torch.zeros(4000, 16, 1)
    gen = torch.Generator().manual_seed(0)
    _, mask, _ = mae.MaskedAutoencoderViT.random_masking(x, 0.75,
                                                         generator=gen)
    assert torch.equal(mask.sum(dim=1), torch.full((4000,), 12.0))
    kept = 1.0 - mask.mean(dim=0)
    assert float((kept - 0.25).abs().max()) < 0.03
    again = mae.MaskedAutoencoderViT.random_masking(
        x, 0.75, generator=torch.Generator().manual_seed(0))[1]
    assert torch.equal(again, mask)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("norm_pix", [False, True])
@pytest.mark.parametrize("pack", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, pack, norm_pix):
    """(loss, pred, mask) of the deterministic forward (jitted) on the JAX
    key's noise; the input in the compute dtype (the trainer's bf16
    images). In bf16 the tolerance also covers XLA's excess precision
    under jit (the `norm_pix_loss` target normalised in f32, where the
    written code and the port round each op)."""
    jm, params = jax_small(dtype=dtype, norm_pix_loss=norm_pix)
    key = jax.random.PRNGKey(7)
    x = images(4)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else None)
    loss, pred, mask = jax.jit(lambda p, x, k: jm.apply(
        {"params": p}, x, 0.75, True, rng=k, pack=pack))(params, jx, key)
    model = port_small(params, dtype=dtype, norm_pix_loss=norm_pix).eval()
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (4, 16))))
    with torch.no_grad():
        g_loss, g_pred, g_mask = model.forward_pretrain(tx, 0.75, noise,
                                                        pack=pack)
    assert g_loss.dtype == g_pred.dtype == torch.float32
    assert g_pred.shape == (4, 16, 192)
    np.testing.assert_array_equal(g_mask.numpy(), np.asarray(mask))
    if dtype == "float32":
        assert rel(to_np(g_pred), pred) <= F32_REL
        assert abs(float(g_loss) - float(loss)) <= F32_REL * abs(float(loss))
    else:
        np.testing.assert_allclose(to_np(g_pred), np.asarray(pred),
                                   **BF16_TOL)
        np.testing.assert_allclose(float(g_loss), float(loss), **BF16_TOL)


def test_pack_2_equals_pack_1_and_checks_the_batch():
    _, params = jax_small()
    model = port_small(params).eval()
    x = torch.from_numpy(images(4))
    noise = torch.rand(4, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        one = model.forward_pretrain(x, 0.75, noise)
        two = model.forward_pretrain(x, 0.75, noise, pack=2)
    assert rel(to_np(two[1]), to_np(one[1])) <= F32_REL
    with pytest.raises(ValueError, match="pack"):
        model.forward_pretrain(x[:3], 0.75, noise[:3], pack=2)


def test_dtypes_follow_jax():
    """bf16: the patch embedding, both residual streams, the norms,
    decoder_embed and pred run in f32, the blocks' branches in bf16; the
    target is the input's dtype; the loss leaves in f32."""
    model = mae.MaskedAutoencoderViT(compute_dtype="bfloat16",
                                     with_decoder=True, norm_pix_loss=True,
                                     **SMALL)
    seen = {}

    def hook(name):
        def record(mod, args, out):
            seen.setdefault(name, out.dtype)
        return record

    model.patch_embed.register_forward_hook(hook("patch_embed"))
    for stack in ("blocks", "decoder_blocks"):
        blk = getattr(model, stack)[0]
        blk.register_forward_hook(hook(stack))
        blk.attn.register_forward_hook(hook(f"{stack}.attn"))
        blk.adaptmlp.register_forward_hook(hook(f"{stack}.adaptmlp"))
    x = torch.from_numpy(images(2)).to(torch.bfloat16)
    with torch.no_grad():
        loss, pred, _ = model.eval().forward_pretrain(x)
    f32, bf16 = torch.float32, torch.bfloat16
    assert seen == {"patch_embed": f32, "blocks": f32, "blocks.attn": bf16,
                    "blocks.adaptmlp": bf16, "decoder_blocks": f32,
                    "decoder_blocks.attn": bf16,
                    "decoder_blocks.adaptmlp": bf16}
    assert loss.dtype == pred.dtype == f32
    assert model.patchify(x).dtype == bf16


def test_adapter_dropout_draws_in_train_mode_only():
    """The adapters drop at 0.1 (encoder and decoder) in train mode,
    reproducibly from the generator, and not in eval."""
    _, params = jax_small()
    model = port_small(params)
    for blk in [*model.blocks, *model.decoder_blocks]:
        assert blk.adaptmlp is not None
        blk.adaptmlp.dropout = 0.1
    x = torch.from_numpy(images(2))
    noise = torch.rand(2, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ev = model.eval().forward_pretrain(x, 0.75, noise)[1]
        model.train()
        a, b, c = (model.forward_pretrain(
            x, 0.75, noise, torch.Generator().manual_seed(s))[1]
            for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, ev)


def jax_shapes(name, use_adapter):
    jm = getattr(jax_mae, name)(use_adapter=use_adapter)
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(
        lambda: jm.init({"params": key, "masking": key},
                        jnp.zeros((1, 224, 224, 3)), 0.75, True))["params"]


def port_name_and_shape(path, shape):
    """A flax MAE leaf's name and shape under the MAE checkpoint's names
    (`blocks_i`/`decoder_blocks_i` → `.i`, kernels transposed, LayerNorm
    scale → weight, the adapter's down/up/ln → down_proj/up_proj/
    adapter_layer_norm_before)."""
    names = {"down": "down_proj", "up": "up_proj",
             "ln": "adapter_layer_norm_before", "scale": "weight",
             "kernel": "weight"}
    parts = [p.replace("blocks_", "blocks.") for p in path]
    if parts[-2:] == ["adaptmlp", "scale"]:
        return ".".join(parts), shape
    if parts[-1] == "kernel":
        shape = ((shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4
                 else shape[::-1])
    return ".".join(names.get(p, p) for p in parts), shape


@pytest.mark.parametrize("name", ["mae_vit_base_patch16",
                                  "mae_vit_large_patch16",
                                  "mae_vit_huge_patch14"])
def test_factories_with_the_decoder_have_the_jax_shapes(name):
    """Shapes only (the JAX side by `jax.eval_shape`, the port's on the
    meta device): the decoder adapter's bottleneck is 42 for ViT-B
    (int(64·512/768)), 32 for ViT-L, 25 for ViT-H."""
    want = dict(
        port_name_and_shape([str(p.key) for p in path], tuple(leaf.shape))
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax_shapes(name, True))[0])
    with torch.device("meta"):
        model = getattr(mae, name)(use_adapter=True, with_decoder=True)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    bottleneck = {"mae_vit_base_patch16": 42, "mae_vit_large_patch16": 32,
                  "mae_vit_huge_patch14": 25}[name]
    assert got["decoder_blocks.0.adaptmlp.down_proj.weight"] == (bottleneck,
                                                                512)
    assert tuple(model.decoder_pos_embed.shape) == (1, model.grid ** 2 + 1,
                                                    512)


def test_the_extraction_model_keeps_its_names_and_init():
    """Without `with_decoder` the state dict is the encoder's; with it,
    the encoder's init is the same from the same seed."""
    enc = mae.MaskedAutoencoderViT(seed=3, **SMALL)
    full = mae.MaskedAutoencoderViT(seed=3, with_decoder=True, **SMALL)
    sd, fsd = enc.state_dict(), full.state_dict()
    assert not any(k.startswith(("decoder", "mask_token")) for k in sd)
    for k, v in sd.items():
        assert torch.equal(fsd[k], v), k
    assert {k for k in fsd if k not in sd} >= {"mask_token",
                                               "decoder_pred.weight"}


# ---------------------------------------------------------------- augment


def jax_mae_draws(key, b, scale):
    """The draws `jaug.mae_train_augment` takes from `key`, stacked."""
    out = []
    for k in jax.random.split(key, b):
        k1, k2 = jax.random.split(k)
        c = jax.random.split(k1, 4)
        out.append({
            "area": jax.random.uniform(c[0], (), minval=scale[0],
                                       maxval=scale[1]),
            "log_ratio": jax.random.uniform(c[1], (), minval=jnp.log(3 / 4),
                                            maxval=jnp.log(4 / 3)),
            "y": jax.random.uniform(c[2], ()),
            "x": jax.random.uniform(c[3], ()),
            "flip": jax.random.bernoulli(k2, 0.5)})
    return {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in out]))
            for k in out[0]}


@pytest.mark.parametrize("raw, out, scale", [(40, 32, (0.2, 1.0)),
                                             (32, 32, (0.2, 1.0)),
                                             (48, 24, (0.001, 0.002))])
def test_mae_train_augment_matches_jax(raw, out, scale):
    """The bicubic crop from the raw size, the flip and the normalisation
    on JAX's draws; (0.001, 0.002) clips both sides to 8 px."""
    x = images(6, raw, seed=raw)
    key = jax.random.PRNGKey(raw + out)
    want = jaug.mae_train_augment(key, jnp.asarray(x), out, scale=scale)
    d = jax_mae_draws(key, 6, scale)
    got = augment.mae_train_augment(torch.from_numpy(x), None, out,
                                    draws=d)
    assert got.shape == (6, out, out, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=AUG_TOL)


def test_mae_augment_draws_and_uint8():
    """The port's own draws: in range, about half flipped, reproducible;
    a uint8 batch is the f32 batch / 255."""
    d = augment.mae_draws(torch.Generator().manual_seed(0), 4000,
                          device=torch.device("cpu"))
    assert float(d["area"].min()) >= 0.2 and float(d["area"].max()) < 1.0
    assert abs(float(d["flip"].float().mean()) - 0.5) < 0.03
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (3, 40, 40, 3), dtype=np.uint8))
    d = augment.mae_draws(torch.Generator().manual_seed(1), 3,
                          device=torch.device("cpu"))
    assert torch.equal(augment.mae_train_augment(u8, None, 32, draws=d),
                       augment.mae_train_augment(u8.float() / 255.0, None,
                                                 32, draws=d))


def test_prep_follows_jax():
    """The trainer's input at the JAX trainer's default (`use_bf16`): uint8
    → bf16 / 255 and floats cast, bit for bit; with the augment, the crop
    in f32 and the cast after it (the two f32 crops differ by ≤ 1e-5, so a
    rounding to bf16 may fall one ulp apart: ≤ 2^-7 of the largest |x|,
    2.64)."""
    u8 = np.random.default_rng(2).integers(0, 256, (3, 40, 40, 3),
                                           dtype=np.uint8)
    key = jax.random.PRNGKey(4)
    for aug in (False, True):
        jt = jtrainer.MAETrainer(jax_mae.MaskedAutoencoderViT(**SMALL),
                                 augment=aug)
        pt = mae_trainer.MAETrainer(mae.MaskedAutoencoderViT(
            with_decoder=True, **SMALL), augment=aug)
        for x in ((u8, u8 / np.float32(255)) if aug else
                  (u8[:, :32, :32], images(3))):
            prep = jax.jit(jt._prep) if aug else jt._prep
            want = np.asarray(prep(jnp.asarray(x), key), np.float32)
            got = pt.prep(torch.from_numpy(x), None,
                          jax_mae_draws(key, 3, (0.2, 1.0)))
            assert got.dtype == torch.bfloat16
            if aug:
                assert np.abs(to_np(got) - want).max() <= 2.0 ** -7 * 2.64
            else:
                np.testing.assert_array_equal(to_np(got), want)


# ------------------------------------------------------- masks, optimizer


def as_port(tree_of_bools, params):
    """A flax tree of booleans → {port name: bool}, through the bridge."""
    filled = jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32),
        tree_of_bools, params)
    out = {}
    for k, v in mae_pretrain_from_jax(filled).items():
        assert v.min() == v.max(), k
        out[k] = bool(v.flat[0])
    return out


@pytest.mark.parametrize("use_adapter, kw", [
    (True, {}), (False, {}),
    (True, dict(adapter_learnable_scale=True,
                adapter_layernorm_option="in"))])
@pytest.mark.parametrize("freeze, train_dec", [(True, False), (True, True),
                                               (False, False)])
def test_masks_match_jax(use_adapter, kw, freeze, train_dec):
    _, params = jax_small(use_adapter, **kw)
    model = port_small(params, use_adapter, **kw)
    want = as_port(jtrainer.mae_trainable_mask(params, freeze, train_dec),
                   params)
    assert mae_trainer.mae_trainable_mask(model, freeze, train_dec) == want
    assert mae_trainer.no_decay_mask(model) == as_port(
        jtrainer.no_decay_mask(params), params)
    if freeze and use_adapter:
        assert want["blocks.0.adaptmlp.down_proj.weight"]
        assert want["decoder_blocks.0.adaptmlp.up_proj.bias"]
        assert want["decoder_pred.weight"] == train_dec
    if not freeze:
        decays = mae_trainer.no_decay_mask(model)
        assert decays["cls_token"] and decays["mask_token"]
        assert not decays["norm.weight"] and not decays["decoder_embed.bias"]


def jax_moments(state, params):
    """{'exp_avg'|'exp_avg_sq': {port name: moment}} of the JAX masked
    Adam state, MaskedNodes as zeros."""
    import optax

    inner = state.inner_state[0]

    def fill(m, p):
        return (np.zeros(np.shape(p), np.float32)
                if isinstance(m, optax.MaskedNode) else np.asarray(m))

    out = {}
    for key, field in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        out[key] = mae_pretrain_from_jax(jax.tree_util.tree_map(
            fill, getattr(inner, field), params,
            is_leaf=lambda x: isinstance(x, optax.MaskedNode)))
    return out, int(inner.count)


@pytest.mark.parametrize("use_adapter, train_dec, pack", [
    (True, True, 1), (True, False, 2), (False, False, 1)])
def test_two_steps_match_jax(no_flax_dropout, use_adapter, train_dec, pack):
    """Two f32 steps (uint8 batches to bf16 / 255 on both sides, as the
    trainers' default; no augment; lr 1e-4, wd 0.05) from the
    same weights and noise: the JAX step written out as `MAETrainer.
    make_step` computes it (`jax.value_and_grad`, `trainer.tx`, the
    masked update). Loss, parameters and moments within STEP_TOL; frozen
    parameters bit for bit; the adapters (and the decoder linears where
    they train) moved; then `eval_loss` on the stepped weights. Adam's
    first steps move a parameter by about lr·sign(g) whatever |g|, so
    where a gradient element is near zero the two sides' rounding moves
    it by up to lr: the lr stays far below the weights' scale (0.02-0.2).
    At the CLI's default, without `norm_pix_loss`: under `jax.jit`, XLA
    computes the bf16 target's normalisation with excess precision (in
    f32, where the written code and the eager forward round each op to
    bf16), so a jitted JAX step and the port, which rounds as written,
    differ there by up to a bf16 ulp of the target; the forward tests hold
    `norm_pix_loss` in f32, where no rounding enters, and in bf16 at the
    bf16 tolerance."""
    lr = 1e-4
    jm, params = jax_small(use_adapter)
    jt = jtrainer.MAETrainer(jm, freeze_non_adapter=use_adapter,
                             train_decoder_linears=train_dec, img_pack=pack)
    jt.init_state(0)
    opt = jt.tx.init(params)
    trains = jtrainer.mae_trainable_mask(params, use_adapter, train_dec)
    model = port_small(params, use_adapter)
    pt = mae_trainer.MAETrainer(model, freeze_non_adapter=use_adapter,
                                train_decoder_linears=train_dec,
                                img_pack=pack)
    ps = pt.init_state()
    start = {k: v.clone() for k, v in model.state_dict().items()}

    @jax.jit
    def jax_step(params, opt, imgs, key):
        def loss_fn(p):
            loss, _, _ = jm.apply({"params": p}, imgs, 0.75, False, rng=key,
                                  pack=pack)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = jt.tx.update(grads, opt, params)
        params = jax.tree_util.tree_map(
            lambda p, u, m: jnp.where(m, p + lr * u, p), params, updates,
            trains)
        return params, opt, loss

    for i in range(2):
        u8 = np.random.default_rng(10 + i).integers(0, 256, (4, 32, 32, 3),
                                                    dtype=np.uint8)
        key = jax.random.PRNGKey(20 + i)
        params, opt, jl = jax_step(params, opt,
                                   jt._to_model_dtype(jnp.asarray(u8)), key)
        noise = torch.from_numpy(np.array(jax.random.uniform(key, (4, 16))))
        ps, pl = pt.step(ps, torch.from_numpy(u8), lr, noise=noise)
        assert abs(float(pl) - float(jl)) <= STEP_TOL * abs(float(jl)), i
    want = mae_pretrain_from_jax(jax.tree_util.tree_map(np.asarray, params))
    port_trains = mae_trainer.mae_trainable_mask(model, use_adapter,
                                                 train_dec)
    sd = model.state_dict()
    for k, v in sd.items():
        if not port_trains[k]:
            assert torch.equal(v, start[k]), k
            continue
        err = np.abs(v.numpy() - want[k])
        # every element within Adam's bound, 2·lr·steps
        assert err.max() <= 2 * lr * 2, k
        if k.endswith("attn.qkv.bias"):
            # the key projection's bias has a true gradient of 0 (the
            # softmax cancels it): both sides step it by rounding noise,
            # which Adam scales to up to lr a step
            dim = err.shape[0] // 3
            err = np.delete(err, slice(dim, 2 * dim))
        # the weights' rounding and each Adam step's direction's (a tensor
        # that starts at 0 holds only the latter)
        tight = err <= STEP_TOL * (np.abs(want[k]).max() + lr * 2)
        assert tight.mean() >= STEP_SHARE, (k, err.max(), tight.mean())
    moved = [k for k, t in port_trains.items() if t
             and not torch.equal(sd[k], start[k])]
    if use_adapter:
        assert any(k.startswith("blocks.") and "adaptmlp" in k for k in moved)
        assert any(k.startswith("decoder_blocks.") and "adaptmlp" in k
                   for k in moved)
        assert ("decoder_pred.weight" in moved) == train_dec
    else:
        assert {"cls_token", "mask_token", "blocks.0.attn.qkv.weight"} <= \
            set(moved)
    moments, count = jax_moments(opt, params)
    assert int(ps.opt_state["count"]) == count == 2 and ps.step == 2
    for key_, m in moments.items():
        assert set(ps.opt_state[key_]) == {k for k, t in port_trains.items()
                                           if t}
        for name, got in ps.opt_state[key_].items():
            assert rel(got.numpy(), m[name]) <= STEP_TOL, (key_, name)
    # eval_loss: deterministic, no pack, the JAX forward's
    u8 = np.random.default_rng(30).integers(0, 256, (4, 32, 32, 3),
                                            dtype=np.uint8)
    key = jax.random.PRNGKey(30)
    jl, _, _ = jm.apply({"params": params},
                        jt._to_model_dtype(jnp.asarray(u8)), 0.75, True,
                        rng=key)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (4, 16))))
    got = pt.eval_loss(ps, torch.from_numpy(u8), noise=noise)
    assert abs(got - float(jl)) <= STEP_TOL * abs(float(jl))


def test_weight_decay_spares_biases_and_1d():
    """All parameters trainable, wd 0 against wd 10: biases and norms take
    the same step, weights and the 3-D tokens do not."""
    def run(wd):
        model = mae.MaskedAutoencoderViT(with_decoder=True, use_adapter=False,
                                         seed=1, **SMALL)
        t = mae_trainer.MAETrainer(model, weight_decay=wd,
                                   freeze_non_adapter=False)
        s = t.init_state()
        u8 = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (2, 32, 32, 3), dtype=np.uint8))
        t.step(s, u8, 1e-2, torch.Generator().manual_seed(2))
        return model.state_dict()

    a, b = run(0.0), run(10.0)
    for k in ("norm.weight", "decoder_embed.bias", "blocks.0.norm1.bias"):
        assert torch.equal(a[k], b[k]), k
    for k in ("cls_token", "mask_token", "decoder_pred.weight",
              "patch_embed.proj.weight"):
        assert not torch.allclose(a[k], b[k]), k
