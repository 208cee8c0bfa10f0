"""The port's DINO-adapter training pieces against the JAX package's.

ViT train mode (dropouts at 0) and crop packing against the JAX
`deterministic=True` forward; `DINOHead` (both `norm_last_layer`, both
`use_bn`, flax's biased running variance); `dino_loss` and its centre;
three `DINOTrainer` steps across the last-layer freeze boundary for
adamw, sgd and LARS against the JAX `get_step`, optimizer moments and
shared count included; `eval_loss`; LARS and the layer-wise decay.

Dropout and drop-path draws cannot match across frameworks: on the JAX
side the tests replace flax's `nn.Dropout` by a pass-through (the JAX
`Block` hard-wires the adapter's 0.1) and set `drop_path_rate=0`; the
port runs with `adapter_dropout=0`. Nothing in `snuffy_tpu/` changes.
The random share is held by structure and statistics. The adapters'
up-projections (zero at init in both) are drawn non-zero. All f32.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from snuffy_tpu.models import vit as jvit
from snuffy_tpu.ssl import dino as jdino
from snuffy_tpu.ssl import lars as jlars
from snuffy_tpu_torch.bridge import (
    dino_from_jax,
    dino_head_state_dict,
    dino_student_state_dict,
    vit_from_jax,
)
from snuffy_tpu_torch.models import vit
from snuffy_tpu_torch.ssl import dino, lars

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2,
            mlp_ratio=2.0, use_adapter=True, adapter_bottleneck=4)
TRAINER = dict(out_dim=64, n_local_crops=2, local_size=16, global_size=32,
               freeze_backbone=True, head_hidden_dim=32,
               head_bottleneck_dim=16)
# a parameter or moment after 3 steps, against JAX: max |diff| within
# this share of the tensor's max |JAX| (f32 sums in other orders)
STEP_TOL = 1e-5


class PassThrough(fnn.Module):
    rate: float = 0.0
    deterministic: object = None

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", PassThrough)


def draw_up(tree, seed=5):
    """The adapters' `up` Dense drawn N(0, 0.02²) (zero at init)."""
    rng = np.random.default_rng(seed)

    def one(path, x):
        names = [str(getattr(p, "key", p)) for p in path]
        if "adaptmlp" in names and "up" in names:
            return jnp.asarray(rng.normal(size=x.shape) * 0.02, jnp.float32)
        return x

    return jax.tree_util.tree_map_with_path(one, tree)


def torch_sd(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def rel(got, want):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


# ---------------------------------------------------------------- the ViT


def jax_vit(pack_mode="masked", **kw):
    return jvit.VisionTransformer(pack_mode=pack_mode, **{**TINY, **kw})


def port_vit(**kw):
    m = vit.VisionTransformer(**{**TINY, "adapter_dropout": 0.0, **kw})
    return m


@pytest.mark.parametrize("pack, mode", [(1, "masked"), (2, "masked"),
                                        (4, "masked"), (2, "blocked"),
                                        (4, "blocked")])
def test_vit_train_mode_matches_jax(no_flax_dropout, pack, mode):
    """Train mode with every dropout at 0 equals the JAX forward at the
    same pack and pack_mode (its 'masked' runs one masked attention of
    pack·n tokens, the port folds the segments): CLS within 2e-5, the JAX
    package's own packing tolerance."""
    x = np.random.default_rng(pack).normal(size=(8, 16, 16, 3)).astype(
        np.float32)
    jm = jax_vit(mode)
    params = draw_up(jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                             True)["params"])
    want = jm.apply({"params": params}, jnp.asarray(x), False, pack=pack,
                    rngs={"dropout": jax.random.PRNGKey(1)})
    model = port_vit(pack_mode=mode)
    model.load_state_dict(torch_sd(vit_from_jax(params)), strict=True)
    model.train()
    got = model(torch.from_numpy(x), pack=pack)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError):
        model(torch.from_numpy(x[:6]), pack=4)


def test_drop_path_per_sample_and_per_segment():
    """Stochastic depth keeps a whole sample (or, packed, a whole
    segment) with probability 1 − rate, scaled by 1/(1 − rate); the keep
    rate is within 0.02 of 0.7 over 8000 draws."""
    gen = torch.Generator().manual_seed(0)
    rate, keep = 0.3, 0.7
    x = torch.ones(2000, 12, 5)
    for seg in (1, 4):
        run = vit.Run(True, gen, seg)
        y = vit.drop_path(x, rate, run).reshape(2000, seg, 12 // seg, 5)
        first = y[:, :, :1, :1]
        assert torch.equal(y, first.expand_as(y))   # one draw a segment
        kept = first[first != 0]
        assert torch.allclose(kept, torch.full_like(kept, 1 / keep))
        assert abs(float((first > 0).float().mean()) - keep) < 0.02
    assert torch.equal(vit.drop_path(x, rate, vit.Run(False, gen, 1)), x)
    assert torch.equal(vit.drop_path(x, 0.0, vit.Run(True, gen, 1)), x)


def test_dropouts_draw_in_train_mode_only():
    """Adapter dropout, drop_rate and drop-path change a train forward,
    reproducibly from the generator's seed, and leave eval alone; the
    rates follow JAX (drop-path linearly spaced over the blocks)."""
    model = vit.VisionTransformer(**{**TINY, "drop_rate": 0.1,
                                     "drop_path_rate": 0.2})
    with torch.no_grad():
        for blk in model.blocks:
            blk.adaptmlp.up_proj.weight.normal_(0, 0.02)
    assert [b.drop_path_rate for b in model.blocks] == [0.0, 0.2]
    assert model.blocks[0].adaptmlp.dropout == 0.1
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    model.eval()
    ev = model(x)
    assert torch.equal(ev, model(x, generator=torch.Generator()))
    model.train()
    a = model(x, generator=torch.Generator().manual_seed(3))
    b = model(x, generator=torch.Generator().manual_seed(3))
    c = model(x, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.allclose(a, ev)
    with pytest.raises(ValueError, match="attn_drop_rate"):
        vit.VisionTransformer(**TINY, attn_drop_rate=0.1)


@pytest.mark.parametrize("name", ["vit_tiny", "vit_small", "vit_base",
                                  "vit_large"])
def test_factories_match_jax(monkeypatch, name):
    want = getattr(jvit, name)()
    seen = {}
    monkeypatch.setattr(vit, "VisionTransformer", lambda **kw: seen.update(kw))
    getattr(vit, name)()
    assert (seen["embed_dim"], seen["depth"], seen["num_heads"]) == (
        want.embed_dim, want.depth, want.num_heads)


def test_lora_down_init_is_jaxs_distribution():
    w = torch.empty(4000, 96)
    vit.lora_down_init(w, torch.Generator().manual_seed(0))
    k = np.asarray(jvit.lora_down_init(jax.random.PRNGKey(0), (96, 4000)))
    for t in (w.numpy(), k):
        assert abs(t.std() - (3 * 96) ** -0.5) < 1e-3 and abs(t.mean()) < 1e-3


# --------------------------------------------------------------- the head


@pytest.mark.parametrize("norm_last_layer", [True, False])
@pytest.mark.parametrize("use_bn", [False, True])
def test_dino_head_matches_jax(norm_last_layer, use_bn):
    """The head in eval (running averages) and train mode (batch stats;
    the running mean and the BIASED running variance moved as flax moves
    them) against the JAX head, within 1e-5 of max |out|."""
    jh = jvit.DINOHead(out_dim=64, hidden_dim=32, bottleneck_dim=16,
                       use_bn=use_bn, norm_last_layer=norm_last_layer)
    x = np.random.default_rng(0).normal(size=(12, 32)).astype(np.float32)
    variables = jh.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = dict(variables["params"])
    if not norm_last_layer:
        params["last_layer_g"] = jnp.asarray(
            np.random.default_rng(1).uniform(0.5, 1.5, 64), jnp.float32)
    stats = variables.get("batch_stats", {})
    head = vit.DINOHead(32, 64, 32, 16, use_bn=use_bn,
                        norm_last_layer=norm_last_layer)
    head.load_state_dict(torch_sd(dino_head_state_dict(params, stats)),
                         strict=True)
    head.eval()
    want = jh.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x))
    assert rel(head(torch.from_numpy(x)).detach().numpy(), want) < 1e-5
    if use_bn:
        want, mut = jh.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x), True, mutable=["batch_stats"])
        head.train()
        got = head(torch.from_numpy(x))
        assert rel(got.detach().numpy(), want) < 1e-5
        new = dino_head_state_dict(params, mut["batch_stats"])
        for k, v in head.state_dict().items():
            if "running" in k:
                assert rel(v.numpy(), new[k]) < 1e-6, k


def test_batchnorm_running_variance_is_biased():
    """flax's BatchNorm moves its running variance toward the biased
    batch variance (torch's BatchNorm1d takes the unbiased one)."""
    x = torch.randn(8, 5, generator=torch.Generator().manual_seed(0))
    bn = vit.BatchNorm(5).train()
    bn(x)
    biased = x.var(dim=0, unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               (0.9 + 0.1 * biased).numpy(), rtol=1e-6)
    ref = torch.nn.BatchNorm1d(5, momentum=0.1).train()
    ref(x)
    assert not torch.allclose(ref.running_var, bn.running_var, rtol=1e-4)


# ------------------------------------------------------- loss and trainer


def jax_trainer(**kw):
    return jdino.DINOTrainer(jax_vit(), **{**TRAINER, **kw})


def port_trainer(**kw):
    return dino.DINOTrainer(port_vit(), **{**TRAINER, **kw})


def same_start(jt, pt, seed=0):
    """A JAX state (adapters' up drawn) and the port's state holding its
    weights (`bridge.dino_from_jax`)."""
    js = jt.init_state(seed)
    student = draw_up(js.student)
    js = js._replace(student=student,
                     teacher=jax.tree_util.tree_map(jnp.copy, student))
    ps = pt.init_state(seed)
    w = dino_from_jax(js)
    ps.student.load_state_dict(torch_sd(w["student"]), strict=True)
    ps.teacher.load_state_dict(torch_sd(w["teacher"]), strict=True)
    ps.center = torch.from_numpy(w["center"])
    return js, ps


def crops(seed, b=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, b, 32, 32, 3)).astype(np.float32),
            rng.normal(size=(2, b, 16, 16, 3)).astype(np.float32))


def test_dino_loss_and_center_match_jax():
    jt, pt = jax_trainer(), port_trainer()
    rng = np.random.default_rng(0)
    s = rng.normal(size=(4, 3, 64)).astype(np.float32)
    t = rng.normal(size=(2, 3, 64)).astype(np.float32)
    c = rng.normal(size=(1, 64)).astype(np.float32) * 0.1
    for temp in (0.04, 0.07):
        want, want_c = jt.dino_loss(jnp.asarray(s), jnp.asarray(t),
                                    jnp.asarray(c), temp)
        got, got_c = pt.dino_loss(torch.from_numpy(s), torch.from_numpy(t),
                                  torch.from_numpy(c), temp)
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
        assert rel(got_c.numpy(), want_c) < 1e-6
    assert [pt.teacher_temp_at(e) for e in (0, 5, 10)] == [
        jt.teacher_temp_at(e) for e in (0, 5, 10)]


def jax_moments(opt, js):
    """{port moment key: JAX tree, MaskedNodes as zeros} of the JAX
    optimizer state."""
    inner = js.opt_state.inner_state[0]
    fields = {"adamw": (("exp_avg", "mu"), ("exp_avg_sq", "nu")),
              "sgd": (("momentum_buffer", "trace"),),
              "lars": (("momentum_buffer", "momentum"),)}[opt]

    def fill(m, p):
        return (np.zeros(p.shape, np.float32)
                if isinstance(m, optax.MaskedNode) else np.asarray(m))

    out = {}
    for key, field in fields:
        tree = jax.tree_util.tree_map(
            fill, getattr(inner, field), js.student,
            is_leaf=lambda x: isinstance(x, optax.MaskedNode))
        out[key] = dino_student_state_dict(tree)
    return out


def compare_states(js, ps, skip=(), tol=STEP_TOL):
    w = dino_from_jax(js)
    for part in ("student", "teacher"):
        sd = getattr(ps, part).state_dict()
        for k, v in w[part].items():
            if k.endswith("num_batches_tracked") or k in skip:
                continue
            assert rel(sd[k].numpy(), v) <= tol, (part, k, rel(sd[k], v))
    assert rel(ps.center.numpy(), w["center"]) <= tol


@pytest.mark.parametrize("opt, lr", [("adamw", 1e-3), ("sgd", 1e-2),
                                     ("lars", 1e-1)])
def test_three_steps_across_the_freeze_match_jax(no_flax_dropout, opt, lr):
    """Steps 1-2 cancel the last layer (the freeze epochs), step 3 does
    not: loss, student, teacher, centre, every moment and the shared
    count against the JAX step. adamw at lr 1e-3: where an Adam gradient
    element is near zero, f32 noise in it moves the step by up to lr, so
    the lr stays below the weights' scale (0.02-0.05)."""
    jt, pt = jax_trainer(optimizer=opt), port_trainer(optimizer=opt)
    js, ps = same_start(jt, pt)
    v0 = ps.student.state_dict()["head.last_layer.weight_v"].clone()
    step = jt.get_step()
    for i, cancel in enumerate((True, True, False)):
        g, loc = crops(i)
        js, jl = step(js, jnp.asarray(g), jnp.asarray(loc),
                      jnp.asarray(lr, jnp.float32),
                      jnp.asarray(0.04, jnp.float32),
                      jnp.asarray(0.99, jnp.float32),
                      jnp.asarray(0.04, jnp.float32), jnp.asarray(cancel),
                      jax.random.PRNGKey(i))
        ps, pl = pt.step(ps, torch.from_numpy(g), torch.from_numpy(loc), lr,
                         0.04, 0.99, 0.04, cancel)
        assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl)), i
        v = ps.student.state_dict()["head.last_layer.weight_v"]
        assert torch.equal(v, v0) == cancel, i
    compare_states(js, ps)
    for key, sd in jax_moments(opt, js).items():
        for name, got in ps.opt_state[key].items():
            assert rel(got.numpy(), sd[name]) <= STEP_TOL, (key, name)
    if opt == "adamw":
        assert int(ps.opt_state["count"]) == int(
            js.opt_state.inner_state[0].count) == 3
    assert ps.step == int(js.step) == 3


def test_use_bn_in_head_step_and_eval_loss_match_jax(no_flax_dropout):
    """With BatchNorm in the head: two steps (adamw), both networks'
    running statistics, and `eval_loss` on running averages. The Linear
    biases before each BatchNorm have a true gradient of 0 (the norm
    subtracts the batch mean): both sides update them by rounding noise,
    which Adam scales to up to lr a step, so they are held to 2·lr·steps
    and the running means (which carry them) to that plus 1e-5 of their
    scale."""
    lr = 1e-3
    jt, pt = jax_trainer(use_bn_in_head=True), port_trainer(
        use_bn_in_head=True)
    js, ps = same_start(jt, pt)
    step = jt.get_step()
    for i in range(2):
        g, loc = crops(10 + i)
        js, jl = step(js, jnp.asarray(g), jnp.asarray(loc),
                      jnp.asarray(lr, jnp.float32),
                      jnp.asarray(0.04, jnp.float32),
                      jnp.asarray(0.99, jnp.float32),
                      jnp.asarray(0.04, jnp.float32), jnp.asarray(i == 0),
                      jax.random.PRNGKey(i))
        ps, pl = pt.step(ps, torch.from_numpy(g), torch.from_numpy(loc), lr,
                         0.04, 0.99, 0.04, i == 0)
        assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    noisy = [f"head.mlp.{i}.bias" for i in (0, 3)]
    stats = [f"head.mlp.{i}.running_mean" for i in (1, 4)]
    compare_states(js, ps, skip=noisy + stats, tol=2e-5)
    w = dino_from_jax(js)
    bound = 2 * lr * 2
    for part in ("student", "teacher"):
        sd = getattr(ps, part).state_dict()
        for k in noisy:
            assert np.abs(sd[k].numpy() - w[part][k]).max() <= bound
        for k in stats:
            scale = np.abs(w[part][k]).max()
            assert np.abs(sd[k].numpy() - w[part][k]).max() <= \
                bound + 1e-5 * scale
    # eval_loss on the JAX state's weights and running statistics (in
    # eval mode the noisy biases pass the norms uncancelled, and the
    # teacher's 0.04 temperature sharpens what they move)
    g, loc = crops(20)
    w = dino_from_jax(js)
    ps.student.load_state_dict(torch_sd(w["student"]))
    ps.teacher.load_state_dict(torch_sd(w["teacher"]))
    want = jt.eval_loss(js, jnp.asarray(g), jnp.asarray(loc), 0.04)
    got = pt.eval_loss(ps, torch.from_numpy(g), torch.from_numpy(loc), 0.04)
    assert abs(got - want) <= 1e-5 * abs(want)


def test_eval_loss_matches_jax(no_flax_dropout):
    jt, pt = jax_trainer(), port_trainer()
    js, ps = same_start(jt, pt)
    g, loc = crops(3, b=4)
    want = jt.eval_loss(js, jnp.asarray(g), jnp.asarray(loc), 0.05)
    got = pt.eval_loss(ps, torch.from_numpy(g), torch.from_numpy(loc), 0.05)
    assert abs(got - want) <= 1e-5 * abs(want)
    packed = port_trainer(crop_pack=2)
    ps2 = packed.init_state(0)
    ps2.student.load_state_dict(ps.student.state_dict())
    ps2.teacher.load_state_dict(ps.teacher.state_dict())
    got2 = packed.eval_loss(ps2, torch.from_numpy(g), torch.from_numpy(loc),
                            0.05)
    assert abs(got2 - got) <= 1e-5 * abs(got)


def test_adam_count_is_shared_and_moments_decay_through_the_freeze():
    """optax's masked Adam: two cancelled steps (zero gradients) then
    g = 1 give −0.6388 (the moments decayed, the shared count at 3), not
    a fresh Adam's −1.0 (torch.optim with grad=None skips the parameter)."""
    pt = port_trainer()
    p = torch.nn.Parameter(torch.zeros(1))
    opt = {"count": torch.zeros((), dtype=torch.int32),
           "exp_avg": {"w": torch.zeros(1)},
           "exp_avg_sq": {"w": torch.zeros(1)}}
    tx = optax.scale_by_adam()
    state = tx.init(jnp.zeros(1))
    for g in (0.0, 0.0, 1.0):
        d = pt._directions(opt, ["w"], [("w", p)], [torch.tensor([g])], [1])
        u, state = tx.update(jnp.asarray([g]), state)
    assert float(-d[0]) == pytest.approx(-0.6388, abs=1e-4)
    assert float(d[0]) == pytest.approx(float(u[0]), rel=1e-6)
    assert int(opt["count"]) == int(state.count) == 3
    fresh = torch.optim.Adam([p], lr=1.0)
    p.grad = torch.ones(1)
    fresh.step()
    assert float(p.detach()) == pytest.approx(-1.0, abs=1e-6)


def test_weight_decay_exempts_1d_params_and_weight_g():
    """adamw with norm_last_layer=False at wd 0 and 10: biases and
    `last_layer.weight_g` (1-D in the JAX tree, (out, 1) here) take the
    same step, 2-D weights do not."""
    def run(wd):
        pt = port_trainer(norm_last_layer=False)
        ps = pt.init_state(0)
        g, loc = crops(5)
        pt.step(ps, torch.from_numpy(g), torch.from_numpy(loc), 1e-2, wd,
                0.99, 0.04, False, torch.Generator().manual_seed(6))
        return ps.student.state_dict()

    a, b = run(0.0), run(10.0)
    assert torch.equal(a["head.last_layer.weight_g"],
                       b["head.last_layer.weight_g"])
    assert torch.equal(a["head.mlp.0.bias"], b["head.mlp.0.bias"])
    assert not torch.allclose(a["head.mlp.0.weight"], b["head.mlp.0.weight"])


def test_trainable_mask_and_frozen_backbone():
    """Only the adapters and the head train (the JAX mask); a fixed g
    never does; the frozen backbone is bit for bit unchanged by a step,
    and the teacher moves toward the student."""
    pt = port_trainer()
    ps = pt.init_state(0)
    names = [n for n, _ in pt.trainable_params(ps.student)]
    assert all("adaptmlp" in n or n.startswith("head.") for n in names)
    assert "head.last_layer.weight_g" not in names
    for n, p in ps.student.named_parameters():
        assert p.requires_grad == (n in names)
        assert dino.is_trainable(n, True) == (
            jdino.is_trainable_path(tuple(n.split(".")), True))
    before = copy.deepcopy(ps.student.state_dict())
    t_before = copy.deepcopy(ps.teacher.state_dict())
    g, loc = crops(7)
    pt.step(ps, torch.from_numpy(g), torch.from_numpy(loc), 1e-2, 0.04,
            0.99, 0.04, False, torch.Generator().manual_seed(1))
    after = ps.student.state_dict()
    for k, v in before.items():
        if k in names:
            continue
        assert torch.equal(after[k], v), k
    assert any(not torch.equal(after[k], before[k]) for k in names
               if "adaptmlp" in k)
    t_after = ps.teacher.state_dict()
    assert any(not torch.equal(t_after[k], t_before[k]) for k in names)
    assert not torch.equal(ps.center, torch.zeros_like(ps.center))
    with pytest.raises(KeyError):
        port_trainer(optimizer="lamb")


# ------------------------------------------------------------------ LARS


@pytest.mark.parametrize("shape", [(7,), (5, 3), (2, 3, 4)])
def test_lars_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    p, g, m = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    tx = jlars.lars(momentum=0.9, weight_decay=0.05)
    state = jlars.LarsState(jnp.asarray(m))
    want, _ = tx.update(jnp.asarray(g), state, jnp.asarray(p))
    got = lars.lars_direction(torch.from_numpy(g), torch.from_numpy(m),
                              torch.from_numpy(p), len(shape), 0.9, 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_layerwise_decay_matches_jax():
    params = jax.eval_shape(
        lambda: jax_vit().init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)), True))["params"]
    want = jlars.layerwise_lr_decay_mask(params, 2, 0.75)
    names = list(port_vit().state_dict())
    got = lars.layerwise_lr_decay_mask(names, 2, 0.75)
    by_top = {}          # each top-level flax module's factor
    for path, f in jax.tree_util.tree_flatten_with_path(want)[0]:
        by_top.setdefault(path[0].key, set()).add(float(f))
    for k in names:
        parts = k.split(".")
        top = f"blocks_{parts[1]}" if parts[0] == "blocks" else parts[0]
        (factor,) = by_top[top]
        assert got[k] == pytest.approx(factor), k
    ups = lars.scale_by_layerwise_lr({k: torch.ones(1) for k in names}, got)
    assert float(ups["blocks.0.attn.qkv.weight"]) == pytest.approx(0.75)
    for jax_path, torch_name in ((("blocks_1", "mlp"), "blocks.1.mlp"),
                                 (("cls_token",), "cls_token"),
                                 (("norm",), "norm")):
        assert lars.vit_layer_id(jax_path, 2) == jlars.vit_layer_id(
            jax_path, 2) == lars.vit_layer_id(torch_name.split("."), 2)
