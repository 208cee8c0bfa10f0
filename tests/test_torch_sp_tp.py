"""The port's sequence and tensor parallelism, remat and sharded
checkpoints in one process, against the JAX package on its 8 virtual CPU
devices (the patterns of tests/test_parallel.py:269,301,464,505,636,717).

  * each sp and tp op: every shard's local part run here (the port's
    `*_local` functions, no collective), summed over sp and stacked over
    tp, against the JAX op on an sp or tp mesh with the Pallas kernel in
    interpret mode, at dropout rates 0 and 0.3 from the same int32 seed:
    the dropout masks agree bit for bit (a differing mask moves the
    output far past the tolerance);
  * the one-rank port MILNet's forward and parameter gradients at ρ = 0
    against `build_milnet(cfg, mesh=sp or tp mesh)`, and with remat
    against JAX's `cfg.remat=True` model; remat bitwise the model without
    it, dropout on;
  * one step of the port's bag loop (the form the sp/tp step takes on a
    rank) against JAX's sharded step on a dp=2 × sp=2 × tp=2 mesh;
  * the mesh layout and the trainer's `use_mesh=1` rule; the packed×sp
    and packed×tp refusals with JAX's messages; the tp rules held to
    JAX's `_TP_RULES`;
  * the checkpoint manager keeping the steps orbax's keeps, and a save →
    restore round trip.

The same steps over 2 and 4 real ranks are tests/test_torch_multiproc_mesh.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from snuffy_tpu.configs import MILTrainConfig as JaxMILTrainConfig
from snuffy_tpu.configs import OptimizerConfig as JaxOptimizerConfig
from snuffy_tpu.configs import SnuffyModelConfig as JaxModel
from snuffy_tpu.parallel import mesh as jax_mesh
from snuffy_tpu_torch import configs
from snuffy_tpu_torch.bridge import milnet_from_jax, milnet_state_dict
from snuffy_tpu_torch.models.snuffy import MILNet
from snuffy_tpu_torch.parallel import distributed, sharded_train
from snuffy_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    coordinates,
    factor_devices,
    make_mesh,
)
from snuffy_tpu_torch.parallel.sp_attention import (
    owned_rows,
    scatter_owned_rows,
    sp_attention_local,
)
from snuffy_tpu_torch.parallel.tp_attention import (
    tp_fused_inverted_sparse_attention,
)
from snuffy_tpu_torch.train import trainer as trainer_mod
from snuffy_tpu_torch.train.trainer import SnuffyTrainer

F32_TOL = dict(rtol=1e-5, atol=1e-6)


def jmesh(dp=1, sp=1, tp=1):
    return jax_mesh.make_mesh(jax_mesh.MeshSpec(dp, sp, tp))


def tp_mesh(tp=2):
    """A mesh of the tp axis alone: the JAX tp op's shard_map names only
    "tp" manual, which a mesh with other axes refuses outside the dp-manual
    region of the sharded step (tests/test_parallel.py:301 builds it so)."""
    from jax.sharding import Mesh as JaxMesh

    return JaxMesh(np.asarray(jax.devices()[:tp]).reshape(tp), ("tp",))


def attention_inputs(h=4, n=128, s=16, dk=8, seed=0):
    rng = np.random.default_rng(seed)
    q, v = (rng.standard_normal((h, n, dk)).astype(np.float32)
            for _ in range(2))
    k = rng.standard_normal((h, s, dk)).astype(np.float32)
    return q, k, v, np.arange(s) < 12, np.arange(n) < 100


# ------------------------------------------------------------- the ops

@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_sp_attention_shards_match_the_jax_op(rate, tp):
    """sp = 2 (× tp): K1's plain version on each shard's rows and heads
    with seed + sp·7919 (+ tp·104729), summed over sp, against the JAX
    shard_map op (Pallas, interpret mode)."""
    from snuffy_tpu.parallel.sp_attention import sp_inverted_sparse_attention

    q, k, v, sv, qv = attention_inputs()
    key = jax.random.PRNGKey(3)
    want = np.asarray(sp_inverted_sparse_attention(
        *map(jnp.asarray, (q, k, v, sv, qv)), jmesh(sp=2, tp=tp),
        use_pallas=True, tile_n=32, dropout_rate=rate,
        dropout_rng=key if rate else None))
    # the JAX op's int32 seed, drawn from its key as it draws it
    seed = int(jax.random.randint(key, (), 0, 2**30 - 1, dtype=jnp.int32))
    h, n = q.shape[0] // tp, q.shape[1] // 2
    heads = []
    for t in range(tp):
        hs = slice(t * h, (t + 1) * h)
        parts = [sp_attention_local(
            *(torch.from_numpy(a[hs, s * n:(s + 1) * n])
              for a in (q,)), torch.from_numpy(k[hs]),
            torch.from_numpy(v[hs, s * n:(s + 1) * n]),
            torch.from_numpy(sv), torch.from_numpy(qv[s * n:(s + 1) * n]),
            sp_index=s, tp_index=t if tp > 1 else None, dropout_rate=rate,
            dropout_seed=seed) for s in range(2)]
        heads.append(parts[0] + parts[1])
    np.testing.assert_allclose(torch.cat(heads).numpy(), want, **F32_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_tp_attention_shards_match_the_jax_op(rate):
    """tp = 2: each shard's heads with seed + first_head·C3 against the
    JAX head-sharded op, and so against the one-device kernel."""
    from snuffy_tpu.ops.pallas_attention import fused_inverted_sparse_attention
    from snuffy_tpu.parallel.tp_attention import (
        tp_fused_inverted_sparse_attention as jax_tp,
    )

    q, k, v, sv, qv = attention_inputs(seed=1)
    seed = jnp.asarray(1234, jnp.int32)
    args = tuple(map(jnp.asarray, (q, k, v, sv, qv)))
    want = np.asarray(jax_tp(*args, tp_mesh(), dropout_rate=rate,
                             dropout_seed=seed, tile_n=64))
    whole = np.asarray(fused_inverted_sparse_attention(
        *args, dropout_rate=rate, dropout_seed=seed, tile_n=64))
    np.testing.assert_array_equal(want, whole)
    got = torch.cat([tp_fused_inverted_sparse_attention(
        *(torch.from_numpy(a[2 * t:2 * t + 2]) for a in (q, k, v)),
        torch.from_numpy(sv), torch.from_numpy(qv), t, dropout_rate=rate,
        dropout_seed=1234) for t in range(2)])
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_sp_gather_and_scatter_rows_match_the_jax_ops():
    from snuffy_tpu.parallel.sp_attention import (
        sp_gather_rows,
        sp_scatter_rows,
    )

    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    idx = rng.permutation(64)[:10].astype(np.int32)
    valid = np.arange(10) < 8
    rows = rng.standard_normal((10, 8)).astype(np.float32)
    mesh = jmesh(sp=2)
    want_g = np.asarray(sp_gather_rows(jnp.asarray(x), jnp.asarray(idx),
                                       mesh))
    want_s = np.asarray(sp_scatter_rows(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(valid),
        jnp.asarray(rows), mesh))
    ti = torch.from_numpy(idx.astype(np.int64))
    blocks = [torch.from_numpy(x[32 * s:32 * (s + 1)]) for s in range(2)]
    got_g = sum(owned_rows(b, ti, s) for s, b in enumerate(blocks))
    got_s = torch.cat([scatter_owned_rows(b, ti, torch.from_numpy(valid),
                                          torch.from_numpy(rows), s)
                       for s, b in enumerate(blocks)])
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


# ------------------------------------------------------------- the model

def jax_cfg(**kw):
    base = dict(feats_size=16, num_classes=1, num_heads=2, big_lambda=8,
                random_patch_share=0.0, attention_dropout=0.0, depth=2,
                use_pallas=True, pallas_tile_n=32)
    base.update(kw)
    return JaxModel(**base)


def port_cfg(cfg):
    return configs.SnuffyModelConfig(**dataclasses.asdict(cfg))


def model_fixtures(cfg, n=64, n_valid=50):
    from snuffy_tpu.models.snuffy import init_milnet_params

    params = init_milnet_params(cfg, seed=0, n_example=n)
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((n, cfg.feats_size)).astype(np.float32)
    return params, feats, np.arange(n) < n_valid


def jax_loss_and_grads(cfg, params, feats, mask, mesh=None):
    from snuffy_tpu.models.snuffy import build_milnet

    model = build_milnet(cfg, mesh=mesh)
    key = jax.random.PRNGKey(7)

    def loss(p, f, m):
        ins, bag, _ = model.apply({"params": p}, f, m, True,
                                  rngs={"sparse": key})
        return jnp.mean(bag) + jnp.mean(jnp.tanh(ins)), (ins, bag)

    f, m = jnp.asarray(feats), jnp.asarray(mask)
    if mesh is not None and mesh.shape.get("sp", 1) > 1:
        f = jax.device_put(f, NamedSharding(mesh, P("sp", None)))
        m = jax.device_put(m, NamedSharding(mesh, P("sp")))
    (val, (ins, bag)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params, f, m)
    return (float(val), np.asarray(ins), np.asarray(bag),
            milnet_state_dict(jax.device_get(grads)))


def port_loss_and_grads(cfg, params, feats, mask, train=False, gens=None):
    model = milnet_from_jax(params, port_cfg(cfg), device="cpu")
    model.train(train)
    gens = gens or (None, None)
    ins, bag = model(torch.from_numpy(feats), torch.from_numpy(mask),
                     generator=gens[0], seed_generator=gens[1])
    loss = bag.mean() + torch.tanh(ins).mean()
    loss.backward()
    return (float(loss.detach()), ins.detach().numpy(),
            bag.detach().numpy(),
            {n: p.grad.numpy() for n, p in model.named_parameters()})


def held_to(got, want, grad_tol=1e-5):
    """Loss, instance and bag logits within f32 rounding; each gradient
    within grad_tol of the largest |g| (wk's bias has a true gradient of
    0: only noise lives there)."""
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)
    scale = max(np.abs(g).max() for g in want[3].values())
    for name, g in want[3].items():
        assert np.abs(got[3][name] - g).max() <= grad_tol * scale, name


@pytest.mark.parametrize("axis", ["sp", "tp"])
def test_model_forward_and_gradients_match_the_jax_mesh_model(axis):
    """ρ = 0: the one-rank port MILNet against the JAX MILNet built with
    an sp or tp mesh (Pallas in interpret mode)."""
    cfg = jax_cfg()
    params, feats, mask = model_fixtures(cfg)
    mesh = jmesh(sp=2) if axis == "sp" else tp_mesh()
    want = jax_loss_and_grads(cfg, params, feats, mask, mesh)
    held_to(port_loss_and_grads(cfg, params, feats, mask), want)


def test_remat_gradients_match_the_jax_remat_model():
    cfg = jax_cfg(remat=True)
    params, feats, mask = model_fixtures(cfg)
    want = jax_loss_and_grads(cfg, params, feats, mask)
    held_to(port_loss_and_grads(cfg, params, feats, mask, train=True),
            want)


@pytest.mark.parametrize("multiclass", [False, True])
def test_remat_is_bitwise_the_model_without_it(multiclass):
    """Dropout on (ρ = 0.5, attention and encoder dropout 0.1): the
    recompute draws the first run's selection, seeds and masks."""
    base = dict(random_patch_share=0.5, attention_dropout=0.1,
                encoder_dropout=0.1, multiclass=multiclass,
                num_classes=2 if multiclass else 1)
    out = []
    for remat in (False, True):
        cfg = jax_cfg(remat=remat, **base)
        params, feats, mask = model_fixtures(jax_cfg(**base))
        gens = (torch.Generator().manual_seed(1),
                torch.Generator().manual_seed(2))
        out.append(port_loss_and_grads(cfg, params, feats, mask, True, gens))
    (l0, i0, b0, g0), (l1, i1, b1, g1) = out
    assert l0 == l1
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(b0, b1)
    for name in g0:
        np.testing.assert_array_equal(g0[name], g1[name], err_msg=name)


def to_port_train(cfg):
    d = dataclasses.asdict(cfg)
    return configs.MILTrainConfig(
        **{**d, "model": configs.SnuffyModelConfig(**d["model"]),
           "optim": configs.OptimizerConfig(**d["optim"])})


def test_bag_loop_step_matches_the_jax_sp_tp_step():
    """8 bags, one optimizer step: the port's bag loop on one rank (one
    bag a forward, the gradients accumulated: the form of the sp/tp step
    on each rank) against the JAX sharded step on dp=2 × sp=2 × tp=2,
    f32, ρ = 0, no dropout: losses, bag and instance scores, parameters
    and w."""
    from snuffy_tpu.parallel.sharded_train import (
        make_sharded_batch_train_step as jax_step,
    )
    from snuffy_tpu.parallel.sharded_train import shard_state
    from snuffy_tpu.train.trainer import SnuffyTrainer as JaxTrainer

    lr = 1e-3
    jcfg = JaxMILTrainConfig(
        model=jax_cfg(depth=1), soft_average=True, bag_batch_size=8,
        use_mesh=0,
        optim=JaxOptimizerConfig(optimizer="adamw", lr=lr,
                                 weight_decay=5e-2, clip_grad=0.05))
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((8, 64, 16)).astype(np.float32)
    masks = np.arange(64)[None] < rng.integers(40, 65, 8)[:, None]
    labels = rng.integers(0, 2, (8, 1)).astype(np.float32)
    bag_w = np.ones(8, np.float32)
    jt = JaxTrainer(jcfg)
    mesh = jmesh(2, 2, 2)
    start = jt.init_state(0, example_n=64)
    pcfg = to_port_train(jcfg)
    tt = SnuffyTrainer(pcfg, "cpu", model=milnet_from_jax(
        start.params, pcfg.model, device="cpu"), w=float(start.w))
    with mesh:   # the step donates the state
        state = shard_state(start, mesh)
        state, *want = jax_step(jt, mesh)(
            state, feats, masks, labels, bag_w, np.float32(lr),
            jax.random.PRNGKey(7))
    tt.model.train()
    tt.set_lr(lr)
    got = tt.bag_loop_train_step(
        torch.from_numpy(feats), torch.from_numpy(masks),
        torch.from_numpy(labels), torch.from_numpy(bag_w),
        torch.Generator(), torch.Generator())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(
            g.shape), rtol=1e-5, atol=1e-6)
    end = milnet_state_dict(jax.device_get(state.params))
    for name, p in tt.model.state_dict().items():
        # Adam's first step is about lr·sign(g): elements of g near zero
        # flip with the rounding, so each within 2·lr, most within 1e-5
        diff = np.abs(p.numpy() - end[name])
        assert diff.max() <= 2 * lr, name
        assert (diff <= 1e-5 * (1 + np.abs(end[name]))).mean() >= 0.99, name
    np.testing.assert_allclose(tt.w.item(), float(state.w), rtol=1e-6)


# ------------------------------------------------------ mesh and rules

@pytest.mark.parametrize("spec", [MeshSpec(1, 2, 1), MeshSpec(1, 1, 2),
                                  MeshSpec(2, 2, 2, dcn=2)])
def test_ranks_lay_out_as_the_jax_devices(spec):
    """Rank r's (batch, sp, tp) coordinates are the position of device r
    in the JAX mesh's reshape(dcn, dp, sp, tp); make_mesh refuses a spec
    that is not the world."""
    grid = np.arange(spec.n_devices).reshape(spec.dcn, spec.dp, spec.sp,
                                             spec.tp)
    for r in range(spec.n_devices):
        c, dp, s, t = (int(i[0]) for i in np.nonzero(grid == r))
        assert coordinates(r, spec) == (c * spec.dp + dp, s, t)
    with pytest.raises(ValueError, match="1 rank"):
        make_mesh(spec)
    with pytest.raises(ValueError, match="does not divide num_heads"):
        make_mesh(MeshSpec(1, 1, 2), num_heads=3)


def test_mesh_axes_and_batch_blocks():
    """A mesh's axes; its block of a batch is the block of its batch-axis
    index among the batch axes' extent, not the world's."""
    mesh = Mesh("g", 1, 2, "s", 1, 2, "t", 0, 2)
    assert mesh.axis("batch") == ("g", 2, 1)
    assert mesh.axis("sp") == ("s", 2, 1)
    assert mesh.axis("tp") == ("t", 2, 0)
    assert distributed.process_batch_slice(8, mesh.rank, mesh.size) == \
        slice(4, 8)
    with pytest.raises(ValueError, match="not divisible by 2"):
        distributed.process_batch_slice(7, mesh.rank, mesh.size)
    with pytest.raises(ValueError, match="no mesh axis"):
        mesh.axis("dp")


def test_use_mesh_1_builds_the_factoring(monkeypatch):
    """use_mesh=1: factor_devices(world, hosts), the hosts from torchrun's
    LOCAL_WORLD_SIZE, with JAX's divisibility error."""
    cfg = configs.MILTrainConfig(bag_batch_size=4, use_mesh=1)
    made = []
    monkeypatch.setattr(trainer_mod, "make_mesh",
                        lambda spec, **kw: made.append((spec, kw)) or "m")
    monkeypatch.setattr(distributed, "world_size", lambda: 8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert trainer_mod._maybe_mesh(cfg) == "m"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    trainer_mod._maybe_mesh(cfg)
    assert [m[0] for m in made] == [factor_devices(8, 1),
                                    factor_devices(8, 2)]
    assert made[0][1] == dict(
        num_heads=cfg.model.num_heads,
        mlp_hidden=cfg.model.feats_size * cfg.model.mlp_multiplier)
    with pytest.raises(ValueError, match="must divide over the batch axes"):
        trainer_mod._maybe_mesh(dataclasses.replace(cfg, bag_batch_size=3))


@pytest.mark.parametrize("axis", ["sp", "tp"])
def test_packed_bags_refuse_sp_and_tp_with_the_jax_messages(axis):
    from snuffy_tpu.models.snuffy import build_milnet

    cfg = jax_cfg()
    spec = (1, 2, 1) if axis == "sp" else (1, 1, 2)
    with pytest.raises(NotImplementedError) as jax_err:
        build_milnet(cfg, mesh=jmesh(sp=2) if axis == "sp" else tp_mesh(),
                     segments=2).init(
            {"params": jax.random.PRNGKey(0),
             "sparse": jax.random.PRNGKey(1)},
            jnp.zeros((64, 16)), jnp.ones(64, bool), True)
    mesh = Mesh(None, 0, 1, None, 0, spec[1], None, 0, spec[2])
    model = MILNet(port_cfg(cfg))
    model.mesh = mesh     # tp's blocks are not needed to refuse
    with pytest.raises(NotImplementedError) as port_err:
        model(torch.zeros(64, 16), segments=2)
    assert str(port_err.value) == str(jax_err.value)


def test_tp_rules_are_the_jax_rules():
    """Each rule of the JAX `_TP_RULES` (flax path suffix, the kernel's
    (in, out) axis over tp) is one of the port's (torch name, the
    weight's (out, in) dim), and nothing else splits."""
    from snuffy_tpu.parallel.sharded_train import _TP_RULES

    module = {"wq": "self_attn.linears.0", "wk": "self_attn.linears.1",
              "wv": "self_attn.linears.2", "wo": "self_attn.linears.3",
              "w1": "feed_forward.w_1", "w2": "feed_forward.w_2"}
    want = set()
    for (_, mod, leaf), spec in _TP_RULES:
        if leaf == "kernel":
            want.add((f"{module[mod]}.weight", 0 if spec[1] == "tp" else 1))
        else:
            want.add((f"{module[mod]}.bias", 0))
    assert set(sharded_train.TP_RULES) == want


def test_tp_state_shards_and_gathers_back():
    sd = MILNet(port_cfg(jax_cfg())).state_dict()
    parts = [sharded_train.shard_state(sd, Mesh(None, 0, 1, None, 0, 1,
                                                None, t, 2))
             for t in range(2)]
    for name, v in sd.items():
        dim = sharded_train.tp_dim(name)
        if dim is None:
            assert all(p[name] is v for p in parts)
        else:
            assert torch.equal(torch.cat([p[name] for p in parts], dim), v)


# ---------------------------------------------------------- checkpoints

SAVES = [(0, 0.5), (1, 0.9), (2, 0.1), (3, None), (4, 0.7), (5, 0.95),
         (6, None), (7, 0.95)]


def test_manager_keeps_the_steps_orbax_keeps(tmp_path):
    """The saves of tests/test_parallel.py:360-405 and more (without
    metrics, ties): after each, the same all_steps, latest and best as the
    JAX ShardedCheckpointManager (orbax) with max_to_keep 2 and 3."""
    from snuffy_tpu.train.checkpoint import (
        ShardedCheckpointManager as JaxManager,
    )
    from snuffy_tpu_torch.train.checkpoint import ShardedCheckpointManager

    for keep in (2, 3):
        jm = JaxManager(str(tmp_path / f"jax{keep}"), max_to_keep=keep)
        pm = ShardedCheckpointManager(str(tmp_path / f"port{keep}"),
                                      max_to_keep=keep)
        for step, auc in SAVES:
            metrics = None if auc is None else {"valid_auc": auc}
            jm.save(step, {"x": jnp.arange(4.0) + step}, metrics=metrics)
            pm.save(step, {"x": torch.arange(4.0) + step}, metrics=metrics)
            assert pm.all_steps() == sorted(jm.all_steps()), (keep, step)
            assert pm.latest_step() == jm.latest_step(), (keep, step)
            assert pm.best_step() == jm.best_step(), (keep, step)
        jm.close()
        # a new manager reads the directory back
        again = ShardedCheckpointManager(str(tmp_path / f"port{keep}"),
                                         max_to_keep=keep)
        assert again.all_steps() == pm.all_steps()
        assert again.best_step() == pm.best_step()
        got = again.restore(again.latest_step(), {"x": torch.zeros(4)})
        assert torch.equal(got["x"],
                           torch.arange(4.0) + again.latest_step())


def test_trainer_state_round_trips(tmp_path):
    """A trained state (parameters, w, Adam's moments and count) saved and
    read into a fresh trainer: bitwise."""
    from snuffy_tpu_torch.train.checkpoint import (
        restore_sharded,
        save_sharded,
    )

    cfg = configs.MILTrainConfig(
        model=port_cfg(jax_cfg(use_pallas=False)), soft_average=True,
        bag_batch_size=2)
    t = SnuffyTrainer(cfg, "cpu")
    t.init_state(0)
    t.model.train()
    t.packed_train_step(torch.randn(2, 16, 16), torch.ones(2, 16, dtype=bool),
                        torch.ones(2, 1), torch.ones(2), torch.Generator(),
                        torch.Generator())
    save_sharded(str(tmp_path), 3, t.sharded_state())
    fresh = SnuffyTrainer(cfg, "cpu")
    fresh.init_state(1)
    fresh.load_sharded_state(restore_sharded(str(tmp_path), 3,
                                             fresh.sharded_state()))
    a, b = t.sharded_state(), fresh.sharded_state()
    assert a.keys() == b.keys() and len(a) > 40
    for k in a:
        assert torch.equal(a[k], b[k]), k
