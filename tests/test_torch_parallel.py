"""The port's data parallelism in one process (`snuffy_tpu_torch/parallel`).

In-process: the bootstrap without torchrun's environment (nothing
changes), WORLD_SIZE=2 with no rendezvous address (a clear error), the
rank's device and batch block, the trainer's mesh rule, the collectives'
identity without a group, and the 1-rank steps the
2-rank tests (tests/test_torch_multiproc.py) are held to, against the JAX
package's data-parallel steps on its 8 virtual CPU devices (the pattern of
tests/test_parallel.py:114,174,213): the MIL packed step against
`make_sharded_batch_train_step` on a (dp=8) mesh, and the DINO and MAE
steps against the JAX steps with the batch sharded over `dp_mesh(8)`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snuffy_tpu.configs import MILTrainConfig as JaxMILTrainConfig
from snuffy_tpu.configs import OptimizerConfig as JaxOptimizerConfig
from snuffy_tpu.parallel import mesh as jax_mesh
from snuffy_tpu.parallel import ssl_sharding as jax_ssl
from snuffy_tpu.parallel.sharded_train import (
    make_sharded_batch_train_step as jax_sharded_step,
)
from snuffy_tpu.parallel.sharded_train import shard_state
from snuffy_tpu.train.trainer import SnuffyTrainer as JaxTrainer
from snuffy_tpu_torch.bridge import milnet_from_jax, milnet_state_dict
from snuffy_tpu_torch.parallel import distributed, ssl_sharding
from snuffy_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh
from snuffy_tpu_torch.train import trainer as trainer_mod
from snuffy_tpu_torch.train.trainer import SnuffyTrainer
from snuffy_tpu_torch.utils.metrics_sync import mesh_metric_mean

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


@pytest.fixture
def no_torchrun(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)


# ------------------------------------------------------------- bootstrap

def test_one_process_without_torchrun_changes_nothing(no_torchrun):
    with distributed.session():
        assert not torch.distributed.is_initialized()
        assert (distributed.world_size(), distributed.rank()) == (1, 0)
        assert distributed.is_primary()
        assert distributed.host_allgather({"a": 1}) == [{"a": 1}]
        distributed.barrier("nothing to wait for")
        assert distributed.rank_seed(7) == 7
        assert distributed.global_mesh_spec() == MeshSpec(1, 1, 1, dcn=1)
        mesh = make_mesh(distributed.global_mesh_spec())
        assert mesh is None
        g = [torch.randn(3), torch.randn(2, 2)]
        assert all(a is b for a, b in zip(
            ssl_sharding.allreduce_gradients(g, mesh), g))
        x = torch.tensor(2.5)
        assert mesh_metric_mean(x, mesh) is x
        before = g[0].clone()
        ssl_sharding.replicate_state(g, mesh)
        assert torch.equal(g[0], before)
    assert distributed.primary_only(lambda: 3)() == 3


def test_world_size_2_without_a_rendezvous_address_raises(no_torchrun,
                                                          monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="MASTER_ADDR and MASTER_PORT"):
        distributed.initialize(device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(RuntimeError, match="MASTER_PORT not set"):
        distributed.initialize(device="cpu")
    assert not torch.distributed.is_initialized()


def test_a_rank_without_its_gpu_raises(no_torchrun, monkeypatch):
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "1"),
                 ("MASTER_ADDR", "localhost"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="rank 0: device cuda:1"):
        distributed.initialize()
    with pytest.raises(ValueError, match="nccl takes CUDA tensors only"):
        distributed.initialize("nccl", "cpu")


def test_rank_device(no_torchrun, monkeypatch):
    assert distributed.rank_device(None) == torch.device("cuda")
    assert distributed.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.rank_device("cuda") == torch.device("cuda", 3)
    assert distributed.rank_device("cuda:1") == torch.device("cuda", 1)
    assert distributed.rank_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("rank, world, want", [
    (0, 1, (0, 8)), (0, 2, (0, 4)), (1, 2, (4, 8)), (3, 4, (6, 8))])
def test_process_batch_slice(monkeypatch, rank, world, want):
    monkeypatch.setattr(distributed, "rank", lambda: rank)
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    sl = distributed.process_batch_slice(8)
    assert (sl.start, sl.stop) == want
    assert distributed.is_primary() == (rank == 0)
    assert distributed.rank_seed(5) == 5 + (rank << 32)
    if world > 1:
        with pytest.raises(ValueError, match="not divisible"):
            distributed.process_batch_slice(8 * world + 1)


def test_row_shards():
    x = torch.arange(24).reshape(8, 3)
    crops = torch.arange(2 * 8 * 2).reshape(2, 8, 2)
    for rank in range(2):
        mesh = Mesh(None, rank, 2)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(distributed, "world_size", lambda: 2)
            assert torch.equal(ssl_sharding.shard_images(x, mesh),
                               x[4 * rank:4 * rank + 4])
            assert torch.equal(ssl_sharding.shard_crops(crops, mesh),
                               crops[:, 4 * rank:4 * rank + 4])


def test_gradient_buckets_split_by_dtype_and_size():
    ts = [torch.zeros(10), torch.zeros(10), torch.zeros(4, dtype=torch.int32),
          torch.zeros(100), torch.zeros(3)]
    assert ssl_sharding._buckets(ts, 100) == [[0, 1], [2], [3], [4]]
    assert ssl_sharding._buckets(ts, 10 ** 6) == [[0, 1], [2], [3, 4]]


# ------------------------------------------------------------- the mesh

def test_mesh_spans_the_ranks():
    with pytest.raises(ValueError, match="1 rank"):
        make_mesh(MeshSpec(dcn=2))
    with pytest.raises(ValueError, match="1 rank"):
        make_mesh(MeshSpec(2, 1, 1))


def test_trainer_mesh_follows_the_jax_rule(monkeypatch):
    from snuffy_tpu_torch.configs import MILTrainConfig

    cfg = MILTrainConfig(bag_batch_size=4)
    assert trainer_mod._maybe_mesh(cfg) is None          # one process
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    made = []
    monkeypatch.setattr(trainer_mod, "make_mesh",
                        lambda spec, **kw: made.append(spec) or "mesh")
    assert trainer_mod._maybe_mesh(cfg) == "mesh"
    assert made == [MeshSpec(1, 1, 1, dcn=2)]
    for kw in (dict(bag_batch_size=1), dict(bag_batch_size=3),
               dict(bag_batch_size=4, use_mesh=0)):
        assert trainer_mod._maybe_mesh(
            dataclasses.replace(cfg, **kw)) is None, kw
    # use_mesh=1: the dp×sp×tp factoring, sp = 2 on two ranks of a host
    assert trainer_mod._maybe_mesh(
        dataclasses.replace(cfg, use_mesh=1)) == "mesh"
    assert made[-1] == MeshSpec(1, 2, 1)


# ------------------------------------ 1-rank steps against the JAX dp steps

def to_port(cfg):
    from snuffy_tpu_torch import configs

    d = dataclasses.asdict(cfg)
    return configs.MILTrainConfig(
        **{**d, "model": configs.SnuffyModelConfig(**d["model"]),
           "optim": configs.OptimizerConfig(**d["optim"])})


def test_mil_step_matches_the_jax_dp_step_on_8_devices():
    """8 bags, one packed step on one rank against the JAX sharded step on
    a dp=8 mesh (one bag a device), f32, ρ = 0, no dropout: losses, bag and
    instance scores, the parameters and w."""
    from snuffy_tpu.configs import SnuffyModelConfig as JaxModel

    lr = 1e-3
    jcfg = JaxMILTrainConfig(
        model=JaxModel(feats_size=16, num_heads=2, big_lambda=8,
                       random_patch_share=0.0, attention_dropout=0.0,
                       use_pallas=False),
        optim=JaxOptimizerConfig(optimizer="adamw", lr=lr, weight_decay=5e-2,
                                 clip_grad=0.05),
        soft_average=True, bag_batch_size=8, use_mesh=0)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((8, 64, 16)).astype(np.float32)
    masks = np.arange(64)[None] < rng.integers(40, 65, 8)[:, None]
    labels = rng.integers(0, 2, (8, 1)).astype(np.float32)
    bag_w = np.ones(8, np.float32)
    jt = JaxTrainer(jcfg)
    mesh = jax_mesh.make_mesh(jax_mesh.MeshSpec(8, 1, 1))
    start = jt.init_state(0, example_n=64)
    pcfg = to_port(jcfg)
    tt = SnuffyTrainer(pcfg, "cpu", model=milnet_from_jax(
        start.params, pcfg.model, device="cpu"), w=float(start.w))
    with mesh:
        state = shard_state(start, mesh)
        state, *want = jax_sharded_step(jt, mesh)(
            state, feats, masks, labels, bag_w, np.float32(lr),
            jax.random.PRNGKey(7))
    assert tt.mesh is None
    tt.model.train()
    tt.set_lr(lr)
    got = tt.packed_train_step(
        torch.from_numpy(feats), torch.from_numpy(masks),
        torch.from_numpy(labels), torch.from_numpy(bag_w),
        torch.Generator(), torch.Generator())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    end = milnet_state_dict(jax.device_get(state.params))
    for name, p in tt.model.state_dict().items():
        # Adam's first step is about lr·sign(g): near-zero elements of g
        # flip with the rounding (the key projection's bias has a true
        # gradient of 0), so each element within 2·lr, most within 1e-5
        diff = np.abs(p.numpy() - end[name])
        assert diff.max() <= 2 * lr, name
        assert (diff <= 1e-5 * (1 + np.abs(end[name]))).mean() >= 0.99, name
    np.testing.assert_allclose(tt.w.item(), float(state.w), rtol=1e-6)


def test_dino_step_matches_the_jax_dp_step_on_8_devices(monkeypatch):
    """One DINO step, 8 images: the JAX step with the crops sharded over
    dp_mesh(8) and the state replicated, against the port's one-rank
    step; flax's Dropout passed through, as tests/test_torch_dino.py."""
    import flax.linen as fnn
    import test_torch_dino as td

    monkeypatch.setattr(fnn, "Dropout", td.PassThrough)
    jt, pt = td.jax_trainer(), td.port_trainer()
    js, ps = td.same_start(jt, pt)
    g, loc = td.crops(0, b=8)
    mesh = jax_ssl.dp_mesh(8)
    args = (1e-3, 0.04, 0.99, 0.04, False)
    with mesh:
        js, jl = jt.get_step()(
            jax_ssl.replicate_state(js, mesh),
            jax_ssl.shard_crops(jnp.asarray(g), mesh),
            jax_ssl.shard_crops(jnp.asarray(loc), mesh),
            *(jnp.asarray(a, jnp.float32) for a in args[:4]),
            jnp.asarray(args[4]), jax.random.PRNGKey(0))
    ps, pl = pt.step(ps, torch.from_numpy(g), torch.from_numpy(loc), *args)
    assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    td.compare_states(jax.device_get(js), ps)


def test_mae_step_matches_the_jax_dp_step_on_8_devices(monkeypatch):
    """One MAE step, 8 uint8 images, the JAX step written out as
    tests/test_torch_mae_train.py writes it, jitted with the images sharded
    over dp_mesh(8) and the params replicated, against the port's
    one-rank step with the same masking noise."""
    import flax.linen as fnn
    import test_torch_mae_train as tm

    from snuffy_tpu.ssl import mae_trainer as jtrainer
    from snuffy_tpu_torch.bridge import mae_pretrain_from_jax
    from snuffy_tpu_torch.ssl import mae_trainer

    monkeypatch.setattr(fnn, "Dropout", tm.PassThrough)
    lr = 1e-4
    jm, params = tm.jax_small(True)
    jt = jtrainer.MAETrainer(jm, freeze_non_adapter=True)
    jt.init_state(0)
    opt = jt.tx.init(params)
    trains = jtrainer.mae_trainable_mask(params, True, False)
    model = tm.port_small(params, True)
    pt = mae_trainer.MAETrainer(model, freeze_non_adapter=True)
    ps = pt.init_state()

    @jax.jit
    def jax_step(params, opt, imgs, key):
        def loss_fn(p):
            return jm.apply({"params": p}, imgs, 0.75, False, rng=key)[0]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = jt.tx.update(grads, opt, params)
        params = jax.tree_util.tree_map(
            lambda p, u, m: jnp.where(m, p + lr * u, p), params, updates,
            trains)
        return params, loss

    u8 = np.random.default_rng(10).integers(0, 256, (8, 32, 32, 3),
                                            dtype=np.uint8)
    key = jax.random.PRNGKey(20)
    mesh = jax_ssl.dp_mesh(8)
    with mesh:
        params, jl = jax_step(
            jax_ssl.replicate_state(params, mesh), jax_ssl.replicate_state(
                opt, mesh),
            jax_ssl.shard_images(jt._to_model_dtype(jnp.asarray(u8)), mesh),
            key)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (8, 16))))
    ps, pl = pt.step(ps, torch.from_numpy(u8), lr, noise=noise)
    assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    want = mae_pretrain_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.device_get(params)))
    for k, v in model.state_dict().items():
        err = np.abs(v.numpy() - want[k])
        assert err.max() <= 2 * lr, k
        assert (err <= 1e-5 * (np.abs(want[k]).max() + lr)).mean() >= 0.99, k
