"""The port's sequence and tensor parallelism, remat and sharded
checkpoints over real processes (gloo on the CPU).

Each module fixture runs scenarios of
`snuffy_tpu_torch/tools/multiproc_worker.py` on 2 spawned ranks (4 for
sp×tp), each rank limited in time so that a collective one rank never
joins fails the test instead of hanging the suite. Held:

  * one MIL step of 8 bags on an sp=2, a tp=2 and an sp=2 × tp=2 mesh
    against one rank stepping the 8 bags packed from the same weights,
    f32, ρ = 0, no dropout: losses, bag scores, instance scores, the
    gradients before the clip (relative to max |g|, 1e-5), the
    parameters; every rank's whole model bitwise equal after it, and
    after a step at ρ = 0.5 and dropout 0.1;
  * the collective audit of those steps (the counterpart of
    tests/test_collective_audit.py:118,140 and tests/test_parallel.py:
    546): under sp no (N, d) or (h, N, S) tensor crosses; under tp each
    layer's activation all-reduces are one (S, d) and one (N, d) forward
    and their gradients' conjugates backward; no parameter-sized gather;
    the gradient sums move each parameter once per axis on which its
    share is partial (the parameter count where that is one axis);
  * remat bitwise the step without it with dropout on, over 2 ranks;
  * a bag of 4× the rows split over sp=2 against one rank;
  * a tp=2 checkpoint saved by 2 ranks, the processes gone, read back by
    2 fresh ranks: each rank's blocks, bit for bit;
  * DINO with `use_bn_in_head` on 2 ranks against 1 on the global batch;
  * the training CLI with `--use_mesh 1 --remat 1`: rank 0 alone writes,
    and its `.pth` loads into the one-rank model.
"""

import os

import numpy as np
import pytest
import torch

from snuffy_tpu_torch.parallel.sharded_train import partial_axes, tp_dim
from snuffy_tpu_torch.tools.multiproc_worker import (
    GRAD_TOL,
    LOSS_TOL,
    MIL,
    MIL_BAGS,
    MIL_LR,
    MIL_ROWS,
    PARAM_SHARE,
    SSL_LR,
    SSL_STEPS,
    Launch,
    launch,
    saved_and_exited,
)

F32 = "float32"
TINY = MIL["tiny"]
N, S, D = MIL_ROWS["tiny"][0], TINY["big_lambda"], TINY["feats_size"]
ACTIVATIONS = ("gradients", "bag weight", "gradient norm")


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    work = tmp_path_factory.mktemp("sp")
    return launch("sp", str(work)), work


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    return launch("tp", str(tmp_path_factory.mktemp("tp")))


@pytest.fixture(scope="module")
def sptp(tmp_path_factory):
    return launch("sptp", str(tmp_path_factory.mktemp("sptp")), world=4,
                  timeout=180.0)


@pytest.fixture(scope="module")
def rest(tmp_path_factory):
    """remat, the long bag, the checkpoint's save and DINO in one launch;
    the restore in a second one, started with it, that reads the
    checkpoint once the first launch's ranks have exited."""
    work = str(tmp_path_factory.mktemp("rest"))
    restore = Launch("ckpt:restore", work, timeout=300.0)
    try:
        first = launch("remat,long,ckpt:save,dino_bn", work, timeout=180.0)
        saved_and_exited(work)
        return first, restore.results()
    finally:
        restore.close()


def results(request, kind):
    got = request.getfixturevalue(kind)
    return got[0] if kind == "sp" else got


@pytest.mark.parametrize("kind, mesh", [
    ("sp", [0, 1, None, 2, 0, 1]), ("tp", [0, 1, 0, 1, None, 2]),
    ("sptp", [0, 1, None, 2, None, 2])])
def test_mesh_step_is_the_one_rank_step(request, kind, mesh):
    ranks = results(request, kind)
    for r in ranks:   # None: the coordinate that differs between ranks
        assert [g for g, w in zip(r[f"{kind}_mesh"], mesh)
                if w is not None] == [w for w in mesh if w is not None]
    coords = sorted(tuple(r[f"{kind}_mesh"]) for r in ranks)
    assert len(set(coords)) == len(ranks)          # one place a rank
    r0 = ranks[0]
    assert r0[f"{kind}_dtype"] == F32
    assert max(r0[f"{kind}_errors"]) <= LOSS_TOL[F32]
    assert max(r0[f"{kind}_grads"]) <= GRAD_TOL[F32]
    worst, share = r0[f"{kind}_params"]
    assert worst <= 2 * MIL_LR and share >= PARAM_SHARE
    for key in ("digest", "rand_digest", "n_params"):
        assert len({r[f"{kind}_{key}"] for r in ranks}) == 1, key
    assert all(r[f"{kind}_rand_finite"] for r in ranks)
    if "tp" in kind:   # each rank holds its blocks of the tp-split weights
        assert r0[f"{kind}_local_params"] < r0[f"{kind}_n_params"]


def activation_records(rank, kind):
    return [r for r in rank[f"{kind}_audit"] if r[1] not in ACTIVATIONS]


def gradient_elements(rank, kind, axes) -> int:
    return sum(r[3] for r in rank[f"{kind}_audit"]
               if r[1] == "gradients" and r[0] in axes)


@pytest.mark.parametrize("kind", ["sp", "sptp"])
def test_sp_moves_no_row_proportional_tensor(request, kind):
    """Under sp the activations that cross are (S, d)-sized (the gathered
    rows, the attention partials, their gradients), the (N, 1) instance
    logits and the (N,) mask for the selection over the global N, and
    the pooled sums: never an (N/sp, d) block or (h, N, S) probabilities."""
    for rank in results(request, kind):
        acts = activation_records(rank, kind)
        sp_acts = [r for r in acts if r[0] == "sp"]
        assert sp_acts
        for axis, what, shape, numel, _ in sp_acts:
            assert numel <= max(S * D, N, D + 1), (what, shape)
            assert numel < (N // 2) * D, (what, shape)
        whats = {r[1] for r in sp_acts}
        assert whats == {"instance logits", "row mask", "gathered rows",
                         "attention keys grad", "attention partials",
                         "scattered rows grad", "pooled sums",
                         "instance maxima"}, whats
        assert not any(r[1] == "parameter" for r in rank[f"{kind}_audit"])


def test_tp_activation_all_reduces_are_megatrons(tp):
    """tp, 8 bags one at a time: each bag's layer moves (S, d) and (N, d)
    forward (wo's and w2's partial products) and the gradients of the
    column-parallel inputs backward, (N, d) for LayerNorm(x) into wq/wv,
    (S, d) for the selected rows into wk and (N, d) for LayerNorm(y) into
    w1; nothing else is activation-sized. The first layer's selected rows
    are rows of the input, which takes no gradient: its (S, d) is not
    sent."""
    depth = TINY["depth"]
    for rank in tp:
        acts = activation_records(rank, "tp")
        counts = {}
        for axis, what, shape, numel, _ in acts:
            assert axis == "tp", what
            counts[(what, tuple(shape))] = counts.get(
                (what, tuple(shape)), 0) + 1
        per = MIL_BAGS * depth
        want = {
            ("attention output", (S, D)): per,
            ("FFN output", (N, D)): per,
            ("attention input grad", (N, D)): per,
            ("attention keys input grad", (S, D)): MIL_BAGS * (depth - 1),
            ("FFN input grad", (N, D)): per,
        }
        assert counts == {k: v for k, v in want.items() if v}, counts


@pytest.mark.parametrize("kind", ["sp", "tp", "sptp"])
def test_gradient_sums_move_each_partial_share_once(request, kind):
    """The gradient all-reduces move each parameter's local elements once
    for each axis on which its share is partial (partial_axes), and
    nothing else: under tp only wq, wk and wv's whole biases; under sp
    everything the rank's rows reach."""
    from snuffy_tpu_torch.models.snuffy import MILNet
    from snuffy_tpu_torch.configs import SnuffyModelConfig
    from snuffy_tpu_torch.parallel.mesh import Mesh

    rank = results(request, kind)[0]
    _, _, _, sp, _, tp = rank[f"{kind}_mesh"]
    mesh = Mesh(None, 0, 1, None, 0, sp, None, 0, tp)
    named = [*MILNet(SnuffyModelConfig(**TINY)).named_parameters(),
             ("w", torch.zeros(()))]
    for axis in ("sp", "tp"):
        want = sum(p.numel() // (tp if tp_dim(n) is not None else 1)
                   for n, p in named if axis in partial_axes(n, mesh))
        assert gradient_elements(rank, kind, (axis,)) == want, axis
    total = sum(p.numel() for _, p in named)
    if kind == "sp":   # one axis: every parameter the rows reach
        assert gradient_elements(rank, kind, ("sp",)) < total


def test_remat_over_two_ranks_is_bitwise(rest):
    ranks, _ = rest
    for r in ranks:
        assert r["remat_bitwise"] == {"outputs": True, "grads": True,
                                      "params": True}


def test_a_long_bag_over_sp_is_the_one_rank_bag(rest):
    r0 = rest[0][0]
    assert r0["long_rows"] == 4 * N
    assert max(r0["long_errors"]) <= LOSS_TOL[F32]
    assert r0["long_grads"] <= GRAD_TOL[F32]


def test_tp_checkpoint_restores_into_fresh_ranks(rest):
    first, second = rest
    for saved, restored in zip(first, second):
        assert saved["ckpt_tp_rank"] == restored["ckpt_tp_rank"]
        assert restored["ckpt_restore_shards"] == saved["ckpt_save_shards"]
        assert restored["ckpt_steps"] == [[1], 1]
        # each rank wrote its own shard file; rank 0 the metadata too
        files = {os.path.basename(w) for w in saved["ckpt_writes"]}
        assert f"__{saved['rank']}_0.distcp" in files
        assert (".metadata.tmp" in files) == (saved["rank"] == 0)
    s0, s1 = (r["ckpt_save_shards"] for r in first)
    split = [k for k in s0 if tp_dim(k) is not None]
    assert split
    for k in s0:
        if k in split:   # two blocks of one tensor, each rank its own
            assert s0[k][0] != s1[k][0] and s0[k][1] == s1[k][1], k
        else:
            assert s0[k] == s1[k], k


def test_dino_use_bn_in_head_over_two_ranks_is_the_one_rank_step(rest):
    r0, r1 = rest[0]
    loss, loss1 = r0["dino_bn_loss"]
    assert abs(loss - loss1) <= LOSS_TOL[F32] * abs(loss1)
    assert max(r0["dino_bn_grads"]) <= GRAD_TOL[F32]
    assert r0["dino_bn_center"] <= LOSS_TOL[F32]
    worst, share = r0["dino_bn_student"]
    assert worst <= 2 * SSL_LR * SSL_STEPS and share >= PARAM_SHARE
    assert r0["dino_bn_noise_biases"] <= 2 * SSL_LR * SSL_STEPS
    assert r0["dino_bn_teacher"][1] >= PARAM_SHARE
    assert r0["dino_bn_digest"] == r1["dino_bn_digest"]
    assert r0["dino_bn_running"] == r1["dino_bn_running"]


def test_training_cli_with_mesh_and_remat_writes_once(sp):
    from snuffy_tpu_torch.bridge import load_reference_pth
    from snuffy_tpu_torch.configs import SnuffyModelConfig
    from snuffy_tpu_torch.models.snuffy import MILNet

    (r0, r1), work = sp
    assert r1["mesh_cli"]["writes"] == []
    written = {os.path.basename(w) for w in r0["mesh_cli"]["writes"]}
    assert {"summary.json", "metrics.jsonl"} <= written
    best = r0["mesh_cli"]["best_epoch"]
    assert f"{best}.pth" in written
    model = MILNet(SnuffyModelConfig(feats_size=16, num_heads=2,
                                     big_lambda=8, random_patch_share=0.5))
    model.load_state_dict(load_reference_pth(
        os.path.join(work, r0["mesh_cli"]["pth"])), strict=True)
    assert all(np.isfinite(p.detach().numpy()).all()
               for p in model.parameters())
