"""The port's multi-process launcher: W ranks on one host, each one process
(the counterpart of the JAX package's `tools/multihost_worker.py`).

    python -m snuffy_tpu_torch.tools.multiproc_worker <scenario>[,...] \\
        <workdir> [--size tiny|full] [--device cpu|cuda:0] \\
        [--backend gloo|nccl]

runs one rank; torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) says which. `launch` starts W of them on a free
localhost port, each with a time limit, and returns their results; the
tests (gloo on the CPU, `--size tiny`) and `chip_smoke.py` (gloo over
CUDA tensors, two ranks sharing one card, `--size full`: the CLIs'
widths) drive it. Each rank prints one `RESULT <json>` line.

Scenarios, each on every rank:
  mil      the bootstrap and the host-side agreement (`global_min_int`,
           `sync_metrics` with a value on one rank only, `sync_epoch_row`,
           the meters, `mesh_metric_mean`); one packed MIL step of 8 bags
           over the ranks (`parallel/sharded_train`) at ρ = 0 and no
           dropout against one rank stepping all 8 from the same weights
           (outputs, the gradients before the clip, the parameters),
           then a tail batch of 3 real bags (the last rank holds only
           zero-weight dummies); an epoch at ρ = 0.5 and dropout 0.1 (the
           rank folded into the seeds); the replicas' checksums; (tiny) a
           `Runner` run of 2 epochs whose files rank 0 alone writes.
  dino     two DINO steps over the ranks (crops drawn once, split) against
           one rank on the whole batch: loss, centre, the gradients the
           update receives, student and teacher;
           (tiny) the DINO CLI with unequal per-rank validation counts.
  mae      two MAE steps (noise passed in, split) against one rank, held
           as DINO's; (tiny) the MAE CLI likewise.
  extract  the extraction CLI (`compute_feats.main`) over the ranks.
  nccl1    (card) a group of one rank on NCCL: an all-reduce, and one DINO
           step under the mesh bit for bit the step without a group.

Each rank reports the files it opened for writing under the workdir (an
audit hook), its kernels' launch counts on the scenario's path (from 0
just before it), the largest error of each kernel's first launch at each
shape against its plain version (on the card), step seconds and peak
memory.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The MIL step: the training operating point (bench.py:107-127) on the
# card, a narrow one on the CPU. 8 bags a step.
MIL = {"full": dict(feats_size=384, num_heads=4, big_lambda=512, depth=2,
                    activation="gelu", compute_dtype="bfloat16"),
       "tiny": dict(feats_size=16, num_heads=2, big_lambda=8, depth=1)}
MIL_ROWS = {"full": (10240, 10000, 10000), "tiny": (64, 40, 64)}
MIL_BAGS, MIL_LR, MIL_CLIP = 8, 1e-3, 0.05
# two SSL steps on the same batch: the second one's wall is a warm step's
SSL_LR, SSL_STEPS = 1e-4, 2
# 2 ranks against 1 on the same global batch: the same arithmetic but for
# where the gradient's sums are split, so f32 within a few roundings; bf16
# activations round at other points when a GEMM's row count changes.
# Adam's first steps move a parameter by about lr·sign(g), whatever the
# scale of g, and MIL's clip at 0.05 takes any scale out too: so the
# gradient each step hands its optimizer (after the all-reduce, before
# the clip) is held relative to max |g|, where a factor of W (a sum for a
# mean, a rank's Σ bag_w for the global one) is an error of 0.5 or more.
# The parameters: where an element of g is near zero, the rounding flips
# its sign, so every element is held to 2·lr a step and a share to the
# tolerance. The bf16 limits stand a few times above the H100's readings
# in chip_smoke's phase 15 (PERF.md §6).
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
CENTER_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PARAM_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
PARAM_SHARE = 0.99
# first launch at each shape, kernel against plain, relative to max |plain|
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
DENSE_F32_TOL = 1e-5


# ------------------------------------------------------------ the launcher

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(scenario: str, workdir: str, world: int = 2, size: str = "tiny",
           device: str = "cpu", backend: Optional[str] = None,
           timeout: float = 120.0) -> List[dict]:
    """Run `scenario` (or several, comma-separated, in one run) on `world`
    ranks, each a process of this module with torchrun's environment and
    2 OpenMP threads; returns their RESULT dicts in rank order.
    Raises when a rank fails, prints no result, or any is still running
    after `timeout` seconds (then every rank is killed)."""
    port = str(free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=port,
               WORLD_SIZE=str(world), OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "snuffy_tpu_torch.tools.multiproc_worker",
           scenario, workdir, "--size", size, "--device", device]
    if backend:
        cmd += ["--backend", backend]
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                cmd, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                stdout=logs[r], stderr=subprocess.STDOUT, text=True,
                cwd=REPO))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise TimeoutError(
                    f"{scenario}: a rank is still running after {timeout} s "
                    f"(a collective waiting on a rank?)\n"
                    + _tails(logs)) from None
        results = []
        for r, (p, f) in enumerate(zip(procs, logs)):
            f.seek(0)
            text = f.read()
            lines = [ln for ln in text.splitlines()
                     if ln.startswith("RESULT ")]
            if p.returncode != 0 or not lines:
                raise RuntimeError(f"{scenario}: rank {r} exited "
                                   f"{p.returncode}\n" + _tails(logs))
            results.append(json.loads(lines[-1][len("RESULT "):]))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


def _tails(logs, n: int = 4000) -> str:
    out = []
    for r, f in enumerate(logs):
        f.seek(0)
        out.append(f"--- rank {r}:\n{f.read()[-n:]}")
    return "\n".join(out)


# ------------------------------------------------------- rank-side helpers

class WriteAudit:
    """The files this process opens for writing under `root`: an audit
    hook sees builtins.open (np.savez and shutil pass there too), and
    `torch.save`, whose writer opens its file in C++, is wrapped."""

    def __init__(self, root: str):
        self.root = os.path.realpath(root)
        self.paths: List[str] = []
        sys.addaudithook(self._hook)
        save = torch.save

        def recorded_save(obj, f, *args, **kwargs):
            if isinstance(f, (str, os.PathLike)):
                self._note(f)
            return save(obj, f, *args, **kwargs)

        torch.save = recorded_save

    def _note(self, path) -> None:
        path = os.path.realpath(os.fsdecode(path))
        if path.startswith(self.root + os.sep):
            self.paths.append(os.path.relpath(path, self.root))

    def _hook(self, event, args):
        if event != "open" or not isinstance(args[0], (str, bytes)):
            return
        _, mode, flags = args
        if (any(c in mode for c in "wax+") if isinstance(mode, str)
                else bool(flags & (os.O_WRONLY | os.O_RDWR))):
            self._note(args[0])

    def take(self) -> List[str]:
        out, self.paths = sorted(set(self.paths)), []
        return out


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order (replicas bitwise equal iff
    their digests are)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale


def compare_params(got: Dict[str, torch.Tensor],
                   want: Dict[str, torch.Tensor], tol: float):
    """(largest |diff| of any element, the least share of a tensor's
    elements within tol·(1 + |want|))."""
    worst, share = 0.0, 1.0
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        d = (got[k].detach().double().cpu() - w.detach().double().cpu()).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        ok = d <= tol * (1 + w.detach().double().cpu().abs())
        share = min(share, float(ok.float().mean()) if d.numel() else 1.0)
    return worst, share


def flat_f32(tensors) -> torch.Tensor:
    return torch.cat([t.detach().float().reshape(-1) for t in tensors])


@contextlib.contextmanager
def gradients_before_clip(trainer, kept: List[torch.Tensor]):
    """Inside it, each MIL step of `trainer` appends to `kept` the model's
    gradients as its clip receives them (summed over the ranks under a
    mesh), and w's, flat."""
    from snuffy_tpu_torch.train import trainer as trainer_mod

    clip = trainer_mod.clip_by_global_norm

    def keeping(params, max_norm):
        params = list(params)
        kept.append(flat_f32([*(p.grad for p in params if p.grad is not None),
                              trainer.w.grad]))
        return clip(params, max_norm)

    trainer_mod.clip_by_global_norm = keeping
    try:
        yield kept
    finally:
        trainer_mod.clip_by_global_norm = clip


@contextlib.contextmanager
def gradients_to_update(trainer, kept: List[torch.Tensor]):
    """Inside it, each SSL step of `trainer` appends to `kept` the
    gradients its update receives (averaged over the ranks under a mesh,
    before DINO's clip), flat."""
    update = trainer._update

    def keeping(state, params, grads, *rest):
        kept.append(flat_f32(grads))
        return update(state, params, grads, *rest)

    trainer._update = keeping
    try:
        yield kept
    finally:
        del trainer._update


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_memory(device: torch.device) -> Optional[int]:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def adapters_for_parity(model: torch.nn.Module, seed: int) -> None:
    """Adapters' dropout off and their up-projections drawn N(0, 0.02²)
    from a CPU generator (zero at init: their down-projections would get
    no gradient)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "up_proj") and hasattr(m, "down_proj"):
                m.dropout = 0.0
                w = m.up_proj.weight
                w.copy_(0.02 * torch.randn(w.shape, generator=gen))


@contextlib.contextmanager
def kernel_calls(calls: dict):
    """Inside it, K1's, K2's and K5's wrappers keep a copy of the inputs of
    their first call at each shape in `calls` (K1: the forward inputs and
    seed; K2: the output gradient; K5: q, k, v, n_valid). Launch counts
    are the kernels' own."""
    from snuffy_tpu_torch.ops import dense_attention as da
    from snuffy_tpu_torch.ops import fused_attention as fa

    fwd, bwd, dense = fa._fwd_cuda, fa._bwd_cuda, da._dense_cuda

    def key(q, k, segments, rate):
        return ("sparse", tuple(q.shape), tuple(k.shape), segments, rate)

    def fwd_kept(q, k, v, sv, qv, segments, rate, seed):
        call = calls.setdefault(key(q, k, segments, rate), {})
        if "fwd" not in call:
            call["fwd"] = ([t.clone() for t in (q, k, v, sv, qv)], seed)
        return fwd(q, k, v, sv, qv, segments, rate, seed)

    def bwd_kept(q, k, v, sv, row_max, row_scale, g, segments, rate, seed):
        call = calls.setdefault(key(q, k, segments, rate), {})
        call.setdefault("g", g.clone())
        return bwd(q, k, v, sv, row_max, row_scale, g, segments, rate, seed)

    def dense_kept(q, k, v, n_valid):
        calls.setdefault(("dense", tuple(q.shape)), tuple(
            t.detach().clone() for t in (q, k, v)) + (n_valid,))
        return dense(q, k, v, n_valid)

    fa._fwd_cuda, fa._bwd_cuda, da._dense_cuda = fwd_kept, bwd_kept, \
        dense_kept
    try:
        yield calls
    finally:
        fa._fwd_cuda, fa._bwd_cuda, da._dense_cuda = fwd, bwd, dense


def check_kernel_calls(calls: dict) -> Dict[str, float]:
    """Each kept first call through its kernel and its plain version: K1's
    output, K2's dq, dk, dv, K5's output within KERNEL_TOL (K5 f32 within
    DENSE_F32_TOL; bf16 real activations one ulp of max |plain|), two
    launches bitwise equal. → the largest error of each kernel (0 where
    it never ran). Raises on a disagreement."""
    from snuffy_tpu_torch.ops import dense_attention as da
    from snuffy_tpu_torch.ops import fused_attention as fa
    from snuffy_tpu_torch.ops.sparse_attention import (
        packed_inverted_sparse_attention,
        packed_inverted_sparse_attention_bwd,
    )

    errs = {"sparse_attention_fwd": 0.0, "sparse_attention_bwd": 0.0,
            "dense_attention": 0.0}

    def held(name, got, want, tol, what):
        err = rel_err(got, want)
        if not err <= tol:
            raise AssertionError(f"{name} {what}: kernel vs plain {err:.3e} "
                                 f"> {tol:.3e}")
        errs[name] = max(errs[name], err)

    with torch.inference_mode():
        for key, call in calls.items():
            if key[0] == "dense":
                q, k, v, n_valid = call
                tol = (DENSE_F32_TOL if q.dtype == torch.float32
                       else KERNEL_TOL["bfloat16"])
                got = da.fused_self_attention(q, k, v, n_valid)
                held("dense_attention", got,
                     da.dense_attention_reference(q, k, v, n_valid), tol,
                     str(key[1]))
                if not torch.equal(da.fused_self_attention(q, k, v, n_valid),
                                   got):
                    raise AssertionError(f"K5 at {key[1]}: two launches "
                                         "differ")
                continue
            (q, k, v, sv, qv), seed = call["fwd"]
            seg, rate = key[3], key[4]
            tol = KERNEL_TOL[str(q.dtype).removeprefix("torch.")]
            kw = dict(dropout_rate=rate, dropout_seed=seed)
            got = fa.fused_packed_inverted_sparse_attention(q, k, v, sv, qv,
                                                            seg, **kw)
            held("sparse_attention_fwd", got, packed_inverted_sparse_attention(
                q, k, v, sv, qv, seg, **kw), tol, str(key[1:]))
            if not torch.equal(fa.fused_packed_inverted_sparse_attention(
                    q, k, v, sv, qv, seg, **kw), got):
                raise AssertionError(f"K1 at {key[1:]}: two launches differ")
            if "g" in call:
                _, row_max, row_scale = fa._fwd_cuda(q, k, v, sv, qv, seg,
                                                     rate, seed)
                grads = fa._bwd_cuda(q, k, v, sv, row_max, row_scale,
                                     call["g"], seg, rate, seed)
                want = packed_inverted_sparse_attention_bwd(
                    q, k, v, sv, qv, call["g"], seg, **kw)
                for name, a, b in zip(("dq", "dk", "dv"), grads, want):
                    held("sparse_attention_bwd", a, b, tol,
                         f"{name} {key[1:]}")
                again = fa._bwd_cuda(q, k, v, sv, row_max, row_scale,
                                     call["g"], seg, rate, seed)
                if not all(torch.equal(a, b) for a, b in zip(again, grads)):
                    raise AssertionError(f"K2 at {key[1:]}: two launches "
                                         "differ")
    return errs


class KernelPath:
    """Launch counts of a path (from 0 just before it), and the inputs of
    each kernel's first call at each shape on the card."""

    def __init__(self, device: torch.device):
        self.device, self.calls = device, {}
        self.launches: Dict[str, int] = {}

    @contextlib.contextmanager
    def run(self):
        from snuffy_tpu_torch.ops import kernels

        sync(self.device)
        kernels.reset_launches()
        with (kernel_calls(self.calls) if self.device.type == "cuda"
              else contextlib.nullcontext()):
            yield
        sync(self.device)
        for k, n in kernels.launch_counts().items():
            self.launches[k] = self.launches.get(k, 0) + n

    def checked(self) -> Dict[str, float]:
        return check_kernel_calls(self.calls)


# --------------------------------------------------------------- scenarios

def scenario_mil(out: dict, size: str, device: torch.device, work: str,
                 audit: WriteAudit) -> None:
    import dataclasses

    from snuffy_tpu_torch.configs import (
        MILTrainConfig,
        OptimizerConfig,
        SnuffyModelConfig,
    )
    from snuffy_tpu_torch.parallel import distributed
    from snuffy_tpu_torch.parallel.sharded_train import (
        make_sharded_batch_train_step,
    )
    from snuffy_tpu_torch.train.trainer import SnuffyTrainer
    from snuffy_tpu_torch.utils.metrics_sync import (
        SmoothedValue,
        global_min_int,
        mesh_metric_mean,
        sync_epoch_row,
        sync_metrics,
    )

    rank, world = distributed.rank(), distributed.world_size()
    # -- the host-side agreement over the real wire
    out["global_min"] = global_min_int(5 if rank == 0 else 3)
    red = sync_metrics({"train_loss": 2.0 + rank,
                        "val_loss": 7.0 if rank == 1 else None,
                        "n": float(3 + rank)}, weight_key="n")
    out["sync"] = [red["n"], red["train_loss"], red["val_loss"]]
    row, writer = sync_epoch_row({"epoch": 3, "train_loss": 1.0 + rank},
                                 1 + rank)
    out["epoch_row"] = [row, writer]
    meter = SmoothedValue()
    meter.update(1.0 + rank, n=2)
    meter.synchronize_between_processes()
    out["meter"] = [meter.count, meter.total]
    sl = distributed.process_batch_slice(MIL_BAGS)
    out["batch_slice"] = [sl.start, sl.stop]

    # -- the packed step over the ranks against one rank
    n_pad, lo, hi = MIL_ROWS[size]
    model = SnuffyModelConfig(**MIL[size], random_patch_share=0.0,
                              attention_dropout=0.0)
    out["mil_dtype"] = model.compute_dtype
    cfg = MILTrainConfig(
        model=model, soft_average=True, bag_batch_size=MIL_BAGS, seed=1,
        optim=OptimizerConfig(optimizer="adamw", lr=MIL_LR,
                              weight_decay=5e-2, clip_grad=MIL_CLIP))
    rng = np.random.default_rng(0)   # the same bags on every rank
    d = cfg.model.feats_size
    feats = torch.from_numpy(rng.standard_normal(
        (MIL_BAGS, n_pad, d)).astype(np.float32)).to(device)
    valid = rng.integers(lo, hi + 1, MIL_BAGS)
    masks = (torch.arange(n_pad)[None] < torch.from_numpy(valid)[:, None]
             ).to(device)
    labels = torch.from_numpy(rng.integers(0, 2, (MIL_BAGS, 1)).astype(
        np.float32)).to(device)
    tail_w = (torch.arange(MIL_BAGS) < 3).float().to(device)
    tail = [torch.where(tail_w.bool().view(-1, *[1] * (t.dim() - 1)), t,
                        torch.zeros_like(t)) for t in (feats, masks, labels)]
    batches = ((feats, masks, labels, torch.ones(MIL_BAGS, device=device)),
               (*tail, tail_w))
    mesh_mil = SnuffyTrainer(cfg, device)
    if mesh_mil.mesh is None:
        raise AssertionError("bag_batch_size 8 over the ranks took no mesh")
    mesh_mil.init_state(cfg.seed)
    step = make_sharded_batch_train_step(mesh_mil, mesh_mil.mesh)
    path, two, seconds, grads = KernelPath(device), [], [], []
    for i, batch in enumerate(batches):
        mesh_mil.model.train()
        mesh_mil.set_lr(MIL_LR)
        gens = (torch.Generator(device).manual_seed(11 + i),
                torch.Generator().manual_seed(12 + i))
        t0 = time.perf_counter()
        with (path.run() if i == 0 else contextlib.nullcontext()), \
                gradients_before_clip(mesh_mil, grads):
            two.append(step(*batch, *gens))
        sync(device)
        seconds.append(time.perf_counter() - t0)
    out["mil_step_s_ranks"] = seconds
    out["mil_launches"] = path.launches
    out["mil_peak_bytes"] = peak_memory(device)
    params = {**mesh_mil.model.state_dict(), "w": mesh_mil.w.detach()}
    out["mil_digest"] = digest(params.values())
    if rank == 0:
        one = SnuffyTrainer(dataclasses.replace(cfg, use_mesh=0), device)
        one.init_state(cfg.seed)
        one_out, seconds, grads1 = [], [], []
        for i, batch in enumerate(batches):
            one.model.train()
            one.set_lr(MIL_LR)
            gens = (torch.Generator(device).manual_seed(11 + i),
                    torch.Generator().manual_seed(12 + i))
            t0 = time.perf_counter()
            with gradients_before_clip(one, grads1):
                one_out.append(one.packed_train_step(*batch, *gens))
            sync(device)
            seconds.append(time.perf_counter() - t0)
        out["mil_step_s_one"] = seconds
        out["mil_errors"] = [
            [rel_err(a, b) for a, b in zip(got, want)]
            for got, want in zip(two, one_out)]
        out["mil_grads"] = [rel_err(a, b) for a, b in zip(grads, grads1)]
        want = {**one.model.state_dict(), "w": one.w.detach()}
        out["mil_params"] = compare_params(
            params, want, PARAM_TOL[model.compute_dtype])
        del one, one_out, grads1
    # the kernels, the first launch at each shape (after the path's
    # counts were read)
    out["mil_kernel_errors"] = path.checked()
    del mesh_mil, step, two, grads

    # -- an epoch at the training point's randomness
    rand = dataclasses.replace(cfg, model=dataclasses.replace(
        model, random_patch_share=0.5, attention_dropout=0.1))
    trainer = SnuffyTrainer(rand, device)
    trainer.init_state(rand.seed)
    bucketed = {n_pad: (feats, masks, labels, np.arange(MIL_BAGS))}
    losses, scores, _, order = trainer.run_train_epoch(
        bucketed, MIL_LR, np.random.default_rng(0), 7)
    out["mil_rand_finite"] = bool(np.isfinite(losses).all()
                                  and np.isfinite(scores).all())
    out["mil_rand_order"] = order.tolist()
    out["mil_rand_digest"] = digest([*trainer.model.state_dict().values(),
                                     trainer.w])
    del trainer, feats, masks, labels, batches, tail

    out["mesh_mean"] = float(mesh_metric_mean(
        torch.tensor(float(rank + 1), device=device),
        distributed_mesh()))
    if size == "tiny":
        out["runner"] = runner_run(rand, device, work, audit)


def distributed_mesh():
    from snuffy_tpu_torch.parallel import distributed
    from snuffy_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(distributed.global_mesh_spec())


def runner_run(cfg, device: torch.device, work: str, audit: WriteAudit):
    """A Runner's 2 epochs on tiny bags; → the files this rank wrote and
    the summary's best epoch and AUC."""
    import dataclasses

    from snuffy_tpu_torch.train.runner import Runner
    from snuffy_tpu_torch.train.trainer import SnuffyTrainer
    from snuffy_tpu_torch.train.schedules import make_epoch_schedule
    from snuffy_tpu_torch.utils.logging import MetricsLogger

    cfg = dataclasses.replace(cfg, num_epochs=2, bag_batch_size=4,
                              save_path=os.path.join(work, "runs"))
    rng = np.random.default_rng(3)

    def split(n):
        feats = [rng.standard_normal((int(k), cfg.model.feats_size)).astype(
            np.float32) for k in rng.integers(20, 60, n)]
        return ([np.array([float(i % 2)], np.float32) for i in range(n)],
                feats, None, None)

    data = [split(8), split(6), split(6)]
    audit.take()
    runner = Runner(cfg, SnuffyTrainer(cfg, device), *data,
                    MetricsLogger(os.path.join(cfg.save_path,
                                               "metrics.jsonl")))
    summary = runner.run(make_epoch_schedule("cosine", 1e-3, 2, 5e-6))
    return {"writes": audit.take(), "best_epoch": summary["best_epoch"],
            "best_valid_auc": summary["best_valid_auc"],
            "digest": digest(runner.trainer.model.state_dict().values())}


def tiny_vit(**kw):
    from snuffy_tpu_torch.models import vit as vit_mod

    kw.pop("patch_size", None)
    return vit_mod.VisionTransformer(patch_size=8, embed_dim=32, depth=1,
                                     num_heads=2, mlp_ratio=2.0, **kw)


def tiny_mae(**kw):
    from snuffy_tpu_torch.models import mae as mae_mod

    kw.pop("patch_size", None)
    return mae_mod.MaskedAutoencoderViT(
        patch_size=8, embed_dim=32, depth=1, num_heads=2,
        decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2,
        mlp_ratio=2.0, **kw)


def image_folder(root: str, n: int, size: int, seed: int) -> str:
    from snuffy_tpu_torch import native

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "a"), exist_ok=True)
    for i in range(n):
        native.write_jpeg(os.path.join(root, "a", f"{i:03}.jpeg"),
                          rng.integers(0, 256, (size, size, 3), np.uint8))
    return root


# tiny DINO / MAE CLI flags (the CPU tests' sizes); the data: 18 train
# images (9 a rank: 2 steps of 4) and 15 validation ones (8 and 7: 2
# batches against 1, the ranks agree on 1)
DINO_TINY = ["--arch=vit_tiny", "--batch_size_per_gpu=4", "--num_workers=0",
             "--img_size=32", "--global_size=32", "--local_size=16",
             "--local_crops_number=2", "--out_dim=32", "--warmup_epochs=1"]
MAE_TINY = ["--model=mae_vit_base_patch16", "--batch_size=4",
            "--num_workers=0", "--input_size=32", "--warmup_epochs=1"]


def scenario_dino(out: dict, size: str, device: torch.device, work: str,
                  audit: WriteAudit) -> None:
    from snuffy_tpu_torch import main_dino_adapter as cli
    from snuffy_tpu_torch.parallel import distributed
    from snuffy_tpu_torch.parallel.ssl_sharding import (
        replicate_state,
        shard_crops,
    )
    from snuffy_tpu_torch.ssl.augment import dino_multicrop_batch
    from snuffy_tpu_torch.utils.metrics_sync import mesh_metric_mean

    mesh = distributed_mesh()
    flags = (DINO_TINY + ["--compute_dtype=float32"] if size == "tiny"
             else ["--batch_size_per_gpu", str(64 // mesh.size)])
    flags = flags + ["--drop_path_rate=0", f"--device={device}"]
    args = cli.get_args_parser().parse_args(flags)
    n = args.batch_size_per_gpu * mesh.size
    u8 = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (n, args.img_size, args.img_size, 3), np.uint8)).to(device)
    # the crops drawn once (rank 0's, to every rank), then split
    g, loc = dino_multicrop_batch(
        u8, torch.Generator(device).manual_seed(2),
        n_local=args.local_crops_number, global_size=args.global_size,
        local_size=args.local_size,
        global_scale=tuple(args.global_crops_scale),
        local_scale=tuple(args.local_crops_scale))
    replicate_state((g, loc), mesh)
    step_args = (SSL_LR, 0.04, 0.996, 0.04, False)

    def build(m):
        trainer = cli.build_trainer(args, device, m)
        state = trainer.init_state(args.seed)
        adapters_for_parity(state.student, 3)
        state.teacher.load_state_dict(state.student.state_dict())
        return trainer, state

    trainer, state = build(mesh)
    replicate_state((state.student, state.teacher), mesh)
    path, seconds, grads = KernelPath(device), [], []
    for i in range(SSL_STEPS):
        t0 = time.perf_counter()
        with (path.run() if i == 0 else contextlib.nullcontext()), \
                gradients_to_update(trainer, grads):
            state, loss = trainer.step(state, shard_crops(g, mesh),
                                       shard_crops(loc, mesh), *step_args)
        sync(device)
        seconds.append(time.perf_counter() - t0)
    out["dino_step_s_ranks"] = seconds
    out["dino_launches"] = path.launches
    out["dino_peak_bytes"] = peak_memory(device)
    loss = float(mesh_metric_mean(loss, mesh))
    every = [*state.student.state_dict().values(),
             *state.teacher.state_dict().values(), state.center,
             *state.opt_state["exp_avg"].values(),
             *state.opt_state["exp_avg_sq"].values()]
    out["dino_digest"] = digest(every)
    # the parameters' bytes an all-reduce moves, bucket by bucket
    out["dino_buckets"] = bucket_stats(
        [p for _, p in trainer.trainable_params(state.student)], mesh)
    if distributed.rank() == 0:
        trainer1, state1 = build(None)
        seconds, grads1 = [], []
        for _ in range(SSL_STEPS):
            t0 = time.perf_counter()
            with gradients_to_update(trainer1, grads1):
                state1, loss1 = trainer1.step(state1, g, loc, *step_args)
            sync(device)
            seconds.append(time.perf_counter() - t0)
        out["dino_step_s_one"] = seconds
        tol = PARAM_TOL[args.compute_dtype]
        out["dino_loss"] = [loss, float(loss1)]
        out["dino_grads"] = [rel_err(a, b) for a, b in zip(grads, grads1)]
        out["dino_center"] = rel_err(state.center, state1.center)
        out["dino_student"] = compare_params(
            state.student.state_dict(), state1.student.state_dict(), tol)
        out["dino_teacher"] = compare_params(
            state.teacher.state_dict(), state1.teacher.state_dict(), tol)
        del trainer1, state1, grads1
    out["dino_kernel_errors"] = path.checked()
    del trainer, state, g, loc, u8, grads
    if size == "tiny":
        out["dino_cli"] = dino_cli(cli, work, audit)


def bucket_stats(params, mesh) -> List[dict]:
    """One all-reduce of gradients shaped as `params`, bucket by bucket:
    bytes and seconds (the device synchronised around each)."""
    from snuffy_tpu_torch.parallel.ssl_sharding import allreduce_gradients

    grads = [torch.ones_like(p) for p in params]
    allreduce_gradients(grads, mesh)         # warm the group
    stats: List[dict] = []
    allreduce_gradients(grads, mesh, stats=stats)
    return stats


def dino_cli(cli, work: str, audit: WriteAudit) -> dict:
    from snuffy_tpu_torch.models import vit as vit_mod
    from snuffy_tpu_torch.parallel import distributed

    if distributed.rank() == 0:
        image_folder(os.path.join(work, "imgs"), 18, 32, 4)
        image_folder(os.path.join(work, "val"), 15, 32, 5)
    distributed.barrier("images written")
    vit_mod.vit_tiny = tiny_vit
    audit.take()
    state = cli.main(DINO_TINY + [
        f"--data_path={work}/imgs", f"--valid_data_path={work}/val",
        f"--output_dir={work}/dino", "--epochs=2", "--device=cpu"])
    return {"steps": state.step, "writes": audit.take(),
            "digest": digest([*state.student.state_dict().values(),
                              *state.teacher.state_dict().values()])}


def scenario_mae(out: dict, size: str, device: torch.device, work: str,
                 audit: WriteAudit) -> None:
    from snuffy_tpu_torch import main_pretrain_adapter as cli
    from snuffy_tpu_torch.parallel import distributed
    from snuffy_tpu_torch.parallel.ssl_sharding import (
        replicate_state,
        shard_images,
    )
    from snuffy_tpu_torch.utils.metrics_sync import mesh_metric_mean

    mesh = distributed_mesh()
    flags = (MAE_TINY + ["--compute_dtype=float32"] if size == "tiny"
             else ["--batch_size", str(64 // mesh.size)])
    args = cli.get_args_parser().parse_args(flags + [f"--device={device}"])
    n = args.batch_size * mesh.size
    u8 = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (n, args.input_size, args.input_size, 3), np.uint8)
    ).to(device)

    def build(m):
        trainer = cli.build_trainer(args, device, m)
        trainer.augment = False       # the images as given, on both sides
        adapters_for_parity(trainer.model, 3)
        return trainer, trainer.init_state()

    trainer, state = build(mesh)
    replicate_state(state.model, mesh)
    tokens = trainer.model.grid ** 2
    noise = torch.rand((n, tokens),
                       generator=torch.Generator().manual_seed(4)).to(device)
    path, seconds, grads = KernelPath(device), [], []
    for i in range(SSL_STEPS):
        t0 = time.perf_counter()
        with (path.run() if i == 0 else contextlib.nullcontext()), \
                gradients_to_update(trainer, grads):
            state, loss = trainer.step(state, shard_images(u8, mesh), SSL_LR,
                                       noise=shard_images(noise, mesh))
        sync(device)
        seconds.append(time.perf_counter() - t0)
    out["mae_step_s_ranks"] = seconds
    out["mae_launches"] = path.launches
    out["mae_peak_bytes"] = peak_memory(device)
    loss = float(mesh_metric_mean(loss, mesh))
    out["mae_digest"] = digest([
        *state.model.state_dict().values(),
        *state.opt_state["exp_avg"].values(),
        *state.opt_state["exp_avg_sq"].values()])
    out["mae_buckets"] = bucket_stats(
        [p for _, p in trainer.trainable_params()], mesh)
    if distributed.rank() == 0:
        trainer1, state1 = build(None)
        seconds, grads1 = [], []
        for _ in range(SSL_STEPS):
            t0 = time.perf_counter()
            with gradients_to_update(trainer1, grads1):
                state1, loss1 = trainer1.step(state1, u8, SSL_LR,
                                              noise=noise)
            sync(device)
            seconds.append(time.perf_counter() - t0)
        out["mae_step_s_one"] = seconds
        out["mae_loss"] = [loss, float(loss1)]
        out["mae_grads"] = [rel_err(a, b) for a, b in zip(grads, grads1)]
        out["mae_params"] = compare_params(
            state.model.state_dict(), state1.model.state_dict(),
            PARAM_TOL[args.compute_dtype])
        del trainer1, state1, grads1
    out["mae_kernel_errors"] = path.checked()
    del trainer, state, u8, noise, grads
    if size == "tiny":
        out["mae_cli"] = mae_cli(cli, work, audit)


def mae_cli(cli, work: str, audit: WriteAudit) -> dict:
    from snuffy_tpu_torch.models import mae as mae_mod
    from snuffy_tpu_torch.parallel import distributed

    if distributed.rank() == 0:
        image_folder(os.path.join(work, "imgs"), 18, 32, 4)
        image_folder(os.path.join(work, "val"), 15, 32, 5)
    distributed.barrier("images written")
    mae_mod.mae_vit_base_patch16 = tiny_mae
    audit.take()
    state = cli.main(MAE_TINY + [
        f"--data_path={work}/imgs", f"--valid_data_path={work}/val",
        f"--output_dir={work}/mae", "--epochs=2", "--device=cpu"])
    return {"steps": state.step, "writes": audit.take(),
            "digest": digest(state.model.state_dict().values())}


def extract_flags(size: str) -> List[str]:
    """The extraction CLI's flags: ViT-S/8 + adapter in bf16 on the card
    (the Camelyon16 recipe), ViT-S/16 + adapter in f32 with no decode
    pool on the CPU; data under datasets/, output to embeddings/."""
    flags = ["--embedder", "DINO", "--backbone", "vit_small",
             "--use_adapter"]
    if size == "tiny":
        return flags + ["--patch_size", "16", "--batch_size", "3",
                        "--num_workers", "0", "--compute_dtype", "float32"]
    return flags + ["--patch_size", "8", "--compute_dtype", "bfloat16"]


def scenario_extract(out: dict, size: str, device: torch.device, work: str,
                     audit: WriteAudit) -> None:
    """The extraction CLI over the ranks, from <work>/ranks, once for each
    dataset under <work>/datasets: output to <work>/ranks/embeddings."""
    from snuffy_tpu_torch import compute_feats

    os.makedirs(os.path.join(work, "ranks"), exist_ok=True)
    os.chdir(os.path.join(work, "ranks"))
    audit.take()
    path, rows = KernelPath(device), {}
    t0 = time.perf_counter()
    with path.run():
        for name in sorted(os.listdir(os.path.join(work, "datasets"))):
            rows[name] = [list(r) for r in compute_feats.main(
                extract_flags(size) + [
                    "--datasets_path", os.path.join(work, "datasets"),
                    "--dataset", name, "--device", str(device)])]
    out["extract_s"] = time.perf_counter() - t0
    out["extract_launches"] = path.launches
    out["extract_rows"] = rows
    out["extract_writes"] = audit.take()
    out["extract_kernel_errors"] = path.checked()


def scenario_nccl1(out: dict, size: str, device: torch.device, work: str,
                   audit: WriteAudit) -> None:
    """A group of one rank: an all-reduce, and one DINO step under the
    mesh bit for bit the step without a group."""
    import torch.distributed as dist

    from snuffy_tpu_torch import main_dino_adapter as cli
    from snuffy_tpu_torch.ssl.augment import dino_multicrop_batch

    x = torch.arange(4.0, device=device)
    dist.all_reduce(x)
    out["allreduce"] = x.tolist()
    mesh = distributed_mesh()
    args = cli.get_args_parser().parse_args(
        ["--batch_size_per_gpu=16", f"--device={device}"])
    u8 = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (16, 224, 224, 3), np.uint8)).to(device)
    g, loc = dino_multicrop_batch(u8, torch.Generator(device).manual_seed(2),
                                  n_local=8, global_size=224, local_size=96)
    digests = []
    for m in (mesh, None):
        trainer = cli.build_trainer(args, device, m)
        state = trainer.init_state(args.seed)
        state, loss = trainer.step(
            state, g, loc, SSL_LR, 0.04, 0.996, 0.04, False,
            torch.Generator(device).manual_seed(6))
        digests.append(digest([loss, *state.student.state_dict().values(),
                               *state.teacher.state_dict().values(),
                               state.center]))
        del trainer, state
    out["nccl1_bitwise"] = digests[0] == digests[1]


SCENARIOS = {"mil": scenario_mil, "dino": scenario_dino,
             "mae": scenario_mae, "extract": scenario_extract,
             "nccl1": scenario_nccl1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("scenarios", help="comma-separated, of: "
                   + ", ".join(sorted(SCENARIOS)))
    p.add_argument("workdir")
    p.add_argument("--size", default="tiny", choices=["tiny", "full"])
    p.add_argument("--device", default="cpu")
    p.add_argument("--backend", default=None)
    args = p.parse_args(argv)
    names = args.scenarios.split(",")
    unknown = set(names) - set(SCENARIOS)
    if unknown:
        p.error(f"unknown scenario(s) {sorted(unknown)}")

    from snuffy_tpu_torch.parallel import distributed

    torch.manual_seed(0)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    audit = WriteAudit(args.workdir)
    with distributed.session(args.backend, args.device):
        device = distributed.rank_device(args.device)
        out = {"rank": distributed.rank(),
               "world": distributed.world_size(),
               "backend": str(torch.distributed.get_backend()),
               "device": str(device)}
        for name in names:
            if device.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            SCENARIOS[name](out, args.size, device, args.workdir, audit)
        distributed.barrier("scenario done")
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
