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
  sp, tp, sptp
           one MIL step of 8 bags with `use_mesh=1` factored as sp=2, tp=2
           or sp=2 × tp=2 (4 ranks) at ρ = 0 and no dropout against one
           rank stepping them packed (outputs, the gradients before the
           clip, the parameters); the step's collectives (the audit of
           `parallel/collectives`), then a warm step with each all-reduce
           timed; a step at ρ = 0.5 and dropout 0.1; every rank's whole
           model's checksum; (sp, tiny) the training CLI with
           `--use_mesh 1 --remat 1`.
  remat    an sp=2 step at ρ = 0.5 and dropout 0.1 with remat and
           without: outputs, gradients and parameters bitwise.
  long     one bag of 4× the largest rows (40960 on the card) forward and
           backward over sp=2 against one rank: scores, gradients, peak
           memory.
  ckpt:save, ckpt:restore
           (two launches) a tp=2 trainer's state after a step saved by
           `train/checkpoint.ShardedCheckpointManager`; fresh ranks read
           it back once `saved_and_exited` says the savers have exited
           (they may start before): each rank's shards' checksums and
           shapes.
  dino_bn  `dino` with the head's BatchNorms over the ranks
           (`--use_bn_in_head`); keys prefixed dino_bn.

Each rank reports the files it opened for writing under the workdir (an
audit hook), its kernels' launch counts on the scenario's path (from 0
just before it), the largest error of each kernel's first launch at each
shape against its plain version (on the card), step seconds and peak
memory.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
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
# the DINO head's Linear biases that a BatchNorm follows (use_bn_in_head)
PRE_BN_BIASES = ("head.mlp.0.bias", "head.mlp.3.bias")
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


class Launch:
    """`scenario` (or several, comma-separated, in one run) started on
    `world` ranks, each a process of this module with torchrun's
    environment and 2 OpenMP threads. `results()` waits for them and
    returns their RESULT dicts in rank order (each with "ready_at", the
    time.time() at which its group was up, against this object's
    `started_at`, and "scenario_s", each scenario's seconds); it raises when a rank
    fails, prints no result, or any is still running `timeout` seconds
    after the start (then every rank is killed). `close()` kills what
    still runs."""

    def __init__(self, scenario: str, workdir: str, world: int = 2,
                 size: str = "tiny", device: str = "cpu",
                 backend: Optional[str] = None, timeout: float = 120.0):
        self.scenario, self.timeout = scenario, timeout
        port = str(free_port())
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "MASTER_ADDR", "MASTER_PORT")}
        env.update(MASTER_ADDR="localhost", MASTER_PORT=port,
                   WORLD_SIZE=str(world), OMP_NUM_THREADS="2",
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        cmd = [sys.executable, "-m", "snuffy_tpu_torch.tools.multiproc_worker",
               scenario, workdir, "--size", size, "--device", device]
        if backend:
            cmd += ["--backend", backend]
        self.logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
        self.procs: List[subprocess.Popen] = []
        self.deadline = time.monotonic() + timeout
        self.started_at = time.time()
        try:
            for r in range(world):
                self.procs.append(subprocess.Popen(
                    cmd, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                    stdout=self.logs[r], stderr=subprocess.STDOUT,
                    text=True, cwd=REPO))
        except BaseException:
            self.close()
            raise

    def results(self) -> List[dict]:
        try:
            for p in self.procs:
                try:
                    p.wait(timeout=max(self.deadline - time.monotonic(),
                                       0.1))
                except subprocess.TimeoutExpired:
                    raise TimeoutError(
                        f"{self.scenario}: a rank is still running after "
                        f"{self.timeout} s (a collective waiting on a "
                        "rank?)\n" + _tails(self.logs)) from None
            results = []
            for r, (p, f) in enumerate(zip(self.procs, self.logs)):
                f.seek(0)
                lines = [ln for ln in f.read().splitlines()
                         if ln.startswith("RESULT ")]
                if p.returncode != 0 or not lines:
                    raise RuntimeError(f"{self.scenario}: rank {r} exited "
                                       f"{p.returncode}\n"
                                       + _tails(self.logs))
                results.append(json.loads(lines[-1][len("RESULT "):]))
            return results
        finally:
            self.close()

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            if not f.closed:
                f.close()


def launch(scenario: str, workdir: str, world: int = 2, size: str = "tiny",
           device: str = "cpu", backend: Optional[str] = None,
           timeout: float = 120.0) -> List[dict]:
    """`Launch(...).results()`: start the ranks and wait for them."""
    return Launch(scenario, workdir, world, size, device, backend,
                  timeout).results()


def saved_and_exited(workdir: str) -> None:
    """Tell the ranks of a `ckpt:restore` launch, started early so that
    their start-up overlaps other work, that the ranks of `ckpt:save`
    have exited: they restore only then."""
    with open(os.path.join(workdir, CKPT_GO), "w"):
        pass


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
    mesh; under tp the whole model's, gathered), and w's, flat."""
    from snuffy_tpu_torch.parallel import collectives
    from snuffy_tpu_torch.parallel.sharded_train import gather_state
    from snuffy_tpu_torch.train import trainer as trainer_mod

    clip = trainer_mod.clip_by_global_norm

    def keeping(params, max_norm, mesh=None, names=None):
        params = list(params)
        names = names or [str(i) for i in range(len(params))]
        with collectives.audit():   # the check's gather, not the step's
            grads = gather_state({n: p.grad for n, p in zip(names, params)
                                  if p.grad is not None}, mesh)
        kept.append(flat_f32([*grads.values(), trainer.w.grad]))
        return clip(params, max_norm, mesh, names)

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

def mil_bags(size: str, d: int, device: torch.device, bags: int = MIL_BAGS,
             rows=None, seed: int = 0):
    """(feats (bags, n, d), masks, labels (bags, 1)): the same bags on
    every rank, `rows` (n, least valid, most valid) or MIL_ROWS[size]."""
    n_pad, lo, hi = rows or MIL_ROWS[size]
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.standard_normal(
        (bags, n_pad, d)).astype(np.float32)).to(device)
    valid = rng.integers(lo, hi + 1, bags)
    masks = (torch.arange(n_pad)[None] < torch.from_numpy(valid)[:, None]
             ).to(device)
    labels = torch.from_numpy(rng.integers(0, 2, (bags, 1)).astype(
        np.float32)).to(device)
    return feats, masks, labels


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
    feats, masks, labels = mil_bags(size, cfg.model.feats_size, device)
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
                  audit: WriteAudit, use_bn: bool = False,
                  dtype: Optional[str] = None) -> None:
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
    flags = flags + ["--drop_path_rate=0", f"--device={device}"] + (
        ["--use_bn_in_head=true"] if use_bn else []) + (
        [f"--compute_dtype={dtype}"] if dtype else [])
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
        named = trainer1.trainable_params(state1.student)
        out["dino_grad_worst"] = worst_tensor(
            [n for n, _ in named], [p.numel() for _, p in named], grads[-1],
            grads1[-1])
        out["dino_center"] = rel_err(state.center, state1.center)
        want = state1.student.state_dict()
        # with BatchNorms in the head, the biases of the Linears before
        # them have a true gradient of 0: Adam moves them by up to lr a
        # step on rounding noise alone (held to 2·lr·steps by themselves)
        noise = [k for k in want if use_bn and k.endswith(PRE_BN_BIASES)]
        out["dino_student"] = compare_params(
            state.student.state_dict(),
            {k: v for k, v in want.items() if k not in noise}, tol)
        if noise:
            out["dino_noise_biases"] = compare_params(
                state.student.state_dict(),
                {k: want[k] for k in noise}, tol)[0]
        out["dino_teacher"] = compare_params(
            state.teacher.state_dict(), state1.teacher.state_dict(), tol)
        del trainer1, state1, grads1
    out["dino_kernel_errors"] = path.checked()
    if use_bn:
        out["dino_running"] = digest(
            [b for net in (state.student, state.teacher)
             for n, b in net.named_buffers() if "running" in n])
    del trainer, state, g, loc, u8, grads
    if size == "tiny" and not use_bn:
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



# ------------------------------------------------ sp, tp, remat, checkpoints

# the factoring each scenario forces on use_mesh=1: (dp, sp, tp)
MESH_SPECS = {"sp": (1, 2, 1), "tp": (1, 1, 2), "sptp": (1, 2, 2)}
# the card's long bag: 4× the largest bucket, its rows split over sp=2
LONG_ROWS = 40960
CKPT_DIR = "ckpt"
CKPT_GO = "ckpt.go"     # written by `saved_and_exited`
# the one-rank step the sp, tp and sp×tp steps are held to, kept in the
# process (rank 0) for the next scenario of the same launch
_ONE_RANK: Dict[str, dict] = {}


@contextlib.contextmanager
def factored_as(spec):
    """Inside it, the trainer's use_mesh=1 factors the ranks as `spec` (a
    MeshSpec) in place of `factor_devices`' default."""
    from snuffy_tpu_torch.train import trainer as trainer_mod

    factor = trainer_mod.factor_devices
    trainer_mod.factor_devices = lambda n, procs=1: spec
    try:
        yield
    finally:
        trainer_mod.factor_devices = factor


def mesh_cfg(size: str, rho: float = 0.0, rate: float = 0.0,
             remat: bool = False, use_mesh: int = 1):
    from snuffy_tpu_torch.configs import (
        MILTrainConfig,
        OptimizerConfig,
        SnuffyModelConfig,
    )

    model = SnuffyModelConfig(**MIL[size], random_patch_share=rho,
                              attention_dropout=rate, remat=remat)
    return MILTrainConfig(
        model=model, soft_average=True, bag_batch_size=MIL_BAGS, seed=1,
        use_mesh=use_mesh,
        optim=OptimizerConfig(optimizer="adamw", lr=MIL_LR,
                              weight_decay=5e-2, clip_grad=MIL_CLIP))


def mesh_trainer(cfg, device, spec=None):
    """A trainer on `spec`'s mesh (None: no mesh), at its init state."""
    from snuffy_tpu_torch.train.trainer import SnuffyTrainer

    if spec is None:
        trainer = SnuffyTrainer(cfg, device)
    else:
        with factored_as(spec):
            trainer = SnuffyTrainer(cfg, device)
    trainer.init_state(cfg.seed)
    trainer.model.train()
    trainer.set_lr(MIL_LR)
    return trainer


def mil_gens(device: torch.device, i: int):
    return (torch.Generator(device).manual_seed(11 + i),
            torch.Generator().manual_seed(12 + i))


def whole_params(trainer) -> Dict[str, torch.Tensor]:
    state, w = trainer.state_dict()
    return {**state, "w": torch.tensor(w)}


def audit_rows(records) -> List[list]:
    """[axis, what, shape, elements, bytes(, seconds)] a collective."""
    return [[r["axis"], r["what"], r["shape"], r["numel"], r["bytes"]]
            + ([r["s"]] if "s" in r else []) for r in records]


def one_rank_reference(size: str, device: torch.device, batch) -> dict:
    """One rank stepping all the bags packed, from the same weights: the
    outputs, the gradients before the clip and the parameters."""
    key = f"{size}:{device}"
    if key not in _ONE_RANK:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        trainer = mesh_trainer(mesh_cfg(size, use_mesh=0), device)
        grads = []
        t0 = time.perf_counter()
        with gradients_before_clip(trainer, grads):
            got = trainer.packed_train_step(*batch, *mil_gens(device, 0))
        sync(device)
        _ONE_RANK[key] = {"out": [t.cpu() for t in got], "grads": grads,
                          "params": whole_params(trainer),
                          "s": time.perf_counter() - t0,
                          "peak": peak_memory(device)}
    return _ONE_RANK[key]


def scenario_mesh(kind: str, out: dict, size: str, device: torch.device,
                  work: str, audit: WriteAudit) -> None:
    """One step of 8 bags on the `kind` mesh (use_mesh=1 factored as
    MESH_SPECS[kind]) at ρ = 0 and no dropout against one rank stepping
    them packed; the collectives of the step; a step at ρ = 0.5 and rate
    0.1; K1/K2's first launches at the new shapes."""
    from snuffy_tpu_torch.parallel import collectives, distributed
    from snuffy_tpu_torch.parallel.mesh import MeshSpec
    from snuffy_tpu_torch.parallel.sharded_train import (
        make_sharded_batch_train_step,
    )

    spec = MeshSpec(*MESH_SPECS[kind])
    cfg = mesh_cfg(size)
    feats, masks, labels = mil_bags(size, cfg.model.feats_size, device)
    batch = (feats, masks, labels, torch.ones(MIL_BAGS, device=device))
    trainer = mesh_trainer(cfg, device, spec)
    mesh = trainer.mesh
    out[f"{kind}_mesh"] = [mesh.rank, mesh.size, mesh.sp_rank, mesh.sp,
                           mesh.tp_rank, mesh.tp]
    out[f"{kind}_dtype"] = cfg.model.compute_dtype
    step = make_sharded_batch_train_step(trainer, mesh)
    path, grads = KernelPath(device), []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with path.run(), gradients_before_clip(trainer, grads), \
            collectives.audit() as records:
        got = step(*batch, *mil_gens(device, 0))
    sync(device)
    out[f"{kind}_step_s_ranks"] = [time.perf_counter() - t0]
    out[f"{kind}_peak_bytes"] = peak_memory(device)
    out[f"{kind}_launches"] = path.launches
    out[f"{kind}_audit"] = audit_rows(records)
    params = whole_params(trainer)
    out[f"{kind}_digest"] = digest(params.values())
    out[f"{kind}_n_params"] = sum(p.numel() for p in params.values())
    out[f"{kind}_local_params"] = sum(
        p.numel() for p in trainer.model.parameters()) + 1
    if distributed.rank() == 0:
        one = one_rank_reference(size, device, batch)
        out[f"{kind}_step_s_one"] = [one["s"]]
        out[f"{kind}_peak_bytes_one"] = one["peak"]
        out[f"{kind}_errors"] = [rel_err(a, b)
                                 for a, b in zip(got, one["out"])]
        out[f"{kind}_grads"] = [rel_err(a, b)
                                for a, b in zip(grads, one["grads"])]
        out[f"{kind}_params"] = compare_params(
            params, one["params"], PARAM_TOL[cfg.model.compute_dtype])
    out[f"{kind}_kernel_errors"] = path.checked()
    # a warm step, each all-reduce timed (the device synchronised around)
    t0 = time.perf_counter()
    with collectives.audit(timed=True) as records:
        step(*batch, *mil_gens(device, 1))
    sync(device)
    out[f"{kind}_step_s_ranks"].append(time.perf_counter() - t0)
    out[f"{kind}_audit_timed"] = audit_rows(records)
    del trainer, step, got, grads
    # the training point's randomness: every replica the same bits
    rand = mesh_trainer(mesh_cfg(size, rho=0.5, rate=0.1), device, spec)
    losses, scores, _ = make_sharded_batch_train_step(rand, rand.mesh)(
        *batch, *mil_gens(device, 2))
    out[f"{kind}_rand_finite"] = bool(torch.isfinite(losses).all()
                                      and torch.isfinite(scores).all())
    out[f"{kind}_rand_digest"] = digest(whole_params(rand).values())
    del rand


def scenario_sp(out, size, device, work, audit):
    scenario_mesh("sp", out, size, device, work, audit)
    if size == "tiny":
        out["mesh_cli"] = mesh_cli(work, audit)


def scenario_tp(out, size, device, work, audit):
    scenario_mesh("tp", out, size, device, work, audit)


def scenario_sptp(out, size, device, work, audit):
    scenario_mesh("sptp", out, size, device, work, audit)


def scenario_remat(out: dict, size: str, device: torch.device, work: str,
                   audit: WriteAudit) -> None:
    """One step on the sp mesh at ρ = 0.5 and rate 0.1 with remat and
    without, from the same weights and generators: outputs and gradients
    bitwise equal; K1's launches and the peak memory of each."""
    from snuffy_tpu_torch.parallel.mesh import MeshSpec
    from snuffy_tpu_torch.parallel.sharded_train import (
        make_sharded_batch_train_step,
    )

    spec = MeshSpec(*MESH_SPECS["sp"])
    feats, masks, labels = mil_bags(size, MIL[size]["feats_size"], device)
    batch = (feats, masks, labels, torch.ones(MIL_BAGS, device=device))
    got = {}
    for remat in (False, True):
        trainer = mesh_trainer(mesh_cfg(size, 0.5, 0.1, remat), device, spec)
        step = make_sharded_batch_train_step(trainer, trainer.mesh)
        path, grads = KernelPath(device), []
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        with path.run(), gradients_before_clip(trainer, grads):
            outs = step(*batch, *mil_gens(device, 3))
        got[remat] = (outs, grads, whole_params(trainer))
        out[f"remat{int(remat)}_launches"] = path.launches
        out[f"remat{int(remat)}_peak_bytes"] = peak_memory(device)
        del trainer, step
    (o0, g0, p0), (o1, g1, p1) = got[False], got[True]
    out["remat_bitwise"] = {
        "outputs": all(torch.equal(a, b) for a, b in zip(o0, o1)),
        "grads": all(torch.equal(a, b) for a, b in zip(g0, g1)),
        "params": all(torch.equal(p0[k], p1[k]) for k in p0)}


def scenario_long(out: dict, size: str, device: torch.device, work: str,
                  audit: WriteAudit) -> None:
    """One bag of LONG_ROWS rows (the CPU: 4× the tiny bucket), forward
    and backward under sp = 2 against one rank: scores, the gradients,
    peak memory."""
    from snuffy_tpu_torch.models.snuffy import build_milnet
    from snuffy_tpu_torch.parallel import distributed
    from snuffy_tpu_torch.parallel.collectives import all_reduce_
    from snuffy_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from snuffy_tpu_torch.parallel.sharded_train import partial_axes
    from snuffy_tpu_torch.train.losses import mixed_mil_loss

    rows = LONG_ROWS if size == "full" else 4 * MIL_ROWS["tiny"][0]
    cfg = mesh_cfg(size).model
    feats, masks, labels = mil_bags(size, cfg.feats_size, device, bags=1,
                                    rows=(rows, rows - 7, rows - 7), seed=5)
    mesh = make_mesh(MeshSpec(*MESH_SPECS["sp"]))
    w = torch.tensor(0.5, device=device)

    def fwd_bwd(model, f, m, msh):
        model.train()
        if device.type == "cuda":
            sync(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        ins, bag = model(f, m, generator=torch.Generator(device).manual_seed(
            1), seed_generator=torch.Generator().manual_seed(2))
        loss, score = mixed_mil_loss(ins, bag, labels[0], m, w, mesh=msh)
        loss.backward()
        sync(device)
        grads = {n: p.grad for n, p in model.named_parameters()}
        return (torch.sigmoid(ins.detach()), score.detach(), grads,
                time.perf_counter() - t0, peak_memory(device))

    per = rows // 2
    mine = slice(mesh.sp_rank * per, (mesh.sp_rank + 1) * per)
    model = build_milnet(cfg, 1, device, mesh=mesh)
    path = KernelPath(device)
    with path.run():
        ins, score, grads, s, peak = fwd_bwd(model, feats[0, mine],
                                             masks[0, mine], mesh)
    out["long_launches"] = path.launches
    for name, g in grads.items():
        if "sp" in partial_axes(name, mesh):
            all_reduce_(g, mesh, "sp", "gradients")
    ins_all = torch.cat(distributed.host_allgather_tensor(ins), dim=0)
    out["long_s_ranks"], out["long_peak_bytes"] = s, peak
    out["long_rows"] = rows
    if distributed.rank() == 0:
        one = build_milnet(cfg, 1, device)
        ins1, score1, grads1, s1, peak1 = fwd_bwd(one, feats[0], masks[0],
                                                  None)
        out["long_s_one"], out["long_peak_bytes_one"] = s1, peak1
        out["long_errors"] = [rel_err(ins_all, ins1), rel_err(score, score1)]
        out["long_grads"] = rel_err(flat_f32(grads.values()),
                                    flat_f32(grads1.values()))
    out["long_kernel_errors"] = path.checked()
    del model, grads


def scenario_ckpt(out: dict, size: str, device: torch.device, work: str,
                  audit: WriteAudit, phase: str) -> None:
    """save: a step on the tp mesh, then the sharded checkpoint of its
    state (each rank its blocks); restore (a fresh launch): the state of
    a fresh trainer read back from it. Each rank reports its shards'
    checksums and shapes, and (save) the files it wrote."""
    from snuffy_tpu_torch.parallel.mesh import MeshSpec
    from snuffy_tpu_torch.parallel.sharded_train import (
        make_sharded_batch_train_step,
    )
    from snuffy_tpu_torch.train.checkpoint import ShardedCheckpointManager

    trainer = mesh_trainer(mesh_cfg(size), device,
                           MeshSpec(*MESH_SPECS["tp"]))
    while phase == "restore" and not os.path.exists(
            os.path.join(work, CKPT_GO)):
        time.sleep(0.1)    # the launch's timeout ends a wait that hangs
    mgr = ShardedCheckpointManager(os.path.join(work, CKPT_DIR),
                                   max_to_keep=2, mesh=trainer.mesh)
    if phase == "save":
        feats, masks, labels = mil_bags(size, MIL[size]["feats_size"],
                                        device)
        make_sharded_batch_train_step(trainer, trainer.mesh)(
            feats, masks, labels, torch.ones(MIL_BAGS, device=device),
            *mil_gens(device, 4))
        state = trainer.sharded_state()
        audit.take()
        t0 = time.perf_counter()
        mgr.save(1, state, metrics={"valid_auc": 0.75})
        out["ckpt_save_s"] = time.perf_counter() - t0
        out["ckpt_writes"] = audit.take()
    else:
        t0 = time.perf_counter()
        state = mgr.restore(mgr.latest_step(), trainer.sharded_state())
        out["ckpt_restore_s"] = time.perf_counter() - t0
        trainer.load_sharded_state(state)
        state = trainer.sharded_state()
        out["ckpt_steps"] = [mgr.all_steps(), mgr.best_step()]
    out[f"ckpt_{phase}_shards"] = {k: [digest([v]), list(v.shape)]
                                   for k, v in state.items()}
    out["ckpt_tp_rank"] = trainer.mesh.tp_rank


def scenario_dino_bn(out: dict, size: str, device: torch.device, work: str,
                     audit: WriteAudit, dtype: Optional[str] = None) -> None:
    """`scenario_dino` with the head's BatchNorms (`--use_bn_in_head`),
    their statistics over the ranks, in `dtype` (the CLI's default, or
    float32); its keys prefixed dino_bn (dino_bn32 in float32)."""
    got: dict = {}
    scenario_dino(got, size, device, work, audit, use_bn=True, dtype=dtype)
    prefix = "dino_bn32" if dtype == "float32" else "dino_bn"
    out.update({k.replace("dino", prefix, 1): v for k, v in got.items()})


def worst_tensor(names, numels, got, want) -> list:
    """[name, |diff| / max |want| of the tensor, its max |want|] of the
    tensor of the flat `got` farthest from `want`, relative to max |want|
    of the whole."""
    scale = max(float(want.abs().max()), 1e-30)
    worst = ["", 0.0, 0.0]
    for name, a, b in zip(names, got.split(numels), want.split(numels)):
        err = float((a - b).abs().max()) / scale
        if err > worst[1]:
            worst = [name, err, float(b.abs().max())]
    return worst


def mesh_cli(work: str, audit: WriteAudit) -> dict:
    """The training CLI with --use_mesh 1 --remat 1 over the ranks on a
    tiny Camelyon16-layout tree: → the files this rank wrote, the summary's
    best epoch, and the best .pth's digest as the one-rank model loads
    it."""
    from snuffy_tpu_torch.embed.pipeline import (
        save_class_features,
        write_bag_csv,
    )
    from snuffy_tpu_torch.parallel import distributed
    from snuffy_tpu_torch.train import cli

    root = os.path.join(work, "cli")
    if distributed.rank() == 0:
        rng = np.random.default_rng(9)
        out_dir = os.path.join(root, "embeddings", "camelyon16", "dino")
        for split, count in (("train", 8), ("valid", 4), ("test", 4)):
            for i in range(count):
                x = rng.standard_normal((18, 16)).astype(np.float32)
                x[:4] += 2.0 * (i % 2)
                write_bag_csv(os.path.join(out_dir, split, f"class{i % 2}",
                                           f"{split}_{i}.csv"), x)
        save_class_features(out_dir, "camelyon16.csv", seed=1)
    distributed.barrier("cli tree written")
    cwd = os.getcwd()
    os.chdir(root)
    audit.take()
    try:
        summary = cli.main([
            "--dataset=camelyon16", "--embedding=dino", "--feats_size=16",
            "--num_heads=2", "--big_lambda=8", "--random_patch_share=0.5",
            "--num_epochs=2", "--lr=2e-3", "--optimizer=adamw",
            "--bag_batch_size=2", "--use_mesh=1", "--remat=1",
            "--wandb_run=run", "--use_mp=0", "--device=cpu"])
    finally:
        os.chdir(cwd)
    writes = audit.take()
    pth = os.path.join(root, "runs", "camelyon16", "run",
                       f"{summary['best_epoch']}.pth")
    return {"writes": writes, "best_epoch": summary["best_epoch"],
            "pth": os.path.relpath(pth, work)}


SCENARIOS = {"mil": scenario_mil, "dino": scenario_dino,
             "mae": scenario_mae, "extract": scenario_extract,
             "nccl1": scenario_nccl1, "sp": scenario_sp,
             "tp": scenario_tp, "sptp": scenario_sptp,
             "remat": scenario_remat, "long": scenario_long,
             "ckpt:save": functools.partial(scenario_ckpt, phase="save"),
             "ckpt:restore": functools.partial(scenario_ckpt,
                                               phase="restore"),
             "dino_bn": scenario_dino_bn,
             "dino_bn:f32": functools.partial(scenario_dino_bn,
                                              dtype="float32")}


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
               "device": str(device), "ready_at": time.time(),
               "scenario_s": {}}
        for name in names:
            if device.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            SCENARIOS[name](out, args.size, device, args.workdir, audit)
            out["scenario_s"][name] = time.perf_counter() - t0
        distributed.barrier("scenario done")
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
