"""DINO-with-adapter self-supervised trainer in PyTorch.

The port of `snuffy_tpu/ssl/dino.py` (the reference DINO-adapter stage,
reference dino_adapter/main_dino_adapter.py):

  * student and teacher are `MultiCropWrapper`s, a ViT backbone and a
    `DINOHead` under the reference's names (`backbone.*`, `head.*`): one
    backbone call per crop resolution, one head call over every view's CLS
    output (reference main_dino_adapter.py:228-237);
  * `dino_loss`, with the teacher-temperature warmup and the centre EMA
    (reference :618-671);
  * the adapter freeze: only the adapters and the head train
    (`is_trainable`, reference :307-314), the rest has requires_grad off;
  * per-parameter gradient clipping and last-layer cancelling
    (reference dino_adapter/utils.py:137-154);
  * adamw, sgd (momentum 0.9) or LARS, and the teacher EMA.

The optimizer is written out on tensors, as the JAX step computes it,
not through `torch.optim`: the JAX step runs
`optax.masked(chain(scale_by_adam(), scale(-1)))` over the whole student,
which keeps ONE step count for the tree, and feeds the cancelled last
layer zero gradients during the `freeze_last_layer` epochs. So its
moments decay through the freeze and the shared count still rises; only
its parameter update is skipped. `torch.optim.AdamW` would skip a
parameter whose grad is None altogether, and differ on the first step
after the freeze. Weight decay is folded as the JAX step folds it: adamw
decoupled (p −= lr·wd·p after the Adam step), sgd and LARS into the
gradient before the momentum, and only for parameters whose JAX leaf has
more than one dimension (biases, norms, `last_layer.weight_g` and a
learnable adapter `scale` are exempt).

The teacher sees only the 2 global views; it runs its backbone
deterministically and its head's BatchNorm (with `use_bn_in_head`) on
batch statistics, as a torch module left in train mode under no_grad.

Under data parallelism (`mesh`, `parallel/mesh.py`), each rank steps on
its own rows: the gradients are averaged over the ranks before the clip
(the reference clips after DDP's all-reduce), the batch centre is the
global batch's mean (reference main_dino_adapter.py:666-668), and
`eval_loss` the ranks' mean. Every rank holds the same batch size, so the
mean of the ranks' means is the global mean. The head's BatchNorms (with
`use_bn_in_head`) normalise the student's and the teacher's rows with
the global batch's statistics, as the JAX step's over its dp-sharded
batch (`models/vit.BatchNorm` with the mesh set).
"""

from __future__ import annotations

import copy
import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from snuffy_tpu_torch.models.vit import (
    BatchNorm,
    DINOHead,
    VisionTransformer,
)
from snuffy_tpu_torch.parallel.mesh import Mesh
from snuffy_tpu_torch.parallel.ssl_sharding import allreduce_gradients
from snuffy_tpu_torch.ssl.adam import adam_directions, init_adam_state
from snuffy_tpu_torch.ssl.lars import jax_ndim, lars_direction
from snuffy_tpu_torch.utils.metrics_sync import mesh_metric_mean

OPTIMIZERS = ("adamw", "sgd", "lars")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class MultiCropWrapper(nn.Module):
    """A backbone and a head under the reference's names."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head


@dataclasses.dataclass
class DINOState:
    student: MultiCropWrapper
    teacher: MultiCropWrapper
    center: torch.Tensor           # (1, out_dim)
    opt_state: dict                # see DINOTrainer.init_opt_state
    step: int = 0


def is_trainable(name: str, freeze_backbone: bool) -> bool:
    """Adapter finetuning: the head always trains, the backbone only its
    adapter branches (the JAX `is_trainable_path` on a torch name)."""
    if name.startswith("head."):
        return True
    return not freeze_backbone or "adaptmlp" in name


def clip_gradients_per_param(grads: List[torch.Tensor], clip: float
                             ) -> List[torch.Tensor]:
    """DINO's per-parameter clip: g·min(1, clip/(‖g‖ + 1e-6)) (reference
    dino_adapter/utils.py:137-146)."""
    norms = torch.stack(torch._foreach_norm(grads))
    factors = torch.clamp(clip / (norms + 1e-6), max=1.0)
    return torch._foreach_mul(grads, list(factors.unbind()))


class DINOTrainer:
    """The JAX `DINOTrainer`'s arguments, on a port `VisionTransformer`
    (`backbone`) and a device (the backbone's)."""

    def __init__(
        self,
        backbone: VisionTransformer,
        out_dim: int = 65536,
        warmup_teacher_temp: float = 0.04,
        teacher_temp: float = 0.04,
        warmup_teacher_temp_epochs: int = 0,
        student_temp: float = 0.1,
        center_momentum: float = 0.9,
        n_local_crops: int = 8,
        local_size: int = 96,
        global_size: int = 224,
        freeze_backbone: bool = True,
        freeze_last_layer: int = 1,
        clip_grad: Optional[float] = 3.0,
        norm_last_layer: bool = True,
        head_hidden_dim: int = 2048,
        head_bottleneck_dim: int = 256,
        optimizer: str = "adamw",
        use_bn_in_head: bool = False,
        crop_pack: int = 1,
        mesh: Optional[Mesh] = None,
    ):
        if optimizer not in OPTIMIZERS:
            raise KeyError(f"Optimizer not found. Given: {optimizer}, "
                           f"Have: {list(OPTIMIZERS)}")
        self.mesh = mesh
        self.backbone = backbone
        self.head_kw = dict(out_dim=out_dim, hidden_dim=head_hidden_dim,
                            bottleneck_dim=head_bottleneck_dim,
                            use_bn=use_bn_in_head,
                            norm_last_layer=norm_last_layer)
        self.out_dim = out_dim
        self.student_temp = student_temp
        self.center_momentum = center_momentum
        self.n_local = n_local_crops
        self.local_size = local_size
        self.global_size = global_size
        self.freeze_backbone = freeze_backbone
        self.freeze_last_layer = freeze_last_layer
        self.clip_grad = clip_grad
        self.warmup_teacher_temp = warmup_teacher_temp
        self.teacher_temp = teacher_temp
        self.warmup_teacher_temp_epochs = warmup_teacher_temp_epochs
        self.optimizer = optimizer
        self.crop_pack = crop_pack
        self._warned_pack_drop = False

    # ------------------------------------------------------------ building

    def teacher_temp_at(self, epoch: int) -> float:
        """Linear warmup then constant (reference main_dino_adapter.py:633-639)."""
        if epoch < self.warmup_teacher_temp_epochs:
            span = self.warmup_teacher_temp_epochs
            return self.warmup_teacher_temp + (
                self.teacher_temp - self.warmup_teacher_temp
            ) * epoch / span
        return self.teacher_temp

    def init_state(self, seed: int = 0) -> DINOState:
        """Student = the backbone + a head drawn from `seed`; the teacher a
        copy; centre 0; the optimizer's state at zero."""
        device = next(self.backbone.parameters()).device
        head = DINOHead(self.backbone.embed_dim, seed=seed,
                        **self.head_kw).to(device)
        student = MultiCropWrapper(self.backbone, head)
        teacher = copy.deepcopy(student)
        for p in teacher.parameters():
            p.requires_grad_(False)
        for m in (*student.head.modules(), *teacher.head.modules()):
            if isinstance(m, BatchNorm):
                m.mesh = self.mesh
        for name, p in student.named_parameters():
            p.requires_grad_(self.trainable(name))
        return DINOState(student, teacher,
                         torch.zeros((1, self.out_dim), device=device),
                         self.init_opt_state(student))

    def trainable(self, name: str) -> bool:
        """Trains under the freeze; a fixed weight-norm g never trains."""
        return (is_trainable(name, self.freeze_backbone)
                and not (name.endswith("last_layer.weight_g")
                         and self.head_kw["norm_last_layer"]))

    def trainable_params(self, student: nn.Module
                         ) -> List[Tuple[str, nn.Parameter]]:
        return [(n, p) for n, p in student.named_parameters()
                if self.trainable(n)]

    def init_opt_state(self, student: nn.Module) -> dict:
        """adamw: {'count': int32 0-d, 'exp_avg': {name: μ}, 'exp_avg_sq':
        {name: ν}}, one shared count (optax's); sgd and lars:
        {'momentum_buffer': {name: m}}. One buffer a trainable parameter."""
        params = dict(self.trainable_params(student))
        if self.optimizer == "adamw":
            return init_adam_state(params)
        return {"momentum_buffer": {n: torch.zeros_like(p)
                                    for n, p in params.items()}}

    # ------------------------------------------------------------ forwards

    def forward_views(self, net: MultiCropWrapper, globals_, locals_,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """(2, B, gs, gs, 3) + (L, B, ls, ls, 3) → (2+L, B, out_dim): one
        backbone call a resolution (views folded into the batch, the local
        ones packed `crop_pack` a sequence), one head call over all, in
        the modes the modules are in."""
        def run(crops, pack=1):
            v, b = crops.shape[0], crops.shape[1]
            if (v * b) % pack:
                if not self._warned_pack_drop:
                    warnings.warn(
                        f"crop_pack={pack} does not divide "
                        f"views*batch={v * b}; running unpacked (pack=1)",
                        stacklevel=3)
                    self._warned_pack_drop = True
                pack = 1
            flat = crops.reshape((v * b,) + tuple(crops.shape[2:]))
            return net.backbone(flat, pack=pack,
                                generator=generator).reshape(v, b, -1)

        outs = [run(globals_)]
        if locals_.shape[0] > 0:
            outs.append(run(locals_, self.crop_pack))
        cls_all = torch.cat(outs, dim=0)
        v, b, d = cls_all.shape
        return net.head(cls_all.reshape(v * b, d)).reshape(v, b,
                                                           self.out_dim)

    def dino_loss(self, student_out, teacher_out, center, teacher_temp
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cross-entropy between the teacher (centred, sharpened, 2 global
        views) and the student (all views), same-view pairs skipped
        (reference main_dino_adapter.py:641-663) → (loss, new centre)."""
        t = torch.softmax((teacher_out - center[None]) / teacher_temp,
                          dim=-1).detach()
        log_s = torch.log_softmax(student_out / self.student_temp, dim=-1)
        total, n_terms = 0.0, 0
        for iq in range(2):
            for v in range(student_out.shape[0]):
                if v == iq:
                    continue
                total = total + torch.mean(-torch.sum(t[iq] * log_s[v],
                                                      dim=-1))
                n_terms += 1
        loss = total / n_terms
        with torch.no_grad():
            batch_center = mesh_metric_mean(
                torch.mean(teacher_out.reshape(-1, self.out_dim), dim=0,
                           keepdim=True), self.mesh)
            new_center = (center * self.center_momentum
                          + batch_center * (1 - self.center_momentum))
        return loss, new_center

    # ---------------------------------------------------------------- step

    def step(self, state: DINOState, globals_, locals_, lr: float,
             wd: float, momentum: float, teacher_temp: float,
             cancel_last: bool, generator: Optional[torch.Generator] = None,
             timings: Optional[Dict[str, float]] = None
             ) -> Tuple[DINOState, torch.Tensor]:
        """One training step in place: forwards, loss, backward, clip,
        cancel, the masked optimizer update, the teacher EMA →
        (state, loss). `generator` draws the student's dropouts. With a
        `timings` dict, adds the seconds of forward, backward and update
        to it (synchronising the device between them)."""
        clock = StageClock(timings, globals_.device)
        student, teacher = state.student, state.teacher
        student.train()
        teacher.backbone.eval()
        teacher.head.train()
        with torch.no_grad():
            t_out = self.forward_views(teacher, globals_, locals_[:0])
        s_out = self.forward_views(student, globals_, locals_, generator)
        loss, new_center = self.dino_loss(s_out, t_out, state.center,
                                          teacher_temp)
        clock.mark("forward_s")
        params = self.trainable_params(student)
        grads = allreduce_gradients(
            list(torch.autograd.grad(loss, [p for _, p in params])),
            self.mesh)
        clock.mark("backward_s")
        with torch.no_grad():
            self._update(state, params, grads, lr, wd, cancel_last)
            self._ema(state, momentum)
            state.center = new_center
            state.step += 1
        clock.mark("update_s")
        return state, loss.detach()

    def _update(self, state, params, grads, lr, wd, cancel_last) -> None:
        """The JAX step's update after the backward, on tensor lists
        (`torch._foreach_*`: a few launches a step, not a few a tensor)."""
        names = [n for n, _ in params]
        ps = [p for _, p in params]
        ndims = [jax_ndim(n, p) for n, p in params]
        last = [("last_layer" in n) and bool(cancel_last) for n in names]
        if self.clip_grad:  # 0 disables clipping (reference flag help)
            grads = clip_gradients_per_param(grads, self.clip_grad)
        grads = [torch.zeros_like(g) if c else g for g, c in zip(grads, last)]
        lr32 = float(np.float32(lr))
        lr_wd = float(np.float32(lr) * np.float32(wd))
        if self.optimizer in ("sgd", "lars"):
            # L2 folded into the gradient before the momentum; re-cancelled
            # so a frozen last layer feeds nothing into the buffers
            grads = [g + float(np.float32(wd)) * p if nd > 1 and not c else g
                     for g, p, nd, c in zip(grads, ps, ndims, last)]
        dirs = self._directions(state.opt_state, names, ps, grads, ndims)
        live = [i for i, c in enumerate(last) if not c]   # cancelled: skip
        decay = [i for i in live
                 if self.optimizer == "adamw" and ndims[i] > 1]
        wd_terms = (torch._foreach_mul([ps[i] for i in decay], lr_wd)
                    if decay else [])
        if live:
            torch._foreach_add_([ps[i] for i in live],
                                [dirs[i] for i in live], alpha=-lr32)
        if decay:
            torch._foreach_sub_([ps[i] for i in decay], wd_terms)

    def _directions(self, opt, names, ps, grads, ndims
                    ) -> List[torch.Tensor]:
        """The positive descent direction of each parameter, its buffers
        moved in `opt` in place (every trainable one, cancelled or not)."""
        if self.optimizer == "adamw":
            return adam_directions(opt, names, grads, ADAM_B1, ADAM_B2,
                                   ADAM_EPS)
        bufs = [opt["momentum_buffer"][n] for n in names]
        if self.optimizer == "sgd":
            torch._foreach_mul_(bufs, 0.9)
            torch._foreach_add_(bufs, grads)
            return bufs
        for n, p, g, nd in zip(names, ps, grads, ndims):
            opt["momentum_buffer"][n] = lars_direction(
                g, opt["momentum_buffer"][n], p, nd, momentum=0.9)
        return [opt["momentum_buffer"][n] for n in names]

    @staticmethod
    def _ema(state: DINOState, momentum: float) -> None:
        """teacher ← teacher·m + student·(1 − m), m and 1 − m in f32."""
        m = np.float32(momentum)
        ts = list(state.teacher.parameters())
        torch._foreach_mul_(ts, float(m))
        torch._foreach_add_(ts, list(state.student.parameters()),
                            alpha=float(np.float32(1.0) - m))

    def eval_loss(self, state: DINOState, globals_, locals_,
                  teacher_temp: float) -> float:
        """Deterministic DINO loss on held-out crops (the reference's
        per-epoch validation pass, main_dino_adapter.py:567-594), the
        ranks' mean under a mesh; head BatchNorms use their running
        averages and nothing updates."""
        state.student.eval()
        state.teacher.eval()
        with torch.no_grad():
            s_out = self.forward_views(state.student, globals_, locals_)
            t_out = self.forward_views(state.teacher, globals_, locals_[:0])
            loss, _ = self.dino_loss(s_out, t_out, state.center,
                                     teacher_temp)
        return float(mesh_metric_mean(loss, self.mesh))


class StageClock:
    """Adds the host-clock seconds of each stage, the device synchronised
    at its end, to `timings[key]`; does nothing without a dict."""

    def __init__(self, timings: Optional[Dict[str, float]],
                 device: torch.device):
        self.timings, self.device = timings, device
        self.start()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self) -> None:
        if self.timings is not None:
            self.t = self._now()

    def mark(self, key: str) -> None:
        """Close the stage `key` and start the next one."""
        if self.timings is not None:
            now = self._now()
            self.timings[key] = self.timings.get(key, 0.0) + now - self.t
            self.t = now

    def count(self, key: str) -> None:
        if self.timings is not None:
            self.timings[key] = self.timings.get(key, 0) + 1
