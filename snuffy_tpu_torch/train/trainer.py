"""MIL trainer: per-bag and packed optimizer steps, and the packed eval.

Port of `snuffy_tpu/train/trainer.py:49-301,327-540`. The epoch visits
buckets of equal-length bags in a shuffled order and shuffles the bags
within a bucket (`run_train_epoch`); `bag_batch_size` ≤ 1 takes one
optimizer step per bag (the reference's serial SGD), > 1 one step per
chunk of that many bags packed on the row axis (segments = the chunk),
with the tail chunk padded by dummy bags of weight zero. The eval
classifies each bucket in packed chunks of `EVAL_CHUNK` bags.

Optimizer semantics (reference train.py:165-180, 809-826):
  * adam  = torch Adam (L2 weight decay folded into the gradient);
  * adamw = torch AdamW (decoupled weight decay);
  * betas, eps 1e-8 and weight_decay apply to every parameter group,
    the learnable loss-mix scalar `w` included; torch's bias-corrected
    moments are optax's `scale_by_adam`;
  * `w` trains at lr · single_weight_lr_multiplier and is clamped to
    [0, 1] after each step; without soft_average it has no optimizer
    state and stays put;
  * gradient clipping (global norm) applies to the MILNet parameters
    only, before the decay is folded in, by optax's rule: scale by
    max/‖g‖ when ‖g‖ ≥ max, with no epsilon (`clip_grad_norm_` adds one).

`pos_weight` (the BCE positive-class weight the runner sets from the
train split) is a scalar or a per-class vector, kept as a float32 tensor
on the trainer's device. `init_state` resets the weights to a seed's,
`w` to 0.5 and the optimizer, as the JAX `init_state` builds a fresh
state; `state_dict` and `load` carry (MILNet, w) to and from the
runner's checkpoints.

Over several ranks (`parallel/distributed.py`, one process a GPU) the
batched steps run over a mesh (`_maybe_mesh`, `parallel/sharded_train`):
every rank draws the same bucket and bag order from `rng`, steps on its
block of each chunk, and the gradients are summed over the axes where
they are partial; the batch index (not the sp or tp index: those ranks
share every draw) is folded into the seeds of its draws. A data-parallel
mesh runs the packed step on the rank's B/D bags; `use_mesh=1` factors
the ranks into dp × sp × tp, and the step then takes the rank's bags one
at a time (`bag_loop_train_step`), on its N/sp rows and its tp blocks of
the weights. The serial step and the eval run whole on every rank (under
tp, on a whole copy of the model, `eval_model`). `state_dict` is the
whole model on every rank (gathered over tp), `load` takes a whole one.

Not ported: `bag_batch_impl='vmap'` and the per-bucket `lax.scan`
(PyTorch runs the steps eagerly).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from snuffy_tpu_torch.configs import MILTrainConfig, OptimizerConfig
from snuffy_tpu_torch.models.snuffy import MILNet, build_milnet
from snuffy_tpu_torch.parallel import distributed
from snuffy_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    factor_devices,
    make_mesh,
)
from snuffy_tpu_torch.parallel.sharded_train import (
    gather_state,
    global_bag_weight,
    global_grad_norm,
    make_sharded_batch_train_step,
    shard_state,
    sum_gradients,
)
from snuffy_tpu_torch.parallel.ssl_sharding import replicate_state
from snuffy_tpu_torch.train.losses import mixed_mil_loss, packed_mixed_mil_loss

Bucketed = Dict[int, Tuple[object, object, object, np.ndarray]]


def make_optimizer(optim: OptimizerConfig, params, w: torch.Tensor,
                   soft_average: bool) -> torch.optim.Optimizer:
    """Two parameter groups: the MILNet's, then `w` (only with
    soft_average). `set_lr` sets both groups' rates."""
    if optim.optimizer not in ("adam", "adamw"):
        raise KeyError(f"Optimizer not found. Given: {optim.optimizer}, "
                       "Have: ['adam', 'adamw']")
    cls = torch.optim.Adam if optim.optimizer == "adam" else torch.optim.AdamW
    groups = [{"params": list(params)}]
    if soft_average:
        groups.append({"params": [w]})
    return cls(groups, lr=optim.lr, betas=tuple(optim.betas), eps=1e-8,
               weight_decay=optim.weight_decay)


def clip_by_global_norm(params, max_norm: float, mesh=None,
                        names=None) -> None:
    """optax.clip_by_global_norm in place: g ← g / ‖g‖ · max unless
    ‖g‖ < max, ‖g‖ over every gradient at once (under tp, over the whole
    model: `names` name the parameters). No host sync."""
    params = list(params)
    grads = [p.grad for p in params if p.grad is not None]
    if mesh is not None and mesh.tp > 1:
        norm = global_grad_norm(
            ((n, p.grad) for n, p in zip(names, params)), mesh)
    else:
        norm = torch.stack([g.float().pow(2).sum()
                            for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def num_nodes(world: int) -> int:
    """The hosts of a torchrun launch (JAX's process_count): the world
    over torchrun's LOCAL_WORLD_SIZE, the ranks of a host (one host where
    it is unset)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    return world // local if local and world % local == 0 else 1


def _maybe_mesh(cfg: MILTrainConfig) -> Optional[Mesh]:
    """The mesh of the batched steps (the JAX `_maybe_mesh`,
    train/trainer.py:79-111, with one device a rank): use_mesh None gives
    a dp mesh over every rank when bag_batch_size divides over them, else
    none (each rank runs the whole run); 0 none; 1 the dp×sp×tp
    factoring `factor_devices(world, nodes)`, whose batch axes must
    divide bag_batch_size. One rank, or one bag a step: none."""
    world = distributed.world_size()
    if cfg.bag_batch_size <= 1 or world <= 1:
        return None
    if cfg.use_mesh is not None and int(cfg.use_mesh) == 0:
        return None
    if cfg.use_mesh is not None and int(cfg.use_mesh) == 1:
        spec = factor_devices(world, num_nodes(world))
        if cfg.bag_batch_size % (spec.dcn * spec.dp):
            raise ValueError(
                f"bag_batch_size={cfg.bag_batch_size} must divide over the "
                f"batch axes dcn×dp={spec.dcn * spec.dp} (use_mesh=1)")
        return make_mesh(spec, num_heads=cfg.model.num_heads,
                         mlp_hidden=cfg.model.feats_size
                         * cfg.model.mlp_multiplier)
    if cfg.bag_batch_size % world:
        return None
    return make_mesh(MeshSpec(1, 1, 1, dcn=world))


def _split_mesh(mesh: Optional[Mesh]) -> bool:
    """True for a mesh with sp or tp above 1."""
    return mesh is not None and (mesh.sp > 1 or mesh.tp > 1)


class SnuffyTrainer:
    """Owns the MILNet, the loss-mix weight `w` and the optimizer
    (the counterpart of the JAX trainer's MILTrainState). Runs on the
    card unless the caller passes another device."""

    EVAL_CHUNK = 8

    def __init__(self, cfg: MILTrainConfig,
                 device: Optional[torch.device] = None,
                 model: Optional[MILNet] = None, w: float = 0.5):
        if cfg.bag_batch_impl != "packed":
            raise ValueError(
                f"the port runs bag_batch_impl='packed' only, got "
                f"{cfg.bag_batch_impl!r}")
        self.cfg = cfg
        self.device = torch.device(device or "cuda")
        self.mesh = _maybe_mesh(cfg)
        if model is not None and _split_mesh(self.mesh):
            raise ValueError("a model passed in is whole; under an sp/tp "
                             "mesh the trainer builds its own part")
        self.model = (model if model is not None
                      else build_milnet(cfg.model, cfg.seed, self.device,
                                        mesh=self.mesh))
        self.w = torch.tensor(float(w), dtype=torch.float32,
                              device=self.device,
                              requires_grad=cfg.soft_average)
        self.optimizer = make_optimizer(cfg.optim, self.model.parameters(),
                                        self.w, cfg.soft_average)
        self.pos_weight = None

    @property
    def pos_weight(self) -> Optional[torch.Tensor]:
        """None (unweighted) or a float32 scalar or (C,) tensor on the
        trainer's device; set from a float or an array."""
        return self._pos_weight

    @pos_weight.setter
    def pos_weight(self, value) -> None:
        self._pos_weight = (None if value is None else torch.as_tensor(
            np.asarray(value, np.float32), device=self.device))

    # --------------------------------------------------------------- state

    def init_state(self, seed: int) -> None:
        """The weights `build_milnet` draws at `seed`, w = 0.5 and a fresh
        optimizer (the JAX trainer's `init_state`); under a mesh, rank
        0's (under sp/tp every rank draws the same whole weights and keeps
        its part)."""
        self.load(MILNet(self.cfg.model, seed).state_dict(), 0.5)
        if not _split_mesh(self.mesh):
            replicate_state((self.model, self.w), self.mesh)
        self.optimizer = make_optimizer(self.cfg.optim,
                                        self.model.parameters(), self.w,
                                        self.cfg.soft_average)

    def state_dict(self) -> Tuple[Dict[str, torch.Tensor], float]:
        """(the whole MILNet's state dict on the CPU, w); under tp every
        rank of a tp group calls it together (the blocks are gathered)."""
        state = gather_state(self.model.state_dict(), self.mesh)
        return ({k: v.detach().cpu().clone() for k, v in state.items()},
                float(self.w.item()))

    def load(self, model_state: Dict[str, torch.Tensor], w: float) -> None:
        """Load a whole MILNet state dict (strict; under tp, this rank's
        blocks of it) and w; the optimizer state stays."""
        self.model.load_state_dict(shard_state(model_state, self.mesh),
                                   strict=True)
        with torch.no_grad():
            self.w.fill_(float(w))

    def sharded_state(self) -> Dict[str, torch.Tensor]:
        """This rank's training state as a flat dict for
        `train/checkpoint.py`: "model:<name>" its parameters (under tp its
        blocks), "w", and each trained tensor's Adam moments
        "exp_avg:<name>", "exp_avg_sq:<name>" (the names end with the
        parameter's, so they shard as it does) and count "<name>#count"
        (zeros before the first step)."""
        out = {f"model:{k}": v for k, v in self.model.state_dict().items()}
        out["w"] = self.w.detach()
        for name, p in self._optimized():
            st = self.optimizer.state.get(p) or {}
            out[f"exp_avg:{name}"] = st.get("exp_avg", torch.zeros_like(p))
            out[f"exp_avg_sq:{name}"] = st.get("exp_avg_sq",
                                               torch.zeros_like(p))
            out[f"{name}#count"] = torch.as_tensor(
                st.get("step", 0.0), dtype=torch.float32).reshape(())
        return out

    @torch.no_grad()
    def load_sharded_state(self, state: Dict[str, torch.Tensor]) -> None:
        """The inverse of `sharded_state`, in place."""
        self.model.load_state_dict(
            {k[len("model:"):]: v for k, v in state.items()
             if k.startswith("model:")}, strict=True)
        self.w.copy_(state["w"])
        for name, p in self._optimized():
            self.optimizer.state[p] = {
                "step": state[f"{name}#count"].detach().cpu().clone(),
                "exp_avg": state[f"exp_avg:{name}"].to(p.device).clone(),
                "exp_avg_sq": state[f"exp_avg_sq:{name}"].to(
                    p.device).clone()}

    def _optimized(self):
        """(name, tensor) of what the optimizer trains, "w" last."""
        named = list(self.model.named_parameters())
        if self.cfg.soft_average:
            named.append(("w", self.w))
        return named

    def eval_model(self) -> MILNet:
        """The model the eval runs: the trainer's own, or under an sp/tp
        mesh a whole copy of it without the mesh (every rank of a tp group
        calls it together)."""
        if not _split_mesh(self.mesh):
            return self.model
        whole = MILNet(self.cfg.model).to(self.device)
        whole.load_state_dict(gather_state(self.model.state_dict(),
                                           self.mesh))
        return whole.eval()

    # ------------------------------------------------------------ training

    def set_lr(self, lr: float) -> None:
        groups = self.optimizer.param_groups
        groups[0]["lr"] = lr
        if len(groups) > 1:
            groups[1]["lr"] = lr * self.cfg.optim.single_weight_lr_multiplier

    def _apply_gradients(self, loss: Optional[torch.Tensor]) -> None:
        """Backward of `loss` (None: the gradients are in place already),
        the sums over the mesh, the clip, the optimizer step, w's clamp."""
        if loss is not None:
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        names = [n for n, _ in self.model.named_parameters()]
        if self.mesh is not None:
            sum_gradients([*self.model.parameters(), self.w],
                          names + ["w"], self.mesh)
        if self.cfg.optim.clip_grad is not None:
            clip_by_global_norm(self.model.parameters(),
                                self.cfg.optim.clip_grad, self.mesh, names)
        self.optimizer.step()
        with torch.no_grad():
            self.w.clamp_(0.0, 1.0)

    def train_step(self, feats, mask, label, generator, seed_generator):
        """One optimizer step on one bag: feats (n, d), mask (n,), label
        (C,) → (loss, bag_score (C,), ins_scores (n, C)), detached."""
        ins_logits, bag_logits = self.model(feats, mask,
                                            generator=generator,
                                            seed_generator=seed_generator)
        loss, score = mixed_mil_loss(ins_logits, bag_logits, label, mask,
                                     self.w, self.pos_weight)
        self._apply_gradients(loss)
        return loss.detach(), score.detach(), torch.sigmoid(
            ins_logits.detach())

    def packed_train_step(self, feats_b, masks_b, labels_b, bag_w, generator,
                          seed_generator):
        """One optimizer step on a chunk of b bags packed on the row axis;
        the loss is the bag_w-weighted mean (under a mesh, over every
        rank's bags: this rank's share of it). → (losses (b,), scores
        (b, C), ins_scores (b, n, C)), detached."""
        b, n, d = feats_b.shape
        mask = masks_b.reshape(b * n)
        ins_logits, bag_logits = self.model(
            feats_b.reshape(b * n, d), mask, segments=b,
            generator=generator, seed_generator=seed_generator)
        if b == 1:
            bag_logits = bag_logits[None]
        losses, scores = packed_mixed_mil_loss(
            ins_logits, bag_logits, labels_b, mask, self.w, self.pos_weight,
            segments=b)
        total = (bag_w.sum() if self.mesh is None
                 else global_bag_weight(bag_w, self.mesh))
        mean = (losses * bag_w).sum() / total.clamp_min(1.0)
        self._apply_gradients(mean)
        return losses.detach(), scores.detach(), torch.sigmoid(
            ins_logits.detach()).reshape(b, n, -1)

    def bag_loop_train_step(self, feats_b, masks_b, labels_b, bag_w,
                            generator, seed_generator):
        """One optimizer step on a chunk of b bags, one bag a forward
        (segments = 1; under sp each bag is this rank's N/sp rows), the
        gradients accumulated: the loss is the bag_w-weighted mean over
        every rank's bags. → (losses (b,), scores (b, C), ins_scores
        (b, n, C)), detached."""
        total = (bag_w.sum() if self.mesh is None
                 else global_bag_weight(bag_w, self.mesh)).clamp_min(1.0)
        self.optimizer.zero_grad(set_to_none=True)
        losses, scores, ins = [], [], []
        for b in range(feats_b.shape[0]):
            ins_logits, bag_logits = self.model(
                feats_b[b], masks_b[b], generator=generator,
                seed_generator=seed_generator)
            loss, score = mixed_mil_loss(ins_logits, bag_logits, labels_b[b],
                                         masks_b[b], self.w, self.pos_weight,
                                         mesh=self.mesh)
            (loss * bag_w[b] / total).backward()
            losses.append(loss.detach())
            scores.append(score.detach())
            ins.append(torch.sigmoid(ins_logits.detach()))
        self._apply_gradients(None)
        return torch.stack(losses), torch.stack(scores), torch.stack(ins)

    def run_train_epoch(self, bucketed: Bucketed, lr: float,
                        rng: np.random.Generator, seed: int):
        """bucketed: {n_pad: (feats (B, n_pad, D), masks (B, n_pad),
        labels (B, C), orig_index (B,))}, numpy arrays or tensors.
        Returns (losses, bag_scores, ins_scores per bag, order) as numpy,
        in the order the bags were visited.

        The bucket order and the order within each bucket come from `rng`,
        as in the JAX trainer; each bucket's draws come from a CPU
        generator seeded with rng.integers(2**31) ^ seed, which draws the
        attention-dropout seeds and seeds the device generator of the
        selection and the encoder dropout. Under a mesh the batch index is
        folded into that seed, and each chunk steps over the ranks."""
        dev = self.device
        batch = max(1, self.cfg.bag_batch_size)
        packed_step, fold = self.packed_train_step, 0
        if _split_mesh(self.mesh) and batch == 1:
            raise ValueError("an sp/tp mesh steps batches of bags")
        if self.mesh is not None:
            packed_step = make_sharded_batch_train_step(self, self.mesh)
            fold = self.mesh.rank << distributed.RANK_SEED_SHIFT
        self.model.train()
        self.set_lr(lr)
        order, losses, scores, ins_list = [], [], [], []
        bucket_keys = list(bucketed.keys())
        rng.shuffle(bucket_keys)
        for n_pad in bucket_keys:
            feats_b, masks_b, labels_b, idx = bucketed[n_pad]
            perm = rng.permutation(len(idx))
            feats_b = torch.as_tensor(feats_b, device=dev)[perm]
            masks_b = torch.as_tensor(masks_b, device=dev).to(torch.bool)[perm]
            labels_b = torch.as_tensor(labels_b, device=dev).float()[perm]
            idx = np.asarray(idx)[perm]
            seeds = torch.Generator().manual_seed(
                (int(rng.integers(2**31)) ^ seed) + fold)
            gen = torch.Generator(dev).manual_seed(
                int(torch.randint(2**62, (), generator=seeds)))
            parts = []
            if batch == 1:
                for b in range(len(idx)):
                    parts.append([t[None] for t in self.train_step(
                        feats_b[b], masks_b[b], labels_b[b], gen, seeds)])
            else:
                for start in range(0, len(idx), batch):
                    fb = feats_b[start:start + batch]
                    mb = masks_b[start:start + batch]
                    lb = labels_b[start:start + batch]
                    n_real = fb.shape[0]
                    if n_real < batch:  # pad with zero-weight dummy bags
                        pad = batch - n_real
                        fb = torch.cat([fb, fb.new_zeros((pad,) + fb.shape[1:])])
                        mb = torch.cat([mb, mb.new_zeros((pad,) + mb.shape[1:])])
                        lb = torch.cat([lb, lb.new_zeros((pad,) + lb.shape[1:])])
                    bag_w = (torch.arange(batch, device=dev) < n_real).float()
                    out = packed_step(fb, mb, lb, bag_w, gen, seeds)
                    parts.append([t[:n_real] for t in out])
            l, s, ins = (torch.cat(p).cpu().numpy() for p in zip(*parts))
            losses.append(l)
            scores.append(s)
            n_valid = masks_b.sum(dim=1).tolist()
            ins_list.extend(ins[b, :nv] for b, nv in enumerate(n_valid))
            order.extend(idx.tolist())
        return (
            np.concatenate(losses),
            np.concatenate(scores),
            ins_list,
            np.asarray(order),
        )

    # ---------------------------------------------------------------- eval

    def eval_bucket_fn(self, n_pad: int, batch: int = EVAL_CHUNK,
                       model: Optional[MILNet] = None):
        """Packed deterministic forward for chunks of `batch` bags of
        length `n_pad`: (feats (b, n, d), masks (b, n), labels (b, C),
        generator) → (losses (b,), scores (b, C), ins_scores (b, n, C)).
        `model`: the trainer's by default."""
        model = self.model if model is None else model

        @torch.inference_mode()
        def eval_packed(feats_b, masks_b, labels_b, generator):
            b, n, d = feats_b.shape
            if n != n_pad:
                raise ValueError(f"bags of {n} rows in the {n_pad} bucket")
            mask = masks_b.reshape(b * n)
            ins_logits, bag_logits = model(
                feats_b.reshape(b * n, d), mask, segments=b,
                generator=generator,
            )
            if b == 1:
                bag_logits = bag_logits[None]
            losses, scores = packed_mixed_mil_loss(
                ins_logits, bag_logits, labels_b, mask, self.w,
                self.pos_weight, segments=b,
            )
            return losses, scores, torch.sigmoid(ins_logits).reshape(b, n, -1)

        return eval_packed

    def run_eval_epoch(self, bucketed: Bucketed, seed: int):
        """bucketed as for `run_train_epoch`, visited in bucket order.
        The random share of the selection draws from a generator seeded
        with seed + n_pad per bucket, as the JAX eval keys are. Returns
        (losses, bag_scores, ins_scores per bag, order) as numpy."""
        dev = self.device
        self.model.eval()
        model = self.eval_model()
        order, losses, scores, ins_list = [], [], [], []
        for n_pad in sorted(bucketed):
            feats_b, masks_b, labels_b, idx = bucketed[n_pad]
            feats_b = torch.as_tensor(feats_b, device=dev)
            masks_b = torch.as_tensor(masks_b, device=dev).to(torch.bool)
            labels_b = torch.as_tensor(labels_b, device=dev).float()
            chunk = min(self.EVAL_CHUNK, len(idx))
            fn = self.eval_bucket_fn(n_pad, chunk, model)
            gen = torch.Generator(dev).manual_seed(seed + n_pad)
            for start in range(0, len(idx), chunk):
                fb = feats_b[start:start + chunk]
                mb = masks_b[start:start + chunk]
                lb = labels_b[start:start + chunk]
                n_real = fb.shape[0]
                if n_real < chunk:  # masked dummy bags pad the tail chunk
                    pad = chunk - n_real
                    fb = torch.cat([fb, fb.new_zeros((pad,) + fb.shape[1:])])
                    mb = torch.cat([mb, mb.new_zeros((pad,) + mb.shape[1:])])
                    lb = torch.cat([lb, lb.new_zeros((pad,) + lb.shape[1:])])
                l, s, ins = fn(fb, mb, lb, gen)
                losses.append(l[:n_real].cpu().numpy())
                scores.append(s[:n_real].cpu().numpy())
                ins = ins[:n_real].cpu().numpy()
                n_valid = mb[:n_real].sum(dim=1).tolist()
                ins_list.extend(ins[b, :nv] for b, nv in enumerate(n_valid))
            order.extend(np.asarray(idx).tolist())
        return (
            np.concatenate(losses),
            np.concatenate(scores),
            ins_list,
            np.asarray(order),
        )
