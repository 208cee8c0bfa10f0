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

Not ported: `bag_batch_impl='vmap'`, the device mesh and the per-bucket
`lax.scan` (PyTorch runs the steps eagerly).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from snuffy_tpu_torch.configs import MILTrainConfig, OptimizerConfig
from snuffy_tpu_torch.models.snuffy import MILNet, build_milnet
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


def clip_by_global_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g ← g / ‖g‖ · max unless
    ‖g‖ < max, ‖g‖ over every gradient at once. No host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.stack([g.float().pow(2).sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


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
        self.model = (model if model is not None
                      else build_milnet(cfg.model, cfg.seed, self.device))
        self.w = torch.tensor(float(w), dtype=torch.float32,
                              device=self.device,
                              requires_grad=cfg.soft_average)
        self.optimizer = make_optimizer(cfg.optim, self.model.parameters(),
                                        self.w, cfg.soft_average)
        self.pos_weight: Optional[float] = None  # set for MIL datasets

    # ------------------------------------------------------------ training

    def set_lr(self, lr: float) -> None:
        groups = self.optimizer.param_groups
        groups[0]["lr"] = lr
        if len(groups) > 1:
            groups[1]["lr"] = lr * self.cfg.optim.single_weight_lr_multiplier

    def _apply_gradients(self, loss: torch.Tensor) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.cfg.optim.clip_grad is not None:
            clip_by_global_norm(self.model.parameters(),
                                self.cfg.optim.clip_grad)
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
        the loss is the bag_w-weighted mean. → (losses (b,), scores
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
        mean = (losses * bag_w).sum() / bag_w.sum().clamp_min(1.0)
        self._apply_gradients(mean)
        return losses.detach(), scores.detach(), torch.sigmoid(
            ins_logits.detach()).reshape(b, n, -1)

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
        selection and the encoder dropout."""
        dev = self.device
        batch = max(1, self.cfg.bag_batch_size)
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
                int(rng.integers(2**31)) ^ seed)
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
                    out = self.packed_train_step(fb, mb, lb, bag_w, gen, seeds)
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

    def eval_bucket_fn(self, n_pad: int, batch: int = EVAL_CHUNK):
        """Packed deterministic forward for chunks of `batch` bags of
        length `n_pad`: (feats (b, n, d), masks (b, n), labels (b, C),
        generator) → (losses (b,), scores (b, C), ins_scores (b, n, C))."""

        @torch.inference_mode()
        def eval_packed(feats_b, masks_b, labels_b, generator):
            b, n, d = feats_b.shape
            if n != n_pad:
                raise ValueError(f"bags of {n} rows in the {n_pad} bucket")
            mask = masks_b.reshape(b * n)
            ins_logits, bag_logits = self.model(
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
        order, losses, scores, ins_list = [], [], [], []
        for n_pad in sorted(bucketed):
            feats_b, masks_b, labels_b, idx = bucketed[n_pad]
            feats_b = torch.as_tensor(feats_b, device=dev)
            masks_b = torch.as_tensor(masks_b, device=dev).to(torch.bool)
            labels_b = torch.as_tensor(labels_b, device=dev).float()
            chunk = min(self.EVAL_CHUNK, len(idx))
            fn = self.eval_bucket_fn(n_pad, chunk)
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
