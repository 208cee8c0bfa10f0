"""Packed bag-classification eval: the eval half of the MIL trainer.

Port of `snuffy_tpu/train/trainer.py:327-540` (`eval_bucket_fn`,
`run_eval_epoch`). Each bucket of equal-length bags is classified in
chunks of `EVAL_CHUNK` bags packed on the row axis, one forward per chunk;
the tail chunk is padded with all-masked dummy bags whose outputs are
dropped. The random share of the selection draws from a generator seeded
with seed + n_pad per bucket, as the JAX eval keys are. The training step
is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

# Shared with the JAX package (it imports no JAX); users of the port take
# it from here.
from snuffy_tpu.configs import MILTrainConfig
from snuffy_tpu_torch.models.snuffy import MILNet, build_milnet
from snuffy_tpu_torch.train.losses import packed_mixed_mil_loss


class SnuffyTrainer:
    """Owns the MILNet and the loss-mix weight `w`."""

    EVAL_CHUNK = 8

    def __init__(self, cfg: MILTrainConfig, device: torch.device,
                 model: Optional[MILNet] = None, w: float = 0.5):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = (model if model is not None
                      else build_milnet(cfg.model, cfg.seed, self.device))
        self.w = torch.tensor(float(w), dtype=torch.float32,
                              device=self.device)
        self.pos_weight: Optional[float] = None  # set for MIL datasets

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

    def run_eval_epoch(
        self,
        bucketed: Dict[int, Tuple[object, object, object, np.ndarray]],
        seed: int,
    ):
        """bucketed: {n_pad: (feats (B, n_pad, D), masks (B, n_pad),
        labels (B, C), orig_index (B,))}, as numpy arrays or tensors.
        Returns (losses, bag_scores, ins_scores per bag, order) as numpy."""
        dev = self.device
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
