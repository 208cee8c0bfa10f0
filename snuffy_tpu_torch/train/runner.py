"""Epoch orchestration: bucketing, metrics, checkpoints, best-AUC tracking.

The port's copy of `snuffy_tpu/train/runner.py` (reference train.py:523-794):
  * `bucket_bags` groups the bags of a split into equal-length buckets;
  * `Runner.run`, per epoch: train → valid, tracks the best-valid-AUC
    epoch, saves a checkpoint and the optimal-threshold JSON side file
    (train.py:643-675); then tests at the best and last epochs with their
    thresholds (train.py:752-778) and deletes every other epoch's files
    (train.py:780-794).

Checkpoints are reference `.pth` files: `{epoch}.pth` is the MILNet state
dict under the reference names (what `bridge.load_reference_pth` and the
slide CLI's `--aggregator_weights` read), `{epoch}_single_weight_parameter
.pth` the loss-mix weight w (`snuffy_tpu/embed/torch_export.py:67-80`),
where the JAX runner writes one flax msgpack. The metrics rows and
`summary.json` carry the JAX runner's keys; the summary adds `timings`,
each epoch's wall time split into train, valid, metrics (ROC, accuracy,
ECE) and checkpoint seconds, and the tests' (test, metrics, froc), plus
`load_s` where the CLI sets it.

The Camelyon16 FROC of the test split (`_camelyon16_froc`) is scored
where the JAX runner scores it: instance scores above the feature
threshold become level-0 detections at patch centres, held against the
masks by `eval/froc.froc_for_slides`; `reference.csv` is read with the
csv module.

Over several ranks (`parallel/distributed.py`) every rank trains and
evaluates (the trainer splits the packed steps over them; under an sp/tp
mesh every rank gathers the whole model before a save); rank 0 alone
writes the checkpoints, threshold files, ROC dumps, `summary.json` and
the clean-up (`primary_only`), and the ranks meet at a barrier before
they read the best and last epochs' files back. `save_path` is shared by
the ranks.
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import re
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from snuffy_tpu_torch.bridge import load_reference_pth
from snuffy_tpu_torch.configs import MILTrainConfig
from snuffy_tpu_torch.data.bags import dropout_patches, l2_normalize_rows
from snuffy_tpu_torch.data.bucketing import DEFAULT_BUCKETS, pad_bag
from snuffy_tpu_torch.eval.metrics import (
    compute_accuracy,
    compute_pos_weight,
    ece_loss,
    multi_label_roc,
)
from snuffy_tpu_torch.parallel import distributed
from snuffy_tpu_torch.train.trainer import SnuffyTrainer
from snuffy_tpu_torch.utils.logging import MetricsLogger

BagTuple = Tuple[List[np.ndarray], List[np.ndarray], Optional[list],
                 Optional[list]]


def bucket_bags(
    labels: List[np.ndarray],
    feats: List[np.ndarray],
    l2norm: bool = False,
    dropout_patch: float = 0.0,
    rng: Optional[np.random.Generator] = None,
    buckets=DEFAULT_BUCKETS,
) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Group bags by bucket length → {n_pad: (feats, masks, labels, index)}.

    Applies the reference's per-bag preprocessing: optional row L2-norm
    (train.py:251-252) and dropout_patches augmentation (train.py:253).
    """
    rng = rng or np.random.default_rng()
    groups: Dict[int, list] = {}
    for i, (lab, f) in enumerate(zip(labels, feats)):
        f = np.asarray(f, np.float32)
        if l2norm:
            f = l2_normalize_rows(f)
        if dropout_patch > 0:
            f = dropout_patches(f, dropout_patch, rng)
        padded, mask = pad_bag(f, buckets)
        groups.setdefault(padded.shape[0], []).append(
            (padded, mask, np.asarray(lab, np.float32), i)
        )
    out = {}
    for n_pad, items in groups.items():
        fs, ms, ls, idx = zip(*items)
        out[n_pad] = (
            np.stack(fs),
            np.stack(ms),
            np.stack(ls),
            np.asarray(idx, np.int64),
        )
    return out


class Runner:
    """The training loop of one run (reference train.py:523-794)."""

    def __init__(
        self,
        cfg: MILTrainConfig,
        trainer: SnuffyTrainer,
        train_data: BagTuple,
        valid_data: BagTuple,
        test_data: BagTuple,
        logger: Optional[MetricsLogger] = None,
    ):
        self.cfg = cfg
        self.trainer = trainer
        self.train_data = train_data
        self.valid_data = valid_data
        self.test_data = test_data
        self.logger = logger or MetricsLogger()
        if not distributed.is_primary():  # the JSONL rows from rank 0 alone
            self.logger = MetricsLogger()
        self.rng = np.random.default_rng(cfg.seed)

        # Weighted BCE from the train split, for every dataset: the
        # reference sets it on the first train epoch (train.py:244-247).
        trainer.pos_weight = compute_pos_weight(train_data[0])

        self.save_dir = os.path.join(
            cfg.save_path, cfg.dataset, cfg.run_name or f"run_seed{cfg.seed}"
        )
        os.makedirs(self.save_dir, exist_ok=True)

        self.best_auc = -1.0
        self.best_epoch = -1
        self.timings: dict = {"epochs": []}
        self._clock: Dict[str, float] = {}

    @contextlib.contextmanager
    def _timed(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._clock[key] = (self._clock.get(key, 0.0)
                                + time.perf_counter() - t0)

    def _take_clock(self) -> Dict[str, float]:
        clock, self._clock = self._clock, {}
        return {f"{k}_s": v for k, v in clock.items()}

    # ---------------------------------------------------------------- epochs

    def _epoch_metrics(self, labels, scores, ins_list, feats_labels, order,
                       prefix):
        labels_arr = np.stack([np.asarray(l) for l in labels])[order]
        num_classes = self.cfg.model.num_classes
        aucs, _, th_opt = multi_label_roc(labels_arr, scores, num_classes)
        acc = compute_accuracy(labels_arr, scores, th_opt, num_classes)
        res = {
            f"{prefix}_accuracy": acc,
            f"{prefix}_aucs": [float(a) for a in aucs],
            f"{prefix}_thresholds_optimal": [float(t) for t in th_opt],
        }
        if feats_labels is not None:
            flat_labels = np.concatenate(
                [np.asarray(feats_labels[i]) for i in order]
            ).astype(float)
            flat_scores = np.concatenate([s.reshape(-1) for s in ins_list])
            f_aucs, _, f_th = multi_label_roc(
                flat_labels, flat_scores, num_classes, for_feats=True
            )
            f_acc = float(np.mean(
                (flat_scores >= f_th[0]).astype(int) == flat_labels))
            res.update(
                {
                    f"{prefix}_feat_accuracy": f_acc,
                    f"{prefix}_feat_aucs": [float(a) for a in f_aucs],
                    f"{prefix}_feat_thresholds_optimal": [
                        float(t) for t in f_th],
                }
            )
        return res

    def train_one_epoch(self, epoch: int, lr: float) -> dict:
        labels, feats = self.train_data[0], self.train_data[1]
        with self._timed("train"):
            bucketed = bucket_bags(
                labels,
                feats,
                l2norm=self.cfg.l2normed_embeddings,
                dropout_patch=self.cfg.dropout_patch,
                rng=self.rng,
            )
            losses, scores, ins_list, order = self.trainer.run_train_epoch(
                bucketed, lr, self.rng, self.cfg.seed
            )
        with self._timed("metrics"):
            res = self._epoch_metrics(
                labels, scores, ins_list, self.train_data[2], order,
                "epoch_train"
            )
            res["epoch_train_loss"] = float(np.mean(losses))
        return res

    def evaluate(
        self,
        data: BagTuple,
        epoch: int,
        prefix: str,
        predefined_thresholds: Optional[list] = None,
        predefined_feats_thresholds: Optional[list] = None,
    ) -> dict:
        labels, feats = data[0], data[1]
        with self._timed("test" if "test" in prefix else "valid"):
            bucketed = bucket_bags(
                labels, feats, l2norm=self.cfg.l2normed_embeddings,
                rng=self.rng
            )
            losses, scores, ins_list, order = self.trainer.run_eval_epoch(
                bucketed, self.cfg.seed + epoch
            )
        with self._timed("metrics"):
            res = self._epoch_metrics(labels, scores, ins_list, data[2],
                                      order, prefix)
            res[f"{prefix}_loss"] = float(np.mean(losses))
            labels_arr = np.stack([np.asarray(l) for l in labels])[order]
            if predefined_thresholds is not None:
                res[f"{prefix}_accuracy"] = compute_accuracy(
                    labels_arr, scores, predefined_thresholds,
                    self.cfg.model.num_classes
                )
            # ECE on the mixed sigmoid scores (train.py:415-451).
            res[f"{prefix}_ece"] = ece_loss(
                scores, labels_arr, 0.5, n_bins=self.cfg.bins, logits=False
            )

        # ROC dump, gated as the reference gates it (train.py:365-372,
        # 985-990): both --roc_run_name and --roc_run_epoch, the file
        # named after --roc_run_epoch.
        if (self.cfg.for_roc_curve and self.cfg.roc_data_split in prefix
                and distributed.is_primary()):
            roc_dir = os.path.join(self.cfg.roc_path, self.cfg.roc_run_name)
            os.makedirs(roc_dir, exist_ok=True)
            np.savez(
                os.path.join(roc_dir, f"{self.cfg.roc_run_epoch}.npz"),
                labels=labels_arr,
                predictions=scores,
            )

        # The CAMELYON16 FROC of the test split (train.py:336-349, 392-410):
        # instance scores above the optimal feat threshold become level-0
        # detections at patch centers.
        slide_names = data[4] if len(data) > 4 else None
        if (
            "test" in prefix
            and self.cfg.dataset == "camelyon16"
            and data[3] is not None
            and slide_names is not None
            and os.path.isdir(self.cfg.camelyon16_mask_path)
            and os.path.exists(self.cfg.camelyon16_reference)
        ):
            feat_th = (
                predefined_feats_thresholds[0]
                if predefined_feats_thresholds
                else res.get(f"{prefix}_feat_thresholds_optimal", [0.5])[0]
            )
            with self._timed("froc"):
                res[f"{prefix}_challenge_froc_score"] = self._camelyon16_froc(
                    data, ins_list, order, feat_th
                )
        return res

    def _camelyon16_froc(self, data, ins_list, order, feat_threshold):
        """Build per-slide detections and score them against the official
        masks (reference train.py:347-349 detection construction:
        x = col·512 + 256, y = row·512 + 256 at WSI level 0)."""
        from snuffy_tpu_torch.eval.froc import froc_for_slides

        positions, names = data[3], data[4]
        detections, types = {}, {}
        with open(self.cfg.camelyon16_reference, newline="") as f:
            type_by_image = {
                os.path.splitext(str(r["image"]))[0]: str(r["type"]).lower()
                for r in csv.DictReader(f)
            }
        for j, bag_idx in enumerate(order):
            slide = names[bag_idx]
            scores_j = np.asarray(ins_list[j]).reshape(-1)
            dets = []
            for pos_str, prob in zip(positions[bag_idx], scores_j):
                if prob <= feat_threshold:
                    continue
                m = re.search(r"[^\d]*(\d+)[^\d]*(\d+)", str(pos_str))
                if not m:
                    continue
                col, row = int(m.group(1)), int(m.group(2))
                dets.append((float(prob), col * 512 + 256, row * 512 + 256))
            detections[slide] = dets
            types[slide] = type_by_image.get(slide, "tumor")

        score, _, _ = froc_for_slides(
            detections,
            lambda s: os.path.join(
                self.cfg.camelyon16_mask_path, f"{s}_mask.tif"
            ),
            types,
            evaluation_mask_level=5,
        )
        return score

    # ----------------------------------------------------------- checkpoints

    def _ckpt_path(self, epoch) -> str:
        return os.path.join(self.save_dir, f"{epoch}.pth")

    def _w_path(self, epoch) -> str:
        return os.path.join(self.save_dir,
                            f"{epoch}_single_weight_parameter.pth")

    def save_checkpoint(self, epoch: int, valid_res: dict) -> None:
        """Every rank: the whole model (under tp the ranks gather it
        together); rank 0 writes it."""
        self._write_checkpoint(epoch, valid_res, *self.trainer.state_dict())

    @distributed.primary_only
    def _write_checkpoint(self, epoch: int, valid_res: dict, model_state,
                          w: float) -> None:
        torch.save(model_state, self._ckpt_path(epoch))
        torch.save(torch.tensor(w, dtype=torch.float32), self._w_path(epoch))
        thresholds = {
            "epoch": epoch,
            "auc": valid_res.get("epoch_valid_aucs"),
            "thresholds_optimal": valid_res.get(
                "epoch_valid_thresholds_optimal"),
            "feats_thresholds_optimal": valid_res.get(
                "epoch_valid_feat_thresholds_optimal"
            ),
            "single_weight_parameter": w,
        }
        with open(
            os.path.join(self.save_dir, f"thresholds_{epoch}.txt"), "w"
        ) as f:
            json.dump(thresholds, f)

    def load_checkpoint(self, epoch: int) -> None:
        """Load epoch's MILNet and w into the trainer."""
        w = torch.load(self._w_path(epoch), map_location="cpu",
                       weights_only=True)
        self.trainer.load(load_reference_pth(self._ckpt_path(epoch)),
                          float(w))

    def load_thresholds(self, epoch: int) -> dict:
        with open(os.path.join(self.save_dir, f"thresholds_{epoch}.txt")) as f:
            return json.load(f)

    @distributed.primary_only
    def clean_up(self, keep_epochs) -> None:
        """Delete every other epoch's checkpoint, w and thresholds files
        (reference train.py:780-794)."""
        keep = set()
        for e in keep_epochs:
            keep |= {f"{e}.pth", f"{e}_single_weight_parameter.pth",
                     f"thresholds_{e}.txt"}
        for fname in os.listdir(self.save_dir):
            if fname not in keep and (
                fname.endswith(".pth") or fname.startswith("thresholds_")
            ):
                os.remove(os.path.join(self.save_dir, fname))

    # ------------------------------------------------------------------ run

    def run(self, schedule) -> dict:
        """Full training run. `schedule`: epoch → lr. Returns the summary
        dict, also written to `summary.json`."""
        cfg = self.cfg
        self.trainer.init_state(cfg.seed)
        history = []
        for epoch in range(1, cfg.num_epochs + 1):
            t0 = time.time()
            lr = schedule(epoch - 1)
            train_res = self.train_one_epoch(epoch, lr)
            valid_res = self.evaluate(self.valid_data, epoch, "epoch_valid")
            elapsed = time.time() - t0
            row = {"epoch": epoch, "lr": lr, "time_s": elapsed}
            row.update(train_res)
            row.update(valid_res)
            history.append(row)
            self.logger.log(row)

            with self._timed("checkpoint"):
                self.save_checkpoint(epoch, valid_res)
            self.timings["epochs"].append(self._take_clock())
            auc = float(np.mean(valid_res["epoch_valid_aucs"]))
            if auc > self.best_auc:
                self.best_auc = auc
                self.best_epoch = epoch

        summary = {
            "best_epoch": self.best_epoch,
            "best_valid_auc": self.best_auc,
            "history": history,
        }

        # Test at the best-AUC and last epochs (reference train.py:752-778),
        # from the files rank 0 wrote.
        distributed.barrier("checkpoints written")
        for tag, epoch in (("best", self.best_epoch), ("last", cfg.num_epochs)):
            if epoch < 1:
                continue
            th = self.load_thresholds(epoch)
            with self._timed("checkpoint"):
                self.load_checkpoint(epoch)
            test_res = self.evaluate(
                self.test_data,
                epoch,
                f"epoch_test_{tag}",
                predefined_thresholds=th.get("thresholds_optimal"),
                predefined_feats_thresholds=th.get("feats_thresholds_optimal"),
            )
            self.logger.log(test_res)
            summary[f"test_{tag}"] = test_res

        self.timings["tests"] = self._take_clock()
        summary["timings"] = self.timings
        if distributed.is_primary():
            with open(os.path.join(self.save_dir, "summary.json"), "w") as f:
                json.dump(summary, f, default=float)
        self.clean_up({self.best_epoch, cfg.num_epochs})
        return summary
