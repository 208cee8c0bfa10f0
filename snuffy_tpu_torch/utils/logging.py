"""Metrics logging with the wandb key schema, to JSONL.

The port's copy of `snuffy_tpu/utils/logging.py:17-93`: the reference logs
flat dicts whose keys become wandb sections (reference utils.py:29-56
`to_wandb_format`: 'epoch_train_loss' → 'train/epoch/loss', per-class
AUC lists → one key per class). `MetricsLogger` writes them to a JSONL
file; the wandb mirror is not copied (the port sends nothing over the
network). `truncate_log_past_epoch` keeps a resumed run's JSONL log to
one row an epoch.
"""

from __future__ import annotations

import json
import os
from typing import Optional


def to_wandb_format(d: dict) -> dict:
    """'epoch_train_loss' → 'train/epoch/loss'; list values become one key
    per class ('.../aucs' → '.../auc_0', ...)."""
    out = {}
    for key, value in d.items():
        parts = key.split("_")
        if len(parts) >= 3 and parts[0] in ("epoch", "step"):
            granularity, mode, metric = parts[0], parts[1], "_".join(parts[2:])
            new_key = f"{mode}/{granularity}/{metric}"
        else:
            new_key = key
        if isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                out[f"{new_key.rstrip('s')}_{i}"] = v
        else:
            out[new_key] = value
    return out


def truncate_log_past_epoch(path: str, resume_epoch: int,
                            epoch_key: str = "epoch") -> int:
    """On resume, drop JSONL rows from epochs ≥ resume_epoch so the metric
    stream holds each epoch exactly once (the reference's wandb-history
    replay, reference dino_adapter/main_dino_adapter.py:383-446). Rows
    without `epoch_key`, and lines that do not parse, are kept. Returns
    the number of rows dropped."""
    if not os.path.exists(path):
        return 0
    kept, dropped = [], 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                row = json.loads(line)
                if isinstance(row, dict) and epoch_key in row and (
                    int(row[epoch_key]) >= resume_epoch
                ):
                    dropped += 1
                    continue
            except (ValueError, TypeError):
                pass
            kept.append(line if line.endswith("\n") else line + "\n")
    if dropped:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(kept)
        os.replace(tmp, path)
    return dropped


class MetricsLogger:
    """JSONL metrics sink: one `to_wandb_format` row a call; no file when
    `path` is None."""

    def __init__(self, path: Optional[str] = None):
        self.path = path

    def log(self, metrics: dict):
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(to_wandb_format(metrics), default=float)
                        + "\n")
