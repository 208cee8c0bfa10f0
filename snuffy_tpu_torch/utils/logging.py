"""Metrics logging with the wandb key schema, to JSONL.

The port's copy of `snuffy_tpu/utils/logging.py:17-93`: the reference logs
flat dicts whose keys become wandb sections (reference utils.py:29-56
`to_wandb_format`: 'epoch_train_loss' → 'train/epoch/loss', per-class
AUC lists → one key per class). `MetricsLogger` writes them to a JSONL
file; the wandb mirror is not copied (the port sends nothing over the
network).
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
