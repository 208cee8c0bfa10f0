"""Typed configuration of the Snuffy model and its MIL training.

The port's own copy of `snuffy_tpu/configs.py:25-142`: the same classes
with the same fields and defaults, so a config built for one package
builds the other field by field. Fields that select TPU machinery
(`use_pallas`, `pallas_tile_n`, `remat`, `use_mesh`, `bag_batch_impl`
'vmap') are kept for that round trip; the port reads none of them except
`bag_batch_impl`, where it takes only 'packed'.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class SnuffyModelConfig:
    """Architecture of the Snuffy sparse-transformer MIL model."""

    feats_size: int = 512
    num_classes: int = 1
    num_heads: int = 6
    big_lambda: int = 200          # Λ: number of attended (selected) rows
    random_patch_share: float = 0.0  # ρ: share of Λ sampled uniformly
    mlp_multiplier: int = 4
    encoder_dropout: float = 0.0   # residual-branch and FFN dropout
    attention_dropout: float = 0.1  # dropout on attention probabilities
    activation: str = "relu"
    depth: int = 1
    multiclass: bool = False
    weight_init_i: str = "xavier_normal"
    weight_init_b: str = "xavier_normal"
    use_pallas: bool = True
    pallas_tile_n: int = 2048
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False

    @property
    def top_share(self) -> float:
        return 1.0 - self.random_patch_share

    @property
    def k_top(self) -> int:
        """Static top-Λ share count: ceil(Λ·(1−ρ))."""
        return math.ceil(self.big_lambda * self.top_share)

    @property
    def k_rand(self) -> int:
        """Static random-share count: int(Λ·ρ)."""
        return int(self.big_lambda * self.random_patch_share)


@dataclass(frozen=True)
class OptimizerConfig:
    optimizer: str = "adam"        # adam | adamw
    lr: float = 2e-4
    betas: Tuple[float, float] = (0.5, 0.9)
    weight_decay: float = 5e-3
    eta_min: float = 5e-6
    scheduler: str = "cosine"      # cosine | cosinewarmup | none
    clip_grad: Optional[float] = None
    single_weight_lr_multiplier: float = 0.1


@dataclass(frozen=True)
class MILTrainConfig:
    """MIL training runtime config (reference train.py Trainer/Runner)."""

    model: SnuffyModelConfig = field(default_factory=SnuffyModelConfig)
    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    num_epochs: int = 200
    dataset: str = "camelyon16"
    embedding: str = "SimCLR"
    split: float = 0.2
    dropout_patch: float = 0.0
    l2normed_embeddings: bool = False
    soft_average: bool = False     # learn the bag/instance loss-mix weight
    num_processes: int = 8
    use_mp: bool = True
    bins: int = 10
    seed: int = 1
    arch: str = "snuffy"
    cv_num_folds: int = 10
    cv_current_fold: int = 0
    cv_valid_ratio: float = 0.2
    # 0/1: one optimizer step per bag; >1: one step per batch of bags,
    # packed on the row axis.
    bag_batch_size: int = 1
    bag_batch_impl: str = "packed"
    use_mesh: Optional[int] = None
    embeddings_path: str = "embeddings/"
    save_path: str = "runs/"
    camelyon16_reference: str = "datasets/camelyon16/reference.csv"
    camelyon16_mask_path: str = "datasets/camelyon16/masks"
    run_name: Optional[str] = None
    roc_path: str = "roc/"
    roc_run_name: Optional[str] = None
    roc_run_epoch: Optional[int] = None
    roc_data_split: str = "test"

    @property
    def for_roc_curve(self) -> bool:
        return self.roc_run_name is not None and self.roc_run_epoch is not None
