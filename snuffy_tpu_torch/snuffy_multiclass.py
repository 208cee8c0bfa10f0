"""The public model API of the multiclass Snuffy variant under the
reference's module name `snuffy_multiclass` (reference
snuffy_multiclass.py:34-253): the classes of `snuffy`, with the
multiclass selection (per-class top-k union and the ref_dim random share,
reference snuffy_multiclass.py:130-160) set by `multiclass_config`, as
the root `snuffy_multiclass.py` does for the JAX package.
"""

from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.snuffy import (
    BClassifier,
    Encoder,
    EncoderLayer,
    FCLayer,
    MILNet,
    MultiHeadedAttention,
    PositionwiseFeedForward,
    build_milnet,
)


def multiclass_config(**kw) -> SnuffyModelConfig:
    kw.setdefault("multiclass", True)
    return SnuffyModelConfig(**kw)


__all__ = [
    "SnuffyModelConfig",
    "multiclass_config",
    "FCLayer",
    "BClassifier",
    "Encoder",
    "EncoderLayer",
    "MultiHeadedAttention",
    "PositionwiseFeedForward",
    "MILNet",
    "build_milnet",
]
