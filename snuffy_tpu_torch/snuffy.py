"""The public model API under the reference's module name `snuffy`
(reference snuffy.py:34-238): the port's binary Snuffy MILNet and its
parts, re-exported from `snuffy_tpu_torch.models.snuffy`, as the root
`snuffy.py` re-exports the JAX package's.

One `SnuffyModelConfig` builds the model (the reference assembles cloned
attention and feed-forward modules by hand, train.py:861-890), and the
modules initialise themselves from a seed:

    from snuffy_tpu_torch.snuffy import SnuffyModelConfig, build_milnet
    model = build_milnet(SnuffyModelConfig(feats_size=384, big_lambda=500,
                                           random_patch_share=0.5,
                                           num_heads=4), seed=0)
    ins_logits, bag_logits = model(feats, mask)

The ROI CLI (`snuffy_tpu_torch.roi`) builds its aggregator through here.
"""

from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.models.snuffy import (
    BClassifier,
    Encoder,
    EncoderLayer,
    FCLayer,
    MILNet,
    MultiHeadedAttention,
    PositionwiseFeedForward,
    build_milnet,
)

__all__ = [
    "SnuffyModelConfig",
    "FCLayer",
    "BClassifier",
    "Encoder",
    "EncoderLayer",
    "MultiHeadedAttention",
    "PositionwiseFeedForward",
    "MILNet",
    "build_milnet",
]
