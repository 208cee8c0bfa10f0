"""The system under test, built from a configuration file: the port's
embedder and MILNet, loaded with the benchmark's weights.

This is the only module of the harness that imports `snuffy_tpu_torch`
for its models (the architectures' `backbone` builds them for it); the
driver calls the port's entry points itself.
"""

from __future__ import annotations

import torch

from benchmark import arch, weights
from benchmark.reference import milnet as ref_milnet


def embedder_reference(e: dict):
    return arch.load(e).reference


def embedder_weights(config: dict, seed: int, device) -> dict:
    e = config["embedder"]
    return weights.make(embedder_reference(e).param_spec(e),
                        weights.sub_seed(seed, "embedder"), device)


def milnet_weights(config: dict, seed: int, device) -> dict:
    return weights.make(ref_milnet.param_spec(config["milnet"]),
                        weights.sub_seed(seed, "milnet"), device)


def model_config(config: dict):
    from snuffy_tpu_torch.configs import SnuffyModelConfig

    m = config["milnet"]
    return SnuffyModelConfig(**{k: m[k] for k in (
        "feats_size", "num_classes", "num_heads", "big_lambda",
        "random_patch_share", "mlp_multiplier", "encoder_dropout",
        "attention_dropout", "activation", "depth", "compute_dtype")})


def build_embedder(config: dict, state: dict, device) -> torch.nn.Module:
    """The registry's Embedder around the configured backbone, as
    `embed/registry.build_embedder` assembles it, with `state` loaded."""
    from snuffy_tpu_torch.embed.registry import Embedder

    e = config["embedder"]
    backbone, dim = arch.load(e).backbone(e)
    emb = Embedder(backbone, dim, e["num_classes"],
                   imagenet_norm=e["imagenet_norm"])
    emb.load_state_dict(state, strict=True)
    return emb.to(device).eval()


def build_milnet(config: dict, state: dict, device) -> torch.nn.Module:
    from snuffy_tpu_torch.models.snuffy import build_milnet as build

    net = build(model_config(config), device=torch.device(device))
    net.load_state_dict(state, strict=True)
    return net


def kernel_passes() -> dict:
    """{kernel: fragments of its device kernels' names} from the port's
    registry (`ops/kernels.py`)."""
    from snuffy_tpu_torch.ops.kernels import KERNELS

    return {k.name: tuple(k.passes) for k in KERNELS}


def kernel_build_s() -> float:
    """Seconds nvcc took in this process to build the kernels launched so
    far: 0 where every one was already built in the checkout."""
    from snuffy_tpu_torch.ops.kernels import KERNELS, load_kernel

    return sum(load_kernel(k.name).build_s for k in KERNELS if k.launches)
