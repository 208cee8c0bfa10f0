"""snuffy_tpu_torch — the PyTorch/CUDA port of snuffy_tpu for NVIDIA Hopper.

The JAX package `snuffy_tpu` stays the reference; this package mirrors its
layout. It imports torch and never jax, flax, optax or anything of
snuffy_tpu: the modules it needs from there that run without JAX
(configs, data.bucketing, data.bags, tiling.deepzoom, native's slide
reader, the slide reader of pipeline.slide_inference, train.schedules,
train.runner.bucket_bags) are its own copies. The inverted sparse
attention and its gradient run as hand-written CUDA kernels
(ops/fused_attention.py, csrc/sparse_attention_{fwd,bwd}.cu) on CUDA
tensors and as their plain PyTorch versions on CPU tensors. Entry points
run on the card unless the caller passes another device.
"""

__version__ = "0.2.0"
