"""snuffy_tpu_torch — the PyTorch/CUDA port of snuffy_tpu for NVIDIA Hopper.

The JAX package `snuffy_tpu` stays the reference; this package mirrors its
layout. It imports torch and never jax, flax or optax; the modules of
snuffy_tpu that import without JAX (configs, data.bucketing, tiling,
pipeline.slide_inference's reader) are shared, not copied. The inverted
sparse attention runs as a hand-written CUDA kernel (ops/fused_attention.py,
csrc/sparse_attention_fwd.cu) on CUDA tensors and as its plain PyTorch
version on CPU tensors.
"""

__version__ = "0.1.0"
