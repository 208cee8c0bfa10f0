"""snuffy_tpu_torch — the PyTorch/CUDA port of snuffy_tpu for NVIDIA Hopper.

The JAX package `snuffy_tpu` stays the reference; this package mirrors its
layout. It imports torch and never jax, flax, optax or anything of
snuffy_tpu: the modules it needs from there that run without JAX
(configs, data.bucketing, data.bags, data.mil_pickle, data.splits,
tiling.deepzoom, native's slide reader, label plane, JPEG codec and CSV
parser, the slide reader and streaming path of pipeline.slide_inference,
eval.metrics, eval.froc, viz.heatmap, utils.logging, train.schedules,
train.runner, the root train.py as train.cli and the root tiler, FROC,
ROI and dataset CLIs) are its own copies, and it uses neither cv2, PIL,
pandas nor scikit-learn (numpy and the native code give their bytes;
matplotlib only in eval.froc.plot_froc). The inverted sparse
attention and its gradient run as hand-written CUDA kernels
(ops/fused_attention.py, csrc/sparse_attention_{fwd,bwd}.cu) on CUDA
tensors and as their plain PyTorch versions on CPU tensors. Entry points
run on the card unless the caller passes another device.
"""

__version__ = "0.2.0"
