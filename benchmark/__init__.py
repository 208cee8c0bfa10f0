"""The benchmark of snuffy_tpu_torch on NVIDIA GPUs (see README.md)."""
