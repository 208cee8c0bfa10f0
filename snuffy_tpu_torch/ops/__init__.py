"""Sparse attention (CUDA kernels + plain versions), selection,
initializers; `snuffy_tpu/ops/__init__.py`'s exports. Importing builds no
kernel: each builds at its first launch."""
from snuffy_tpu_torch.ops.selection import (  # noqa: F401
    top_share_selection,
    gumbel_without_replacement,
    binary_lambda_selection,
    multiclass_lambda_selection,
)
from snuffy_tpu_torch.ops.sparse_attention import (  # noqa: F401
    inverted_sparse_attention,
)
