"""Embedder architectures, found by name: a configuration's
`embedder.arch` is the module `benchmark/arch/<arch>.py`.

Each such module gives
  reference          the plain module under `benchmark/reference/`
                     (`param_spec(e)`, `embed(w, tiles, e, q)`), which
                     imports nothing of the port
  backbone(e)        the port's backbone for the config's `embedder` `e`,
                     and the width of its embeddings
  flops_per_tile(e)  the operations of one tile's forward (a multiply-add
                     counts 2), frozen here
  kernel_bounds(e, batches)
                     {registry kernel: seconds} of the bounds of the
                     hand-written kernels the backbone runs on batches of
                     these sizes ({} where it runs none)

A new architecture is two new files, `arch/<arch>.py` and
`reference/<arch>.py`; no file that is there changes.
"""

from __future__ import annotations

import importlib


def load(e: dict):
    """The module of the embedder `e`'s architecture."""
    return importlib.import_module(f"benchmark.arch.{e['arch']}")
