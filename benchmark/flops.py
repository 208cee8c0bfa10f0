"""Operation counts of the MILNet, frozen here so that a change to the
program cannot change what it is measured against. A FLOP is one multiply
or one add: a multiply-add counts 2. Each embedder's count is in its
architecture's module (`benchmark/arch/`).

Origin: milnet_forward_flops is bench.py:152-156, the same count for the
port's models/snuffy.py: q and v from LN(x) 4nd², FFN 16nd², k and W_o on
the slots 4sd², q·kᵀ and pᵀ·v 4nsd a layer, the instance head 2ndc.
"""

from __future__ import annotations

from benchmark import arch


def milnet_forward_flops(n: int, s: int, d: int, depth: int, c: int = 1,
                         mlp_multiplier: int = 4) -> int:
    """One bag of n valid rows and s live slots a layer."""
    per_layer = (4 * n * d * d + 4 * mlp_multiplier * n * d * d
                 + 4 * s * d * d + 4 * n * s * d)
    return depth * per_layer + 2 * n * d * c


def embedder_flops_per_tile(e: dict) -> int:
    return arch.load(e).flops_per_tile(e)
