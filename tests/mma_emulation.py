"""The operand splits and products of the kernels' tensor-core bodies,
emulated on the CPU in f32 (numpy bit operations for the TF32 roundings).
Imports no JAX: the card's test runs import it too."""

import numpy as np
import torch


def tf32(x):
    """x (f32) rounded to tf32, 11 significant bits, to nearest with ties
    away from zero, as `cvt.rna.tf32.f32` and the kernels' `split_tf32`:
    half of the dropped 13 bits' range added to the magnitude bits, then
    the 13 bits cleared."""
    bits = x.contiguous().numpy().view(np.uint32)
    out = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return torch.from_numpy(out.view(np.float32))


def tf32_dropped(x):
    """x (f32) with its low 13 bits cleared: a tf32 operand as the tensor
    cores read an f32 register."""
    bits = x.contiguous().numpy().view(np.uint32) & np.uint32(0xFFFFE000)
    return torch.from_numpy(bits.view(np.float32))


def split_tf32(x):
    """x as the kernels' products take it: big = tf32(x), and small = x −
    big (exact in f32) handed over whole, the tensor cores reading it
    without its low 13 bits."""
    big = tf32(x)
    return big, tf32_dropped(x - big)


def split_bf16_parts(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def whole_product(eq, a, b):
    return torch.einsum(eq, a, b)


def tf32x3_product(eq, a, b):
    """a·b as the f32 tensor-core bodies form it (mma_tf32x3): big·small +
    small·big, then big·big; small·small left out."""
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    return (torch.einsum(eq, ab, bs) + torch.einsum(eq, as_, bb)
            + torch.einsum(eq, ab, bb))


def tf32x1_product(eq, a, b):
    """One TF32 product: each operand rounded once."""
    return torch.einsum(eq, tf32(a), tf32(b))


def bf16x3_product(eq, a, b):
    """The cheaper split: hi + lo bf16 parts (16 bits), hi·lo + lo·hi +
    hi·hi."""
    (ah, al), (bh, bl) = split_bf16_parts(a), split_bf16_parts(b)
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
            + torch.einsum(eq, ah, bh))
