"""The frozen operation and byte counts against hand counts at small
shapes."""

import pytest

from benchmark import flops, roofline
from benchmark.arch import resnet18, vit


def test_vit_by_hand():
    # 32² image, patch 16: 4 patches, 5 tokens, dim 8, one block, mlp 4
    patch = 2 * 4 * (3 * 16 * 16) * 8
    gemms = 2 * 5 * 8 * (3 * 8 + 8 + 2 * 4 * 8)
    attn = 2 * 2 * 5 * 5 * 8
    assert vit.flops(8, 1, 16, 32, 4) == patch + gemms + attn


def test_vit_s16_operating_point():
    # 9.2 GFLOP a 224² tile (tools/profile_serve.py's count)
    assert vit.flops() == pytest.approx(9.2e9, rel=0.01)


def test_resnet18_by_hand():
    # torchvision resnet18 at 224²: 1.814 GMACs in its convolutions
    assert resnet18.flops(224) == pytest.approx(
        2 * 1.8137e9, rel=2e-3)
    # a 32² input: stem 16², pool 8², stages 8, 4, 2, 1
    s = 2 * 3 * 64 * 49 * 16 * 16
    s += 4 * 2 * 64 * 64 * 9 * 8 * 8
    for cin, cout, h in ((64, 128, 4), (128, 256, 2), (256, 512, 1)):
        s += 2 * (cin * cout * 9 + cout * cout * 9 + cin * cout) * h * h
        s += 2 * 2 * cout * cout * 9 * h * h
    assert resnet18.flops(32) == s


def test_milnet_by_hand():
    n, s, d, c = 10, 4, 8, 1
    layer = (2 * n * d * 2 * d          # q and v from LN(x)
             + 2 * s * d * d * 2        # k on the slots, W_o
             + 2 * 2 * n * d * 4 * d    # FFN, mult 4
             + 2 * 2 * n * s * d)       # q·kᵀ, pᵀ·v
    assert flops.milnet_forward_flops(n, s, d, 2, c) == 2 * layer + 2 * n * d


def test_kernel_bounds_by_hand():
    # K1, one head of dk 4, 3 live rows, 2 live slots, bf16
    nbytes = (2 * 3 + 2 * 2) * 4 * 2 + 3 + 2
    ops = 4 * 4 * 3 * 2
    assert roofline.sparse_fwd_bound(1, 4, 3, 2) == max(
        nbytes / roofline.PEAK_HBM_BYTES, ops / roofline.PEAK_BF16_FLOPS)
    # K5 at the ViT-S/16 batch: z = 256·6, n = 197, dk = 64
    z, n, dk = 1536, 197, 64
    assert roofline.dense_bound(z, n, dk) == max(
        4 * z * n * dk * 2 / 3.35e12, 4 * z * n * n * dk / 989.4e12)
    assert roofline.live_slots(1000, 256, 256) == 512
    assert roofline.live_slots(300, 256, 256) == 300
    assert roofline.live_slots(100, 200, 0) == 100
    # the architectures' kernels: K5 in each ViT block, none in ResNet-18
    e = {"img_size": 224, "patch": 16, "heads": 6, "dim": 384, "depth": 12,
         "compute_dtype": "bfloat16"}
    assert vit.kernel_bounds(e, [256, 10]) == {
        "dense_attention": pytest.approx(12 * (
            roofline.dense_bound(1536, 197, 64)
            + roofline.dense_bound(60, 197, 64)))}
    assert resnet18.kernel_bounds({}, [256]) == {}


def test_share_never_reads_zero():
    assert roofline.share(0.0, 1.0) is None
    assert roofline.share(1.0, 0.0) is None
    assert roofline.share(1.0, 4.0) == 25.0
