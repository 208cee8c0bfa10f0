"""ResNet-18 embedders (DSMIL's SimCLR, arXiv:2011.08939): the port's
`models/resnet.ResNet18` with its configured norm, the plain reference
`reference/resnet18.py`; cuDNN convolutions and no hand-written kernel.

`flops_per_tile` counts torchvision's resnet18 convolutions (no fc), as
models/resnet.py runs them.
"""

from __future__ import annotations

from benchmark.reference import resnet18 as reference  # noqa: F401

WIDTH = 512


def backbone(e: dict):
    from snuffy_tpu_torch.models.resnet import ResNet18

    return ResNet18(norm=e["norm"], compute_dtype=e["compute_dtype"]), WIDTH


def _conv(cin, cout, k, h_out):
    return 2 * cin * cout * k * k * h_out * h_out


def flops(size=224) -> int:
    h = (size + 2 * 3 - 7) // 2 + 1              # the 7×7/2 stem
    total = _conv(3, 64, 7, h)
    h = (h + 2 - 3) // 2 + 1                     # 3×3/2 max pool
    cin = 64
    for i, cout in enumerate((64, 128, 256, 512)):
        for j in range(2):
            stride = 2 if (j == 0 and i > 0) else 1
            h_out = (h - 1) // stride + 1
            total += _conv(cin, cout, 3, h_out) + _conv(cout, cout, 3, h_out)
            if cin != cout or stride != 1:
                total += _conv(cin, cout, 1, h_out)
            cin, h = cout, h_out
    return total


def flops_per_tile(e: dict) -> int:
    return flops(e["img_size"])


def kernel_bounds(e: dict, batches) -> dict:
    return {}
