"""Plain float32 ResNet-18 with InstanceNorm (SimCLR as in DSMIL, Li et
al., CVPR 2021, arXiv:2011.08939; torchvision's resnet18 with
`norm_layer=InstanceNorm2d`, affine-less, and no fc).

Stem 7×7/2 conv, norm, ReLU, 3×3/2 max pool; four stages of two basic
blocks (64, 128, 256, 512 channels, stride 2 from the second stage, a 1×1
projection where the shape changes); global average pool. Parameter names
are torchvision's under `backbone.`, with the linear head `head.`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.common import identity

IN_EPS = 1e-5
STAGES = (64, 128, 256, 512)


def _blocks():
    """(prefix, in channels, out channels, stride) of every basic block."""
    cin = 64
    for i, cout in enumerate(STAGES, start=1):
        for j in range(2):
            stride = 2 if (j == 0 and i > 1) else 1
            yield f"backbone.layer{i}.{j}.", cin, cout, stride
            cin = cout


def param_spec(e: dict):
    spec = [("backbone.conv1.weight", (64, 3, 7, 7), "weight")]
    for pre, cin, cout, stride in _blocks():
        spec += [(pre + "conv1.weight", (cout, cin, 3, 3), "weight"),
                 (pre + "conv2.weight", (cout, cout, 3, 3), "weight")]
        if cin != cout or stride != 1:
            spec.append((pre + "downsample.0.weight", (cout, cin, 1, 1),
                         "weight"))
    spec += [("head.weight", (e["num_classes"], 512), "weight"),
             ("head.bias", (e["num_classes"],), "bias")]
    return spec


def _norm(x):
    var, mu = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
    return (x - mu) / torch.sqrt(var + IN_EPS)


def embed(w: dict, images: torch.Tensor, e: dict, q=identity) -> torch.Tensor:
    """uint8 (B, H, W, 3) → (B, 512) float32."""
    def conv(x, name, stride, pad):
        return F.conv2d(q(x), q(w[name]), None, stride, pad)

    x = (images.float() / 255.0).permute(0, 3, 1, 2)
    x = F.relu(_norm(conv(x, "backbone.conv1.weight", 2, 3)))
    x = F.max_pool2d(x, 3, 2, 1)
    for pre, cin, cout, stride in _blocks():
        y = F.relu(_norm(conv(x, pre + "conv1.weight", stride, 1)))
        y = _norm(conv(y, pre + "conv2.weight", 1, 1))
        if cin != cout or stride != 1:
            x = _norm(conv(x, pre + "downsample.0.weight", stride, 0))
        x = F.relu(y + x)
    return x.mean(dim=(2, 3))
