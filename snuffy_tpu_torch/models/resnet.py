"""ResNet-18 and ResNet-50 backbones with selectable normalisation, in
PyTorch.

Port of `snuffy_tpu/models/resnet.py`. The SimCLR embedder is torchvision's
resnet18 with `norm_layer=nn.InstanceNorm2d` (affine-less, no running
stats) and the fc head removed; the DINO ResNet-50 is torchvision's
resnet50 with frozen BatchNorm. Parameter names are torchvision's
(`conv1`, `bn1`, `layer{i}.{j}.conv1`, `.bn1`, ..., `.downsample.0/1`), so
a torchvision state dict without `fc` loads with `strict=True`
(`num_batches_tracked` is dropped on load, as torchvision's own
FrozenBatchNorm2d does).

Images come in as (B, H, W, 3) float; the convs run in `channels_last`.
The dtypes are the JAX model's: under `compute_dtype="bfloat16"` each conv
takes bf16 inputs and weights and returns bf16 (flax `Conv(dtype=bf16)`),
the norms compute in f32 and return f32, so the activations between the
blocks, the residual sums, the max pool and the global average pool are
f32. The convs are `F.conv2d` (cuDNN): the JAX package leaves them to XLA,
no Pallas kernel computes them. An f32 conv on the card follows
`torch.backends.cudnn.allow_tf32` (PyTorch's default is TF32); set it to
False for f32 results.

Output: (B, 512) for ResNet-18, (B, 2048) for ResNet-50, f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from snuffy_tpu_torch.ops.init import lecun_normal

BN_EPS = 1e-5


class InstanceNorm(nn.Module):
    """torch InstanceNorm2d(affine=False) as the JAX package computes it:
    per sample and channel over H·W, in f32, with the biased variance and
    eps 1e-5; (x − μ)/√(σ² + eps). No parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, C, H, W)
        x = x.float()
        var, mu = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
        return (x - mu) / torch.sqrt(var + BN_EPS)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm off the checkpoint's running stats, in f32:
    (x − mean)/√(var + eps)·weight + bias. weight and bias are parameters,
    running_mean and running_var buffers, as in torchvision."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def c(t):
            return t.reshape(1, -1, 1, 1)

        return ((x.float() - c(self.running_mean))
                / torch.sqrt(c(self.running_var) + BN_EPS)
                * c(self.weight) + c(self.bias))


def make_norm(kind: str, features: int) -> nn.Module:
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        return FrozenBatchNorm(features)
    raise KeyError(f"norm layer {kind!r} not in ('instance', 'batch')")


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype
         ) -> torch.Tensor:
    """flax Conv(dtype=…): input and f32 kernel cast to `dtype`, the
    output in `dtype`; channels_last throughout."""
    w = layer.weight.to(dtype).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x.to(dtype), w, None, layer.stride, layer.padding)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, norm: str):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = make_norm(norm, features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = make_norm(norm, features)
        self.downsample = None
        if cin != features or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, features, 1, stride),
                                            make_norm(norm, features))

    def forward(self, x, dtype):
        y = F.relu(self.bn1(conv(x, self.conv1, dtype)))
        y = self.bn2(conv(y, self.conv2, dtype))
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](conv(x, self.downsample[0], dtype))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (1×1 → 3×3 with the stride → 1×1,
    expansion 4)."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, norm: str):
        super().__init__()
        out = features * 4
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = make_norm(norm, features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = make_norm(norm, features)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = make_norm(norm, out)
        self.downsample = None
        if cin != out or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, out, 1, stride),
                                            make_norm(norm, out))

    def forward(self, x, dtype):
        y = F.relu(self.bn1(conv(x, self.conv1, dtype)))
        y = F.relu(self.bn2(conv(y, self.conv2, dtype)))
        y = self.bn3(conv(y, self.conv3, dtype))
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](conv(x, self.downsample[0], dtype))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Stem (7×7/2 conv, norm, ReLU, 3×3/2 max pool), four stages, f32
    global average pool; no fc."""

    def __init__(self, block, blocks, norm: str = "instance",
                 compute_dtype: str = "float32", seed: int = 0):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = make_norm(norm, 64)
        cin = 64
        for i, (features, count) in enumerate(
                zip((64, 128, 256, 512), blocks), start=1):
            layers = []
            for j in range(count):
                stride = 2 if (j == 0 and i > 1) else 1
                layers.append(block(cin, features, stride, norm))
                cin = features * block.expansion
            setattr(self, f"layer{i}", nn.Sequential(*layers))
        self.num_features = cin
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():   # flax's Conv init: lecun_normal kernels
            for mod in self.modules():
                if isinstance(mod, nn.Conv2d):   # fan_in = in · kh · kw
                    lecun_normal(mod.weight.view(mod.out_channels, -1), gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = (torch.bfloat16 if self.compute_dtype == "bfloat16"
                 else torch.float32)
        y = x.permute(0, 3, 1, 2)   # NCHW view of the NHWC images
        y = F.relu(self.bn1(conv(y, self.conv1, dtype)))
        y = F.max_pool2d(y, 3, 2, 1)   # pads with −inf, as flax does
        for i in range(1, 5):
            for blk in getattr(self, f"layer{i}"):
                y = blk(y, dtype)
        return y.float().mean(dim=(2, 3))


class ResNet18(ResNet):
    """The SimCLR embedder: (B, H, W, 3) → (B, 512)."""

    def __init__(self, norm: str = "instance",
                 compute_dtype: str = "float32", seed: int = 0):
        super().__init__(BasicBlock, (2, 2, 2, 2), norm, compute_dtype, seed)


class ResNet50(ResNet):
    """The DINO ResNet-50 backbone: (B, H, W, 3) → (B, 2048)."""

    def __init__(self, norm: str = "batch", compute_dtype: str = "float32",
                 seed: int = 0):
        super().__init__(Bottleneck, (3, 4, 6, 3), norm, compute_dtype, seed)
