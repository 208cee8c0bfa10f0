"""The MAE pretraining slice on the card (marked `cuda`; skipped without a
GPU). No JAX here, so the card's machine collects this file:

    python -m pytest --noconftest -m cuda -q \\
        -o "markers=cuda: needs a CUDA GPU" tests/test_torch_mae_card.py

K5 at the MAE shapes against its plain version; one augment batch and one
MAE step on the card against the CPU under the same draws, noise and
weights.
"""

import numpy as np
import pytest
import torch

from snuffy_tpu_torch.models import mae
from snuffy_tpu_torch.ssl import augment, mae_trainer

SMALL = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
             decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2,
             adapter_bottleneck=8, adapter_scale=4.0, with_decoder=True,
             norm_pix_loss=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("z, n, dk", [(768, 50, 64), (1024, 197, 32),
                                      (1024, 50, 64), (256, 65, 80)])
def test_dense_kernel_at_the_mae_shapes(cuda_device, dtype, z, n, dk):
    """K5 at MAE pretraining's shapes (batch 64 at --mask_ratio 0.75; ViT-H
    at batch 16): ViT-B's masked encoder (n=50), the decoder (dk=32),
    ViT-L's encoder and ViT-H's (n=65, dk=80), within chip_smoke's
    DENSE_TOL of max |plain|."""
    from snuffy_tpu_torch.ops.dense_attention import (
        dense_attention_reference,
        fused_self_attention,
    )

    gen = torch.Generator(cuda_device).manual_seed(z + n + dk)
    q, k, v = (torch.randn((z, n, dk), generator=gen, device=cuda_device)
               .to(dtype) for _ in range(3))
    got = fused_self_attention(q, k, v, n)
    ref = dense_attention_reference(q, k, v, n)
    tol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}[dtype]
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol * float(ref.float().abs().max())


@pytest.mark.cuda
def test_mae_augment_gpu_matches_cpu_under_the_same_draws(cuda_device):
    """One batch (16 noise images of 256², cropped to 224) on the card and
    on the CPU from the same draws: the card's exp and sqrt may move a
    sample position by an ulp or two, so every element within 3e-4 and
    90 % within 1e-5 (as the DINO crops)."""
    u8 = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (16, 256, 256, 3), dtype=np.uint8))
    d = augment.mae_draws(torch.Generator().manual_seed(2), 16,
                          device=torch.device("cpu"))
    cpu = augment.mae_train_augment(u8, None, 224, draws=d)
    gpu = augment.mae_train_augment(
        u8.to(cuda_device), None, 224,
        draws={k: v.to(cuda_device) for k, v in d.items()})
    diff = (gpu.cpu() - cpu).abs()
    assert float(diff.max()) <= 3e-4
    assert float((diff <= 1e-5).float().mean()) >= 0.9


@pytest.mark.cuda
def test_mae_step_gpu_matches_cpu(cuda_device):
    """One f32 step (bf16 images, dropout off, the adapters'
    up-projections drawn non-zero, everything trained) on the card and on
    the CPU from the same weights, batch and noise: loss within 1e-5 of its
    scale, parameters within Adam's 2·lr of each other and 99 % within
    1e-4. The key
    projection's bias has a true gradient of 0 (the softmax cancels it):
    both sides step it by ±lr on rounding noise, so it is held to the 2·lr
    bound alone (as chip_smoke's phase 9 holds it)."""
    lr = 1e-3
    gen = torch.Generator().manual_seed(3)
    sides = []
    for device in (torch.device("cpu"), cuda_device):
        model = mae.MaskedAutoencoderViT(**SMALL)
        with torch.no_grad():
            for blk in [*model.blocks, *model.decoder_blocks]:
                blk.adaptmlp.dropout = 0.0
                w = blk.adaptmlp.up_proj.weight
                w.copy_(0.02 * torch.randn(w.shape, generator=
                                           torch.Generator().manual_seed(4)))
        t = mae_trainer.MAETrainer(model.to(device), freeze_non_adapter=False)
        sides.append((t, t.init_state()))
    u8 = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (4, 32, 32, 3), dtype=np.uint8))
    noise = torch.rand(4, 16, generator=gen)
    losses = [float(t.step(s, u8.to(device), lr, noise=noise.to(device))[1])
              for (t, s), device in zip(sides,
                                        (torch.device("cpu"), cuda_device))]
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    cpu_sd = sides[0][1].model.state_dict()
    gpu_sd = sides[1][1].model.state_dict()
    for k, v in cpu_sd.items():
        d = (gpu_sd[k].cpu() - v).abs()
        assert float(d.max()) <= 2 * lr, k
        within = d <= 1e-4 * (1 + v.abs())
        if k.endswith("attn.qkv.bias"):
            dim = v.shape[0] // 3
            within = torch.cat([within[:dim], within[2 * dim:]])
        assert float(within.float().mean()) >= 0.99, k
