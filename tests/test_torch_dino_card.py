"""The DINO pretraining slice on the card (marked `cuda`; skipped without
a GPU). No JAX here, so the card's machine collects this file:

    python -m pytest --noconftest -m cuda -q \\
        -o "markers=cuda: needs a CUDA GPU" tests/test_torch_dino_card.py

K5 at the DINO crops' shapes against its plain version; one augment
batch and one DINO step on the card against the CPU under the same draws
and weights.
"""

import numpy as np
import pytest
import torch

from snuffy_tpu_torch.models import vit
from snuffy_tpu_torch.ssl import augment, dino

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2,
            mlp_ratio=2.0, use_adapter=True, adapter_bottleneck=4,
            adapter_dropout=0.0)
TRAINER = dict(out_dim=64, n_local_crops=2, local_size=16, global_size=32,
               freeze_backbone=True, head_hidden_dim=32,
               head_bottleneck_dim=16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("z, n", [(3072, 37), (768, 197)])
def test_dense_kernel_at_the_dino_crops(cuda_device, dtype, z, n):
    """K5 at the DINO crops' shapes (ViT-S/16, batch 64: locals n=37,
    globals n=197) against its plain version, within chip_smoke's
    DENSE_TOL of max |plain|."""
    from snuffy_tpu_torch.ops.dense_attention import (
        dense_attention_reference,
        fused_self_attention,
    )

    gen = torch.Generator(cuda_device).manual_seed(z + n)
    q, k, v = (torch.randn((z, n, 64), generator=gen, device=cuda_device)
               .to(dtype) for _ in range(3))
    got = fused_self_attention(q, k, v, n)
    ref = dense_attention_reference(q, k, v, n)
    tol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}[dtype]
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol * float(ref.float().abs().max())


@pytest.mark.cuda
def test_multicrop_gpu_matches_cpu_under_the_same_draws(cuda_device):
    """One multi-crop batch (8 noise images of 224², 2 global and 8 local
    views) on the card and on the CPU from the same draws. The card's
    exp and sqrt may differ from the CPU's by an ulp or two, so a crop's
    sample positions (up to 223 px) move by up to ≈ 5e-5 px, and a pixel
    of noise (steps of up to 1 between neighbours) by that much, 2.4e-4
    after the normalisation's 1/0.224: every element within 3e-4, and 90 %
    within 1e-5."""
    u8 = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (8, 224, 224, 3), dtype=np.uint8))
    draws = augment.multicrop_draws(torch.Generator().manual_seed(2), 8, 8,
                                    device=torch.device("cpu"))
    cpu = augment.dino_multicrop_batch(u8, None, draws=draws)
    gpu = augment.dino_multicrop_batch(
        u8.to(cuda_device), None,
        draws=tuple({k: v.to(cuda_device) for k, v in d.items()}
                    for d in draws))
    for a, b in zip(cpu, gpu):
        d = (b.cpu() - a).abs()
        assert float(d.max()) <= 3e-4
        assert float((d <= 1e-5).float().mean()) >= 0.9


@pytest.mark.cuda
def test_dino_step_gpu_matches_cpu(cuda_device):
    """One f32 step (dropouts off) on the card and on the CPU from the
    same weights: loss and centre within 1e-5 of their scale, parameters
    within Adam's 2·lr of each other and 99 % within 1e-4."""
    trainers, states = [], []
    for device in (torch.device("cpu"), cuda_device):
        t = dino.DINOTrainer(vit.VisionTransformer(**TINY).to(device),
                             **TRAINER)
        trainers.append(t)
        states.append(t.init_state(0))
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(2, 4, 32, 32, 3)).astype(
        np.float32))
    loc = torch.from_numpy(rng.normal(size=(2, 4, 16, 16, 3)).astype(
        np.float32))
    lr = 1e-3
    losses = [float(t.step(s, g.to(s.center.device), loc.to(s.center.device),
                           lr, 0.04, 0.99, 0.04, False)[1])
              for t, s in zip(trainers, states)]
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    c0, c1 = (s.center.cpu() for s in states)
    assert float((c1 - c0).abs().max()) <= 1e-5 * float(c0.abs().max())
    for k, v in states[0].student.state_dict().items():
        if not v.is_floating_point():
            continue
        d = (states[1].student.state_dict()[k].cpu() - v).abs()
        assert float(d.max()) <= 2 * lr, k
        assert float((d <= 1e-4 * (1 + v.abs())).float().mean()) >= 0.99, k
