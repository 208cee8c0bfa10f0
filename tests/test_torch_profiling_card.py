"""The serve path's spans on the card (marked `cuda`; skipped without a
GPU). No JAX here, so the card's machine collects this file:

    python -m pytest --noconftest -m cuda -q \\
        -o "markers=cuda: needs a CUDA GPU" tests/test_torch_profiling_card.py

Under torch.profiler, `predict_tiles` reads the stream time of its
uploads from the CUDA event pairs of its `serve.upload` spans; with no
profiler recording it records none.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.embed.registry import Embedder
from snuffy_tpu_torch.models.snuffy import build_milnet
from snuffy_tpu_torch.models.vit import VisionTransformer
from snuffy_tpu_torch.pipeline.slide_inference import predict_tiles


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_upload_stream_time_under_a_profiler(cuda_device):
    """600 pageable uint8 tiles of 224² in three embed batches through a
    2-layer ViT and a MILNet of d=64: under a profiler, upload_stream_s is
    there and within embed_s; outside one it is not."""
    torch.manual_seed(0)
    vit = VisionTransformer(patch_size=16, embed_dim=64, depth=2, num_heads=2)
    embedder = Embedder(vit, 64, 1).to(cuda_device).eval()
    cfg = SnuffyModelConfig(feats_size=64, num_classes=1, num_heads=2,
                            big_lambda=64, random_patch_share=0.5, depth=2,
                            activation="gelu")
    milnet = build_milnet(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(0)
    tiles = torch.from_numpy(
        rng.integers(0, 256, (600, 224, 224, 3)).astype(np.uint8))

    predict_tiles(tiles, embedder, milnet)          # builds and warms
    untraced = predict_tiles(tiles, embedder, milnet).timings
    assert "upload_stream_s" not in untraced
    assert 0.0 < untraced["upload_s"] <= untraced["embed_s"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = predict_tiles(tiles, embedder, milnet).timings
    assert 0.0 < traced["upload_stream_s"] <= traced["embed_s"]
    assert 0.0 < traced["upload_s"] <= traced["embed_s"]
