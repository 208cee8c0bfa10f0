"""Virchow2 on the card (marked `cuda`; skipped without a GPU). No JAX
here, so the card's machine collects this file:

    python -m pytest --noconftest -m cuda -q \\
        -o "markers=cuda: needs a CUDA GPU" tests/test_torch_virchow2_card.py

K5 at Virchow2's heads of 80 over its 261 tokens (the bf16 body pads dk
to 128 and streams K/V through its ring past n = 256) against its plain
version; the published ViT-H/14 in bf16 against the float32 reference;
and the `serve.forward` spans of `predict_tiles`, one a batch inside
`serve.embed`, whose stream time lies within embed_s.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.embed.registry import Embedder
from snuffy_tpu_torch.models.snuffy import build_milnet
from snuffy_tpu_torch.models.vit import VisionTransformer
from snuffy_tpu_torch.pipeline.slide_inference import predict_tiles
from snuffy_tpu_torch.utils import profiling


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("z, n, n_valid", [(4096, 261, 261),
                                           (1200, 261, 261),
                                           (160, 333, 300)])
def test_dense_kernel_at_virchow2s_heads(cuda_device, dtype, z, n, n_valid):
    """K5 at (batch 256 · 16 heads, 261 tokens, dk 80), a tail batch of 75
    tiles, and a ragged n with keys masked past n_valid, within chip_smoke's
    DENSE_TOL of max |plain| (the MAE card tests' tolerances)."""
    from snuffy_tpu_torch.ops import kernels
    from snuffy_tpu_torch.ops.dense_attention import (
        dense_attention_reference,
        fused_self_attention,
    )

    gen = torch.Generator(cuda_device).manual_seed(z + n + n_valid)
    q, k, v = (torch.randn((z, n, 80), generator=gen, device=cuda_device)
               .to(dtype) for _ in range(3))
    before = kernels.DENSE.launches
    got = fused_self_attention(q, k, v, n_valid)
    assert kernels.DENSE.launches == before + 1
    ref = dense_attention_reference(q, k, v, n_valid)
    torch.cuda.synchronize()
    tol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}[dtype]
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol * float(ref.float().abs().max())


@pytest.mark.cuda
def test_published_virchow2_in_bf16_against_the_reference(cuda_device):
    """The published ViT-H/14 (32 blocks, 1280 wide) in bf16 on 16 tiles,
    with the benchmark's seeded weights, against the float32 reference:
    within the cell's limit of `embed_rel_err`."""
    from benchmark import program, run
    from benchmark.reference import common

    cell = run.Cell("virchow2.serve")
    w = program.embedder_weights(cell.config, 2**31 + 5, cuda_device)
    emb = program.build_embedder(cell.config, w, cuda_device)
    gen = torch.Generator(cuda_device).manual_seed(5)
    x = torch.randint(0, 256, (16, 224, 224, 3), generator=gen,
                      device=cuda_device, dtype=torch.uint8)
    e = cell.config["embedder"]
    with torch.no_grad():
        got, _ = emb(x)
        with common.exact_float32():
            want = program.embedder_reference(e).embed(w, x, e)
    assert got.shape == (16, 2560)
    err = float((got - want).norm() / want.norm())
    print(f"virchow2 bf16 embed_rel_err on 16 tiles: {err!r}")
    assert err <= cell.limits["embed_rel_err"]


def small_serve(device):
    """A 2-block ViT with Virchow2's options (dk 80) and a MILNet of
    d 320, and 600 pageable uint8 tiles of 56²: three batches of 256."""
    torch.manual_seed(0)
    vit = VisionTransformer(patch_size=14, embed_dim=160, depth=2,
                            num_heads=2, mlp_ratio=5.3375, img_size=56,
                            reg_tokens=4, init_values=1.0,
                            mlp="swiglu_packed", pool="cls_mean",
                            compute_dtype="bfloat16")
    embedder = Embedder(vit, 320, 1, imagenet_norm=True).to(device).eval()
    cfg = SnuffyModelConfig(feats_size=320, num_classes=1, num_heads=2,
                            big_lambda=64, random_patch_share=0.5, depth=2,
                            activation="gelu", compute_dtype="bfloat16")
    milnet = build_milnet(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    tiles = torch.from_numpy(
        rng.integers(0, 256, (600, 56, 56, 3)).astype(np.uint8))
    return embedder, milnet, tiles


@pytest.mark.cuda
def test_forward_spans_nest_in_embed_with_their_stream_time(cuda_device,
                                                            tmp_path):
    """Under a profiler each batch's `serve.forward` lies inside
    `serve.embed`, after that batch's `serve.upload`, and forward_stream_s
    lies within embed_s; outside one, forward_s is there and
    forward_stream_s is not."""
    embedder, milnet, tiles = small_serve(cuda_device)
    kw = dict(embed_batch=256, embed_size=56)
    predict_tiles(tiles, embedder, milnet, **kw)             # builds, warms
    untraced = predict_tiles(tiles, embedder, milnet, **kw).timings
    assert "forward_stream_s" not in untraced
    assert 0.0 < untraced["forward_s"] <= untraced["embed_s"]
    with profiling.device_trace(str(tmp_path)):
        traced = predict_tiles(tiles, embedder, milnet, **kw).timings
    assert 0.0 < traced["forward_stream_s"] <= traced["embed_s"]
    assert 0.0 < traced["forward_s"] <= traced["embed_s"]
    path, = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    def spans(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("cat") == "user_annotation"
                      and e.get("name") == name)

    (e0, e1), = spans("serve.embed")
    uploads, forwards = spans("serve.upload"), spans("serve.forward")
    assert len(uploads) == len(forwards) == 3
    for (u0, u1), (f0, f1) in zip(uploads, forwards):
        assert e0 <= u0 < u1 <= f0 < f1 <= e1
