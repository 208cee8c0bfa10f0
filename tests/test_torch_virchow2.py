"""The port's Virchow2 embedder (`models/vit.VisionTransformer` with its
register tokens, LayerScale, packed SwiGLU and class-plus-mean pooling)
against the benchmark's plain float32 reference
`benchmark/reference/virchow2.py`, at a small size on the CPU: dim 160, 2
heads of 80 (the published dk), depth 2, patch 14 at 56² (16 patches, 21
tokens with the class token and 4 registers), mlp_ratio 5.3375 (fc1 854
wide, fc2 427). Weights are the benchmark's seeded ones, loaded strictly
under timm's names. Also: the registers are left out of the mean, a timm
Virchow2 state dict loads with `strict=True`, the registry and the slide
CLI build it by name, and ViT-S/16 with the options off runs the ops it
ran before them, bit for bit.
"""

import pytest
import torch
import torch.nn.functional as F

from benchmark import weights
from benchmark.arch import virchow2 as arch
from benchmark.reference import common as ref_common
from benchmark.reference import virchow2 as ref
from snuffy_tpu_torch.embed.registry import EMBEDDER_FEAT_DIMS, Embedder
from snuffy_tpu_torch.embed.torch_import import (
    import_vit,
    load_embedder_weights,
)
from snuffy_tpu_torch.models import vit
from snuffy_tpu_torch.models.layers import layer_norm, linear
from snuffy_tpu_torch.ops.dense_attention import fused_self_attention

SMALL = {"arch": "virchow2", "dim": 160, "depth": 2, "heads": 2,
         "mlp_ratio": 5.3375, "reg_tokens": 4, "init_values": 1e-5,
         "patch": 14, "img_size": 56, "num_classes": 1,
         "compute_dtype": "float32", "imagenet_norm": True}
# f32: the same products summed in other orders (the port's attention
# takes the plain dense path, its patch GEMM one F.linear). bf16: every
# product's operands rounded to 8 bits, LayerNorm, softmax and the
# registers' and patches' residual stream in bf16 through two blocks; the
# fp8 control reads ~10x this.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def timm_state_dict(e, seed):
    """{timm name: tensor} of a Virchow2 backbone at `e`'s sizes, and the
    instance head, drawn as the benchmark draws them."""
    return weights.make(ref.param_spec(e), seed, "cpu")


def small_embedder(e, seed=7):
    backbone, dim = arch.backbone(e)
    emb = Embedder(backbone, dim, e["num_classes"], imagenet_norm=True)
    w = timm_state_dict(e, seed)
    emb.load_state_dict(w, strict=True)
    return emb.eval(), w


def tiles(n=5, size=56, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, size, size, 3), generator=gen,
                         dtype=torch.uint8)


def rel(a, b):
    return float((a.float() - b).norm() / b.norm())


@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_the_plain_reference(dtype, seed):
    e = dict(SMALL, compute_dtype=dtype)
    emb, w = small_embedder(e, seed)
    x = tiles(seed=seed)
    with torch.no_grad():
        got, logits = emb(x)
        want = ref.embed(w, x, e)
    assert got.shape == (5, 320) and got.dtype == torch.float32
    assert rel(got, want) <= TOL[dtype]
    want_logits = ref_common.dense(want, w["head.weight"], w["head.bias"])
    assert rel(logits, want_logits) <= 10 * TOL[dtype]


def test_bf16_control_reads_above_the_bf16_tolerance():
    """The reference with every product's operands through fp8 (the
    benchmark's control) misses the bf16 tolerance: the tolerance tells a
    lower precision apart."""
    e = dict(SMALL, compute_dtype="bfloat16")
    w = timm_state_dict(e, 7)
    x = tiles()
    with torch.no_grad():
        low = ref.embed(w, x, e, ref_common.fp8)
        want = ref.embed(w, x, e)
    assert rel(low, want) > TOL["bfloat16"]


def test_registers_are_left_out_of_the_mean(monkeypatch):
    """The second half of the embedding is the mean of the final
    LayerNorm's patch tokens (rows 5..20), not of the registers too."""
    emb, _ = small_embedder(SMALL)
    seen = []
    real = vit.class_plus_mean

    def keep(y, prefix):
        seen.append((y, prefix))
        return real(y, prefix)

    monkeypatch.setattr(vit, "class_plus_mean", keep)
    with torch.no_grad():
        got, _ = emb(tiles())
    (y, prefix), = seen
    assert prefix == 5 and y.shape[1] == 21
    torch.testing.assert_close(got[:, :160], y[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(got[:, 160:], y[:, 5:].mean(dim=1),
                               rtol=0, atol=0)
    assert not torch.allclose(got[:, 160:], y[:, 1:].mean(dim=1))


def test_position_grid_resizes_behind_the_registers():
    """At another input size the class and register rows of the position
    table stay as they are and the patch grid is resized as the class
    token's table alone would be (the ViT's bicubic weights)."""
    model, _ = arch.backbone(SMALL)
    with torch.no_grad():
        model.pos_embed.normal_()
    got = vit.interpolate_pos_encoding(model.pos_embed, 36, 84, 84, 14, 5)
    alone = vit.interpolate_pos_encoding(model.pos_embed[:, 4:], 36, 84, 84,
                                         14)
    assert got.shape == (1, 41, 160)
    assert torch.equal(got[:, :5], model.pos_embed[:, :5])
    assert torch.equal(got[:, 5:], alone[:, 1:])
    with torch.no_grad():
        assert model(torch.rand(2, 84, 84, 3)).shape == (2, 320)


def test_packed_crops_with_registers_are_the_crops_alone():
    """Two images packed in one sequence (K5's z fold) embed as each alone:
    the registers of one crop do not reach the other."""
    model, _ = arch.backbone(SMALL)
    x = torch.rand(4, 56, 56, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        torch.testing.assert_close(model(x, pack=2), model(x),
                                   rtol=1e-5, atol=1e-5)


def timm_names(depth):
    """Every key of timm's Virchow2 backbone (`num_classes=0`,
    `global_pool=""`: no head, no fc_norm)."""
    names = ["cls_token", "reg_token", "pos_embed", "patch_embed.proj.weight",
             "patch_embed.proj.bias"]
    for i in range(depth):
        names += [f"blocks.{i}.{n}" for n in (
            "norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
            "attn.proj.weight", "attn.proj.bias", "ls1.gamma",
            "norm2.weight", "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias",
            "mlp.fc2.weight", "mlp.fc2.bias", "ls2.gamma")]
    return names + ["norm.weight", "norm.bias"]


def test_timm_state_dict_loads_strict(tmp_path):
    """A state dict under timm's Virchow2 names and shapes loads into the
    backbone with `strict=True`, straight and through the slide CLI's
    importer (every layer matched, nothing left over)."""
    e = SMALL
    w = timm_state_dict(e, 11)
    sd = {k[len("backbone."):]: v for k, v in w.items()
          if k.startswith("backbone.")}
    assert sorted(sd) == sorted(timm_names(e["depth"]))
    model, _ = arch.backbone(e)
    model.load_state_dict(sd, strict=True)
    assert sorted(import_vit(sd)) == sorted(sd)
    path = tmp_path / "virchow2.pth"
    torch.save({"module." + k: v for k, v in sd.items()}, path)
    fresh, _ = arch.backbone(e)
    matched, missing = load_embedder_weights(fresh, str(path), "Virchow2",
                                             "vit_huge_patch14_reg4")
    assert missing == [] and sorted(matched) == sorted(sd)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k])


def test_slide_cli_serves_virchow2_by_name(monkeypatch):
    """The slide CLI with `--embedder Virchow2 --backbone
    vit_huge_patch14_reg4 --feats_size 2560 --num_heads 20` builds, through
    the registry, the published backbone (widths, depth, registers, the
    261-row position table, LayerScale from 1e-5) with ImageNet
    normalisation on though `--transform` is 0, 2560-d embeddings, and a
    MILNet of 20 heads of 128 over them, and hands both to
    `predict_slide`. The embedder then runs cut to 2 blocks (the widths
    are the published ones). The seeded init of 631 M parameters, which a
    checkpoint overwrites and which takes ~50 s on a CPU, is skipped."""
    from snuffy_tpu_torch import predict_slide as cli
    from snuffy_tpu_torch.pipeline.slide_inference import SlidePrediction

    got = {}

    def fake_predict(path, embedder, milnet, **kw):
        got.update(embedder=embedder, milnet=milnet)
        return SlidePrediction(0.5, torch.zeros(0).numpy(), [], {})

    monkeypatch.setattr(cli, "predict_slide", fake_predict)
    monkeypatch.setattr(vit, "init_weights", lambda *a: None)
    cli.main(["--slide", "none.tif", "--embedder", "Virchow2", "--backbone",
              "vit_huge_patch14_reg4", "--feats_size", "2560",
              "--num_heads", "20", "--device", "cpu"])
    emb, net = got["embedder"], got["milnet"]
    b = emb.backbone
    assert isinstance(b, vit.VisionTransformer)
    assert emb.imagenet_norm and b.num_features == 2560
    assert EMBEDDER_FEAT_DIMS["vit_huge_patch14_reg4"] == 2560
    assert emb.head.in_features == 2560
    assert tuple(b.pos_embed.shape) == (1, 261, 1280)
    assert tuple(b.reg_token.shape) == (1, 4, 1280)
    assert len(b.blocks) == 32 and b.blocks[0].attn.num_heads == 16
    assert tuple(b.blocks[0].mlp.fc1.weight.shape) == (6832, 1280)
    assert tuple(b.blocks[0].mlp.fc2.weight.shape) == (1280, 3416)
    assert torch.all(b.blocks[0].ls1.gamma == 1e-5)
    assert net.i_classifier.fc[0].in_features == 2560
    b.blocks = b.blocks[:2]
    with torch.no_grad():
        feats, logits = emb(tiles(2, 224))
    assert feats.shape == (2, 2560) and logits.shape == (2, 1)


def old_vit_forward(model, x):
    """The ViT's forward as it was before the Virchow2 options (class token,
    GELU MLP, no LayerScale, class-token output), written out."""
    dtype = torch.float32
    b, h_img, w_img, _ = x.shape
    x = model.patch_embed(x, dtype)
    cls = model.cls_token.to(dtype).expand(b, -1, -1)
    x = torch.cat([cls, x], dim=1) + model.pos_embed.to(dtype)
    for blk in model.blocks:
        h = layer_norm(x, blk.norm1, dtype)
        bb, n, c = h.shape
        heads = blk.attn.num_heads
        dk = c // heads
        qkv = linear(h, blk.attn.qkv, dtype).reshape(bb, n, 3, heads, dk)
        qkv = qkv.permute(2, 0, 3, 1, 4).contiguous()
        q, k, v = qkv.view(3, bb * heads, n, dk).unbind(0)
        a = fused_self_attention(q, k, v, n)
        a = a.reshape(bb, heads, n, dk).transpose(1, 2).reshape(bb, n, c)
        x = x + linear(a, blk.attn.proj, dtype)
        h = F.gelu(linear(layer_norm(x, blk.norm2, dtype), blk.mlp.fc1,
                          dtype))
        x = x + linear(h, blk.mlp.fc2, dtype)
    return layer_norm(x[:, 0], model.norm, dtype).float()


def test_vit_s16_with_the_options_off_is_unchanged():
    """ViT-S/16 (3 blocks) holds no register, LayerScale or gate, keeps
    DINO's keys, and gives the old forward's output bit for bit."""
    model = vit.VisionTransformer(embed_dim=384, depth=3, num_heads=6,
                                  seed=5).eval()
    keys = set(model.state_dict())
    assert not any("ls1" in k or "ls2" in k or "reg_token" in k
                   for k in keys)
    assert model.reg_token is None and model.num_features == 384
    assert all(b.ls1 is None and b.ls2 is None and not b.mlp.gated
               for b in model.blocks)
    assert tuple(model.pos_embed.shape) == (1, 197, 384)
    x = torch.rand(2, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(model(x), old_vit_forward(model, x))
