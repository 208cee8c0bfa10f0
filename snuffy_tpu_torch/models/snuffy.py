"""Snuffy sparse-transformer MIL aggregator, binary and multiclass, in
PyTorch.

Port of `snuffy_tpu/models/snuffy.py` (reference snuffy.py and
snuffy_multiclass.py; `cfg.multiclass` selects the multiclass selection
of `ops/selection.py`). A bag is a static
(N_pad, d) tensor with an (N_pad,) bool mask; with `segments` = k > 1 the
rows hold k equal-length bags packed on the row axis and each bag's rows
attend only to its own slots (one forward at GEMM height k·N).

Module names follow the reference `.pth` layout
(`snuffy_tpu/embed/torch_export.py`), so a state dict exported from the
JAX parameters, or a reference checkpoint, loads with `strict=True`.

Kept from the JAX model:
  * keys project the PRE-norm selected rows, q and v project LayerNorm(x),
    and the attention residual is the pre-norm selected rows;
  * q and v share one d→2d GEMM (the parameters stay separate);
  * LayerNorm eps is 1e-6 (flax's default), stats and affine in f32;
  * under bf16 the instance logits come from the f32 feats, the residual
    stream runs bf16 and the masked mean pool accumulates in f32;
  * the top share is chosen once per forward, the random share per layer.

In training mode (`model.train()`) the forward is differentiable and runs
the three dropouts of the JAX model: on the attention probabilities
(`attention_dropout`, the kernels' hash with one seed per layer call), on
the attention output and the FFN output (`encoder_dropout`), and inside
the FFN after the activation (`ffn_dropout`: by default
`encoder_dropout` for the binary model and 0.1 for the multiclass one,
as the reference's trainers leave it). The hash seeds come from a CPU
generator, so no device value is read back each layer (JAX draws them on
the device). Data parallelism runs this model whole on each rank
(`parallel/sharded_train.py`).

With a `mesh` (`parallel/mesh.py`) of sp or tp above 1 (one bag a
forward, segments = 1, as in the JAX model):
  * sp: the rank holds N/sp rows of the bag. The instance logits and the
    mask are gathered over sp once a forward, so every sp rank selects
    the same slots over the global N (the random share from the same
    generator state); the gather, the attention and the scatter run
    through `parallel/sp_attention.py`, the masked mean pool sums and
    counts over sp. The row-local dropouts (inside the FFN and on its
    output) draw from a generator seeded by a shared draw plus the sp
    index, so the ranks' masks differ;
  * tp: Megatron's column and row parallel projections by
    `parallel/sharded_train.TP_RULES`: the rank holds its block of wq,
    wk, wv and ff.w1 (by output feature, w1's bias too) and of wo and
    ff.w2 (by input feature); q, k and v are its h/tp heads, K1/K2 run
    on them (`parallel/tp_attention.py`), and wo's and w2's partial
    products are summed over tp before their whole biases are added. The
    FFN's inner dropout draws the whole (N, d·mult) mask and keeps the
    rank's columns, the one-rank model's mask.
With `cfg.remat` each encoder layer runs under
`torch.utils.checkpoint` (non-reentrant), its activations recomputed in
the backward; the layer's generators are set back to their states at the
layer's start for the recompute (checkpoint replays only torch's default
generators), so the recompute draws the same selection, seeds and masks
and the step is bitwise the step without remat.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from snuffy_tpu_torch.configs import SnuffyModelConfig
from snuffy_tpu_torch.models.layers import LN_EPS, dropout, layer_norm, linear
from snuffy_tpu_torch.ops.fused_attention import (
    fused_packed_inverted_sparse_attention,
)
from snuffy_tpu_torch.ops.init import init_linear
from snuffy_tpu_torch.ops.selection import (
    PreparedSelection,
    binary_selection_draw,
    binary_selection_prepare,
    multiclass_selection_draw,
    multiclass_selection_prepare,
    packed_selection_draw,
    packed_selection_prepare,
)
from snuffy_tpu_torch.parallel.collectives import (
    copy_to,
    gather,
    reduce_from,
)
from snuffy_tpu_torch.parallel.sp_attention import (
    sp_gather_rows,
    sp_inverted_sparse_attention,
    sp_scatter_rows,
    sp_size,
)
from snuffy_tpu_torch.parallel.tp_attention import (
    tp_fused_inverted_sparse_attention,
    tp_size,
)


ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "selu": F.selu,
}


def compute_dtype_of(cfg: SnuffyModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def dropout_columns(x: torch.Tensor, rate: float, generator, col0: int,
                    cols: int) -> torch.Tensor:
    """`dropout` of columns [col0, col0 + x.shape[1]) of a (n, cols)
    tensor: the whole mask is drawn, so the generator moves as for the
    whole tensor and the kept columns get the whole tensor's mask."""
    if rate <= 0.0:
        return x
    keep = torch.rand((x.shape[0], cols), generator=generator,
                      device=x.device)[:, col0:col0 + x.shape[1]] >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def row_parallel_linear(x: torch.Tensor, layer: nn.Linear, dtype, mesh,
                        what: str) -> torch.Tensor:
    """x @ W_rank over the rank's input features, summed over tp, plus
    the whole bias once: the row-parallel half of a Megatron pair."""
    part = F.linear(x.to(dtype), layer.weight.to(dtype))
    return (reduce_from(part, mesh, "tp", what) + layer.bias).to(dtype)


def _tp_block(mesh, width: int):
    """(first feature, features) of this rank's tp block of `width`."""
    tp = tp_size(mesh)
    per = width // tp
    return (mesh.tp_rank * per if tp > 1 else 0), per


class FCLayer(nn.Module):
    """Instance classifier (reference key `i_classifier.fc.0`)."""

    def __init__(self, feats_size: int, num_classes: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(feats_size, num_classes))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.fc(feats)


class MultiHeadedAttention(nn.Module):
    """Projections around the inverted sparse attention; `linears` are
    wq, wk, wv, wo in the reference's order (under tp, this rank's blocks
    of wq, wk, wv and wo; the biases of wq, wk and wv whole)."""

    def __init__(self, d: int, num_heads: int):
        super().__init__()
        if d % num_heads:
            raise ValueError("feats_size must be divisible by num_heads")
        self.d = d
        self.num_heads = num_heads
        self.linears = nn.ModuleList(nn.Linear(d, d) for _ in range(4))

    def forward(self, normed, key_tokens, slot_valid, q_valid, segments,
                dtype, dropout_rate=0.0, dropout_seed=None, mesh=None):
        d, tp = self.d, tp_size(mesh)
        h, dk = self.num_heads // tp, self.d // self.num_heads
        c0, dl = _tp_block(mesh, d)
        wq, wk, wv, wo = self.linears

        def split_heads(t):  # (L, d/tp) -> (h/tp, L, dk)
            return t.reshape(t.shape[0], h, dk).transpose(0, 1).contiguous()

        def bias(layer):  # the rank's block of a whole bias
            return layer.bias if tp == 1 else layer.bias[c0:c0 + dl]

        normed = copy_to(normed, mesh, "tp", "attention input")
        qv = F.linear(
            normed.to(dtype),
            torch.cat([wq.weight, wv.weight]).to(dtype),
            torch.cat([bias(wq), bias(wv)]).to(dtype),
        )
        q, v = split_heads(qv[:, :dl]), split_heads(qv[:, dl:])
        key_tokens = copy_to(key_tokens, mesh, "tp", "attention keys input")
        k = split_heads(F.linear(key_tokens.to(dtype), wk.weight.to(dtype),
                                 bias(wk).to(dtype)))
        if sp_size(mesh) > 1:
            out = sp_inverted_sparse_attention(
                q, k, v, slot_valid, q_valid, mesh,
                dropout_rate=dropout_rate, dropout_seed=dropout_seed)
        elif tp > 1:
            out = tp_fused_inverted_sparse_attention(
                q, k, v, slot_valid, q_valid, mesh.tp_rank,
                dropout_rate=dropout_rate, dropout_seed=dropout_seed)
        else:
            out = fused_packed_inverted_sparse_attention(
                q, k, v, slot_valid, q_valid, segments,
                dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            )
        out = out.transpose(0, 1).reshape(out.shape[1], dl)
        if tp > 1:
            return row_parallel_linear(out, wo, dtype, mesh,
                                       "attention output")
        return linear(out, wo, dtype)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d: int, mult: int, activation: str):
        super().__init__()
        self.w_1 = nn.Linear(d, d * mult)
        self.w_2 = nn.Linear(d * mult, d)
        self.hidden = d * mult
        self.act = ACTIVATIONS[activation]

    def forward(self, x, dtype, rate=0.0, generator=None, mesh=None):
        if tp_size(mesh) == 1:
            hidden = dropout(self.act(linear(x, self.w_1, dtype)), rate,
                             generator)
            return linear(hidden, self.w_2, dtype)
        x = copy_to(x, mesh, "tp", "FFN input")
        hidden = self.act(linear(x, self.w_1, dtype))
        hidden = dropout_columns(hidden, rate, generator,
                                 _tp_block(mesh, self.hidden)[0],
                                 self.hidden)
        return row_parallel_linear(hidden, self.w_2, dtype, mesh,
                                   "FFN output")


class SublayerConnection(nn.Module):
    """Holds the pre-norm of one residual branch (reference
    `sublayer.{0,1}.norm`); its dropout runs in `EncoderLayer`."""

    def __init__(self, d: int):
        super().__init__()
        self.norm = nn.LayerNorm(d, eps=LN_EPS)


class EncoderLayer(nn.Module):
    """Select Λ rows, attend, scatter back, FFN."""

    def __init__(self, cfg: SnuffyModelConfig, ffn_dropout: float):
        super().__init__()
        d = cfg.feats_size
        self.cfg = cfg
        self.ffn_dropout = ffn_dropout
        self.self_attn = MultiHeadedAttention(d, cfg.num_heads)
        self.feed_forward = PositionwiseFeedForward(d, cfg.mlp_multiplier,
                                                    cfg.activation)
        self.sublayer = nn.ModuleList(SublayerConnection(d) for _ in range(2))

    def forward(self, x, prep: PreparedSelection, mask, segments, generator,
                seed_generator, dtype, mesh=None, row_generator=None):
        """x (N, d) (under sp this rank's N/sp rows, `prep` over the global
        N); `row_generator` draws the row-local dropouts under sp."""
        n, d = x.shape
        cfg = self.cfg
        attn_rate = cfg.attention_dropout if self.training else 0.0
        enc_rate = cfg.encoder_dropout if self.training else 0.0
        ffn_rate = self.ffn_dropout if self.training else 0.0
        seed = None
        if attn_rate > 0.0:
            seed = int(torch.randint(0, 2**31 - 1, (),
                                     generator=seed_generator))
        if segments > 1:
            sel = packed_selection_draw(generator, prep, cfg.k_rand,
                                        n // segments, cfg.multiclass)
        elif cfg.multiclass:
            sel = multiclass_selection_draw(generator, prep)
        else:
            sel = binary_selection_draw(generator, prep, cfg.k_rand)
        sp = sp_size(mesh) > 1
        rows_gen = row_generator if sp else generator
        # Keys and the residual read the PRE-norm selected rows.
        sel_tokens = (sp_gather_rows(x, sel.indices, mesh) if sp
                      else x.index_select(0, sel.indices))
        normed = layer_norm(x, self.sublayer[0].norm, dtype)
        attn = self.self_attn(normed, sel_tokens, sel.slot_valid, mask,
                              segments, dtype, attn_rate, seed, mesh)
        new_sel = sel_tokens + dropout(attn, enc_rate, generator)
        if sp:
            y = sp_scatter_rows(x, sel.indices, sel.slot_valid, new_sel,
                                mesh)
        else:
            # Dead slots scatter into one extra row that is then dropped;
            # out of place, so the gradient reaches both x and new_sel.
            scatter_idx = torch.where(sel.slot_valid, sel.indices,
                                      torch.full_like(sel.indices, n))
            y = torch.cat([x, x.new_zeros(1, d)]).index_copy(
                0, scatter_idx, new_sel)[:n]
        ff = self.feed_forward(layer_norm(y, self.sublayer[1].norm, dtype),
                               dtype, ffn_rate, rows_gen, mesh)
        return y + dropout(ff, enc_rate, rows_gen)


def _remat(layer: EncoderLayer, x, generators, *args):
    """`layer(x, *args)` under torch.utils.checkpoint: the activations are
    recomputed in the backward, and the recompute starts from the
    `generators`' states at this call (each set back afterwards), so it
    draws what the first run drew."""
    from torch.utils.checkpoint import checkpoint

    gens = [g for g in generators if g is not None]
    start = [g.get_state() for g in gens]
    runs = [0]

    def run(x):
        runs[0] += 1
        if runs[0] == 1:
            return layer(x, *args)
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, start):
            g.set_state(state)
        try:
            return layer(x, *args)
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)

    return checkpoint(run, x, use_reentrant=False)


class Encoder(nn.Module):
    def __init__(self, cfg: SnuffyModelConfig, ffn_dropout: float):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(EncoderLayer(cfg, ffn_dropout)
                                    for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.feats_size, eps=LN_EPS)

    def forward(self, x, c, mask, segments, generator, seed_generator, dtype,
                mesh=None, row_generator=None):
        cfg = self.cfg
        c = c.detach()  # the selection passes no gradient
        if sp_size(mesh) > 1:
            # every sp rank selects over the global N
            c = gather(c, mesh, "sp", "instance logits")
            mask_all = gather(mask, mesh, "sp", "row mask")
        else:
            mask_all = mask
        n = c.shape[0]
        if segments > 1:
            n_seg = n // segments
            # multiclass passes k_top itself: its slot count is
            # min(k_top·C, n_seg), as in the JAX model
            prep = packed_selection_prepare(
                c.reshape(segments, n_seg, -1) if cfg.multiclass
                else c[:, 0].reshape(segments, n_seg),
                mask_all.reshape(segments, n_seg),
                cfg.k_top if cfg.multiclass else min(cfg.k_top, n_seg),
                cfg.multiclass,
            )
        elif cfg.multiclass:
            prep = multiclass_selection_prepare(c, mask_all, cfg.k_top)
        else:
            prep = binary_selection_prepare(c[:, 0], mask_all,
                                            min(cfg.k_top, n))
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            args = (prep, mask, segments, generator, seed_generator, dtype,
                    mesh, row_generator)
            if remat:
                x = _remat(layer, x, (generator, seed_generator,
                                      row_generator), *args)
            else:
                x = layer(x, *args)
        return layer_norm(x, self.norm, dtype)


class BClassifier(nn.Module):
    """Encoder → masked mean pool (f32) → linear bag head."""

    def __init__(self, cfg: SnuffyModelConfig, ffn_dropout: float):
        super().__init__()
        self.encoder = Encoder(cfg, ffn_dropout)
        self.linear = nn.Linear(cfg.feats_size, cfg.num_classes)

    def forward(self, x, c, mask, segments, generator, seed_generator,
                dtype, mesh=None, row_generator=None):
        enc = self.encoder(x, c, mask, segments, generator, seed_generator,
                           dtype, mesh, row_generator)
        if sp_size(mesh) > 1:
            # the masked sums and the count over every rank's rows
            sums = torch.cat([
                (enc * mask[:, None].to(enc.dtype)).sum(
                    dim=0, dtype=torch.float32),
                mask.sum(dtype=torch.float32)[None]])
            sums = reduce_from(sums, mesh, "sp", "pooled sums")
            return self.linear(sums[:-1] / sums[-1].clamp_min(1.0))
        k = segments
        enc_b = enc.reshape(k, enc.shape[0] // k, -1)
        mask_b = mask.reshape(k, -1)
        denom = mask_b.sum(dim=1).clamp_min(1).float()
        pooled = (enc_b * mask_b[:, :, None].to(enc.dtype)).sum(
            dim=1, dtype=torch.float32) / denom[:, None]
        bag_logits = self.linear(pooled)                  # (k, C)
        return bag_logits if segments > 1 else bag_logits[0]


class MILNet(nn.Module):
    """i_classifier + b_classifier.

    forward(feats (N, d), mask (N,) bool, segments=1, generator=None,
            seed_generator=None) →
        (ins_logits (N, C) f32, bag_logits (C,) f32 — (k, C) when packed)
    `generator` lives on the feats' device and draws the random share and,
    in training mode, the encoder dropout; `seed_generator`, a CPU
    generator, draws the attention-dropout seeds in training mode. None
    takes torch's default generator. `ffn_dropout` overrides the FFN's
    inner dropout rate (default: 0.1 multiclass, else encoder_dropout).

    With a `mesh` of sp > 1, feats and mask are this rank's N/sp rows of
    the bag and so are the instance logits; with tp > 1 the module holds
    this rank's blocks of the tp-sharded parameters (`shard_state` and
    `gather_state` of `parallel/sharded_train.py` convert whole state
    dicts). The weights are drawn whole from `seed` either way.
    """

    def __init__(self, cfg: SnuffyModelConfig, seed: int = 0,
                 ffn_dropout: Optional[float] = None, mesh=None):
        super().__init__()
        if ffn_dropout is None:
            ffn_dropout = 0.1 if cfg.multiclass else cfg.encoder_dropout
        self.cfg = cfg
        self.mesh = mesh
        self.i_classifier = FCLayer(cfg.feats_size, cfg.num_classes)
        self.b_classifier = BClassifier(cfg, ffn_dropout)
        gen = torch.Generator().manual_seed(seed)
        for name, mod in self.named_modules():
            if isinstance(mod, nn.Linear):
                init = (cfg.weight_init_i if name.startswith("i_classifier")
                        else cfg.weight_init_b)
                init_linear(mod, init, gen)
        if tp_size(mesh) > 1:
            from snuffy_tpu_torch.parallel.sharded_train import shard_module

            shard_module(self, mesh)

    def forward(
        self,
        feats: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        segments: int = 1,
        generator: Optional[torch.Generator] = None,
        seed_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        mesh = self.mesh
        if segments > 1 and sp_size(mesh) > 1:
            raise NotImplementedError(
                "packed bags (segments > 1) and sequence parallelism "
                "shard the same row axis — use one or the other")
        if segments > 1 and tp_size(mesh) > 1:
            raise NotImplementedError(
                "packed bags do not compose with tensor parallelism yet")
        if mask is None:
            mask = torch.ones(feats.shape[0], dtype=torch.bool,
                              device=feats.device)
        # the kernel takes a contiguous bool row mask
        mask = mask.to(device=feats.device, dtype=torch.bool).contiguous()
        dtype = compute_dtype_of(self.cfg)
        row_generator = None
        if sp_size(mesh) > 1 and self.training:
            # a shared draw, then the sp index: the row-local masks differ
            # between the ranks, the shared generators stay in step
            row_generator = torch.Generator(feats.device).manual_seed(
                int(torch.randint(0, 2**62, (), generator=seed_generator))
                + mesh.sp_rank * 7919)
        feats = feats.float() * mask[:, None].float()
        ins_logits = self.i_classifier(feats)
        bag_logits = self.b_classifier(feats.to(dtype), ins_logits, mask,
                                       segments, generator, seed_generator,
                                       dtype, mesh, row_generator)
        return ins_logits, bag_logits


def build_milnet(cfg: SnuffyModelConfig, seed: int = 0,
                 device: Optional[torch.device] = None,
                 ffn_dropout: Optional[float] = None, mesh=None) -> MILNet:
    """Seeded MILNet in eval mode on `device`: the card unless the caller
    passes another; with a mesh, this rank's part of it."""
    return MILNet(cfg, seed, ffn_dropout, mesh).to(
        device or torch.device("cuda")).eval()
