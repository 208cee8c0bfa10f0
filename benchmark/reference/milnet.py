"""Plain float32 Snuffy MILNet (arXiv:2408.08258), its forward in
evaluation (no dropout).

A bag is N rows of embeddings, the first n valid, padded with zero rows
(the port pads to its buckets); with K > 1 segments, K such bags of one
length lie on the row axis. Per bag:

  ins = feats · W_iᵀ + b_i                   the instance logits (C = 1)
  per encoder layer, Λ slots: the top ⌈Λ(1−ρ)⌉ valid rows by instance
  logit (ties to the lower row), then ⌊Λρ⌋ drawn uniformly without
  replacement from the other valid rows, as Gumbel-top-k: exponential
  noise e over the padded rows (one `exponential_` of the bag's shape
  from the request's device generator, per layer), −log e the keys;
  keys  = W_k · x[slots] (pre-norm rows), q, v = W_q, W_v · LN(x);
  p[i, j] = softmax over the bag's slots j of q_i·k_j/√dk (dead slots
  −1e30); out[j] = Σ_valid i p[i, j] v_i; the slots' rows become
  x[slots] + W_o·out; then
  x + FFN(LN(x)) with the configured ReLU or exact GELU; the encoder's
  final LayerNorm, the masked mean over the bag's rows, the bag head.

`q` reads every product's operands and the stored residual stream (the
encoder's input, each sum, its output) in a precision: identity for the
reference, a lower one for a control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.common import dense, identity, layer_norm

NEG = -1e30
ACTIVATIONS = {"relu": F.relu, "gelu": F.gelu}


def k_top(m: dict) -> int:
    return math.ceil(m["big_lambda"] * (1.0 - m["random_patch_share"]))


def k_rand(m: dict) -> int:
    return int(m["big_lambda"] * m["random_patch_share"])


def param_spec(m: dict):
    d, c, hidden = m["feats_size"], m["num_classes"], (
        m["feats_size"] * m["mlp_multiplier"])
    spec = [("i_classifier.fc.0.weight", (c, d), "weight"),
            ("i_classifier.fc.0.bias", (c,), "bias")]
    for i in range(m["depth"]):
        pre = f"b_classifier.encoder.layers.{i}."
        for j in range(4):
            spec += [(pre + f"self_attn.linears.{j}.weight", (d, d), "weight"),
                     (pre + f"self_attn.linears.{j}.bias", (d,), "bias")]
        spec += [(pre + "feed_forward.w_1.weight", (hidden, d), "weight"),
                 (pre + "feed_forward.w_1.bias", (hidden,), "bias"),
                 (pre + "feed_forward.w_2.weight", (d, hidden), "weight"),
                 (pre + "feed_forward.w_2.bias", (d,), "bias")]
        for j in range(2):
            spec += [(pre + f"sublayer.{j}.norm.weight", (d,), "ln_weight"),
                     (pre + f"sublayer.{j}.norm.bias", (d,), "bias")]
    spec += [("b_classifier.encoder.norm.weight", (d,), "ln_weight"),
             ("b_classifier.encoder.norm.bias", (d,), "bias"),
             ("b_classifier.linear.weight", (c, d), "weight"),
             ("b_classifier.linear.bias", (c,), "bias")]
    return spec


def _top(keys: torch.Tensor, k: int):
    """(indices, valid) of the k largest along the last axis, ties to the
    lower index; -inf entries come back invalid."""
    vals, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
    return idx[..., :k], torch.isfinite(vals[..., :k])


def _attention(x_norm, sel_rows, slots_valid, mask, K, w, pre, heads, q):
    """(K·S, d): the bags' slots' attention outputs through W_o."""
    d = x_norm.shape[1]
    dk = d // heads
    n, s = x_norm.shape[0] // K, sel_rows.shape[0] // K

    def split(t, rows):   # (K·rows, d) → (h, K, rows, dk)
        return t.reshape(K, rows, heads, dk).permute(2, 0, 1, 3)

    lin = [(w[pre + f"self_attn.linears.{j}.weight"],
            w[pre + f"self_attn.linears.{j}.bias"]) for j in range(4)]
    qh = split(dense(x_norm, *lin[0], q), n)
    kh = split(dense(sel_rows, *lin[1], q), s)
    vh = split(dense(x_norm, *lin[2], q), n)
    scores = torch.einsum("hknd,hksd->hkns", q(qh), q(kh)) / math.sqrt(dk)
    scores = scores.masked_fill(~slots_valid.reshape(K, s)[None, :, None, :],
                                NEG)
    p = torch.softmax(scores, dim=-1) * mask.reshape(K, n)[None, :, :, None]
    out = torch.einsum("hkns,hknd->hksd", q(p), q(vh))
    out = out.permute(1, 2, 0, 3).reshape(K * s, d)
    return dense(out, *lin[3], q)


def forward(w: dict, feats: torch.Tensor, mask: torch.Tensor, m: dict,
            segments: int, generator: torch.Generator, q=identity):
    """feats (K·N, d) float32, mask (K·N,) bool → (instance logits (K·N, C),
    bag logits (K, C), the encoder's output (K·N, d)). `generator` (on the
    feats' device) draws the random share."""
    if m.get("encoder_dropout", 0.0):
        raise NotImplementedError("encoder dropout above 0")
    K, d = segments, feats.shape[1]
    n = feats.shape[0] // K
    x = feats.float() * mask[:, None].float()
    ins = dense(x, w["i_classifier.fc.0.weight"], w["i_classifier.fc.0.bias"])
    c = ins[:, 0].detach()
    shape = (K, n) if K > 1 else (n,)
    valid = mask.reshape(shape)
    top_idx, top_valid = _top(
        torch.where(valid, c.reshape(shape), torch.tensor(
            float("-inf"), device=c.device)), min(k_top(m), n))
    remainder = valid.scatter(-1, top_idx, False)
    offsets = (torch.arange(K, device=x.device) * n)[:, None]
    x = q(x)            # the residual stream, stored in the compute precision
    for i in range(m["depth"]):
        pre = f"b_classifier.encoder.layers.{i}."
        idx, ok = top_idx, top_valid
        if k_rand(m):
            e = torch.empty(shape, dtype=torch.float32, device=x.device)
            e = e.exponential_(generator=generator)
            g = -torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny))
            r_idx, r_ok = _top(torch.where(remainder, g, torch.tensor(
                float("-inf"), device=x.device)), k_rand(m))
            idx = torch.cat([idx, r_idx], dim=-1)
            ok = torch.cat([ok, r_ok], dim=-1)
        if K > 1:
            idx = idx + offsets
        idx, ok = idx.reshape(-1), ok.reshape(-1)
        sel_rows = x.index_select(0, idx)
        x_norm = layer_norm(x, w[pre + "sublayer.0.norm.weight"],
                            w[pre + "sublayer.0.norm.bias"])
        new = q(sel_rows + _attention(x_norm, sel_rows, ok, mask, K, w, pre,
                                      m["num_heads"], q))
        # dead slots write into one extra row that is dropped
        target = torch.where(ok, idx, torch.full_like(idx, x.shape[0]))
        x = torch.cat([x, x.new_zeros(1, d)]).index_copy(0, target, new)
        x = x[:-1]
        h = layer_norm(x, w[pre + "sublayer.1.norm.weight"],
                       w[pre + "sublayer.1.norm.bias"])
        h = ACTIVATIONS[m["activation"]](dense(
            h, w[pre + "feed_forward.w_1.weight"],
            w[pre + "feed_forward.w_1.bias"], q))
        x = q(x + dense(h, w[pre + "feed_forward.w_2.weight"],
                        w[pre + "feed_forward.w_2.bias"], q))
    x = q(layer_norm(x, w["b_classifier.encoder.norm.weight"],
                     w["b_classifier.encoder.norm.bias"]))
    mk = mask.reshape(K, n, 1).float()
    pooled = (x.reshape(K, n, d) * mk).sum(dim=1) / mk.sum(dim=1).clamp_min(1)
    bag = dense(pooled, w["b_classifier.linear.weight"],
                w["b_classifier.linear.bias"])
    return ins, bag, x

