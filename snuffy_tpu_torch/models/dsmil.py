"""DSMIL dual-stream MIL baseline in PyTorch (reference dsmil.py:28-106).

The port of `snuffy_tpu/models/dsmil.py`. `FCLayer` is the instance
classifier over precomputed features; `BClassifier` is the dual-stream
attention baseline (the critical instance's query and a Conv1d bag head).
Module names are the reference's (`i_classifier.fc.0`,
`b_classifier.q.{0,2}` or `b_classifier.q` when linear,
`b_classifier.v.1`, `b_classifier.fcc`), so a reference `.pth` loads with
`strict=True`.

Kept from the JAX module: padded rows are excluded from the critical
instance's argmax and from the attention softmax by −inf (not Snuffy's
−1e30: a bag with no valid row gives NaN attention, as in JAX); the
argmax tie goes to the lowest row; the softmax runs over the instance axis
(each class column sums to one); the query MLP is shared by every row and
the critical instances. Everything runs in f32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = float("-inf")


class FCLayer(nn.Module):
    """feats → (feats, logits) (reference dsmil.py:28-36)."""

    def __init__(self, in_size: int, out_size: int = 1):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(in_size, out_size))

    def forward(self, feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return feats, self.fc(feats)


class BClassifier(nn.Module):
    """Dual-stream bag classifier (reference dsmil.py:53-92).

    q: Linear-ReLU-Linear-Tanh to 128-d queries (one Linear when not
    `nonlinear`); v: identity, or Dropout-Linear-ReLU with `passing_v`;
    attention = the instance-axis softmax of Q·q_maxᵀ/√128; the bag head is
    a Conv1d(C → C, kernel = V) over the (C, V) bag matrix B = Aᵀ·V.
    """

    def __init__(self, input_size: int, output_class: int,
                 dropout_v: float = 0.0, nonlinear: bool = True,
                 passing_v: bool = False, q_dim: int = 128):
        super().__init__()
        self.q_dim = q_dim
        if nonlinear:
            self.q = nn.Sequential(nn.Linear(input_size, q_dim), nn.ReLU(),
                                   nn.Linear(q_dim, q_dim), nn.Tanh())
        else:
            self.q = nn.Linear(input_size, q_dim)
        if passing_v:
            self.v = nn.Sequential(nn.Dropout(dropout_v),
                                   nn.Linear(input_size, input_size),
                                   nn.ReLU())
        else:
            self.v = nn.Identity()
        self.fcc = nn.Conv1d(output_class, output_class,
                             kernel_size=input_size)

    def forward(self, feats: torch.Tensor, c: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
        """feats (N, K), instance logits c (N, C), mask (N,) bool →
        (bag logits (C,), attention A (N, C), bag matrix B (C, V))."""
        n = feats.shape[0]
        if mask is None:
            mask = torch.ones(n, dtype=torch.bool, device=feats.device)
        mask = mask.to(device=feats.device, dtype=torch.bool)
        q = self.q(feats)
        v = self.v(feats)
        # critical instance per class: the first row of the largest masked
        # logit (reference dsmil.py:78-81: descending sort, first row)
        guarded = torch.where(mask[:, None], c, torch.full_like(c, NEG_INF))
        crit = torch.argmax(guarded, dim=0)                  # (C,)
        q_max = self.q(feats[crit])                          # shared weights
        scores = q @ q_max.T / math.sqrt(self.q_dim)         # (N, C)
        scores = torch.where(mask[:, None], scores,
                             torch.full_like(scores, NEG_INF))
        a = torch.softmax(scores, dim=0)                     # column softmax
        b = a.T @ v                                          # (C, V)
        bag = F.conv1d(b[None], self.fcc.weight, self.fcc.bias)  # (1, C, 1)
        return bag.reshape(-1), a, b


class MILNet(nn.Module):
    """i_classifier + dual-stream b_classifier (reference dsmil.py:95-106).
    forward(feats (N, K), mask (N,) bool or None) → (instance logits
    (N, C), bag logits (C,), attention (N, C))."""

    def __init__(self, feats_size: int, num_classes: int = 1,
                 dropout_v: float = 0.0, nonlinear: bool = True,
                 passing_v: bool = False):
        super().__init__()
        self.i_classifier = FCLayer(feats_size, num_classes)
        self.b_classifier = BClassifier(feats_size, num_classes, dropout_v,
                                        nonlinear, passing_v)

    def forward(self, feats: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
        feats, classes = self.i_classifier(feats)
        bag_logits, a, _ = self.b_classifier(feats, classes, mask)
        return classes, bag_logits, a


def build_dsmil(feats_size: int, num_classes: int = 1, seed: int = 0,
                device: Optional[torch.device] = None, **kw) -> MILNet:
    """A seeded DSMIL MILNet in eval mode on `device`: the card unless the
    caller passes another."""
    torch.manual_seed(seed)
    return MILNet(feats_size, num_classes, **kw).to(
        device or torch.device("cuda")).eval()
