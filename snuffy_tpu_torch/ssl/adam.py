"""Adam's direction on tensor lists, as optax's `scale_by_adam` computes
it under `optax.masked`: one step count shared by every masked-in
parameter, moments for those alone.

The SSL trainers (`ssl/dino.py`, `ssl/mae_trainer.py`) write their
optimizers out on tensors rather than through `torch.optim`: their JAX
steps fold weight decay, masks and cancelled layers in ways
`torch.optim.AdamW` does not (see each trainer's docstring).
"""

from __future__ import annotations

from typing import Dict, List

import torch


def init_adam_state(params: Dict[str, torch.Tensor]) -> dict:
    """{'count': int32 0-d, 'exp_avg': {name: μ}, 'exp_avg_sq': {name: ν}},
    zeros, one buffer pair a parameter of `params`."""
    device = next(iter(params.values())).device
    return {"count": torch.zeros((), dtype=torch.int32, device=device),
            "exp_avg": {n: torch.zeros_like(p) for n, p in params.items()},
            "exp_avg_sq": {n: torch.zeros_like(p) for n, p in params.items()}}


def adam_directions(opt: dict, names: List[str], grads: List[torch.Tensor],
                    b1: float, b2: float, eps: float = 1e-8
                    ) -> List[torch.Tensor]:
    """Move `opt`'s count and the moments of `names` by `grads`, in place
    (`torch._foreach_*`: a few launches a step, not a few a tensor), and
    return each parameter's bias-corrected μ̂ / (√ν̂ + eps)."""
    opt["count"] += 1
    count = opt["count"].float()
    c1 = 1 - torch.tensor(b1, device=count.device) ** count
    c2 = 1 - torch.tensor(b2, device=count.device) ** count
    mus = [opt["exp_avg"][n] for n in names]
    nus = [opt["exp_avg_sq"][n] for n in names]
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, grads, alpha=1 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
    den = torch._foreach_div(nus, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    return torch._foreach_div(torch._foreach_div(mus, c1), den)
