"""MAE-with-adapter pretraining trainer in PyTorch.

The port of `snuffy_tpu/ssl/mae_trainer.py` (the reference MAE-adapter
stage, reference mae_adapter/main_pretrain_adapter.py):

  * the masked-patch reconstruction loss of `models/mae.py`
    (`forward_pretrain`);
  * the adapter freeze: only the adapters train, in the encoder and the
    decoder, and with `train_decoder_linears` also `decoder_embed` and
    `decoder_pred` (`mae_trainable_mask`); the rest has requires_grad off;
  * AdamW with betas (0.9, 0.95) and eps 1e-8, weight decay only where
    timm's rule allows it (`no_decay_mask`: not on 1-D parameters or
    biases; with the freeze off, `cls_token` and `mask_token`, which are
    3-D, decay);
  * bf16 images: a batch is rounded to bf16 before the patch embedding,
    whatever the model's compute dtype (the JAX trainer's `use_bf16`,
    which the root CLI never turns off); with `augment`, the crop runs in
    f32 on the device and the result is rounded after the normalisation.

The optimizer is written out on tensors as the JAX step computes it:
`optax.masked(chain(scale_by_adam(b1, b2), masked(add_decayed_weights(wd),
decay), scale(-1)), trainable)` gives u = −(adam + wd·p) and the step
p ← p + lr·u, for trainable parameters only; Adam's moments are held for
those, with one shared step count.

A step draws, from one `torch.Generator` on the device, the augment's
crops and flips, then the masking noise, then the adapters' dropout.

Under data parallelism (`mesh`, `parallel/mesh.py`), each rank steps on
its own images: the gradients are averaged over the ranks before the
update (every rank holds the same batch size and mask ratio, so the mean
of the ranks' losses is the global loss), and `eval_loss` is the ranks'
mean.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from snuffy_tpu_torch.models.mae import MaskedAutoencoderViT
from snuffy_tpu_torch.parallel.mesh import Mesh
from snuffy_tpu_torch.parallel.ssl_sharding import allreduce_gradients
from snuffy_tpu_torch.ssl.adam import adam_directions, init_adam_state
from snuffy_tpu_torch.ssl.augment import Draws, mae_train_augment
from snuffy_tpu_torch.ssl.dino import StageClock
from snuffy_tpu_torch.utils.metrics_sync import mesh_metric_mean

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8
CROP_SCALE = (0.2, 1.0)


@dataclasses.dataclass
class MAEState:
    model: MaskedAutoencoderViT
    opt_state: dict                # ssl.adam.init_adam_state's layout
    step: int = 0


def mae_trainable_mask(model: torch.nn.Module, freeze_non_adapter: bool,
                       train_decoder_linears: bool) -> Dict[str, bool]:
    """{parameter name: trains}: the adapters always (the keys a published
    checkpoint lacks), `decoder_embed`/`decoder_pred` with
    `train_decoder_linears`, everything without the freeze (reference
    main_pretrain_adapter.py:209-288)."""
    def one(name: str) -> bool:
        if not freeze_non_adapter or "adaptmlp" in name:
            return True
        return train_decoder_linears and name.split(".")[0] in (
            "decoder_embed", "decoder_pred")

    return {n: one(n) for n, _ in model.named_parameters()}


def no_decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """{parameter name: takes weight decay}: timm's add_weight_decay, no
    decay for 1-D parameters and biases (reference
    timm_modified/optim/optim_factory.py:26-38)."""
    return {n: not (p.ndim <= 1 or n.split(".")[-1] == "bias")
            for n, p in model.named_parameters()}


def effective_lr(blr: float, batch_size: int, accum: int = 1,
                 n_devices: int = 1) -> float:
    """The linear scaling rule, blr · eff_batch / 256 (reference
    main_pretrain_adapter.py:296-302)."""
    eff_batch = batch_size * accum * n_devices
    return blr * eff_batch / 256.0


def host_check_finite(loss: float) -> None:
    """The reference stops on a non-finite loss (reference
    main_pretrain_adapter.py:404-406)."""
    if not np.isfinite(loss):
        raise FloatingPointError(f"Loss is {loss}, stopping training")


class MAETrainer:
    """The JAX `MAETrainer`'s arguments, on a port `MaskedAutoencoderViT`
    built `with_decoder` (the device is the model's)."""

    def __init__(
        self,
        model: MaskedAutoencoderViT,
        mask_ratio: float = 0.75,
        weight_decay: float = 0.05,
        freeze_non_adapter: bool = True,
        train_decoder_linears: bool = False,
        augment: bool = False,
        img_pack: int = 1,
        mesh: Optional[Mesh] = None,
    ):
        self.model = model
        self.mesh = mesh
        self.mask_ratio = mask_ratio
        self.weight_decay = weight_decay
        self.freeze_non_adapter = freeze_non_adapter
        self.train_decoder_linears = train_decoder_linears
        # the reference applies transform_train to the validation split
        # too (main_pretrain_adapter.py:161); eval_loss does the same
        self.augment = augment
        self.img_pack = img_pack
        self.img_size = model.grid * model.patch_size

    def init_state(self) -> MAEState:
        """requires_grad on the trainable parameters alone; Adam's state
        at zero for them."""
        trains = mae_trainable_mask(self.model, self.freeze_non_adapter,
                                    self.train_decoder_linears)
        for name, p in self.model.named_parameters():
            p.requires_grad_(trains[name])
        return MAEState(self.model,
                        init_adam_state(dict(self.trainable_params())))

    def trainable_params(self) -> List[Tuple[str, torch.nn.Parameter]]:
        return [(n, p) for n, p in self.model.named_parameters()
                if p.requires_grad]

    def prep(self, images: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Draws] = None) -> torch.Tensor:
        """A batch → the model's bf16 input. Integer pixels are scaled to
        [0, 1] (in bf16, as the JAX `_to_model_dtype`); floats are taken as
        [0, 1]. With `augment`, the crop, flip and normalisation run in f32
        from the raw decode size to the model's (`draws` replaces the
        draws from `generator`), then the cast."""
        if not self.augment:
            x = images.to(torch.bfloat16)
            return x if images.is_floating_point() else x / 255.0
        x = images.float()
        if not images.is_floating_point():
            x = x / 255.0
        x = mae_train_augment(x, generator, self.img_size, CROP_SCALE, draws)
        return x.to(torch.bfloat16)

    def step(self, state: MAEState, images: torch.Tensor, lr: float,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             timings: Optional[Dict[str, float]] = None
             ) -> Tuple[MAEState, torch.Tensor]:
        """One training step in place: the augment, the forward with the
        adapters' dropout, the backward and the masked AdamW update →
        (state, loss). `noise` (B, N) replaces the masking draw from
        `generator`. With a `timings` dict, adds the seconds of augment,
        forward, backward and update to it (the device synchronised
        between them)."""
        clock = StageClock(timings, images.device)
        model = state.model
        model.train()
        imgs = self.prep(images, generator)
        clock.mark("augment_s")
        loss, _, _ = model.forward_pretrain(imgs, self.mask_ratio, noise,
                                            generator, self.img_pack)
        clock.mark("forward_s")
        params = self.trainable_params()
        grads = allreduce_gradients(
            list(torch.autograd.grad(loss, [p for _, p in params])),
            self.mesh)
        clock.mark("backward_s")
        with torch.no_grad():
            self._update(state, params, grads, lr)
            state.step += 1
        clock.mark("update_s")
        return state, loss.detach()

    def _update(self, state, params, grads, lr) -> None:
        """p ← p − lr·(adam + wd·p), wd where `no_decay_mask` allows it."""
        names = [n for n, _ in params]
        ps = [p for _, p in params]
        dirs = adam_directions(state.opt_state, names, grads, ADAM_B1,
                               ADAM_B2, ADAM_EPS)
        decays = no_decay_mask(state.model)
        decay = [i for i, n in enumerate(names) if decays[n]]
        if decay and self.weight_decay:
            torch._foreach_add_(
                [dirs[i] for i in decay],
                torch._foreach_mul([ps[i] for i in decay],
                                   float(np.float32(self.weight_decay))))
        torch._foreach_add_(ps, dirs, alpha=-float(np.float32(lr)))

    def eval_loss(self, state: MAEState, images: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> float:
        """The loss in eval mode (no dropout, no packing), the masking and,
        with `augment`, the crops still random, as the reference
        validates; the ranks' mean under a mesh."""
        model = state.model
        model.eval()
        with torch.no_grad():
            imgs = self.prep(images, generator)
            loss, _, _ = model.forward_pretrain(imgs, self.mask_ratio, noise,
                                                generator)
        return float(mesh_metric_mean(loss, self.mesh))
