"""Profile the MIL training step of the port on a CUDA GPU.

    python -m snuffy_tpu_torch.tools.profile_train [--out FILE]

Builds the MILNet at the training widths chip_smoke.py uses (d=384,
4 heads, Λ=512, ρ=0.5, depth 2, gelu, bf16, attention dropout 0.1;
AdamW lr 2e-2, weight decay 5e-2, soft_average; seeded weights), warms
it on bags of 10240 rows (10000 valid), then prints for one serial step
(one bag) and one packed step (8 bags):

  * the wall time (median of CUDA-event timings) and the device-busy time
    (sum of kernel and copy durations in a torch.profiler trace, per
    step), with the idle share 1 − busy/wall;
  * device time by group: the sparse-attention forward (K1) and backward
    (K2) kernels by pass (split reduces included), cuBLAS GEMMs, the
    optimizer's kernels, the sort of the selection, and the rest; it
    raises if a pass the step launches recorded no device time.

`--out` also writes the full per-op tables to FILE. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import sys

import torch

from snuffy_tpu_torch.ops.fused_attention import launched_passes
from snuffy_tpu_torch.ops.kernels import BWD, FWD
from snuffy_tpu_torch.tools.profile_serve import report, table, wall_ms
from snuffy_tpu_torch.utils.profiling import device_profile

ROWS, VALID, PACKED = 10240, 10000, 8

# Kernel-name fragments of each group, first match wins: the passes of
# the sparse-attention forward (K1) and backward (K2) kernels, then the
# rest of the step.
GROUPS = tuple((f"{label} {name}", (name,))
               for label, kernel in (("K1", FWD), ("K2", BWD))
               for name in kernel.passes) + (
    ("GEMMs (cuBLAS)", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("selection sort", ("sort", "radix")),
)


def grouped(kernels):
    """[(group, ms)] over the device kernels, the rest last."""
    sums = {name: 0.0 for name, _ in GROUPS}
    rest = 0.0
    for key, ms in kernels:
        low = key.lower()
        for name, frags in GROUPS:
            if any(f.lower() in low for f in frags):
                sums[name] += ms
                break
        else:
            rest += ms
    return list(sums.items()) + [("the rest (elementwise, norms, copies)",
                                  rest)]


def check_passes(groups, segments, cfg):
    """Raise unless every pass that a step of `segments` bags launches
    (split reduces only where N is split) recorded device time, so that a
    renamed kernel cannot report 0 ms."""
    times = dict(groups)
    folded = cfg.num_heads * segments
    for label, kernel in (("K1", FWD), ("K2", BWD)):
        for name in launched_passes(kernel, ROWS, cfg.big_lambda, folded):
            if times[f"{label} {name}"] <= 0:
                raise RuntimeError(f"the profiler found no device time for "
                                   f"{label}'s {name} kernels")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="write the full per-op tables to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA GPU", file=sys.stderr)
        return 2

    from snuffy_tpu_torch.configs import (
        MILTrainConfig,
        OptimizerConfig,
        SnuffyModelConfig,
    )
    from snuffy_tpu_torch.train.trainer import SnuffyTrainer

    dev = torch.device("cuda", 0)
    cfg = SnuffyModelConfig(
        feats_size=384, num_classes=1, num_heads=4, big_lambda=512,
        random_patch_share=0.5, activation="gelu", depth=2,
        compute_dtype="bfloat16",
    )
    trainer = SnuffyTrainer(MILTrainConfig(
        model=cfg, soft_average=True,
        optim=OptimizerConfig(optimizer="adamw", lr=2e-2, weight_decay=5e-2),
    ), dev)
    trainer.model.train()
    trainer.set_lr(2e-2)
    gen = torch.Generator(dev).manual_seed(0)
    seeds = torch.Generator().manual_seed(0)
    feats = torch.randn((PACKED, ROWS, cfg.feats_size), generator=gen,
                        device=dev)
    masks = (torch.arange(ROWS, device=dev) < VALID).repeat(PACKED, 1)
    labels = (torch.arange(PACKED, device=dev) % 2).float()[:, None]
    bag_w = torch.ones(PACKED, device=dev)

    def serial():
        trainer.train_step(feats[0], masks[0], labels[0], gen, seeds)

    def packed():
        trainer.packed_train_step(feats, masks, labels, bag_w, gen, seeds)

    lines, tables, steps = [], [], []
    for label, fn, segments in (("serial step, 1 bag", serial, 1),
                                (f"packed step, {PACKED} bags", packed,
                                 PACKED)):
        wall = wall_ms(fn)
        busy, ops, kernels = device_profile(fn)
        lines += report(label, wall, busy, ops)
        groups = grouped(kernels)
        for name, ms in groups:
            lines.append(f"  {100 * ms / busy:6.2f} %  {ms:9.4f} ms  {name}")
        tables += table(label, ops, kernels)
        steps.append((groups, segments))
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines + tables) + "\n")
    for groups, segments in steps:
        check_passes(groups, segments, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
