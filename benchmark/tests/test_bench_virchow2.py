"""The `virchow2.serve` cell at a size the CPU holds: a sound run is
correct, and each piece of Virchow2 left out or done wrong underneath
the timed path fails the cell's own limits (dim 160, 2 heads of 80, depth
2, patch 14 at 56², 4 registers; a MILNet of d 320). Its frozen counts
against hand counts at the published size."""

import copy

import pytest
import torch

from benchmark import roofline, run
from benchmark.arch import virchow2

BIG = 2**31 + 4242


def tiny_virchow2_cell():
    cell = run.Cell("virchow2.serve")
    cell.config = copy.deepcopy(cell.config)
    cell.config["embedder"].update(dim=160, depth=2, heads=2, img_size=56)
    cell.config["milnet"].update(feats_size=320, num_heads=2, big_lambda=16)
    cell.traffic = dict(cell.traffic, tiles_min=8, tiles_max=24,
                        sizes_per_cycle=4, pool_tiles=80, tile_size=56,
                        embed_batch=16, trace_tiles=50, check_requests=2)
    return cell


def test_sound_virchow2_run_is_correct():
    res = run.execute(tiny_virchow2_cell(), BIG, 5.0, False, "cpu")
    assert res["correct"], res["checks"]


def swapped_gate(self, x, dtype, run=None):
    """The packed SwiGLU with its halves swapped: SiLU(b) ⊙ a."""
    from snuffy_tpu_torch.models.layers import linear

    a, b = linear(x, self.fc1, dtype).chunk(2, dim=-1)
    return linear(torch.nn.functional.silu(b) * a, self.fc2, dtype)


def registers_in_the_mean(y, prefix):
    return torch.cat([y[:, 0], y[:, 1:].mean(dim=1)], dim=-1)


def class_token_alone(y, prefix):
    return torch.cat([y[:, 0], torch.zeros_like(y[:, 0])], dim=-1)


def without_gamma(monkeypatch):
    """The first block's two branches added unscaled (γ₁, γ₂ dropped)."""
    real = virchow2.backbone

    def backbone(e):
        model, dim = real(e)
        for ls in (model.blocks[0].ls1, model.blocks[0].ls2):
            monkeypatch.setattr(ls, "forward", lambda x: x)
        return model, dim

    monkeypatch.setattr(virchow2, "backbone", backbone)


@pytest.mark.parametrize("fault", ["swapped_gate", "registers_in_the_mean",
                                   "gamma_dropped", "class_token_alone"])
def test_planted_fault_fails_the_check(fault, monkeypatch):
    from snuffy_tpu_torch.models import vit

    if fault == "swapped_gate":
        monkeypatch.setattr(vit.Mlp, "forward", swapped_gate)
    elif fault == "gamma_dropped":
        without_gamma(monkeypatch)
    else:
        monkeypatch.setattr(vit, "class_plus_mean", {
            "registers_in_the_mean": registers_in_the_mean,
            "class_token_alone": class_token_alone}[fault])
    res = run.execute(tiny_virchow2_cell(), BIG, 5.0, False, "cpu")
    assert not res["correct"], res["checks"]


def test_flops_and_k5_bound_at_the_published_size():
    e = run.Cell("virchow2.serve").config["embedder"]
    d, n = 1280, 261
    block = 2 * n * (3 * d * d + d * d + d * 6832 + 3416 * d) + 4 * n * n * d
    patch = 2 * 256 * 3 * 14 * 14 * d
    assert virchow2.flops_per_tile(e) == 32 * block + patch
    assert virchow2.flops_per_tile(e) == pytest.approx(340.13e9, rel=1e-4)
    # K5 at dk 80 over 16 heads a tile, not the 128 columns of its body
    assert virchow2.kernel_bounds(e, [256, 75]) == {
        "dense_attention": pytest.approx(32 * (
            roofline.dense_bound(4096, 261, 80)
            + roofline.dense_bound(1200, 261, 80)))}
