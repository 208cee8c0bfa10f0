"""The benchmark's own tests (CPU; those marked `cuda` need a card).

    python -m pytest benchmark/tests -q
    python -m pytest benchmark/tests -q -m cuda     # on a machine with a card
"""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA GPU")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def tiny_serve_cell(name="vits16.serve"):
    """The cell with its widths cut to what a CPU test holds."""
    from benchmark import run

    cell = run.Cell(name)
    cell.config = copy.deepcopy(cell.config)
    tiles = dict(tiles_min=8, tiles_max=24)
    if cell.config["embedder"]["arch"].startswith("vit"):
        cell.config["embedder"].update(dim=32, depth=1, heads=2)
        cell.config["milnet"].update(feats_size=32, num_heads=2)
        tile = 224
    else:   # ResNet-18's 512 wide embeddings, bf16 convs slow on a CPU
        tile = 64
        tiles = dict(tiles_min=6, tiles_max=14)
    cell.config["milnet"]["big_lambda"] = 16
    cell.traffic = dict(cell.traffic, **tiles, sizes_per_cycle=4,
                        pool_tiles=80, tile_size=tile, embed_batch=16,
                        trace_tiles=50, check_requests=3)
    cell.config["embedder"]["img_size"] = tile
    return cell


@pytest.fixture
def serve_cell():
    return tiny_serve_cell()

