"""The controls at a size the CPU holds: the reference in fp8 in the
program's place fails the cell's limits where the program passes them
(`benchmark/control.py` reads the same at the cells' own size on the
card)."""

import pytest

from benchmark import control

SEEDS = (2**31 + 5, 2**31 + 6, 2**31 + 7)


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_control_fails_the_limits(serve_cell, seed):
    out = control.readings(serve_cell, seed, 5.0, True, "cpu")
    limits = serve_cell.limits
    assert all(v <= limits[k] for k, v in out["program"].items())
    assert all(v > limits[k]
               for k, v in out["control"]["lower_precision"].items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vits16.serve", "r18.serve"])
def test_control_at_the_cells_size(cuda_device, name):
    from benchmark.run import Cell

    cell = Cell(name)
    out = control.readings(cell, SEEDS[0], 15.0, True, cuda_device)
    assert all(v <= cell.limits[k] for k, v in out["program"].items())
    assert any(v > cell.limits[k]
               for k, v in out["control"]["lower_precision"].items())
