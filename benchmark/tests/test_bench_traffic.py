"""The traffic generators: the same seed gives the same inputs, and every
seed the same work in another order."""

from collections import Counter

from benchmark import weights
from benchmark.drivers import serve
from benchmark.run import Cell

BIG = 2**31 + 1234567


def test_serve_plan_is_seeded():
    t = Cell("vits16.serve").traffic
    assert serve.request_plan(t, BIG) == serve.request_plan(t, BIG)
    assert serve.request_plan(t, BIG) != serve.request_plan(t, BIG + 1)


def test_serve_cycles_hold_the_same_sizes_for_every_seed():
    t = Cell("vits16.serve").traffic
    k = t["sizes_per_cycle"]
    a, b = serve.request_plan(t, 7), serve.request_plan(t, BIG)
    for c in range(3):
        cyc_a = Counter(n for n, _, _ in a[c * k:(c + 1) * k])
        cyc_b = Counter(n for n, _, _ in b[c * k:(c + 1) * k])
        assert cyc_a == cyc_b and len(cyc_a) == k
    sizes = sorted(cyc_a)
    assert sizes[0] >= t["tiles_min"] and sizes[-1] <= t["tiles_max"]
    assert all(0 <= s and s + n <= t["pool_tiles"] for n, s, _ in a)


def test_weights_are_seeded():
    import torch

    spec = [("a", (4, 3), "weight"), ("b", (4,), "ln_weight")]
    one = weights.make(spec, weights.sub_seed(BIG, "x"), "cpu")
    two = weights.make(spec, weights.sub_seed(BIG, "x"), "cpu")
    other = weights.make(spec, weights.sub_seed(BIG + 1, "x"), "cpu")
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert not torch.equal(one["a"], other["a"])
