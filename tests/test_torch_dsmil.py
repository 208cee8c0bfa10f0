"""The port's DSMIL (`snuffy_tpu_torch.models.dsmil`) against
`snuffy_tpu.models.dsmil.MILNet`, and the model shims.

From the JAX parameters (`bridge.dsmil_from_jax`): instance logits, bag
logits and attention within 1e-5 (f32 both sides); padding invariance;
one query MLP shared by the rows and the critical instances; a strict
load of the reference names from a `.pth`; −inf masking (as the JAX
module, not Snuffy's −1e30); the argmax tie to the lowest row;
`passing_v` with and without `nonlinear`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snuffy as root_snuffy
import snuffy_multiclass as root_multiclass
from snuffy_tpu.models.dsmil import MILNet as JaxDsmil
from snuffy_tpu_torch import snuffy, snuffy_multiclass
from snuffy_tpu_torch.bridge import (
    dsmil_from_jax,
    dsmil_state_dict,
    load_reference_pth,
)
from snuffy_tpu_torch.models.dsmil import MILNet, build_dsmil

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def jax_model(d, c, nonlinear, passing_v, n=24, n_valid=17, seed=0):
    model = JaxDsmil(feats_size=d, num_classes=c, nonlinear=nonlinear,
                     passing_v=passing_v)
    rng = np.random.default_rng(seed)
    feats = np.zeros((n, d), np.float32)
    feats[:n_valid] = rng.standard_normal((n_valid, d))
    mask = np.arange(n) < n_valid
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(feats),
                        jnp.asarray(mask))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params), feats, mask


@pytest.mark.parametrize("d, c, nonlinear, passing_v",
                         [(16, 1, True, False), (32, 2, True, True),
                          (24, 3, False, True), (512, 2, False, False)])
def test_dsmil_matches_jax(d, c, nonlinear, passing_v):
    model, params, feats, mask = jax_model(d, c, nonlinear, passing_v)
    want = model.apply({"params": params}, jnp.asarray(feats),
                       jnp.asarray(mask))
    port = dsmil_from_jax(params, d, c, nonlinear, passing_v, device=CPU)
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    a = got[2].numpy()
    np.testing.assert_allclose(a[mask].sum(axis=0), 1.0, rtol=1e-6)
    assert (a[~mask] == 0).all()


def test_dsmil_is_padding_invariant():
    model, params, feats, mask = jax_model(16, 2, True, False, n=20)
    port = dsmil_from_jax(params, 16, 2, device=CPU)
    big = np.zeros((64, 16), np.float32)
    big[:17] = feats[:17]
    with torch.no_grad():
        _, bag, _ = port(torch.from_numpy(feats), torch.from_numpy(mask))
        _, bag2, _ = port(torch.from_numpy(big),
                          torch.from_numpy(np.arange(64) < 17))
        _, bag3, _ = port(torch.from_numpy(feats[:17]))
    np.testing.assert_allclose(bag.numpy(), bag2.numpy(), **TOL)
    np.testing.assert_allclose(bag.numpy(), bag3.numpy(), **TOL)


def test_dsmil_shares_its_query_weights():
    names = {n for n, _ in MILNet(8, 1).named_parameters()}
    assert names == {"i_classifier.fc.0.weight", "i_classifier.fc.0.bias",
                     "b_classifier.q.0.weight", "b_classifier.q.0.bias",
                     "b_classifier.q.2.weight", "b_classifier.q.2.bias",
                     "b_classifier.fcc.weight", "b_classifier.fcc.bias"}
    linear = {n for n, _ in MILNet(8, 1, nonlinear=False,
                                   passing_v=True).named_parameters()}
    assert {"b_classifier.q.weight", "b_classifier.v.1.weight"} <= linear
    _, params, _, _ = jax_model(8, 1, True, False)
    assert set(params["b_classifier"]) == {"q1", "q2", "fcc_kernel",
                                           "fcc_bias"}


@pytest.mark.parametrize("nonlinear, passing_v", [(True, True),
                                                  (False, False)])
def test_dsmil_loads_a_reference_pth_strictly(tmp_path, nonlinear,
                                              passing_v):
    _, params, feats, mask = jax_model(16, 2, nonlinear, passing_v)
    path = str(tmp_path / "dsmil.pth")
    torch.save({f"module.{k}": torch.from_numpy(v)
                for k, v in dsmil_state_dict(params).items()}, path)
    model = build_dsmil(16, 2, seed=3, device=CPU, nonlinear=nonlinear,
                        passing_v=passing_v)
    model.load_state_dict(load_reference_pth(path), strict=True)
    ref = dsmil_from_jax(params, 16, 2, nonlinear, passing_v, device=CPU)
    with torch.no_grad():
        for g, w in zip(model(torch.from_numpy(feats)),
                        ref(torch.from_numpy(feats))):
            assert torch.equal(g, w)


def test_dsmil_masks_with_minus_infinity():
    """Padded rows get exactly 0 attention whatever their logits; a bag
    with no valid row gives NaN attention (softmax over −inf), as the JAX
    module does, where Snuffy's −1e30 would give a uniform one."""
    model, params, feats, _ = jax_model(8, 1, True, False, n=6, n_valid=6)
    port = dsmil_from_jax(params, 8, 1, device=CPU)
    feats[4:] = 1e6            # large logits on the padded rows
    mask = np.arange(6) < 4
    with torch.no_grad():
        _, _, a = port(torch.from_numpy(feats), torch.from_numpy(mask))
        _, _, dead = port(torch.from_numpy(feats),
                          torch.zeros(6, dtype=torch.bool))
    assert (a[4:] == 0).all() and np.isfinite(a.numpy()).all()
    _, _, want_dead = model.apply({"params": params}, jnp.asarray(feats),
                                  jnp.zeros(6, bool))
    assert np.isnan(dead.numpy()).all() and np.isnan(
        np.asarray(want_dead)).all()


def test_dsmil_argmax_tie_goes_to_the_lowest_row():
    _, params, _, _ = jax_model(8, 1, True, False)
    port = dsmil_from_jax(params, 8, 1, device=CPU)
    feats = np.random.default_rng(2).standard_normal((5, 8)).astype(
        np.float32)
    c = torch.zeros(5, 1)
    c[1] = c[3] = 4.0              # rows 1 and 3 tie on the logit

    def pool(row):
        q = port.b_classifier.q
        x = torch.from_numpy(feats)
        return torch.softmax(q(x) @ q(x[row:row + 1]).T / np.sqrt(128),
                             dim=0).T @ x

    with torch.no_grad():
        _, _, b = port.b_classifier(torch.from_numpy(feats), c)
        torch.testing.assert_close(b, pool(1))
        assert not torch.allclose(b, pool(3))


def test_the_shims_export_the_ports_models():
    assert snuffy.build_milnet is snuffy_multiclass.build_milnet
    assert set(snuffy.__all__) == set(root_snuffy.__all__) - {
        "init_milnet_params"}
    assert set(snuffy_multiclass.__all__) == set(
        root_multiclass.__all__) - {"init_milnet_params"}
    cfg = snuffy_multiclass.multiclass_config(feats_size=16, num_heads=2)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        root_multiclass.multiclass_config(feats_size=16, num_heads=2))
    assert cfg.multiclass and not snuffy.SnuffyModelConfig().multiclass
    model = snuffy.build_milnet(cfg, device=CPU)
    assert isinstance(model, snuffy.MILNet)
