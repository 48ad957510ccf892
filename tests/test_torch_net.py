"""tpinn_torch.core.{net, deriv, taylor} against tpinn.core on shared inputs.

Inputs are drawn with numpy from a seed; JAX parameters are carried into
the port with params_from_numpy, so both packages see identical weights.
Tolerance for u and its partials (f32 on the CPU): rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.core import deriv as jderiv
from tpinn.core import net as jnet
from tpinn.core import pde as jpde
from tpinn.core import taylor as jtaylor
from tpinn_torch.core import deriv as tderiv
from tpinn_torch.core import net as tnet
from tpinn_torch.core import pde as tpde
from tpinn_torch.core import taylor as ttaylor
from tpinn_torch.utils.convert import params_from_numpy, params_to_numpy

RTOL, ATOL = 1e-4, 1e-5
TWO_PI = 2.0 * np.pi
IDX = [(), (0,), (1,), (0, 0), (1, 1), (0, 1)]


def _points(n, lo, hi, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, len(lo))).astype(np.float32)


def _both(spec_kw, kinds=("minmax", "periodic"), pad_to=0, lb=(0.1, 0.0),
          ub=(1.0, TWO_PI), seed=0):
    """(JAX predictor, JAX params, port predictor, port params)."""
    fm_j = jnet.feature_map_for(kinds, pad_to=pad_to)
    spec_j = jnet.MLPSpec(**spec_kw)
    p_j = jnet.init_params(jax.random.PRNGKey(seed), spec_j, fm_j)
    pred_j = jnet.make_predictor(spec_j, fm_j, jnp.asarray(lb), jnp.asarray(ub))
    fm_t = tnet.feature_map_for(kinds, pad_to=pad_to)
    spec_t = tnet.spec_from_dict(jnet.spec_to_dict(spec_j))
    p_t = params_from_numpy(p_j, "cpu")
    pred_t = tnet.make_predictor(spec_t, fm_t,
                                 torch.tensor(lb, dtype=torch.float32),
                                 torch.tensor(ub, dtype=torch.float32))
    return pred_j, p_j, pred_t, p_t


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("kinds,pad_to", [
    (("minmax", "periodic"), 0),
    (("periodic_fit", "minmax"), 0),
    (("identity", "minmax"), 0),
    (("minmax", "minmax"), 3),
    (("minmax", "periodic", "identity"), 5),
])
def test_feature_maps_match(kinds, pad_to):
    d = len(kinds)
    lb, ub = (-0.5,) * d, (1.5,) * d
    z = _points(40, lb, ub)
    fm_j = jnet.feature_map_for(kinds, pad_to=pad_to)
    fm_t = tnet.feature_map_for(kinds, pad_to=pad_to)
    assert fm_t.num_features == fm_j.num_features
    h_j = fm_j(jnp.asarray(z), jnp.asarray(lb), jnp.asarray(ub))
    h_t = fm_t(torch.from_numpy(z), torch.tensor(lb), torch.tensor(ub))
    assert tuple(h_t.shape) == h_j.shape
    _close(h_t, h_j, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tnet.feature_map_for(("polar",))


@pytest.mark.parametrize("spec_kw,kinds,pad_to", [
    (dict(depth=3, width=24, scl=1.5, epsil=0.8), ("minmax", "periodic"), 0),
    (dict(depth=2, width=16, act_first="sin", scl=3.0), ("minmax", "minmax"), 3),
    (dict(depth=2, width=20, act_hidden="sin"), ("periodic_fit", "minmax"), 0),
])
def test_predictor_matches_jax(spec_kw, kinds, pad_to):
    pred_j, p_j, pred_t, p_t = _both(spec_kw, kinds, pad_to, lb=(0.1, 0.0),
                                     ub=(1.0, 2.0))
    z = _points(200, (0.1, 0.0), (1.0, 2.0))
    u_t = pred_t(p_t, torch.from_numpy(z))
    assert tuple(u_t.shape) == (200, 1)
    _close(u_t, pred_j(p_j, jnp.asarray(z)))


def test_params_roundtrip_numpy():
    _, p_j, _, p_t = _both(dict(depth=2, width=16))
    back = params_to_numpy(p_t)
    for lj, lt in zip(p_j["layers"], back["layers"]):
        np.testing.assert_array_equal(lt["w"], np.asarray(lj["w"]))
        np.testing.assert_array_equal(lt["b"], np.asarray(lj["b"]))


def test_init_statistics():
    gen = torch.Generator().manual_seed(0)
    params = tnet.init_mlp(gen, [3, 256, 256, 1], "cpu")
    w = params[1]["w"]
    std_expected = np.sqrt(2.0 / (256 + 256))
    # truncated normal ±2σ has std ≈ 0.88σ of the untruncated
    assert 0.6 * std_expected < float(w.std()) < 1.0 * std_expected
    assert float(w.abs().max()) <= 2.0 * std_expected + 1e-6
    b = params[1]["b"]
    assert float(b.abs().max()) <= 2.0 * std_expected + 1e-6
    assert tuple(params[0]["w"].shape) == (3, 256)
    assert tuple(params[2]["b"].shape) == (1,)
    # the same seed gives the same weights; another seed other weights
    again = tnet.init_mlp(torch.Generator().manual_seed(0), [3, 256, 256, 1], "cpu")
    assert torch.equal(again[1]["w"], w)
    other = tnet.init_mlp(torch.Generator().manual_seed(1), [3, 256, 256, 1], "cpu")
    assert not torch.equal(other[1]["w"], w)


def test_other_families_not_ported():
    fm = tnet.feature_map_for(("identity", "identity"))
    gen = torch.Generator().manual_seed(0)
    for spec in (tnet.MLPSpec(depth=2, width=8, fourier_features=4),
                 tnet.MLPSpec(depth=2, width=8, modified=True)):
        with pytest.raises(NotImplementedError, match="Queue A item 4"):
            tnet.init_params(gen, spec, fm, "cpu")
        with pytest.raises(NotImplementedError):
            tnet.make_predictor(spec, fm, torch.zeros(2), torch.ones(2))


def test_compose_stages_matches_jax_and_freezes_prev():
    lb, ub = (0.1, 0.0), (1.0, TWO_PI)
    pred1_j, p1_j, pred1_t, p1_t = _both(dict(depth=2, width=16))
    spec2 = dict(depth=2, width=12, act_first="sin", scl=7.0, epsil=0.03)
    fm_j = jnet.feature_map_for(("minmax", "periodic"))
    p2_j = jnet.init_params(jax.random.PRNGKey(1), jnet.MLPSpec(**spec2), fm_j)
    f_j = jnet.compose_stages(pred1_j, jnet.MLPSpec(**spec2), fm_j,
                              jnp.asarray(lb), jnp.asarray(ub))
    f_t = tnet.compose_stages(pred1_t, tnet.MLPSpec(**spec2),
                              tnet.feature_map_for(("minmax", "periodic")),
                              torch.tensor(lb), torch.tensor(ub))
    params_j = jnet.compose_params(p2_j, p1_j)
    params_t = params_from_numpy(params_j, "cpu")
    z = _points(64, lb, ub)
    _close(f_t(params_t, torch.from_numpy(z)), f_j(params_j, jnp.asarray(z)))

    # the previous stage is frozen: no gradient reaches the prev subtree
    for leaf in (params_t["prev"]["layers"][0]["w"],
                 params_t["stage"]["layers"][0]["w"]):
        leaf.requires_grad_(True)
    loss = (f_t(params_t, torch.from_numpy(z)) ** 2).sum()
    loss.backward()
    assert params_t["prev"]["layers"][0]["w"].grad is None
    assert float(params_t["stage"]["layers"][0]["w"].grad.abs().max()) > 0


def _hard_pair():
    coords = ("r", "t")
    lift_j = jpde.compile_coord_expr("(1 - r)/0.9", coords)
    bub_j = jpde.compile_coord_expr("(r - 0.1)*(1 - r)", coords)
    lift_t = tpde.compile_coord_expr("(1 - r)/0.9", coords)
    bub_t = tpde.compile_coord_expr("(r - 0.1)*(1 - r)", coords)
    pred_j, p_j, pred_t, p_t = _both(dict(depth=3, width=20))
    hard_j = jnet.wrap_hard_bc(pred_j, lift_j, bub_j)
    hard_t = tnet.wrap_hard_bc(pred_t, lift_t, bub_t)
    return hard_j, p_j, hard_t, p_t


def test_wrap_hard_bc_exact_on_boundary_and_matches_jax():
    hard_j, p_j, hard_t, p_t = _hard_pair()
    t = torch.linspace(0.0, 6.28, 9)[:, None]
    z_in = torch.cat([torch.full_like(t, 0.1), t], dim=1)
    z_out = torch.cat([torch.full_like(t, 1.0), t], dim=1)
    assert float((hard_t(p_t, z_in) - 1.0).abs().max()) < 1e-6
    assert float(hard_t(p_t, z_out).abs().max()) < 1e-6
    z = _points(100, (0.1, 0.0), (1.0, TWO_PI))
    _close(hard_t(p_t, torch.from_numpy(z)), hard_j(p_j, jnp.asarray(z)))
    assert hard_t.tpinn_raw is not None and len(hard_t.tpinn_hard) == 2


def test_hard_bc_partials_match_jax_generic():
    """The product rule over the raw net's fused partials equals JAX's
    generic jvp through the wrapped predictor."""
    hard_j, p_j, hard_t, p_t = _hard_pair()
    z = _points(150, (0.1, 0.0), (1.0, TWO_PI))
    want = jderiv.partials(lambda zz: hard_j(p_j, zz), jnp.asarray(z), IDX)
    got = hard_t.tpinn_partials(p_t, torch.from_numpy(z), IDX)
    for ix in IDX:
        _close(got[ix], want[ix], msg=str(ix))


@pytest.mark.parametrize("indices", [
    [(), (0,), (1,), (0, 0), (1, 1)],
    [(0, 1), (1,)],
    [(0, 0, 1), (1, 1, 1), ()],
])
def test_deriv_partials_match_jax(indices):
    pred_j, p_j, pred_t, p_t = _both(dict(depth=2, width=16, act_first="sin",
                                          scl=2.0))
    z = _points(120, (0.1, 0.0), (1.0, TWO_PI))
    want = jderiv.partials(lambda zz: pred_j(p_j, zz), jnp.asarray(z), indices)
    got = tderiv.partials(lambda zz: pred_t(p_t, zz), torch.from_numpy(z),
                          indices)
    assert set(got) == set(want)
    for ix in want:
        _close(got[ix], want[ix], msg=str(ix))
    assert tderiv.plan_passes(indices) == jderiv.plan_passes(indices)


def test_deriv_closed_form():
    """u = sin(x)·cos(y): partials by the generic engine against the
    closed forms, including an order-3 index."""
    z = torch.from_numpy(_points(50, (0.0, 0.0), (2.0, 2.0)))
    f = lambda zz: torch.sin(zz[:, 0:1]) * torch.cos(zz[:, 1:2])
    parts = tderiv.partials(f, z, [(0, 1), (0, 0, 0)])
    x, y = z[:, 0:1], z[:, 1:2]
    _close(parts[(0, 1)], -torch.cos(x) * torch.sin(y))
    _close(parts[(0, 0, 0)], -torch.cos(x) * torch.cos(y))
    _close(parts[(1,)], -torch.sin(x) * torch.sin(y))


@pytest.mark.parametrize("spec_kw,kinds,pad_to", [
    (dict(depth=3, width=24, scl=1.5, epsil=0.8), ("minmax", "periodic"), 0),
    (dict(depth=2, width=16, act_first="sin", scl=3.0), ("minmax", "minmax"), 3),
    (dict(depth=2, width=16, act_hidden="sin"), ("identity", "minmax"), 0),
])
def test_taylor2_mlp_matches_jax(spec_kw, kinds, pad_to):
    lb, ub = (0.1, 0.0), (1.0, 2.0)
    fm_j = jnet.feature_map_for(kinds, pad_to=pad_to)
    spec_j = jnet.MLPSpec(**spec_kw)
    p_j = jnet.init_params(jax.random.PRNGKey(3), spec_j, fm_j)
    z = _points(150, lb, ub)
    want = jtaylor.taylor2_mlp(p_j, jnp.asarray(z), spec_j, fm_j,
                               jnp.asarray(lb), jnp.asarray(ub), IDX)
    got = ttaylor.taylor2_mlp(params_from_numpy(p_j, "cpu"), torch.from_numpy(z),
                              tnet.MLPSpec(**spec_kw),
                              tnet.feature_map_for(kinds, pad_to=pad_to),
                              torch.tensor(lb), torch.tensor(ub), IDX)
    assert set(got) == set(want)
    for ix in IDX:
        _close(got[ix], want[ix], msg=str(ix))


def test_plan_streams_matches_jax():
    for idx in ([(0, 1)], [(1,), ()], IDX, [(2, 2), (0,)]):
        assert ttaylor.plan_streams(idx) == jtaylor.plan_streams(idx)
    with pytest.raises(ValueError):
        ttaylor.plan_streams([(0, 0, 0)])


def test_dispatch_by_structure():
    """Kernel-eligible predictors advertise fused partials (kernel B1 /
    its plain version); periodic_fit and order 3 go to the generic
    engine, which still agrees with JAX."""
    _, _, pred_t, _ = _both(dict(depth=2, width=16))
    assert hasattr(pred_t, "tpinn_partials")
    pred_j, p_j, pred_fit, p_t = _both(dict(depth=2, width=16),
                                       kinds=("periodic_fit", "minmax"))
    assert not hasattr(pred_fit, "tpinn_partials")
    z = _points(80, (0.1, 0.0), (1.0, TWO_PI))
    got = ttaylor.fast_partials(pred_fit, p_t, torch.from_numpy(z), IDX, 2)
    want = jderiv.partials(lambda zz: pred_j(p_j, zz), jnp.asarray(z), IDX)
    for ix in IDX:
        _close(got[ix], want[ix], msg=str(ix))
    _, _, pred_t, p_t = _both(dict(depth=2, width=16))
    got3 = ttaylor.fast_partials(pred_t, p_t, torch.from_numpy(z),
                                 [(0, 0, 1)], 3)
    assert set(got3) == {(0, 0, 1)}
