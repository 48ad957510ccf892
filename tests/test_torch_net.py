"""tpinn_torch.core.{net, deriv, taylor} against tpinn.core on shared inputs.

Inputs are drawn with numpy from a seed; JAX parameters are carried into
the port with params_from_numpy, so both packages see identical weights.
Tolerance for u and its partials (f32 on the CPU): rtol 1e-4, atol 1e-5.

The random-Fourier-feature and modified-MLP families: float64 outputs and
partials rtol 1e-10 (atol 1e-12 of the stream's max); float32 per stream
max |diff| <= 1e-4 * max |ref| (second derivatives carry B² and the two
packages' float32 cos/sin differ in the last bits, so they are held
relative to the stream's max, not elementwise).  The flat Adam step on
such a tree: rtol 1e-5, atol 1e-6 per leaf, as tests/test_torch_optim.py.
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
    """The Fourier and modified families ARE ported now: they initialise
    with tpinn's tree (keys, shapes, fourier_b's scale), build a
    predictor, and advertise no kernel partials."""
    fm = tnet.feature_map_for(("identity", "identity"))
    fm_j = jnet.feature_map_for(("identity", "identity"))
    for kw in (dict(depth=2, width=8, fourier_features=4, fourier_scale=3.0),
               dict(depth=2, width=8, modified=True),
               dict(depth=3, width=8, fourier_features=5, modified=True)):
        spec = tnet.MLPSpec(**kw)
        p = tnet.init_params(torch.Generator().manual_seed(0), spec, fm, "cpu")
        p_j = jnet.init_params(jax.random.PRNGKey(0), jnet.MLPSpec(**kw), fm_j)
        assert sorted(p) == sorted(p_j)
        shapes = lambda t: [tuple(x.shape) for x in
                            jax.tree_util.tree_leaves(t)]
        assert shapes(params_to_numpy(p)) == shapes(p_j)
        pred = tnet.make_predictor(spec, fm, torch.zeros(2), torch.ones(2))
        assert not hasattr(pred, "tpinn_partials")
        assert tuple(pred(p, torch.rand(7, 2)).shape) == (7, 1)
        again = tnet.init_params(torch.Generator().manual_seed(0), spec, fm,
                                 "cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(again)))
    big = tnet.init_params(
        torch.Generator().manual_seed(1),
        tnet.MLPSpec(depth=1, width=4, fourier_features=2000,
                     fourier_scale=10.0), fm, "cpu")["fourier_b"]
    assert tuple(big.shape) == (2, 2000)
    assert 9.5 < float(big.std()) < 10.5 and abs(float(big.mean())) < 0.5


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


# ---------------------------------------------------------------------------
# The random-Fourier-feature and modified-MLP families
# ---------------------------------------------------------------------------

FAMILIES = {
    "fourier": dict(depth=2, width=16, fourier_features=8, fourier_scale=10.0),
    "modified": dict(depth=3, width=12, modified=True, act_first="sin",
                     scl=2.0, epsil=0.7),
    "fourier+modified": dict(depth=2, width=12, fourier_features=6,
                             fourier_scale=3.0, modified=True),
}
F64_RTOL, F32_REL = 1e-10, 1e-4


def _family(name, dtype, pad_to=3, kinds=("minmax", "minmax")):
    """JAX and port predictors of one family on tpinn's parameters."""
    kw = FAMILIES[name]
    lb, ub = (0.0,) * len(kinds), (1.0,) * len(kinds)
    fm_j = jnet.feature_map_for(kinds, pad_to=pad_to)
    spec_j = jnet.MLPSpec(**kw)
    p_j = jnet.init_params(jax.random.PRNGKey(7), spec_j, fm_j,
                           jnp.float64 if dtype == torch.float64
                           else jnp.float32)
    pred_j = jnet.make_predictor(spec_j, fm_j, jnp.asarray(lb), jnp.asarray(ub))
    spec_t = tnet.MLPSpec(**kw)
    fm_t = tnet.feature_map_for(kinds, pad_to=pad_to)
    pred_t = tnet.make_predictor(spec_t, fm_t, torch.tensor(lb, dtype=dtype),
                                 torch.tensor(ub, dtype=dtype))
    return (spec_j, fm_j, pred_j, p_j, spec_t, fm_t, pred_t,
            params_from_numpy(p_j, "cpu", dtype), lb, ub)


def _stream_close(got, want, dtype, msg=""):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, msg
    scale = float(np.abs(want).max())
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, rtol=F64_RTOL,
                                   atol=1e-12 * scale, err_msg=msg)
    else:
        assert float(np.abs(got - want).max()) <= F32_REL * scale, msg


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_families_match_jax(name, dtype):
    """mlp_hidden, mlp_apply and the predictor on tpinn's parameters."""
    from tpinn.utils.x64 import force_x64

    with force_x64():
        (spec_j, fm_j, pred_j, p_j, spec_t, fm_t, pred_t, p_t, lb,
         ub) = _family(name, dtype)
        z = _points(90, lb, ub).astype(np.float64 if dtype == torch.float64
                                       else np.float32)
        zt, zj = torch.from_numpy(z), jnp.asarray(z)
        h_t = fm_t(zt, torch.tensor(lb, dtype=dtype),
                   torch.tensor(ub, dtype=dtype))
        h_j = fm_j(zj, jnp.asarray(lb), jnp.asarray(ub))
        hid = tnet.mlp_hidden(p_t, h_t, spec_t)
        assert tuple(hid.shape) == (90, spec_t.width) and hid.dtype == dtype
        _stream_close(hid, jnet.mlp_hidden(p_j, h_j, spec_j), dtype, "hidden")
        _stream_close(tnet.mlp_apply(p_t, h_t, spec_t),
                      jnet.mlp_apply(p_j, h_j, spec_j), dtype, "apply")
        _stream_close(pred_t(p_t, zt), pred_j(p_j, zj), dtype, "predictor")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["fourier", "fourier+modified"])
def test_fourier_partials_match_jax(name, dtype):
    """u and its partials up to order 2 by the generic engine, which is
    where dispatch sends these families."""
    from tpinn.utils.x64 import force_x64

    with force_x64():
        (_, _, pred_j, p_j, _, _, pred_t, p_t, lb, ub) = _family(name, dtype)
        z = _points(120, lb, ub).astype(np.float64 if dtype == torch.float64
                                        else np.float32)
        want = jderiv.partials(lambda zz: pred_j(p_j, zz), jnp.asarray(z), IDX)
        got = ttaylor.fast_partials(pred_t, p_t, torch.from_numpy(z), IDX, 2)
        assert set(got) == set(IDX)
        for ix in IDX:
            _stream_close(got[ix], want[ix], dtype, str(ix))
        if name == "fourier":   # B² rides the second derivatives
            assert (float(got[(0, 0)].abs().max())
                    > 30.0 * float(got[()].abs().max()))


def test_families_dispatch_by_structure():
    """Neither family advertises kernel partials, alone or under a hard-BC
    wrapper or in a chain, so every engine choice lands on the generic
    jvp; engine='kernel' is refused by structure; a plain net still
    advertises them."""
    from tpinn_torch.core import loss as tloss
    from tpinn_torch.kernels import mlp_taylor

    lift = tpde.compile_coord_expr("0", ("x", "y"))
    bub = tpde.compile_coord_expr("x*(1 - x)*y*(1 - y)", ("x", "y"))
    compiled = tpde.compile_pde("u_xx + u_yy", ("x", "y"))
    plain = _family("fourier", torch.float32)[6]
    for name in FAMILIES:
        (_, _, _, _, spec_t, fm_t, pred_t, p_t, lb, ub) = _family(
            name, torch.float32)
        assert not spec_t.is_plain and not mlp_taylor.supports(spec_t, fm_t)
        hard = tnet.wrap_hard_bc(pred_t, lift, bub)
        chain = tnet.compose_stages(pred_t, tnet.MLPSpec(depth=2, width=8),
                                    fm_t, torch.tensor(lb), torch.tensor(ub))
        for pred in (pred_t, hard, chain):
            assert not hasattr(pred, "tpinn_partials")
            assert tloss.kernel_engine_unavailable(pred, False) is not None
        with pytest.raises(ValueError, match="plain dense"):
            tloss.make_loss(pred_t, compiled, engine="kernel")
        z = torch.from_numpy(_points(40, lb, ub))
        fast = compiled.residual_fast(hard, p_t, z)
        generic = compiled.residual(lambda zz: hard(p_t, zz), z)
        assert torch.equal(fast, generic)
        with pytest.raises(ValueError, match="plain dense"):
            ttaylor.taylor2_mlp(p_t, z, spec_t, fm_t, torch.tensor(lb),
                                torch.tensor(ub), IDX)
    _, _, pred_plain, _ = _both(dict(depth=2, width=16))
    assert hasattr(pred_plain, "tpinn_partials") and plain is not None
    assert tloss.kernel_engine_unavailable(pred_plain, False) is None


@pytest.mark.parametrize("name", list(FAMILIES))
def test_flat_adam_step_on_family_tree_matches_tpinn(name):
    """Five steps of the flat-layout Adam phase on a tree that holds
    fourier_b and the gates beside the layers: every leaf equal to
    tpinn's, in JAX's flattening order (dict keys sorted)."""
    from tpinn.core import optim as jopt
    from tpinn_torch.core import optim as topt

    (_, _, pred_j, p_j, _, _, pred_t, p_t, lb, ub) = _family(
        name, torch.float32)
    z = _points(64, lb, ub)
    target = np.sin(3.0 * z[:, 0:1]) * z[:, 1:2]
    dj = {"z": jnp.asarray(z), "y": jnp.asarray(target)}
    dt = {"z": torch.from_numpy(z), "y": torch.from_numpy(target)}

    def loss_j(p, data, lw, ref):
        loss = jnp.mean((pred_j(p, data["z"]) - data["y"]) ** 2)
        return loss / ref, jnp.stack([loss, loss, loss])

    def loss_t(p, data, lw, ref):
        loss = torch.mean((pred_t(p, data["z"]) - data["y"]) ** 2)
        return loss / ref, torch.stack([loss, loss, loss])

    cfg = dict(epochs=5, lr=1e-2, tail_max=0, plateau_every=0)
    rj = jopt.make_adam_phase(loss_j, None, None, jopt.AdamConfig(**cfg), 3)(
        jax.random.PRNGKey(0), p_j, dj, jnp.ones((3, 3)), jnp.array([1.0]),
        jnp.array(1.0))
    rt = topt.make_adam_phase(loss_t, None, None, topt.AdamConfig(**cfg), 3)(
        torch.Generator().manual_seed(0), p_t, dt, torch.ones(3, 3),
        torch.tensor([1.0]), torch.tensor(1.0))
    keys = sorted(p_t)
    assert keys == sorted(rt.params) and keys[-1] == "layers"
    assert keys[0] == ("fourier_b" if "fourier" in name else "gate_u")
    flat, unravel = topt.ravel_tree(p_t)
    first = topt.tree_leaves(p_t)[0]
    assert torch.equal(flat[:first.numel()].view(first.shape), first)
    assert torch.equal(topt.tree_leaves(unravel(flat))[-1],
                       p_t["layers"][-1]["w"])
    np.testing.assert_allclose(rt.history[:5].numpy(),
                               np.asarray(rj.history)[:5], rtol=1e-5, atol=1e-6)
    leaves_j = jax.tree_util.tree_leaves(rj.params)
    leaves_t = topt.tree_leaves(rt.params)
    assert len(leaves_j) == len(leaves_t)
    moved = 0.0
    for a, b, b0 in zip(leaves_j, leaves_t, topt.tree_leaves(p_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
        moved = max(moved, float((b - b0).abs().max()))
    assert moved > 1e-3


@pytest.mark.parametrize("case", ["fourier", "fourier+modified", "3d-plain"])
def test_tpinn_checkpoint_of_other_nets_served_by_the_port(tmp_path, case):
    """A checkpoint that tpinn writes for a Fourier (or gated) net, or
    for a 3-coordinate net, loads in the port and is served: /predict
    and /residual equal tpinn's server (float32: 1e-5 and the residual
    relative to its max 1e-4), and the port's own round trip keeps every
    leaf."""
    from tpinn.app.serve import PINNServer as JaxServer
    from tpinn.utils import checkpoint as jckpt
    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.utils import checkpoint as tckpt

    if case == "3d-plain":
        problem, kinds, pad, hard = "poisson_3d", ("minmax",) * 3, 0, [
            "0", "x*(1 - x)*y*(1 - y)*z*(1 - z)"]
        spec_j = jnet.MLPSpec(depth=2, width=12)
    else:
        problem, kinds, pad, hard = "helmholtz_2d", ("minmax",) * 2, 3, None
        spec_j = jnet.MLPSpec(**{**FAMILIES[case], "fourier_scale": 2.0})
    d = len(kinds)
    fm_j = jnet.feature_map_for(kinds, pad_to=pad)
    p_j = jnet.init_params(jax.random.PRNGKey(11), spec_j, fm_j)
    meta = {"stage": 1, "scl": spec_j.scl, "epsil": spec_j.epsil,
            "problem": problem, "chain": [jnet.spec_to_dict(spec_j)],
            "feature_kinds": list(kinds), "lb": [0.0] * d, "ub": [1.0] * d,
            "hard_bc": hard, "coords": ["x", "y", "z"][:d],
            "pad_features": pad, "deflation": None}
    path = tmp_path / "params_stage_1.npz"
    jckpt.save_pytree(path, p_j, meta=meta)
    tsrv = PINNServer(str(path), problem, device="cpu")
    jsrv = JaxServer(str(path), problem)
    assert sorted(tsrv.params) == sorted(p_j)
    pts = _points(50, (0.0,) * d, (1.0,) * d, seed=3).tolist()
    np.testing.assert_allclose(tsrv.predict(pts), jsrv.predict(pts),
                               rtol=1e-5, atol=1e-5)
    f_t, f_j = np.asarray(tsrv.residual(pts)), np.asarray(jsrv.residual(pts))
    assert np.abs(f_t - f_j).max() <= 1e-4 * np.abs(f_j).max()
    with pytest.raises(ValueError, match=f"\\[n, {d}\\]"):
        tsrv.predict([[0.5] * (d + 1)])
    # the port's own round trip, and its file read back by tpinn
    again = tmp_path / "again.npz"
    tckpt.save_pytree(again, tsrv.params, meta)
    back, meta2 = tckpt.load_pytree(again, tsrv.params)
    assert meta2 == meta
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(back)),
                    jax.tree_util.tree_leaves(p_j)):
        np.testing.assert_array_equal(a, np.asarray(b))
    with np.load(again) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
