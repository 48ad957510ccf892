"""Coupled systems: tpinn_torch against tpinn, piece by piece.

The same numpy-seeded multi-output net is loaded into both packages
(``params_from_numpy``) and fed the same points.  Tolerances, float32 on
the CPU:

- ``compile_system(...).residual`` (the generic engine in both: nested
  forward-mode passes): rtol 1e-5, atol 1e-6;
- ``make_system_loss``'s ``(loss_n, loss_info)``: rtol 1e-5;
- the presets' BC targets and oracles at the same points: 1e-6.

The compiled structure (indices, ``n_eq``, ``max_order``,
``is_linear``), the grammar errors, ``SystemSpec``'s and ``InverseSpec``'s
checks and ``SYSTEM_RECIPES`` are held equal.  End-to-end training and
serving are in test_torch_system_train.py.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.core import inverse as jinverse
from tpinn.core import net as jnet
from tpinn.core import pde as jpde
from tpinn.core import sample as jsample
from tpinn.core import system as jsystem
from tpinn.problems import systems as jsystems
from tpinn_torch import problems as tproblems
from tpinn_torch.core import deriv as tderiv
from tpinn_torch.core import inverse as tinverse
from tpinn_torch.core import net as tnet
from tpinn_torch.core import pde as tpde
from tpinn_torch.core import sample as tsample
from tpinn_torch.core import system as tsystem
from tpinn_torch.problems import systems as tsystems
from tpinn_torch.utils.convert import params_from_numpy

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _net(kinds, lb, ub, m, seed=0, depth=2, width=16, pad=0):
    """One numpy-seeded net with ``m`` outputs as (params_numpy, jax
    predictor, port predictor)."""
    fm_j = jnet.feature_map_for(kinds, pad_to=pad)
    fm_t = tnet.feature_map_for(kinds, pad_to=pad)
    spec = jnet.MLPSpec(depth=depth, width=width, out_dim=m)
    rng = np.random.default_rng(seed)
    sizes = [fm_j.num_features] + [width] * depth + [m]
    params = {"layers": [
        {"w": (rng.standard_normal((a, b)) * math.sqrt(2.0 / (a + b))
               ).astype(np.float32),
         "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
        for a, b in zip(sizes[:-1], sizes[1:])]}
    pred_j = jnet.make_predictor(spec, fm_j, jnp.asarray(lb, jnp.float32),
                                 jnp.asarray(ub, jnp.float32))
    pred_t = tnet.make_predictor(
        tnet.spec_from_dict(jnet.spec_to_dict(spec)), fm_t,
        torch.tensor(lb, dtype=torch.float32),
        torch.tensor(ub, dtype=torch.float32))
    return params, pred_j, pred_t


def _points(lb, ub, n, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(lb, ub, (n, len(lb))).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# (equations, coords, fields, params, coef, box, feature kinds)
SYSTEMS = {
    "oscillator": (["u_x - v", "v_x + pi**2*u"], ("x",), ("u", "v"), (),
                   None, ((0.0,), (1.0,)), ("minmax",)),
    "cauchy_riemann": (["u_x - v_y", "u_y + v_x"], ("x", "y"), ("u", "v"),
                       (), None, ((0.0, 0.0), (1.0, 1.0)),
                       ("minmax", "minmax")),
    "coefficient": (["u_x - v", "v_x + w2*u"], ("x",), ("u", "v"), ("w2",),
                    {"w2": 9.5}, ((0.0,), (1.0,)), ("minmax",)),
}


def _system_case(name):
    if name in SYSTEMS:
        return SYSTEMS[name]
    # a preset's equations, coordinates, fields, box and feature kinds
    # (building a preset does not build its oracle)
    eqs = {"kovasznay": (("x", "y"), ("u", "v", "p"),
                         ((-0.5, -0.5), (1.0, 1.5)), ("minmax", "minmax")),
           "taylor_green": (("x", "y", "t"), ("u", "v", "p"),
                            ((0.0,) * 3, (math.pi, math.pi, 1.0)),
                            ("minmax",) * 3),
           "schrodinger": (("x", "t"), ("u", "v"),
                           ((-5.0, 0.0), (5.0, 0.5 * math.pi)),
                           ("periodic_fit", "minmax"))}[name]
    coords, fields, box, kinds = eqs
    equations = list(getattr(jsystems, name)().equations)
    return equations, coords, fields, (), None, box, kinds


@pytest.mark.parametrize("name", ["oscillator", "cauchy_riemann",
                                  "kovasznay", "taylor_green",
                                  "schrodinger", "coefficient"])
def test_compiled_system_matches_tpinn(name):
    equations, coords, fields, params, coef, (lb, ub), kinds = \
        _system_case(name)
    cj = jpde.compile_system(equations, coords, fields, params)
    ct = tpde.compile_system(equations, coords, fields, params)
    assert ct.indices == cj.indices
    assert (ct.n_eq, ct.max_order, ct.is_linear) == (cj.n_eq, cj.max_order,
                                                     cj.is_linear)
    assert (ct.equations, ct.coords, ct.fields, ct.param_names) == (
        cj.equations, cj.coords, cj.fields, cj.param_names)
    p_np, pred_j, pred_t = _net(kinds, lb, ub, len(fields), pad=3)
    p_t = params_from_numpy(p_np, "cpu")
    z = _points(lb, ub, 64)
    coef_j = ({k: jnp.float32(v) for k, v in coef.items()} if coef else None)
    coef_t = ({k: torch.tensor(v) for k, v in coef.items()} if coef else None)
    r_j = np.asarray(cj.residual(lambda zz: pred_j(p_np, zz),
                                 jnp.asarray(z), coef_j))
    r_t = ct.residual(lambda zz: pred_t(p_t, zz), _t(z), coef_t)
    assert tuple(r_t.shape) == r_j.shape == (64, len(equations))
    np.testing.assert_allclose(r_t.detach().numpy(), r_j, rtol=RTOL,
                               atol=ATOL)
    # __call__ and evaluate are the same residual
    np.testing.assert_array_equal(
        ct(lambda zz: pred_t(p_t, zz), _t(z), coef_t).detach().numpy(),
        r_t.detach().numpy())


def test_one_derivative_call_per_residual(monkeypatch):
    """Every field's partials come from the same tangent passes: one
    deriv.partials call per system residual, over the union of the
    equations' multi-indices."""
    calls = []
    inner = tderiv.partials

    def counted(f, z, indices):
        calls.append(frozenset(indices))
        return inner(f, z, indices)

    monkeypatch.setattr(tderiv, "partials", counted)
    prob = tsystems.kovasznay()
    ct = tpde.compile_system(prob.equations, prob.coords, prob.fields)
    p_np, _, pred_t = _net(prob.feature_kinds, prob.lb, prob.ub, 3)
    p_t = params_from_numpy(p_np, "cpu")
    z = _t(_points(prob.lb, prob.ub, 16))
    ct.residual(lambda zz: pred_t(p_t, zz), z)
    assert calls == [ct.indices]
    sys2 = tpde.compile_system(["u_t - v_xx", "v_t - u_xx"], ("x", "t"),
                               ("u", "v"))
    assert sys2.indices == frozenset({(1,), (0, 0)}) and sys2.max_order == 2


@pytest.mark.parametrize("case", ["unknown_field", "duplicate_fields",
                                  "field_is_coord", "no_equations"])
def test_grammar_errors_alike(case):
    args = {"unknown_field": (["u_x - w"], ("x",), ("u", "v")),
            "duplicate_fields": (["u_x"], ("x",), ("u", "u")),
            "field_is_coord": (["u_x"], ("x",), ("u", "x")),
            "no_equations": ([], ("x",), ("u",))}[case]
    with pytest.raises(jpde.PDESyntaxError):
        jpde.compile_system(*args)
    with pytest.raises(tpde.PDESyntaxError):
        tpde.compile_system(*args)


def test_multichar_field_and_column_mismatch():
    sj = jpde.compile_system(["psi_xx + psi"], ("x",), ("psi",))
    st = tpde.compile_system(["psi_xx + psi"], ("x",), ("psi",))
    assert st.indices == sj.indices == frozenset({(0, 0), ()})
    # a scalar predictor where the system reads field column 1
    sj2 = jpde.compile_system(["u_x - v"], ("x",), ("u", "v"))
    with pytest.raises(ValueError, match="out_dim"):
        sj2.residual(jnp.sin, jnp.ones((4, 1)))
    st2 = tpde.compile_system(["u_x - v"], ("x",), ("u", "v"))
    with pytest.raises(ValueError, match="out_dim"):
        st2.residual(torch.sin, torch.ones((4, 1)))


def test_constant_equation_column_on_points_device():
    st = tpde.compile_system(["u - u + 2"], ("x",), ("u",))
    r = st.residual(lambda z: z, torch.ones((5, 1)))
    assert tuple(r.shape) == (5, 1) and torch.all(r == 2.0)


@pytest.mark.parametrize("pkg", ["tpinn", "tpinn_torch"])
def test_system_spec_field_check(pkg):
    mod, smp = ((jsystem, jsample) if pkg == "tpinn"
                else (tsystem, tsample))
    with pytest.raises(ValueError, match="field"):
        mod.SystemSpec(
            name="bad", equations=("u_x - v",), fields=("u", "v"),
            coords=("x",), lb=(0.0,), ub=(1.0,),
            bc_groups=(smp.BCGroup(lo=(0.0,), hi=(0.0,), field=2),))
    ok = mod.SystemSpec(
        name="ok", equations=("u_x - v",), fields=("u", "v"),
        coords=("x", "y"), lb=(0.0, 0.0), ub=(1.0, 1.0), bc_groups=())
    assert ok.feature_kinds == ("minmax", "minmax") and ok.dim == 2


# ---------------------------------------------------------------------------
# The system loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dirichlet", "operators_obs_coef"])
def test_system_loss_matches_tpinn(case):
    """``(loss_n, loss_info)`` on the same net, points and targets: field
    Dirichlet groups only; and a declared coefficient with BC operator
    groups (flux and a coupled one, None entries pinning fields) and
    full-state observations with obs_weight != 1."""
    coeffy = case == "operators_obs_coef"
    params = ("w2",) if coeffy else ()
    equations = ["u_x - v", "v_x + w2*u" if coeffy else "v_x + u"]
    operators = [None, "u_x", "u_x - v"] if coeffy else [None, None]
    fields_of = [0, 0, 0] if coeffy else [0, 1]
    p_np, pred_j, pred_t = _net(("minmax",), (0.0,), (1.0,), 2, pad=3)
    rng = np.random.default_rng(3)
    x_col = rng.uniform(0, 1, (40, 1)).astype(np.float32)
    x_bd = [np.full((4, 1), v, np.float32) for v in (0.0, 1.0, 0.5)
            ][:len(operators)]
    u_bd = [rng.standard_normal((4, 1)).astype(np.float32) for _ in x_bd]
    obs = None
    if coeffy:
        obs = (rng.uniform(0, 1, (10, 1)).astype(np.float32),
               rng.standard_normal((10, 2)).astype(np.float32))
    lw = np.asarray([0.7, 0.0], np.float32)
    out = []
    for pde_mod, sysmod, pred, conv in (
            (jpde, jsystem, pred_j, lambda a: jnp.asarray(a)),
            (tpde, tsystem, pred_t, _t)):
        cs = pde_mod.compile_system(equations, ("x",), ("u", "v"), params)
        ops = tuple(pde_mod.compile_system([o], ("x",), ("u", "v"), params)
                    if o else None for o in operators)
        loss_fn = sysmod.make_system_loss(
            pred, cs, tuple(fields_of),
            observations=(tuple(conv(a) for a in obs) if obs else None),
            obs_weight=2.5, bc_operators=ops if any(ops) else None)
        net_p = (p_np if pde_mod is jpde
                 else params_from_numpy(p_np, "cpu"))
        tree = ({"net": net_p, "coef": {"w2": conv(np.float32(8.0))}}
                if coeffy else net_p)
        data = {"x_col": conv(x_col), "x_bd": [conv(a) for a in x_bd],
                "u_bd": [conv(a) for a in u_bd]}
        loss_n, info = loss_fn(tree, data, conv(lw), conv(np.float32(2.0)))
        out.append((np.asarray(loss_n.detach() if torch.is_tensor(loss_n)
                               else loss_n),
                    np.asarray(info.detach() if torch.is_tensor(info)
                               else info)))
    (lj, ij), (lt, it) = out
    width = 3 + len(operators) + (2 if coeffy else 0) + 2
    assert ij.shape == it.shape == (width,)
    np.testing.assert_allclose(lt, lj, rtol=RTOL)
    np.testing.assert_allclose(it, ij, rtol=RTOL, atol=1e-7)


# ---------------------------------------------------------------------------
# Presets, recipes, InverseSpec
# ---------------------------------------------------------------------------


def _compare_presets(pj, pt, n=32):
    assert (pt.name, pt.equations, pt.fields, pt.coords, pt.lb, pt.ub,
            pt.feature_kinds) == (pj.name, pj.equations, pj.fields,
                                  pj.coords, pj.lb, pj.ub, pj.feature_kinds)
    assert len(pt.bc_groups) == len(pj.bc_groups)
    for k, (gj, gt) in enumerate(zip(pj.bc_groups, pt.bc_groups)):
        assert (gt.lo, gt.hi, gt.field, gt.value, gt.value_expr,
                gt.operator) == (gj.lo, gj.hi, gj.field, gj.value,
                                 gj.value_expr, gj.operator)
        z = _points(gj.lo, np.asarray(gj.hi) + 0.0, n, seed=k)
        np.testing.assert_allclose(gt.target(_t(z)).numpy(),
                                   np.asarray(gj.target(jnp.asarray(z))),
                                   rtol=0, atol=1e-6)
    z = _points(pj.lb, pj.ub, 200, seed=7)
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(pt.exact(_t(z)))),
        np.asarray(pj.exact(jnp.asarray(z))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["kovasznay", "taylor_green"])
def test_preset_equals_tpinn(name):
    _compare_presets(jsystems.get_system(name), tsystems.get_system(name))


def test_schrodinger_preset_equals_tpinn(monkeypatch):
    """One test: the oracle is a split-step Fourier solve on the host
    (seconds per process and package at its full grid), so both packages
    build it here from the same reduced solve (256 modes, 2,000 steps),
    whose copies test_torch_problems holds bit for bit; what is held is
    the preset's wiring: the interpolants, the column order, numpy out in
    both packages, at the same float32 points on the box and past its
    periodic seam."""
    import functools

    from tpinn.problems import oracles as joracles
    from tpinn_torch.problems import oracles as toracles

    for sysmod, orc in ((jsystems, joracles), (tsystems, toracles)):
        monkeypatch.setattr(orc, "nls_solution", functools.partial(
            orc.nls_solution, n=256, nsteps=2000))
        monkeypatch.setattr(sysmod, "_NLS_EXACT", None)
    pj, pt = jsystems.schrodinger(), tsystems.schrodinger()
    _compare_presets(pj, pt)
    z = _points((-7.0, 0.0), (7.0, 0.5 * math.pi), 50, seed=9)
    assert isinstance(pt.exact(_t(z)), np.ndarray)
    np.testing.assert_allclose(pt.exact(_t(z)),
                               np.asarray(pj.exact(jnp.asarray(z))),
                               rtol=0, atol=1e-6)


def test_registry_and_recipes_equal_tpinn():
    assert list(tsystems.SYSTEM_PRESETS) == list(jsystems.SYSTEM_PRESETS)
    assert tsystems.SYSTEM_RECIPES == jsystems.SYSTEM_RECIPES
    assert tproblems.SYSTEM_PRESETS is tsystems.SYSTEM_PRESETS
    assert tproblems.get_system("kovasznay").name == "kovasznay_re40"
    for mod in (jsystems, tsystems):
        with pytest.raises(KeyError, match="unknown system preset"):
            mod.get_system("no_such_system")
    assert (tsystems.kovasznay(re=100.0).equations
            == jsystems.kovasznay(re=100.0).equations)
    assert (tsystems.taylor_green(nu=0.01, t_final=2.0).ub
            == jsystems.taylor_green(nu=0.01, t_final=2.0).ub)


@pytest.mark.parametrize("kw", [dict(params=("a",), init=(1.0, 2.0)),
                                dict(params=(), init=()),
                                dict(params=("a",), init=(1.0,),
                                     normalize=-1.0)])
def test_inverse_spec_checks_alike(kw):
    for mod in (jinverse, tinverse):
        with pytest.raises(ValueError, match="InverseSpec"):
            mod.InverseSpec(**kw)


def test_inverse_spec_fields_equal_tpinn():
    fj = [(f.name, f.default) for f in
          dataclasses.fields(jinverse.InverseSpec)]
    ft = [(f.name, f.default) for f in
          dataclasses.fields(tinverse.InverseSpec)]
    assert ft == fj
