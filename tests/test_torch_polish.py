"""tpinn_torch.core.polish against tpinn.core.polish.

The same numpy-seeded parameters, grids and planted errors go through
both packages.  tpinn's side runs as its own tests run it (polish.py
switches to float64 by itself; the helpers called directly here are
wrapped in ``force_x64``).  Tolerances, all float64 on the CPU:

- last-layer solve on a well-conditioned basis: new output layer rtol
  1e-8, pre/post objective rtol 1e-8; on a rank-deficient basis (a
  duplicated hidden unit, where the SVD cutoff decides the answer) the
  same minimum-norm solution to rtol 1e-6;
- the linearized system (LV, r): rtol 1e-9 (atol 1e-9 of the field's
  max);
- correction families: same kind, same kept modes, coefficients rtol
  1e-6 (atol 1e-9 of the largest), and the planted mode recovered to the
  tolerance of tests/test_polish.py;
- ``deflation_term`` / ``deflation_fields`` of one description by both
  packages: 1e-12 absolute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.core import net as jnet
from tpinn.core import pde as jpde
from tpinn.core import polish as jpolish
from tpinn.core import sample as jsample
from tpinn.utils.x64 import force_x64
from tpinn_torch import problems as tproblems
from tpinn_torch.core import net as tnet
from tpinn_torch.core import pde as tpde
from tpinn_torch.core import polish as tpolish
from tpinn_torch.core import sample as tsample
from tpinn_torch.core import train as ttrain
from tpinn_torch.utils.convert import params_from_numpy
from torch_spec_compare import field_names, tpinn_asdict

TWO_PI = float(2 * np.pi)
LAPLACE = "u_rr + 1/r*u_r + 1/r**2*u_tt"
HARD_ANNULUS = ("(1 - r)/0.9", "(r - 0.1)*(1 - r)")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These nets are tiny: one intra-op thread is as fast as eight alone,
    and many times faster when several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def both(fn):
    """A parameter-free predictor for each package from one formula
    ``fn(xp, z)`` (xp = jnp or torch)."""
    return (lambda p, z: fn(jnp, z)), (lambda p, z: fn(torch, z))


def compile_both(eq, coords):
    return jpde.compile_pde(eq, coords), tpde.compile_pde(eq, coords)


def assert_same_correction(got, want, rtol=1e-6):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert got["kind"] == want["kind"]
    assert got["modes"] == want["modes"]
    if "coeffs" in want:             # the parabolic kind carries series
        scale = np.abs(want["coeffs"]).max()
        np.testing.assert_allclose(got["coeffs"], want["coeffs"], rtol=rtol,
                                   atol=1e-9 * scale)
    for key in ("lb", "ub", "n_grid", "linearized", "tau", "spatial", "soft",
                "degree", "ring", "band"):
        assert got.get(key) == want.get(key), key
    for key in ("eps", "mu", "series", "rhs", "tau_grid"):
        if key in want:
            np.testing.assert_allclose(
                got[key], want[key], rtol=rtol,
                atol=1e-9 * np.abs(want[key]).max())


# ---------------------------------------------------------------------------
# last_layer_lsq
# ---------------------------------------------------------------------------


def _planted(hard):
    """A float64 3x16 net on [0, 1] whose own output is the true solution
    of u_xx = source (tests/test_polish.py:64-162)."""
    fm = tnet.feature_map_for((tnet.MINMAX,))
    spec = tnet.MLPSpec(depth=3, width=16, scl=1.0, epsil=0.7)
    params = tnet.init_params(torch.Generator().manual_seed(0), spec, fm,
                              "cpu", torch.float64)
    pred = tnet.make_predictor(spec, fm, torch.tensor([0.0]),
                               torch.tensor([1.0]))
    if hard:
        pred = tnet.wrap_hard_bc(pred,
                                 tpde.compile_coord_expr("1 - x", ("x",)),
                                 tpde.compile_coord_expr("x*(1 - x)", ("x",)))
    return pred, params


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard-bc"])
def test_lsq_polish_exact_recovery(hard):
    """Perturb only the output layer of a net that spans the true
    solution: one solve restores it to machine precision."""
    from tpinn_torch.core import deriv

    pred, true = _planted(hard)
    u_star = lambda z: pred(true, z)
    compiled = tpde.compile_pde("u_xx", ("x",))
    source = lambda z: deriv.partials(u_star, z, [(0, 0)])[(0, 0)]
    z_col = torch.linspace(0.0, 1.0, 257, dtype=torch.float64)[:, None]
    z_bd = ([] if hard else [torch.zeros((4, 1), dtype=torch.float64),
                             torch.ones((4, 1), dtype=torch.float64)])
    data = {"x_col": z_col, "x_bd": z_bd, "u_bd": [u_star(z) for z in z_bd]}
    last = true["layers"][-1]
    start = {"layers": true["layers"][:-1] + [{"w": last["w"] + 0.5,
                                               "b": last["b"] - 0.3}]}
    new, info = tpolish.last_layer_lsq(pred, compiled, start, data, lw0=1.0,
                                       source_fn=source)
    assert info["applied"] is True
    assert info["post"] < (1e-16 if hard else 1e-18), info
    err_w = float((new["layers"][-1]["w"] - last["w"]).abs().max())
    u_err = float((pred(new, z_col) - u_star(z_col)).abs().max())
    assert err_w < (1e-6 if hard else 1e-7), err_w
    assert u_err < (1e-8 if hard else 1e-9), u_err
    if hard:
        zb = torch.tensor([[0.0], [1.0]], dtype=torch.float64)
        assert float((pred(new, zb) - (1 - zb)).abs().max()) == 0.0
    assert new["layers"][-1]["w"].dtype == torch.float64
    # a nonlinear equation has no least-squares subproblem
    with pytest.raises(ValueError, match="not linear"):
        tpolish.last_layer_lsq(pred, tpde.compile_pde("u_xx + u**2", ("x",)),
                               start, data, lw0=1.0)


def _annulus_pair(hard, seed, depth=3, width=16, composed=False):
    """The same float32 net (numpy-seeded through tpinn's initializer) as a
    tpinn and a tpinn_torch predictor, and the same deterministic grid."""
    kinds = ("minmax", "periodic")
    fm_j, fm_t = jnet.feature_map_for(kinds), tnet.feature_map_for(kinds)
    lb, ub = (0.1, 0.0), (1.0, TWO_PI)
    spec_j = jnet.MLPSpec(depth=depth, width=width, scl=1.3, epsil=0.9)
    p_j = jnet.init_params(jax.random.PRNGKey(seed), spec_j, fm_j)
    pred_j = jnet.make_predictor(spec_j, fm_j, jnp.asarray(lb),
                                 jnp.asarray(ub))
    spec_t = tnet.spec_from_dict(jnet.spec_to_dict(spec_j))
    pred_t = tnet.make_predictor(spec_t, fm_t, torch.tensor(lb),
                                 torch.tensor(ub))
    if composed:
        s2 = jnet.MLPSpec(depth=2, width=12, act_first="sin", scl=4.0,
                          epsil=0.05)
        p2 = jnet.init_params(jax.random.PRNGKey(seed + 7), s2, fm_j)
        pred_j = jnet.compose_stages(pred_j, s2, fm_j, jnp.asarray(lb),
                                     jnp.asarray(ub))
        pred_t = tnet.compose_stages(
            pred_t, tnet.spec_from_dict(jnet.spec_to_dict(s2)), fm_t,
            torch.tensor(lb), torch.tensor(ub))
        p_j = jnet.compose_params(p2, p_j)
    if hard:
        pred_j = jnet.wrap_hard_bc(pred_j, *(jpde.compile_coord_expr(
            e, ("r", "t")) for e in HARD_ANNULUS))
        pred_t = tnet.wrap_hard_bc(pred_t, *(tpde.compile_coord_expr(
            e, ("r", "t")) for e in HARD_ANNULUS))
    g = 33
    R, T = np.meshgrid(np.linspace(0.1, 1.0, g, dtype=np.float32),
                       np.linspace(0.0, TWO_PI, g, dtype=np.float32))
    theta = np.linspace(0.0, TWO_PI, g, dtype=np.float32)
    data = {"x_col": np.stack([R.ravel(), T.ravel()], axis=1),
            "x_bd": [np.stack([np.full(g, r, np.float32), theta], axis=1)
                     for r in (0.1, 1.0)],
            "u_bd": [np.ones((g, 1), np.float32),
                     np.zeros((g, 1), np.float32)]}
    return (pred_j, p_j, jax.tree_util.tree_map(jnp.asarray, data),
            pred_t, params_from_numpy(p_j, "cpu"),
            jax.tree_util.tree_map(torch.from_numpy, data))


def _last_layer(params):
    stage = params["stage"] if "stage" in params else params
    last = stage["layers"][-1]
    return np.concatenate([np.asarray(last["w"])[:, 0], np.asarray(last["b"])])


@pytest.mark.parametrize("case", ["soft", "hard-bc", "composed-hard-bc",
                                  "weighted-source"])
def test_lsq_polish_matches_tpinn(case):
    hard = "hard" in case
    pj, p_j, d_j, pt, p_t, d_t = _annulus_pair(hard, seed=3,
                                               composed="composed" in case)
    cj, ct = compile_both(LAPLACE, ("r", "t"))
    kw_j, kw_t = {}, {}
    if case == "weighted-source":
        kw_j = {"source_fn": jpde.compile_coord_expr("sin(t)*r", ("r", "t")),
                "residual_weight_fn": jpde.compile_coord_expr("1 + r",
                                                              ("r", "t"))}
        kw_t = {"source_fn": tpde.compile_coord_expr("sin(t)*r", ("r", "t")),
                "residual_weight_fn": tpde.compile_coord_expr("1 + r",
                                                              ("r", "t"))}
    new_j, info_j = jpolish.last_layer_lsq(pj, cj, p_j, d_j, 0.05, **kw_j)
    new_t, info_t = tpolish.last_layer_lsq(pt, ct, p_t, d_t, 0.05, **kw_t)
    assert info_t["applied"] == info_j["applied"] is True
    np.testing.assert_allclose(info_t["pre"], info_j["pre"], rtol=1e-8)
    np.testing.assert_allclose(info_t["post"], info_j["post"], rtol=1e-8)
    want = _last_layer(new_j)
    got = _last_layer(jax.tree_util.tree_map(lambda t: t.numpy(), new_t))
    np.testing.assert_allclose(got, want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())
    # untouched leaves come back as they went in, in float64
    first_j = (new_j["stage"] if "stage" in new_j else new_j)["layers"][0]["w"]
    first_t = (new_t["stage"] if "stage" in new_t else new_t)["layers"][0]["w"]
    assert first_t.dtype == torch.float64
    np.testing.assert_array_equal(first_t.numpy(), np.asarray(first_j))


def test_lsq_polish_rank_deficient_matches_tpinn():
    """A duplicated hidden unit makes two columns of the system equal: the
    SVD cutoff picks the minimum-norm solution (equal weights on the two
    copies), as tpinn's lstsq does; a full-rank QR solve (LAPACK's
    ``gels``, the only method ``torch.linalg.lstsq`` offers on a CUDA
    tensor) does not."""
    pj, p_j, d_j, pt, p_t, d_t = _annulus_pair(False, seed=5, depth=2,
                                               width=8)
    hidden = p_j["layers"][-2]
    hidden["w"] = hidden["w"].at[:, 1].set(hidden["w"][:, 0])
    hidden["b"] = hidden["b"].at[1].set(hidden["b"][0])
    p_t = params_from_numpy(p_j, "cpu")
    cj, ct = compile_both(LAPLACE, ("r", "t"))
    new_j, info_j = jpolish.last_layer_lsq(pj, cj, p_j, d_j, 0.05)
    new_t, info_t = tpolish.last_layer_lsq(pt, ct, p_t, d_t, 0.05)
    assert info_t["applied"] == info_j["applied"] is True
    np.testing.assert_allclose(info_t["post"], info_j["post"], rtol=1e-6)
    want = _last_layer(new_j)
    got = _last_layer(jax.tree_util.tree_map(lambda t: t.numpy(), new_t))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(got[0], got[1], rtol=1e-9)

    # the solve itself on a matrix with a repeated column
    rng = np.random.default_rng(0)
    A = rng.normal(size=(60, 5))
    A[:, 3] = A[:, 1]
    b = rng.normal(size=60)
    x_np = np.linalg.lstsq(A, b, rcond=None)[0]
    x = tpolish.svd_lstsq(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, x_np, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(x[1], x[3], rtol=1e-9)
    # what gels computes: QR without pivoting, then a triangular solve
    # that divides by the (rounding-level) pivot of the repeated column
    Q, R = torch.linalg.qr(torch.from_numpy(A))
    x_gels = torch.linalg.solve_triangular(
        R, (Q.T @ torch.from_numpy(b))[:, None], upper=True)[:, 0].numpy()
    assert not np.allclose(x_gels, x_np, rtol=1e-3, atol=1e-6)
    # a wide system takes the same routine (no QR reduction)
    xw = tpolish.svd_lstsq(torch.from_numpy(A[:4]), torch.from_numpy(b[:4]))
    np.testing.assert_allclose(
        xw.numpy(), np.linalg.lstsq(A[:4], b[:4], rcond=None)[0], rtol=1e-8,
        atol=1e-10)


# ---------------------------------------------------------------------------
# The linearized system
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["annulus-linear", "burgers-newton",
                                  "annulus-net"])
def test_linearized_system_matches_tpinn(case):
    if case == "burgers-newton":
        eq, coords, lb, ub = "u_t + u*u_x - 0.01*u_xx", ("x", "t"), \
            [-1.0, 0.0], [1.0, 1.0]
        pj, pt = both(lambda xp, z: z[:, 0:1] / (1 + z[:, 1:2])
                      + 4e-4 * xp.sin(xp.pi * (z[:, 0:1] + 1) / 2)
                      * xp.sin(xp.pi * z[:, 1:2] / 2))
        basis = [(("sin", a), ("msin", b)) for a in (1, 2) for b in (1, 2)]
        p_j, p_t = {}, {}
    else:
        eq, coords, lb, ub = LAPLACE, ("r", "t"), [0.1, 0.0], [1.0, TWO_PI]
        basis = [(("sin", 1), ("one", 0)), (("sin", 2), ("pcos", 1)),
                 (("sin", 3), ("psin", 2)), (("cheb", 3), ("cheb", 2))]
        if case == "annulus-net":
            pj, p_j, _, pt, p_t, _ = _annulus_pair(True, seed=2)
        else:
            pj, pt = both(lambda xp, z: xp.log(z[:, 0:1]) / np.log(0.1)
                          + 3e-4 * xp.sin(xp.pi * (z[:, 0:1] - 0.1) / 0.9)
                          * xp.cos(z[:, 1:2]))
            p_j, p_t = {}, {}
    cj, ct = compile_both(eq, coords)
    z, _ = tpolish._box_quadrature(lb, ub, 21)
    src_j = jpde.compile_coord_expr("0.1*" + coords[0], coords)
    src_t = tpde.compile_coord_expr("0.1*" + coords[0], coords)
    with force_x64():
        LV_j, r_j = jpolish._linearized_system(pj, p_j, cj, lb, ub, z, basis,
                                               src_j)
    LV_t, r_t = tpolish._linearized_system(pt, p_t, ct, lb, ub, z, basis,
                                           src_t)
    assert LV_t.shape == LV_j.shape == (21 * 21, len(basis))
    np.testing.assert_allclose(LV_t, LV_j, rtol=1e-9,
                               atol=1e-9 * np.abs(LV_j).max())
    np.testing.assert_allclose(r_t, r_j, rtol=1e-9,
                               atol=1e-9 * np.abs(r_j).max())


# ---------------------------------------------------------------------------
# Correction families on planted errors (tests/test_polish.py)
# ---------------------------------------------------------------------------


def _planted_case(name):
    """(equation, coords, lb, ub, formula, defect_correction kwargs, the
    planted error's formula)."""
    if name == "diagonal-full-band":
        c = 2.7e-4
        return ("u_xx + u_yy + 2*pi**2*sin(pi*x)*sin(pi*y)", ("x", "y"),
                (0.0, 0.0), (1.0, 1.0),
                lambda xp, z: xp.sin(xp.pi * z[:, 0:1])
                * xp.sin(xp.pi * z[:, 1:2])
                + c * xp.sin(2 * xp.pi * z[:, 0:1])
                * xp.sin(3 * xp.pi * z[:, 1:2]),
                dict(hard_bc=("0", "x*(1 - x)*y*(1 - y)"), mode="full",
                     n_grid=61, max_mode=6),
                lambda z: c * np.sin(2 * np.pi * z[:, :1])
                * np.sin(3 * np.pi * z[:, 1:]), "modal", 0.05 * c)
    if name == "parabolic":
        c = 8e-4
        return ("u_t - u_xx", ("x", "t"), (0.0, 0.0), (1.0, 1.0),
                lambda xp, z: xp.exp(-xp.pi ** 2 * z[:, 1:2])
                * xp.sin(xp.pi * z[:, 0:1])
                + c * xp.sin(2 * xp.pi * z[:, 0:1])
                * (1 - xp.exp(-3 * z[:, 1:2])),
                dict(hard_bc=("sin(pi*x)", "t*x*(1 - x)"), mode="full",
                     n_grid=121, max_mode=6),
                lambda z: c * np.sin(2 * np.pi * z[:, :1])
                * (1 - np.exp(-3 * z[:, 1:])), "parabolic", 0.04 * c)
    if name == "galerkin-annulus":
        c1, c2 = 3.1e-4, -1.7e-4

        def u(xp, z):
            s = xp.pi * (z[:, 0:1] - 0.1) / 0.9
            return (xp.log(z[:, 0:1]) / np.log(0.1) + c1 * xp.sin(s)
                    + c2 * xp.sin(2 * s) * xp.cos(z[:, 1:2]))

        def err(z):
            s = np.pi * (z[:, :1] - 0.1) / 0.9
            return c1 * np.sin(s) + c2 * np.sin(2 * s) * np.cos(z[:, 1:])

        return (LAPLACE, ("r", "t"), (0.1, 0.0), (1.0, TWO_PI), u,
                dict(hard_bc=HARD_ANNULUS, mode="full", n_grid=81, max_sin=6,
                     max_fourier=3), err, "galerkin", 0.05 * c1)
    if name == "galerkin-newton-burgers":
        c = 4e-4
        return ("u_t + u*u_x - 0.01*u_xx", ("x", "t"), (-1.0, 0.0),
                (1.0, 1.0),
                lambda xp, z: z[:, 0:1] / (1 + z[:, 1:2])
                + c * xp.sin(xp.pi * (z[:, 0:1] + 1) / 2)
                * xp.sin(xp.pi * z[:, 1:2] / 2),
                dict(hard_bc=("x", "t*(1 - x**2)"), mode="full", n_grid=61,
                     max_sin=5),
                lambda z: c * np.sin(np.pi * (z[:, :1] + 1) / 2)
                * np.sin(np.pi * z[:, 1:] / 2), "galerkin", 0.05 * c)
    if name == "resonance-band":
        k, c = 20.0, 1.3e-3
        return (f"u_xx + u_yy + {k * k}*u + {k * k}*sin({k}*x)*sin({k}*y)",
                ("x", "y"), (0.0, 0.0), (1.0, 1.0),
                lambda xp, z: xp.sin(k * z[:, 0:1]) * xp.sin(k * z[:, 1:2])
                + c * xp.sin(4 * xp.pi * z[:, 0:1])
                * xp.sin(5 * xp.pi * z[:, 1:2]),
                dict(hard_bc=None, mode="auto", n_grid=81, max_mode=8),
                lambda z: c * np.sin(4 * np.pi * z[:, :1])
                * np.sin(5 * np.pi * z[:, 1:]), "modal", 0.06 * c)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["diagonal-full-band", "parabolic",
                                  "galerkin-annulus",
                                  "galerkin-newton-burgers",
                                  "resonance-band"])
def test_defect_correction_matches_tpinn_on_planted_error(name):
    eq, coords, lb, ub, formula, kw, err, kind, tol = _planted_case(name)
    pj, pt = both(formula)
    cj, ct = compile_both(eq, coords)
    want = jpolish.defect_correction(pj, {}, cj, lb, ub, coords=coords, **kw)
    got = tpolish.defect_correction(pt, {}, ct, lb, ub, coords=coords, **kw)
    assert got is not None and got["kind"] == kind
    assert_same_correction(got, want)
    if "resid_drop" in want:
        np.testing.assert_allclose(got["resid_drop"], want["resid_drop"],
                                   rtol=1e-5, atol=1e-9)
    assert got.get("linearized", False) == (not ct.is_linear)

    # the planted error is recovered, by the fields and by the term
    rng = np.random.default_rng(3)
    z = np.asarray(lb) + rng.uniform(0, 1, (300, 2)) * (np.asarray(ub)
                                                        - np.asarray(lb))
    du, df = tpolish.deflation_fields(got, ct, z)
    assert np.abs(du - err(z)).max() < tol
    assert (df is None) == (not ct.is_linear)
    term = tpolish.deflation_term(got)(torch.from_numpy(z))
    assert term.dtype == torch.float64 and tuple(term.shape) == (300, 1)
    np.testing.assert_allclose(term.numpy(), du, rtol=0, atol=1e-12)

    # one description, both packages: term and fields to 1e-12
    du_j, df_j = jpolish.deflation_fields(want, cj, z)
    np.testing.assert_allclose(du, du_j, rtol=0, atol=1e-12)
    if df is not None:
        np.testing.assert_allclose(df, df_j, rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(df_j).max()))
    with force_x64():
        term_j = np.asarray(jpolish.deflation_term(want)(jnp.asarray(z)))
    np.testing.assert_allclose(tpolish.deflation_term(want)(
        torch.from_numpy(z)).numpy(), term_j, rtol=0, atol=1e-12)
    # float32 points give a float32 term
    t32 = tpolish.deflation_term(got)(torch.from_numpy(z.astype(np.float32)))
    assert t32.dtype == torch.float32
    np.testing.assert_allclose(t32.numpy(), du, rtol=0,
                               atol=2e-5 * np.abs(du).max() + 1e-9)


def test_deflation_term_is_differentiable_and_vectorized():
    """The vectorized term equals the mode-by-mode sum of _basis_value on
    every factor kind, and forward-mode differentiates (the served
    residual takes u-partials of predictor − term)."""
    from tpinn_torch.core import deriv

    lb, ub = [0.1, -1.0], [1.0, 2.0]
    modes = [[["sin", 2], ["one", 0]], [["msin", 1], ["pcos", 3]],
             [["msinr", 2], ["psin", 1]], [["cheb", 4], ["cheb", 0]],
             [["cheb", 1], ["sin", 3]], [["one", 0], ["one", 0]]]
    coeffs = [0.3, -0.2, 0.11, 0.07, -0.05, 0.02]
    defl = {"kind": "galerkin", "modes": modes, "coeffs": coeffs, "lb": lb,
            "ub": ub}
    rng = np.random.default_rng(1)
    z = torch.from_numpy(np.asarray(lb) + rng.uniform(0, 1, (50, 2))
                         * (np.asarray(ub) - np.asarray(lb)))
    want = sum(c * tpolish._basis_value(
        torch, z, tuple((k, n) for k, n in m), lb, ub)
        for m, c in zip(modes, coeffs))
    term = tpolish.deflation_term(defl)
    np.testing.assert_allclose(term(z).numpy(), want.numpy(), rtol=0,
                               atol=1e-14)
    with force_x64():
        want_j = np.asarray(jpolish.deflation_term(defl)(
            jnp.asarray(z.numpy())))
    np.testing.assert_allclose(term(z).numpy(), want_j, rtol=0, atol=1e-12)
    # analytic partials of the same modes (host numpy) against the jvp
    # engine through the torch term
    idx = [(), (0,), (1,), (0, 0), (1, 1), (0, 1)]
    parts = deriv.partials(term, z, idx)
    for ix in idx:
        ref = sum(c * tpolish._basis_partials(
            tuple((k, n) for k, n in m), lb, ub, z.numpy(), [ix])[ix]
            for m, c in zip(modes, coeffs))
        np.testing.assert_allclose(parts[ix].numpy(), ref, rtol=1e-9,
                                   atol=1e-10)
    # parabolic: interpolation in τ differentiates too
    para = {"kind": "parabolic", "modes": [[1], [2]], "tau": 1,
            "spatial": [0], "lb": [0.0, 0.0], "ub": [1.0, 1.0],
            "tau_grid": np.linspace(0, 1, 11).tolist(),
            "series": [np.linspace(0, 1, 11).tolist(),
                       (np.linspace(0, 1, 11) ** 2).tolist()],
            "rhs": [[0.0] * 11, [0.0] * 11]}
    zp = torch.from_numpy(rng.uniform(0.02, 0.98, (40, 2)))
    t = tpolish.deflation_term(para)
    du, _ = tpolish.deflation_fields(para, None, zp.numpy())
    np.testing.assert_allclose(t(zp).numpy(), du, rtol=0, atol=1e-13)
    dt = deriv.partials(t, zp, [(1,)])[(1,)].numpy()
    assert np.isfinite(dt).all() and np.abs(dt).max() > 0.1
    # an empty correction is the zero field
    zero = tpolish.deflation_term({"kind": "galerkin", "modes": [],
                                   "coeffs": [], "lb": lb, "ub": ub})(z)
    assert float(zero.abs().max()) == 0.0 and tuple(zero.shape) == (50, 1)


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------


def test_full_defect_requires_vanishing_bubble():
    _, ct = compile_both("u_xx + u_yy + 2*u", ("x", "y"))
    _, pt = both(lambda xp, z: xp.sin(xp.pi * z[:, 0:1]) * z[:, 1:2])
    assert tpolish.defect_correction(
        pt, {}, ct, (0.0, 0.0), (1.0, 1.0), hard_bc=("0", "x*(1 - x)"),
        mode="full", coords=("x", "y"), n_grid=41, max_mode=4) is None
    assert tpolish.defect_correction(
        pt, {}, ct, (0.0, 0.0), (1.0, 1.0), hard_bc=None, mode="full",
        coords=("x", "y")) is None
    assert tpolish.defect_correction(
        pt, {}, ct, (0.0, 0.0), (1.0, 1.0), hard_bc=None, mode="sweep") is None


def test_galerkin_defect_rejects_nonperiodic_axis():
    cj, ct = compile_both(LAPLACE, ("r", "t"))
    pj, pt = both(lambda xp, z: xp.log(z[:, 0:1]) / np.log(0.1)
                  + 1e-3 * z[:, 1:2] * (z[:, 0:1] - 0.1) * (1 - z[:, 0:1]))
    kw = dict(hard_bc=HARD_ANNULUS, mode="full", coords=("r", "t"),
              n_grid=61, max_sin=4, max_fourier=2)
    assert tpolish.defect_correction(pt, {}, ct, (0.1, 0.0), (1.0, TWO_PI),
                                     **kw) is None
    assert jpolish.defect_correction(pj, {}, cj, (0.1, 0.0), (1.0, TWO_PI),
                                     **kw) is None
    assert tpolish.galerkin_defect(pt, {}, ct, (0.1, 0.0), (1.0, TWO_PI),
                                   ["dirichlet", "robin"]) is None
    assert tpolish.galerkin_defect(pt, {}, ct, (0.1,), (1.0,),
                                   ["dirichlet", "periodic"]) is None


def test_bubble_face_check_is_relative():
    """An O(100)-amplitude bubble leaves roundoff on a true zero face; the
    float64 relative check must still accept it."""
    vanish = tpolish._bubble_face_map("100*sin(pi*x)*y*(1 - y)", ("x", "y"),
                                      [0.0, 0.0], [1.0, 1.0])
    assert all(vanish.values()), vanish
    vanish = tpolish._bubble_face_map("t*(1 - x**2)", ("x", "t"),
                                      [-1.0, 0.0], [1.0, 1.0])
    assert vanish == {(0, 0): True, (0, 1): True, (1, 0): True, (1, 1): False}
    c = 2.7e-4
    _, ct = compile_both("u_xx + u_yy + 2*u", ("x", "y"))
    _, pt = both(lambda xp, z: c * xp.sin(2 * xp.pi * z[:, 0:1])
                 * xp.sin(3 * xp.pi * z[:, 1:2]))
    assert tpolish.defect_correction(
        pt, {}, ct, (0.0, 0.0), (1.0, 1.0),
        hard_bc=("0", "100*x*(1 - x)*y*(1 - y)"), mode="full",
        coords=("x", "y"), n_grid=61, max_mode=6) is not None


def test_resonant_deflation_inert_and_singular_cases():
    _, pt = both(lambda xp, z: xp.sin(xp.pi * z[:, 0:1]) * (1 - z[:, 1:2]))
    for eq, coords in (("u_t - u_xx + 100*u", ("x", "t")),   # non-diagonal
                       ("u_xx + u_yy", ("x", "y")),           # no c0
                       ("u_xx + u_yy + u*u", ("x", "y"))):    # nonlinear
        assert tpolish.resonant_deflation(
            pt, {}, tpde.compile_pde(eq, coords), (0.0, 0.0), (1.0, 1.0),
            n_grid=41, max_mode=5) is None
    # an exactly resonant operator never divides by its zero eigenvalue
    c0 = 5 * float(np.pi) ** 2
    pj, pt = both(lambda xp, z: xp.sin(xp.pi * z[:, 0:1])
                  * xp.sin(xp.pi * z[:, 1:2]) * (1 + 0.1 * z[:, 0:1]))
    for shift in (0.0, 1.0):
        cj, ct = compile_both(f"u_xx + u_yy + {c0 + shift!r}*u", ("x", "y"))
        got = tpolish.resonant_deflation(pt, {}, ct, (0.0, 0.0), (1.0, 1.0),
                                         n_grid=61, max_mode=4)
        want = jpolish.resonant_deflation(pj, {}, cj, (0.0, 0.0), (1.0, 1.0),
                                          n_grid=61, max_mode=4)
        assert_same_correction(got, want)
        if got is not None:
            assert all(np.isfinite(c) and abs(c) < 1e3 for c in got["coeffs"])
            assert all(abs(e) > 1e-6 for e in got["eps"])
    modes = {tuple(m) for m in got["modes"]}
    assert (1, 2) in modes and (2, 1) in modes


def test_defect_correction_full_accepts_band_kwarg():
    """The band knob passes through mode='full' (which fixes the band)
    without a TypeError, with tpinn's answer."""
    cj, ct = compile_both("u_xx + u_yy + 2*u", ("x", "y"))
    pj, pt = both(lambda xp, z: z[:, 0:1] * 0)
    kw = dict(hard_bc=("0", "x*(1 - x)*y*(1 - y)"), mode="full",
              coords=("x", "y"), n_grid=41, max_mode=3, band=0.5)
    got = tpolish.defect_correction(pt, {}, ct, (0.0, 0.0), (1.0, 1.0), **kw)
    want = jpolish.defect_correction(pj, {}, cj, (0.0, 0.0), (1.0, 1.0), **kw)
    assert_same_correction(got, want)
    assert got["band"] == "full" and not any(got["coeffs"])


def test_parabolic_antidiffusive_guard_is_cumulative():
    cj, ct = compile_both("u_t - u_xx - 800*u", ("x", "t"))
    pj, pt = both(lambda xp, z: xp.sin(xp.pi * z[:, 0:1])
                  * (1 + 0.1 * z[:, 1:2])
                  + 3e-4 * xp.sin(2 * xp.pi * z[:, 0:1]) * z[:, 1:2])
    got = tpolish.parabolic_defect(pt, {}, ct, (0.0, 0.0), (1.0, 1.0),
                                   n_grid=81, max_mode=6)
    want = jpolish.parabolic_defect(pj, {}, cj, (0.0, 0.0), (1.0, 1.0),
                                    n_grid=81, max_mode=6)
    assert_same_correction(got, want)
    if got is not None:
        for m, mu in zip(got["modes"], got["mu"]):
            assert mu / got["a"] >= -30.0, (m, mu)
        assert np.isfinite(np.asarray(got["series"], dtype=float)).all()
    # no march coordinate, or a nonlinear operator: not this family
    assert tpolish.parabolic_defect(
        pt, {}, tpde.compile_pde("u_xx + u_tt", ("x", "t")), (0.0, 0.0),
        (1.0, 1.0), n_grid=21) is None
    assert tpolish.parabolic_defect(
        pt, {}, tpde.compile_pde("u_t - u*u_xx", ("x", "t")), (0.0, 0.0),
        (1.0, 1.0), n_grid=21) is None


# ---------------------------------------------------------------------------
# The soft-BC Chebyshev ladder and the ring penalty
# ---------------------------------------------------------------------------

UNIT_FACES = (((0.0, 0.0), (0.0, 1.0)), ((1.0, 0.0), (1.0, 1.0)),
              ((0.0, 0.0), (1.0, 0.0)), ((0.0, 1.0), (1.0, 1.0)))


def _soft_case(ring):
    if ring:
        eq = "u_xx + u_yy + 1200*u - (1200 - 2*pi**2)*sin(pi*x)*sin(pi*y)"

        def err(xp, x, y):
            return (3e-4 * (x * x * y - 0.4 * x + 0.1)
                    + 5e-4 * xp.sin(8 * xp.pi * x) * xp.sin(8 * xp.pi * y))
    else:
        eq = "u_xx + u_yy + 30*u - (30 - 2*pi**2)*sin(pi*x)*sin(pi*y)"

        def err(xp, x, y):
            return 5e-4 * (x * x * y + 0.5 * xp.cos(2 * y) * x - 0.3)

    pj, pt = both(lambda xp, z: xp.sin(xp.pi * z[:, 0:1])
                  * xp.sin(xp.pi * z[:, 1:2])
                  + err(xp, z[:, 0:1], z[:, 1:2]))
    cj, ct = compile_both(eq, ("x", "y"))
    gj = tuple(jsample.BCGroup(lo=lo, hi=hi, value=0.0)
               for lo, hi in UNIT_FACES)
    gt = tuple(tsample.BCGroup(lo=lo, hi=hi, value=0.0)
               for lo, hi in UNIT_FACES)
    return pj, pt, cj, ct, gj, gt, lambda z: err(np, z[:, :1], z[:, 1:])


@pytest.mark.parametrize("degree", [10, "auto"])
def test_soft_defect_matches_tpinn(degree):
    """A planted smooth error with NONZERO boundary trace is determined by
    residual rows plus the known boundary data in the Chebyshev basis."""
    pj, pt, cj, ct, gj, gt, err = _soft_case(ring=False)
    kw = dict(hard_bc=None, mode="full", coords=("x", "y"), n_grid=61,
              degree=degree)
    want = jpolish.defect_correction(pj, {}, cj, (0.0, 0.0), (1.0, 1.0),
                                     bc_groups=gj, **kw)
    got = tpolish.defect_correction(pt, {}, ct, (0.0, 0.0), (1.0, 1.0),
                                    bc_groups=gt, **kw)
    assert got is not None and got.get("soft") is True
    assert got["degree"] == want["degree"]
    assert got["degree"] in ((8, 12, 16, 20, 24) if degree == "auto"
                             else (10,))
    # an ill-conditioned Chebyshev solve: coefficients at the 1e-8 keep
    # threshold come and go with rounding, so the descriptions are compared
    # through the held-out misfits and the corrections they build (1e-9)
    # (the corrected misfits are rounding noise, ~1e-17: absolute 1e-12)
    np.testing.assert_allclose(got["heldout"], want["heldout"], rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(got["bd_rms"], want["bd_rms"], rtol=1e-5,
                               atol=1e-12)
    z = np.random.default_rng(7).uniform(0, 1, (400, 2))
    du, _ = tpolish.deflation_fields(got, ct, z)
    du_j, _ = jpolish.deflation_fields(want, cj, z)
    np.testing.assert_allclose(du, du_j, rtol=0, atol=1e-9)
    g = err(z)
    assert np.abs(du - g).max() < 0.03 * np.abs(g).max()
    np.testing.assert_allclose(
        tpolish.deflation_term(got)(torch.from_numpy(z)).numpy(), du,
        rtol=0, atol=1e-12)


def test_soft_defect_ring_augmentation_recovers_resonant_mode():
    pj, pt, cj, ct, gj, gt, err = _soft_case(ring=True)
    args = ((0.0, 0.0), (1.0, 1.0))
    got = tpolish.soft_defect(pt, {}, ct, *args, gt, n_grid=61, degree=12,
                              ring_max_mode=8)
    want = jpolish.soft_defect(pj, {}, cj, *args, gj, n_grid=61, degree=12,
                               ring_max_mode=8)
    assert got is not None and got["ring"] == want["ring"] > 0
    z = np.random.default_rng(7).uniform(0, 1, (400, 2))
    du, _ = tpolish.deflation_fields(got, ct, z)
    g = err(z)
    assert np.abs(du - g).max() < 0.05 * np.abs(g).max()
    # the pure Chebyshev solve at the same degree cannot carry the mode
    off = tpolish.soft_defect(pt, {}, ct, *args, gt, n_grid=61, degree=12,
                              ring=False)
    if off is not None:
        du0, _ = tpolish.deflation_fields(off, ct, z)
        assert np.abs(du0 - g).max() > 0.4 * 5e-4
    # no boundary groups, or three coordinates: not this family
    assert tpolish.soft_defect(pt, {}, ct, *args, ()) is None
    assert tpolish.soft_defect(pt, {}, ct, (0.0,) * 3, (1.0,) * 3, gt) is None


def test_ring_penalty_setup_matches_tpinn():
    cj, ct = compile_both("u_xx + u_yy + 1200*u", ("x", "y"))
    z_j, P_j = jpolish.ring_penalty_setup(cj, (0.0, 0.0), (1.0, 1.0),
                                          n_grid=64, max_mode=10)
    z, P = tpolish.ring_penalty_setup(ct, (0.0, 0.0), (1.0, 1.0), n_grid=64,
                                      max_mode=10)
    np.testing.assert_allclose(z, z_j, rtol=0, atol=1e-15)
    np.testing.assert_allclose(P, P_j, rtol=1e-9, atol=1e-12 * np.abs(P_j).max())
    # a planted ring-mode error of coefficient δ reads as δ² …
    x, y = z[:, 0:1], z[:, 1:2]
    v_hat = 2.0 * np.sin(8 * np.pi * x) * np.sin(8 * np.pi * y)
    eps, delta = 1200.0 - 128.0 * np.pi ** 2, 3e-4
    r_ring = delta * eps * v_hat
    pen = float(np.sum((P.T @ r_ring) ** 2))
    assert pen == pytest.approx(delta ** 2, rel=0.05)
    # … while broadband content of the same norm barely registers
    r_flat = np.full_like(r_ring, float(np.sqrt(np.mean(r_ring ** 2))))
    assert float(np.sum((P.T @ r_flat) ** 2)) < 1e-3 * pen
    for eq, coords, lb, ub in (
            ("u_xx + u_yy", ("x", "y"), (0.0, 0.0), (1.0, 1.0)),
            ("u*u_x + u_xx + 100*u", ("x",), (0.0,), (1.0,)),
            ("u_t - u_xx + 40*u", ("x", "t"), (0.0, 0.0), (1.0, 1.0))):
        assert tpolish.ring_penalty_setup(tpde.compile_pde(eq, coords), lb,
                                          ub, n_grid=32, max_mode=6) is None


def test_ring_penalty_trains():
    """TrainSpec.ring_weight wires the penalty through the stage loss."""
    prob = ttrain.ProblemSpec(
        name="helm_ring", coords=("x", "y"),
        equation="u_xx + u_yy + 25*u - (25 - 2*pi**2)*sin(pi*x)*sin(pi*y)",
        lb=(0.0, 0.0), ub=(1.0, 1.0),
        bc_groups=tuple(tsample.BCGroup(lo=lo, hi=hi, value=0.0)
                        for lo, hi in UNIT_FACES),
        exact=lambda z: torch.sin(torch.pi * z[:, 0:1])
        * torch.sin(torch.pi * z[:, 1:2]))
    spec = ttrain.TrainSpec(
        n_col=256, n_band=0, n_adaptive=64, n_bd=24, testing_size=(32, 32),
        lw=(1.0, 0.0), grid=41, ring_weight=1.0, pad_features=3,
        stages=(ttrain.StageSpec(depth=2, width=16, scl=1.0, epsil=1.0,
                                 adam_epochs=300, lbfgs_epochs=150),),
        log_every=300)
    lines = []
    res = ttrain.run_training(prob, spec, log_fn=lines.append, device="cpu")
    assert any("ring penalty on 1 band modes" in ln for ln in lines), lines
    assert res.rel_l2 is not None and np.isfinite(res.rel_l2)
    assert res.history[-1, 0] < res.history[0, 0]
    # the penalty is part of the loss: the same point costs more with it
    lines2 = []
    ttrain.run_training(
        prob, dataclasses.replace(
            spec, ring_weight=0.0,
            stages=(dataclasses.replace(spec.stages[0], adam_epochs=1,
                                        lbfgs_epochs=3),)),
        log_fn=lines2.append, device="cpu")
    first = lambda ls: float(next(ln for ln in ls if "initial loss" in ln)
                             .split()[-1])
    assert first(lines) > first(lines2)


# ---------------------------------------------------------------------------
# Recipes and the recipe's path end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["annulus_laplace", "poisson_1d"])
def test_recipes_equal_tpinn(name):
    from tpinn import problems as jproblems
    from tpinn.problems.recipes import RECIPES as JRECIPES

    jp, jspec = jproblems.get_recipe(name)
    tp, tspec = tproblems.get_recipe(name)
    assert tpinn_asdict(tspec) == dataclasses.asdict(jspec)
    assert field_names(tspec) == [f.name for f in dataclasses.fields(jspec)]
    jrec, trec = JRECIPES[name], tproblems.RECIPES[name]
    for f in dataclasses.fields(jrec):
        if f.name != "spec":
            assert getattr(trec, f.name) == getattr(jrec, f.name), f.name
    assert tp.hard_bc == jp.hard_bc == tproblems.HARD_BC[name]
    for field in ("name", "equation", "coords", "lb", "ub", "feature_kinds",
                  "source"):
        assert getattr(tp, field) == getattr(jp, field), field
    ac, _ = tproblems.get_recipe("allen_cahn")   # ported with marching
    assert ac.feature_kinds == ("periodic_fit", "minmax")
    with pytest.raises(KeyError, match="no recipe"):
        tproblems.get_recipe("no_such_problem")


def _cut(spec, **stage_kw):
    return dataclasses.replace(
        spec, n_col=400, n_adaptive=100, n_bd=20, grid=41, tail_max=50,
        density_every=100, plateau_every=200, log_every=1000,
        testing_size=(128,),
        stages=(dataclasses.replace(spec.stages[0], **stage_kw),))


def test_poisson_1d_recipe_polish_and_correction_end_to_end(tmp_path):
    """The poisson_1d recipe at a cut budget: the last-layer solve applies
    after both L-BFGS rounds, the final correction is the diagonal family,
    rel-L2 does not get worse, the checkpoint carries the correction and
    ``predict`` subtracts it; tpinn at the same configuration lands in
    the same accuracy class (within a factor 10: the RNG streams differ)."""
    import json

    from tpinn import problems as jproblems
    from tpinn.core import train as jtrain

    cut = dict(depth=3, width=16, adam_epochs=300, lbfgs_epochs=120,
               lbfgs_grid=200)
    prob, spec = tproblems.get_recipe("poisson_1d")
    lines = []
    res = ttrain.run_training(prob, _cut(spec, **cut),
                              output_dir=str(tmp_path), log_fn=lines.append,
                              device="cpu")
    polished = [ln for ln in lines if "lsq polish objective" in ln]
    assert len(polished) == 2 and not any("not applied" in ln
                                          for ln in polished), polished
    for ln in polished:
        pre, post = (float(ln.split()[k]) for k in (5, 7))
        assert post <= pre
    with np.load(tmp_path / "params_stage_1.npz") as raw:
        meta = json.loads(bytes(raw["__meta__"]).decode())
    defl = meta["deflation"]
    assert defl["kind"] == "modal" and defl["band"] == "full"
    assert res.rel_l2 <= defl["rel_l2_before"]
    assert res.rel_l2 < 1e-6
    # the frozen predictor is the corrected one: net minus term
    z = torch.linspace(0.05, 0.95, 19)[:, None]
    p32 = res.stages[0].params
    fm = tnet.feature_map_for(prob.feature_kinds, pad_to=3)
    raw_pred = tnet.wrap_hard_bc(
        tnet.make_predictor(tnet.spec_from_dict(meta["chain"][0]), fm,
                            torch.tensor(prob.lb), torch.tensor(prob.ub)),
        *(tpde.compile_coord_expr(e, prob.coords) for e in prob.hard_bc))
    want = raw_pred(p32, z) - tpolish.deflation_term(defl)(z)
    np.testing.assert_allclose(res.predict(z).detach().numpy(), want.numpy(),
                               rtol=0, atol=1e-6)
    err = float((res.predict(z) - torch.sin(torch.pi * z)).abs().max())
    assert err < 1e-5, err

    jprob, jspec = jproblems.get_recipe("poisson_1d")
    jres = jtrain.run_training(jprob, _cut(jspec, **cut))
    assert jres.rel_l2 < 1e-6
    assert res.rel_l2 < 10 * max(jres.rel_l2, 1e-11), (res.rel_l2, jres.rel_l2)


def test_annulus_recipe_runs_at_a_cut_budget(tmp_path):
    """The flagship recipe as written (adam_precision='default',
    lbfgs_rounds=3, lsq_polish='auto', deflation='full') at a tiny size:
    three polishes, a galerkin correction (r faces vanish, θ periodic)."""
    prob, spec = tproblems.get_recipe("annulus_laplace")
    spec = dataclasses.replace(
        spec, n_col=300, n_band=60, n_adaptive=100, n_bd=30, grid=41,
        testing_size=(31, 31), tail_max=20, density_every=100,
        plateau_every=200, log_every=1000,
        stages=(dataclasses.replace(spec.stages[0], depth=3, width=20,
                                    adam_epochs=150, lbfgs_epochs=90,
                                    lbfgs_grid=33),))
    lines = []
    before = torch.backends.cuda.matmul.allow_tf32
    res = ttrain.run_training(prob, spec, output_dir=str(tmp_path),
                              log_fn=lines.append, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 == before
    assert sum("lsq polish objective" in ln for ln in lines) == 3
    assert any("spectral correction (galerkin)" in ln for ln in lines), lines
    assert res.rel_l2 is not None and res.rel_l2 < 1e-2
    assert (tmp_path / "params_stage_1.npz").exists()
