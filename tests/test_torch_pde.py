"""tpinn_torch.core.pde against tpinn.core.pde: grammar, compile, evaluate.

Both compilers get the same strings; evaluation gets the same numpy
u-parts and points.  Tolerance for expression values in f32 on the CPU:
rtol 1e-5, atol 1e-6 (pointwise arithmetic only, no reductions); for
residuals through the derivative engines rtol 1e-4, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.core import pde as jpde
from tpinn_torch.core import pde as tpde

# the corpus of tests/test_pde.py, plus equations of the presets
VALID = [
    ("u_xx + u_yy", ("x", "y")),
    ("u_rr + 1/r*u_r + 1/r**2*u_tt", ("r", "t")),
    ("2*u_x - 0.5*u", ("x", "y")),
    ("(u_x + u_y) * 3.0", ("x", "y")),
    ("u_xx+u_yy-1", ("x", "y")),
    ("x*y*u", ("x", "y")),
    ("u_x/2 + .5*u", ("x", "y")),
    ("3**2 * u_x", ("x", "y")),
    ("u_t + u*u_x - 0.01*u_xx = 0", ("x", "t")),
    ("u_xx + sin(pi*x)", ("x",)),
    ("-u_xx + 2", ("x",)),
    ("u_xx = -(pi**2)*sin(pi*x)", ("x",)),
    ("u_t - 0.0001*u_xx + 5*u**3 - 5*u", ("x", "t")),
    ("u_t + 6*u*u_x + u_xxx", ("x", "t")),
    ("u_xy + exp(x)*u - sqrt(abs(y))*u_yy", ("x", "y")),
    ("u_xx + u_yy + u_zz + 3*pi**2*sin(pi*x)*sin(pi*y)*sin(pi*z)",
     ("x", "y", "z")),
    ("tanh(x)*u_x + cosh(y)/sinh(1 + y)*u - log(2 + x)*tan(y)*u_y",
     ("x", "y")),
]

INVALID = [
    ("u_x+", ("x", "y")),
    ("u_q", ("x", "y")),
    ("foo + u", ("x", "y")),
    ("u_x + @", ("x", "y")),
    ("(u_x", ("x", "y")),
    ("u_ab + u_x", ("x", "y")),
    ("u_x + (", ("x",)),
    ("", ("x",)),
    ("a = b = c", ("x",)),
    ("u_x )", ("x",)),
]


@pytest.mark.parametrize("expr,coords", VALID)
def test_valid_corpus_compiles_alike(expr, coords):
    cj = jpde.compile_pde(expr, coords)
    ct = tpde.compile_pde(expr, coords)
    assert ct.indices == cj.indices
    assert ct.max_order == cj.max_order
    assert ct.is_linear == cj.is_linear
    assert tpde.validate_equation(expr, coords)


@pytest.mark.parametrize("expr,coords", INVALID)
def test_invalid_corpus_raises_alike(expr, coords):
    with pytest.raises(jpde.PDESyntaxError) as ej:
        jpde.parse(expr, coords)
    with pytest.raises(tpde.PDESyntaxError) as et:
        tpde.parse(expr, coords)
    assert str(et.value) == str(ej.value)
    assert issubclass(tpde.PDESyntaxError, ValueError)
    if expr:
        assert not tpde.validate_equation(expr, coords)


def test_param_and_field_collisions_raise_alike():
    for kw in (dict(params=("x",)), dict(params=("pi",))):
        with pytest.raises(jpde.PDESyntaxError):
            jpde.parse("u_x", ("x",), **kw)
        with pytest.raises(tpde.PDESyntaxError):
            tpde.parse("u_x", ("x",), **kw)


@pytest.mark.parametrize("expr,coords", VALID)
def test_evaluate_on_identical_parts(expr, coords):
    """The AST on the same u-parts and points gives the same residual."""
    rng = np.random.default_rng(7)
    d = len(coords)
    z = rng.uniform(0.3, 1.7, (64, d)).astype(np.float32)
    cj = jpde.compile_pde(expr, coords)
    ct = tpde.compile_pde(expr, coords)
    parts = {ix: rng.normal(0, 1, (64, 1)).astype(np.float32)
             for ix in cj.indices}
    want = np.asarray(cj.evaluate(jnp.asarray(z),
                                  {k: jnp.asarray(v) for k, v in parts.items()}))
    got = ct.evaluate(torch.from_numpy(z),
                      {k: torch.from_numpy(v) for k, v in parts.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_param_coefficients():
    ct = tpde.compile_pde("u_t - lam*u_xx", ("x", "t"), params=("lam",))
    z = torch.rand(10, 2)
    parts = {(1,): torch.ones(10, 1), (0, 0): torch.full((10, 1), 2.0)}
    np.testing.assert_allclose(
        ct.evaluate(z, parts, coef={"lam": 0.25}).numpy(), 0.5, rtol=1e-6)
    with pytest.raises(KeyError, match="lam"):
        ct.evaluate(z, parts)


def test_residual_generic_engine_matches_jax():
    """compiled.residual through each package's jvp engine on the same
    closed-form field."""
    rng = np.random.default_rng(3)
    z = rng.uniform(0.2, 1.0, (64, 2)).astype(np.float32)
    eq = "u_rr + 1/r*u_r + 1/r**2*u_tt + u*u_rt"
    fj = lambda zz: jnp.log(zz[:, 0:1]) + 0.1 * jnp.sin(3 * zz[:, 1:2]) * zz[:, 0:1]
    ft = lambda zz: torch.log(zz[:, 0:1]) + 0.1 * torch.sin(3 * zz[:, 1:2]) * zz[:, 0:1]
    want = np.asarray(jpde.compile_pde(eq, ("r", "t")).residual(fj, jnp.asarray(z)))
    got = tpde.compile_pde(eq, ("r", "t")).residual(ft, torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("expr,coords", [
    ("sin(pi*x)*2", ("x",)),
    ("(1 - r)/0.9", ("r", "t")),
    ("(r - 0.1)*(1 - r)", ("r", "t")),
    ("0", ("x", "t")),
    ("x**2*cos(pi*x) + e*t", ("x", "t")),
])
def test_compile_coord_expr_matches_jax(expr, coords):
    rng = np.random.default_rng(11)
    z = rng.uniform(0.0, 1.0, (33, len(coords))).astype(np.float32)
    want = np.asarray(jpde.compile_coord_expr(expr, coords)(jnp.asarray(z)))
    got = tpde.compile_coord_expr(expr, coords)(torch.from_numpy(z))
    assert tuple(got.shape) == (33, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    with pytest.raises(tpde.PDESyntaxError):
        tpde.compile_coord_expr("u_x + 1", ("x",))


def test_infer_coords_matches_jax():
    for eq in ("u_rr + 1/r*u_r + 1/r**2*u_tt", "u_xx + u_yy",
               "u_t + u*u_x - 0.01*u_xx", "u_xx + sin(pi*x)",
               "u_xx + exp(u)"):
        assert tpde.infer_coords(eq) == jpde.infer_coords(eq)
    with pytest.raises(tpde.PDESyntaxError):
        tpde.infer_coords("u_rr + u_xx")
