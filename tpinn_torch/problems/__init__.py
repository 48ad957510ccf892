"""Problem presets with analytic oracles (port of ``tpinn.problems``).

Every scalar preset of ``tpinn.problems``, each with a torch oracle, its
BC groups and (where ``tpinn`` has one) its hard-BC ansatz, and the
best-known training recipes (``RECIPES``, ``get_recipe``;
tpinn_torch.problems.recipes; the port's own in ``PORT_RECIPES``), so that

    problem, spec = problems.get_recipe("poisson_3d")
    result = train.run_training(problem, spec, device="cuda")

is the one-liner from PDE name to the preset's configuration.  Each
equation string goes through the symbolic compiler; problems with a
forcing use manufactured solutions, so every oracle is closed-form but
two computed on the host in float64: ``burgers_shock``'s quadrature and
``allen_cahn``'s spectral reference solve (problems.oracles).  Building a
preset does no device work.  ``convection_1d``, ``wave_1d`` and
``allen_cahn`` train by time marching (``Recipe.march``,
core.march.run_time_marching).  The coupled-system presets
(``SYSTEM_PRESETS``, ``get_system``, ``SYSTEM_RECIPES``) are in
problems.systems and train through core.system.run_system.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from tpinn_torch.core import net, pde, sample
from tpinn_torch.core.train import ProblemSpec
from tpinn_torch.problems.recipes import (PORT_RECIPES, RECIPES, Recipe,
                                         find_recipe)
from tpinn_torch.problems.systems import SYSTEM_PRESETS, get_system

__all__ = ["PRESETS", "HARD_BC", "RECIPES", "PORT_RECIPES", "Recipe",
           "SYSTEM_PRESETS",
           "get_system", "get_problem",
           "get_recipe", "with_hard_bc", "annulus_laplace", "poisson_1d",
           "burgers_1d", "burgers_shock", "poisson_2d", "heat_2d",
           "helmholtz_2d", "poisson_3d", "convection_1d", "lshape_laplace",
           "allen_cahn", "wave_1d", "kdv_1d"]

PI = math.pi


def annulus_laplace() -> ProblemSpec:
    """Laplace in polar coordinates on the annulus r∈[0.1,1], θ∈[0,2π),
    Dirichlet u(0.1)=1, u(1)=0.  Exact: u = log(r)/log(0.1).  θ spans the
    full circle, so the cos/sin embedding is a hard periodicity constraint
    (see tpinn.problems.annulus_laplace for why)."""
    two_pi = 2.0 * PI
    return ProblemSpec(
        name="annulus_laplace",
        equation="u_rr + 1/r*u_r + 1/r**2*u_tt",
        coords=("r", "t"),
        lb=(0.1, 0.0),
        ub=(1.0, two_pi),
        bc_groups=(
            sample.BCGroup(lo=(0.1, 0.0), hi=(0.1, two_pi), value=1.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, two_pi), value=0.0),
        ),
        feature_kinds=(net.MINMAX, net.PERIODIC),
        exact=lambda z: torch.log(z[:, 0:1]) / torch.log(z.new_tensor(0.1)),
    )


def poisson_1d() -> ProblemSpec:
    """−u″ = f on [0,1], u(0)=u(1)=0, manufactured u = sin(πx)."""
    return ProblemSpec(
        name="poisson_1d",
        equation="u_xx + pi**2*sin(pi*x)",
        coords=("x",),
        lb=(0.0,),
        ub=(1.0,),
        bc_groups=(
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0),
            sample.BCGroup(lo=(1.0,), hi=(1.0,), value=0.0),
        ),
        exact=lambda z: torch.sin(PI * z[:, 0:1]),
    )


def burgers_1d(nu: float = 0.01) -> ProblemSpec:
    """Viscous Burgers u_t + u·u_x = ν·u_xx on x∈[-1,1], t∈[0,1].
    Manufactured solution u = e^{-t} sin(πx) with the matching forcing, so
    the oracle stays closed-form while the residual keeps the nonlinear
    convection and mixed space-time derivatives."""
    source = (
        f"-exp(-t)*sin(pi*x) + pi*exp(-2*t)*sin(pi*x)*cos(pi*x) "
        f"+ {nu}*pi**2*exp(-t)*sin(pi*x)"
    )
    ic = pde.compile_coord_expr("sin(pi*x)", coords=("x", "t"))
    return ProblemSpec(
        name="burgers_1d",
        equation=f"u_t + u*u_x - {nu}*u_xx",
        coords=("x", "t"),
        lb=(-1.0, 0.0),
        ub=(1.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(-1.0, 0.0), hi=(1.0, 0.0), value_fn=ic,
                           value_expr="sin(pi*x)"),  # IC
            sample.BCGroup(lo=(-1.0, 0.0), hi=(-1.0, 1.0), value=0.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0), value=0.0),
        ),
        exact=lambda z: torch.exp(-z[:, 1:2]) * torch.sin(PI * z[:, 0:1]),
        source=source,
    )


_HERMGAUSS = None


def _burgers_shock_exact(z, nu: float) -> np.ndarray:
    """Cole–Hopf closed form of viscous Burgers with IC −sin(πx),
    evaluated by 96-point Gauss–Hermite quadrature (the standard oracle
    for this benchmark).  Host float64 numpy: the Cole–Hopf weight
    exp(−cos(πy)/(2πν)) reaches e^50 at ν = 0.01/π, which overflows
    float32."""
    global _HERMGAUSS
    if _HERMGAUSS is None:
        _HERMGAUSS = np.polynomial.hermite.hermgauss(96)
    xi, w = _HERMGAUSS
    z = np.asarray(z, np.float64)
    x, t = z[:, 0:1], z[:, 1:2]
    s = np.sqrt(np.maximum(4.0 * nu * t, 0.0))          # [N,1]
    y = x - s * xi[None, :]                             # [N,Q]
    expo = -np.cos(np.pi * y) / (2.0 * np.pi * nu)
    g = np.exp(expo - expo.max(axis=1, keepdims=True))  # stabilized
    num = np.sum(w * np.sin(np.pi * y) * g, axis=1, keepdims=True)
    den = np.sum(w * g, axis=1, keepdims=True)
    return -num / den


def burgers_shock(nu: Optional[float] = None) -> ProblemSpec:
    """The Burgers benchmark of Raissi et al. (2019): ν = 0.01/π,
    u(x,0) = −sin(πx), u(±1,t) = 0 — a steep front forms at x = 0 by
    t ≈ 0.3 (|u_x(0,1)| ≈ 152), unlike burgers_1d's smooth manufactured
    solution.  No forcing; the oracle is the Cole–Hopf integral by
    Gauss–Hermite quadrature (exact BCs by antisymmetry), computed on the
    host in float64 and returned on the input's device in its dtype: call
    it once per evaluation, never inside a training step."""
    if nu is None:
        nu = 0.01 / PI

    def exact(z):
        u = _burgers_shock_exact(z.detach().cpu().numpy(), nu)
        return torch.as_tensor(u, dtype=z.dtype, device=z.device)

    ic = pde.compile_coord_expr("-sin(pi*x)", coords=("x", "t"))
    return ProblemSpec(
        name="burgers_shock",
        equation=f"u_t + u*u_x - {nu}*u_xx",
        coords=("x", "t"),
        lb=(-1.0, 0.0),
        ub=(1.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(-1.0, 0.0), hi=(1.0, 0.0), value_fn=ic,
                           value_expr="-sin(pi*x)"),  # IC
            sample.BCGroup(lo=(-1.0, 0.0), hi=(-1.0, 1.0), value=0.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0), value=0.0),
        ),
        exact=exact,
    )


def poisson_2d() -> ProblemSpec:
    """Poisson on the unit square, manufactured u = sin(πx)sin(πy)."""
    return ProblemSpec(
        name="poisson_2d",
        equation="u_xx + u_yy + 2*pi**2*sin(pi*x)*sin(pi*y)",
        coords=("x", "y"),
        lb=(0.0, 0.0),
        ub=(1.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(0.0, 0.0), hi=(0.0, 1.0), value=0.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0), value=0.0),
            sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0), value=0.0),
            sample.BCGroup(lo=(0.0, 1.0), hi=(1.0, 1.0), value=0.0),
        ),
        exact=lambda z: torch.sin(PI * z[:, 0:1]) * torch.sin(PI * z[:, 1:2]),
    )


def heat_2d() -> ProblemSpec:
    """Heat equation u_t = u_xx on x∈[0,1], t∈[0,1], u(x,0)=sin(πx),
    u(0,t)=u(1,t)=0.  Exact u = e^{-π²t} sin(πx)."""
    ic = pde.compile_coord_expr("sin(pi*x)", coords=("x", "t"))
    return ProblemSpec(
        name="heat_2d",
        equation="u_t - u_xx",
        coords=("x", "t"),
        lb=(0.0, 0.0),
        ub=(1.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0), value_fn=ic,
                           value_expr="sin(pi*x)"),   # IC
            sample.BCGroup(lo=(0.0, 0.0), hi=(0.0, 1.0), value=0.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0), value=0.0),
        ),
        exact=lambda z: (torch.exp(-PI ** 2 * z[:, 1:2])
                         * torch.sin(PI * z[:, 0:1])),
    )


def helmholtz_2d(k: float = 20.0) -> ProblemSpec:
    """Helmholtz Δu + k²u = f, k=20 — the high-frequency spectral-bias
    stress test.  Manufactured u = sin(kx)sin(ky) ⇒ f = −k²·sin(kx)sin(ky);
    the Dirichlet edges carry the exact trace (compiled boundary
    expressions)."""
    k2 = k * k
    edge = lambda expr: pde.compile_coord_expr(expr, coords=("x", "y"))
    return ProblemSpec(
        name="helmholtz_2d",
        equation=f"u_xx + u_yy + {k2}*u + {k2}*sin({k}*x)*sin({k}*y)",
        coords=("x", "y"),
        lb=(0.0, 0.0),
        ub=(1.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(0.0, 0.0), hi=(0.0, 1.0), value=0.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0),
                           value_fn=edge(f"sin({k})*sin({k}*y)"),
                           value_expr=f"sin({k})*sin({k}*y)"),
            sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0), value=0.0),
            sample.BCGroup(lo=(0.0, 1.0), hi=(1.0, 1.0),
                           value_fn=edge(f"sin({k}*x)*sin({k})"),
                           value_expr=f"sin({k}*x)*sin({k})"),
        ),
        exact=lambda z: torch.sin(k * z[:, 0:1]) * torch.sin(k * z[:, 1:2]),
    )


def poisson_3d() -> ProblemSpec:
    """Poisson on the unit cube, manufactured u = sin(πx)sin(πy)sin(πz):
    the d ≥ 3 sampler and density path (sample.make_sampler_nd).
    Soft-posed with six zero-Dirichlet face groups; the recipe trains the
    hard-BC ansatz (HARD_BC below)."""
    faces = (
        ((0.0, 0.0, 0.0), (0.0, 1.0, 1.0)),
        ((1.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
        ((0.0, 0.0, 0.0), (1.0, 0.0, 1.0)),
        ((0.0, 1.0, 0.0), (1.0, 1.0, 1.0)),
        ((0.0, 0.0, 0.0), (1.0, 1.0, 0.0)),
        ((0.0, 0.0, 1.0), (1.0, 1.0, 1.0)),
    )
    return ProblemSpec(
        name="poisson_3d",
        equation=("u_xx + u_yy + u_zz "
                  "+ 3*pi**2*sin(pi*x)*sin(pi*y)*sin(pi*z)"),
        coords=("x", "y", "z"),
        lb=(0.0, 0.0, 0.0),
        ub=(1.0, 1.0, 1.0),
        bc_groups=tuple(
            sample.BCGroup(lo=lo, hi=hi, value=0.0) for lo, hi in faces
        ),
        exact=lambda z: (torch.sin(PI * z[:, 0:1])
                         * torch.sin(PI * z[:, 1:2])
                         * torch.sin(PI * z[:, 2:3])),
    )


def convection_1d(c: float = 30.0) -> ProblemSpec:
    """Convection u_t + c·u_x = 0 at c = 30 — the canonical PINN failure
    mode (Krishnapriyan et al. 2021): the residual is near-minimized by
    flattening u at later times, so plain MSE training stalls far from the
    travelling wave; its recipe is a time-marching configuration.

    Posed 2π-periodic in x via the periodic feature map (the network is
    exactly periodic, so the IC u(x,0) = sin(x) is the only data term).
    Exact u = sin(x − c·t)."""
    two_pi = 2.0 * PI
    ic = pde.compile_coord_expr("sin(x)", coords=("x", "t"))
    return ProblemSpec(
        name="convection_1d",
        equation=f"u_t + {c}*u_x",
        coords=("x", "t"),
        lb=(0.0, 0.0),
        ub=(two_pi, 1.0),
        feature_kinds=("periodic", "minmax"),
        bc_groups=(
            sample.BCGroup(lo=(0.0, 0.0), hi=(two_pi, 0.0),
                           value_fn=ic, value_expr="sin(x)"),   # IC
        ),
        exact=lambda z: torch.sin(z[:, 0:1] - c * z[:, 1:2]),
    )


_AC_EXACT = None


def _allen_cahn_exact(z: np.ndarray) -> np.ndarray:
    """The ETDRK4 spectral reference (problems.oracles) at host float64
    points, its interpolant built once per process (about a second)."""
    global _AC_EXACT
    if _AC_EXACT is None:
        from tpinn_torch.problems import oracles

        t, x, U = oracles.allen_cahn_solution()
        _AC_EXACT = oracles.grid_interpolant(t, x, U, 2.0)
    return _AC_EXACT(z)


def allen_cahn() -> ProblemSpec:
    """The Raissi et al. (2019) Allen–Cahn benchmark, a stiff
    reaction–diffusion problem:

        u_t − 1e-4·u_xx + 5u³ − 5u = 0,   x∈[−1,1], t∈[0,1]
        u(x,0) = x²cos(πx),  periodic in x

    The bistable reaction sharpens the IC into near-±1 plateaus separated
    by interface layers √γ ≈ 0.01 wide; plain space-time training fails
    here, and its recipe marches in time.  Periodicity is hard-posed by the
    domain-fitted periodic embedding (``periodic_fit``, which kernel B1
    does not take: the generic jvp engine trains it), so the IC is the only
    data term.  No closed form: the oracle is the ETDRK4 Fourier-spectral
    reference, evaluated on the host in float64 and returned on the
    input's device in its dtype (one round trip per call, never inside a
    training step)."""
    def exact(z):
        u = _allen_cahn_exact(z.detach().cpu().numpy())
        return torch.as_tensor(u, dtype=z.dtype, device=z.device)

    ic = pde.compile_coord_expr("x**2*cos(pi*x)", coords=("x", "t"))
    return ProblemSpec(
        name="allen_cahn",
        equation="u_t - 0.0001*u_xx + 5*u**3 - 5*u",
        coords=("x", "t"),
        lb=(-1.0, 0.0),
        ub=(1.0, 1.0),
        feature_kinds=(net.PERIODIC_FIT, net.MINMAX),
        bc_groups=(
            sample.BCGroup(lo=(-1.0, 0.0), hi=(1.0, 0.0), value_fn=ic,
                           value_expr="x**2*cos(pi*x)"),   # IC
        ),
        exact=exact,
    )


def wave_1d() -> ProblemSpec:
    """Second-order-in-time: the 1-D wave equation u_tt = 4u_xx on
    x∈[0,1], t∈[0,1] with the two-mode standing wave

        u = sin(πx)cos(2πt) + ½sin(4πx)cos(8πt)

    (the benchmark of Wang et al.'s causal-training paper).  Exercises
    u_tt through the derivative engine and the OPERATOR boundary condition
    (BCGroup.operator="u_t"): a well-posed wave IC pins both u(x,0) and
    u_t(x,0).  The hard-BC ansatz instead uses the bubble t²:
    u = IC(x) + t²·x(1−x)·N satisfies all four constraints exactly."""
    ic = pde.compile_coord_expr("sin(pi*x) + 0.5*sin(4*pi*x)",
                                coords=("x", "t"))
    return ProblemSpec(
        name="wave_1d",
        equation="u_tt - 4*u_xx",
        coords=("x", "t"),
        lb=(0.0, 0.0),
        ub=(1.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0), value_fn=ic,
                           value_expr="sin(pi*x) + 0.5*sin(4*pi*x)"),  # IC
            sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0), value=0.0,
                           operator="u_t"),           # velocity IC
            sample.BCGroup(lo=(0.0, 0.0), hi=(0.0, 1.0), value=0.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0), value=0.0),
        ),
        exact=lambda z: (
            torch.sin(PI * z[:, 0:1]) * torch.cos(2 * PI * z[:, 1:2])
            + 0.5 * torch.sin(4 * PI * z[:, 0:1])
            * torch.cos(8 * PI * z[:, 1:2])),
    )


def kdv_1d(c: float = 4.0, a: float = -5.0) -> ProblemSpec:
    """Korteweg–de Vries single soliton — THIRD-order dispersion:

        u_t + 6u·u_x + u_xxx = 0,   x∈[−10,10], t∈[0,1]
        u = (c/2)·sech²(√c/2·(x − ct − a))

    The order-3 term rides the nested-jvp derivative path
    (tpinn_torch.core.deriv), which no other preset reaches; the kernels
    stop at order 2.  Dirichlet data from the exact trace on both edges
    (soliton tails ≤ 7e-4 there) + the IC."""
    rc = math.sqrt(c) / 2.0

    def exact(z):
        s = rc * (z[:, 0:1] - c * z[:, 1:2] - a)
        return (c / 2.0) / torch.cosh(s) ** 2

    ic_expr = f"{c / 2.0}/cosh({rc}*(x - {a}))**2"
    ic = pde.compile_coord_expr(ic_expr, coords=("x", "t"))
    return ProblemSpec(
        name="kdv_1d",
        equation="u_t + 6*u*u_x + u_xxx",
        coords=("x", "t"),
        lb=(-10.0, 0.0),
        ub=(10.0, 1.0),
        bc_groups=(
            sample.BCGroup(lo=(-10.0, 0.0), hi=(10.0, 0.0), value_fn=ic,
                           value_expr=ic_expr),                 # IC
            sample.BCGroup(lo=(-10.0, 0.0), hi=(-10.0, 1.0), value_fn=exact),
            sample.BCGroup(lo=(10.0, 0.0), hi=(10.0, 1.0), value_fn=exact),
        ),
        exact=exact,
    )


def lshape_laplace() -> ProblemSpec:
    """Laplace on the L-shaped domain [−1,1]² ∖ (0,1]×[−1,0) — the classic
    re-entrant-corner benchmark.  Exact singular solution
    u = r^{2/3} sin(2θ/3) with θ ∈ [0, 3π/2] measured counterclockwise
    from the inner edge y=0, x>0 (the gradient blows up at the corner).

    Posed on the BOUNDING box with a 0/1 ``residual_weight`` indicator
    that removes the dead quadrant from the residual, BC groups tracing
    the true L boundary (the two inner edges carry u = 0), and
    ``eval_mask`` restricting the metric and the adaptive density to the
    real domain."""
    def _theta(z):
        th = torch.atan2(z[:, 1:2], z[:, 0:1])
        return torch.where(th < 0, th + 2 * PI, th)

    def exact(z):
        r = torch.sqrt(z[:, 0:1] ** 2 + z[:, 1:2] ** 2)
        return r ** (2.0 / 3.0) * torch.sin(2.0 * _theta(z) / 3.0)

    def inside(z):
        # 1 on the L (x <= 0 or y >= 0), 0 on the dead quadrant
        x, y = z[:, 0:1], z[:, 1:2]
        return torch.where((x <= 0.0) | (y >= 0.0), 1.0, 0.0).to(z.dtype)

    edges = (
        ((-1.0, -1.0), (-1.0, 1.0)),    # x = −1
        ((-1.0, 1.0), (1.0, 1.0)),      # y = 1
        ((1.0, 0.0), (1.0, 1.0)),       # x = 1, upper half
        ((-1.0, -1.0), (0.0, -1.0)),    # y = −1, left half
        ((0.0, -1.0), (0.0, 0.0)),      # inner edge x = 0 (u = 0)
        ((0.0, 0.0), (1.0, 0.0)),       # inner edge y = 0 (u = 0)
    )
    return ProblemSpec(
        name="lshape_laplace",
        equation="u_xx + u_yy",
        coords=("x", "y"),
        lb=(-1.0, -1.0),
        ub=(1.0, 1.0),
        bc_groups=tuple(
            sample.BCGroup(lo=lo, hi=hi, value_fn=exact) for lo, hi in edges
        ),
        exact=exact,
        residual_weight=inside,
        eval_mask=inside,
    )


PRESETS = {
    "annulus_laplace": annulus_laplace,
    "poisson_1d": poisson_1d,
    "burgers_1d": burgers_1d,
    "burgers_shock": burgers_shock,
    "poisson_2d": poisson_2d,
    "heat_2d": heat_2d,
    "helmholtz_2d": helmholtz_2d,
    "poisson_3d": poisson_3d,
    "convection_1d": convection_1d,
    "lshape_laplace": lshape_laplace,
    "allen_cahn": allen_cahn,
    "wave_1d": wave_1d,
    "kdv_1d": kdv_1d,
}


def get_problem(name: str) -> ProblemSpec:
    if name in PRESETS:
        return PRESETS[name]()
    raise KeyError(f"unknown problem {name!r}; available: {sorted(PRESETS)}")


# Hard Dirichlet ansatz (lift, bubble) per preset: u = lift + bubble·N
# meets the BC/IC data exactly for any network output (net.wrap_hard_bc).
# The lift interpolates the boundary data (transfinite blending for
# non-constant traces); the bubble vanishes on the constrained boundary.
_K = 20.0  # helmholtz_2d default wavenumber


def _helmholtz_hard(k: float = _K):
    lift = (f"x*sin({k})*sin({k}*y) + y*sin({k}*x)*sin({k}) "
            f"- x*y*sin({k})*sin({k})")
    return (lift, "x*(1 - x)*y*(1 - y)")


HARD_BC = {
    "annulus_laplace": ("(1 - r)/0.9", "(r - 0.1)*(1 - r)"),
    "poisson_1d": ("0", "x*(1 - x)"),
    "burgers_1d": ("sin(pi*x)", "t*(1 - x**2)"),
    "burgers_shock": ("-sin(pi*x)", "t*(1 - x**2)"),
    "poisson_2d": ("0", "x*(1 - x)*y*(1 - y)"),
    "heat_2d": ("sin(pi*x)", "t*x*(1 - x)"),
    "helmholtz_2d": _helmholtz_hard(),
    "poisson_3d": ("0", "x*(1 - x)*y*(1 - y)*z*(1 - z)"),
    # hard IC only — x is handled by the periodic feature map
    "convection_1d": ("sin(x)", "t"),
    "allen_cahn": ("x**2*cos(pi*x)", "t"),
    # the t² bubble pins u(x,0) AND u_t(x,0); x(1−x) the edges
    "wave_1d": ("sin(pi*x) + 0.5*sin(4*pi*x)", "t**2*x*(1 - x)"),
}


def with_hard_bc(problem: ProblemSpec) -> ProblemSpec:
    """The preset posed with its hard-BC ansatz (KeyError if it has none)."""
    return dataclasses.replace(problem, hard_bc=HARD_BC[problem.name])


def get_recipe(name: str):
    """(ProblemSpec, TrainSpec) of the preset's best-known configuration,
    or of one of the port's own recipes (``PORT_RECIPES``)."""
    preset, rec = find_recipe(name)
    problem = get_problem(preset)
    if rec.hard_bc:
        problem = with_hard_bc(problem)
    return problem, rec.spec
