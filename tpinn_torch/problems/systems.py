"""Coupled-system benchmark presets (port of ``tpinn.problems.systems``).

The presets exercise ``core.system.run_system`` on named CFD benchmarks
with analytic or reference solutions, each with torch oracles and its
field-tagged BC groups:

- ``kovasznay``: steady incompressible Navier–Stokes, the Kovasznay
  laminar wake (Kovasznay 1948), three fields (u, v, p) in (x, y);
- ``taylor_green``: the decaying 2-D Taylor–Green vortex in (x, y, t);
- ``schrodinger``: the Raissi et al. (2019) nonlinear Schrödinger bound
  state as the 2-field real system h = u + iv, its oracle a split-step
  Fourier solve on the host (problems.oracles).

``SYSTEM_RECIPES`` holds the CLI-level knobs of each preset's measured
configuration, copied from tpinn field for field: its
``expected_rel_l2`` and ``run_tag`` are tpinn's TPU v5e records (or its
CPU evidence where it says so), not measurements of this port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpinn_torch.core import sample
from tpinn_torch.core.system import SystemSpec

__all__ = ["SYSTEM_PRESETS", "SYSTEM_RECIPES", "get_system", "kovasznay",
           "taylor_green", "schrodinger"]


def kovasznay(re: float = 40.0) -> SystemSpec:
    """Steady Navier–Stokes Kovasznay flow at Reynolds number ``re``:

        λ = Re/2 − sqrt(Re²/4 + 4π²)
        u = 1 − e^{λx} cos(2πy)
        v = (λ/2π) e^{λx} sin(2πy)
        p = (1 − e^{2λx})/2

    solving (u·∇)u + ∇p − ν∆u = 0, ∇·u = 0 with ν = 1/Re on [−0.5, 1.0]
    × [−0.5, 1.5].  Dirichlet u and v on all four edges from the exact
    solution; p is pinned on the inflow edge x = −0.5 only (the momentum
    equations fix the pressure up to a constant)."""
    nu = 1.0 / re
    lam = re / 2.0 - math.sqrt(re * re / 4.0 + 4.0 * math.pi ** 2)
    two_pi = 2.0 * math.pi

    def u_fn(z):
        return 1.0 - torch.exp(lam * z[:, 0:1]) * torch.cos(two_pi * z[:, 1:2])

    def v_fn(z):
        return (lam / two_pi) * torch.exp(lam * z[:, 0:1]) * torch.sin(
            two_pi * z[:, 1:2])

    def p_fn(z):
        return 0.5 * (1.0 - torch.exp(2.0 * lam * z[:, 0:1]))

    def exact(z):
        return torch.cat([u_fn(z), v_fn(z), p_fn(z)], dim=1)

    lb, ub = (-0.5, -0.5), (1.0, 1.5)
    edges = (
        ((lb[0], lb[1]), (lb[0], ub[1])),   # x = -0.5 (inflow)
        ((ub[0], lb[1]), (ub[0], ub[1])),   # x = 1.0
        ((lb[0], lb[1]), (ub[0], lb[1])),   # y = -0.5
        ((lb[0], ub[1]), (ub[0], ub[1])),   # y = 1.5
    )
    groups = []
    for fi, fn in ((0, u_fn), (1, v_fn)):
        for lo, hi in edges:
            groups.append(sample.BCGroup(lo=lo, hi=hi, value_fn=fn, field=fi))
    groups.append(sample.BCGroup(lo=edges[0][0], hi=edges[0][1],
                                 value_fn=p_fn, field=2))

    return SystemSpec(
        name=f"kovasznay_re{re:g}",
        equations=(
            f"u*u_x + v*u_y + p_x - {nu}*(u_xx + u_yy)",
            f"u*v_x + v*v_y + p_y - {nu}*(v_xx + v_yy)",
            "u_x + v_y",
        ),
        fields=("u", "v", "p"),
        coords=("x", "y"),
        lb=lb, ub=ub,
        bc_groups=tuple(groups),
        exact=exact,
    )


def taylor_green(nu: float = 0.1, t_final: float = 1.0) -> SystemSpec:
    """Unsteady incompressible Navier–Stokes: the 2-D decaying
    Taylor–Green vortex,

        u = −cos x · sin y · e^{−2νt}
        v =  sin x · cos y · e^{−2νt}
        p = −(cos 2x + cos 2y)/4 · e^{−4νt}

    on [0, π]² × [0, t_final], Dirichlet u, v from the exact trace on the
    four spatial faces and the initial condition, p anchored on the x = 0
    face.  Three coordinates (x, y, t): time is one more sampled axis."""
    pi = math.pi

    def u_fn(z):
        return (-torch.cos(z[:, 0:1]) * torch.sin(z[:, 1:2])
                * torch.exp(-2.0 * nu * z[:, 2:3]))

    def v_fn(z):
        return (torch.sin(z[:, 0:1]) * torch.cos(z[:, 1:2])
                * torch.exp(-2.0 * nu * z[:, 2:3]))

    def p_fn(z):
        return (-0.25 * (torch.cos(2.0 * z[:, 0:1])
                         + torch.cos(2.0 * z[:, 1:2]))
                * torch.exp(-4.0 * nu * z[:, 2:3]))

    def exact(z):
        return torch.cat([u_fn(z), v_fn(z), p_fn(z)], dim=1)

    lb, ub = (0.0, 0.0, 0.0), (pi, pi, t_final)
    faces = (
        ((0.0, 0.0, 0.0), (0.0, pi, t_final)),     # x = 0
        ((pi, 0.0, 0.0), (pi, pi, t_final)),       # x = π
        ((0.0, 0.0, 0.0), (pi, 0.0, t_final)),     # y = 0
        ((0.0, pi, 0.0), (pi, pi, t_final)),       # y = π
        ((0.0, 0.0, 0.0), (pi, pi, 0.0)),          # t = 0 (IC)
    )
    groups = []
    for fi, fn in ((0, u_fn), (1, v_fn)):
        for lo, hi in faces:
            groups.append(sample.BCGroup(lo=lo, hi=hi, value_fn=fn, field=fi))
    groups.append(sample.BCGroup(lo=faces[0][0], hi=faces[0][1],
                                 value_fn=p_fn, field=2))

    return SystemSpec(
        name=f"taylor_green_nu{nu:g}",
        equations=(
            f"u_t + u*u_x + v*u_y + p_x - {nu}*(u_xx + u_yy)",
            f"v_t + u*v_x + v*v_y + p_y - {nu}*(v_xx + v_yy)",
            "u_x + v_y",
        ),
        fields=("u", "v", "p"),
        coords=("x", "y", "t"),
        lb=lb, ub=ub,
        bc_groups=tuple(groups),
        exact=exact,
    )


_NLS_EXACT = None


def _nls_oracle(z) -> np.ndarray:
    """The split-step Fourier reference (problems.oracles) at the points
    ``z`` (a tensor on any device, or an array): ``[N, 2]`` float64 numpy
    columns (Re h, Im h), evaluated on the host.  The interpolants are
    built once per process (about 5 s)."""
    global _NLS_EXACT
    if _NLS_EXACT is None:
        from tpinn_torch.problems import oracles

        t, x, H = oracles.nls_solution()
        _NLS_EXACT = (oracles.grid_interpolant(t, x, H.real, 10.0),
                      oracles.grid_interpolant(t, x, H.imag, 10.0))
    if isinstance(z, torch.Tensor):
        z = z.detach().cpu().numpy()
    fr, fi = _NLS_EXACT
    return np.concatenate([fr(z), fi(z)], axis=1)


def schrodinger() -> SystemSpec:
    """The Raissi et al. (2019) nonlinear Schrödinger benchmark:

        i·h_t + ½·h_xx + |h|²·h = 0,   x∈[−5,5], t∈[0,π/2]
        h(x,0) = 2·sech(x),  periodic in x

    posed as the equivalent 2-field real system over h = u + iv:

        u_t + ½·v_xx + (u² + v²)·v = 0        (imaginary part)
        v_t − ½·u_xx − (u² + v²)·u = 0        (−1 × real part)

    The IC is the Satsuma–Yajima N=2 soliton bound state.  Periodicity is
    hard-posed by the domain-fitted periodic embedding (``periodic_fit``),
    so the two ICs are the only data terms.  The oracle returns numpy
    (see ``_nls_oracle``)."""
    t_final = 0.5 * math.pi

    def ic_u(z):
        return 2.0 / torch.cosh(z[:, 0:1])

    return SystemSpec(
        name="schrodinger",
        equations=(
            "u_t + 0.5*v_xx + (u**2 + v**2)*v",
            "v_t - 0.5*u_xx - (u**2 + v**2)*u",
        ),
        fields=("u", "v"),
        coords=("x", "t"),
        lb=(-5.0, 0.0),
        ub=(5.0, t_final),
        feature_kinds=("periodic_fit", "minmax"),
        bc_groups=(
            sample.BCGroup(lo=(-5.0, 0.0), hi=(5.0, 0.0), value_fn=ic_u,
                           value_expr="2/cosh(x)", field=0),    # Re IC
            sample.BCGroup(lo=(-5.0, 0.0), hi=(5.0, 0.0), value=0.0,
                           field=1),                            # Im IC
        ),
        exact=_nls_oracle,
    )


SYSTEM_PRESETS = {
    "kovasznay": kovasznay,
    "taylor_green": taylor_green,
    "schrodinger": schrodinger,
}


def get_system(name: str) -> SystemSpec:
    try:
        return SYSTEM_PRESETS[name]()
    except KeyError:
        raise KeyError(f"unknown system preset {name!r}; "
                       f"available: {sorted(SYSTEM_PRESETS)}")


# The measured configurations of tpinn (its CLI builds one TrainSpec stage
# from them: `tpinn system --name X --recipe`).  The expected_rel_l2 pins
# and run tags are tpinn's records on a TPU v5e (or its CPU evidence where
# the tag says so).
SYSTEM_RECIPES = {
    # kv1 (TPU v5e): aggregate 3.67e-4 — u 2.5e-4, v 1.8e-3, p 8.7e-4
    # (pressure pinned on one edge only)
    "kovasznay": {
        "adam": 12000, "lbfgs": 8000, "depth": 5, "width": 64,
        "n_col": 8000, "n_adaptive": 2000, "n_bd": 400,
        "expected_rel_l2": 3.7e-4, "run_tag": "kv1",
    },
    # tg1 queued in tpinn; its CPU evidence: u 7.2e-4, v 8.1e-4, p 6.6e-3
    # at 6k+5k
    "taylor_green": {
        "adam": 10000, "lbfgs": 8000, "depth": 5, "width": 64,
        "n_col": 8000, "n_adaptive": 2000, "n_bd": 300,
        "expected_rel_l2": 8e-4, "run_tag": "tg1(queued); CPU r4",
    },
    # sch1 (TPU v5e): aggregate 1.28e-2 — u 1.0e-2, v 1.6e-2 on the
    # Satsuma-Yajima focusing bound state
    "schrodinger": {
        "adam": 20000, "lbfgs": 8000, "depth": 5, "width": 96,
        "n_col": 8192, "n_adaptive": 2048, "n_bd": 512,
        "expected_rel_l2": 1.3e-2, "run_tag": "sch1",
    },
}
