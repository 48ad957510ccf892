"""Problem presets with analytic oracles (port of ``tpinn.problems``).

Ported so far: ``annulus_laplace``, the flagship problem, with its torch
oracle and hard-BC ansatz, and ``poisson_1d``, the 1-D problem of the
end-to-end training tests.  The other presets, ``RECIPES`` and the system
presets are ROADMAP.md Queue A item 12.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpinn_torch.core import net, sample
from tpinn_torch.core.train import ProblemSpec

__all__ = ["PRESETS", "HARD_BC", "get_problem", "with_hard_bc",
           "annulus_laplace", "poisson_1d"]

# presets of tpinn.problems that are not ported yet
_LATER = ("burgers_1d", "burgers_shock", "poisson_2d",
          "heat_2d", "helmholtz_2d", "poisson_3d", "convection_1d",
          "lshape_laplace", "allen_cahn", "wave_1d", "kdv_1d")


def annulus_laplace() -> ProblemSpec:
    """Laplace in polar coordinates on the annulus r∈[0.1,1], θ∈[0,2π),
    Dirichlet u(0.1)=1, u(1)=0.  Exact: u = log(r)/log(0.1).  θ spans the
    full circle, so the cos/sin embedding is a hard periodicity constraint
    (see tpinn.problems.annulus_laplace for why)."""
    two_pi = 2.0 * math.pi
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
        exact=lambda z: torch.sin(math.pi * z[:, 0:1]),
    )


PRESETS = {
    "annulus_laplace": annulus_laplace,
    "poisson_1d": poisson_1d,
}


def get_problem(name: str) -> ProblemSpec:
    if name in PRESETS:
        return PRESETS[name]()
    if name in _LATER:
        raise KeyError(
            f"problem {name!r} is not ported to tpinn_torch yet (ROADMAP.md "
            f"Queue A item 12); available: {sorted(PRESETS)}")
    raise KeyError(f"unknown problem {name!r}; available: {sorted(PRESETS)}")


# Hard Dirichlet ansatz (lift, bubble) per preset: u = lift + bubble·N
# meets the BC data exactly for any network output (net.wrap_hard_bc).
HARD_BC = {
    "annulus_laplace": ("(1 - r)/0.9", "(r - 0.1)*(1 - r)"),
}


def with_hard_bc(problem: ProblemSpec) -> ProblemSpec:
    """The preset posed with its hard-BC ansatz (KeyError if no recipe)."""
    return dataclasses.replace(problem, hard_bc=HARD_BC[problem.name])
