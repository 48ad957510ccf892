"""Problem presets with analytic oracles (port of ``tpinn.problems``).

Ported so far: ``annulus_laplace``, the flagship problem, with its torch
oracle and hard-BC ansatz, and ``poisson_1d``, the 1-D problem of the
end-to-end training tests; and their best-known training recipes
(``RECIPES``, ``get_recipe``), so that

    problem, spec = problems.get_recipe("annulus_laplace")
    result = train.run_training(problem, spec, device="cuda")

is the one-liner from PDE name to the flagship configuration.  The other
presets and recipes and the system presets are ROADMAP.md Queue A item 12.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpinn_torch.core import net, sample
from tpinn_torch.core.train import ProblemSpec, StageSpec, TrainSpec

__all__ = ["PRESETS", "HARD_BC", "RECIPES", "Recipe", "get_problem",
           "get_recipe", "with_hard_bc", "annulus_laplace", "poisson_1d"]

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
    "poisson_1d": ("0", "x*(1 - x)"),
}


def with_hard_bc(problem: ProblemSpec) -> ProblemSpec:
    """The preset posed with its hard-BC ansatz (KeyError if no recipe)."""
    return dataclasses.replace(problem, hard_bc=HARD_BC[problem.name])


@dataclasses.dataclass(frozen=True)
class Recipe:
    """A preset's best-known training configuration (the fields of
    ``tpinn.problems.recipes.Recipe``)."""

    spec: TrainSpec
    hard_bc: bool                 # pose with HARD_BC[name]
    # rel-L2 that tpinn measured with this configuration on a TPU v5e at
    # the full budget (its run ``run_tag``).  The H100 has yet to reproduce
    # it at full budget: it documents the configuration's accuracy class
    # and is no measurement of this package.
    expected_rel_l2: float
    run_tag: str                  # tpinn's evidence record of that run
    provisional: bool = False     # best measured so far, not a gate result
    march: int = 0                # > 0: a time-marching config (not ported)


# The configurations of tpinn.problems.recipes.RECIPES, field for field.
# Linear PDEs use the variable-projection loop: deterministic-grid L-BFGS
# rounds alternating with the exact float64 last-layer solve
# (lsq_polish="auto"), and close with the spectral defect correction
# (deflation="full"); the annulus rides reduced-precision dense products
# through the Adam phase (adam_precision="default", TF32 here) because the
# exact-precision L-BFGS and polish phases set the converged accuracy.
RECIPES = {
    "annulus_laplace": Recipe(
        spec=TrainSpec(
            n_col=30000, n_band=5000, n_adaptive=10000, n_bd=500,
            lw=(0.05, 0.0),
            stages=(StageSpec(depth=6, width=80, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=8000, lbfgs_epochs=8000,
                              lbfgs_grid=450, lbfgs_rounds=3),),
            lsq_polish="auto", adam_precision="default", deflation="full",
        ),
        hard_bc=True, expected_rel_l2=1.7e-7, run_tag="eN"),
    "poisson_1d": Recipe(
        spec=TrainSpec(
            n_col=8000, n_band=0, n_adaptive=1000, n_bd=200,
            lw=(1.0, 0.0),
            stages=(StageSpec(depth=5, width=50, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=6000, lbfgs_epochs=5000,
                              lbfgs_grid=2000, lbfgs_rounds=2),),
            lsq_polish="auto", pad_features=3, testing_size=(256,),
            deflation="full",
        ),
        hard_bc=True, expected_rel_l2=2.5e-12, run_tag="p1W"),
}


def get_recipe(name: str):
    """(ProblemSpec, TrainSpec) of the preset's best-known configuration."""
    if name not in RECIPES:
        later = (" (not ported to tpinn_torch yet, ROADMAP.md Queue A item "
                 "12)" if name in _LATER else "")
        raise KeyError(f"no recipe for {name!r}{later}; available: "
                       f"{sorted(RECIPES)}")
    rec = RECIPES[name]
    problem = get_problem(name)
    if rec.hard_bc:
        problem = with_hard_bc(problem)
    return problem, rec.spec
