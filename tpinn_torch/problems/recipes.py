"""Best-known training recipes per preset (port of
``tpinn.problems.recipes``, field for field).

Each recipe is the configuration with which ``tpinn`` met the preset's
accuracy gate on a TPU v5e, so

    problem, spec = problems.get_recipe("poisson_3d")
    result = train.run_training(problem, spec, device="cuda")

is the one-liner from PDE name to that configuration.

Recipe notes:
- Linear PDEs use the variable-projection loop: deterministic-grid L-BFGS
  rounds alternating with the exact float64 last-layer solve
  (``lsq_polish="auto"``, skipped for an equation nonlinear in u).
- The annulus flagship rides reduced-precision dense products through the
  Adam phase (``adam_precision="default"``, TF32 here) because the
  exact-precision L-BFGS and polish phases set the converged accuracy.
- Helmholtz k=20 trains soft-BC with lw0 ≈ 1/k⁴, random Fourier features
  and a k-continuation curriculum: stage 1 solves k=10, stage 2 warm-starts
  the same net (``init_from="prev"``) at the true k.
- The 1-D/2-D recipes close with the spectral defect correction
  (``deflation="full"``); its guards make it a no-op where it cannot help.
  ``poisson_3d`` and ``lshape_laplace`` leave it off (the correctors are
  1-D/2-D and box-shaped).
- ``pad_features=3`` is kept because the recipes are copied field for
  field; it duplicates an input column and leaves the model class as it is.
- ``march`` > 0 marks a time-marching configuration (``convection_1d``,
  ``allen_cahn``, ``wave_1d``); ``spec`` then describes ONE window, and
  the recipe runs as
  ``march.run_time_marching(problem, spec, recipe.march, device=...)``
  (tpinn_torch.core.march), not through ``run_training``.
"""

from __future__ import annotations

from dataclasses import dataclass

from tpinn_torch.core.train import StageSpec, TrainSpec


@dataclass(frozen=True)
class Recipe:
    """A preset's best-known training configuration (the fields of
    ``tpinn.problems.recipes.Recipe``)."""

    spec: TrainSpec
    hard_bc: bool                 # pose with problems.HARD_BC[name]
    # rel-L2 that tpinn measured with this configuration on a TPU v5e at
    # the full budget (its run ``run_tag``): it documents the
    # configuration's accuracy class and is no measurement of this package
    expected_rel_l2: float
    run_tag: str                  # tpinn's evidence record of that run
    provisional: bool = False     # best measured so far, not a gate result
    # > 0: a time-marching configuration with this many windows, run by
    # core.march.run_time_marching; hard_bc is False there (soft IC handoff)
    march: int = 0


def _two_stage(depth, width, adam, lbfgs, *, n_col, n_band, n_adaptive,
               n_bd, lw0, lbfgs_grid, lbfgs_rounds=1, stage2_scl=None,
               mult=1.5, sample_scale2=2.0):
    """The workhorse shape: tanh stage 1 + sin correction stage 2 with
    auto-derived (Nyquist-capped) scales, VP polish on both."""
    s1 = StageSpec(depth=depth, width=width, act_first="tanh",
                   scl=1.0, epsil=1.0, adam_epochs=adam, lbfgs_epochs=lbfgs,
                   lbfgs_grid=lbfgs_grid, lbfgs_rounds=lbfgs_rounds)
    s2 = StageSpec(depth=depth, width=width, act_first="sin",
                   scl=stage2_scl, epsil=None,
                   adam_epochs=int(adam * mult),
                   lbfgs_epochs=int(lbfgs * mult),
                   sample_scale=sample_scale2,
                   lbfgs_grid=lbfgs_grid, lbfgs_rounds=lbfgs_rounds)
    return TrainSpec(
        n_col=n_col, n_band=n_band, n_adaptive=n_adaptive, n_bd=n_bd,
        lw=(lw0, 0.0), stages=(s1, s2), lsq_polish="auto", pad_features=3, deflation="full",
    )


RECIPES = {
    # single stage 6x80, three VP rounds on a 450² grid, reduced-precision
    # Adam
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
    # single stage 5x50, two VP rounds on a 2000-point grid
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
    # two stages; nonlinear, so the correction is one Newton step of the
    # Galerkin defect
    "burgers_1d": Recipe(
        spec=_two_stage(5, 64, 10000, 4000, n_col=20000, n_band=2000,
                        n_adaptive=6000, n_bd=500, lw0=1.0, lbfgs_grid=300),
        hard_bc=True, expected_rel_l2=1.1e-6, run_tag="bN"),
    # two stages, VP polish on both, correction on top
    "poisson_2d": Recipe(
        spec=_two_stage(5, 64, 10000, 4000, n_col=20000, n_band=2000,
                        n_adaptive=6000, n_bd=500, lw0=1.0, lbfgs_grid=300),
        hard_bc=True, expected_rel_l2=1.2e-8, run_tag="pW"),
    # single-stage VP recipe (the annulus recipe's shape)
    "heat_2d": Recipe(
        spec=TrainSpec(
            n_col=20000, n_band=2000, n_adaptive=6000, n_bd=500,
            lw=(1.0, 0.0),
            stages=(StageSpec(depth=6, width=96, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=20000, lbfgs_epochs=12000,
                              lbfgs_grid=300, lbfgs_rounds=3),),
            lsq_polish="auto", pad_features=3, deflation="full",
        ),
        hard_bc=True, expected_rel_l2=7.6e-6, run_tag="tW"),
    # soft BC, Fourier features, k-continuation 10 -> 20, last-layer solve;
    # the soft-BC Chebyshev correction applies on top
    "helmholtz_2d": Recipe(
        spec=TrainSpec(
            n_col=40000, n_band=4000, n_adaptive=16000, n_bd=4000,
            lw=(1e-4, 0.0),
            stages=(
                StageSpec(depth=4, width=128, act_first="tanh",
                          scl=1.0, epsil=1.0,
                          adam_epochs=40000, lbfgs_epochs=12000,
                          lbfgs_grid=283, fourier_features=64,
                          fourier_scale=10.0,
                          equation="u_xx + u_yy + 100*u "
                                   "+ 100*sin(10*x)*sin(10*y)"),
                StageSpec(depth=4, width=128, act_first="tanh",
                          adam_epochs=60000, lbfgs_epochs=18000,
                          sample_scale=2.0, lbfgs_grid=283,
                          fourier_features=64, fourier_scale=10.0,
                          init_from="prev"),
            ),
            pad_features=3, lsq_polish="auto", deflation="full",
        ),
        hard_bc=False, expected_rel_l2=3.8e-4, run_tag="hS"),
    # 3-D cube Poisson, hard-BC ansatz + VP loop on a 24³ deterministic
    # grid; no deflation (the spectral correctors are 1-D/2-D)
    "poisson_3d": Recipe(
        spec=TrainSpec(
            n_col=4000, n_band=1000, n_adaptive=1000, n_bd=200,
            lw=(1.0, 0.0), grid=31,
            stages=(StageSpec(depth=5, width=64, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=4000, lbfgs_epochs=4000,
                              lbfgs_grid=24, lbfgs_rounds=2),),
            lsq_polish="auto", testing_size=(48, 48, 48),
        ),
        hard_bc=True, expected_rel_l2=8.9e-6, run_tag="nd1"),
    # the real nu = 0.01/pi front, plain hard-IC/BC single stage (tpinn
    # measured this one on a CPU)
    "burgers_shock": Recipe(
        spec=TrainSpec(
            n_col=4096, n_band=0, n_adaptive=2048, n_bd=256,
            lw=(1.0, 0.0), grid=111,
            stages=(StageSpec(depth=4, width=64, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=10000, lbfgs_epochs=5000),),
            pad_features=3, testing_size=(111, 111),
        ),
        hard_bc=True, expected_rel_l2=2.06e-3, run_tag="bsA"),
    # one window of an 8-window time-marching configuration
    "convection_1d": Recipe(
        spec=TrainSpec(
            n_col=4096, n_band=0, n_adaptive=1024, n_bd=512,
            lw=(1.0, 0.0), grid=101,
            stages=(StageSpec(depth=4, width=64, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=20000, lbfgs_epochs=6000),),
            pad_features=3, testing_size=(111, 111),
        ),
        hard_bc=False, expected_rel_l2=1.2e-3, run_tag="cvTM",
        march=8),
    # one window of an 8-window marching configuration with the
    # domain-fitted periodic embedding (periodic_fit: the generic engine)
    "allen_cahn": Recipe(
        spec=TrainSpec(
            n_col=4096, n_band=0, n_adaptive=1024, n_bd=512,
            lw=(1.0, 0.0), grid=111,
            stages=(StageSpec(depth=4, width=64, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=12000, lbfgs_epochs=4000),),
            pad_features=3, testing_size=(201, 101),
        ),
        hard_bc=False, expected_rel_l2=8.1e-3, run_tag="acM8",
        provisional=True, march=8),
    # one window of a 4-window Cauchy-handoff marching configuration; lw0 =
    # 0.01 keeps the residual from swamping the soft IC/edge data
    "wave_1d": Recipe(
        spec=TrainSpec(
            n_col=4096, n_band=0, n_adaptive=1024, n_bd=512,
            lw=(0.01, 0.0), grid=111,
            stages=(StageSpec(depth=4, width=64, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=20000, lbfgs_epochs=6000),),
            pad_features=3, testing_size=(111, 111),
        ),
        hard_bc=False, expected_rel_l2=2.0e-2, run_tag="wvMT4",
        provisional=True, march=4),
    # third-order dispersion through the generic jvp engine; soft IC + exact
    # edge traces
    "kdv_1d": Recipe(
        spec=TrainSpec(
            n_col=4096, n_band=0, n_adaptive=1024, n_bd=256,
            lw=(1.0, 0.0), grid=111,
            stages=(StageSpec(depth=4, width=64, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=8000, lbfgs_epochs=4000),),
            pad_features=3, testing_size=(111, 111),
        ),
        hard_bc=False, expected_rel_l2=1.2e-3, run_tag="kdA"),
    # masked non-box domain; polish and deflation do not apply
    "lshape_laplace": Recipe(
        spec=TrainSpec(
            n_col=2048, n_band=512, n_adaptive=1024, n_bd=128,
            lw=(1.0, 0.0), grid=64,
            stages=(StageSpec(depth=4, width=48, act_first="tanh",
                              scl=1.0, epsil=1.0,
                              adam_epochs=6000, lbfgs_epochs=6000),),
            pad_features=3, testing_size=(81, 81),
        ),
        hard_bc=False, expected_rel_l2=5.3e-3, run_tag="ls1"),
}
