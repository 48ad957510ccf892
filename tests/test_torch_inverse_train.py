"""Scalar inverse identification end to end in tpinn_torch, on the CPU.

The run cases of tests/test_inverse.py and tests/test_bc_operators.py's
unknown Robin coefficient, at their own sizes, seeds and bars, through
``tpinn_torch.core.inverse.run_inverse(..., device="cpu")`` (the residual
through B1's plain version).  The two packages' random streams differ by
design (torch generators against JAX keys), so trajectories are not
compared across packages: each run is held to tpinn's bar.  Every case
passes at tpinn's default seed.  Checkpoints, records and artifacts
against tpinn's are in test_torch_inverse.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpinn_torch.core import sample
from tpinn_torch.core.inverse import (InverseSpec, run_inverse,
                                      synth_observations)
from tpinn_torch.core.train import ProblemSpec, StageSpec, TrainSpec

PI = np.pi


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny nets: one intra-op thread is as fast as eight alone, and many
    times faster when several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _poisson_inverse_problem():
    return ProblemSpec(
        name="poisson_1d_inverse",
        equation="lam*u_xx + sin(pi*x)",
        coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(),
        exact=lambda z: torch.sin(PI * z[:, :1]),
        hard_bc=("0", "x*(1-x)"),
    )


def _poisson_spec(n_col, n_adaptive, adam, lbfgs, n_bd=16):
    return TrainSpec(
        n_col=n_col, n_band=0, n_adaptive=n_adaptive, n_bd=n_bd,
        stages=(StageSpec(depth=3, width=16, adam_epochs=adam,
                          lbfgs_epochs=lbfgs),),
        grid=64, lw=(1.0, 0.0), testing_size=(201,), pad_features=3,
        log_every=200)


def test_recover_poisson_coefficient():
    # -d/dx(lam u_xx) = f with u = sin(pi x): true lam = 1/pi^2
    inv = InverseSpec(params=("lam",), init=(0.5,), n_obs=50)
    lines = []
    r = run_inverse(_poisson_inverse_problem(), inv,
                    _poisson_spec(256, 64, 400, 150), log_fn=lines.append,
                    device="cpu")
    true = 1.0 / PI ** 2
    assert abs(r.coef["lam"] - true) / true < 5e-3
    assert r.rel_l2 < 5e-3
    # L-BFGS sharpened the Adam estimate
    assert abs(r.coef["lam"] - true) <= abs(r.coef_adam["lam"] - true)
    # history carries both phases with the widened loss_info (obs column)
    assert r.history.shape[1] == 3 + 0 + 1 + 1
    assert isinstance(r.coef["lam"], float)
    assert isinstance(r.coef_adam["lam"], float)
    assert set(r.params) == {"net", "coef"}
    assert r.z_obs.shape == (50, 1) and r.u_obs.shape == (50, 1)
    assert any(ln.startswith("inverse: 1 coefficient(s)") for ln in lines)
    assert any(ln.startswith("inverse: after L-BFGS lam=") for ln in lines)


def test_recover_heat_diffusivity():
    # u_t = lam*u_xx with u = exp(-pi^2 t) sin(pi x): true lam = 1; soft
    # Dirichlet sides + the initial condition as a value_fn BC group
    prob = ProblemSpec(
        name="heat_inverse",
        equation="u_t - lam*u_xx",
        coords=("x", "t"), lb=(0.0, 0.0), ub=(1.0, 0.5),
        bc_groups=(
            sample.BCGroup(lo=(0.0, 0.0), hi=(0.0, 0.5), value=0.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 0.5), value=0.0),
            sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0),
                           value_fn=lambda z: torch.sin(PI * z[:, :1])),
        ),
        exact=lambda z: (torch.exp(-PI ** 2 * z[:, 1:2])
                         * torch.sin(PI * z[:, :1])),
    )
    inv = InverseSpec(params=("lam",), init=(0.3,), n_obs=120)
    spec = TrainSpec(
        n_col=384, n_band=0, n_adaptive=128, n_bd=32,
        stages=(StageSpec(depth=3, width=24,
                          adam_epochs=800, lbfgs_epochs=2400),),
        grid=48, lw=(1.0, 0.0), testing_size=(64, 64), pad_features=3,
        log_every=400,
    )
    r = run_inverse(prob, inv, spec, device="cpu")
    assert abs(r.coef["lam"] - 1.0) < 1e-2
    assert r.rel_l2 < 1e-2
    assert r.history.shape[1] == 3 + 3 + 1 + 1


def test_noisy_observations_still_identify():
    inv = InverseSpec(params=("lam",), init=(0.5,), n_obs=80,
                      obs_noise=1e-3)
    r = run_inverse(_poisson_inverse_problem(), inv,
                    _poisson_spec(256, 64, 300, 120), device="cpu")
    true = 1.0 / PI ** 2
    assert abs(r.coef["lam"] - true) / true < 5e-2
    # the labels carry the noise: they are not the oracle's
    clean = np.sin(PI * r.z_obs)
    assert 0.0 < float(np.abs(r.u_obs - clean).max()) < 1e-2


def test_user_supplied_observations():
    prob = _poisson_inverse_problem()
    inv = InverseSpec(params=("lam",), init=(0.2,), n_obs=40)
    z_obs, u_obs = synth_observations(prob, inv, torch.float32)
    r = run_inverse(prob, inv, _poisson_spec(192, 0, 250, 90),
                    observations=(z_obs, u_obs[:, 0].numpy()), device="cpu")
    np.testing.assert_array_equal(r.z_obs, z_obs.numpy())
    np.testing.assert_array_equal(r.u_obs, u_obs.numpy())
    true = 1.0 / PI ** 2
    assert abs(r.coef["lam"] - true) / true < 2e-2


def test_unknown_robin_coefficient():
    # u = sin(pi x) on [0, 1/2]; Robin at x=1/2: u_x + k*u = 0 + k*1 = k,
    # target 2.0 → the unknown transfer coefficient k has true value 2
    prob = ProblemSpec(
        name="robin_inverse",
        equation="u_xx + pi**2*sin(pi*x)",
        coords=("x",), lb=(0.0,), ub=(0.5,),
        bc_groups=(
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0),
            sample.BCGroup(lo=(0.5,), hi=(0.5,), value=2.0,
                           operator="u_x + k*u"),
        ),
        exact=lambda z: torch.sin(PI * z[:, :1]),
    )
    inv = InverseSpec(params=("k",), init=(0.5,), n_obs=80)
    spec = TrainSpec(
        n_col=256, n_band=0, n_adaptive=0, n_bd=32,
        stages=(StageSpec(depth=3, width=20, scl=1.0, epsil=1.0,
                          adam_epochs=600, lbfgs_epochs=1500),),
        grid=64, lw=(1.0, 0.0), testing_size=(201,), pad_features=3,
        tail_max=4000, log_every=250)
    r = run_inverse(prob, inv, spec, device="cpu")
    assert abs(r.coef["k"] - 2.0) < 2e-2
    assert r.rel_l2 < 1e-3


def _eigen_problem_1d():
    return ProblemSpec(
        name="dirichlet_eigen", equation="u_xx + lam*u", coords=("x",),
        lb=(0.0,), ub=(1.0,),
        bc_groups=(
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0),
            sample.BCGroup(lo=(1.0,), hi=(1.0,), value=0.0),
        ),
        exact=lambda z: torch.sin(PI * z),   # mean u² = 1/2 matches the pin
    )


def _eigen_check(r, mode, lam_bar, corr_bar):
    lam = r.coef["lam"]
    true = (mode * PI) ** 2
    assert abs(lam - true) / true < lam_bar, lam
    # eigenfunction up to sign: normalized correlation with sin(mode pi x)
    z = torch.linspace(0.0, 1.0, 201)[:, None]
    with torch.no_grad():
        u = r.predict(z)[:, 0].numpy()
    s = np.sin(mode * PI * z[:, 0].numpy())
    corr = abs(float(np.dot(u, s))) / (
        np.linalg.norm(u) * np.linalg.norm(s) + 1e-30)
    assert corr > corr_bar, corr
    return u


def test_eigen_ground_state():
    """-u'' = lam u, u(0)=u(1)=0: with the mean-square pin replacing
    observations, the joint optimization lands the ground eigenpair —
    lam -> pi^2 and u -> sin(pi x) up to sign."""
    inv = InverseSpec(params=("lam",), init=(8.0,), n_obs=128,
                      normalize=0.5, obs_weight=10.0)
    spec = TrainSpec(
        n_col=256, n_band=0, n_adaptive=0, n_bd=32,
        stages=(StageSpec(depth=3, width=24,
                          adam_epochs=1500, lbfgs_epochs=1500),),
        grid=64, lw=(1.0, 0.0), testing_size=(101,), pad_features=3,
        log_every=500,
    )
    lines = []
    r = run_inverse(_eigen_problem_1d(), inv, spec, log_fn=lines.append,
                    device="cpu")
    u = _eigen_check(r, 1, 1e-2, 0.999)
    # the amplitude pin held: mean u^2 ~ normalize
    assert abs(float(np.mean(u * u)) - 0.5) < 0.05
    # sign-free rel-L2 against the oracle, the fixed unlabelled points
    assert r.rel_l2 is not None and r.rel_l2 < 5e-2
    assert not r.u_obs.any() and r.z_obs.shape == (128, 1)
    assert any("eigen mode" in ln for ln in lines)


@pytest.mark.slow
def test_eigen_second_mode():
    """Initializing lam near 4 pi^2 selects the second eigenpair — the
    identification is local in the spectrum."""
    inv = InverseSpec(params=("lam",), init=(40.0,), n_obs=128,
                      normalize=0.5, obs_weight=30.0)
    spec = TrainSpec(
        n_col=384, n_band=0, n_adaptive=0, n_bd=32,
        stages=(StageSpec(depth=3, width=32, scl=2.0,
                          adam_epochs=3000, lbfgs_epochs=3000),),
        grid=64, lw=(1.0, 0.0), testing_size=(101,), pad_features=3,
        log_every=1500,
    )
    r = run_inverse(_eigen_problem_1d(), inv, spec, device="cpu")
    _eigen_check(r, 2, 2e-2, 0.99)


def test_refusals(monkeypatch):
    """mesh (item 14) and what run_training refuses raise before any work;
    device 'cuda' without a card raises (no CPU fallback); no oracle and
    no observations is a ValueError."""
    prob = _poisson_inverse_problem()
    inv = InverseSpec(params=("lam",), init=(0.5,), n_obs=8)
    spec = _poisson_spec(16, 0, 1, 0, n_bd=4)
    with pytest.raises(NotImplementedError, match="item 14"):
        run_inverse(prob, inv, spec, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="cpu_fallback"):
        run_inverse(prob, inv, dataclasses.replace(spec, cpu_fallback=True),
                    device="cpu")
    with pytest.raises(ValueError, match="analytic solution"):
        run_inverse(dataclasses.replace(prob, exact=None), inv, spec,
                    device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_inverse(prob, inv, spec, device="cuda")


def test_adam_layouts_agree():
    """The flat layout (net and coefficient in one vector) and the tree
    layout (the coefficient a 1-element vector of its own) take the same
    Adam steps: Adam is elementwise."""
    inv = InverseSpec(params=("lam",), init=(0.5,), n_obs=20)
    base = dataclasses.replace(_poisson_spec(64, 16, 60, 0), tail_max=0)
    runs = [run_inverse(_poisson_inverse_problem(), inv,
                        dataclasses.replace(base, adam_layout=layout),
                        device="cpu") for layout in ("flat", "tree")]
    np.testing.assert_allclose(runs[0].history, runs[1].history, rtol=1e-5,
                               atol=1e-7)
    assert runs[0].coef["lam"] == pytest.approx(runs[1].coef["lam"],
                                                rel=1e-5)
    assert runs[0].coef["lam"] != 0.5
