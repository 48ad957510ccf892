"""High-accuracy numerical oracles for presets without closed forms
(a copy of ``tpinn.problems.oracles``: numpy and scipy, run on the host in
float64, so the port keeps its own).

The Allen–Cahn and nonlinear Schrödinger benchmarks (Raissi et al. 2019
configs) have no closed form, so the oracle is a spectral reference
solution computed once per process on the host in float64:

* **Allen–Cahn**: Fourier pseudo-spectral in x + ETDRK4 in t
  (Kassam–Trefethen 2005 contour-quadrature coefficients) — the standard
  stiff-PDE integrator for periodic problems; 4th order in dt, spectral
  in x.
* **NLS**: Strang split-step Fourier — the linear half-steps are exact in
  Fourier space and the nonlinear step is exact pointwise (|h| is
  conserved by h ↦ e^{i|h|²dt}h), so the only error is the 2nd-order
  splitting error.

Evaluation at arbitrary points goes through a cubic tensor-grid
interpolant (scipy RegularGridInterpolator) over a fine cached grid; the
periodic x axis is ghost-padded with wrapped columns so the cubic stencil
is seamless across the seam.  Everything here is host-side numpy: a
preset's ``exact()`` calls it once per evaluation, never inside a training
step.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["allen_cahn_solution", "nls_solution", "grid_interpolant"]


# ---------------------------------------------------------------------------
# Allen–Cahn:  u_t = gamma*u_xx + 5u - 5u^3   on x in [-1,1] periodic
# ---------------------------------------------------------------------------

_AC_CACHE: dict = {}


def allen_cahn_solution(
    gamma: float = 1e-4,
    n: int = 1024,
    dt: float = 1e-3,
    t_final: float = 1.0,
    frame_every: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(t[nt], x[n], U[nt, n]) reference solution of the Raissi Allen–Cahn
    benchmark  u_t − γu_xx + 5u³ − 5u = 0,  u(x,0) = x²cos(πx), periodic.

    ETDRK4 with M=32 contour points for the φ-coefficients; dt = 1e-3 over
    t∈[0,1] keeps the 4th-order time error far below the spectral floor
    (step-halving agreement ~1e-10, asserted in tpinn's suite)."""
    key = (gamma, n, dt, t_final, frame_every)
    if key in _AC_CACHE:
        return _AC_CACHE[key]

    L_dom = 2.0
    x = -1.0 + L_dom * np.arange(n) / n                      # periodic grid
    u = (x**2) * np.cos(np.pi * x)
    k = 2.0 * np.pi * np.fft.fftfreq(n, d=L_dom / n)          # wavenumbers
    L = -gamma * k**2 + 5.0                                   # linear symbol

    # Kassam–Trefethen contour quadrature for the ETDRK4 coefficients
    E = np.exp(dt * L)
    E2 = np.exp(dt * L / 2.0)
    M = 32
    r = np.exp(1j * np.pi * (np.arange(1, M + 1) - 0.5) / M)  # unit circle
    LR = dt * L[:, None] + r[None, :]
    Q = dt * np.real(np.mean((np.exp(LR / 2) - 1) / LR, axis=1))
    f1 = dt * np.real(np.mean(
        (-4 - LR + np.exp(LR) * (4 - 3 * LR + LR**2)) / LR**3, axis=1))
    f2 = dt * np.real(np.mean(
        (2 + LR + np.exp(LR) * (-2 + LR)) / LR**3, axis=1))
    f3 = dt * np.real(np.mean(
        (-4 - 3 * LR - LR**2 + np.exp(LR) * (4 - LR)) / LR**3, axis=1))

    def Nfun(v):  # nonlinear term in Fourier space
        u_phys = np.real(np.fft.ifft(v))
        return np.fft.fft(-5.0 * u_phys**3)

    v = np.fft.fft(u)
    nsteps = int(round(t_final / dt))
    frames = [u.copy()]
    ts = [0.0]
    for step in range(1, nsteps + 1):
        Nv = Nfun(v)
        a = E2 * v + Q * Nv
        Na = Nfun(a)
        b = E2 * v + Q * Na
        Nb = Nfun(b)
        c = E2 * a + Q * (2 * Nb - Nv)
        Nc = Nfun(c)
        v = E * v + Nv * f1 + 2 * (Na + Nb) * f2 + Nc * f3
        if step % frame_every == 0:
            frames.append(np.real(np.fft.ifft(v)))
            ts.append(step * dt)

    out = (np.asarray(ts), x, np.asarray(frames))
    _AC_CACHE[key] = out
    return out


# ---------------------------------------------------------------------------
# NLS:  i h_t + 0.5 h_xx + |h|^2 h = 0   on x in [-5,5] periodic
# ---------------------------------------------------------------------------

_NLS_CACHE: dict = {}


def nls_solution(
    n: int = 2048,
    nsteps: int = 20000,
    t_final: float = float(np.pi / 2),
    frame_every: int = 20,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(t[nt], x[n], H[nt, n] complex) reference solution of the Raissi
    Schrödinger benchmark  i h_t + ½h_xx + |h|²h = 0,  h(x,0) = 2 sech x,
    periodic on [−5,5].  The IC is the N=2 soliton bound state: |h| focuses
    to 4 at t = π/4 — the hard part of the benchmark.

    Strang splitting: exact linear half-step exp(−i k² dt/4) in Fourier
    space, exact nonlinear step exp(i|h|²dt) pointwise."""
    key = (n, nsteps, t_final, frame_every)
    if key in _NLS_CACHE:
        return _NLS_CACHE[key]

    L_dom = 10.0
    x = -5.0 + L_dom * np.arange(n) / n
    h = (2.0 / np.cosh(x)).astype(np.complex128)
    k = 2.0 * np.pi * np.fft.fftfreq(n, d=L_dom / n)
    dt = t_final / nsteps
    half = np.exp(-0.25j * k**2 * dt)        # exp(i*0.5*(-k^2)*dt/2)

    frames = [h.copy()]
    ts = [0.0]
    for step in range(1, nsteps + 1):
        h = np.fft.ifft(half * np.fft.fft(h))
        h = h * np.exp(1j * np.abs(h) ** 2 * dt)
        h = np.fft.ifft(half * np.fft.fft(h))
        if step % frame_every == 0:
            frames.append(h.copy())
            ts.append(step * dt)

    out = (np.asarray(ts), x, np.asarray(frames))
    _NLS_CACHE[key] = out
    return out


# ---------------------------------------------------------------------------
# Cubic tensor-grid interpolant with a periodic x axis
# ---------------------------------------------------------------------------


def grid_interpolant(t: np.ndarray, x: np.ndarray, U: np.ndarray,
                     x_period: float):
    """``f(z[N, 2] with columns (x, t)) -> [N, 1]`` cubic interpolation of
    the frame stack ``U[nt, nx]``.  The x axis is periodic with the given
    period and is ghost-padded (3 wrapped columns each side) so the cubic
    stencil never sees the seam; query x is wrapped into the grid's
    fundamental cell and t is clamped to [t0, t1] (guards the float32 →
    float64 eval-grid endpoints)."""
    from scipy.interpolate import RegularGridInterpolator

    pad = 3
    x_ext = np.concatenate([x[-pad:] - x_period, x, x[:pad] + x_period])
    U_ext = np.concatenate([U[:, -pad:], U, U[:, :pad]], axis=1)
    rgi = RegularGridInterpolator((t, x_ext), U_ext, method="cubic",
                                  bounds_error=False, fill_value=None)
    t_lo, t_hi = float(t[0]), float(t[-1])
    x_lo = float(x[0])

    def f(z):
        z = np.asarray(z, np.float64)
        xq = x_lo + np.mod(z[:, 0] - x_lo, x_period)
        tq = np.clip(z[:, 1], t_lo, t_hi)
        return rgi(np.stack([tq, xq], axis=1))[:, None]

    return f
