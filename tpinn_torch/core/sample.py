"""Sampling on the device: LHS, inverse-CDF adaptive sampling, smoothing.

Port of ``tpinn.core.sample``.  Every draw takes an explicit
``torch.Generator`` that lives on the device of the points it makes (a
CUDA generator for CUDA points), so a training loop resamples without
leaving the card.  The generators' streams differ from ``jax.random``'s:
parity with ``tpinn`` is held by statistics and by equal outputs on equal
inputs, never by random bits.

Components (reference counterparts in ``tpinn.core.sample``):
- ``lhs`` / ``lhs_box``     — stratified Latin-hypercube sampling.
- ``inverse_cdf_1d/2d/nd``  — density-weighted sampling by the inverse CDF
                              of the flattened cell masses, jittered within
                              the cell.
- ``gaussian_smooth_1d/2d/nd`` — separable Gaussian window smoothing,
                              'same' mode, written as padded weighted sums:
                              no convolution library, so no TF32 (cuDNN's
                              float32 default) whatever the caller's flags.
- ``boundary_band_density`` / ``boundary_band_density_nd`` — the 5%-frame
  boundary-band mask.
- ``make_sampler`` / ``make_sampler_1d`` / ``make_sampler_nd`` /
  ``sampler_for`` — the point-set pipeline: BC-group points, uniform +
  boundary-band + adaptive collocation points, BC points concatenated
  into the collocation set.  The d ≥ 3 sampler works on an
  ``indexing="ij"`` density grid of ``grid**d`` nodes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Latin hypercube sampling
# ---------------------------------------------------------------------------


def lhs(gen: torch.Generator, n: int, dim: int, dtype=torch.float32) -> Tensor:
    """Stratified LHS in the unit cube: [n, dim] on ``gen``'s device, one
    point per 1/n slab per axis (random axis permutations + intra-slab
    jitter)."""
    dev = gen.device
    perms = torch.stack(
        [torch.randperm(n, generator=gen, device=dev) for _ in range(dim)],
        dim=1).to(dtype)
    jitter = torch.rand((n, dim), generator=gen, device=dev, dtype=dtype)
    return (perms + jitter) / n


def lhs_box(gen: torch.Generator, n: int, lb, ub, dtype=torch.float32) -> Tensor:
    """LHS scaled to the box [lb, ub]."""
    lb = torch.as_tensor(lb, dtype=dtype, device=gen.device)
    ub = torch.as_tensor(ub, dtype=dtype, device=gen.device)
    return lhs(gen, n, lb.shape[0], dtype) * (ub - lb) + lb


# ---------------------------------------------------------------------------
# Inverse-CDF sampling from gridded densities
# ---------------------------------------------------------------------------


def fixed_order_cdf(f: Tensor) -> Tensor:
    """``[0, f_0, f_0 + f_1, …]``: the cumulative mass of the 1-D tensor
    ``f``, summed in index order in float64 on the host and rounded to
    ``f``'s dtype, on ``f``'s device.  The same bits on every run and every
    device (a device scan adds its tiles' partial sums in whatever order
    they finish, which moved a draw at a cell's edge between runs); the
    bits of ``torch.cumsum`` on the CPU.  One copy each way and one
    synchronisation per draw."""
    host = np.cumsum(f.detach().to("cpu", torch.float64).numpy())
    cdf = torch.from_numpy(np.concatenate([[0.0], host])).to(f.dtype)
    return cdf.to(f.device)


def _cell_index(gen: torch.Generator, f: Tensor, n: int) -> Tensor:
    """``n`` cell indices drawn with probability ∝ the cell masses ``f``
    (the floor of ``interp(u·total, cdf, 0..M)`` of the JAX version: the
    last cell whose cumulative mass does not exceed the draw).  A cell of
    zero mass is never drawn: on a plateau of the cumulative sum the search
    lands on the plateau's last cell, the one whose mass follows, and a
    draw that rounds up to the total goes to the last cell that has any.
    The cumulative mass is ``fixed_order_cdf``'s, so a draw repeats
    bitwise on the card."""
    cdf = fixed_order_cdf(f)
    draws = torch.rand((n,), generator=gen, device=f.device,
                       dtype=f.dtype) * cdf[-1]
    pos = torch.searchsorted(cdf, draws, right=True) - 1
    last_live = torch.searchsorted(cdf, cdf[-1:], right=False) - 1
    return torch.minimum(pos, last_live).clamp_(0, f.shape[0] - 1)


def inverse_cdf_1d(gen: torch.Generator, x: Tensor, f: Tensor, n: int) -> Tensor:
    """Sample ``n`` points on the 1-D grid ``x`` [N, 1] (equally spaced
    nodes) with cell density ``f`` [N, 1].  Returns [n, 1]."""
    xc = x[:-1, :]
    dx = xc[1, 0] - xc[0, 0]
    pos = _cell_index(gen, f[:-1, 0], n)
    jitter = torch.rand((n, 1), generator=gen, device=x.device, dtype=x.dtype)
    return xc[pos] + jitter * dx


def inverse_cdf_2d(gen: torch.Generator, X: Tensor, Y: Tensor, F: Tensor,
                   n: int) -> Tensor:
    """Sample ``n`` points from the 2-D cell density ``F`` on the meshgrid
    (X, Y): flatten the cell masses, invert their cumulative sum for the
    flat cell index, jitter uniformly within the cell.  Returns [n, 2]."""
    Xc = X[:-1, :-1]
    Yc = Y[:-1, :-1]
    Fc = F[:-1, :-1]
    dx = X[0, 1] - X[0, 0]
    dy = Y[1, 0] - Y[0, 0]
    flat = _cell_index(gen, Fc.reshape(-1), n)
    ncols = Fc.shape[1]
    row = torch.div(flat, ncols, rounding_mode="floor")
    col = flat - row * ncols
    jitter = torch.rand((2, n), generator=gen, device=X.device, dtype=X.dtype)
    return torch.stack([Xc[row, col] + jitter[0] * dx,
                        Yc[row, col] + jitter[1] * dy], dim=1)


def inverse_cdf_nd(gen: torch.Generator, axes: Sequence[Tensor], F: Tensor,
                   n: int) -> Tensor:
    """Sample ``n`` points from a d-dimensional cell density (d ≥ 1).

    ``axes``: per-axis equally spaced node vectors [g_i]; ``F``: the
    density on their ``indexing="ij"`` meshgrid, shape (g_0, …, g_{d-1}).
    The algorithm of the 1-D/2-D samplers: the flat cell index from the
    inverse cumulative sum, unravelled by a div/mod chain, then a uniform
    jitter per axis within the cell.  Returns [n, d]."""
    d = len(axes)
    Fc = F[tuple(slice(0, -1) for _ in range(d))]
    flat = _cell_index(gen, Fc.reshape(-1), n)
    idx = []
    for size in reversed(Fc.shape):
        q = torch.div(flat, size, rounding_mode="floor")
        idx.append(flat - q * size)
        flat = q
    idx.reverse()
    jitter = torch.rand((d, n), generator=gen, device=F.device, dtype=F.dtype)
    cols = [axes[i][idx[i]] + jitter[i] * (axes[i][1] - axes[i][0])
            for i in range(d)]
    return torch.stack(cols, dim=1)


# ---------------------------------------------------------------------------
# Gaussian density smoothing (separable weighted sums)
# ---------------------------------------------------------------------------


def _gauss_window(sig: float, wid: int, dtype, device) -> Tensor:
    xg = torch.linspace(-sig, sig, wid, dtype=dtype, device=device)
    return torch.exp(-0.5 * xg * xg) / math.sqrt(2.0 * math.pi)


def _weighted_sum_same(a: Tensor, w: Tensor, dim: int, lo: int) -> Tensor:
    """out[i] = Σ_j w[j]·ap[i + j] along ``dim``, where ``ap`` is ``a``
    zero-padded with ``lo`` entries before and ``len(w) − 1 − lo`` after:
    a 'same'-size correlation written as shifted slices (exact float
    multiply-adds, no convolution library)."""
    k = w.shape[0]
    a = a.movedim(dim, -1)
    n = a.shape[-1]
    ap = torch.nn.functional.pad(a, (lo, k - 1 - lo))
    out = w[0] * ap[..., 0:n]
    for j in range(1, k):
        out = out + w[j] * ap[..., j:j + n]
    return out.movedim(-1, dim)


def gaussian_smooth_1d(f: Tensor, sig: float = 1.0, wid: int = 5) -> Tensor:
    """'same'-mode 1-D Gaussian smoothing of [N, 1] (numpy's
    ``convolve(f, w, mode="same")`` with the normalized window)."""
    w = _gauss_window(sig, wid, f.dtype, f.device)
    w = w / w.sum()
    # convolution = correlation with the reversed window, padded
    # (k-1-lo, lo) where lo = (k-1)//2 is numpy's 'same' offset
    k = w.shape[0]
    return _weighted_sum_same(f, w.flip(0), 0, k - 1 - (k - 1) // 2)


def gaussian_smooth_2d(F: Tensor, sig: Sequence[float] = (1.0, 1.0),
                       wid: Sequence[int] = (5, 5)) -> Tensor:
    """'same'-mode 2-D Gaussian smoothing of an [H, W] density: the outer
    product of two 1-D normal-pdf windows on linspace(-sig, sig, wid),
    normalized to sum 1, applied as two separable passes (rows with wx,
    columns with wy), as ``tpinn.core.sample.gaussian_smooth_2d``."""
    wx = _gauss_window(float(sig[0]), int(wid[0]), F.dtype, F.device)
    wy = _gauss_window(float(sig[1]), int(wid[1]), F.dtype, F.device)
    total = wx.sum() * wy.sum()
    wx = wx / torch.sqrt(total)
    wy = wy / torch.sqrt(total)
    F1 = _weighted_sum_same(F, wx, 1, (wx.shape[0] - 1) // 2)
    return _weighted_sum_same(F1, wy, 0, (wy.shape[0] - 1) // 2)


def gaussian_smooth_nd(F: Tensor, sig: float = 1.0, wid: int = 5) -> Tensor:
    """Separable 'same'-mode Gaussian smoothing along every axis of a
    d-dimensional density: one normalized window, one padded weighted sum
    per axis (as ``tpinn.core.sample.gaussian_smooth_nd``)."""
    w = _gauss_window(sig, wid, F.dtype, F.device)
    w = w / w.sum()
    lo = (w.shape[0] - 1) // 2
    for ax in range(F.dim()):
        F = _weighted_sum_same(F, w, ax, lo)
    return F


def boundary_band_density(R: Tensor, T: Tensor, lb, ub) -> Tensor:
    """Density = 1 on the outer 5% frame of the box, 0 inside."""
    fx = (ub[0] - lb[0]) / 20.0
    fy = (ub[1] - lb[1]) / 20.0
    interior = ((R > lb[0] + fx) & (R < ub[0] - fx)
                & (T > lb[1] + fy) & (T < ub[1] - fy))
    return torch.where(interior, 0.0, 1.0).to(R.dtype)


def boundary_band_density_nd(grids: Sequence[Tensor], lb, ub) -> Tensor:
    """N-D ``boundary_band_density``: 1 on the outer 5% shell of the box, 0
    inside.  ``grids``: the per-axis ``indexing="ij"`` meshgrids."""
    interior = None
    for i, G in enumerate(grids):
        band = (ub[i] - lb[i]) / 20.0
        ax_in = (G > lb[i] + band) & (G < ub[i] - band)
        interior = ax_in if interior is None else (interior & ax_in)
    return torch.where(interior, 0.0, 1.0).to(grids[0].dtype)


# ---------------------------------------------------------------------------
# Point-set pipeline (dataf equivalent)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BCGroup:
    """One boundary-condition group: the box [lo, hi] where the solution is
    pinned to ``value`` (constant) or to a coordinate expression
    (``value_fn``; ``value_expr`` carries its source string).  ``field``
    selects the component of a coupled system; ``operator`` is a
    Neumann/Robin expression over u and its derivatives (None = Dirichlet).
    """

    lo: Tuple[float, ...]
    hi: Tuple[float, ...]
    value: float = 0.0
    value_fn: Optional[Callable[[Tensor], Tensor]] = None
    value_expr: Optional[str] = None
    field: int = 0
    operator: Optional[str] = None

    def target(self, pts: Tensor) -> Tensor:
        if self.value_fn is not None:
            return self.value_fn(pts)
        return torch.full((pts.shape[0], 1), self.value, dtype=pts.dtype,
                          device=pts.device)


@dataclass(frozen=True)
class SamplerConfig:
    """Counts per draw: ``n_col`` uniform, ``n_band`` boundary-band,
    ``n_adaptive`` residual-adaptive collocation points, ``n_bd`` points per
    BC group; ``grid`` is the density grid per axis."""

    n_col: int
    n_band: int
    n_adaptive: int
    n_bd: int
    grid: int = 111


def make_sampler(config: SamplerConfig, bc_groups: Sequence[BCGroup],
                 lb: Sequence[float], ub: Sequence[float],
                 dtype=torch.float32, device="cpu"):
    """The resampling function of a 2-D problem.

    Returns ``(sample, (R, T))``: ``sample(gen, F) -> data`` draws a fresh
    point set on ``device`` (``gen`` must live there) given the adaptive
    density ``F`` on the meshgrid (R, T).  ``data``:

        x_col : [n_col + n_band + sum(n_bd) + n_adaptive, 2]
        x_bd  : list of [n_bd, 2] per BC group
        u_bd  : list of [n_bd, 1] per BC group
    """
    if len(lb) != 2:
        raise ValueError("make_sampler is 2-D; use make_sampler_1d for 1-D")
    lb_a = torch.as_tensor(lb, dtype=dtype, device=device)
    ub_a = torch.as_tensor(ub, dtype=dtype, device=device)
    g = config.grid
    r = torch.linspace(lb[0], ub[0], g, dtype=dtype, device=device)
    t = torch.linspace(lb[1], ub[1], g, dtype=dtype, device=device)
    R, T = torch.meshgrid(r, t, indexing="xy")
    F_bd = boundary_band_density(R, T, lb, ub)
    groups = tuple(bc_groups)

    def sample(gen: torch.Generator, F: Tensor) -> Dict:
        x_bd: List[Tensor] = []
        u_bd: List[Tensor] = []
        for grp in groups:
            pts = lhs_box(gen, config.n_bd, grp.lo, grp.hi, dtype)
            x_bd.append(pts)
            u_bd.append(grp.target(pts))
        x_uniform = lhs_box(gen, config.n_col, lb_a, ub_a, dtype)
        x_band = inverse_cdf_2d(gen, R, T, F_bd, config.n_band)
        x_adapt = inverse_cdf_2d(gen, R, T, F, config.n_adaptive)
        x_col = torch.cat([x_uniform, x_band] + x_bd + [x_adapt], dim=0)
        return {"x_col": x_col, "x_bd": x_bd, "u_bd": u_bd}

    return sample, (R, T)


def make_sampler_1d(config: SamplerConfig, bc_groups: Sequence[BCGroup],
                    lb: Sequence[float], ub: Sequence[float],
                    dtype=torch.float32, device="cpu"):
    """1-D counterpart of ``make_sampler``.  BC groups in 1-D are points
    (lo == hi), sampled as n_bd copies of the endpoint."""
    lb_a = torch.as_tensor(lb, dtype=dtype, device=device)
    ub_a = torch.as_tensor(ub, dtype=dtype, device=device)
    x_nodes = torch.linspace(lb[0], ub[0], config.grid, dtype=dtype,
                             device=device)[:, None]
    groups = tuple(bc_groups)

    def sample(gen: torch.Generator, F: Tensor) -> Dict:
        x_bd: List[Tensor] = []
        u_bd: List[Tensor] = []
        for grp in groups:
            if grp.hi[0] - grp.lo[0] == 0.0:
                pts = torch.full((config.n_bd, 1), grp.lo[0], dtype=dtype,
                                 device=device)
            else:
                pts = lhs_box(gen, config.n_bd, grp.lo, grp.hi, dtype)
            x_bd.append(pts)
            u_bd.append(grp.target(pts))
        parts = [lhs_box(gen, config.n_col, lb_a, ub_a, dtype)]
        n_extra = config.n_band + config.n_adaptive
        if n_extra:
            parts.append(inverse_cdf_1d(gen, x_nodes, F, n_extra))
        x_col = torch.cat(parts + x_bd, dim=0)
        return {"x_col": x_col, "x_bd": x_bd, "u_bd": u_bd}

    return sample, (x_nodes,)


def make_sampler_nd(config: SamplerConfig, bc_groups: Sequence[BCGroup],
                    lb: Sequence[float], ub: Sequence[float],
                    dtype=torch.float32, device="cpu"):
    """The d ≥ 3 sampler: the same pipeline (uniform LHS, boundary band,
    BC-group points, residual-adaptive draws, in that order: the BC points
    come BEFORE the adaptive ones) over an ``indexing="ij"`` density grid.

    Returns ``(sample, grids)`` with ``grids`` the tuple of d meshgrid
    tensors, each of ``config.grid ** d`` nodes: keep ``grid`` modest in
    high dimension."""
    d = len(lb)
    if d < 3:
        raise ValueError("make_sampler_nd is for d >= 3; use the 1-D/2-D "
                         "samplers (sampler_for dispatches)")
    lb_a = torch.as_tensor(lb, dtype=dtype, device=device)
    ub_a = torch.as_tensor(ub, dtype=dtype, device=device)
    axes = [torch.linspace(lb[i], ub[i], config.grid, dtype=dtype,
                           device=device) for i in range(d)]
    grids = torch.meshgrid(*axes, indexing="ij")
    F_bd = boundary_band_density_nd(grids, lb, ub)
    groups = tuple(bc_groups)

    def sample(gen: torch.Generator, F: Tensor) -> Dict:
        x_bd: List[Tensor] = []
        u_bd: List[Tensor] = []
        for grp in groups:
            pts = lhs_box(gen, config.n_bd, grp.lo, grp.hi, dtype)
            x_bd.append(pts)
            u_bd.append(grp.target(pts))
        parts = [lhs_box(gen, config.n_col, lb_a, ub_a, dtype)]
        if config.n_band:
            parts.append(inverse_cdf_nd(gen, axes, F_bd, config.n_band))
        parts += x_bd
        if config.n_adaptive:
            parts.append(inverse_cdf_nd(gen, axes, F, config.n_adaptive))
        return {"x_col": torch.cat(parts, dim=0), "x_bd": x_bd, "u_bd": u_bd}

    return sample, tuple(grids)


def sampler_for(config: SamplerConfig, bc_groups: Sequence[BCGroup],
                lb: Sequence[float], ub: Sequence[float], dtype=torch.float32,
                device="cpu"):
    """Dispatch the point sampler on the domain dimension (1/2/N-D)."""
    d = len(lb)
    if d == 1:
        return make_sampler_1d(config, bc_groups, lb, ub, dtype, device)
    if d == 2:
        return make_sampler(config, bc_groups, lb, ub, dtype, device)
    return make_sampler_nd(config, bc_groups, lb, ub, dtype, device)


def density_geometry(grids):
    """``(z_grid, reshape, smooth)`` for evaluating an adaptive density on a
    sampler's grid tuple in any dimension: the [N, d] point stack of the
    grid, the reshape of a residual column back onto the grid, and the
    matching separable Gaussian smoothing."""
    if len(grids) == 1:
        x_nodes = grids[0]
        return (x_nodes, lambda f: f,
                lambda f: gaussian_smooth_1d(f, 1.0, 5))
    if len(grids) == 2:
        R, T = grids
        z = torch.stack([R.reshape(-1), T.reshape(-1)], dim=1)
        return (z, lambda f: torch.reshape(f, R.shape),
                lambda F: gaussian_smooth_2d(F, (1.0, 1.0), (5, 5)))
    z = torch.stack([G.reshape(-1) for G in grids], dim=1)
    shp = grids[0].shape
    return z, lambda f: torch.reshape(f, shp), gaussian_smooth_nd
