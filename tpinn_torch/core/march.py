"""Time-marching (sequential-window) training for evolution problems.

Port of ``tpinn.core.march``.  Plain space-time training of one network
fails on stiff or advective evolution problems: the residual is
near-minimized by solutions that are wrong at late times (Krishnapriyan
et al. 2021).  Marching splits the causal axis into W windows, trains
window k on its own slab [t_k, t_{k+1}] with the previous window's
terminal state as its initial condition, and serves the piecewise-in-time
composite.

Each window is an ordinary ``run_training`` on the caller's device, so its
nets go through the same engines as any other run: kernels B1 and B2 for
plain dense tanh nets on ``periodic``/``minmax`` features
(``convection_1d``, ``wave_1d``), the generic jvp engine otherwise
(``allen_cahn``'s ``periodic_fit``), and kernel B3 for every Adam step.
The handoff enters the next window's loss as a ``BCGroup.value_fn``: the
sampler evaluates it once per point set, without an autograd graph, so
no gradient of a later window reaches an earlier window's parameters.
The composite evaluates every window at every point and gathers the
window that ``searchsorted`` picks, where tpinn contracts with a one-hot
matrix: the same values, and the coordinate gradient flows through the
selected window only.

Window nets are cold-started: each window's minmax feature map
renormalizes t to its own slab, so the previous window's weights
represent a different function of the network inputs; the state is
carried by the IC data.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from tpinn_torch import parallel
from tpinn_torch.core import pde, sample
from tpinn_torch.core.train import (ProblemSpec, TrainResult, TrainSpec,
                                    _residual_with_source,
                                    _write_stage_artifacts, eval_grid,
                                    resolve_device, resolve_testing_size,
                                    run_training)
from tpinn_torch.utils import artifacts

Tensor = torch.Tensor


@dataclass
class MarchResult:
    problem: ProblemSpec
    edges: np.ndarray                       # [W+1] window boundaries
    axis_index: int
    windows: List[TrainResult]
    predict: Callable[[Tensor], Tensor]     # piecewise composite u(z)
    rel_l2: Optional[float]                 # vs analytic, FULL domain


def axis_derivative(f: Callable, axis_index: int) -> Callable:
    """∂f/∂z[axis] (one ``torch.func.jvp`` along the axis tangent): the
    velocity handoff for second-order-in-time marching."""
    def df(z):
        tang = torch.zeros_like(z)
        tang[:, axis_index] = 1.0
        return torch.func.jvp(f, (z,), (tang,))[1]

    return df


def _as_data(f: Callable) -> Callable:
    """``f``'s values cut from autograd: a handoff is data for the next
    window, never a path for its gradient into an earlier one.  The
    detach comes after ``f``, so a jvp inside ``f`` still sees its
    tangents; the nets run_training returns hold detached parameters, so
    nothing is recorded to cut in the first place."""
    return lambda z: f(z).detach()


def window_problem(problem: ProblemSpec, axis_index: int,
                   t_lo: float, t_hi: float, k: int,
                   prev_predict: Optional[Callable],
                   handoff_velocity: bool = False) -> ProblemSpec:
    """The slab-k sub-problem: domain clipped to [t_lo, t_hi] along the
    causal axis, BC groups intersected with the slab, and (for k > 0) the
    previous window's terminal state appended as the slab's IC.

    ``handoff_velocity``: also pin ∂u/∂t at the handoff plane to the
    previous window's time derivative (an operator BC group), for
    equations second order along the march axis (wave): their Cauchy data
    is (u, u_t), and handing off only u leaves each window free to pick
    any velocity."""
    lb = list(problem.lb)
    ub = list(problem.ub)
    lb[axis_index], ub[axis_index] = float(t_lo), float(t_hi)

    groups = []
    for g in problem.bc_groups:
        glo, ghi = g.lo[axis_index], g.hi[axis_index]
        # drop groups outside the slab; a group that only touches the
        # slab's start (the t = 0 IC for k > 0) stays with the lower slab
        if ghi < t_lo or glo > t_hi or (k > 0 and ghi <= t_lo):
            continue
        lo = list(g.lo)
        hi = list(g.hi)
        lo[axis_index] = max(glo, t_lo)
        hi[axis_index] = min(ghi, t_hi)
        groups.append(replace(g, lo=tuple(lo), hi=tuple(hi)))
    if k > 0:
        if prev_predict is None:
            raise ValueError("window k>0 needs the previous predictor")
        lo = list(problem.lb)
        hi = list(problem.ub)
        lo[axis_index] = hi[axis_index] = float(t_lo)
        groups.append(sample.BCGroup(
            lo=tuple(lo), hi=tuple(hi), value_fn=_as_data(prev_predict),
            value_expr=f"<window {k} terminal state>"))
        if handoff_velocity:
            axis = problem.coords[axis_index]
            groups.append(sample.BCGroup(
                lo=tuple(lo), hi=tuple(hi),
                value_fn=_as_data(axis_derivative(prev_predict, axis_index)),
                value_expr=f"<window {k} terminal velocity>",
                operator=f"u_{axis}"))

    return replace(
        problem,
        name=f"{problem.name}_w{k + 1}",
        lb=tuple(lb), ub=tuple(ub), bc_groups=tuple(groups),
    )


def make_march_predictor(predicts, edges, axis_index: int):
    """Piecewise-in-t composite: every window evaluates at every point and
    the window ``searchsorted`` picks (``right=True``: a point on an inner
    edge belongs to the later window) is gathered.  The inner edges are
    rounded to float32, as tpinn's are.  The gather is piecewise constant
    in z, so coordinate gradients flow through the selected window's
    forward only and residuals of the composite are exact away from the
    edges."""
    inner = torch.tensor(np.asarray(edges, np.float64)[1:-1],
                         dtype=torch.float32)
    preds = tuple(predicts)

    def predict(z):
        t = z[:, axis_index].contiguous()
        idx = torch.searchsorted(inner.to(z.device, z.dtype), t, right=True)
        vals = torch.stack([f(z) for f in preds])             # [W, N, 1]
        pick = idx[None, :, None].expand(1, -1, vals.shape[2])
        return vals.gather(0, pick)[0]

    return predict


def run_time_marching(
    problem: ProblemSpec,
    spec: TrainSpec,
    n_windows: int,
    axis: str = "t",
    output_dir: Optional[str] = None,
    log_fn: Optional[Callable] = None,
    print_log: bool = False,
    resume: bool = False,
    mesh=None,
    *,
    device,
) -> MarchResult:
    """Train ``n_windows`` sequential slabs along coordinate ``axis`` on
    ``device`` ("cuda" fails without a card) and compose the piecewise
    predictor.  Each window is a full ``run_training`` of ``spec`` (total
    budget = n_windows × spec), so multi-stage chains, causal weighting
    inside the window, mid-Adam checkpoints (``checkpoint_every``) and
    resume work per window unchanged; ``resume=True`` short-circuits
    finished windows from their stage checkpoints and continues a killed
    window's stage from its ``adam_state_stage_N.npz``, and ``mesh`` goes
    through to ``run_training`` (every window points-parallel, rank 0
    writing; the composite's files are rank 0's too).

    Writes ``march.json`` and one checkpoint directory per window under
    ``output_dir``, and for 1-D/2-D problems the composite's artifact set
    at its top level; tpinn_torch.app.serve (and tpinn's) rebuilds the
    composite from ``march.json``."""
    if n_windows < 2:
        raise ValueError("time marching needs n_windows >= 2 "
                         "(1 window IS plain training)")
    if axis not in problem.coords:
        raise ValueError(
            f"march axis {axis!r} is not a coordinate of "
            f"{problem.name} (coords={problem.coords})")
    if problem.hard_bc is not None:
        raise ValueError(
            "time marching poses the IC handoff softly; hard_bc "
            "expressions cannot represent a learned terminal state — "
            "drop hard_bc (window BCs are weighted data terms)")
    ai = problem.coords.index(axis)
    edges = np.linspace(problem.lb[ai], problem.ub[ai], n_windows + 1)

    # equations second order along the march axis (wave) hand off the
    # Cauchy data (u, u_t); first-order ones hand off u only
    compiled = pde.compile_pde(problem.equation, problem.coords)
    axis_order = max((ix.count(ai) for ix in compiled.indices), default=0)
    if axis_order > 2:
        raise ValueError(
            f"time marching supports order <= 2 along the march axis; "
            f"{problem.name} is order {axis_order} in {axis!r}")
    handoff_velocity = axis_order == 2
    dev = resolve_device(device)

    def log(msg):
        if log_fn is not None:
            log_fn(msg)
        if print_log:
            print(msg, flush=True)

    out = Path(output_dir) if output_dir else None
    wout = out if parallel.is_writer(mesh) else None
    if wout:
        wout.mkdir(parents=True, exist_ok=True)

    results: List[TrainResult] = []
    prev_predict = None
    for k in range(n_windows):
        sub = window_problem(problem, ai, edges[k], edges[k + 1], k,
                             prev_predict,
                             handoff_velocity=handoff_velocity)
        log(f"march window {k + 1}/{n_windows}: {axis} in "
            f"[{edges[k]:g}, {edges[k + 1]:g}], "
            f"{len(sub.bc_groups)} BC groups")
        res = run_training(
            sub, spec,
            output_dir=str(out / f"window_{k + 1}") if out else None,
            log_fn=log_fn, print_log=print_log, resume=resume, mesh=mesh,
            device=dev,
        )
        results.append(res)
        prev_predict = res.predict

    predict = make_march_predictor([r.predict for r in results], edges, ai)
    tsize = resolve_testing_size(problem, spec.testing_size, log, "march: ")
    X_star, axes, _ = eval_grid(problem, tsize, torch.float32, dev)

    if wout and problem.dim <= 2:
        # the composite's figure set at the top level (each window wrote
        # its own inside window_k/), so a march run renders like a plain one
        ny, nx = ((1, tsize[0]) if problem.dim == 1
                  else (tsize[1], tsize[0]))
        with torch.no_grad():
            U = predict(X_star).cpu().numpy().reshape(ny, nx)
            src = (pde.compile_coord_expr(problem.source, problem.coords)
                   if problem.source else None)
            F = _residual_with_source(compiled, src, predict, X_star)
            F = F.cpu().numpy().reshape(ny, nx)
            exact_star = (problem.exact(X_star).cpu().numpy()
                          if problem.exact is not None else None)
        hist = np.concatenate([r.history for r in results], axis=0)
        _write_stage_artifacts(out, 1, problem, spec, axes, U, F,
                               exact_star, hist)
        # the composite collocation tab: every window's sampled points
        # over the composite |residual|
        cols = []
        for k in range(n_windows):
            p = out / f"window_{k + 1}" / "collocation_point_1.npz"
            if p.exists():
                with np.load(p) as d:
                    cols.append(np.asarray(d["X_col"]))
        if cols:
            limit = [problem.lb[0], problem.ub[0]] + (
                [problem.lb[1], problem.ub[1]] if problem.dim == 2
                else [0.0, 1.0])
            artifacts.write_collocation(
                out / "collocation_point_1.npz",
                U=np.abs(F), X_col=np.concatenate(cols, axis=0),
                limit=limit)

    # full-domain rel-L2 against the oracle (each window's own rel_l2 is
    # slab-local; the composite is the number that matters), the oracle
    # in float64 at the float32 grid's points
    rel_l2 = None
    if problem.exact is not None:
        with torch.no_grad():
            u = predict(X_star).cpu().numpy().astype(np.float64).reshape(-1)
            z64 = X_star.to(torch.float64)
            ue = problem.exact(z64).cpu().numpy().reshape(-1)
            if problem.eval_mask is not None:
                m = problem.eval_mask(z64).cpu().numpy().reshape(-1)
                u, ue = u * m, ue * m
        rel_l2 = float(np.linalg.norm(u - ue) / np.linalg.norm(ue))
        log(f"march composite rel-L2 vs analytic: {rel_l2:.4e}")

    if wout:
        record = {
            "problem": problem.name,
            "axis": axis,
            "axis_index": ai,
            "edges": [float(v) for v in edges],
            "windows": [
                f"window_{k + 1}/params_stage_{len(r.stages)}.npz"
                for k, r in enumerate(results)
            ],
            "rel_l2": rel_l2,
            "rel_l2_windows": [r.rel_l2 for r in results],
            "fell_back": False,
        }
        tmp = out / "march.json.tmp"
        tmp.write_text(json.dumps(record, indent=1))
        tmp.replace(out / "march.json")

    return MarchResult(
        problem=problem, edges=edges, axis_index=ai, windows=results,
        predict=predict, rel_l2=rel_l2,
    )
