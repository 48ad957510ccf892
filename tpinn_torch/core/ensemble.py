"""Ensemble training: K seed-varied members, one combined solution.

Port of ``tpinn.core.ensemble``.  Training noise decorrelates across
initialization seeds, so the convex combination of K independently
trained solutions cancels part of it.  Members train in turn through
``train.run_training`` (each through kernels B1, B2 and B3 on the card,
where the net takes them), without the final correction; then:

- weights: ``"lsq"`` (default) is the convex combination minimizing the
  float64 PDE residual norm on a 121^d grid — oracle-free, and exact for
  linear operators, where the residual of the mean is the mean of the
  residuals.  Nonlinear operators and K = 1 take uniform weights.
- the spectral defect correction (``spec.deflation``) runs once, on the
  mean predictor (the correction composes linearly).

The mean is a ``(predictor, params)`` pair, ``predictor(params_list, z) =
Σ w_i f_i(p_i, z)`` over the members' own predictors and parameters, so
the float64 passes (polish._residual_f64, defect_correction) cast the
members' float32 weights instead of feeding float64 points to float32
products.  ``output_dir/ensemble.json`` is served by app.serve.  A
``mesh`` goes through to every member's run_training (each member
points-parallel over it); rank 0 writes ``ensemble.json``.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from tpinn_torch import parallel
from tpinn_torch.core import pde, polish
from tpinn_torch.core.train import (ProblemSpec, TrainResult, TrainSpec,
                                    eval_grid, resolve_device, run_training)


@dataclass
class EnsembleResult:
    members: List[TrainResult]
    weights: np.ndarray                     # convex combination, sums to 1
    rel_l2_members: List[Optional[float]]
    err_correlation: Optional[List[List[float]]]  # only with an oracle
    rel_l2_mean_raw: Optional[float]        # before the defect correction
    rel_l2: Optional[float]                 # the ensemble's final accuracy
    deflation: Optional[dict]
    predict: Callable                        # z -> combined (corrected) u
    fell_back: bool                          # always False in the port


def _lsq_weights(members, compiled, source_fn, problem, n_grid=121):
    """Convex weights minimizing ||sum_i w_i r_i|| on a quadrature grid —
    no oracle used.  ``members`` are (predictor, params) pairs; each
    residual is taken in float64.  Min-norm solve of the constrained LSQ
    (sum w = 1, eliminated through the last weight)."""
    axes = [np.linspace(problem.lb[j], problem.ub[j], n_grid)
            for j in range(problem.dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    z = np.stack([g.ravel() for g in mesh], axis=1)
    R = np.concatenate(
        [polish._residual_f64(pred, params, compiled, source_fn, z)
         for pred, params in members], axis=1)                # [n, K]
    A = R[:, :-1] - R[:, -1:]
    w_head, *_ = np.linalg.lstsq(A, -R[:, -1], rcond=None)
    w = np.append(w_head, 1.0 - w_head.sum())
    if not np.all(np.isfinite(w)) or np.abs(w).max() > 3.0:
        # ill-conditioned (near-identical members): extrapolating weights
        # amplify noise instead of cancelling it — fall back to uniform
        return np.full(len(members), 1.0 / len(members)), "uniform-fallback"
    return w, "lsq"


def _mean_predictor(weights, predictors):
    """``(params_list, z) -> Σ w_i f_i(p_i, z)``."""
    wts = tuple(float(v) for v in weights)

    def predictor(params_list, z):
        acc = None
        for wi, fi, pi in zip(wts, predictors, params_list):
            v = wi * fi(pi, z)
            acc = v if acc is None else acc + v
        return acc

    return predictor


def run_ensemble_training(
    problem: ProblemSpec,
    spec: TrainSpec,
    n_members: int = 4,
    seeds: Optional[Sequence[int]] = None,
    output_dir: Optional[str] = None,
    log_fn: Optional[Callable] = None,
    print_log: bool = False,
    resume: bool = False,
    mesh=None,
    weights: str = "lsq",
    *,
    device,
) -> EnsembleResult:
    """Train ``n_members`` seed-varied copies of ``spec`` on ``device``
    ("cuda" fails without a card), combine them by convex weights, and
    defect-correct the combination.

    The default seeds are ``spec.seed + 1000·i``.  ``resume=True`` passes
    through to each member (finished stages reload, a stage killed
    mid-Adam continues from its ``adam_state_stage_N.npz`` when
    ``spec.checkpoint_every > 0``).  Member checkpoints land in
    ``output_dir/member_<i>/``; the combination record in
    ``output_dir/ensemble.json``."""
    if seeds is None:
        seeds = [spec.seed + 1000 * i for i in range(n_members)]
    if len(seeds) != n_members:
        raise ValueError(f"{len(seeds)} seeds for n_members={n_members}")
    if spec.lsq_polish != "off" and any(st.weight_fact is not None
                                        for st in spec.stages):
        # the members' last-layer solve needs a plain output weight: say so
        # before the first member trains
        raise ValueError("an ensemble of weight-factorised PirateNets "
                         "trains with lsq_polish='off' (polish."
                         "last_layer_lsq solves for a plain output weight)")
    dev = resolve_device(device)

    def log(msg):
        if log_fn is not None:
            log_fn(msg)
        if print_log:
            print(msg, file=sys.stderr)

    out = Path(output_dir) if output_dir else None

    # members train WITHOUT the final correction: it applies once, to the
    # combined predictor (linearity; see module docstring)
    member_spec = replace(spec, deflation="off")
    members: List[TrainResult] = []
    for i, seed in enumerate(seeds):
        log(f"=== ensemble member {i + 1}/{n_members} (seed {seed}) ===")
        mdir = str(out / f"member_{i}") if out else None
        members.append(run_training(
            problem, replace(member_spec, seed=int(seed)),
            output_dir=mdir, log_fn=log_fn, print_log=print_log,
            resume=resume, mesh=mesh, device=dev))

    compiled = pde.compile_pde(problem.equation, problem.coords)
    source_fn = (pde.compile_coord_expr(problem.source, problem.coords)
                 if problem.source else None)
    pairs = [m.stages[-1].predictor_frozen.tpinn_frozen for m in members]

    if weights == "lsq" and compiled.is_linear and n_members > 1:
        w, how = _lsq_weights(pairs, compiled, source_fn, problem)
    else:
        w = np.full(n_members, 1.0 / n_members)
        how = "uniform"
    log(f"ensemble weights ({how}): {np.round(w, 4).tolist()}")

    # combined fields on the shared eval grid (StageResult.U is the f64
    # final-stage evaluation each member already computed)
    X_star, _, _ = eval_grid(problem, spec.testing_size, torch.float32)
    z_star = X_star.to(torch.float64).numpy()
    fields = [m.stages[-1].U.reshape(-1, 1).astype(np.float64)
              for m in members]
    mean_f = sum(wi * f for wi, f in zip(w, fields))

    exact = corr = rel_mean = None
    rels = [m.rel_l2 for m in members]
    if problem.exact is not None:
        exact = torch.as_tensor(problem.exact(
            torch.as_tensor(z_star, dtype=torch.float64))).cpu().numpy()
        errs = [f - exact for f in fields]
        K = n_members
        corr = np.ones((K, K))
        for i in range(K):
            for j in range(i + 1, K):
                c = float(np.sum(errs[i] * errs[j])
                          / (np.linalg.norm(errs[i])
                             * np.linalg.norm(errs[j]) + 1e-300))
                corr[i, j] = corr[j, i] = c
        nrm = float(np.linalg.norm(exact)) + 1e-300
        rel_mean = float(np.linalg.norm(mean_f - exact) / nrm)
        log(f"ensemble mean rel-L2 {rel_mean:.4e} "
            f"(best member {min(r for r in rels if r is not None):.4e}; "
            f"offdiag corr {corr[np.triu_indices(K, 1)].round(3).tolist()})")

    mean_pred = _mean_predictor(w, [p for p, _ in pairs])
    mean_params = [p for _, p in pairs]
    predict_mean = lambda z: mean_pred(mean_params, z)
    predict = predict_mean
    defl = None
    rel_final = rel_mean
    if spec.deflation != "off" and (compiled.is_linear
                                    or spec.deflation == "full"):
        defl = polish.defect_correction(
            mean_pred, mean_params, compiled, problem.lb, problem.ub,
            problem.hard_bc, mode=spec.deflation, source_fn=source_fn,
            coords=problem.coords, bc_groups=problem.bc_groups)
        if defl is not None:
            term = polish.deflation_term(defl)
            predict = lambda z: predict_mean(z) - term(z)
            du, _ = polish.deflation_fields(defl, compiled, z_star)
            if exact is not None:
                defl["rel_l2_before"] = rel_mean
                rel_final = float(np.linalg.norm(mean_f - du - exact)
                                  / (np.linalg.norm(exact) + 1e-300))
            log(f"ensemble correction ({defl['kind']}): "
                f"{len(defl['modes'])} modes"
                + (f", rel-L2 {rel_mean:.4e} -> {rel_final:.4e}"
                   if exact is not None else ""))

    corr_list = np.round(corr, 6).tolist() if corr is not None else None
    if out and parallel.is_writer(mesh):
        n_stages = len(spec.stages) if spec.stages else 2
        record = {
            "problem": problem.name,
            "members": [f"member_{i}/params_stage_{n_stages}.npz"
                        for i in range(n_members)],
            "seeds": [int(s) for s in seeds],
            "weights": [float(v) for v in w],
            "weights_how": how,
            "deflation": defl,
            "rel_l2_members": rels,
            "rel_l2_mean_raw": rel_mean,
            "rel_l2": rel_final,
            "err_correlation": corr_list,
        }
        (out / "ensemble.json").write_text(json.dumps(record, indent=1))

    return EnsembleResult(
        members=members, weights=w, rel_l2_members=rels,
        err_correlation=corr_list, rel_l2_mean_raw=rel_mean,
        rel_l2=rel_final, deflation=defl, predict=predict, fell_back=False)
