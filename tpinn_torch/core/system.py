"""Coupled PDE systems: several equations, several fields, one network.

Port of ``tpinn.core.system``.  ``fields=("u", "v")`` makes ``v``,
``v_x``, ``u_xy``… legal identifiers (pde.compile_system), the network
grows to ``out_dim = len(fields)`` output columns, and the loss stacks
one residual column per equation:

    loss = Σ_g MSE(u_pred[:, field_g] − u_bc_g)            per-BC-group data
         + lw[0] · Σ_e MSE(residual_e)                     per-equation

``loss_info`` layout: ``[loss, loss_data, loss_eqn, data_err_1..G,
(obs_err_1..m,) eqn_err_1..E]``: the scalar contract's leading triple
(loss.py), one data column per BC group, one residual column per
equation.

Kernels B1 and B2 are scalar, so every residual here takes the generic
engine (one ``deriv.partials`` call for all fields and equations), and
autograd its gradient.  The Adam update is kernel B3 on CUDA tensors
(optim.make_adam_phase): with ``adam_layout="flat"`` one launch a step on
the raveled tree, with ``"tree"`` one per leaf, a 1-element one per
unknown coefficient.  Then L-BFGS (optim.lbfgs_over_pytree) on a
density-weighted draw.

Unknown coefficients compose: with an ``inverse`` (core.inverse.
InverseSpec) the equations may declare coefficients, identified jointly
with the net from full-state observations (``observations``, or drawn
from ``problem.exact``).  ``mesh`` (tpinn_torch.parallel.make_mesh)
shards the point batches over its points axis as run_training does (the
counts rounded up to its multiples, zeros kept; the observation term
whole on every rank; rank 0 writes).  tpinn's run_system writes no
mid-stage Adam checkpoint and ignores ``checkpoint_every`` and
``lbfgs_device``; here ``checkpoint_every > 0`` and a ``lbfgs_device``
raise ValueError.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpinn_torch.core import loss as loss_mod
from tpinn_torch import parallel
from tpinn_torch.core import net, optim, pde, sample
from tpinn_torch.core.inverse import synth_observations
from tpinn_torch.core.train import (_DTYPES, TrainSpec, _check_supported,
                                    adam_matmul_precision, eval_grid,
                                    one_run_at_a_time, resolve_device,
                                    resolve_testing_size)
from tpinn_torch.utils import checkpoint as ckpt

Tensor = torch.Tensor


@dataclass(frozen=True)
class SystemSpec:
    """What to solve: coupled equations + domain + field-tagged BCs.

    The system analog of train.ProblemSpec.  ``bc_groups`` entries carry
    ``field`` (sample.BCGroup.field) naming the component each group pins;
    ``exact`` (optional oracle) maps ``z -> [N, len(fields)]``, as a
    tensor or a numpy array.
    """

    name: str
    equations: Tuple[str, ...]
    fields: Tuple[str, ...]
    coords: Tuple[str, ...]
    lb: Tuple[float, ...]
    ub: Tuple[float, ...]
    bc_groups: Tuple[sample.BCGroup, ...]
    feature_kinds: Optional[Tuple[str, ...]] = None
    exact: Optional[Callable[[Tensor], Tensor]] = None

    def __post_init__(self):
        if self.feature_kinds is None:
            object.__setattr__(
                self, "feature_kinds", tuple([net.MINMAX] * len(self.coords))
            )
        for g in self.bc_groups:
            if not (0 <= g.field < len(self.fields)):
                raise ValueError(
                    f"BC group pins field {g.field} but the system has "
                    f"{len(self.fields)} fields {self.fields}"
                )

    @property
    def dim(self) -> int:
        return len(self.coords)


@dataclass
class SystemResult:
    rel_l2: Optional[float]                # aggregate over all fields
    rel_l2_fields: Optional[Tuple[float, ...]]  # per field
    coef: Dict[str, float]                 # recovered coefficients (if any)
    params: dict
    predict: Callable[[Tensor], Tensor]    # z -> [N, m]
    history: np.ndarray


def make_system_loss(
    predictor: Callable[[dict, Tensor], Tensor],
    compiled: pde.CompiledSystem,
    bc_fields: Tuple[int, ...],
    observations: Optional[Tuple[Tensor, Tensor]] = None,
    obs_weight: float = 1.0,
    bc_operators=None,
):
    """Build the system loss.  ``params`` is the net tree, or ``{"net",
    "coef"}`` when the system declares unknown coefficients.

    ``bc_operators``: per-group compiled boundary operators (one-equation
    CompiledSystems over the same fields), Neumann/Robin/flux conditions
    like ``"v_x"`` or ``"u_x - v"``; None entries pin the tagged field's
    value (Dirichlet)."""
    has_coef = bool(compiled.param_names)

    def loss_fn(params: dict, data: Dict, lw: Tensor, ref: Tensor):
        if has_coef:
            net_p, coef = params["net"], params["coef"]
        else:
            net_p, coef = params, None
        f = lambda z: predictor(net_p, z)

        data_errs = []
        for gi, (z_bd, u_bd, fi) in enumerate(
                zip(data["x_bd"], data["u_bd"], bc_fields)):
            op = bc_operators[gi] if bc_operators else None
            bd_val = (op.residual(f, z_bd, coef) if op is not None
                      else f(z_bd)[:, fi:fi + 1])
            data_errs.append(loss_mod.ms_error(bd_val - u_bd))
        n_bc_cols = len(data_errs)
        if observations is not None:
            z_obs, u_obs = observations
            # one obs column per field: the full state is observed
            data_errs.append(loss_mod.ms_error(f(z_obs) - u_obs))
        data_err = (torch.cat(data_errs) if data_errs
                    else data["x_col"].new_zeros((0,)))

        res = compiled.residual(f, data["x_col"], coef)  # [N, n_eq]
        eqn_err = loss_mod.ms_error(res)                 # [n_eq]

        # loss_info columns stay unscaled; the weight applies in the sum
        loss_data = (torch.sum(data_err[:n_bc_cols])
                     + obs_weight * torch.sum(data_err[n_bc_cols:]))
        loss_eqn = torch.sum(eqn_err)
        loss = loss_data + lw[0] * loss_eqn
        loss_info = torch.cat(
            [torch.stack([loss, loss_data, loss_eqn]), data_err, eqn_err])
        return loss / ref, loss_info

    return loss_fn


def _on(x, dtype, dev) -> Tensor:
    """An oracle's answer (tensor or numpy) as a tensor on ``dev``."""
    return torch.as_tensor(x, dtype=dtype, device=dev)


def _observations(problem: SystemSpec, inverse, observations, dtype, dev):
    """The observation pair (z_obs, u_obs) on ``dev``: the caller's, or
    full-state observations synthesized from ``problem.exact``
    (inverse.synth_observations, one noise column per field)."""
    if observations is not None:
        return (_on(observations[0], dtype, dev),
                _on(observations[1], dtype, dev))
    return synth_observations(problem, inverse, dtype, dev,
                              n_fields=len(problem.fields))


@one_run_at_a_time
def run_system(
    problem: SystemSpec,
    spec: TrainSpec,
    inverse=None,                           # core.inverse.InverseSpec
    observations: Optional[Tuple[Tensor, Tensor]] = None,
    log_fn: Optional[Callable] = None,
    print_log: bool = False,
    mesh=None,
    output_dir: Optional[str] = None,
    *,
    device,
) -> SystemResult:
    """Train a coupled system on ``device`` ("cuda" fails without a card):
    one stage, Adam then L-BFGS.

    With ``inverse`` (an InverseSpec) the equations may declare unknown
    coefficients, identified jointly from ``observations`` (or synthesized
    from ``problem.exact``: full-state observations, one column per
    field).  Random streams: the net's init, the Adam phase's draws and
    the L-BFGS draw are streams 0, 1 and 2 of ``spec.seed``, as a
    run_training stage's.  ``output_dir`` gets ``params_stage_1.npz``
    (self-describing: app.serve rebuilds the system from its meta) and
    ``system.json``.
    """
    _check_supported(spec, mesh)
    if spec.checkpoint_every > 0:
        raise ValueError("run_system writes no mid-stage Adam checkpoint: "
                         "checkpoint_every must be 0")
    if spec.lbfgs_device is not None:
        raise ValueError("run_system runs L-BFGS on the training device: "
                         "lbfgs_device must be None")
    if not spec.stages:
        spec = spec.with_default_stages()
    st = spec.stages[0]
    dev = resolve_device(device)
    dtype = _DTYPES[spec.dtype]
    m = len(problem.fields)

    def log(msg: str):
        if log_fn is not None:
            log_fn(msg)
        if print_log:
            print(msg, file=sys.stderr)

    def seeded(k: int, where) -> torch.Generator:
        return torch.Generator(device=where).manual_seed(spec.seed * 1000 + k)

    param_names = tuple(inverse.params) if inverse is not None else ()
    compiled = pde.compile_system(
        problem.equations, problem.coords, problem.fields, param_names)
    feature_map = net.feature_map_for(problem.feature_kinds,
                                      pad_to=spec.pad_features)
    lb = torch.tensor(problem.lb, dtype=dtype, device=dev)
    ub = torch.tensor(problem.ub, dtype=dtype, device=dev)
    mspec = net.MLPSpec(
        depth=st.depth, width=st.width, out_dim=m,
        act_first=st.act_first, act_hidden=st.act_hidden,
        scl=float(st.scl if st.scl is not None else 1.0),
        epsil=float(st.epsil if st.epsil is not None else 1.0),
        fourier_features=st.fourier_features,
        fourier_scale=st.fourier_scale, modified=st.modified,
    )
    net_params = net.init_params(seeded(0, "cpu"), mspec, feature_map, dev,
                                 dtype)
    predictor = net.make_predictor(mspec, feature_map, lb, ub)

    if param_names:
        params = {"net": net_params,
                  "coef": {n: torch.tensor(float(v), dtype=dtype, device=dev)
                           for n, v in zip(inverse.params, inverse.init)}}
    else:
        params = net_params

    obs = None
    if inverse is not None:
        obs = _observations(problem, inverse, observations, dtype, dev)
        log(f"system: inverse mode, {len(param_names)} coefficient(s) "
            f"{param_names}, {obs[0].shape[0]} observations")

    _rc = parallel.counts_rounder(mesh)
    cfg = sample.SamplerConfig(
        n_col=_rc(spec.n_col), n_band=_rc(spec.n_band),
        n_adaptive=_rc(spec.n_adaptive), n_bd=_rc(spec.n_bd),
        grid=spec.grid)
    sample_fn, grids = sample.sampler_for(
        cfg, problem.bc_groups, problem.lb, problem.ub, dtype, dev)
    F0 = torch.ones_like(grids[0])

    # adaptive density: total residual energy over all equations
    z_grid, reshape, smooth = sample.density_geometry(grids)

    def density_fn(p):
        net_p = p["net"] if param_names else p
        coef = p["coef"] if param_names else None
        res = compiled.residual(lambda z: predictor(net_p, z), z_grid, coef)
        f_sq = torch.sum(res ** 2, dim=1, keepdim=True)
        return smooth(reshape(f_sq / torch.mean(f_sq) + 0.5))

    bc_fields = tuple(g.field for g in problem.bc_groups)
    bc_ops = tuple(
        pde.compile_system([g.operator], problem.coords, problem.fields,
                           param_names) if g.operator else None
        for g in problem.bc_groups)
    if not any(o is not None for o in bc_ops):
        bc_ops = None
    loss_fn = make_system_loss(
        predictor, compiled, bc_fields, obs,
        obs_weight=(inverse.obs_weight if inverse is not None else 1.0),
        bc_operators=bc_ops)
    info_width = (3 + len(problem.bc_groups) + (m if obs is not None else 0)
                  + compiled.n_eq)

    lw = torch.tensor(spec.lw, dtype=dtype, device=dev)
    gen_adam = seeded(1, dev)
    gen_lbfgs = seeded(2, dev)
    loss_fn, sample_fn = parallel.meshed(loss_fn, sample_fn, mesh)
    data0 = sample_fn(gen_adam, F0)
    with torch.no_grad():
        ref = optim.evaluate_loss(loss_fn, params, data0, lw,
                                  torch.ones((), dtype=dtype,
                                             device=dev))[1][0]
    log(f"system: {compiled.n_eq} equations, {m} fields "
        f"{problem.fields}; initial loss {float(ref):.4e}")

    adam_cfg = optim.AdamConfig(
        epochs=st.adam_epochs,
        lr=(st.lr if st.lr is not None else spec.lr),
        resample_every=spec.resample_every,
        density_every=spec.density_every,
        plateau_every=spec.plateau_every,
        lr_min=spec.lr_min, tail_max=spec.tail_max,
        log_every=spec.log_every, layout=spec.adam_layout)
    adam_log = None
    if log_fn is not None or print_log:
        from tpinn_torch.utils.logging import format_step_line

        def adam_log(step, loss_info):
            log(format_step_line(int(step), loss_info))

    phase = optim.make_adam_phase(loss_fn, sample_fn, density_fn, adam_cfg,
                                  info_width, adam_log)
    with adam_matmul_precision(spec.adam_precision):
        res = phase(gen_adam, params, data0, F0, lw, ref)
    params = res.params
    hist_adam = res.history[:res.n_valid].cpu().numpy()
    if res.n_valid:
        log(f"system: Adam done ({res.n_valid} steps, final loss "
            f"{hist_adam[-1, 0]:.4e})")

    hist_lbfgs = np.zeros((0, info_width), np.float64)
    if st.lbfgs_epochs > 0:
        lb_cfg = optim.LBFGSConfig(max_iters=max(1, st.lbfgs_epochs // 3),
                                   history=spec.lbfgs_history)
        with torch.no_grad():
            data_l = sample_fn(gen_lbfgs, res.density)
        params, hist, n_rows = optim.lbfgs_over_pytree(
            loss_fn, params, data_l, lw, ref, lb_cfg)
        hist_lbfgs = hist[:n_rows].cpu().numpy()
    if mesh is not None:
        mesh.check_replicas(params)

    net_final = params["net"] if param_names else params
    coef = ({n: float(v) for n, v in params["coef"].items()}
            if param_names else {})
    if coef:
        log("system: recovered " +
            " ".join(f"{n}={v:.6g}" for n, v in coef.items()))
    predict = lambda z: predictor(net_final, z)

    rel_l2 = rel_fields = None
    if problem.exact is not None:
        # SystemSpec is duck-typed as a problem for the evaluation grid
        tsize = resolve_testing_size(problem, spec.testing_size, log,
                                     label="system: ")
        X_star, _, _ = eval_grid(problem, tsize, dtype, dev)
        with torch.no_grad():
            u = predict(X_star)
            u_true = _on(problem.exact(X_star), dtype, dev)
        rel_fields = tuple(
            float(loss_mod.relative_l2(u[:, i:i + 1], u_true[:, i:i + 1]))
            for i in range(m))
        rel_l2 = float(loss_mod.relative_l2(u, u_true))
        log(f"system: rel-L2 {rel_l2:.3e} (" +
            ", ".join(f"{f}={e:.3e}"
                      for f, e in zip(problem.fields, rel_fields)) + ")")

    history = (np.concatenate([hist_adam, hist_lbfgs], axis=0)
               if hist_lbfgs.size else hist_adam)

    if output_dir is not None and parallel.is_writer(mesh):
        # self-describing checkpoint: the meta carries the whole system
        # (equations, fields, domain), so app.serve rebuilds the
        # multi-output predictor without a preset
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        ckpt.save_pytree(
            out / "params_stage_1.npz", net_final,
            meta={"stage": 1, "scl": mspec.scl, "epsil": mspec.epsil,
                  "problem": problem.name,
                  "chain": [net.spec_to_dict(mspec)],
                  "feature_kinds": list(problem.feature_kinds),
                  "lb": list(problem.lb), "ub": list(problem.ub),
                  "hard_bc": None,
                  "coords": list(problem.coords),
                  "pad_features": spec.pad_features,
                  "system": {"equations": list(problem.equations),
                             "fields": list(problem.fields)},
                  "coef": coef})
        (out / "system.json").write_text(json.dumps({
            "problem": problem.name,
            "equations": list(problem.equations),
            "fields": list(problem.fields),
            "coef": coef, "rel_l2": rel_l2,
            "rel_l2_fields": (list(rel_fields) if rel_fields else None),
        }, indent=1))
        log(f"system: checkpoint + record written to {out}")

    return SystemResult(rel_l2=rel_l2, rel_l2_fields=rel_fields, coef=coef,
                        params=params, predict=predict, history=history)
