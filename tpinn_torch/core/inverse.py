"""Inverse problems: recover unknown PDE coefficients from observations.

Port of ``tpinn.core.inverse``.  The equation string declares named
unknown coefficients (``"u_t - lam*u_xx"`` with ``params=("lam",)``,
pde.compile_pde), the coefficients become 0-d leaves of the joint
``{"net", "coef"}`` training tree, and a pointwise observation term

    loss = loss_bc + obs_weight·MSE(u(z_obs) − u_obs) + lw[0]·loss_eqn

identifies them jointly with the network weights.  ``normalize`` > 0 is
the eigenvalue mode: the observation term becomes the mean-square pin
``(mean u² − normalize)²`` over fixed LHS points, which excludes the
trivial u ≡ 0 of a homogeneous eigenproblem.

The residual takes ``compiled.residual_fast`` with the coefficient dict
threaded through the expression: on float32 CUDA points of a plain (or
hard-BC wrapped) net that is kernel B1 forward and kernel B2 backward,
the coefficient multiplying B1's streams inside the expression and its
gradient coming from them through autograd.  The Adam update is kernel
B3 (optim.make_adam_phase): with ``adam_layout="flat"`` one vector holds
the net and the coefficients, with ``"tree"`` each coefficient is a
1-element vector of its own.  Then L-BFGS on a density-weighted draw.

``loss_info`` layout: ``[loss, loss_data, loss_eqn, data_err_1..G,
obs_err, eqn_err]``: the observation term is a data term, one column
after the BC groups.

Deviations from tpinn: ``run_inverse`` takes a keyword-only ``device``,
applies ``adam_precision`` as run_training does and refuses what
train._check_supported refuses (a ``mesh`` that is not a
tpinn_torch.parallel.Mesh), and ``checkpoint_every > 0`` and a
``lbfgs_device`` (tpinn writes no
mid-stage checkpoint here and ignores both) with ValueError;
its random streams are ``spec.seed`` streams 0, 1 and 2 (net init, Adam
draws, L-BFGS draw) as in run_system, where tpinn splits one PRNG key;
it logs "inverse: Adam done (N steps), lam=…" where tpinn logs
"inverse: after Adam lam=…".

``mesh`` (tpinn_torch.parallel.make_mesh) shards the point batches over
its points axis as run_system does; the observation term (and the eigen
mode's normalization pin) is computed whole on every rank, and rank 0
writes.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpinn_torch import parallel
from tpinn_torch.core import loss as loss_mod
from tpinn_torch.core import net, optim, pde, sample
from tpinn_torch.core.train import (_DTYPES, ProblemSpec, TrainSpec,
                                    _check_supported, _write_stage_artifacts,
                                    adam_matmul_precision, eval_grid,
                                    make_density_fn, one_run_at_a_time,
                                    resolve_device, resolve_residual_weight,
                                    resolve_testing_size)
from tpinn_torch.utils import artifacts
from tpinn_torch.utils import checkpoint as ckpt

Tensor = torch.Tensor


@dataclass(frozen=True)
class InverseSpec:
    """What to identify: coefficient names, initial guesses, observations.

    ``params``/``init`` must align; the names must appear in the problem's
    equation strings.  When no observations are passed, ``n_obs`` points
    are LHS-drawn over the domain from a generator seeded with
    ``obs_seed`` and labelled by ``problem.exact`` (+ optional Gaussian
    noise of std ``obs_noise``).  ``normalize`` > 0 selects the eigenvalue
    mode: the observation MSE is replaced by (mean u² over the ``n_obs``
    points − normalize)²; for −u'' = λu on [0, 1], normalize=0.5 targets
    ‖sin πx‖².
    """

    params: Tuple[str, ...]
    init: Tuple[float, ...]
    n_obs: int = 200
    obs_noise: float = 0.0
    obs_weight: float = 1.0
    obs_seed: int = 0
    normalize: float = 0.0

    def __post_init__(self):
        if len(self.params) != len(self.init):
            raise ValueError("InverseSpec.init must align with .params")
        if not self.params:
            raise ValueError("InverseSpec needs at least one parameter")
        if self.normalize < 0:
            raise ValueError("InverseSpec.normalize must be >= 0")


@dataclass
class InverseResult:
    coef: Dict[str, float]                 # recovered coefficient values
    coef_adam: Dict[str, float]            # values at the Adam→L-BFGS handoff
    rel_l2: Optional[float]                # solution error vs analytic
    params: dict                           # joint {"net", "coef"} tree
    predict: Callable[[Tensor], Tensor]    # z -> u with trained weights
    history: np.ndarray                    # loss_info rows, both phases
    z_obs: np.ndarray
    u_obs: np.ndarray


def make_inverse_loss(
    predictor: Callable[[dict, Tensor], Tensor],
    compiled: pde.CompiledPDE,
    z_obs: Tensor,
    u_obs: Tensor,
    source_fn: Optional[Callable[[Tensor], Tensor]] = None,
    residual_weight_fn: Optional[Callable[[Tensor], Tensor]] = None,
    obs_weight: float = 1.0,
    bc_operators=None,
    normalize: float = 0.0,
):
    """Joint loss over ``params = {"net": net_tree, "coef": {name: 0-d}}``
    with the ``(params, data, lw, ref) -> (loss_n, loss_info)`` contract of
    loss.make_loss, so the optimizer drivers are reused as they are."""

    def loss_fn(params: dict, data: Dict, lw: Tensor, ref: Tensor):
        net_p, coef = params["net"], params["coef"]
        f_u = lambda z: predictor(net_p, z)

        data_errs = []
        for gi, (z_bd, u_bd) in enumerate(zip(data["x_bd"], data["u_bd"])):
            op = bc_operators[gi] if bc_operators else None
            # operator BCs may read the unknown coefficients too (a Robin
            # condition with an unknown transfer coefficient)
            bd_val = (op.residual(f_u, z_bd, coef) if op is not None
                      else f_u(z_bd))
            data_errs.append(loss_mod.ms_error(bd_val - u_bd))
        if normalize > 0.0:
            # eigen mode: pin the mean-square amplitude instead of values
            u_n = f_u(z_obs)
            obs_err = ((torch.mean(u_n * u_n) - normalize) ** 2).reshape(1)
        else:
            obs_err = loss_mod.ms_error(f_u(z_obs) - u_obs)
        data_errs.append(obs_err)
        data_err = torch.cat(data_errs)

        x_col = data["x_col"]
        f = compiled.residual_fast(predictor, net_p, x_col, coef)
        if source_fn is not None:
            f = f - source_fn(x_col)
        if residual_weight_fn is not None:
            f = residual_weight_fn(x_col) * f
        eqn_err = loss_mod.ms_error(f)

        loss_data = torch.sum(data_err[:-1]) + obs_weight * obs_err[0]
        loss_eqn = torch.sum(eqn_err)
        loss = loss_data + lw[0] * loss_eqn
        loss_info = torch.cat(
            [torch.stack([loss, loss_data, loss_eqn]), data_err, eqn_err])
        return loss / ref, loss_info

    return loss_fn


def synth_observations(problem, inv: InverseSpec, dtype, device="cpu",
                       n_fields: int = 1) -> Tuple[Tensor, Tensor]:
    """``inv.n_obs`` LHS points over the problem's box, from a CPU
    generator seeded with ``inv.obs_seed`` (the same draw on every
    device), labelled by ``problem.exact`` plus Gaussian noise of std
    ``inv.obs_noise`` of shape ``[n_obs, n_fields]``, on ``device``.  The
    scalar path and core.system's full-state observations share it."""
    if problem.exact is None:
        raise ValueError(
            f"problem {problem.name!r} has no analytic solution to "
            f"synthesize observations from — pass observations=(z, u)")
    gen = torch.Generator().manual_seed(inv.obs_seed)
    z_obs = sample.lhs_box(gen, inv.n_obs, problem.lb, problem.ub, dtype)
    noise = (inv.obs_noise * torch.randn((inv.n_obs, n_fields),
                                         generator=gen, dtype=dtype)
             if inv.obs_noise > 0.0 else None)
    z_obs = z_obs.to(device)
    u_obs = torch.as_tensor(problem.exact(z_obs), dtype=dtype, device=device)
    if noise is not None:
        u_obs = u_obs + noise.to(device)
    return z_obs, u_obs


@one_run_at_a_time
def run_inverse(
    problem: ProblemSpec,
    inv: InverseSpec,
    spec: TrainSpec,
    observations: Optional[Tuple[Tensor, Tensor]] = None,
    log_fn: Optional[Callable] = None,
    print_log: bool = False,
    mesh=None,
    output_dir: Optional[str] = None,
    *,
    device,
) -> InverseResult:
    """Identify the equation's unknown coefficients on ``device`` ("cuda"
    fails without a card): one stage, Adam then L-BFGS over the joint
    tree; ``spec.stages[0]`` sets the architecture and the budgets.

    ``output_dir`` gets ``params_stage_1.npz`` (the net, with the
    equation and the recovered coefficients in its meta: app.serve serves
    it with no preset, ``/residual`` at the recovered values),
    ``inverse.json`` and, for ``dim <= 2``, the UI figure artifacts at the
    recovered coefficients with the observation points as the collocation
    set."""
    _check_supported(spec, mesh)
    if spec.checkpoint_every > 0:
        raise ValueError("run_inverse writes no mid-stage Adam checkpoint: "
                         "checkpoint_every must be 0")
    if spec.lbfgs_device is not None:
        raise ValueError("run_inverse runs L-BFGS on the training device: "
                         "lbfgs_device must be None")
    if not spec.stages:
        spec = spec.with_default_stages()
    st = spec.stages[0]
    dev = resolve_device(device)
    dtype = _DTYPES[spec.dtype]

    def log(msg: str):
        if log_fn is not None:
            log_fn(msg)
        if print_log:
            print(msg, file=sys.stderr)

    def seeded(k: int, where) -> torch.Generator:
        return torch.Generator(device=where).manual_seed(spec.seed * 1000 + k)

    compiled = pde.compile_pde(problem.equation, problem.coords, inv.params)
    source_fn = (pde.compile_coord_expr(problem.source, problem.coords)
                 if problem.source else None)
    rw_fn = resolve_residual_weight(problem)
    feature_map = net.feature_map_for(problem.feature_kinds,
                                      pad_to=spec.pad_features)
    lb = torch.tensor(problem.lb, dtype=dtype, device=dev)
    ub = torch.tensor(problem.ub, dtype=dtype, device=dev)
    mspec = net.MLPSpec(
        depth=st.depth, width=st.width, act_first=st.act_first,
        act_hidden=st.act_hidden,
        scl=float(st.scl if st.scl is not None else 1.0),
        epsil=float(st.epsil if st.epsil is not None else 1.0),
        fourier_features=st.fourier_features,
        fourier_scale=st.fourier_scale, modified=st.modified,
    )
    net_params = net.init_params(seeded(0, "cpu"), mspec, feature_map, dev,
                                 dtype)
    predictor = net.make_predictor(mspec, feature_map, lb, ub)
    if problem.hard_bc is not None:
        predictor = net.wrap_hard_bc(predictor, *(
            pde.compile_coord_expr(e, problem.coords)
            for e in problem.hard_bc))
    params = {"net": net_params,
              "coef": {n: torch.tensor(float(v), dtype=dtype, device=dev)
                       for n, v in zip(inv.params, inv.init)}}

    if inv.normalize > 0.0:
        # eigen mode: fixed LHS normalization points, no labels needed
        z_obs = sample.lhs_box(torch.Generator().manual_seed(inv.obs_seed),
                               inv.n_obs, problem.lb, problem.ub,
                               dtype).to(dev)
        u_obs = torch.zeros((inv.n_obs, 1), dtype=dtype, device=dev)
        log(f"inverse: eigen mode — {len(inv.params)} coefficient(s) "
            f"{inv.params}, mean-square normalization {inv.normalize:g} "
            f"over {inv.n_obs} points")
    else:
        if observations is not None:
            z_obs = torch.as_tensor(observations[0], dtype=dtype, device=dev)
            u_obs = torch.as_tensor(observations[1], dtype=dtype, device=dev)
            if u_obs.ndim == 1:
                u_obs = u_obs[:, None]
        else:
            z_obs, u_obs = synth_observations(problem, inv, dtype, dev)
        log(f"inverse: {len(inv.params)} coefficient(s) {inv.params}, "
            f"{z_obs.shape[0]} observations (noise {inv.obs_noise:g})")

    _rc = parallel.counts_rounder(mesh)
    cfg = sample.SamplerConfig(
        n_col=_rc(spec.n_col), n_band=_rc(spec.n_band),
        n_adaptive=_rc(spec.n_adaptive), n_bd=_rc(spec.n_bd),
        grid=spec.grid)
    sample_fn, grids = sample.sampler_for(
        cfg, problem.bc_groups, problem.lb, problem.ub, dtype, dev)
    F0 = torch.ones_like(grids[0])

    # adaptive density over the joint tree: the residual (and so the
    # refresh) depends on the live coefficient
    density = make_density_fn(predictor, compiled, grids, source_fn,
                              mask_fn=problem.eval_mask)
    density_fn = lambda joint: density(joint["net"], joint["coef"])

    bc_ops = tuple(pde.compile_pde(g.operator, problem.coords, inv.params)
                   if g.operator else None for g in problem.bc_groups)
    if not any(o is not None for o in bc_ops):
        bc_ops = None
    loss_fn = make_inverse_loss(
        predictor, compiled, z_obs, u_obs, source_fn, rw_fn, inv.obs_weight,
        bc_operators=bc_ops, normalize=inv.normalize)
    info_width = loss_mod.loss_info_width(len(problem.bc_groups)) + 1

    lw = torch.tensor(spec.lw, dtype=dtype, device=dev)
    gen_adam = seeded(1, dev)
    gen_lbfgs = seeded(2, dev)
    loss_fn, sample_fn = parallel.meshed(loss_fn, sample_fn, mesh)
    data0 = sample_fn(gen_adam, F0)
    with torch.no_grad():
        ref = optim.evaluate_loss(loss_fn, params, data0, lw,
                                  torch.ones((), dtype=dtype,
                                             device=dev))[1][0]
    log(f"inverse: initial loss {float(ref):.4e}, "
        + " ".join(f"{n}={float(v):.6g}" for n, v in params["coef"].items()))

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
    coef_adam = {n: float(v) for n, v in params["coef"].items()}
    hist_adam = res.history[:res.n_valid].cpu().numpy()
    log(f"inverse: Adam done ({res.n_valid} steps), "
        + " ".join(f"{n}={v:.6g}" for n, v in coef_adam.items()))

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
    coef = {n: float(v) for n, v in params["coef"].items()}
    log("inverse: after L-BFGS "
        + " ".join(f"{n}={v:.6g}" for n, v in coef.items()))

    net_final = params["net"]
    predict = lambda z: predictor(net_final, z)

    tsize = resolve_testing_size(problem, spec.testing_size, log,
                                 label="inverse: ")
    X_star, axes, _ = eval_grid(problem, tsize, dtype, dev)
    with torch.no_grad():
        u_star = predict(X_star)
        exact_star = (torch.as_tensor(problem.exact(X_star), dtype=dtype,
                                      device=dev)
                      if problem.exact is not None else None)
        if problem.eval_mask is not None:
            m_star = torch.as_tensor(problem.eval_mask(X_star), dtype=dtype,
                                     device=dev)
            u_star = u_star * m_star
            if exact_star is not None:
                exact_star = exact_star * m_star
    rel_l2 = None
    if exact_star is not None:
        rel_l2 = float(loss_mod.relative_l2(u_star, exact_star))
        if inv.normalize > 0.0:
            # eigen mode: the eigenfunction's sign is arbitrary
            rel_l2 = min(rel_l2, float(loss_mod.relative_l2(u_star,
                                                            -exact_star)))
        log(f"inverse: solution rel-L2 {rel_l2:.3e}")

    history = (np.concatenate([hist_adam, hist_lbfgs], axis=0)
               if hist_lbfgs.size else hist_adam)

    if output_dir is not None and parallel.is_writer(mesh):
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        ckpt.save_pytree(
            out / "params_stage_1.npz", net_final,
            meta={"stage": 1, "scl": mspec.scl, "epsil": mspec.epsil,
                  "problem": problem.name,
                  "chain": [net.spec_to_dict(mspec)],
                  "feature_kinds": list(problem.feature_kinds),
                  "lb": list(problem.lb), "ub": list(problem.ub),
                  "hard_bc": (list(problem.hard_bc)
                              if problem.hard_bc else None),
                  "coords": list(problem.coords),
                  "pad_features": spec.pad_features,
                  "equation": problem.equation,
                  "coef": coef, "inverse": True})
        (out / "inverse.json").write_text(json.dumps({
            "problem": problem.name, "equation": problem.equation,
            "coef": coef, "coef_adam": coef_adam, "rel_l2": rel_l2,
            "n_obs": int(z_obs.shape[0]), "obs_noise": inv.obs_noise,
        }, indent=1))
        if problem.dim <= 2:
            # the UI figure artifacts: fields at the RECOVERED
            # coefficients, the loss history with the obs column, the
            # observation points on the collocation tab
            coef_t = {k: torch.tensor(v, dtype=dtype, device=dev)
                      for k, v in coef.items()}
            with torch.no_grad():
                f_star = compiled.residual_fast(predictor, net_final, X_star,
                                                coef_t)
                if source_fn is not None:
                    f_star = f_star - source_fn(X_star)
            u_np, f_np = u_star.cpu().numpy(), f_star.cpu().numpy()
            if problem.dim == 1:
                U, F = u_np[:, 0][None, :], f_np[:, 0][None, :]
            else:
                ny, nx = int(tsize[1]), int(tsize[0])
                U, F = u_np.reshape(ny, nx), f_np.reshape(ny, nx)
            _write_stage_artifacts(
                out, 1, problem, spec, axes, U, F,
                (exact_star.cpu().numpy() if exact_star is not None
                 else None), history)
            z_np = z_obs.cpu().numpy()
            artifacts.write_collocation(
                out / "collocation_point_1.npz",
                U=np.ones((8, 8), np.float32),
                X_col=(z_np if problem.dim == 2 else np.concatenate(
                    [z_np, np.zeros_like(z_np)], axis=1)),
                limit=[float(problem.lb[0]), float(problem.ub[0])] + (
                    [float(problem.lb[1]), float(problem.ub[1])]
                    if problem.dim == 2 else [0.0, 1.0]))
        log(f"inverse: checkpoint + record written to {out}")

    return InverseResult(
        coef=coef, coef_adam=coef_adam, rel_l2=rel_l2, params=params,
        predict=predict, history=history,
        z_obs=z_obs.cpu().numpy(), u_obs=u_obs.cpu().numpy())
