"""Overlapping-patch decomposition: many small nets, one global solution.

Port of ``tpinn.core.patch`` (FBPINN-style; Moseley, Markham &
Nissen-Meyer, 2023).  The box is partitioned into P overlapping patches,
each with its own small net normalized to ITS box, blended by a smooth
partition of unity

    u(z) = Σ_p  ŵ_p(z) · N_p((z − c_p)/h_p),      ŵ_p = w_p / Σ_q w_q

with w_p a cos² bump supported on the patch.  The loss trains all patches
jointly through the summed predictor.

All P nets evaluate at all N points as one batched product chain over
stacked parameters (every leaf has a leading P axis): ``torch.matmul`` of
``[P, N, k]`` by ``[P, k, W]``, the counterpart of tpinn's ``jax.vmap``
over the stacked tree, for every net family (plain, Fourier features,
modified gating).  The predictor advertises no structured partials,
so its derivatives take the generic nested-jvp engine (kernels B1 and B2
serve one scalar net); the Adam update is kernel B3 on the stacked
vector(s) on the card.

With ``checkpoint_every > 0`` a run saves its Adam phase to
``adam_state_stage_1.npz`` and ``resume=True`` continues a killed run from
it, as run_training does.  ``lbfgs_device`` is refused with ValueError
(tpinn's run_patched ignores it).

``mesh`` (tpinn_torch.parallel.make_mesh): point batches shard over its
points axis as in run_system.  With an ensemble axis E > 1 the patches
are split over it (patch-parallelism, :func:`shard_patches`): each
ensemble group evaluates its P/E patches, and the window-weighted sum
crosses the group as one all-reduce of its partial STREAMS (u and the
partial derivatives the residual reads, all linear in the sum; forward-
mode AD does not cross a collective), whose backward passes the
cotangent through.  The stacked parameters stay whole on every rank, so
the step's all-reduce sums each patch's gradient from its owner and
B3 and L-BFGS run on the whole vector, the same on every rank.  The
density refresh and the evaluation run the whole predictor.
"""

from __future__ import annotations

import itertools
import json
import math
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpinn_torch import parallel
from tpinn_torch.core import loss as loss_mod
from tpinn_torch.core import net, optim, pde, sample
from tpinn_torch.core.train import (_DTYPES, _UNUSABLE, ProblemSpec,
                                    TrainSpec, _check_supported, _load_phase,
                                    _phase_saver, eval_grid,
                                    make_density_fn, one_run_at_a_time,
                                    resolve_device, resolve_residual_weight,
                                    resolve_testing_size)
from tpinn_torch.utils import checkpoint as ckpt

Tensor = torch.Tensor


@dataclass(frozen=True)
class PatchSpec:
    """Patch grid: ``n[i]`` patches along axis i, cos²-bump windows.

    ``overlap`` is the fractional widening of each patch beyond its
    uniform cell (0.5 → each patch is 1.5 cells wide).  Must be > 0 so
    neighbouring bumps overlap and the partition of unity stays positive
    everywhere.
    """

    n: Tuple[int, ...]
    overlap: float = 0.5

    def __post_init__(self):
        if not self.n or any(int(k) < 1 for k in self.n):
            raise ValueError(
                f"PatchSpec.n must be positive ints, got {self.n}")
        if not 0.0 < self.overlap <= 2.0:
            raise ValueError("PatchSpec.overlap must be in (0, 2]")

    @property
    def count(self) -> int:
        return math.prod(int(k) for k in self.n)


def patch_geometry(patch: PatchSpec, lb, ub, dtype=torch.float32,
                   device="cpu"):
    """(centers [P, d], half_widths [d]) of the overlapping patch boxes,
    computed in float64 and cast to ``dtype`` on ``device``."""
    lb = np.asarray(lb, np.float64)
    ub = np.asarray(ub, np.float64)
    d = lb.shape[0]
    if len(patch.n) != d:
        raise ValueError(f"PatchSpec.n has {len(patch.n)} axes for a "
                         f"{d}-D domain")
    steps = (ub - lb) / np.asarray(patch.n, np.float64)
    half = steps * (1.0 + patch.overlap) / 2.0
    axes = [lb[i] + (np.arange(patch.n[i]) + 0.5) * steps[i]
            for i in range(d)]
    centers = np.asarray(list(itertools.product(*axes)), np.float64)
    return (torch.tensor(centers, dtype=dtype, device=device),
            torch.tensor(half, dtype=dtype, device=device))


def make_patch_predictor(
    mspec: net.MLPSpec,
    patch: PatchSpec,
    lb,
    ub,
    dtype=torch.float32,
    pad_features: int = 0,
    device="cpu",
):
    """``u(stacked_params, z)`` over the partition of unity.

    ``stacked_params`` carries a leading P axis on every leaf (init via
    :func:`init_patch_params`).  Each patch's features are the min-max
    map of z to that patch's own box, padded as net.FeatureMap pads."""
    centers, half = patch_geometry(patch, lb, ub, dtype, device)
    d = centers.shape[1]
    n_pad = net.feature_map_for((net.MINMAX,) * d,
                                pad_to=pad_features).num_features - d
    lo = centers - half[None, :]
    hi = centers + half[None, :]

    def _window(z):
        # cos² bump per axis, product over axes: [P, N, 1]
        t = (torch.abs(z[None, :, :] - centers[:, None, :])
             / half[None, None, :])
        w = torch.where(t < 1.0,
                        torch.cos(0.5 * math.pi * torch.clamp(t, max=1.0))
                        ** 2, 0.0)
        out = w[..., 0:1]
        for i in range(1, d):
            out = out * w[..., i:i + 1]
        return out

    def patch_sum(stacked, z, rows=slice(None)):
        """The partition of unity's sum over the patches ``rows`` (all of
        them by default), normalized by every patch's window."""
        stacked = optim._rebuild(stacked, iter(
            x[rows] for x in optim.tree_leaves(stacked)))
        feats = (2.0 * (z[None, :, :] - lo[rows, None, :])
                 / (hi - lo)[rows, None, :] - 1.0)            # [P, N, d]
        if n_pad:
            feats = torch.cat([feats] + [feats[..., :1]] * n_pad, dim=-1)
        # net.mlp_apply on P nets at once: [P, N, k] @ [P, k, W], the
        # biases [P, W] broadcast over the points as [P, 1, W]; [P, N, 1]
        batched = {k: ({"w": v["w"], "b": v["b"][:, None]}
                       if k in ("gate_u", "gate_v") else v)
                   for k, v in stacked.items() if k != "layers"}
        batched["layers"] = [{"w": layer["w"], "b": layer["b"][:, None]}
                             for layer in stacked["layers"]]
        u_all = mspec.epsil * net.mlp_apply(batched, feats, mspec)
        w = _window(z)
        return (torch.sum(u_all * w[rows], dim=0)
                / (torch.sum(w, dim=0) + 1e-12))

    def predictor(stacked, z):
        return patch_sum(stacked, z)

    predictor.tpinn_patch = (centers, half)
    predictor.tpinn_patch_sum = patch_sum
    return predictor


def shard_patches(predictor, count: int, mesh):
    """The patch-parallel form of a patch predictor on ``mesh``: this
    rank's ensemble group evaluates its ``count / E`` patches and the sum
    crosses the group (Mesh.ensemble_sum).  Its ``tpinn_partials`` (the
    loss's "fused" engine) takes the local sum's partials through the
    generic engine and all-reduces them packed, once; the plain call (the
    BC values) all-reduces u."""
    from tpinn_torch.core import deriv

    n_ens = mesh.shape["ensemble"]
    if count % n_ens:
        raise ValueError(f"{count} patches not divisible by the mesh's "
                         f"ensemble axis ({n_ens})")
    k = count // n_ens
    rows = slice(mesh.ensemble_index * k, (mesh.ensemble_index + 1) * k)
    part = predictor.tpinn_patch_sum

    def sharded(stacked, z):
        return mesh.ensemble_sum(part(stacked, z, rows))

    def partials(stacked, z, indices):
        local = deriv.partials(lambda zz: part(stacked, zz, rows), z,
                               indices)
        keys = list(local)
        summed = mesh.ensemble_sum(torch.cat([local[i] for i in keys], 1))
        return dict(zip(keys, torch.split(
            summed, [local[i].shape[1] for i in keys], dim=1)))

    sharded.tpinn_partials = partials
    sharded.tpinn_patch = predictor.tpinn_patch
    return sharded


def init_patch_params(generator: torch.Generator, mspec: net.MLPSpec,
                      patch: PatchSpec, dtype=torch.float32,
                      pad_features: int = 0, device="cpu") -> dict:
    """P inits drawn in turn from ``generator``, stacked on a leading
    axis of every leaf."""
    fm = net.feature_map_for((net.MINMAX,) * len(patch.n),
                             pad_to=pad_features)
    trees = [net.init_params(generator, mspec, fm, device, dtype)
             for _ in range(patch.count)]
    stacked = [torch.stack(ls) for ls in
               zip(*(optim.tree_leaves(t) for t in trees))]
    return optim._rebuild(trees[0], iter(stacked))


@dataclass
class PatchResult:
    rel_l2: Optional[float]
    params: dict
    predict: Callable[[Tensor], Tensor]
    history: np.ndarray
    n_patches: int


@one_run_at_a_time
def run_patched(
    problem: ProblemSpec,
    spec: TrainSpec,
    patch: PatchSpec,
    log_fn: Optional[Callable] = None,
    print_log: bool = False,
    mesh=None,
    output_dir: Optional[str] = None,
    resume: bool = False,
    *,
    device,
) -> PatchResult:
    """Train the patched predictor on ``device`` ("cuda" fails without a
    card): single-stage Adam → L-BFGS on the joint stacked tree
    (``spec.stages[0]`` sets the PER-PATCH net).

    Random streams: the P inits, the Adam phase's draws and the L-BFGS
    draw are streams 0, 1 and 2 of ``spec.seed``, as a run_system's.
    ``resume=True`` with ``output_dir``: a finished run's
    params_stage_1.npz is reloaded and nothing is trained; else, with
    ``checkpoint_every > 0``, a killed run's adam_state_stage_1.npz
    continues its Adam phase.
    """
    _check_supported(spec, mesh)
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

    if problem.hard_bc is not None:
        raise ValueError("run_patched poses BCs softly; hard_bc is the "
                         "single-net path (net.wrap_hard_bc)")
    if spec.lbfgs_device is not None:
        raise ValueError("run_patched runs L-BFGS on the training device: "
                         "lbfgs_device must be None")
    if st.pirate_blocks or st.weight_fact is not None:
        raise ValueError("run_patched trains a plain dense net per patch; "
                         "a PirateNet (pirate_blocks, weight_fact) is the "
                         "single-net path (run_training)")
    dropped = [k for k in ("lsq_polish", "deflation")
               if getattr(spec, k, "off") != "off"]
    if spec.ring_weight > 0:
        dropped.append("ring_weight")
    if len(spec.stages) > 1:
        dropped.append(f"stages[1:{len(spec.stages)}]")
    if dropped:
        log("patched: option(s) " + ", ".join(dropped)
            + " have no patched-path implementation and are ignored")
    compiled = pde.compile_pde(problem.equation, problem.coords)
    source_fn = (pde.compile_coord_expr(problem.source, problem.coords)
                 if problem.source else None)
    rw_fn = resolve_residual_weight(problem)

    mspec = net.MLPSpec(
        depth=st.depth, width=st.width,
        act_first=st.act_first, act_hidden=st.act_hidden,
        scl=float(st.scl if st.scl is not None else 1.0),
        epsil=float(st.epsil if st.epsil is not None else 1.0),
    )
    predictor = make_patch_predictor(mspec, patch, problem.lb, problem.ub,
                                     dtype, spec.pad_features, dev)
    params = init_patch_params(seeded(0, "cpu"), mspec, patch, dtype,
                               spec.pad_features, dev)
    log(f"patched: {patch.count} patches ({'x'.join(map(str, patch.n))}), "
        f"{st.depth}x{st.width} net each, overlap {patch.overlap:g}")

    n_ens = mesh.shape["ensemble"] if mesh is not None else 1
    train_pred, engine = predictor, "auto"
    if n_ens > 1:
        train_pred, engine = shard_patches(predictor, patch.count,
                                           mesh), "fused"
        log(f"patched: {patch.count} patches sharded over {n_ens} "
            f"ensemble-axis groups")
    _rc = parallel.counts_rounder(mesh)
    cfg = sample.SamplerConfig(
        n_col=_rc(spec.n_col), n_band=_rc(spec.n_band),
        n_adaptive=_rc(spec.n_adaptive), n_bd=_rc(spec.n_bd),
        grid=spec.grid)
    sample_fn, grids = sample.sampler_for(
        cfg, problem.bc_groups, problem.lb, problem.ub, dtype, dev)
    F0 = torch.ones_like(grids[0])
    density_fn = make_density_fn(predictor, compiled, grids, source_fn,
                                 mask_fn=problem.eval_mask)
    loss_fn = loss_mod.make_loss(train_pred, compiled, source_fn,
                                 engine=engine, residual_weight_fn=rw_fn)
    info_width = loss_mod.loss_info_width(len(problem.bc_groups))

    lw = torch.tensor(spec.lw, dtype=dtype, device=dev)
    gen_adam = seeded(1, dev)
    gen_lbfgs = seeded(2, dev)
    data0_all = data0 = sample_fn(gen_adam, F0)
    loss_fn, sample_fn = parallel.meshed(loss_fn, sample_fn, mesh,
                                         sum_ensemble=n_ens > 1)
    if mesh is not None:
        data0 = parallel.shard_data(data0_all, mesh)
    with torch.no_grad():
        ref = optim.evaluate_loss(loss_fn, params, data0, lw,
                                  torch.ones((), dtype=dtype,
                                             device=dev))[1][0]
    log(f"patched: initial loss {float(ref):.4e}")

    out = Path(output_dir) if output_dir is not None else None
    final_ckpt = out / "params_stage_1.npz" if out else None
    hist_lbfgs = np.zeros((0, info_width), np.float64)
    if resume and final_ckpt is not None and final_ckpt.exists():
        params, _ = ckpt.load_pytree(final_ckpt, params)
        log("patched: resumed finished run from params_stage_1.npz "
            "(training skipped)")
        hist_adam = np.zeros((0, info_width), np.float64)
    else:
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

        phase = optim.make_adam_phase(loss_fn, sample_fn, density_fn,
                                      adam_cfg, info_width, adam_log)
        adam_ckpt = out / "adam_state_stage_1.npz" if out else None
        init_phase = None
        if resume and adam_ckpt is not None and adam_ckpt.exists():
            try:
                init_phase = _load_phase(adam_ckpt, phase, adam_cfg.layout,
                                         st.adam_epochs, gen_adam, params,
                                         data0_all, F0, ref, mesh)
                log(f"patched: resuming Adam mid-run at step "
                    f"{init_phase[0]}/{st.adam_epochs}")
            except _UNUSABLE as e:
                init_phase = None
                log(f"patched: mid-run checkpoint unusable ({e}); "
                    "restarting the Adam phase")
        ckpt_cb = None
        if adam_ckpt is not None and spec.checkpoint_every > 0:
            ckpt_cb = _phase_saver(adam_ckpt, spec.checkpoint_every,
                                   st.adam_epochs, adam_cfg.layout,
                                   init_phase[0] if init_phase else 0, mesh)
        res = phase(gen_adam, params, data0, F0, lw, ref, ckpt_cb=ckpt_cb,
                    init=init_phase)
        params = res.params
        hist_adam = res.history[:res.n_valid].cpu().numpy()
        if res.n_valid:
            log(f"patched: Adam done ({res.n_valid} steps, final loss "
                f"{hist_adam[-1, 0]:.4e})")
        if st.lbfgs_epochs > 0:
            lb_cfg = optim.LBFGSConfig(
                max_iters=max(1, st.lbfgs_epochs // 3),
                history=spec.lbfgs_history)
            with torch.no_grad():
                data_l = sample_fn(gen_lbfgs, res.density)
            params, hist, n_rows = optim.lbfgs_over_pytree(
                loss_fn, params, data_l, lw, ref, lb_cfg)
            hist_lbfgs = hist[:n_rows].cpu().numpy()
    if mesh is not None:
        mesh.check_replicas(params)

    predict = lambda z: predictor(params, z)
    rel_l2 = None
    if problem.exact is not None:
        tsize = resolve_testing_size(problem, spec.testing_size, log,
                                     label="patched: ")
        X_star, _, _ = eval_grid(problem, tsize, dtype, dev)
        with torch.no_grad():
            u = predict(X_star)
            e = torch.as_tensor(problem.exact(X_star), dtype=dtype,
                                device=dev)
            if problem.eval_mask is not None:
                m = problem.eval_mask(X_star)
                u, e = u * m, e * m
            rel_l2 = float(loss_mod.relative_l2(u, e))
        log(f"patched: rel-L2 {rel_l2:.3e}")

    history = (np.concatenate([hist_adam, hist_lbfgs], axis=0)
               if hist_lbfgs.size else hist_adam)

    if out is not None and parallel.is_writer(mesh):
        out.mkdir(parents=True, exist_ok=True)
        ckpt.save_pytree(
            out / "params_stage_1.npz", params,
            meta={"stage": 1, "scl": mspec.scl, "epsil": mspec.epsil,
                  "problem": problem.name,
                  "chain": [net.spec_to_dict(mspec)],
                  "feature_kinds": list(problem.feature_kinds),
                  "lb": list(problem.lb), "ub": list(problem.ub),
                  "hard_bc": None, "coords": list(problem.coords),
                  "pad_features": spec.pad_features,
                  "equation": problem.equation,
                  "patch": {"n": list(patch.n),
                            "overlap": patch.overlap}})
        (out / "patched.json").write_text(json.dumps({
            "problem": problem.name, "n_patches": patch.count,
            "n": list(patch.n), "overlap": patch.overlap,
            "rel_l2": rel_l2,
        }, indent=1))
        log(f"patched: checkpoint written to {out}")

    return PatchResult(rel_l2=rel_l2, params=params, predict=predict,
                       history=history, n_patches=patch.count)
