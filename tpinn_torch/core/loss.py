"""Loss system: per-BC-group data terms + PDE residual term.

Port of ``tpinn.core.loss`` with the same ``loss_info`` column contract:

    loss_info = [loss, loss_data, loss_eqn, data_err_1..G, eqn_err...]

- ``data_err_i``: MSE of (u_pred − u_bc) for BC group i (or of a
  Neumann/Robin operator of u, ``bc_operators``).
- ``eqn_err``: MSE of the PDE residual over the collocation points (plus
  one column for the residual-gradient term with ``deriv_loss``).
- ``loss = loss_data + lw[0] * loss_eqn``; the function returns
  ``loss / ref`` (normalized by the loss at initialization) and the
  gradient is taken of that.

Residual engines: "generic" (nested ``torch.func.jvp``), "fused" (the
predictor's structured partials), "kernel" (kernels B1/B2 through their
autograd Function; plain dense nets and hard-BC wrappers around one) and
"auto" (``pde.residual_fast``: B1/B2 for float32 plain nets, the generic
engine otherwise; with ``deriv_loss`` the generic engine, as in
``tpinn``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from tpinn_torch.core.pde import CompiledPDE

Tensor = torch.Tensor

ENGINES = ("auto", "generic", "fused", "kernel")


def ms_error(diff: Tensor) -> Tensor:
    """Columnwise mean squared error; an EMPTY batch contributes zero (not
    NaN): with full hard-BC ansatzes n_bd = 0 is a legal configuration."""
    if diff.shape[0] == 0:
        return diff.new_zeros(diff.shape[1:])
    return torch.mean(torch.square(diff), dim=0)


def _is_plain_kernel_net(predictor) -> bool:
    return (hasattr(predictor, "tpinn_spec")
            and predictor.tpinn_spec.is_plain
            and predictor.tpinn_spec.out_dim == 1)


def kernel_engine_unavailable(predictor, deriv_loss: bool) -> Optional[str]:
    """Why ``engine='kernel'`` cannot serve this loss, or None if it can.

    A structural decision, taken before any loss is built: the kernels
    serve a plain dense predictor (make_predictor) or a hard-BC wrapper
    around one, and they give no gradient in z, which the residual-
    gradient term (``deriv_loss``) needs."""
    if deriv_loss:
        return ("engine='kernel' cannot serve deriv_loss (the kernels give "
                "no z-derivative of the residual); use 'auto' or 'generic'")
    if _is_plain_kernel_net(predictor):
        return None
    if hasattr(predictor, "tpinn_hard") and _is_plain_kernel_net(
            getattr(predictor, "tpinn_raw", None)):
        return None
    return ("engine='kernel' needs a plain dense predictor (make_predictor) "
            "or a hard-BC wrapper around one; composed/fourier/modified "
            "families use 'auto'")


def _kernel_partials_for(predictor, pde: CompiledPDE):
    """The kernel engine's partials: B1/B2 on the plain net, recombined by
    the product rule under a hard-BC wrapper (net.hard_bc_partials)."""
    from tpinn_torch.core.net import hard_bc_partials
    from tpinn_torch.kernels.taylor_vjp import make_kernel_partials

    if hasattr(predictor, "tpinn_spec"):
        return make_kernel_partials(
            predictor.tpinn_spec, predictor.tpinn_feature_map,
            *(t.tolist() for t in predictor.tpinn_bounds), pde.indices)
    # hard-BC ansatz u = lift + bubble·N: the kernels run on the raw net N
    # over the product rule's index superset (value + component firsts)
    raw = predictor.tpinn_raw
    need = set(pde.indices) | {()}
    for ix in pde.indices:
        for i in ix:
            need.add((i,))
    raw_kernel = make_kernel_partials(
        raw.tpinn_spec, raw.tpinn_feature_map,
        *(t.tolist() for t in raw.tpinn_bounds),
        tuple(sorted(need, key=lambda t: (len(t), t))))
    lift_fn, bubble_fn = predictor.tpinn_hard
    return hard_bc_partials(raw_kernel, lift_fn, bubble_fn)


def make_loss(
    predictor: Callable[[dict, Tensor], Tensor],
    pde: CompiledPDE,
    source_fn: Optional[Callable[[Tensor], Tensor]] = None,
    deriv_loss: bool = False,
    engine: str = "auto",
    residual_weight_fn: Optional[Callable[[Tensor], Tensor]] = None,
    bc_operators=None,
    ring=None,
    causal=None,
):
    """Build ``loss_fn(params, data, lw, ref) -> (loss_n, loss_info)``.

    Arguments as ``tpinn.core.loss.make_loss``: ``source_fn`` (residual −=
    g(z)), ``deriv_loss`` (the residual-gradient MSE weighted by lw[1],
    one extra eqn_err column), ``residual_weight_fn`` (pointwise w(z)·f),
    ``bc_operators`` (per-group compiled boundary operators or None),
    ``causal`` (``{"axis", "t0", "t1", "bins", "eps"}``: slab i's residual
    weighted by exp(−eps · Σ_{j<i} L_j / Σ_j L_j), detached; loss_eqn
    becomes the weighted term while the eqn_err columns stay unweighted;
    with a ``"mesh"`` the slab sums and counts are all-reduced over its
    points group first, so a shard weighs its points as the global batch
    does).
    ``ring`` is the resonance-band penalty of
    ``polish.ring_penalty_setup``, ``{"z": [N,d], "P": [N,M], "weight":
    w}``: it adds ``w·‖Pᵀ r(z)‖²``, the implied mean-square ring-mode
    error of the live residual, to the total (the ``loss`` column only;
    the loss_info layout is unchanged).  The raw residual is used, without
    ``residual_weight_fn``: P already carries the quadrature weights and
    the 1/ε amplification."""
    from tpinn_torch.core import deriv as deriv_mod

    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    kernel_partials = None
    if engine == "kernel":
        why = kernel_engine_unavailable(predictor, deriv_loss)
        if why is not None:
            raise ValueError(why)
        kernel_partials = _kernel_partials_for(predictor, pde)
    # 'auto' with the residual-gradient term: the generic engine, whose
    # jvp the term differentiates again in z
    res_engine = "generic" if engine == "auto" and deriv_loss else engine

    def residual_at(params, z):
        if res_engine == "generic":
            f = pde.residual(lambda zz: predictor(params, zz), z)
        elif res_engine == "fused":
            f = pde.evaluate(z, predictor.tpinn_partials(params, z,
                                                         pde.indices))
        elif res_engine == "kernel":
            f = pde.evaluate(z, kernel_partials(params, z, pde.indices))
        else:
            f = pde.residual_fast(predictor, params, z)
        if source_fn is not None:
            f = f - source_fn(z)
        return f

    def loss_fn(params: dict, data: Dict, lw: Tensor, ref: Tensor):
        def f_u(z):
            return predictor(params, z)

        x_col = data["x_col"]
        data_errs = []
        for gi, (z_bd, u_bd) in enumerate(zip(data["x_bd"], data["u_bd"])):
            op = bc_operators[gi] if bc_operators else None
            bd_val = op.residual(f_u, z_bd) if op is not None else f_u(z_bd)
            data_errs.append(ms_error(bd_val - u_bd))
        data_err = (torch.cat(data_errs) if data_errs
                    else x_col.new_zeros((0,)))

        f = residual_at(params, x_col)
        if residual_weight_fn is not None:
            f = residual_weight_fn(x_col) * f
        eqn_errs = [ms_error(f)]

        if deriv_loss:
            # d(residual)/dz by forward mode over the residual itself
            d = x_col.shape[1]
            dparts = deriv_mod.partials(lambda z: residual_at(params, z),
                                        x_col, [(i,) for i in range(d)])
            df = torch.cat([dparts[(i,)] for i in range(d)], dim=1)
            eqn_errs.append(torch.mean(ms_error(df)).reshape(1))

        eqn_err = torch.cat(eqn_errs)
        loss_data = torch.sum(data_err)
        n_res_cols = eqn_errs[0].shape[0]
        if causal is not None:
            # per-slab mean residual → exclusive prefix share → slab
            # weights, applied per POINT so eps → 0 gives the plain MSE
            r2 = torch.sum(torch.square(f), dim=1)
            nb = causal["bins"]
            pos = ((x_col[:, causal["axis"]] - causal["t0"])
                   / (causal["t1"] - causal["t0"]))
            idx = torch.clamp((pos * nb).to(torch.int32), 0, nb - 1).long()
            sums = r2.new_zeros(nb).index_add_(0, idx, r2)
            counts = r2.new_zeros(nb).index_add_(0, idx, torch.ones_like(r2))
            if causal.get("mesh") is not None:
                # the slab statistics of the GLOBAL batch: this shard's
                # sums and counts added over the points group
                both = causal["mesh"].all_reduce(
                    torch.stack([sums, counts]), "points")
                sums, counts = both[0], both[1]
            l_slab = sums / torch.clamp(counts, min=1.0)
            tot = torch.sum(l_slab)
            w_slab = torch.exp(-causal["eps"] * (torch.cumsum(l_slab, 0)
                                                 - l_slab)
                               / torch.clamp(tot, min=1e-30)).detach()
            res_term = torch.mean(w_slab[idx] * r2)
        else:
            res_term = torch.sum(eqn_err[:n_res_cols])
        if deriv_loss:
            loss_eqn = res_term + lw[1] * eqn_err[n_res_cols]
        else:
            loss_eqn = res_term
        loss = loss_data + lw[0] * loss_eqn
        if ring is not None:
            f_ring = residual_at(params, ring["z"])
            loss = loss + ring["weight"] * torch.sum(
                torch.square(torch.matmul(ring["P"].T, f_ring)))
        loss_n = loss / ref
        loss_info = torch.cat([torch.stack([loss, loss_data, loss_eqn]),
                               data_err, eqn_err])
        return loss_n, loss_info

    return loss_fn


def loss_info_width(num_bc_groups: int) -> int:
    """Number of columns in loss_info: 3 + G data terms + 1 residual term."""
    return 3 + num_bc_groups + 1


def relative_l2(u_pred: Tensor, u_true: Tensor) -> Tensor:
    """rel-L2 error, the parity/convergence gate metric."""
    return torch.linalg.norm(u_pred - u_true) / torch.linalg.norm(u_true)
