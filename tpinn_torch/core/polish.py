"""Exact last-layer least squares and the spectral defect corrections.

Port of ``tpinn.core.polish``.  Two families of float64 post-processing
turn a float32-trained net into the accuracy class the package exists for:

**Last-layer least squares** (a variable-projection step).  For a LINEAR
PDE the residual is affine in the output layer's weights: with the hidden
chain viewed as a learned feature basis h(z) ∈ R^H,

    u(z)        = ε·(h(z)·w + b) + u_prev(z)
    ∂^α u(z)    = ε·(∂^α h(z)·w + [α=∅]·b) + ∂^α u_prev(z)
    residual(z) = Σ_α C_α(z)·∂^α u(z) + d(z)  =  A(z)·[w; b] + c(z)

and the Dirichlet boundary terms are affine in (w, b) too, so the exact
minimizer of the training loss restricted to the output layer,

    Σ_g mean_g (u − u_g)² + lw₀ · mean (residual)²,

is one weighted least-squares solve (:func:`last_layer_lsq`).  It runs in
float64 on the device that holds the parameters: one multi-output
derivative pass over the hidden basis (nested ``torch.func.jvp``, H
outputs instead of 1) and one SVD-based solve (:func:`svd_lstsq`, the same
routine on the CPU and on a CUDA card).

**Spectral defect corrections.**  With L e = r (the error's equation, from
the residual field alone) the error of a trained solution is recovered in
a spectral basis and subtracted:

- :func:`resonant_deflation` — sine eigenmodes of a constant-coefficient
  operator: the resonance band |ε_m| ≤ band·|c₀| (safe for soft BCs), or
  the whole truncated spectrum (``band="full"``, hard-BC ansatz);
- :func:`parabolic_defect` — one march coordinate, per-mode Duhamel series;
- :func:`galerkin_defect` — a general (variable-coefficient or, by one
  Newton step, nonlinear) operator: weighted least squares over a tensor
  basis of Dirichlet sines, Fourier pairs on exactly periodic axes and
  (m−½)π march sines on initial-value axes;
- :func:`soft_defect` — soft-BC runs: a Chebyshev ladder with the known
  boundary trace as extra rows, optionally augmented by the resonance
  band's sine eigenmodes;
- :func:`defect_correction` dispatches between them; :func:`deflation_term`
  rebuilds the correction T(z) from its JSON-safe description (the same
  schema ``tpinn`` writes into checkpoint meta, so a checkpoint written by
  either package loads in the other) and :func:`deflation_fields` adjusts
  already-evaluated u/residual fields;
- :func:`ring_penalty_setup` turns the band identity into a training
  penalty (``loss.make_loss(ring=...)``).

Everything is measured numerically from the compiled AST (eigenvalues,
coefficient fields, diagonality), in float64.  The network enters through
three device calls — its u-partials, its residual and its values on a
float64 grid, all through the generic jvp engine (float64 points never
reach the float32 kernels) — and the basis algebra is host numpy.  No
kernel is launched here.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpinn_torch.core import deriv, net, pde

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# float64 device calls
# ---------------------------------------------------------------------------


def _cast(tree, dtype):
    """The tree with every floating tensor detached and cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.detach().to(dtype)
    return tree


def _tree_device(tree):
    """Device of the first tensor leaf, or None for a tree without one (a
    parameter-free predictor)."""
    if torch.is_tensor(tree):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            found = _tree_device(v)
            if found is not None:
                return found
    return None


def _f64(params, z_np):
    """(params, points) in float64 on the parameters' device."""
    dev = _tree_device(params) or torch.device("cpu")
    z = torch.as_tensor(np.asarray(z_np), dtype=torch.float64, device=dev)
    return _cast(params, torch.float64), z


def _partials_f64(predictor, params, compiled, z_np) -> Dict[tuple, Tensor]:
    """All u-partials of the trained predictor on a grid, float64, kept on
    the device — the linearization point for the Newton–Galerkin
    correction.  May hold byproduct indices beyond ``compiled.indices``."""
    from tpinn_torch.core import taylor

    p64, z64 = _f64(params, z_np)
    with torch.no_grad():
        return taylor.fast_partials(predictor, p64, z64, compiled.indices,
                                    compiled.max_order)


def _residual_f64(predictor, params, compiled, source_fn, z_np) -> np.ndarray:
    """Full residual of the trained predictor on a grid, float64 (same
    policy as train.eval_stage_f64: the measurement must be more precise
    than the model)."""
    p64, z64 = _f64(params, z_np)
    with torch.no_grad():
        f = compiled.residual_fast(predictor, p64, z64)
        if source_fn is not None:
            f = f - source_fn(z64)
    return f.cpu().numpy()


def _u_f64(predictor, params, z_np) -> np.ndarray:
    """Predictor values on a grid, float64."""
    p64, z64 = _f64(params, z_np)
    with torch.no_grad():
        return predictor(p64, z64).cpu().numpy()


def _evaluate_np(compiled, z_np, parts_np) -> np.ndarray:
    """``compiled.evaluate`` on host numpy fields (float64, pointwise
    arithmetic only)."""
    z = torch.as_tensor(np.asarray(z_np), dtype=torch.float64)
    parts = {ix: torch.as_tensor(np.asarray(v), dtype=torch.float64)
             for ix, v in parts_np.items()}
    return compiled.evaluate(z, parts).numpy()


# ---------------------------------------------------------------------------
# Last-layer least squares
# ---------------------------------------------------------------------------


def svd_lstsq(A: Tensor, b: Tensor, rcond: Optional[float] = None) -> Tensor:
    """Minimum-norm least-squares solution of ``A x ≈ b`` by SVD with the
    singular values below ``rcond·σ_max`` cut (``rcond=None``:
    eps·max(M, N), the cutoff of ``numpy.linalg.lstsq``).

    A tall A is first reduced by Householder QR, so the SVD runs on the
    N×N factor R; the singular values are A's.  The same routine runs on
    the CPU and on a CUDA card: ``torch.linalg.lstsq`` offers only the
    full-rank ``gels`` method there, and rank deficiency (duplicate or
    saturated hidden units) is the ordinary case for a learned basis."""
    m, n = A.shape
    if rcond is None:
        rcond = torch.finfo(A.dtype).eps * max(m, n)
    if m > n:
        Q, R = torch.linalg.qr(A, mode="reduced")
        rhs = Q.T @ b
    else:
        R, rhs = A, b
    U, S, Vh = torch.linalg.svd(R, full_matrices=False)
    keep = S >= rcond * S[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)),
                        torch.zeros_like(S))
    return Vh.T @ (s_inv * (U.T @ rhs))


def _split_predictor(predictor, params):
    """Decompose a predictor into (stage_spec, feature_map, lb, ub,
    stage_params, prev_fn, rebuild) where ``rebuild(new_stage_params)``
    reassembles the full parameter pytree."""
    kind = getattr(predictor, "tpinn_kind", None)
    if kind == "sum":
        stage_pred = predictor.tpinn_stage
        prev_pred = predictor.tpinn_prev
        prev_params = params["prev"]
        prev_fn = lambda z: prev_pred(prev_params, z)
        rebuild = lambda sp: {"stage": sp, "prev": prev_params}
        return (stage_pred.tpinn_spec, stage_pred.tpinn_feature_map,
                *stage_pred.tpinn_bounds, params["stage"], prev_fn, rebuild)
    if kind == "mlp":
        return (predictor.tpinn_spec, predictor.tpinn_feature_map,
                *predictor.tpinn_bounds, params, None, lambda sp: sp)
    raise ValueError(
        "last_layer_lsq needs a predictor built by net.make_predictor / "
        "net.compose_stages (tpinn_kind meta missing)"
    )


def _residual_coeffs(compiled, z: Tensor, source_fn):
    """Extract the affine form residual = Σ_α C_α(z)·u_α + d(z) of a linear
    PDE by probing the (cheap, arithmetic-only) AST evaluation."""
    zeros = {ix: torch.zeros((z.shape[0], 1), dtype=z.dtype, device=z.device)
             for ix in compiled.indices}
    base = compiled.evaluate(z, zeros)
    d = base
    if source_fn is not None:
        d = d - source_fn(z)
    ones = torch.ones_like(zeros[next(iter(compiled.indices))])
    coeffs = {}
    for ix in compiled.indices:
        probe = dict(zeros)
        probe[ix] = ones
        coeffs[ix] = compiled.evaluate(z, probe) - base
    return coeffs, d


def last_layer_lsq(
    predictor: Callable,
    compiled,
    params,
    data: Dict,
    lw0: float,
    source_fn: Optional[Callable] = None,
    dtype=torch.float64,
    residual_weight_fn: Optional[Callable] = None,
):
    """Solve the output layer exactly.  Returns ``(new_params, info)``;
    ``new_params`` is in ``dtype`` on the device of ``params`` (cast back
    as the caller's precision policy dictates).  ``info`` carries the
    weighted pre/post objective and ``applied``.

    :param data: point set dict (x_col / x_bd / u_bd) on the same device —
        typically the deterministic L-BFGS grid (train._grid_data) so the
        polish minimizes the true grid residual, not a sampled draw.
    """
    if not compiled.is_linear:
        raise ValueError(
            f"equation {compiled.equation!r} is not linear in u: the "
            f"last-layer subproblem is not a least-squares problem"
        )
    with torch.no_grad():
        return _last_layer_lsq(predictor, compiled, params, data, lw0,
                               source_fn, dtype, residual_weight_fn)


def _last_layer_lsq(predictor, compiled, params, data, lw0, source_fn,
                    dtype, residual_weight_fn):
    # hard-BC ansatz u = lift + bubble·raw: the subproblem stays linear
    # with bubble-scaled features, bubble as the bias basis function, the
    # lift folded into the affine part, and the BC rows identically zero
    hard = getattr(predictor, "tpinn_hard", None)
    if hard is not None:
        lift_fn, bubble_fn = hard
        predictor = predictor.tpinn_raw

    params = _cast(params, dtype)
    spec, fm, lb, ub, stage_params, prev_fn, rebuild = _split_predictor(
        predictor, params)
    data = _cast(data, dtype)
    lb, ub = lb.to(dtype), ub.to(dtype)

    if hard is not None:
        raw_prev = prev_fn
        if raw_prev is not None:
            prev_fn = lambda z: lift_fn(z) + bubble_fn(z) * raw_prev(z)
        else:
            prev_fn = lift_fn

        def h_fn(z):
            return bubble_fn(z) * net.mlp_hidden(stage_params, fm(z, lb, ub),
                                                 spec)

        bias_fn = bubble_fn
    else:
        def h_fn(z):
            return net.mlp_hidden(stage_params, fm(z, lb, ub), spec)

        bias_fn = None

    last = stage_params["layers"][-1]
    if "w" not in last:
        raise ValueError(
            "last_layer_lsq solves for the output layer's weight w; this "
            "net's output layer is weight-factorised (g, v: a PirateNet "
            "with weight_fact), so train it with lsq_polish='off'")
    # the whole module assumes a scalar u: one output column, one bias.
    # A wider output layer would silently solve only column 0's problem
    # (or shape-error later) — reject it up front instead.
    if last["w"].shape[1] != 1 or tuple(last["b"].shape) != (1,):
        raise ValueError(
            f"last_layer_lsq requires a scalar network output; got output "
            f"layer w{tuple(last['w'].shape)}, b{tuple(last['b'].shape)}"
        )

    eps = float(spec.epsil)
    z_col = data["x_col"]
    n_col = z_col.shape[0]

    # residual rows: A_res·[w; b] + c_res, weighted sqrt(lw0 / n_col)
    h_parts = deriv.partials(h_fn, z_col, compiled.indices)   # {α: [N, H]}
    coeffs, d = _residual_coeffs(compiled, z_col, source_fn)
    H = h_parts[next(iter(compiled.indices))].shape[1]
    A_w = z_col.new_zeros((n_col, H))
    A_b = z_col.new_zeros((n_col, 1))
    c_res = d
    if prev_fn is not None:
        prev_parts = deriv.partials(prev_fn, z_col, compiled.indices)
    if bias_fn is not None:
        bias_parts = deriv.partials(bias_fn, z_col, compiled.indices)
    for ix in compiled.indices:
        A_w = A_w + coeffs[ix] * h_parts[ix] * eps
        if bias_fn is not None:
            A_b = A_b + coeffs[ix] * bias_parts[ix] * eps
        elif ix == ():
            A_b = A_b + coeffs[ix] * eps
        if prev_fn is not None:
            c_res = c_res + coeffs[ix] * prev_parts[ix]
    del h_parts
    w_res = (float(lw0) / n_col) ** 0.5
    if residual_weight_fn is not None:
        # pointwise residual weight w(z): scale each residual row so the
        # solve minimizes the same weighted objective as the training loss
        wz = residual_weight_fn(z_col).to(dtype)
        A_w = A_w * wz
        A_b = A_b * wz
        c_res = c_res * wz
    rows_A = [torch.cat([A_w, A_b], dim=1) * w_res]
    rows_b = [-c_res[:, 0] * w_res]

    # boundary rows: ε·(h·w + b) + u_prev = u_bc, weighted 1/sqrt(n_g)
    # (identically zero under the hard-BC ansatz — skipped)
    for z_bd, u_bd in zip([] if hard is not None else data["x_bd"],
                          [] if hard is not None else data["u_bd"]):
        n_g = z_bd.shape[0]
        hb = net.mlp_hidden(stage_params, fm(z_bd, lb, ub), spec)
        Ab = torch.cat([hb * eps, z_bd.new_full((n_g, 1), eps)], dim=1)
        target = u_bd[:, 0]
        if prev_fn is not None:
            target = target - prev_fn(z_bd)[:, 0]
        w_g = 1.0 / n_g ** 0.5
        rows_A.append(Ab * w_g)
        rows_b.append(target * w_g)

    A = torch.cat(rows_A, dim=0)
    b = torch.cat(rows_b, dim=0)

    wb0 = torch.cat([last["w"][:, 0], last["b"]])
    pre = float(torch.sum(torch.square(A @ wb0 - b)))
    # column equilibration: coefficient magnitudes (e.g. 1/r² terms) spread
    # column norms over orders of magnitude; normalize before the SVD cut
    col = torch.linalg.norm(A, dim=0)
    col = torch.where(col > 0, col, torch.ones_like(col))
    wb = svd_lstsq(A / col[None, :], b) / col
    post = float(torch.sum(torch.square(A @ wb - b)))

    if post >= pre:  # never make things worse (rank-deficient corner cases)
        return params, {"pre": pre, "post": post, "applied": False}

    new_last = {"w": wb[:-1][:, None].to(dtype), "b": wb[-1:].to(dtype)}
    new_stage = dict(stage_params)
    new_stage["layers"] = list(stage_params["layers"][:-1]) + [new_last]
    return rebuild(new_stage), {"pre": pre, "post": post, "applied": True}


# ===========================================================================
# Resonant-mode deflation (spectral polish for near-singular linear PDEs)
# ===========================================================================
#
# The trained Helmholtz solution's remaining error concentrates on the
# Dirichlet eigenmodes v_ab = sin(aπx̂)sin(bπŷ) whose eigenvalue under
# L = Δ + k² is nearly zero (λ_ab = π²(a²+b²) ≈ k², the "resonance ring").
# Those modes vanish on the boundary AND nearly annihilate the operator, so
# NO loss weighting can see them.  But linearity makes the leakage exactly
# recoverable from the residual field:
#
#     L e = r   and   L v_m = ε_m v_m   ⇒   ⟨e, v_m⟩ = ⟨r, v_m⟩ / ε_m
#
# so the correction  u ← u − Σ_m (⟨r,v_m⟩/ε_m) v_m  removes the
# near-null-space component in closed form.
#
# Everything is measured numerically from the compiled AST — no symbolic
# coefficient extraction:
#   * ε_m    = ⟨v_m, L v_m⟩/⟨v_m, v_m⟩ with L v built from the mode's
#              analytic partials through CompiledPDE.evaluate (minus the
#              zero-field base, which removes any inline source term);
#   * a diagonality self-test rms(Lv − εv)/rms(Lv) rejects modes the
#              operator does not diagonalize (first-order terms, variable
#              coefficients, time marching — heat's ∂t fails it, so the
#              deflation is naturally inert there);
#   * the resonance band |ε| ≤ band·|c₀| is scaled by the operator's own
#              zeroth-order coefficient c₀ (probed from the AST); c₀ ≈ 0
#              (Poisson) selects nothing.


def _ones(xp, z):
    if xp is np:
        return np.ones((z.shape[0], 1), z.dtype)
    return torch.ones((z.shape[0], 1), dtype=z.dtype, device=z.device)


def _mode_partials(m, lb, ub, z, indices):
    """Analytic partials of v(z) = Π_d sin(m_d π (z_d − lb_d)/L_d) for the
    compiled equation's multi-indices.  Host numpy, float64."""
    d = len(lb)
    return {ix: _mode_partials_subset(m, lb, ub, z, ix, range(d))
            for ix in indices}


def _mode_value(xp, z, m, axes, lb, ub):
    """Π_k sin(m_k π (z[:, j_k] − lb_{j_k})/L_{j_k}) over the coordinate
    columns ``axes``.  ``xp`` is numpy for host f64 callers or torch for
    tensors; dtype (and device) follow ``z``."""
    v = _ones(xp, z)
    for k, j in enumerate(axes):
        w = m[k] * xp.pi / (ub[j] - lb[j])
        v = v * xp.sin(w * (z[:, j:j + 1] - lb[j]))
    return v


# --- mixed tensor basis (Galerkin correction) ------------------------------
# Per-axis factor kinds:
#   ("sin", m)          Dirichlet sine m·π/L (vanishes on both faces)
#   ("psin"/"pcos", n)  periodic Fourier pair at 2πn/L
#   ("one", 0)          the periodic constant
#   ("msin", m)         march sine (m−½)π/L of (z−lb): vanishes at the lb
#                       face only (initial-value axes)
#   ("msinr", m)        mirrored march sine of (ub−z): vanishes at ub only
#   ("cheb", n)         Chebyshev T_n on the axis mapped to [−1, 1]
# A mode is a tuple of one factor per coordinate.


def _factor_freq(kind, n, L, xp):
    if kind == "sin":
        return n * xp.pi / L
    if kind in ("msin", "msinr"):
        return (n - 0.5) * xp.pi / L
    return 2 * n * xp.pi / L


def _cheb_T(t, n):
    """T_n(t) by the three-term recurrence — polynomial in t, so exact
    autodiff derivatives everywhere including t = ±1 (the arccos form is
    non-differentiable there, and serving differentiates the correction
    term through the residual endpoint).  n is static and small."""
    if n == 0:
        return t * 0 + 1.0
    tkm1, tk = t * 0 + 1.0, t
    for _ in range(n - 1):
        tkm1, tk = tk, 2.0 * t * tk - tkm1
    return tk


def _basis_value(xp, z, mode_desc, lb, ub):
    """Order-0 value of a mixed-basis mode; numpy or torch via ``xp``."""
    v = _ones(xp, z)
    for j, (kind, n) in enumerate(mode_desc):
        if kind == "one":
            continue
        L = ub[j] - lb[j]
        if kind == "cheb":
            t = 2.0 * (z[:, j:j + 1] - lb[j]) / L - 1.0
            v = v * _cheb_T(t, n)
            continue
        w = _factor_freq(kind, n, L, xp)
        arg = (ub[j] - z[:, j:j + 1]) if kind == "msinr" \
            else (z[:, j:j + 1] - lb[j])
        t = w * arg
        v = v * (xp.cos(t) if kind == "pcos" else xp.sin(t))
    return v


def _basis_partials(mode_desc, lb, ub, z, indices):
    """Analytic partials of a mixed-basis mode for the compiled equation's
    multi-indices.  Host numpy, float64."""
    cyc_sin = (np.sin, np.cos, lambda a: -np.sin(a), lambda a: -np.cos(a))
    cyc_cos = (np.cos, lambda a: -np.sin(a), lambda a: -np.cos(a), np.sin)
    out = {}
    for ix in indices:
        val = np.ones((z.shape[0], 1))
        for j, (kind, n) in enumerate(mode_desc):
            order = sum(1 for jj in ix if jj == j)
            if kind == "one":
                if order:
                    val = np.zeros((z.shape[0], 1))
                continue
            L = ub[j] - lb[j]
            if kind == "cheb":
                from numpy.polynomial import chebyshev as _cheb

                coef = np.zeros(n + 1)
                coef[n] = 1.0
                t = 2.0 * (z[:, j:j + 1] - lb[j]) / L - 1.0
                val = val * ((2.0 / L) ** order
                             * _cheb.chebval(t, _cheb.chebder(coef, order)
                                             if order else coef))
                continue
            w = _factor_freq(kind, n, L, np)
            if kind == "msinr":
                # f = sin(w·(ub−z)): each ∂_z brings a factor −w
                t = w * (ub[j] - z[:, j:j + 1])
                sgn = (-1.0) ** order
            else:
                t = w * (z[:, j:j + 1] - lb[j])
                sgn = 1.0
            cyc = cyc_cos if kind == "pcos" else cyc_sin
            val = val * sgn * (w ** order) * cyc[order % 4](t)
        out[ix] = val
    return out


def galerkin_defect(
    predictor: Callable,
    params,
    compiled,
    lb,
    ub,
    axis_kinds,
    source_fn: Optional[Callable] = None,
    n_grid: int = 161,
    max_sin: int = 14,
    max_fourier: int = 8,
    drop_tol: float = 0.8,
):
    """Defect correction e ≈ argmin‖L(Σ c_i b_i) − r‖_W for a GENERAL
    linear operator — no eigenmode structure required, unlike the diagonal
    full-band path.  The basis is a tensor product of Dirichlet sines
    (axes where the error carries zero boundary data) and a Fourier family
    (axes where the solution ansatz is exactly periodic, e.g. the annulus
    θ via net.PERIODIC features), and the coefficients come from one
    weighted least-squares solve of the collocated residual — the
    spectral analogue of the last-layer variable projection above.

    NONLINEAR operators are served too: the solve runs against the
    FRÉCHET DERIVATIVE of the residual at the trained solution (forward-
    mode differentiation of the compiled AST — one Newton step in the
    error), exact to O(‖e‖²); for linear operators the linearization IS
    the operator and the path is identical.  One-sided axes (error pinned
    at one face only, e.g. an initial-value t) use the (m−½)π march-sine
    family.

    Returns None when an axis kind is unsupported or the basis fails to
    absorb at least ``1 − drop_tol`` of the (linearized) residual — the
    guard against overfitting projections with a basis the error does
    not live in.

    ``axis_kinds``: per-coordinate
    "dirichlet" | "periodic" | "march_lb" | "march_ub"."""
    dim = len(lb)
    if dim not in (1, 2) or len(axis_kinds) != dim:
        return None
    if any(k not in ("dirichlet", "periodic", "march_lb", "march_ub")
           for k in axis_kinds):
        return None
    lb = [float(v) for v in lb]
    ub = [float(v) for v in ub]

    axes_1d = []
    for kind in axis_kinds:
        if kind == "dirichlet":
            axes_1d.append([("sin", m) for m in range(1, max_sin + 1)])
        elif kind == "march_lb":
            axes_1d.append([("msin", m) for m in range(1, max_sin + 1)])
        elif kind == "march_ub":
            axes_1d.append([("msinr", m) for m in range(1, max_sin + 1)])
        else:
            fs = [("one", 0)]
            for n1 in range(1, max_fourier + 1):
                fs += [("pcos", n1), ("psin", n1)]
            axes_1d.append(fs)
    basis = [tuple(c) for c in itertools.product(*axes_1d)]
    if not basis or len(basis) > 1200:
        return None

    z, W = _box_quadrature(lb, ub, n_grid)
    sw = np.sqrt(W)

    LV, r = _linearized_system(predictor, params, compiled, lb, ub,
                               z, basis, source_fn)

    A = LV * sw[:, None]
    y = r[:, 0] * sw
    c, *_ = np.linalg.lstsq(A, y, rcond=1e-10)
    r0 = float(np.sqrt((y ** 2).sum()))
    r1 = float(np.sqrt(((y - A @ c) ** 2).sum()))
    if r0 <= 0.0 or r1 / r0 > drop_tol:
        return None

    keep = np.abs(c) > np.abs(c).max() * 1e-8
    modes = [[list(f) for f in b] for b, k in zip(basis, keep) if k]
    coeffs = [float(ci) for ci, k in zip(c, keep) if k]
    if not modes:
        return None
    return {"kind": "galerkin", "modes": modes, "coeffs": coeffs,
            "resid_drop": r1 / r0, "n_grid": n_grid,
            "linearized": not compiled.is_linear,
            "lb": lb, "ub": ub}


def _linearized_system(predictor, params, compiled, lb, ub, z, basis,
                       source_fn):
    """(LV, r): the linearized operator's action on each basis mode and
    the residual at the trained solution — the shared assembly for the
    hard-BC Galerkin and soft-BC Chebyshev solves.

    Linearization point: the trained solution's partial fields.  For a
    linear operator the forward-mode derivative reproduces the operator
    exactly; for a nonlinear one it is the Fréchet derivative — one Newton
    step."""
    parts0 = _partials_f64(predictor, params, compiled, z)
    # the engine may return byproduct indices beyond compiled.indices;
    # tangents must match parts0's tree structure exactly
    tangent_keys = list(parts0)
    z_t = next(iter(parts0.values())).new_tensor(z)

    def residual_of(parts):
        return compiled.evaluate(z_t, parts)

    # The Fréchet derivative is LINEAR in the tangent and the compiled
    # AST is pointwise (elementwise ops over derivative fields), so
    # lin(t) = Σ_ix C_ix(z)·t_ix(z) with coefficient fields extracted by
    # one jvp per derivative index — instead of one dispatch per basis
    # column, assembly is len(indices) jvps plus vectorized host numpy.
    n = z.shape[0]
    with torch.no_grad():
        base_r = residual_of(parts0)
        if source_fn is not None:
            base_r = base_r - source_fn(z_t)
        zero_t = {ix: torch.zeros_like(v) for ix, v in parts0.items()}
        C = {}
        for ix in tangent_keys:
            t = dict(zero_t)
            t[ix] = torch.ones_like(parts0[ix])
            _, c_ix = torch.func.jvp(residual_of, (parts0,), (t,))
            C[ix] = np.broadcast_to(c_ix.cpu().numpy(), (n, 1))
    r = base_r.cpu().numpy()
    LV = np.empty((n, len(basis)))
    for i, b in enumerate(basis):
        parts = _basis_partials(b, lb, ub, z, tangent_keys)
        acc = np.zeros((n, 1))
        for ix in tangent_keys:
            acc += C[ix] * parts[ix]
        LV[:, i] = acc[:, 0]
    return LV, r


def _box_quadrature(lb, ub, n_grid):
    """Trapezoid tensor grid: (z [n,dim], normalized weights W [n])."""
    dim = len(lb)
    axes = [np.linspace(lb[j], ub[j], n_grid) for j in range(dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    z = np.stack([g.ravel() for g in mesh], axis=1)
    w1 = np.ones(n_grid)
    w1[0] = w1[-1] = 0.5
    W = w1
    for _ in range(dim - 1):
        W = np.multiply.outer(W, w1)
    return z, (W / W.sum()).ravel()


def resonant_deflation(
    predictor: Callable,
    params,
    compiled,
    lb,
    ub,
    source_fn: Optional[Callable] = None,
    n_grid: int = 161,
    band=0.35,
    max_mode: int = 16,
    diag_tol: float = 0.02,
):
    """Estimate and return the near-resonant modal leakage of a trained
    linear-PDE solution.  Returns ``None`` when the operator offers no
    resonance band (nonlinear, c₀≈0, non-diagonal, or no mode selected);
    otherwise a dict with ``modes``/``coeffs``/``eps`` (plain lists, JSON-
    safe for checkpoint meta) and diagnostics.

    ``band="full"`` inverts the WHOLE truncated spectrum instead of a
    resonance band — the exact defect correction e = L⁻¹r, valid when the
    error has homogeneous Dirichlet data on every face (hard-BC ansatz);
    use through :func:`defect_correction`, which checks that."""
    if not compiled.is_linear:
        return None
    dim = len(lb)
    if dim not in (1, 2):
        return None
    lb = [float(v) for v in lb]
    ub = [float(v) for v in ub]

    z, W = _box_quadrature(lb, ub, n_grid)
    W = W[:, None]                                    # normalized quadrature

    full = band == "full"
    # pointwise coefficient fields: every per-mode operator action below
    # becomes vectorized numpy instead of one AST dispatch per mode
    _, C = _coeff_fields(compiled, z, compiled.indices)
    # zeroth-order coefficient of the operator (the resonance scale)
    c0 = 0.0
    if () in compiled.indices:
        c0_field = C[()]
        c0 = float(np.sum(c0_field * W))
        if abs(c0) > 1e-12 and float(np.std(c0_field)) > 0.01 * abs(c0):
            return None                               # variable c₀
    if not full and abs(c0) < 1e-12:
        return None                                   # no resonance scale

    r = _residual_f64(predictor, params, compiled, source_fn, z)

    # pass 1: eigenmode screening — collect every diagonal mode with its
    # eigenvalue, WITHOUT dividing yet.  The singularity floor below must be
    # scaled by the operator (max |ε| over the truncated spectrum, or |c₀|),
    # not by the mode's own ‖Lv‖: an exactly-singular mode has Lv = ε·v ≈ 0,
    # so a per-mode ‖Lv‖ floor can never catch it.
    candidates = []
    for m, v, ip_vv, eps in _sine_eigenmodes(compiled, C, lb, ub, z, W,
                                             max_mode, diag_tol):
        if not full and abs(eps) > band * abs(c0):
            continue                                  # outside the band
        candidates.append((m, v, ip_vv, eps))

    # pass 2: singularity floor + coefficient solve.  A mode with |ε| at
    # float-rounding level relative to the operator scale is exactly
    # resonant: 1/ε would bake an unbounded coefficient into u*, the
    # checkpoint meta, and serving — skip it (the mode is in L's null space;
    # its content is pinned by BC data, not by the residual).
    eps_ref = max([abs(c0)] + [abs(e) for *_x, e in candidates])
    modes, coeffs, eps_list = [], [], []
    for m, v, ip_vv, eps in candidates:
        if abs(eps) < 1e-9 * eps_ref:
            continue                                  # singular mode
        c = float(np.sum(r * v * W)) / ip_vv / eps
        modes.append(list(m))
        coeffs.append(c)
        eps_list.append(eps)

    if not modes:
        return None
    return {"kind": "modal", "modes": modes, "coeffs": coeffs,
            "eps": eps_list, "c0": c0, "band": band, "n_grid": n_grid,
            "lb": lb, "ub": ub}


def _sine_eigenmodes(compiled, C, lb, ub, z, W, max_mode, diag_tol):
    """Yield ``(m, v, ⟨v,v⟩, ε)`` for every sine tensor mode m ≤ max_mode
    per axis that the operator (coefficient fields ``C``) diagonalizes:
    rms(Lv − εv)/rms(Lv) ≤ ``diag_tol`` under the quadrature ``W`` [n,1]."""
    dim = len(lb)
    for m in itertools.product(*([range(1, max_mode + 1)] * dim)):
        parts = _mode_partials(m, lb, ub, z, compiled.indices)
        v = (parts[()] if () in parts
             else _mode_value(np, z, m, range(dim), lb, ub))
        Lv = np.zeros((z.shape[0], 1))
        for ix in compiled.indices:
            Lv += C[ix] * parts[ix]
        ip_vv = float(np.sum(v * v * W))
        eps = float(np.sum(v * Lv * W)) / ip_vv
        resid = Lv - eps * v
        scale = float(np.sqrt(np.sum(Lv * Lv * W))) + 1e-300
        if float(np.sqrt(np.sum(resid * resid * W))) / scale > diag_tol:
            continue                                  # not an eigenmode of L
        yield m, v, ip_vv, eps


def _coeff_fields(compiled, z, keys):
    """Base field and pointwise coefficient fields of a LINEAR compiled
    operator: evaluate(z, parts) = base + Σ_ix C_ix(z)·parts_ix(z).
    Extracting them costs len(keys)+1 AST evaluations; every per-mode
    operator action afterwards is vectorized host numpy instead of one
    AST dispatch per mode."""
    zeros = {ix: np.zeros((z.shape[0], 1)) for ix in keys}
    base = _evaluate_np(compiled, z, zeros)
    C = {}
    for ix in keys:
        probe = dict(zeros)
        probe[ix] = np.ones((z.shape[0], 1))
        C[ix] = _evaluate_np(compiled, z, probe) - base
    return base, C


def _ring_sine_modes(compiled, lb, ub, z, W, band, max_mode, diag_tol=0.02,
                     return_details=False):
    """Sine tensor modes in the operator's resonance band — the columns a
    truncated Chebyshev basis cannot represent (a k=20 oscillation needs
    polynomial degree ≳ k, but degree ≳ 20 starts fitting residual noise;
    see :func:`soft_defect`).  Selection mirrors
    :func:`resonant_deflation`: probe the constant zeroth-order
    coefficient c₀, keep every Π sin(m_j π x̂_j) that (a) is an eigenmode
    of the operator (diagnostic ≤ ``diag_tol``) and (b) has eigenvalue
    ``|ε| ≤ band·|c₀|``.  Returns mixed-basis descriptors
    (("sin", m₁), …) ready for :func:`_basis_value`; empty list when the
    operator is nonlinear, has no constant c₀, or no mode qualifies.

    ``return_details=True`` returns ``(descs, details)`` with one
    ``(eps, v_hat, c0)`` per mode (v̂ W-normalized on the caller's grid) so
    callers that need the eigen-data (ring_penalty_setup) don't recompute
    the coefficient fields and per-mode operator actions."""
    empty = ([], []) if return_details else []
    if not compiled.is_linear:
        return empty
    Wc = W[:, None]
    if () not in compiled.indices:
        return empty
    _, C = _coeff_fields(compiled, z, compiled.indices)
    c0_field = C[()]
    c0 = float(np.sum(c0_field * Wc))
    if abs(c0) < 1e-12 or float(np.std(c0_field)) > 0.01 * abs(c0):
        return empty

    out, details = [], []
    for m, v, ip_vv, eps in _sine_eigenmodes(compiled, C, lb, ub, z, Wc,
                                             max_mode, diag_tol):
        if abs(eps) <= band * abs(c0):
            out.append(tuple(("sin", mj) for mj in m))
            if return_details:
                details.append((eps, v / np.sqrt(ip_vv), c0))
    return (out, details) if return_details else out


def ring_penalty_setup(
    compiled,
    lb,
    ub,
    band: float = 0.35,
    max_mode: int = 16,
    n_grid: int = 48,
    eps_floor: float = 0.02,
):
    """Precompute the resonance-band TRAINING penalty operator.

    The offline deflation (:func:`resonant_deflation`, design notes above)
    removes the near-null ring leakage AFTER training; this is the same
    spectral identity turned into a loss term the optimizer can see
    DURING training.  For a linear operator L with sine eigenmodes
    ``L v_m = ε_m v_m`` in the resonance band ``|ε_m| ≤ band·|c₀|``, the
    live residual field implies the modal error  c_m = ⟨r, v̂_m⟩/ε_m,
    so

        penalty(r) = Σ_m c_m²  =  ‖Pᵀ r‖²,   P[:,m] = W·v̂_m/ε_m

    is (an estimate of) the MEAN-SQUARE SOLUTION ERROR carried by the
    ring — the component a plain residual MSE weights by ε_m² ≈ 0 and
    therefore cannot drive out.  The penalty vanishes at the exact
    solution, so it biases nothing; it only re-conditions the descent
    directions the loss is blind to.

    Returns ``(z [N,d], P [N,M])`` as float64 numpy arrays (cast to the
    training dtype by the caller; the training-time cost is one fixed
    [N,d] residual evaluation and one [M,N]@[N,1] matmul per step), or
    ``None`` when the operator is nonlinear, has no constant zeroth-order
    coefficient, or no mode falls in the band — same inertness contract
    as deflation="auto".  ``eps_floor`` clamps |ε_m| ≥ eps_floor·|c₀|: an
    (almost) exactly-resonant mode would otherwise get unbounded weight
    and hand the optimizer an ill-posed objective (cf. the singularity
    floor in :func:`resonant_deflation`).
    """
    if not getattr(compiled, "is_linear", False):
        return None
    if len(lb) not in (1, 2, 3):
        return None
    lb = [float(v) for v in lb]
    ub = [float(v) for v in ub]

    z, W = _box_quadrature(lb, ub, n_grid)
    Wc = W[:, None]
    modes, details = _ring_sine_modes(compiled, lb, ub, z, W, band,
                                      max_mode, return_details=True)
    if not modes:
        return None
    cols = []
    for eps, v_hat, c0 in details:
        sign = 1.0 if eps >= 0 else -1.0   # sign(0)=0 must not zero ε
        eps_c = sign * max(abs(eps), eps_floor * abs(c0))
        cols.append((Wc * v_hat / eps_c)[:, 0])
    return z, np.stack(cols, axis=1)


def soft_defect(
    predictor: Callable,
    params,
    compiled,
    lb,
    ub,
    bc_groups,
    source_fn: Optional[Callable] = None,
    n_grid: int = 161,
    degree="auto",
    n_bd: int = 256,
    drop_tol: float = 1.05,
    ring: bool = True,
    ring_band: float = 0.35,
    ring_max_mode: int = 16,
):
    """Defect correction for SOFT-BC runs.  The error's boundary trace is
    KNOWN data — e = u − g on every Dirichlet group — so no homogeneous
    face structure is needed: e is determined by the joint least squares

        min_c ‖L_lin(Σ c_i b_i) − r‖²_W,domain + w²·‖Σ c_i b_i − (u−g)‖²_∂

    over a tensor Chebyshev basis (the natural spectral family with no
    built-in boundary behavior).  L_lin is the residual's Fréchet
    derivative at the trained solution, so nonlinear equations get the
    same one-Newton-step treatment as the hard-BC Galerkin path.  The
    boundary block is scaled to match the domain block's sensitivity.

    This is the correction that serves the soft-BC Helmholtz recipes,
    where resonance-ring error modes are nearly invisible to the
    residual: their tiny eigenvalues survive in the least squares
    (σ_ring/σ_max ≈ ε/‖L‖ ≫ rcond) and the boundary rows pin the rest.
    Larger bases start fitting residual noise, hence the modest ladder
    and the guard.

    ``degree="auto"`` (the default) selects the degree over the ladder
    (8, 12, 16, 20, 24) by held-out relative misfit (boundary + residual
    on the excluded rows) — the same signal the guard uses, turned from
    a veto into a selector.  The basis is assembled once at the ladder's
    top; each candidate is a column subset, so selection costs only
    extra least-squares solves.

    Guard: a held-out split (every 5th domain row and boundary point is
    excluded from the fit) must show the correction improving the
    held-out boundary misfit and not worsening the held-out residual
    beyond ``drop_tol`` — unlike the hard-BC paths, absolute residual
    absorption is NOT required, because the soft-BC residual is
    typically dominated by high-frequency net noise outside any
    reasonable basis.

    ``ring=True`` (default) augments the Chebyshev basis with the
    operator's resonance-band sine eigenmodes (``|ε| ≤ ring_band·|c₀|``,
    :func:`_ring_sine_modes`) — the near-null-space content a truncated
    polynomial cannot carry.  The held-out ladder decides ring on/off per
    candidate degree, so the augmentation can only be kept when it
    generalizes."""
    if len(lb) not in (1, 2) or not bc_groups:
        return None
    lb = [float(v) for v in lb]
    ub = [float(v) for v in ub]

    dim = len(lb)
    candidates = (8, 12, 16, 20, 24) if degree == "auto" else (int(degree),)
    dmax = max(candidates)
    axes_1d = [[("cheb", n) for n in range(dmax + 1)]] * dim
    basis = [tuple(c) for c in itertools.product(*axes_1d)]
    if len(basis) > 1200:
        return None
    # per-column polynomial degree (max over axes) — candidate d keeps
    # the columns with all axis degrees <= d, a nested subset family
    col_deg = np.array([max(n for _, n in b) for b in basis])

    z, W = _box_quadrature(lb, ub, n_grid)

    # resonance-band sine eigenmode augmentation (always-kept columns
    # orthogonal to the degree ladder; the held-out guard decides use)
    ring_cols = _ring_sine_modes(compiled, lb, ub, z, W, ring_band,
                                 ring_max_mode) if ring else []
    is_ring = np.concatenate([np.zeros(len(basis), bool),
                              np.ones(len(ring_cols), bool)])
    basis = basis + ring_cols
    col_deg = np.concatenate([col_deg, np.zeros(len(ring_cols), int)])

    sw = np.sqrt(W)
    LV, r = _linearized_system(predictor, params, compiled, lb, ub,
                               z, basis, source_fn)

    # boundary trace rows: e = u − g on each Dirichlet group
    rng = np.random.default_rng(0)
    zb_parts, gb_parts = [], []
    for g in bc_groups:
        lo = np.asarray(g.lo, float)
        hi = np.asarray(g.hi, float)
        zb = lo + rng.uniform(0.0, 1.0, (n_bd, dim)) * (hi - lo)
        zb_parts.append(zb)
        gb_parts.append(g.target(torch.as_tensor(zb)).numpy())
    zb = np.concatenate(zb_parts, axis=0)
    gb = np.concatenate(gb_parts, axis=0).reshape(-1, 1)
    e_bd = _u_f64(predictor, params, zb) - gb
    V_bd = np.concatenate(
        [_basis_value(np, zb, b, lb, ub) for b in basis], axis=1)

    A_dom = LV * sw[:, None]
    y_dom = r[:, 0] * sw

    def solve(Ad, yd, Vb, eb, wb):
        A = np.vstack([Ad, wb * Vb])
        y = np.concatenate([yd, wb * eb])
        c, *_ = np.linalg.lstsq(A, y, rcond=1e-10)
        return c

    # held-out validation: fit without every 5th row, require the
    # correction to generalize (improve held-out boundary misfit, not
    # worsen held-out residual) — the guard against fitting noise.
    # With a degree ladder, the same held-out signal also SELECTS the
    # degree: candidates that pass the guard are ranked by their
    # dimensionless held-out misfit (boundary + residual, each relative
    # to the uncorrected level) and the best one is refit on all rows.
    hd = np.arange(A_dom.shape[0]) % 5 == 0
    hb = np.arange(V_bd.shape[0]) % 5 == 0
    bd_h0 = float(np.sqrt((e_bd[hb, 0] ** 2).mean()))
    r_h0 = float(np.sqrt((y_dom[hd] ** 2).mean()))

    best = None
    ring_opts = (False, True) if len(ring_cols) else (False,)
    for d in candidates:
        for use_ring in ring_opts:
            sel = (~is_ring & (col_deg <= d)) | (is_ring & use_ring)
            Asub, Vsub = A_dom[:, sel], V_bd[:, sel]
            # boundary block scaled to the subset's domain-block sensitivity
            s_dom = float(np.sqrt((Asub ** 2).mean()))
            s_bd = float(np.sqrt((Vsub ** 2).mean())) + 1e-300
            wb = s_dom / s_bd / np.sqrt(max(1, len(bc_groups)))
            c_fit = solve(Asub[~hd], y_dom[~hd], Vsub[~hb], e_bd[~hb, 0], wb)
            bd_h1 = float(
                np.sqrt(((e_bd[hb, 0] - Vsub[hb] @ c_fit) ** 2).mean()))
            r_h1 = float(
                np.sqrt(((y_dom[hd] - Asub[hd] @ c_fit) ** 2).mean()))
            if bd_h1 > bd_h0 * 1.02 + 1e-14:
                continue          # does not generalize on the boundary
            if r_h0 > 0 and r_h1 / r_h0 > drop_tol:
                continue          # worsens the held-out residual
            score = bd_h1 / (bd_h0 + 1e-300) + r_h1 / (r_h0 + 1e-300)
            if best is None or score < best[0]:
                best = (score, d, sel, wb, bd_h1, r_h1, use_ring)
    if best is None:
        return None
    _, deg_sel, sel, wb, bd_h1, r_h1, ring_sel = best
    basis = [b for b, k in zip(basis, sel) if k]
    A_dom, V_bd = A_dom[:, sel], V_bd[:, sel]

    c = solve(A_dom, y_dom, V_bd, e_bd[:, 0], wb)

    # perturbative-regime sanity: defect correction is an asymptotic
    # method — valid only when the correction is SMALL against the
    # solution scale.  An untrained/garbage net has O(1) "error"; the
    # truncated fit then trades interior vs boundary arbitrarily (the
    # held-out checks can pass while the interior worsens).
    rng_s = np.random.default_rng(1)
    zs = rng_s.uniform(0.0, 1.0, (512, dim))
    for k in range(dim):
        zs[:, k] = lb[k] + zs[:, k] * (ub[k] - lb[k])
    u_s = _u_f64(predictor, params, zs)
    Vs = np.concatenate(
        [_basis_value(np, zs, b, lb, ub) for b in basis], axis=1)
    du_rms = float(np.sqrt(((Vs @ c) ** 2).mean()))
    u_rms = float(np.sqrt((u_s ** 2).mean()))
    if du_rms > 0.1 * (u_rms + 1e-30):
        return None

    y = np.concatenate([y_dom, wb * e_bd[:, 0]])
    A = np.vstack([A_dom, wb * V_bd])
    y0 = float(np.sqrt((y ** 2).sum()))
    y1 = float(np.sqrt(((y - A @ c) ** 2).sum()))
    bd0 = float(np.sqrt((e_bd[:, 0] ** 2).mean()))
    bd1 = float(np.sqrt(((e_bd[:, 0] - V_bd @ c) ** 2).mean()))

    keep = np.abs(c) > np.abs(c).max() * 1e-8
    modes = [[list(f) for f in b] for b, k in zip(basis, keep) if k]
    coeffs = [float(ci) for ci, k in zip(c, keep) if k]
    if not modes:
        return None
    return {"kind": "galerkin", "modes": modes, "coeffs": coeffs,
            "resid_drop": y1 / y0 if y0 > 0 else 0.0,
            "bd_rms": [bd0, bd1], "heldout": [bd_h0, bd_h1, r_h0, r_h1],
            "degree": int(deg_sel),
            "ring": len(ring_cols) if ring_sel else 0,
            "n_grid": n_grid, "soft": True,
            "linearized": not compiled.is_linear,
            "lb": lb, "ub": ub}


# ---------------------------------------------------------------------------
# The correction term, rebuilt from its description
# ---------------------------------------------------------------------------


def _basis_matrix(z: Tensor, modes, lb, ub) -> Tensor:
    """[N, M] values of M mixed-basis modes at once: per coordinate one
    sine, one cosine and (with Chebyshev factors) one recurrence over all
    modes, the factors picked by mask — the values of :func:`_basis_value`
    mode by mode, in a handful of tensor ops whatever M is."""
    n_modes = len(modes)
    V = None
    for j in range(len(lb)):
        kinds = [m[j][0] for m in modes]
        if all(k == "one" for k in kinds):
            continue
        L = ub[j] - lb[j]
        col = z[:, j:j + 1]

        def row(vals, dtype=z.dtype):
            return torch.tensor(vals, dtype=dtype, device=z.device)[None, :]

        trig = [k not in ("one", "cheb") for k in kinds]
        F = None
        if any(trig):
            w = row([_factor_freq(k, n, L, np) if t else 0.0
                     for (k, n), t in zip((m[j] for m in modes), trig)])
            if "msinr" in kinds:
                arg = torch.where(row([k == "msinr" for k in kinds],
                                      torch.bool), ub[j] - col, col - lb[j])
            else:
                arg = col - lb[j]
            t = w * arg
            F = torch.sin(t)
            if "pcos" in kinds:
                F = torch.where(row([k == "pcos" for k in kinds], torch.bool),
                                torch.cos(t), F)
        if "cheb" in kinds:
            orders = [n if k == "cheb" else 0 for k, n in
                      (m[j] for m in modes)]
            tc = 2.0 * (col - lb[j]) / L - 1.0
            cols = [torch.ones_like(tc), tc]     # the recurrence of _cheb_T
            for _ in range(max(orders) - 1):
                cols.append(2.0 * tc * cols[-1] - cols[-2])
            T = torch.cat(cols, dim=1)
            Tsel = T[:, torch.tensor(orders, device=z.device)]
            F = Tsel if F is None else torch.where(
                row([k == "cheb" for k in kinds], torch.bool), Tsel, F)
        if "one" in kinds:
            F = torch.where(row([k == "one" for k in kinds], torch.bool),
                            torch.ones_like(F), F)
        V = F if V is None else V * F
    if V is None:
        V = torch.ones((z.shape[0], n_modes), dtype=z.dtype, device=z.device)
    return V


def _interp_rows(t: Tensor, grid: Tensor, rows: Tensor) -> Tensor:
    """[N, M]: each of the M series ``rows`` [M, G] (samples on the sorted
    ``grid`` [G]) linearly interpolated at ``t`` [N], clamped to the end
    samples outside the grid (``numpy.interp``)."""
    hi = torch.searchsorted(grid, t.detach().contiguous(), right=True)
    hi = hi.clamp(1, grid.shape[0] - 1)
    x0, x1 = grid[hi - 1], grid[hi]
    w = ((t - x0) / (x1 - x0)).clamp(0.0, 1.0)[:, None]
    y0, y1 = rows[:, hi - 1].T, rows[:, hi].T
    return y0 + w * (y1 - y0)


def deflation_term(defl: Dict) -> Callable:
    """The correction term T(z) as a torch function of ``z`` on ``z``'s
    device and dtype; the corrected predictor is u(z) − T(z).  Shared by
    training and serving rebuilds, differentiable in ``z`` (the served
    residual differentiates through it).  Handles all correction kinds:
    "modal" (Σ c_m v_m), "parabolic" (Σ e_m(τ)·v_m(x), the per-mode
    Duhamel series interpolated in τ) and "galerkin" (Σ c_i b_i over the
    mixed sin/Fourier/Chebyshev tensor basis).  ``defl`` is the JSON-safe
    dict the correction functions return and checkpoints carry."""
    lb = [float(v) for v in defl["lb"]]
    ub = [float(v) for v in defl["ub"]]
    kind = defl.get("kind", "modal")
    if kind == "parabolic":
        return _parabolic_term(defl, lb, ub)
    if kind == "galerkin":
        modes = [tuple((k, int(n)) for k, n in m) for m in defl["modes"]]
    else:
        modes = [tuple(("sin", int(n)) for n in m) for m in defl["modes"]]
    coeffs = [float(c) for c in defl["coeffs"]]
    cache = {}

    def term(z):
        key = (z.device, z.dtype)
        if key not in cache:
            cache[key] = torch.tensor(coeffs, dtype=z.dtype,
                                      device=z.device)[:, None]
        if not modes:
            return torch.zeros((z.shape[0], 1), dtype=z.dtype,
                               device=z.device)
        return _basis_matrix(z, modes, lb, ub) @ cache[key]

    return term


def _parabolic_term(defl: Dict, lb, ub) -> Callable:
    tau, spatial = int(defl["tau"]), [int(j) for j in defl["spatial"]]
    dim = len(lb)
    modes = []
    for m in defl["modes"]:
        desc = [("one", 0)] * dim
        for k, j in enumerate(spatial):
            desc[j] = ("sin", int(m[k]))
        modes.append(tuple(desc))
    cache = {}

    def term(z):
        key = (z.device, z.dtype)
        if key not in cache:
            cache[key] = (
                torch.tensor(defl["tau_grid"], dtype=z.dtype, device=z.device),
                torch.tensor(defl["series"], dtype=z.dtype, device=z.device))
        tau_grid, series = cache[key]
        E = _interp_rows(z[:, tau], tau_grid, series)
        V = _basis_matrix(z, modes, lb, ub)
        return torch.sum(E * V, dim=1, keepdim=True)

    return term


def deflation_fields(defl: Dict, compiled, z_np):
    """(du, df): the correction's value and exact operator action on an
    evaluation grid, host numpy — so callers can adjust already-computed
    u/residual fields without re-running the network.  For the parabolic
    kind, L(correction) = Σ_m r_m(τ)v_m(x) by construction (the Duhamel
    series solves a·e' + μe = r_m exactly), so df uses the stored rhs.

    For a NONLINEAR galerkin correction (``defl["linearized"]``) df is
    returned as None: the residual is not affine in the correction, so
    field adjustment cannot be exact — recompute the corrected
    predictor's residual instead (train.py does)."""
    z = np.asarray(z_np)
    lb, ub = defl["lb"], defl["ub"]
    du = np.zeros((z.shape[0], 1))
    df = np.zeros((z.shape[0], 1))
    if defl.get("kind", "modal") == "parabolic":
        tau, spatial = int(defl["tau"]), [int(j) for j in defl["spatial"]]
        tg = np.asarray(defl["tau_grid"])
        for m, e_m, r_m in zip(defl["modes"], defl["series"], defl["rhs"]):
            v = _mode_value(np, z, m, spatial, lb, ub)
            du += np.interp(z[:, tau], tg, np.asarray(e_m))[:, None] * v
            df += np.interp(z[:, tau], tg, np.asarray(r_m))[:, None] * v
        return du, df

    dim = len(lb)
    galerkin = defl.get("kind", "modal") == "galerkin"
    linearized = bool(defl.get("linearized"))
    # df only exists for LINEAR operators, where the operator action per
    # mode is Σ_ix C_ix·parts_ix (one AST dispatch per index, not per mode)
    C = None if linearized else _coeff_fields(compiled, z,
                                              compiled.indices)[1]
    for m, c in zip(defl["modes"], defl["coeffs"]):
        if galerkin:
            m = tuple((k, int(n)) for k, n in m)
            parts = _basis_partials(m, lb, ub, z, compiled.indices)
            v = (parts[()] if () in parts
                 else _basis_value(np, z, m, lb, ub))
        else:
            parts = _mode_partials(tuple(m), lb, ub, z, compiled.indices)
            v = (parts[()] if () in parts
                 else _mode_value(np, z, tuple(m), range(dim), lb, ub))
        du += c * v
        if C is not None:
            for ix in compiled.indices:
                df += c * (C[ix] * parts[ix])
    return du, (None if linearized else df)


def parabolic_defect(
    predictor: Callable,
    params,
    compiled,
    lb,
    ub,
    source_fn: Optional[Callable] = None,
    n_grid: int = 201,
    max_mode: int = 32,
    diag_tol: float = 0.02,
):
    """Exact defect correction for constant-coefficient PARABOLIC problems
    (one march coordinate τ entering only as a·u_τ; the spatial part
    diagonalized by Dirichlet sines): per spatial mode v_m,

        a·e_m'(τ) + μ_m·e_m(τ) = r_m(τ),   e_m(τ_lb) = 0
        ⇒ e_m(τ) = (1/a)∫ exp(−μ_m(τ−s)/a)·r_m(s) ds     (Duhamel)

    with μ_m = ⟨v_m, L_spatial v_m⟩ measured numerically from the AST and
    r_m(τ) the sine transform of the residual field.  Valid when the
    error vanishes on the spatial boundary and the τ=lb face — i.e. the
    hard-BC ansatz; the dispatcher checks the bubble.  Returns None when
    the operator is not of this form.

    The march integration error is O(Δτ²), so ``n_grid`` dominates the
    correction floor — the default trades that against the n_grid²
    residual evaluation."""
    if not compiled.is_linear:
        return None
    dim = len(lb)
    if dim < 2:
        return None
    lb = [float(v) for v in lb]
    ub = [float(v) for v in ub]

    # --- find the march coordinate: appears ONLY as the pure first-order
    # index (j,); mixed or higher τ-derivatives break the mode ODE
    cands = []
    for j in range(dim):
        ixs = [ix for ix in compiled.indices if j in ix]
        if ixs == [(j,)]:
            cands.append(j)
    if len(cands) != 1:
        return None
    tau = cands[0]
    spatial = [j for j in range(dim) if j != tau]

    axes = [np.linspace(lb[j], ub[j], n_grid) for j in range(dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    z = np.stack([g.ravel() for g in mesh], axis=1)
    n_pts = z.shape[0]

    zeros = {ix: np.zeros((n_pts, 1)) for ix in compiled.indices}
    base = _evaluate_np(compiled, z, zeros)

    # march coefficient a (must be a nonzero constant)
    probe = dict(zeros)
    probe[(tau,)] = np.ones((n_pts, 1))
    a_field = _evaluate_np(compiled, z, probe) - base
    a = float(a_field.mean())
    if abs(a) < 1e-12 or float(np.std(a_field)) > 0.01 * abs(a):
        return None

    # spatial quadrature weights on the flattened grid (trapezoid per axis)
    w1 = np.ones(n_grid)
    w1[0] = w1[-1] = 0.5
    w1 = w1 / w1.sum()
    Wsp = np.ones(n_pts)
    for j in spatial:
        idx = (np.arange(n_pts) // n_grid ** (dim - 1 - j)) % n_grid
        Wsp = Wsp * w1[idx]
    Wsp = Wsp[:, None]

    r = _residual_f64(predictor, params, compiled, source_fn, z)
    shape = (n_grid,) * dim
    r_nd = r.reshape(shape)
    taus = axes[tau]
    dt = taus[1] - taus[0]

    # move τ last for per-mode time series
    perm = spatial + [tau]
    r_sp = np.transpose(r_nd, perm).reshape(-1, n_grid)  # [spatial_pts, nτ]
    wsp_flat = np.ones(r_sp.shape[0])
    for k_ax in range(len(spatial)):
        idx = (np.arange(r_sp.shape[0])
               // n_grid ** (len(spatial) - 1 - k_ax)) % n_grid
        wsp_flat = wsp_flat * w1[idx]

    # spatial-mode machinery: analytic partials of v over spatial coords,
    # τ-derivative identically zero (v is τ-independent)
    z_sp = np.concatenate(
        [np.transpose(mesh[j], perm).reshape(-1, n_grid)[:, :1]
         for j in spatial], axis=1)          # [spatial_pts, n_spatial]
    sp_lb = [lb[j] for j in spatial]
    sp_ub = [ub[j] for j in spatial]

    def spatial_mode(m):
        return _mode_value(np, z_sp, m, range(len(spatial)), sp_lb, sp_ub)

    march_len = taus[-1] - taus[0]
    modes, series, rhs_series, mus = [], [], [], []
    for m in itertools.product(*([range(1, max_mode + 1)]
                                 * len(spatial))):
        # μ_m from the full-grid AST evaluation with τ-parts zeroed
        parts = {}
        for ix in compiled.indices:
            if tau in ix:
                parts[ix] = np.zeros((n_pts, 1))
            else:
                # orders over spatial coordinates only
                mm = [0] * dim
                for k_ax, j in enumerate(spatial):
                    mm[j] = m[k_ax]
                parts[ix] = _mode_partials_subset(mm, lb, ub, z, ix, spatial)
        v_full = parts.get(())
        if v_full is None:
            v_full = _mode_partials_subset(
                [m[spatial.index(j)] if j in spatial else 0
                 for j in range(dim)], lb, ub, z, (), spatial)
        Lv = _evaluate_np(compiled, z, parts) - base
        ip = float(np.sum(v_full * v_full * Wsp)) / n_grid  # τ-avg absorbs
        mu = float(np.sum(v_full * Lv * Wsp)) / n_grid / ip
        resid = Lv - mu * v_full
        scale = float(np.sqrt(np.sum(Lv * Lv * Wsp) / n_grid)) + 1e-300
        if float(np.sqrt(np.sum(resid * resid * Wsp) / n_grid)) / scale \
                > diag_tol:
            continue
        if mu / a * march_len < -30.0:
            # anti-diffusive blowup guard: the integrating factor grows by
            # exp(-mu/a·(τ−s)) CUMULATIVELY over the march, so the bound
            # must cover the whole interval, not one Δτ step — e³⁰ already
            # means the correction is amplifying quadrature noise ~1e13×
            continue
        v = spatial_mode(m)
        ip_v = float(np.sum(v[:, 0] ** 2 * wsp_flat))
        r_m = (r_sp * (v[:, 0] * wsp_flat)[:, None]).sum(0) / ip_v  # [nτ]
        # exact integrating factor + trapezoid source
        decay = np.exp(-mu / a * dt)
        e_m = np.zeros(n_grid)
        for i in range(1, n_grid):
            e_m[i] = (e_m[i - 1] * decay
                      + 0.5 * dt / a * (r_m[i] + r_m[i - 1] * decay))
        modes.append(list(m))
        series.append(e_m.tolist())
        rhs_series.append(r_m.tolist())
        mus.append(mu)

    if not modes:
        return None
    return {"kind": "parabolic", "modes": modes, "series": series,
            "rhs": rhs_series, "mu": mus, "a": a, "tau": tau,
            "spatial": spatial, "tau_grid": taus.tolist(),
            "n_grid": n_grid, "lb": lb, "ub": ub}


def _mode_partials_subset(mm, lb, ub, z, ix, spatial):
    """Partial ∂_ix of Π_{j∈spatial} sin(mm_j π (z_j−lb_j)/L_j), counting
    only the derivative orders taken along ``spatial`` coordinates —
    callers must zero the entries for multi-indices that derive a
    non-spatial coordinate (v is constant there, so the true partial
    vanishes)."""
    cyc = (np.sin, np.cos, lambda t: -np.sin(t), lambda t: -np.cos(t))
    val = np.ones((z.shape[0], 1))
    for j in spatial:
        order = sum(1 for jj in ix if jj == j)
        w = mm[j] * np.pi / (ub[j] - lb[j])
        t = w * (z[:, j:j + 1] - lb[j])
        val = val * (w ** order) * cyc[order % 4](t)
    return val


def defect_correction(
    predictor: Callable,
    params,
    compiled,
    lb,
    ub,
    hard_bc,
    mode: str = "auto",
    source_fn: Optional[Callable] = None,
    coords=None,
    bc_groups=None,
    **kw,
):
    """Dispatcher for the spectral error corrections.

    ``mode="auto"``: resonance-band deflation (safe for soft BCs — only
    removes the modes no loss term can see).
    ``mode="full"``: exact defect correction e = L⁻¹r over the truncated
    spectrum.  With the hard-BC ansatz: parabolic (Duhamel march) when
    the operator has a march coordinate, diagonal elliptic full-band
    when the sine modes are eigenmodes, and otherwise the GALERKIN
    least-squares solve (:func:`galerkin_defect`) — exactly-periodic
    axes (net.PERIODIC features, the annulus θ) get a Fourier family,
    initial-value axes the (m−½)π march sines; the bubble is CHECKED
    numerically face by face and candidate periodic axes are certified
    by comparing predictor and residual across the faces.  Without a
    hard-BC ansatz (or when no basis family fits its faces), falls back
    to the SOFT-BC Chebyshev solve (:func:`soft_defect`) using the
    Dirichlet groups' known boundary data."""
    if mode == "auto":
        return resonant_deflation(predictor, params, compiled, lb, ub,
                                  source_fn=source_fn, **kw)
    if mode != "full":
        return None

    kw.pop("band", None)  # mode="full" fixes the band; parabolic has none
    gal_kw = {k: kw.pop(k) for k in ("max_sin", "max_fourier", "drop_tol")
              if k in kw}
    # NB: drop_tol is hard-path-only (absorption fraction); the soft
    # path's guard is held-out generalization with its own default
    soft_kw = {k: kw.pop(k)
               for k in ("degree", "n_bd", "ring", "ring_band",
                         "ring_max_mode") if k in kw}
    if "n_grid" in kw:
        gal_kw["n_grid"] = soft_kw["n_grid"] = kw["n_grid"]
    dim = len(lb)

    out = None
    if hard_bc is not None and coords is not None:
        vanish = _bubble_face_map(hard_bc[1], coords, lb, ub)

        para = parabolic_defect(predictor, params, compiled, lb, ub,
                                source_fn=source_fn, **kw)
        if para is not None:
            # initial-value march: the τ=ub face carries no error condition
            free = {(para["tau"], 1)}
            if all(vanish[(j, s)] for j in range(dim) for s in (0, 1)
                   if (j, s) not in free):
                return para

        if all(vanish.values()):
            kw2 = dict(kw)
            kw2.setdefault("max_mode", 24)
            out = resonant_deflation(predictor, params, compiled, lb, ub,
                                     source_fn=source_fn, band="full", **kw2)
            if out is not None:
                return out
            # sine modes are not eigenmodes (variable coefficients): fall
            # through to the non-diagonal Galerkin solve on the same basis
            axis_kinds = ["dirichlet"] * dim
        else:
            axis_kinds = []
            for j in range(dim):
                v0, v1 = vanish[(j, 0)], vanish[(j, 1)]
                if v0 and v1:
                    axis_kinds.append("dirichlet")
                elif not v0 and not v1:
                    axis_kinds.append("periodic")
                elif v0:
                    axis_kinds.append("march_lb")   # initial-value axis
                else:
                    axis_kinds.append("march_ub")
            per = [j for j, k in enumerate(axis_kinds) if k == "periodic"]
            if not _axes_periodic(predictor, params, compiled, source_fn,
                                  lb, ub, per):
                axis_kinds = None
        if axis_kinds is not None:
            out = galerkin_defect(predictor, params, compiled, lb, ub,
                                  axis_kinds, source_fn=source_fn, **gal_kw)
    if out is None and bc_groups:
        out = soft_defect(predictor, params, compiled, lb, ub, bc_groups,
                          source_fn=source_fn, **soft_kw)
    return out


def _axes_periodic(predictor, params, compiled, source_fn, lb, ub, axes,
                   n: int = 96):
    """True iff predictor AND residual agree on the two faces of every
    axis in ``axes`` (relative 1e-5) — the numerical certificate that the
    solution ansatz is exactly periodic there (e.g. net.PERIODIC
    features), so a Fourier basis represents the error."""
    if not axes:
        return True
    dim = len(lb)
    rng = np.random.default_rng(0)
    for j in axes:
        z = rng.uniform(0, 1, (n, dim))
        for k in range(dim):
            z[:, k] = lb[k] + z[:, k] * (ub[k] - lb[k])
        z0, z1 = z.copy(), z.copy()
        z0[:, j] = lb[j]
        z1[:, j] = ub[j]
        u0 = _u_f64(predictor, params, z0)
        u1 = _u_f64(predictor, params, z1)
        scale = float(np.abs(u0).max()) + 1e-12
        if float(np.abs(u0 - u1).max()) > 1e-5 * scale:
            return False
        r0 = _residual_f64(predictor, params, compiled, source_fn, z0)
        r1 = _residual_f64(predictor, params, compiled, source_fn, z1)
        rscale = float(np.abs(r0).max()) + 1e-30
        if float(np.abs(r0 - r1).max()) > 1e-5 * rscale:
            return False
    return True


def _bubble_face_map(bubble_expr, coords, lb, ub):
    """``{(axis, side): bubble ~0 on that box face}`` — a vanishing face
    means the error carries homogeneous Dirichlet data there (u = lift +
    bubble·N with exact lift), so that face admits a sine basis.

    Evaluated in float64 against a RELATIVE threshold (face max vs the
    bubble's interior amplitude): an O(100)-amplitude bubble evaluated in
    f32 leaves ~1e-5 roundoff on a true zero face, which an absolute
    cutoff would misread as a violation and silently disable the
    correction."""
    fn = pde.compile_coord_expr(bubble_expr, tuple(coords))
    dim = len(lb)
    rng = np.random.default_rng(0)

    def face_max(face=None):
        z = rng.uniform(0, 1, (64, dim))
        for k in range(dim):
            z[:, k] = lb[k] + z[:, k] * (ub[k] - lb[k])
        if face is not None:
            j, side = face
            z[:, j] = (lb[j], ub[j])[side]
        return float(fn(torch.as_tensor(z)).abs().max())

    amp = max(face_max(), 1e-30)
    return {(j, side): face_max((j, side)) <= 1e-8 * amp
            for j in range(dim) for side in (0, 1)}
