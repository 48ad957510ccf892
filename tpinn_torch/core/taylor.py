"""Structured Taylor-2 propagation and engine dispatch.

Port of ``tpinn.core.taylor``.  For a plain dense chain the derivative
recurrences are closed-form, and all derivative "streams" ride one matmul
per layer when stacked along the batch axis:

    H_all = stack([h, h_i, h_j, h_ii, h_jj, ...])   # [S*B, width]
    X_all = H_all @ W
    a     = φ(x);  a_i = φ'(x)·x_i
    a_ij  = φ''(x)·x_i·x_j + φ'(x)·x_ij

``taylor2_mlp`` is that recurrence in plain PyTorch; it is the plain
version that kernel B1 (tpinn_torch.kernels.mlp_taylor) is held against.

Engine dispatch differs from the JAX package on purpose: ``tpinn`` keeps
the generic nested-jvp engine as its default (``PREFER_FUSED = False``, a
choice measured on a TPU).  Here dispatch goes by structure and dtype: a
predictor whose raw net is the plain dense family with scalar output and
feature kinds in {minmax, periodic, identity} advertises
``tpinn_partials``; ``fast_partials`` takes it for order ≤ 2 on float32
points.  On a CUDA tensor it runs kernel B1, differentiable in the
parameters through kernel B2 (tpinn_torch.kernels.taylor_vjp); on a CPU
tensor it runs B1's plain version, which autograd differentiates.
Float64 points (the f64 evaluation, an f64 L-BFGS) and everything else go
to the generic ``torch.func.jvp`` engine (tpinn_torch.core.deriv), as
``tpinn`` computes them.

Activation derivative table:
    tanh:  φ' = 1 − a²          φ'' = −2·a·(1 − a²)
    sin:   φ' = cos x           φ'' = −sin x
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from tpinn_torch.core import net as net_mod
from tpinn_torch.core.net import FeatureMap, MLPSpec

Tensor = torch.Tensor
MultiIndex = Tuple[int, ...]


def plan_streams(indices: Iterable[MultiIndex]) -> List[MultiIndex]:
    """Ordered stream list: value first, then firsts, then pairs — with any
    pair's component firsts force-included (the recurrence needs them)."""
    need = {tuple(sorted(ix)) for ix in indices}
    pairs = sorted(ix for ix in need if len(ix) == 2)
    firsts = {ix[0] for ix in need if len(ix) == 1}
    for i, j in pairs:
        firsts.add(i)
        firsts.add(j)
    if any(len(ix) > 2 for ix in need):
        raise ValueError("taylor2 engine handles order <= 2 only")
    return [()] + [(i,) for i in sorted(firsts)] + pairs


# ---------------------------------------------------------------------------
# Feature-map stream construction
# ---------------------------------------------------------------------------


def feature_streams(
    fm: FeatureMap, z: Tensor, lb: Tensor, ub: Tensor, streams: Sequence[MultiIndex]
) -> Tensor:
    """[S, B, nf] stacked feature values/derivatives per stream."""
    cols_per_stream: List[List[Tensor]] = [[] for _ in streams]
    B = z.shape[0]
    zero = torch.zeros((B, 1), dtype=z.dtype, device=z.device)
    ones = torch.ones((B, 1), dtype=z.dtype, device=z.device)
    for ci, kind in enumerate(fm.kinds):
        x = z[:, ci : ci + 1]
        if kind == net_mod.MINMAX:
            scale = 2.0 / (ub[ci] - lb[ci])
            vals = {(): scale * (x - lb[ci]) - 1.0}
            d1 = ones * scale
        elif kind == net_mod.IDENTITY:
            vals = {(): x}
            d1 = ones
        elif kind == net_mod.PERIODIC:
            c, s = torch.cos(x), torch.sin(x)
        else:
            raise ValueError(f"taylor2 streams do not support feature kind {kind!r}")

        for si, st in enumerate(streams):
            if kind == net_mod.PERIODIC:
                if st == ():
                    out = [c, s]
                elif st == (ci,):
                    out = [-s, c]
                elif st == (ci, ci):
                    out = [-c, -s]
                else:
                    out = [zero, zero]
            else:
                if st == ():
                    out = [vals[()]]
                elif st == (ci,):
                    out = [d1]
                else:
                    out = [zero]
            cols_per_stream[si].extend(out)
    # width padding duplicates column 0 (FeatureMap.pad_to) — same values
    # AND same derivative streams
    for cols in cols_per_stream:
        while len(cols) < fm.pad_to:
            cols.append(cols[0])
    return torch.stack([torch.cat(cols, dim=1) for cols in cols_per_stream], dim=0)


# ---------------------------------------------------------------------------
# Dense-chain propagation
# ---------------------------------------------------------------------------


def _act_derivs(name: str, x: Tensor):
    if name == "tanh":
        a = torch.tanh(x)
        d1 = 1.0 - a * a
        d2 = -2.0 * a * d1
    elif name == "sin":
        a = torch.sin(x)
        d1 = torch.cos(x)
        d2 = -a
    else:
        raise ValueError(f"unknown activation {name!r}")
    return a, d1, d2


def taylor2_mlp(
    params: dict,
    z: Tensor,
    spec: MLPSpec,
    fm: FeatureMap,
    lb: Tensor,
    ub: Tensor,
    indices: Iterable[MultiIndex],
) -> Dict[MultiIndex, Tensor]:
    """Fused value+derivative pass through a plain dense chain.

    Returns {multi-index: [B, out_dim]} for every planned stream (a superset
    of ``indices``).  Plain MLP family only."""
    if not spec.is_plain:
        raise ValueError("taylor2_mlp supports the plain dense family")
    streams = plan_streams(indices)
    S = len(streams)
    B = z.shape[0]
    pos = {st: k for k, st in enumerate(streams)}

    H = feature_streams(fm, z, lb, ub, streams)          # [S, B, nf]
    layers = params["layers"]
    n_layers = len(layers)

    for li, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        nf = H.shape[-1]
        X = torch.matmul(H.reshape(S * B, nf), w).reshape(S, B, -1)
        if li == 0:
            X = X * spec.scl
        if li == n_layers - 1:
            # linear output; bias only on the value stream
            out = torch.cat([X[0:1] + b, X[1:]], dim=0)
            break
        x0 = X[0] + b
        name = spec.act_first if li == 0 else spec.act_hidden
        a, d1, d2 = _act_derivs(name, x0)
        new = [a]
        for st in streams[1:]:
            if len(st) == 1:
                new.append(d1 * X[pos[st]])
            else:
                i, j = st
                new.append(
                    d2 * X[pos[(i,)]] * X[pos[(j,)]] + d1 * X[pos[st]]
                )
        H = torch.stack(new, dim=0)

    out = out * spec.epsil
    return {st: out[pos[st]] for st in streams}


# ---------------------------------------------------------------------------
# Predictor registration: structure-aware partials with generic fallback
# ---------------------------------------------------------------------------


def _kernel_route(z: Tensor) -> bool:
    """Whether the u-partials of ``z`` go through the kernels' autograd
    Function (B1 forward, B2 backward): float32 points on a CUDA card."""
    return z.device.type == "cuda" and z.dtype == torch.float32


def attach_mlp_meta(predictor, spec: MLPSpec, fm: FeatureMap, lb, ub):
    """Tag a predictor closure with its structure; when kernel B1 takes the
    net (mlp_taylor.supports), ``predictor.tpinn_partials(params, z,
    indices)`` computes the u-partials with it: on a float32 CUDA tensor
    through the B1/B2 autograd Function, on a CPU tensor with B1's plain
    version."""
    # late imports: the kernels import core
    from tpinn_torch.kernels import mlp_taylor, taylor_vjp

    # host copies of the bounds (exact fp32 values): the kernel takes them
    # as launch arguments, so a CUDA call needs no device-to-host read
    bounds_host = (tuple(lb.tolist()), tuple(ub.tolist()))

    def tpinn_partials(params, z, indices):
        if _kernel_route(z):
            return taylor_vjp.kernel_partials(
                params, z, spec, fm, *bounds_host, indices)
        return mlp_taylor.taylor2_mlp_kernel(
            params, z, spec, fm, *bounds_host, indices)

    if mlp_taylor.supports(spec, fm):
        predictor.tpinn_partials = tpinn_partials
    predictor.tpinn_kind = "mlp"
    predictor.tpinn_spec = spec
    predictor.tpinn_feature_map = fm
    predictor.tpinn_bounds = (lb, ub)
    return predictor


def attach_sum_meta(predictor, prev_predictor, stage_predictor):
    """Composed stage u = u_prev(params['prev'], z) + stage(params['stage'],
    z): partials of a sum are sums of partials, provided both parts expose
    fused partials (one kernel launch per stage).  The prev subtree is
    detached, keeping the frozen-stage semantics of net.compose_stages."""
    prev_parts = getattr(prev_predictor, "tpinn_partials", None)
    stage_parts = getattr(stage_predictor, "tpinn_partials", None)

    if prev_parts is not None and stage_parts is not None:
        def tpinn_partials(params, z, indices):
            a = stage_parts(params["stage"], z, indices)
            b = prev_parts(net_mod.detach_tree(params["prev"]), z, indices)
            return {k: a[k] + b[k] for k in a if k in b} | {
                k: v for k, v in a.items() if k not in b
            }

        predictor.tpinn_partials = tpinn_partials
    predictor.tpinn_kind = "sum"
    predictor.tpinn_prev = prev_predictor
    predictor.tpinn_stage = stage_predictor
    return predictor


def attach_frozen_meta(frozen, predictor, params):
    """Freeze params into a z-only callable, keeping fused-partials access
    and the ``(predictor, params)`` pair it closes over (``tpinn_frozen``:
    core.ensemble recasts a member's parameters for its float64 passes)."""
    frozen.tpinn_frozen = (predictor, params)
    parts = getattr(predictor, "tpinn_partials", None)
    if parts is not None:
        frozen.tpinn_frozen_partials = lambda z, indices: parts(
            params, z, indices
        )
    return frozen


def fast_partials(predictor, params, z, indices, max_order: int):
    """Engine dispatch for the residual path: the predictor's structured
    partials (kernels B1/B2) when it advertises them, the order is ≤ 2 and
    the points are float32; the generic nested-jvp engine otherwise (f64
    points included: the kernels compute in float32)."""
    from tpinn_torch.core import deriv

    fn = getattr(predictor, "tpinn_partials", None)
    if fn is not None and max_order <= 2 and z.dtype == torch.float32:
        return fn(params, z, indices)
    return deriv.partials(lambda zz: predictor(params, zz), z, indices)
