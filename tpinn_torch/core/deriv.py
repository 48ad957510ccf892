"""Forward-mode derivative engine for PDE residuals (generic engine).

Port of ``tpinn.core.deriv`` on ``torch.func.jvp``.  For a batched map
``f: [N, d] -> [N, m]`` one forward-over-forward pass along whole-batch
unit tangents e_i, e_j yields the value, both first derivatives and the
mixed second derivative:

    g(z)   = (f(z), df(z)@e_j)                       # inner jvp
    jvp(g) = ((u, u_j), (u_i, u_ij))                 # outer jvp along e_i

``partials`` plans a minimal set of such passes covering every
multi-index a compiled residual reads.  This engine takes any callable:
it serves the lift/bubble factors of the hard-BC product rule, every
predictor that kernel B1 does not take, and it is the kernel's second
oracle on the card.

``vect_grad_reverse`` is the reference solver's reverse-mode batch
Jacobian, nested for second derivatives by core.refmode.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch

from tpinn_torch.utils.profiling import span

Tensor = torch.Tensor
MultiIndex = Tuple[int, ...]  # sorted tuple of coordinate indices; () == value


def _unit_tangent(z: Tensor, i: int) -> Tensor:
    """Whole-batch tangent e_i: [N, d] of zeros with column i set to 1."""
    t = torch.zeros(z.shape, dtype=z.dtype, device=z.device)
    t[:, i] = 1.0
    return t


def pair_pass(f: Callable[[Tensor], Tensor], z: Tensor, i: int, j: int):
    """One forward-over-forward pass: ``(u, u_i, u_j, u_ij)``.  When
    ``i == j`` this is the pure directional second derivative."""
    vi = _unit_tangent(z, i)
    vj = _unit_tangent(z, j)

    def g(zz):
        return torch.func.jvp(f, (zz,), (vj,))

    (u, u_j), (u_i, u_ij) = torch.func.jvp(g, (z,), (vi,))
    return u, u_i, u_j, u_ij


def first_pass(f: Callable[[Tensor], Tensor], z: Tensor, i: int):
    """Single jvp: returns ``(u, u_i)``."""
    return torch.func.jvp(f, (z,), (_unit_tangent(z, i),))


def directional(f: Callable[[Tensor], Tensor], z: Tensor, dirs: MultiIndex) -> Tensor:
    """Arbitrary-order partial D_{dirs} f via recursively nested jvp (cost
    ~2^k with order k; used for order >= 3 terms)."""
    if not dirs:
        return f(z)
    *rest, last = dirs
    v = _unit_tangent(z, last)

    def g(zz):
        return torch.func.jvp(f, (zz,), (v,))[1]

    return directional(g, z, tuple(rest))


def plan_passes(indices: Iterable[MultiIndex]):
    """Choose a minimal set of passes covering the requested multi-indices.

    Returns ``(pairs, singles, highers, want_value)``: forward-over-forward
    (i, j) passes, bare first-derivative directions not already covered,
    and the order>=3 multi-indices evaluated by nested jvp.
    """
    need = {tuple(sorted(ix)) for ix in indices}
    want_value = () in need
    pairs = sorted({ix for ix in need if len(ix) == 2})
    highers = sorted({ix for ix in need if len(ix) > 2})
    covered_firsts = {i for p in pairs for i in p}
    singles = sorted(
        {ix[0] for ix in need if len(ix) == 1} - covered_firsts
    )
    return pairs, singles, highers, want_value


def partials(
    f: Callable[[Tensor], Tensor],
    z: Tensor,
    indices: Iterable[MultiIndex],
) -> Dict[MultiIndex, Tensor]:
    """Evaluate the requested partial derivatives of ``f`` at batch ``z``.

    :param f: batched function ``[N, d] -> [N, m]``.
    :param z: evaluation points ``[N, d]``.
    :param indices: multi-indices as sorted tuples of coordinate positions,
        e.g. ``()`` = value, ``(0,)`` = d/dx0, ``(0, 1)`` = mixed second.
    :return: dict mapping each requested multi-index (plus any byproducts)
        to an ``[N, m]`` tensor.
    """
    with span("partials.generic"):
        return _partials(f, z, indices)


def _partials(f, z, indices) -> Dict[MultiIndex, Tensor]:
    pairs, singles, highers, want_value = plan_passes(indices)
    out: Dict[MultiIndex, Tensor] = {}

    for (i, j) in pairs:
        with span("partials.generic.pass"):
            u, u_i, u_j, u_ij = pair_pass(f, z, i, j)
        out.setdefault((), u)
        out[(i,)] = u_i
        out[(j,)] = u_j
        out[(i, j)] = u_ij

    for i in singles:
        with span("partials.generic.pass"):
            u, u_i = first_pass(f, z, i)
        out.setdefault((), u)
        out[(i,)] = u_i

    for ix in highers:
        with span("partials.generic.pass"):
            out[ix] = directional(f, z, ix)

    if want_value and () not in out:
        out[()] = f(z)

    return out


# ---------------------------------------------------------------------------
# Reference-semantics engine (reverse-over-reverse): the reference solver's
# batched Jacobian, for core.refmode and the parity tests.
# ---------------------------------------------------------------------------


def vect_grad_reverse(func: Callable[[Tensor], Tensor], z: Tensor):
    """Batch Jacobian by reverse mode with one-hot cotangents.

    Returns ``(grad [N, m*d], sol [N, m])`` in the reference's column
    layout (output-major): column ``o*d + i`` is d(out_o)/d(z_i).  Built
    on ``torch.func.vjp`` with ``torch.func.vmap`` over the m cotangents,
    so it nests: a call on a function of another call's gradient gives
    second derivatives, and autograd reaches tensors ``func`` closes over.
    """
    sol, vjp_fn = torch.func.vjp(func, z)
    n, m = sol.shape
    eye = torch.eye(m, dtype=sol.dtype, device=sol.device)
    cotangents = eye[:, None, :].expand(m, n, m)
    (grad_rows,) = torch.func.vmap(vjp_fn)(cotangents)  # [m, N, d]
    grad_all = grad_rows.transpose(0, 1).reshape(n, z.shape[1] * m)
    return grad_all, sol
