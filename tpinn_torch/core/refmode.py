"""Reference-semantics mode: the reference solver's algorithmic cost model.

Port of ``tpinn.core.refmode``, the reference's hot path as written:

- float64 (the caller builds the net, its parameters and the points in
  float64),
- batched Jacobians by reverse mode with one-hot cotangents, nested twice
  for second derivatives (deriv.vect_grad_reverse),
- the hardcoded polar-Laplace residual assembled from three such calls,
- per-BC-group MSE + weighted residual MSE normalized by the initial loss,
- one Adam step per iteration, with optax's formula and defaults.

The Adam step here is plain tensor code, not kernel B3: B3 computes in
float32 and the reference's semantics are float64 (tpinn's refmode calls
optax, which no kernel implements).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from tpinn_torch.core.deriv import vect_grad_reverse
from tpinn_torch.core.optim import _rebuild, tree_leaves

Tensor = torch.Tensor


def reference_residual_polar(f_u: Callable[[Tensor], Tensor],
                             z: Tensor) -> Tensor:
    """f = u_rr + (1/r)·u_r + (1/r²)·u_θθ by reverse-over-reverse AD."""
    u_g, _ = vect_grad_reverse(f_u, z)
    u_r = u_g[:, 0:1]
    fu_r = lambda zz: vect_grad_reverse(f_u, zz)[0][:, 0:1]
    fu_t = lambda zz: vect_grad_reverse(f_u, zz)[0][:, 1:2]
    u_rr = vect_grad_reverse(fu_r, z)[0][:, 0:1]
    u_tt = vect_grad_reverse(fu_t, z)[0][:, 1:2]
    r = z[:, 0:1]
    return u_rr + 1.0 / r * u_r + 1.0 / (r ** 2) * u_tt


def make_reference_loss(predictor: Callable[[dict, Tensor], Tensor]):
    """Reference-shaped loss on the polar-Laplace problem:
    ``loss_fn(params, data, lw, ref) -> (loss / ref, loss_info)`` with
    ``loss_info = [loss, loss_data, loss_eqn, data_err..., eqn_err]``."""

    def loss_fn(params, data, lw, ref):
        f_u = lambda z: predictor(params, z)
        data_errs = []
        for z_bd, u_bd in zip(data["x_bd"], data["u_bd"]):
            diff = f_u(z_bd) - u_bd
            data_errs.append(torch.mean(torch.square(diff), dim=0))
        data_err = torch.cat(data_errs)
        f = reference_residual_polar(f_u, data["x_col"])
        eqn_err = torch.mean(torch.square(f), dim=0)
        loss_data = torch.sum(data_err)
        loss_eqn = torch.sum(eqn_err)
        loss = loss_data + lw[0] * loss_eqn
        loss_info = torch.cat(
            [torch.stack([loss, loss_data, loss_eqn]), data_err, eqn_err])
        return loss / ref, loss_info

    return loss_fn


class ReferenceAdam:
    """optax.adam's state and update: b1 0.9, b2 0.999, eps 1e-8 outside
    the root, bias corrections with the 1-based step count."""

    def __init__(self, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> dict:
        zeros = [torch.zeros_like(x) for x in tree_leaves(params)]
        return {"count": 0, "mu": zeros,
                "nu": [torch.zeros_like(x) for x in zeros]}

    def update(self, grads, state: dict, leaves):
        """New leaves and state after one step on ``grads`` (lists)."""
        count = state["count"] + 1
        mu = [(1 - self.b1) * g + self.b1 * m
              for g, m in zip(grads, state["mu"])]
        nu = [(1 - self.b2) * (g * g) + self.b2 * v
              for g, v in zip(grads, state["nu"])]
        c1 = 1 - math.pow(self.b1, count)
        c2 = 1 - math.pow(self.b2, count)
        new = [p + -self.lr * ((m / c1) / (torch.sqrt(v / c2) + self.eps))
               for p, m, v in zip(leaves, mu, nu)]
        return new, {"count": count, "mu": mu, "nu": nu}


def make_reference_adam_step(loss_fn, lr=1e-3):
    """One Adam step as the reference takes it: ``(opt, step)`` with
    ``opt.init(params)`` and ``step(params, opt_state, data, lw, ref) ->
    (params, opt_state, loss_info)``."""
    opt = ReferenceAdam(lr)

    def step(params, opt_state, data, lw, ref):
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        loss_n, loss_info = loss_fn(_rebuild(params, iter(leaves)), data,
                                    lw, ref)
        grads = torch.autograd.grad(loss_n, leaves)
        with torch.no_grad():
            new, opt_state = opt.update(grads, opt_state,
                                        [x.detach() for x in leaves])
        return _rebuild(params, iter(new)), opt_state, loss_info.detach()

    return opt, step
