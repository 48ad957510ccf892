"""Plain PyTorch reference of a hard-BC PINN's loss, gradient and Adam steps.

It imports torch and numpy only: nothing of the measured package, of its
JAX original or of its kernels.  A configuration's own file beside this one
(``<config>.py``) writes out its feature map, its hard-BC lift and bubble
and its residual by hand; this module builds the network

    u(z) = lift(z) + bubble(z) * epsil * MLP(features(z))

with its partials in z by ``torch.autograd`` (first derivatives and the
second derivatives on the diagonal), the loss row

    [loss, loss_data, loss_eqn, data_err_1..G, eqn_err]
    loss = loss_data + lw0 * loss_eqn,  loss_n = loss / ref

and the gradient of ``loss_n`` by ``torch.autograd``, in blocks of rows so
that it fits at the benchmark's sizes (the block sums are added in
float64).  Adam follows its formulas (optax's defaults).

``prec`` sets the dense products: "fp32" (IEEE float32, TF32 off), "tf32"
(inputs rounded to TF32's 10 mantissa bits, float32 sums: what a tensor
core does with TF32) and "bf16" (inputs and result rounded to bfloat16's 7
mantissa bits, as autocast runs a product).  The rounding is done here,
so a control computed on the CPU reads as it does on the card.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch

Tensor = torch.Tensor

# explicit mantissa bits of each precision's product inputs and result
_BITS = {"tf32": (10, 23), "bf16": (7, 7)}


def round_mantissa(x: Tensor, bits: int) -> Tensor:
    """``x`` (float32) rounded to nearest-even at ``bits`` mantissa bits."""
    if bits >= 23:
        return x
    i = x.contiguous().view(torch.int32)
    shift = 23 - bits
    bias = ((i >> shift) & 1) + ((1 << (shift - 1)) - 1)
    return ((i + bias) & ~((1 << shift) - 1)).view(torch.float32)


class _RoundedMatmul(torch.autograd.Function):
    """``a @ b`` with rounded inputs and result; its backward is built of
    the same rounded products, so second and third derivatives see the
    lower precision too."""

    @staticmethod
    def forward(ctx, a, b, bits, out_bits):
        ctx.save_for_backward(a, b)
        ctx.bits = (bits, out_bits)
        y = torch.matmul(round_mantissa(a, bits), round_mantissa(b, bits))
        return round_mantissa(y, out_bits)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        bits, out_bits = ctx.bits
        ga = _RoundedMatmul.apply(g, b.transpose(0, 1), bits, out_bits)
        gb = _RoundedMatmul.apply(a.transpose(0, 1), g, bits, out_bits)
        return ga, gb, None, None


def matmul(a: Tensor, b: Tensor, prec: str) -> Tensor:
    if prec == "fp32":
        return torch.matmul(a, b)
    return _RoundedMatmul.apply(a, b, *_BITS[prec])


def no_tf32():
    """Context that turns TF32 off for torch's float32 products and
    restores the flags on exit."""
    class _Ctx:
        def __enter__(self):
            self.saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        def __exit__(self, *exc):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self.saved

    return _Ctx()


# ---------------------------------------------------------------------------
# Parameters: a list of (w [din, dout], b [dout]) per layer
# ---------------------------------------------------------------------------


def layer_sizes(cfg: dict) -> List[int]:
    return [cfg["n_features"]] + [cfg["width"]] * cfg["depth"] + [1]


def init_layers(seed: int, cfg: dict, device) -> List[List[Tensor]]:
    """Xavier-scaled normal truncated at ±2σ for weights and biases, drawn
    on the CPU from ``torch.Generator().manual_seed(seed * 1000)`` layer by
    layer (w, then b), as the configuration's recipe initialises stage 1
    from the run's seed."""
    gen = torch.Generator().manual_seed(int(seed) * 1000)
    sizes = layer_sizes(cfg)
    layers = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        std = math.sqrt(2.0 / (din + dout))
        pair = []
        for shape in ((din, dout), (dout,)):
            t = torch.empty(shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            pair.append((t * std).to(device))
        layers.append(pair)
    return layers


def leaves(layers) -> List[Tensor]:
    """The parameters in the flat order of a JAX pytree of
    ``{"layers": [{"b", "w"}, ...]}``: per layer the bias, then the
    weight."""
    return [x for w, b in layers for x in (b, w)]


def split_flat(flat: Tensor, cfg: dict) -> List[Tensor]:
    """A flat parameter vector cut into :func:`leaves`' order and shapes."""
    sizes = layer_sizes(cfg)
    out, off = [], 0
    for din, dout in zip(sizes[:-1], sizes[1:]):
        for shape in ((dout,), (din, dout)):
            n = math.prod(shape)
            out.append(flat[off:off + n].view(shape))
            off += n
    if off != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} values, the "
                         f"configuration has {off} parameters")
    return out


def from_leaves(xs: Sequence[Tensor]) -> List[List[Tensor]]:
    return [[xs[2 * i + 1], xs[2 * i]] for i in range(len(xs) // 2)]


# ---------------------------------------------------------------------------
# The model, its partials, the loss
# ---------------------------------------------------------------------------


def mlp(layers, h: Tensor, cfg: dict, prec: str) -> Tensor:
    act = {"tanh": torch.tanh, "sin": torch.sin}
    (w0, b0), *hidden, (wl, bl) = layers
    h = act[cfg["act_first"]](matmul(h, w0, prec) * cfg["scl"] + b0)
    for w, b in hidden:
        h = act[cfg["act_hidden"]](matmul(h, w, prec) + b)
    return cfg["epsil"] * (matmul(h, wl, prec) + bl)


def model(problem, layers, z: Tensor, cfg: dict, prec: str) -> Tensor:
    return (problem.lift(z)
            + problem.bubble(z) * mlp(layers, problem.features(z), cfg, prec))


def residual(problem, layers, z: Tensor, cfg: dict, prec: str) -> Tensor:
    """The residual at ``z`` [N, d], its partials by autograd (graph kept
    for the parameter gradient)."""
    z = z.detach().requires_grad_(True)
    u = model(problem, layers, z, cfg, prec)
    (du,) = torch.autograd.grad(u.sum(), z, create_graph=True)
    d2 = []
    for i in range(z.shape[1]):
        (g,) = torch.autograd.grad(du[:, i].sum(), z, create_graph=True)
        d2.append(g[:, i:i + 1])
    return problem.residual(z, u, du, torch.cat(d2, dim=1))


def value_and_grad(problem, layers, data: Dict, cfg: dict, ref,
                   prec: str = "fp32", block: int = 32768, grad: bool = True):
    """``(loss_n, loss_info [3 + G + 1] float64, grads in leaves()
    order or None)`` at ``layers`` on ``data`` (``x_col`` and the BC
    groups' ``x_bd``; the targets are the configuration's values).
    ``ref`` None: the loss itself, without a gradient (loss_n = 1)."""
    if ref is None and grad:
        raise ValueError("the gradient needs ref")
    lw0 = float(cfg["lw"][0])
    ps = [[w.detach().requires_grad_(grad), b.detach().requires_grad_(grad)]
          for w, b in layers]
    x_col = data["x_col"]
    n = x_col.shape[0]
    f64 = dict(dtype=torch.float64, device=x_col.device)
    data_errs = []
    for gi, z_bd in enumerate(data["x_bd"]):
        target = float(cfg["bc_groups"][gi]["value"])
        with torch.enable_grad():
            e = torch.mean(torch.square(
                model(problem, ps, z_bd, cfg, prec) - target))
        if grad:
            torch.autograd.backward(e / float(ref))
        data_errs.append(e.detach().double())
    sum_f2 = torch.zeros((), **f64)
    for s in range(0, n, block):
        with torch.enable_grad():
            f = residual(problem, ps, x_col[s:s + block], cfg, prec)
            t = torch.sum(torch.square(f))
        if grad:
            torch.autograd.backward(t * (lw0 / n / float(ref)))
        sum_f2 = sum_f2 + t.detach().double()
    loss_eqn = sum_f2 / n
    loss_data = (torch.stack(data_errs).sum() if data_errs
                 else torch.zeros((), **f64))
    loss = loss_data + lw0 * loss_eqn
    info = torch.cat([torch.stack([loss, loss_data, loss_eqn]),
                      torch.stack(data_errs) if data_errs
                      else torch.zeros((0,), **f64),
                      loss_eqn.reshape(1)])
    grads = None
    if grad:
        grads = [x.grad.detach().clone() if x.grad is not None
                 else torch.zeros_like(x) for x in leaves(ps)]
    return loss / (loss if ref is None else float(ref)), info, grads


def adam_steps(problem, layers0, data: Dict, cfg: dict, steps: int = 3,
               prec: str = "fp32", data_fn: Callable = None):
    """``steps`` Adam updates from ``layers0`` on ``data`` (``data_fn(k)``
    gives step k's point set where it changes), ``ref`` the loss at
    ``layers0``.  Returns ``{"ref", "rows" [steps], "grad0" (leaves),
    "params" (leaves after the last step)}``."""
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, float(cfg["lr"])
    data_fn = data_fn or (lambda k: data)
    _, info0, _ = value_and_grad(problem, layers0, data_fn(0), cfg, None,
                                 prec, grad=False)
    ref = float(info0[0])
    p = [x.detach().clone() for x in leaves(layers0)]
    m = [torch.zeros_like(x) for x in p]
    v = [torch.zeros_like(x) for x in p]
    rows, grad0 = [], None
    for k in range(steps):
        t = k + 1
        _, info, g = value_and_grad(problem, from_leaves(p), data_fn(k), cfg,
                                    ref, prec)
        rows.append(info)
        if grad0 is None:
            grad0 = g
        for i in range(len(p)):
            m[i] = b1 * m[i] + (1.0 - b1) * g[i]
            v[i] = b2 * v[i] + (1.0 - b2) * g[i] * g[i]
            mh = m[i] / (1.0 - b1 ** t)
            vh = v[i] / (1.0 - b2 ** t)
            p[i] = p[i] - lr * mh / (torch.sqrt(vh) + eps)
    return {"ref": ref, "rows": rows, "grad0": grad0, "params": p}
