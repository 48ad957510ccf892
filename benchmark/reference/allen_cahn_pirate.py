"""The Allen–Cahn problem on a PirateNet, written out by hand for the
reference.

z = (x, t) on [-1, 1] x [0, 1]; the embedding is (cos w, sin w, 2 t - 1)
with w = 2 pi (x + 1) / 2, periodic in x; the hard-IC ansatz is
u = x^2 cos(pi x) + t N, which meets u(x, 0) for any N; the residual is
u_t - 1e-4 u_xx + 5 u^3 - 5 u.

The network (Wang et al. 2024, arXiv:2402.00326), with sigma = tanh and
every dense layer's weight W = v diag(g) (random weight factorisation):

    Phi = [cos(e B), sin(e B)];  U = sigma(Phi W_u + b_u), V likewise
    x = Phi;  per block l:  f = sigma(x W_1 + b_1),  z = f U + (1 - f) V
                            g = sigma(z W_2 + b_2),  z = g U + (1 - g) V
                            h = sigma(z W_3 + b_3),  x = a_l h + (1 - a_l) x
    N = epsil (x W_out + b_out)

Its partials in z come from ``torch.autograd``.  The loss row is
``[loss, loss_data, loss_eqn, data_err, eqn_err]`` with the causal weights
of 32 slabs in t: slab i's mean squared residual L_i over the whole batch
gives w_i = exp(-eps sum_{j<i} L_j / sum_j L_j), held fixed, and loss_eqn
is the mean of w r^2 while eqn_err stays the plain mean.  The slab means
are taken first, without a graph in the parameters; then the weighted
residual's gradient is taken in blocks of points.  Adam follows optax's
defaults (reference.common).  Parameters are a list of tensors in the
flat order of the port's pytree (dict keys sorted): alpha, fourier_b,
gate_u (b, g, v), gate_v (b, g, v), then each dense layer (b, g, v).

It imports torch and reference.common only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from benchmark.reference import common

Tensor = torch.Tensor
X0, X1, T0, T1 = -1.0, 1.0, 0.0, 1.0


def features(z):
    x, t = z[:, 0:1], z[:, 1:2]
    w = 2.0 * math.pi * (x - X0) / (X1 - X0)
    return torch.cat([torch.cos(w), torch.sin(w),
                      2.0 * (t - T0) / (T1 - T0) - 1.0], dim=1)


def initial(z):
    x = z[:, 0:1]
    return x * x * torch.cos(math.pi * x)


def lift(z):
    return initial(z)


def bubble(z):
    return z[:, 1:2]


def residual(z, u, du, d2):
    """u_t - 1e-4 u_xx + 5 u^3 - 5 u from u, (u_x, u_t) and (u_xx, ...)."""
    return du[:, 1:2] - 1e-4 * d2[:, 0:1] + 5.0 * u ** 3 - 5.0 * u


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _dense_shapes(cfg: dict):
    w = cfg["width"]
    return [(w, w)] * (2 + 3 * cfg["pirate_blocks"]) + [(w, 1)]


def shapes(cfg: dict) -> List[tuple]:
    """The leaves' shapes in the flat order."""
    out = [(cfg["pirate_blocks"],), (cfg["n_features"],
                                     cfg["fourier_features"])]
    for _, dout in _dense_shapes(cfg):
        din = cfg["width"]
        out += [(dout,), (dout,), (din, dout)]
    return out


def init(seed: int, cfg: dict, device) -> List[Tensor]:
    """The recipe's initialisation from the run's seed, drawn on the CPU
    from ``torch.Generator().manual_seed(seed * 1000)``: B ~ N(0, 1) times
    ``fourier_scale``; then per dense layer (the gates, the blocks' layers
    in order, the output) w and b Xavier-scaled normal truncated at ±2σ,
    s ~ N(mean, std) per output column, g = exp(s), v = w / g; alpha = 0.
    Returns the leaves in the flat order."""
    gen = torch.Generator().manual_seed(int(seed) * 1000)
    b_mat = torch.randn((cfg["n_features"], cfg["fourier_features"]),
                        dtype=torch.float32, generator=gen)
    b_mat = b_mat * float(cfg["fourier_scale"])
    mean, std_s = (float(v) for v in cfg["weight_fact"])
    dense = []
    for din, dout in _dense_shapes(cfg):
        std = math.sqrt(2.0 / (din + dout))
        pair = []
        for shape in ((din, dout), (dout,)):
            t = torch.empty(shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            pair.append(t * std)
        s = torch.randn((dout,), dtype=torch.float32, generator=gen)
        g = torch.exp(mean + std_s * s)
        dense += [pair[1], g, pair[0] / g]
    alpha = torch.zeros((cfg["pirate_blocks"],), dtype=torch.float32)
    return [x.to(device) for x in [alpha, b_mat] + dense]


def split_flat(flat: Tensor, cfg: dict) -> List[Tensor]:
    """A flat parameter vector cut into the leaves' order and shapes."""
    out, off = [], 0
    for shape in shapes(cfg):
        n = math.prod(shape)
        out.append(flat[off:off + n].view(shape))
        off += n
    if off != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} values, the "
                         f"configuration has {off} parameters")
    return out


def _tree(leaves: Sequence[Tensor]) -> Dict:
    alpha, b_mat, *dense = leaves
    layers = [dense[3 * i:3 * i + 3] for i in range(len(dense) // 3)]
    return {"alpha": alpha, "B": b_mat, "gate_u": layers[0],
            "gate_v": layers[1], "layers": layers[2:]}


# ---------------------------------------------------------------------------
# The model, its partials, the loss
# ---------------------------------------------------------------------------


def _dense(layer, h, prec):
    b, g, v = layer
    return common.matmul(h, g * v, prec) + b


def model(leaves: Sequence[Tensor], z: Tensor, cfg: dict,
          prec: str = "fp32") -> Tensor:
    p = _tree(leaves)
    proj = common.matmul(features(z), p["B"], prec)
    x = torch.cat([torch.cos(proj), torch.sin(proj)], dim=1)
    u = torch.tanh(_dense(p["gate_u"], x, prec))
    v = torch.tanh(_dense(p["gate_v"], x, prec))
    for blk in range(cfg["pirate_blocks"]):
        l1, l2, l3 = p["layers"][3 * blk:3 * blk + 3]
        f = torch.tanh(_dense(l1, x, prec))
        zz = f * u + (1.0 - f) * v
        g = torch.tanh(_dense(l2, zz, prec))
        zz = g * u + (1.0 - g) * v
        h = torch.tanh(_dense(l3, zz, prec))
        a = p["alpha"][blk]
        x = a * h + (1.0 - a) * x
    out = cfg["epsil"] * _dense(p["layers"][-1], x, prec)
    return lift(z) + bubble(z) * out


def partials(leaves, z: Tensor, cfg: dict, prec: str = "fp32",
             create_graph: bool = True):
    """``(u, u_x, u_t, u_xx)`` at ``z`` [N, 2] by autograd."""
    z = z.detach().requires_grad_(True)
    with torch.enable_grad():
        u = model(leaves, z, cfg, prec)
        (du,) = torch.autograd.grad(u.sum(), z, create_graph=True)
        (d2x,) = torch.autograd.grad(du[:, 0].sum(), z,
                                     create_graph=create_graph)
    return u, du[:, 0:1], du[:, 1:2], d2x[:, 0:1]


def residual_at(leaves, z: Tensor, cfg: dict, prec: str = "fp32",
                create_graph: bool = True) -> Tensor:
    u, u_x, u_t, u_xx = partials(leaves, z, cfg, prec, create_graph)
    return residual(z, u, torch.cat([u_x, u_t], dim=1), u_xx)


def slab_weights(z: Tensor, r2: Tensor, cfg: dict) -> Tensor:
    """Each point's causal weight from the whole batch's squared residuals
    ``r2`` [N] (float64 sums; the slab of a point as the port bins it)."""
    nb, eps = int(cfg["causal_bins"]), float(cfg["causal_eps"])
    axis = cfg["coords"].index(cfg["causal_axis"])
    t0, t1 = cfg["lb"][axis], cfg["ub"][axis]
    pos = (z[:, axis] - t0) / (t1 - t0)
    idx = torch.clamp((pos * nb).to(torch.int32), 0, nb - 1).long()
    r2 = r2.double()
    sums = r2.new_zeros(nb).index_add_(0, idx, r2)
    counts = r2.new_zeros(nb).index_add_(0, idx, torch.ones_like(r2))
    l_slab = sums / torch.clamp(counts, min=1.0)
    tot = torch.clamp(torch.sum(l_slab), min=1e-30)
    w = torch.exp(-eps * (torch.cumsum(l_slab, 0) - l_slab) / tot)
    return w[idx]


def value_and_grad(leaves, data: Dict, cfg: dict, ref, prec: str = "fp32",
                   block: int = 8192, grad: bool = True):
    """``(loss_n, loss_info [5] float64, grads in leaf order or None)``.
    ``ref`` None: the loss without causal weights and without a gradient
    (the recipe's normalisation, loss_n = 1)."""
    if ref is None and grad:
        raise ValueError("the gradient needs ref")
    causal = ref is not None and float(cfg["causal_eps"]) > 0
    lw0 = float(cfg["lw"][0])
    ps = [x.detach().requires_grad_(grad) for x in leaves]
    x_col = data["x_col"]
    n = x_col.shape[0]
    f64 = dict(dtype=torch.float64, device=x_col.device)
    data_errs = []
    for z_bd in data["x_bd"]:
        with torch.enable_grad():
            e = torch.mean(torch.square(model(ps, z_bd, cfg, prec)
                                        - initial(z_bd)))
        if grad:
            torch.autograd.backward(e / float(ref))
        data_errs.append(e.detach().double())
    # the whole batch's squared residuals, no graph in the parameters
    frozen = [x.detach() for x in ps]
    r2 = torch.cat([torch.sum(torch.square(residual_at(
        frozen, x_col[s:s + block], cfg, prec, create_graph=False).detach()),
        dim=1) for s in range(0, n, block)])
    loss_plain = torch.sum(r2.double()) / n
    w = slab_weights(x_col, r2, cfg) if causal else torch.ones_like(
        r2, dtype=torch.float64)
    loss_eqn = torch.sum(w * r2.double()) / n
    if grad:
        w32 = w.to(r2.dtype)
        for s in range(0, n, block):
            with torch.enable_grad():
                f = residual_at(ps, x_col[s:s + block], cfg, prec)
                t = torch.sum(w32[s:s + block] * torch.sum(torch.square(f),
                                                           dim=1))
            torch.autograd.backward(t * (lw0 / n / float(ref)))
    loss_data = (torch.stack(data_errs).sum() if data_errs
                 else torch.zeros((), **f64))
    loss = loss_data + lw0 * loss_eqn
    info = torch.cat([torch.stack([loss, loss_data, loss_eqn]),
                      torch.stack(data_errs) if data_errs
                      else torch.zeros((0,), **f64),
                      loss_plain.reshape(1)])
    grads = None
    if grad:
        grads = [x.grad.detach().clone() if x.grad is not None
                 else torch.zeros_like(x) for x in ps]
    return loss / (loss if ref is None else float(ref)), info, grads


def adam_steps(leaves0, data: Dict, cfg: dict, steps: int = 3,
               prec: str = "fp32"):
    """``steps`` Adam updates from ``leaves0`` on ``data``, ``ref`` the
    loss at ``leaves0`` (without causal weights, as the recipe normalises).
    Returns ``{"ref", "rows" [steps], "grad0", "grad1", "params"}``:
    the gradients of steps 1 and 2 and the parameters after the last step
    (leaves; ``grad1`` None for one step)."""
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, float(cfg["lr"])
    _, info0, _ = value_and_grad(leaves0, data, cfg, None, prec, grad=False)
    ref = float(info0[0])
    p = [x.detach().clone() for x in leaves0]
    m = [torch.zeros_like(x) for x in p]
    v = [torch.zeros_like(x) for x in p]
    rows, grads = [], []
    for k in range(steps):
        t = k + 1
        _, info, g = value_and_grad(p, data, cfg, ref, prec)
        rows.append(info)
        grads.append(g)
        for i in range(len(p)):
            m[i] = b1 * m[i] + (1.0 - b1) * g[i]
            v[i] = b2 * v[i] + (1.0 - b2) * g[i] * g[i]
            mh = m[i] / (1.0 - b1 ** t)
            vh = v[i] / (1.0 - b2 ** t)
            p[i] = p[i] - lr * mh / (torch.sqrt(vh) + eps)
    return {"ref": ref, "rows": rows, "grad0": grads[0],
            "grad1": grads[1] if steps > 1 else None, "params": p}
