"""Driver of the L-BFGS cells: ``tpinn_torch.core.optim.lbfgs_over_pytree``,
the L-BFGS entry that ``run_training`` calls, on the loss that
``tpinn_torch.core.loss.make_loss(engine="auto")`` builds for the
configuration's hard-BC predictor, over the configuration's deterministic
grid (made here: a ``grid``^d tensor grid of collocation points, and
``grid`` evenly spaced points per BC group along its box), from the seed's
initial parameters with ``ref`` the loss there.

A round is the configuration's (``max_iters``, ``memory``, strong Wolfe,
``tolerance``); a round that stops early is followed by the next one from
where it stopped.  The loss handed to the optimizer counts evaluations:
set-up ends at evaluation ``warm_evals``, the window closes at the first
evaluation after ``--seconds``, where it raises (every earlier evaluation
has ended: the line search reads each one's value).  A traced run
profiles ``trace_evals`` more.  Its first four evaluations are watched
(the parameters, the loss row, the gradient by hooks on the leaves) and
handed on unchanged.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.drivers.adam import WindowClosed, shape_args
from benchmark.harness import compare, trace
from benchmark.reference import common as ref_common
from benchmark.work import b1, b2, step as step_work


def grid_data(cfg, g: int, device) -> dict:
    """The deterministic grid: collocation points on a g^d tensor grid
    ('xy' in 2-D, 'ij' from 3-D), g points along each BC group's box."""
    d = len(cfg["coords"])
    axes = [torch.linspace(cfg["lb"][i], cfg["ub"][i], g, device=device)
            for i in range(d)]
    if d == 2:
        A, B = torch.meshgrid(axes[0], axes[1], indexing="xy")
        x_col = torch.stack([A.reshape(-1), B.reshape(-1)], dim=1)
    else:
        meshes = torch.meshgrid(*axes, indexing="ij")
        x_col = torch.stack([m.reshape(-1) for m in meshes], dim=1)
    x_bd, u_bd = [], []
    for grp in cfg["bc_groups"]:
        lo = torch.tensor(grp["lo"], device=device)
        hi = torch.tensor(grp["hi"], device=device)
        varying = [i for i in range(d) if grp["hi"][i] != grp["lo"][i]]
        if len(varying) <= 1:
            ts = torch.linspace(0.0, 1.0, g, device=device)[:, None]
            pts = lo[None, :] + ts * (hi - lo)[None, :]
        else:
            m = int(np.ceil(g ** (1.0 / len(varying))))
            mv = torch.meshgrid(*[torch.linspace(grp["lo"][i], grp["hi"][i],
                                                 m, device=device)
                                  for i in varying], indexing="ij")
            n = mv[0].numel()
            pts = torch.stack([mv[varying.index(i)].reshape(-1)
                               if i in varying else
                               torch.full((n,), grp["lo"][i], device=device)
                               for i in range(d)], dim=1)
        x_bd.append(pts)
        u_bd.append(torch.full((pts.shape[0], 1), float(grp["value"]),
                               device=device))
    return {"x_col": x_col, "x_bd": x_bd, "u_bd": u_bd}


def program(cell, seed, device):
    """The program's loss, initial parameters and L-BFGS configuration for
    the configuration's recipe."""
    from tpinn_torch import problems
    from tpinn_torch.core import loss as loss_mod, net, optim, pde

    cfg = cell.config
    problem, spec = problems.get_recipe(cfg["recipe"])
    st = spec.stages[0]
    lcfg = cfg["lbfgs"]
    rounds = max(1, st.lbfgs_rounds)
    stated = {"grid": st.lbfgs_grid,
              "max_iters": max(1, int(st.lbfgs_epochs / 3 / rounds)),
              "depth": st.depth, "width": st.width, "lw": list(spec.lw),
              "hard_bc": list(problem.hard_bc),
              "equation": problem.equation, "dtype": spec.dtype}
    for key, value in stated.items():
        have = lcfg.get(key, cfg.get(key))
        if have != value:
            raise ValueError(f"configuration {cfg['name']}: {key} is "
                             f"{have!r}, the recipe runs {value!r}")
    if spec.lbfgs_dtype is not None or spec.pad_features:
        raise ValueError("the recipe's L-BFGS is float32 on the plain "
                         "feature map")
    mspec = net.MLPSpec(depth=st.depth, width=st.width,
                        act_first=st.act_first, act_hidden=st.act_hidden,
                        scl=float(st.scl), epsil=float(st.epsil))
    fm = net.feature_map_for(problem.feature_kinds, pad_to=spec.pad_features)
    lb = torch.tensor(problem.lb, device=device)
    ub = torch.tensor(problem.ub, device=device)
    pred = net.wrap_hard_bc(
        net.make_predictor(mspec, fm, lb, ub),
        *(pde.compile_coord_expr(e, problem.coords) for e in problem.hard_bc))
    compiled = pde.compile_pde(problem.equation, problem.coords)
    loss_fn = loss_mod.make_loss(pred, compiled, engine="auto")
    params = net.init_params(torch.Generator().manual_seed(int(seed) * 1000),
                             mspec, fm, device)
    config = optim.LBFGSConfig(max_iters=lcfg["max_iters"],
                               memory=lcfg["memory"],
                               tolerance=lcfg["tolerance"],
                               history=spec.lbfgs_history)
    lw = torch.tensor(spec.lw, device=device)
    return loss_fn, params, config, lw


class Counted:
    """The loss as the optimizer gets it: counts evaluations, opens,
    closes and traces the window, watches the first four."""

    watch = 4

    def __init__(self, loss_fn, t_start, seconds, traffic, do_trace):
        self.fn = loss_fn
        self.__dict__.update({k: v for k, v in loss_fn.__dict__.items()
                              if k.startswith("tpinn_")})
        self.t_start, self.seconds = t_start, float(seconds)
        self.warm = int(traffic["warm_evals"])
        self.trace_evals = int(traffic["trace_evals"])
        self.do_trace = do_trace
        self.evals, self.phase = 0, "setup"
        self.seen = []            # (flat params, loss row, leaf grads)
        self.values = []          # loss_n of the window's evaluations
        self.stretch = None

    def __call__(self, params, data, lw, ref):
        k = self.evals
        self.evals += 1
        now = time.perf_counter()
        if self.phase == "setup" and k == self.warm:
            self.phase, self.t_open, self.k_open = "window", now, k
            self.setup_s = now - self.t_start
        elif self.phase == "window" and now - self.t_open >= self.seconds:
            self.t_close, self.k_close = now, k
            if not self.do_trace:
                raise WindowClosed
            self.phase, self.trace_from = "trace", k
            self.stretch = trace.Stretch()
            self.stretch.start()
        elif self.phase == "trace" and k - self.trace_from >= self.trace_evals:
            self.stretch.stop()
            self.trace_to = k
            raise WindowClosed
        leaves = None
        if k < self.watch:
            leaves = ref_common.leaves([(layer["w"], layer["b"])
                                        for layer in params["layers"]])
            grads = [None] * len(leaves)
            for i, leaf in enumerate(leaves):
                leaf.register_hook(
                    lambda g, i=i, grads=grads: grads.__setitem__(
                        i, g.detach().clone()))
        loss_n, info = self.fn(params, data, lw, ref)
        if leaves is not None:
            flat = torch.cat([x.detach().reshape(-1) for x in leaves])
            self.seen.append((flat, info.detach().clone(), grads))
        if self.phase == "window":
            self.values.append(loss_n.detach())
        return loss_n, info


def run(cell, seed, seconds, do_trace, t_start, device, ranks=None):
    from tpinn_torch.core import optim

    if ranks is not None:
        raise ValueError("the L-BFGS driver runs on one card")
    cfg = cell.config
    loss_fn, params, config, lw = program(cell, seed, device)
    data = grid_data(cfg, int(cell.traffic["grid"]), device)
    with torch.no_grad():
        ref = optim.evaluate_loss(loss_fn, params, data, lw,
                                  torch.ones((), device=device))[1][0]
    counted = Counted(loss_fn, t_start, seconds, cell.traffic, do_trace)
    try:
        while True:
            params, _, _ = optim.lbfgs_over_pytree(counted, params, data, lw,
                                                   ref, config)
    except WindowClosed:
        pass
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    evals = counted.k_close - counted.k_open
    window_s = counted.t_close - counted.t_open
    n = data["x_col"].shape[0]
    vals = torch.stack(counted.values[:evals]) if evals else None
    failed = 0 if vals is None else int((~torch.isfinite(vals)).sum())
    out = {"end_to_end": {"setup_s": counted.setup_s,
                          "lbfgs_points_per_s": evals * n / window_s},
           "attempted": evals, "failed": failed, "memory_peak_bytes": peak}
    if do_trace:
        steps = counted.trace_to - counted.trace_from
        out["layer_ctx"] = {
            "events": counted.stretch.events,
            "seconds": counted.stretch.seconds, "units": steps,
            "calls": {"b1": [(shape_args(cfg, n), steps)],
                      "b2": [(shape_args(cfg, n), steps)]},
            "work": {"b1": b1, "b2": b2},
            "window_units": evals, "window_s": window_s,
            "unit_flops": step_work.operations(*shape_args(cfg, n)),
            "peaks": cell.peaks}
    seen = counted.seen
    out["judge"] = lambda: judge(cell, seed, seen, data)
    out["state"] = (seen, data)
    return out


# ---------------------------------------------------------------------------
# correctness
# ---------------------------------------------------------------------------


def program_outcome(seen, cfg):
    """The first three evaluations as the optimizer got them (parameters,
    loss rows, gradients), and its first step x1 - x0."""
    return {"x": [s[0].cpu() for s in seen[:3]],
            "rows": [s[1] for s in seen[:3]],
            "grads": [s[2] for s in seen[:3]],
            "dir": ref_common.split_flat((seen[1][0] - seen[0][0]).cpu(),
                                         cfg)}


def reference_outcome(cell, seed, data, xs, prec="fp32"):
    """The reference at the program's three evaluation points (the line
    search's probes are the program's own state), its loss at the seed's
    initial parameters as ``ref``, and the first step L-BFGS takes from
    there: -min(1, 1/|g0|_1) g0."""
    cfg = cell.config
    problem = cell.reference()
    dev = data["x_col"].device
    layers0 = ref_common.init_layers(seed, cfg, dev)
    with ref_common.no_tf32():
        _, info0, _ = ref_common.value_and_grad(problem, layers0, data, cfg,
                                                None, prec, grad=False)
        ref = float(info0[0])
        rows, grads = [], []
        for x in xs:
            layers = ref_common.from_leaves(ref_common.split_flat(x.to(dev),
                                                                  cfg))
            _, info, g = ref_common.value_and_grad(problem, layers, data, cfg,
                                                   ref, prec)
            rows.append(info)
            grads.append(g)
    g0 = grads[0]
    l1 = sum(float(g.double().abs().sum()) for g in g0)
    a0 = min(1.0, 1.0 / max(l1, 1e-12))
    x0 = torch.cat([x.reshape(-1) for x in ref_common.leaves(layers0)])
    return {"x0": x0.cpu(), "rows": rows, "grads": grads,
            "dir": [-a0 * g for g in g0]}


def readings(prog, ref):
    return {"init_gap": compare.max_abs(prog["x"][0], ref["x0"]),
            "loss_gap": compare.row_gap(prog["rows"], ref["rows"]),
            "grad_gap": max(compare.leaf_gap(p, r) for p, r in
                            zip(prog["grads"], ref["grads"], strict=True)),
            "dir_gap": compare.leaf_gap(prog["dir"], ref["dir"])}


def judge(cell, seed, seen, data):
    if len(seen) < 3 or any(g is None for s in seen[:3] for g in s[2]):
        return {"init_gap": math.inf}
    prog = program_outcome(seen, cell.config)
    ref = reference_outcome(cell, seed, data, prog["x"])
    return readings(prog, ref)


def controls(cell, seed, out, prec, fractions):
    """Readings of the control (the reference in ``prec`` put in the
    program's place, at the program's evaluation points) and of the
    faults planted in the reference: the grid cut to its first
    ``fraction``."""
    seen, data = out["state"]
    xs = program_outcome(seen, cell.config)["x"]
    ref = reference_outcome(cell, seed, data, xs)

    def as_program(r):
        return {"x": [r["x0"]], "rows": r["rows"], "grads": r["grads"],
                "dir": r["dir"]}

    res = {"control": readings(as_program(reference_outcome(
        cell, seed, data, xs, prec)), ref)}
    for frac in fractions:
        part = {k: ([x[:int(x.shape[0] * frac)] for x in v]
                    if isinstance(v, list) else v[:int(v.shape[0] * frac)])
                for k, v in data.items()}
        res[f"fault_part_{frac:g}"] = readings(as_program(
            reference_outcome(cell, seed, part, xs)), ref)
    return res
