"""Driver of the Adam cells: the configuration's recipe through
``tpinn_torch.core.train.run_training``, its Adam phase measured.

The traffic file gives the point mix of a step (``n_col``, ``n_band``,
``n_adaptive``, ``n_bd`` per BC group: global counts, shared among the
ranks of a mesh), ``adam_epochs`` (more than a window reaches),
``log_every``, ``warm_steps`` and ``trace_steps``.  Everything else is the
recipe's, seeded by ``--seed``; ``output_dir`` is None.

The phase replays its loss rows to ``log_fn`` every ``10 * log_every``
steps, after reading them from the card: there all earlier steps have
ended.  Set-up runs to the first replay at or after ``warm_steps``; the
window opens there and closes at the first replay after ``--seconds``
(on a mesh the ranks agree on that by an all-reduce), where ``log_fn``
raises.  A traced run profiles the next ``trace_steps`` steps after the
window.

What is judged is observed, not recomputed: the loss's first calls (the
point set, the rows) and kernel B3's launcher (the parameters before step
1, the first moment after it, the parameters after step 3) are watched
through thin wrappers that hand everything on unchanged.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
import types

import torch

from benchmark.harness import compare, trace
from benchmark.reference import common as ref_common
from benchmark.work import b1, b2, step as step_work


class WindowClosed(Exception):
    """Raised from ``log_fn`` to end ``run_training`` when the window (and
    the traced stretch) is over."""


def recipe(cell, seed: int):
    """The configuration's recipe with the traffic's point mix, held to
    the numbers the configuration file states."""
    from tpinn_torch import problems

    cfg, tr = cell.config, cell.traffic
    problem, spec = problems.get_recipe(cfg["recipe"])
    if len(spec.stages) != 1:
        raise ValueError(f"{cfg['recipe']}: one stage expected")
    st = spec.stages[0]
    stated = {
        "depth": st.depth, "width": st.width, "act_first": st.act_first,
        "act_hidden": st.act_hidden, "scl": st.scl, "epsil": st.epsil,
        "lw": list(spec.lw), "lr": spec.lr, "dtype": spec.dtype,
        "adam_precision": spec.adam_precision, "density_grid": spec.grid,
        "resample_every": spec.resample_every,
        "density_every": spec.density_every,
        "plateau_every": spec.plateau_every,
        "hard_bc": list(problem.hard_bc), "equation": problem.equation,
        "coords": list(problem.coords), "lb": list(problem.lb),
        "ub": list(problem.ub),
        "feature_kinds": list(problem.feature_kinds),
    }
    for key, value in stated.items():
        if cfg[key] != value:
            raise ValueError(f"configuration {cfg['name']}: {key} is "
                             f"{cfg[key]!r}, the recipe runs {value!r}")
    st = dataclasses.replace(st, adam_epochs=int(tr["adam_epochs"]))
    spec = dataclasses.replace(
        spec, n_col=tr["n_col"], n_band=tr["n_band"],
        n_adaptive=tr["n_adaptive"], n_bd=tr["n_bd"],
        log_every=tr["log_every"], seed=int(seed), stages=(st,))
    return problem, spec


def points_per_step(cell) -> int:
    tr = cell.traffic
    return (tr["n_col"] + tr["n_band"] + tr["n_adaptive"]
            + len(cell.config["bc_groups"]) * tr["n_bd"])


class Capture:
    """Watches the program's first steps: the loss's first four calls (the
    normalisation, steps 0-2), their reduction on a mesh, and kernel B3's
    launcher.  Every wrapper returns what it was given; the loss's wrapper
    stays in the path as one Python call."""

    calls = 4

    def __init__(self):
        self.local, self.reduced = [], []
        self.x0 = self.m1 = self.p3 = None

    def __enter__(self):
        from tpinn_torch import parallel
        from tpinn_torch.core import loss as loss_mod
        from tpinn_torch.kernels import adam as adam_kernel

        cap = self
        make_loss = loss_mod.make_loss
        make_parallel = parallel.make_parallel_loss
        base = adam_kernel.FusedAdam

        def watched_make_loss(*args, **kwargs):
            fn = make_loss(*args, **kwargs)

            def loss_fn(params, data, lw, ref):
                out = fn(params, data, lw, ref)
                if len(cap.local) < cap.calls:
                    cap.local.append((data, out[0].detach().clone(),
                                      out[1].detach().clone()))
                return out

            loss_fn.__dict__.update(fn.__dict__)
            return loss_fn

        def watched_parallel(loss_fn, mesh, sum_ensemble=False):
            fn = make_parallel(loss_fn, mesh, sum_ensemble)
            reduce = fn.tpinn_reduce

            def watched_reduce(loss_n, info, grads):
                out = reduce(loss_n, info, grads)
                if len(cap.reduced) < cap.calls:
                    cap.reduced.append((out[0].detach().clone(),
                                        out[1].detach().clone()))
                return out

            fn.tpinn_reduce = watched_reduce
            return fn

        class Watched(base):
            def __init__(self, p, *args, **kwargs):
                super().__init__(p, *args, **kwargs)
                self._seen = None
                if cap.x0 is None:
                    cap.x0 = p.detach().clone()
                    self._seen = 0

            def step(self, g):
                out = base.step(self, g)
                if self._seen is not None:
                    self._seen += 1
                    if self._seen == 1:
                        cap.m1 = self.m.detach().clone()
                    elif self._seen == 3:
                        cap.p3 = self.p.detach().clone()
                        self.step = types.MethodType(base.step, self)
                return out

        self._restore = [(loss_mod, "make_loss", make_loss),
                         (parallel, "make_parallel_loss", make_parallel),
                         (adam_kernel, "FusedAdam", base)]
        loss_mod.make_loss = watched_make_loss
        parallel.make_parallel_loss = watched_parallel
        adam_kernel.FusedAdam = Watched
        return self

    def __exit__(self, *exc):
        for mod, attr, value in self._restore:
            setattr(mod, attr, value)

    def rows(self):
        """The loss rows of steps 0-2 as the optimizer got them."""
        src = self.reduced if self.reduced else [c[1:] for c in self.local]
        return [info for _, info in src[1:self.calls]]

    def ready(self) -> bool:
        return (len(self.local) >= self.calls and self.m1 is not None
                and self.p3 is not None
                and all(c[0] is self.local[0][0] for c in self.local))


class Window:
    """``log_fn`` of run_training: opens, closes and traces the window at
    replays, and counts failed steps from the logged rows."""

    def __init__(self, t_start, seconds, traffic, do_trace, agree=None):
        self.t_start, self.seconds = t_start, float(seconds)
        self.every = int(traffic["log_every"])
        self.chunk = 10 * self.every
        self.warm = int(traffic["warm_steps"])
        self.trace_steps = int(traffic["trace_steps"])
        self.do_trace, self.agree = do_trace, agree
        self.phase = "setup"
        self.first_bad = None
        self.stretch = None
        self.marks = []           # (steps done, host clock) at replays

    def __call__(self, msg: str):
        if not msg.startswith("Step: "):
            return
        fields = msg.split("|")
        step = int(fields[0].split(":")[1])
        loss = float(fields[1].split(":")[1])
        if not math.isfinite(loss) and self.first_bad is None:
            self.first_bad = step
        if step % self.chunk == self.chunk - self.every:
            self.replay(step + self.every)

    def replay(self, done: int):
        now = time.perf_counter()
        if self.phase == "setup":
            if done >= self.warm:
                self.phase, self.t_open, self.done_open = "window", now, done
                self.setup_s = now - self.t_start
                self.marks.append((done, now))
            return
        if self.phase == "window":
            self.marks.append((done, now))
            over = now - self.t_open >= self.seconds
            if self.agree is not None:
                over = self.agree(over)
            if not over:
                return
            self.t_close, self.done_close = now, done
            if not self.do_trace:
                raise WindowClosed
            self.phase, self.trace_from = "trace", done
            self.stretch = trace.Stretch()
            self.stretch.start()
            return
        if done - self.trace_from >= self.trace_steps:
            self.stretch.stop()
            self.trace_to = done
            raise WindowClosed

    def failed(self) -> int:
        if self.first_bad is None or self.first_bad >= self.done_close:
            return 0
        return self.done_close - max(self.first_bad, self.done_open)


def run(cell, seed, seconds, do_trace, t_start, device, ranks=None):
    """Run the cell; returns the driver's outcome (see harness.cell)."""
    from tpinn_torch import parallel
    from tpinn_torch.core import train

    problem, spec = recipe(cell, seed)
    mesh = parallel.make_mesh() if ranks is not None else None
    window = Window(t_start, seconds, cell.traffic, do_trace,
                    ranks.agree if ranks is not None else None)
    with Capture() as cap:
        try:
            train.run_training(problem, spec, output_dir=None,
                               log_fn=window, mesh=mesh, device=device)
        except WindowClosed:
            pass
        else:
            raise RuntimeError("run_training ended before the window closed")
    if not cap.ready():
        raise RuntimeError("the first steps were not observed")
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    world = 1 if ranks is None else ranks.world
    n_step = points_per_step(cell)
    per = sorted(1e3 * (t1 - t0) / (d1 - d0) for (d0, t0), (d1, t1)
                 in zip(window.marks, window.marks[1:]))
    if per:
        print(f"window: {len(per)} chunks, ms a step min {per[0]:.3f} "
              f"median {per[len(per) // 2]:.3f} max {per[-1]:.3f}",
              file=sys.stderr)
    steps = window.done_close - window.done_open
    out = {
        "end_to_end": {
            "setup_s": window.setup_s,
            "adam_points_per_s":
                steps * n_step / (window.t_close - window.t_open)},
        "attempted": steps, "failed": window.failed(),
        "memory_peak_bytes": peak,
    }
    if do_trace:
        out["layer_ctx"] = layer_ctx(cell, window, n_step // world)
    out["judge"] = lambda: judge(cell, seed, cap, ranks)
    out["state"] = cap
    return out


def shape_args(cfg, n):
    return (n, cfg["depth"], cfg["width"], cfg["n_features"],
            len(cfg["coords"]), cfg["streams"])


def layer_ctx(cell, window, n_rank):
    """What the per-layer readers take: the traced stretch's events and
    length, its steps and the kernels' calls in it, and the untraced
    window's steps and length."""
    cfg = cell.config
    steps = window.trace_to - window.trace_from
    every = cfg["density_every"]
    refresh = sum(1 for s in range(window.trace_from, window.trace_to)
                  if (s + 1) % every == 0)
    grid_n = cfg["density_grid"] ** len(cfg["coords"])
    return {
        "events": window.stretch.events, "seconds": window.stretch.seconds,
        "units": steps,
        "calls": {"b1": [(shape_args(cfg, n_rank), steps),
                         (shape_args(cfg, grid_n), refresh)],
                  "b2": [(shape_args(cfg, n_rank), steps)]},
        "work": {"b1": b1, "b2": b2},
        "window_units": window.done_close - window.done_open,
        "window_s": window.t_close - window.t_open,
        "unit_flops": step_work.operations(*shape_args(cfg, n_rank)),
        "peaks": cell.peaks,
    }


# ---------------------------------------------------------------------------
# correctness
# ---------------------------------------------------------------------------


def lhs_bad(x, lb, ub, bins: int = 16) -> int:
    """Points by which a Latin-hypercube block breaks its strata: one point
    in each of its n slabs of every axis puts n / bins points in each of
    ``bins`` equal bins, give or take 3 (a slab across a bin's edge, and
    rounding there)."""
    n = x.shape[0]
    idx = ((x - lb) / (ub - lb) * bins).floor().long().clamp(0, bins - 1)
    bad = 0
    for i in range(x.shape[1]):
        counts = torch.bincount(idx[:, i], minlength=bins).double()
        bad += int(((counts - n / bins).abs() - 3).clamp(min=0).sum())
    return bad


def band_bad(x, lb, ub, grid: int, tol) -> int:
    """Boundary-band points off the band: the sampler draws each in a cell
    of the density grid whose lower corner lies on the box's outer 5%
    frame, so on some axis a point lies within the frame's width plus one
    cell of the low side, or within the frame's width of the high side."""
    frame = (ub - lb) / 20.0
    cell = (ub - lb) / (grid - 1)
    near = ((x <= lb + frame + cell + tol) | (x >= ub - frame - tol))
    return int((~near.any(dim=1)).sum())


def points_bad(data, cell) -> int:
    """The sampler's point set checked by itself: the counts, every point
    in the domain, the uniform block's Latin-hypercube strata, the band
    block on its frame, each BC group's points on its box with the group's
    value, and the BC points inside the collocation set where the sampler
    puts them.  The adaptive block is drawn from the program's own density
    and is checked only for its count and the domain."""
    cfg, tr = cell.config, cell.traffic
    groups = cfg["bc_groups"]
    x_col = data["x_col"].detach().double().cpu()
    n_bd = tr["n_bd"]
    bad = abs(x_col.shape[0] - points_per_step(cell))
    lb = torch.tensor(cfg["lb"], dtype=torch.float64)
    ub = torch.tensor(cfg["ub"], dtype=torch.float64)
    tol = 1e-6 * (ub - lb)
    bad += int(((x_col < lb - tol) | (x_col > ub + tol)).any(dim=1).sum())
    bad += lhs_bad(x_col[:tr["n_col"]], lb, ub)
    bad += band_bad(x_col[tr["n_col"]:tr["n_col"] + tr["n_band"]], lb, ub,
                    cfg["density_grid"], tol)
    for g, xb, ubd in zip(groups, data["x_bd"], data["u_bd"]):
        xb = xb.detach().double().cpu()
        lo = torch.tensor(g["lo"], dtype=torch.float64)
        hi = torch.tensor(g["hi"], dtype=torch.float64)
        bad += abs(xb.shape[0] - n_bd)
        bad += int(((xb < lo - tol) | (xb > hi + tol)).any(dim=1).sum())
        bad += int((ubd.detach().double().cpu() != g["value"]).sum())
    off = tr["n_col"] + tr["n_band"]
    block = x_col[off:off + len(groups) * n_bd]
    bds = torch.cat([xb.detach().double().cpu() for xb in data["x_bd"]])
    if block.shape == bds.shape:
        bad += int((block != bds).any(dim=1).sum())
    else:
        bad += 1
    return bad


def gathered(cap, ranks):
    """The point set of steps 0-2 and the observed tensors, on rank 0 the
    global point set of a mesh (every rank's shard, in rank order)."""
    data = cap.local[0][0]
    if ranks is None:
        return {"x_col": data["x_col"], "x_bd": list(data["x_bd"]),
                "u_bd": list(data["u_bd"])}
    return {"x_col": ranks.cat(data["x_col"]),
            "x_bd": [ranks.cat(x) for x in data["x_bd"]],
            "u_bd": [ranks.cat(u) for u in data["u_bd"]]}


def program_outcome(cap, cfg):
    """What the timed path produced: rows of steps 0-2, the first gradient
    as B3's first moment holds it after step 1, the parameters' change
    after step 3, and the parameters before step 1."""
    one_minus_b1 = torch.tensor(1.0) - torch.tensor(0.9)
    g0 = cap.m1.cpu() / one_minus_b1
    return {"rows": cap.rows(), "grad0": ref_common.split_flat(g0, cfg),
            "change": ref_common.split_flat((cap.p3 - cap.x0).cpu(), cfg),
            "x0": cap.x0.cpu()}


def reference_outcome(cell, seed, data, device, prec="fp32", steps=3):
    """The reference's own three Adam steps from its own initialisation,
    as :func:`program_outcome` reports them."""
    cfg = cell.config
    problem = cell.reference()
    layers0 = ref_common.init_layers(seed, cfg, device)
    x0 = torch.cat([x.reshape(-1) for x in ref_common.leaves(layers0)])
    with ref_common.no_tf32():
        r = ref_common.adam_steps(problem, layers0, data, cfg, steps, prec)
    change = [p - x for p, x in zip(r["params"], ref_common.leaves(layers0))]
    return {"rows": r["rows"], "grad0": r["grad0"], "change": change,
            "x0": x0.cpu()}


def readings(prog, ref, n_bad=0):
    keep = compare.moving(ref["grad0"])
    return {"init_gap": compare.max_abs(prog["x0"], ref["x0"]),
            "points_bad": float(n_bad),
            "loss_gap": compare.row_gap(prog["rows"], ref["rows"]),
            "grad_gap": compare.leaf_gap(prog["grad0"], ref["grad0"]),
            "change_gap": compare.leaf_gap(prog["change"], ref["change"],
                                           keep)}


def judge(cell, seed, cap, ranks):
    """Runs after the window (on rank 0 of a mesh, after the gather): the
    readings of this run."""
    data = gathered(cap, ranks)
    if ranks is not None and ranks.rank != 0:
        return None
    prog = program_outcome(cap, cell.config)
    device = data["x_col"].device
    ref = reference_outcome(cell, seed, data, device)
    return readings(prog, ref, points_bad(data, cell))


def controls(cell, seed, out, prec, fractions):
    """Readings of the control (the reference in ``prec`` put in the
    program's place) and of the faults planted in the reference: the
    point set cut to its first ``fraction`` (half of the batch left out;
    one rank's shard where the exchange between cards is left out)."""
    data = gathered(out["state"], None)
    device = data["x_col"].device
    ref = reference_outcome(cell, seed, data, device)
    res = {"control": readings(reference_outcome(cell, seed, data, device,
                                                 prec), ref)}
    for frac in fractions:
        part = {k: ([x[:int(x.shape[0] * frac)] for x in v]
                    if isinstance(v, list) else v[:int(v.shape[0] * frac)])
                for k, v in data.items()}
        res[f"fault_part_{frac:g}"] = readings(
            reference_outcome(cell, seed, part, device), ref)
    return res
