"""Driver of the Adam cells whose network is not a plain dense chain (a
PirateNet): the configuration's recipe through
``tpinn_torch.core.train.run_training``, its Adam phase measured as
drivers/adam.py measures it.

The traffic file is drivers/adam.py's: the point mix of a step, global
counts (``n_col``, ``n_band``, ``n_adaptive``, ``n_bd`` per BC group),
``adam_epochs``, ``log_every``, ``warm_steps`` and ``trace_steps`` (the
traced stretch ends at a replay, every ``10 * log_every`` steps, so it is
never shorter than that).  The window and the point-set check are
drivers/adam.py's own; the watch of the first steps is too, and also
keeps B3's first moment after step 2.  The readings are drivers/adam.py's
five with the first gradient compared where it is not exactly 0, and a
sixth, the second gradient on every leaf (:func:`readings`).  The
configuration's reference module (``reference/<config>.py``) gives the
initialisation from the seed, the parameters' flat order and the plain
model, so the judge compares the program's first three Adam steps with
the reference's three.  No kernel B1 or B2 runs (the generic jvp engine
takes the net), so the traced run's context counts no calls of theirs;
its operations a step are ``work/pirate.py``'s.  One card.
"""

from __future__ import annotations

import sys
import types

import torch

from benchmark.drivers import adam
from benchmark.harness import compare
from benchmark.reference import common as ref_common
from benchmark.work import pirate as pirate_work


def recipe(cell, seed: int):
    """drivers/adam.py's recipe, and the PirateNet's own numbers held to
    the configuration file too."""
    problem, spec = adam.recipe(cell, seed)
    cfg, st = cell.config, spec.stages[0]
    stated = {
        "pirate_blocks": st.pirate_blocks,
        "fourier_features": st.fourier_features,
        "fourier_scale": st.fourier_scale,
        "weight_fact": (list(st.weight_fact) if st.weight_fact is not None
                        else None),
        "causal_eps": spec.causal_eps, "causal_bins": spec.causal_bins,
        "causal_axis": spec.causal_axis,
    }
    for key, value in stated.items():
        if cfg[key] != value:
            raise ValueError(f"configuration {cfg['name']}: {key} is "
                             f"{cfg[key]!r}, the recipe runs {value!r}")
    return problem, spec


class Capture(adam.Capture):
    """drivers/adam.py's watch of the first steps, and B3's first moment
    after step 2 besides: with it the second gradient, the first in which
    the gates and the blocks take part (every alpha has left 0)."""

    def __init__(self):
        super().__init__()
        self.m2 = None

    def __enter__(self):
        from tpinn_torch.kernels import adam as adam_kernel

        super().__enter__()
        cap, watched = self, adam_kernel.FusedAdam

        class Second(watched):
            def step(self, g):
                out = watched.step(self, g)
                if self._seen == 2 and cap.m2 is None:
                    cap.m2 = self.m.detach().clone()
                return out

        adam_kernel.FusedAdam = Second
        return self

    def ready(self) -> bool:
        return super().ready() and self.m2 is not None


def run(cell, seed, seconds, do_trace, t_start, device, ranks=None):
    """Run the cell; returns its outcome as harness.cell reads it."""
    from tpinn_torch.core import train

    if ranks is not None:
        raise ValueError(f"{cell.name}: this driver runs on one card")
    problem, spec = recipe(cell, seed)
    window = adam.Window(t_start, seconds, cell.traffic, do_trace)
    with Capture() as cap:
        try:
            train.run_training(problem, spec, output_dir=None,
                               log_fn=window, device=device)
        except adam.WindowClosed:
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
    n_step = adam.points_per_step(cell)
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
        out["layer_ctx"] = layer_ctx(cell, window, n_step)
    out["judge"] = lambda: judge(cell, seed, cap)
    out["state"] = cap
    return out


def unit_flops(cell, n: int) -> int:
    cfg = cell.config
    return pirate_work.operations(n, cfg["width"], cfg["pirate_blocks"],
                                  cfg["n_features"], cfg["streams"])


def layer_ctx(cell, window, n):
    """What the per-layer readers take: the traced stretch's events and
    length, its steps, and the untraced window's steps and length; no
    kernel calls of B1 or B2."""
    return {
        "events": window.stretch.events, "seconds": window.stretch.seconds,
        "units": window.trace_to - window.trace_from,
        "calls": {}, "work": {},
        "window_units": window.done_close - window.done_open,
        "window_s": window.t_close - window.t_open,
        "unit_flops": unit_flops(cell, n),
        "peaks": cell.peaks,
    }


# ---------------------------------------------------------------------------
# correctness
# ---------------------------------------------------------------------------


def points_check(data, cell) -> int:
    """drivers/adam.py's ``points_bad`` on the point set, with each BC
    group's targets held to the reference's initial data (to 1e-6, float32
    rounding of a value of at most 1): a target off it counts as a bad
    point."""
    ref_mod = cell.reference()
    flags = [((u.detach().double() - ref_mod.initial(x.detach().double()))
              .abs() > 1e-6).double() for x, u in zip(data["x_bd"],
                                                     data["u_bd"])]
    cfg = dict(cell.config, bc_groups=[dict(g, value=0.0)
                                       for g in cell.config["bc_groups"]])
    view = types.SimpleNamespace(config=cfg, traffic=cell.traffic)
    return adam.points_bad(dict(data, u_bd=flags), view)


def program_outcome(cap, cell):
    """What the timed path produced (drivers/adam.py's program_outcome,
    the flat vectors cut by the reference's shapes), and the second
    gradient from B3's first moments, m2 = b1·m1 + (1 − b1)·g1, with the
    float32 constants the kernel uses."""
    split = cell.reference().split_flat
    b1 = torch.tensor(0.9)
    one_minus_b1 = torch.tensor(1.0) - b1
    m1 = cap.m1.cpu()
    g1 = ((cap.m2.cpu().double() - b1.double() * m1.double())
          / one_minus_b1.double())
    return {"rows": cap.rows(), "grad0": split(m1 / one_minus_b1, cell.config),
            "grad1": split(g1, cell.config),
            "change": split((cap.p3 - cap.x0).cpu(), cell.config),
            "x0": cap.x0.cpu()}


def reference_outcome(cell, seed, data, device, prec="fp32", steps=3):
    """The reference's own three Adam steps from its own initialisation,
    as :func:`program_outcome` reports them."""
    cfg = cell.config
    ref_mod = cell.reference()
    leaves0 = ref_mod.init(seed, cfg, device)
    x0 = torch.cat([x.reshape(-1) for x in leaves0])
    with ref_common.no_tf32():
        r = ref_mod.adam_steps(leaves0, data, cfg, steps, prec)
    change = [p - x for p, x in zip(r["params"], leaves0)]
    return {"rows": r["rows"], "grad0": r["grad0"], "grad1": r["grad1"],
            "change": change, "x0": x0.cpu()}


def readings(prog, ref, n_bad=0):
    """drivers/adam.py's readings, with two changes.  The first gradient
    is compared on the leaves where either side is not exactly 0: with
    every alpha at 0 the blocks and the gates take no part in the first
    step, so their first gradient is exactly 0 in the reference, and the
    median leaf norm that ``compare.leaf_gap`` scales by would be 0 (a
    leaf that is 0 on one side only stays and reads its whole norm as the
    gap; two exact zeros agree).  And ``grad1_gap`` compares the second
    gradient on every leaf, the gates' and the blocks' included: Adam's
    update does not see a leaf's gradient scaled, so the change after
    three steps alone would not see it either."""
    moves = [i for i, (p, r) in enumerate(zip(prog["grad0"], ref["grad0"],
                                             strict=True))
             if bool(p.any()) or bool(r.any())]
    return {"init_gap": compare.max_abs(prog["x0"], ref["x0"]),
            "points_bad": float(n_bad),
            "loss_gap": compare.row_gap(prog["rows"], ref["rows"]),
            "grad_gap": compare.leaf_gap([prog["grad0"][i] for i in moves],
                                         [ref["grad0"][i] for i in moves]),
            "grad1_gap": compare.leaf_gap(prog["grad1"], ref["grad1"]),
            "change_gap": compare.leaf_gap(prog["change"], ref["change"],
                                           compare.moving(ref["grad0"]))}


def judge(cell, seed, cap):
    """Runs after the window: the readings of this run."""
    data = adam.gathered(cap, None)
    prog = program_outcome(cap, cell)
    ref = reference_outcome(cell, seed, data, data["x_col"].device)
    return readings(prog, ref, points_check(data, cell))


def controls(cell, seed, out, prec, fractions):
    """Readings of the control (the reference in ``prec`` put in the
    program's place) and of the faults planted in the reference: the
    point set cut to its first ``fraction``."""
    data = adam.gathered(out["state"], None)
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
