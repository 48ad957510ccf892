#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpinn_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: require CUDA, print the card (nvidia-smi name and power
   limit), turn TF32 off everywhere.
2. Build: compile kernels B1, B2 and B3 (tpinn_torch/kernels/csrc/
   taylor2_fwd.cu, taylor2_bwd.cu, adam.cu) with nvcc for sm_90a, one
   nvcc process each, all started together; print the build times and
   the ptxas register/spill report.
3. Kernel vs plain:
   a. B1 against its plain PyTorch version and against the generic
      torch.func.jvp engine, per stream, on the 6x80 annulus net (N =
      262,144, a ragged 1,077 and the 202,500 points of the recipe's
      L-BFGS grid), a sin-first net with pad_to=3, and a 3-coordinate net.
   b. B2 through the autograd Function (B1 forward, B2 backward) against
      B2's plain version on the same cotangent and against autograd
      through the plain Taylor-2 recurrence, per leaf, on the 6x80
      annulus net at the recipe's batch (46,000), a ragged 1,077 and the
      recipe's L-BFGS grid (450^2 = 202,500), the pad_to=3 net and the
      3-coordinate net; the same under the hard-BC product rule at those
      three sizes; points that require a gradient must be refused.
   c. B3 against its plain version over 1,000 steps, with a learning-rate
      change half-way, on n = 32,801 (the 6x80 net on 3 features) and an
      odd n.
4. Serve (the first slice's path): two annulus checkpoints written from
   a seeded initialisation in the format run_training writes — the 6x80
   hard-BC net and a 2-stage hard-BC chain — each served by PINNServer on
   the card behind ThreadingHTTPServer; /health, /predict and /residual
   at 1, 1,000 and 65,536 points, checked against the direct predictor,
   the plain-version residual and the exact hard-BC boundary values.  B1's
   launch count is reset before this phase and must grow with every
   /residual request.
5. Train (the second slice's path): first, at step 0, the kernel-engine
   gradient of the full loss against the generic engine's.  Then
   run_training on the hard-BC annulus at the recipe's batch: stage 1
   6x80 tanh, stage 2 6x50 sin composed, about 300 Adam steps each
   through B1 + B2 + B3, then L-BFGS; launch counts reset before and read
   after, loss drops, rel-L2, the 11 artifacts and the checkpoints
   checked; the stage-2 checkpoint is served and /predict checked
   against the trainer's predictor.
5b. Recipe (this slice's main path): get_recipe("annulus_laplace") as
   written — 6x80, the 46,000-point batch, lbfgs_grid=450,
   lbfgs_rounds=3, lsq_polish="auto", deflation="full",
   adam_precision="default" — with only the budgets cut, through
   run_training on the card: Adam through B1 + B2 + B3 (launch counts
   reset before, read after), three L-BFGS rounds on the 202,500-point
   grid each followed by the exact float64 last-layer solve (objective
   post <= pre, applied), the float64 evaluation, the Galerkin defect
   correction (kind, residual drop, modes, rel-L2 before and after), the
   checkpoint whose meta carries it, and the served /predict of that
   checkpoint against the trainer's corrected predictor and against the
   same checkpoint served without its correction; its served /residual
   against the residual of the trainer's corrected predictor, with the
   engine that answered it (B1's launch count over the request).
6. Timing (medians of synchronised runs): B1 alone and inside the
   residual at the serving shapes; the Adam step with the kernel engine
   against the plain engine at the recipe's shape and at bench.py's; B2
   and B3 alone against their plain versions; B3 and the one PyTorch call
   that computes the same update (torch._fused_adam_) alone and in a
   queue of 100 launches behind a long kernel, which reads the device
   time per launch apart from the host call.

The line before the last is a JSON object describing the kernels (each
with its launches on this slice's main path, its time, its plain
version's, the card's bound for the same work and, where one PyTorch
call computes the same function, that call's time); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SMOKE_DIR = ROOT / "build" / "smoke"
SEED = 0
IDX5 = [(), (0,), (1,), (0, 0), (1, 1)]           # the annulus residual's plan
IDX6 = IDX5 + [(0, 1)]
REL_TOL = 1e-4      # per stream: max |kernel - ref| / max |ref|
RES_RTOL, RES_ATOL = 1e-3, 1e-4   # residual tolerance (1/r^2 scales u_tt)
# B2, per leaf: max |kernel - ref| <= GRAD_REL * max |ref| + GRAD_ABS (fp32
# sums over all points in another order)
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
# step-0 gradient of the full loss, kernel vs generic engine (the tolerance
# of tests/test_kernels.py for the Pallas custom_vjp)
STEP0_RTOL, STEP0_ATOL = 2e-3, 2e-5
ADAM_RTOL = 1e-6    # B3 vs plain, per vector: max |diff| / max |ref|
TIMED_RUNS = 15
KERNELS = ("taylor2_fwd", "taylor2_bwd", "adam")
# the annulus_laplace recipe's batch (tpinn/problems/recipes.py:92-102)
RECIPE_COUNTS = dict(n_col=30000, n_band=5000, n_adaptive=10000, n_bd=500)
RECIPE_N = 30000 + 5000 + 10000 + 2 * 500
# bench.py's shape: 6x60 soft-BC annulus, 5,200 points (bench.py:44-46)
BENCH_COUNTS = dict(n_col=3000, n_band=1000, n_adaptive=1000, n_bd=100)
ADAM_N = 32_801     # parameters of the 6x80 net on 3 features
ADAM_STEPS = 1000
TRAIN_ADAM = 300    # Adam steps per stage in the training phase
TRAIN_LBFGS = 30    # lbfgs_epochs per stage (max_iters = epochs / 3)
RECIPE_ADAM = 300   # phase 5b: adam_epochs of the recipe, cut from 8,000
# phase 5b: lbfgs_epochs, cut from 8,000 (100 iterations per round).  270
# also passed every check, but its correction's resid_drop of 0.783 lay
# close to the 0.8 above which polish.galerkin_defect keeps no correction
RECIPE_LBFGS = 900
RECIPE_GRID_N = 450 * 450   # points of the recipe's lbfgs_grid
QUEUED = 100        # back-to-back launches timed behind a long kernel
# the card's published peaks (H100 SXM data sheet): fp32 outside the tensor
# cores, HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def box_points(gen, n, lo, hi, device):
    import torch

    lo = torch.tensor(lo, dtype=torch.float32)
    hi = torch.tensor(hi, dtype=torch.float32)
    u = torch.rand((n, len(lo)), generator=gen, dtype=torch.float32)
    return (lo + u * (hi - lo)).to(device)


def plain_partials(pred, params, z, indices):
    """u-partials of a served predictor with kernel B1 replaced by its
    plain version (taylor2_mlp) — same hard-BC and stage structure."""
    from tpinn_torch.core import net, taylor

    if hasattr(pred, "tpinn_hard"):
        lift, bubble = pred.tpinn_hard
        raw = pred.tpinn_raw
        return net.hard_bc_partials(
            lambda p, zz, need: plain_partials(raw, p, zz, need),
            lift, bubble)(params, z, indices)
    if pred.tpinn_kind == "sum":
        a = plain_partials(pred.tpinn_stage, params["stage"], z, indices)
        b = plain_partials(pred.tpinn_prev, params["prev"], z, indices)
        return {k: a[k] + b[k] for k in a}
    lb, ub = pred.tpinn_bounds
    return taylor.taylor2_mlp(params, z, pred.tpinn_spec,
                              pred.tpinn_feature_map, lb, ub, indices)


def sync_ms(fn) -> float:
    """Host time of one call that ends in torch.cuda.synchronize()."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def kernel_cases():
    """(name, spec, fm, lb, ub, streams, N) for phase 3."""
    from tpinn_torch.core import net, taylor

    two_pi = 2.0 * math.pi
    annulus = net.MLPSpec(depth=6, width=80)
    annulus_fm = net.feature_map_for(("minmax", "periodic"))
    return [
        ("annulus 6x80 tanh", annulus, annulus_fm, (0.1, 0.0), (1.0, two_pi),
         IDX5, 262_144),
        ("annulus 6x80 tanh ragged", annulus, annulus_fm, (0.1, 0.0),
         (1.0, two_pi), IDX5, 1_077),
        ("annulus 6x80 tanh, the recipe's L-BFGS grid", annulus, annulus_fm,
         (0.1, 0.0), (1.0, two_pi), IDX5, RECIPE_GRID_N),
        ("sin first, minmax x2, pad_to=3",
         net.MLPSpec(depth=6, width=64, act_first="sin", scl=3.0, epsil=0.5),
         net.feature_map_for(("minmax", "minmax"), pad_to=3),
         (0.0, 0.0), (1.0, 1.0), IDX6, 65_536),
        ("3 coordinates, full order-2 plan",
         net.MLPSpec(depth=4, width=48, scl=1.3, epsil=0.7),
         net.feature_map_for(("minmax", "periodic", "identity")),
         (0.0, 0.0, -1.0), (1.0, two_pi, 1.0),
         taylor.plan_streams([(i, j) for i in range(3) for j in range(i, 3)]),
         32_768),
    ]


def phase_kernel_vs_plain(dev, gen):
    import torch

    from tpinn_torch.core import deriv, net
    from tpinn_torch.kernels import mlp_taylor

    worst_abs = 0.0
    for name, spec, fm, lo, hi, streams, n in kernel_cases():
        params = net.init_params(gen, spec, fm, dev)
        lb = torch.tensor(lo, dtype=torch.float32, device=dev)
        ub = torch.tensor(hi, dtype=torch.float32, device=dev)
        z = box_points(gen, n, lo, hi, dev)
        got = mlp_taylor.taylor2_streams(params, z, spec, fm, lo, hi, streams)
        plain = mlp_taylor.taylor2_streams_reference(params, z, spec, fm, lo,
                                                     hi, streams)
        pred = net.make_predictor(spec, fm, lb, ub)
        gparts = deriv.partials(lambda zz: pred(params, zz), z, streams)
        generic = torch.cat([gparts[st] for st in streams], dim=1)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        print(f"  {name}: N={n} S={len(streams)}")
        for k, st in enumerate(streams):
            scale_p = plain[:, k].abs().max().item()
            scale_g = generic[:, k].abs().max().item()
            err_p = (got[:, k] - plain[:, k]).abs().max().item()
            err_g = (got[:, k] - generic[:, k]).abs().max().item()
            worst_abs = max(worst_abs, err_p)
            rel_p, rel_g = err_p / scale_p, err_g / scale_g
            print(f"    stream {str(st):7s} max|ref| {scale_p:.4e}  "
                  f"rel err vs plain {rel_p:.3e}  vs jvp {rel_g:.3e}")
            check(rel_p <= REL_TOL, f"{name} stream {st} vs plain: {rel_p}")
            check(rel_g <= REL_TOL, f"{name} stream {st} vs jvp: {rel_g}")
    return worst_abs


def leaves_of(params):
    return [t for layer in params["layers"] for t in (layer["w"], layer["b"])]


def check_grads(name, got, ref, rtol=None, atol=None) -> float:
    """Per leaf: max |got - ref| <= GRAD_REL * max |ref| + GRAD_ABS, or,
    with rtol/atol, |got - ref| <= atol + rtol * |ref| elementwise.
    Returns the largest absolute difference."""
    worst = 0.0
    for k, (a, b) in enumerate(zip(got, ref)):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        if rtol is None:
            ok = err <= GRAD_REL * scale + GRAD_ABS
        else:
            ok = bool(((a - b).abs() <= atol + rtol * b.abs()).all())
        check(ok, f"{name}, leaf {k}: max |diff| {err:.3e}, max |ref| "
                  f"{scale:.3e}")
        worst = max(worst, err)
    return worst


def phase_b2(dev, gen):
    """B1 + B2 through the autograd Function against B2's plain version
    and against autograd through the plain Taylor-2 recurrence."""
    import torch

    from tpinn_torch.core import net, taylor
    from tpinn_torch.kernels import mlp_taylor, taylor_vjp

    # per case of kernel_cases()
    sizes = (RECIPE_N, 1_077, RECIPE_GRID_N, 16_384, 8_192)
    worst_abs = 0.0
    for n, (name, spec, fm, lo, hi, streams, _) in zip(sizes, kernel_cases()):
        params = net.init_params(gen, spec, fm, dev)
        leaves = leaves_of(params)
        for t in leaves:
            t.requires_grad_(True)
        z = box_points(gen, n, lo, hi, dev)
        ct = torch.randn((n, len(streams)), generator=gen).to(dev)
        before = (mlp_taylor.LAUNCHES, taylor_vjp.LAUNCHES)
        runs = []
        for _ in range(2):
            out = taylor_vjp.kernel_streams(params, z, spec, fm, lo, hi,
                                            streams)
            runs.append(torch.autograd.grad((out * ct).sum(), leaves))
        torch.cuda.synchronize()
        grew = (mlp_taylor.LAUNCHES - before[0],
                taylor_vjp.LAUNCHES - before[1])
        check(grew == (2, 2), f"{name}: B1/B2 launches {grew}, expected (2, 2)")
        got = runs[0]
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"{name}: B2 gradient not bitwise repeatable")
        layers = [{"w": t["w"].detach(), "b": t["b"].detach()}
                  for t in params["layers"]]
        plain = leaves_of({"layers": taylor_vjp.taylor2_backward_reference(
            layers, z, ct, spec, fm, lo, hi, streams)})
        lb = torch.tensor(lo, dtype=torch.float32, device=dev)
        ub = torch.tensor(hi, dtype=torch.float32, device=dev)
        parts = taylor.taylor2_mlp(params, z, spec, fm, lb, ub, streams)
        cols = torch.cat([parts[st] for st in streams], dim=1)
        auto = torch.autograd.grad((cols * ct).sum(), leaves)
        err_p = check_grads(f"{name}: B2 vs plain", got, plain)
        err_a = check_grads(f"{name}: B2 vs autograd", got, auto)
        worst_abs = max(worst_abs, err_p)
        print(f"  {name}: N={n} S={len(streams)} max |grad| "
              f"{max(g.abs().max().item() for g in plain):.4e}, max abs err "
              f"vs plain {err_p:.3e}, vs autograd {err_a:.3e}, repeatable")
        try:
            taylor_vjp.kernel_streams(params, z.clone().requires_grad_(True),
                                      spec, fm, lo, hi, streams)
        except ValueError:
            pass
        else:
            raise RuntimeError(f"{name}: points requiring a gradient were "
                               f"not refused")

    # the hard-BC product rule: the residual-MSE gradient of the kernel
    # engine against the plain engine and the generic jvp engine
    from tpinn_torch import problems

    problem = problems.with_hard_bc(problems.annulus_laplace())
    for n in (RECIPE_N, 1_077, RECIPE_GRID_N):
        pred, compiled, params, data, lw = loss_setup(
            problem, annulus_spec(), dev, col_only=n)
        got, ref = loss_grads(pred, compiled, params, data, lw, "kernel")
        plain, _ = loss_grads(plain_engine(pred), compiled, params, data, lw,
                              "fused", ref)
        generic, _ = loss_grads(pred, compiled, params, data, lw, "generic",
                                ref)
        err_p = check_grads(f"hard-BC N={n}: kernel vs plain", got, plain)
        err_g = check_grads(f"hard-BC N={n}: kernel vs generic", got, generic,
                            STEP0_RTOL, STEP0_ATOL)
        worst_abs = max(worst_abs, err_p)
        print(f"  hard-BC residual MSE, 6x80, N={n}: max abs err vs plain "
              f"{err_p:.3e}, vs generic {err_g:.3e}")
    return worst_abs


def phase_b3(dev):
    """B3 against its plain version over ADAM_STEPS steps, lr halved at
    the midpoint."""
    import torch

    from tpinn_torch.kernels import adam

    worst_abs = 0.0
    for n in (ADAM_N, 1_001):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        p = torch.randn(n, generator=gen, device=dev)
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        lr = torch.full((1,), 1e-3, device=dev)
        pr, mr, vr, lr_r = p.clone(), m.clone(), v.clone(), lr.clone()
        before = adam.LAUNCHES
        for t in range(1, ADAM_STEPS + 1):
            if t == ADAM_STEPS // 2 + 1:
                lr.mul_(0.5)
                lr_r.mul_(0.5)
            g = torch.randn(n, generator=gen, device=dev)
            adam.adam_update_flat(g, p, m, v, lr, t)
            adam.adam_update_reference(g, pr, mr, vr, lr_r, t)
        torch.cuda.synchronize()
        check(adam.LAUNCHES - before == ADAM_STEPS,
              f"B3 launched {adam.LAUNCHES - before} times in {ADAM_STEPS} "
              f"steps")
        errs = []
        for what, a, b in (("p", p, pr), ("m", m, mr), ("v", v, vr)):
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            check(err <= ADAM_RTOL * scale,
                  f"B3 n={n} {what}: max |diff| {err:.3e}, max |ref| "
                  f"{scale:.3e}")
            errs.append(f"{what} {err:.2e}")
            worst_abs = max(worst_abs, err)
        print(f"  B3 n={n}: {ADAM_STEPS} steps, lr halved at step "
              f"{ADAM_STEPS // 2 + 1}; max abs err vs plain "
              + ", ".join(errs))
    return worst_abs


def annulus_spec(width=80):
    from tpinn_torch.core import net

    return net.MLPSpec(depth=6, width=width)


def loss_setup(problem, mspec, dev, counts=None, col_only=None):
    """Predictor, compiled PDE, seeded params, a point set and lw for the
    Adam-step checks and timings: the sampler's draw at ``counts``, or
    ``col_only`` uniform collocation points and no BC terms."""
    import torch

    from tpinn_torch.core import net, pde, sample

    fm = net.feature_map_for(problem.feature_kinds)
    lb = torch.tensor(problem.lb, dtype=torch.float32, device=dev)
    ub = torch.tensor(problem.ub, dtype=torch.float32, device=dev)
    pred = net.make_predictor(mspec, fm, lb, ub)
    if problem.hard_bc:
        pred = net.wrap_hard_bc(pred, *(pde.compile_coord_expr(
            e, problem.coords) for e in problem.hard_bc))
    compiled = pde.compile_pde(problem.equation, problem.coords)
    params = net.init_params(torch.Generator().manual_seed(SEED), mspec, fm,
                             dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if col_only is not None:
        data = {"x_col": box_points(torch.Generator().manual_seed(SEED),
                                    col_only, problem.lb, problem.ub, dev),
                "x_bd": [], "u_bd": []}
    else:
        sample_fn, grids = sample.sampler_for(
            sample.SamplerConfig(**counts), problem.bc_groups, problem.lb,
            problem.ub, torch.float32, dev)
        data = sample_fn(gen, torch.ones_like(grids[0]))
    lw = torch.tensor([0.05, 0.0], device=dev)
    return pred, compiled, params, data, lw


def plain_engine(pred):
    """``pred`` whose structured partials come from B1's plain version
    under autograd: make_loss(engine='fused') on it launches no kernel."""
    def f(params, z):
        return pred(params, z)

    f.tpinn_partials = lambda p, z, idx: plain_partials(pred, p, z, idx)
    return f


def loss_grads(pred, compiled, params, data, lw, engine, ref=None):
    """Per-leaf gradient of the normalised loss (ref = the loss at these
    params unless given) with one residual engine; returns (grads, ref)."""
    import torch

    from tpinn_torch.core import loss as loss_mod

    loss_fn = loss_mod.make_loss(pred, compiled, engine=engine)
    leaves = [t.detach().requires_grad_(True) for t in leaves_of(params)]
    p = {"layers": [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                    for i in range(len(leaves) // 2)]}
    if ref is None:
        with torch.no_grad():
            ref = loss_fn(p, data, lw, torch.ones((), device=lw.device))[1][0]
    loss_n, _ = loss_fn(p, data, lw, ref)
    return torch.autograd.grad(loss_n, leaves), ref


def write_checkpoints(gen):
    """The 6x80 hard-BC annulus net and a 2-stage hard-BC chain, in the
    format tpinn's run_training writes (tpinn/core/train.py)."""
    from tpinn_torch import problems
    from tpinn_torch.core import net
    from tpinn_torch.utils import checkpoint

    problem = problems.with_hard_bc(problems.annulus_laplace())
    fm = net.feature_map_for(problem.feature_kinds)
    s1 = net.MLPSpec(depth=6, width=80)
    s2 = net.MLPSpec(depth=6, width=50, act_first="sin", scl=7.0, epsil=0.03)
    p1 = net.init_params(gen, s1, fm, "cpu")
    p2 = net.init_params(gen, s2, fm, "cpu")

    def meta(stage, spec, chain):
        return {"stage": stage, "scl": spec.scl, "epsil": spec.epsil,
                "problem": problem.name,
                "chain": [net.spec_to_dict(s) for s in chain],
                "feature_kinds": list(problem.feature_kinds),
                "lb": list(problem.lb), "ub": list(problem.ub),
                "hard_bc": list(problem.hard_bc),
                "coords": list(problem.coords), "pad_features": 0,
                "deflation": None}

    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    single = SMOKE_DIR / "annulus_6x80_hardbc.npz"
    chain = SMOKE_DIR / "annulus_chain_hardbc.npz"
    checkpoint.save_pytree(single, p1, meta(1, s1, [s1]))
    checkpoint.save_pytree(chain, net.compose_params(p2, p1),
                           meta(2, s2, [s1, s2]))
    return [("6x80 hard-BC", single), ("2-stage hard-BC chain", chain)]


def post(base, route, points):
    body = json.dumps({"points": points}).encode()
    req = urllib.request.Request(base + route, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def http_server(srv):
    """Serve ``srv`` over HTTP on a free localhost port for the block;
    yields the base URL and stops the server thread after it."""
    from tpinn_torch.app.serve import make_handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    check(not th.is_alive(), "server thread did not stop")


def phase_serve(dev, ckpts):
    import numpy as np
    import torch

    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.kernels import mlp_taylor

    rng = np.random.default_rng(SEED)
    servers = []
    for name, path in ckpts:
        srv = PINNServer(str(path), "annulus_laplace", device=dev)
        with http_server(srv) as base:
            with urllib.request.urlopen(base + "/health", timeout=60) as r:
                h = json.loads(r.read())
            check(h.get("ok") is True and h["problem"] == "annulus_laplace",
                  f"{name}: /health {h}")
            for n in (1, 1_000, 65_536):
                pts = np.stack([rng.uniform(0.1, 1.0, n),
                                rng.uniform(0.0, 2 * np.pi, n)],
                               axis=1).astype(np.float32)
                t0 = time.perf_counter()
                u = np.asarray(post(base, "/predict", pts.tolist())["u"])
                t_pred = time.perf_counter() - t0
                before = mlp_taylor.LAUNCHES
                t0 = time.perf_counter()
                f = np.asarray(post(base, "/residual", pts.tolist())["f"])
                t_res = time.perf_counter() - t0
                grew = mlp_taylor.LAUNCHES - before
                check(grew > 0, f"{name}: /residual at {n} launched no kernel")
                check(u.shape == (n,) and f.shape == (n,),
                      f"{name}: shapes {u.shape} {f.shape}")
                check(bool(np.isfinite(u).all() and np.isfinite(f).all()),
                      f"{name}: non-finite answer at {n} points")
                z = torch.from_numpy(pts).to(dev)
                direct = srv.predictor(srv.params, z)[:, 0].cpu().numpy()
                plain = srv.compiled.evaluate(
                    z, plain_partials(srv.predictor, srv.params, z,
                                      srv.compiled.indices))[:, 0].cpu().numpy()
                err_u = float(np.abs(u - direct).max())
                err_f = float(np.abs(f - plain).max())
                check(np.allclose(u, direct, rtol=1e-5, atol=1e-6),
                      f"{name}: /predict vs direct, max err {err_u}")
                check(np.allclose(f, plain, rtol=RES_RTOL, atol=RES_ATOL),
                      f"{name}: /residual vs plain, max err {err_f}")
                print(f"  {name}: n={n:6d} /predict {t_pred * 1e3:8.1f} ms "
                      f"(max err vs direct {err_u:.2e}), /residual "
                      f"{t_res * 1e3:8.1f} ms (max err vs plain {err_f:.2e}, "
                      f"max |f| {np.abs(plain).max():.3e}), launches +{grew}")
            theta = np.linspace(0.0, 2 * np.pi, 17)
            inner = np.asarray(post(base, "/predict",
                                    [[0.1, t] for t in theta])["u"])
            outer = np.asarray(post(base, "/predict",
                                    [[1.0, t] for t in theta])["u"])
            e_in = float(np.abs(inner - 1.0).max())
            e_out = float(np.abs(outer).max())
            check(e_in <= 1e-6 and e_out <= 1e-6,
                  f"{name}: boundary values |u(0.1)-1| {e_in}, |u(1)| {e_out}")
            print(f"  {name}: |u(0.1,t) - 1| <= {e_in:.1e}, "
                  f"|u(1,t)| <= {e_out:.1e}")
        servers.append((name, srv))
    return servers


def phase_train(dev):
    """run_training on the hard-BC annulus at the recipe's batch, with the
    step-0 gradient check before it and the trained checkpoint served
    after it.  Returns the kernels' launch counts of the run."""
    import numpy as np
    import torch

    from tpinn_torch import problems
    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.core.train import StageSpec, TrainSpec, run_training
    from tpinn_torch.kernels import adam, mlp_taylor, taylor_vjp
    from tpinn_torch.utils import artifacts

    problem = problems.with_hard_bc(problems.annulus_laplace())
    pred, compiled, params, data, lw = loss_setup(
        problem, annulus_spec(), dev, counts=RECIPE_COUNTS)
    check(data["x_col"].shape[0] == RECIPE_N, "recipe batch size")
    got, ref = loss_grads(pred, compiled, params, data, lw, "kernel")
    generic, _ = loss_grads(pred, compiled, params, data, lw, "generic", ref)
    err = check_grads("step-0 gradient, kernel vs generic engine", got,
                      generic, STEP0_RTOL, STEP0_ATOL)
    print(f"  step-0 gradient of the full loss (N={RECIPE_N}): kernel vs "
          f"generic engine max abs err {err:.3e} (rtol {STEP0_RTOL}, atol "
          f"{STEP0_ATOL})")

    spec = TrainSpec(
        **RECIPE_COUNTS, lw=(0.05, 0.0),
        stages=(StageSpec(depth=6, width=80, scl=1.0, epsil=1.0,
                          adam_epochs=TRAIN_ADAM, lbfgs_epochs=TRAIN_LBFGS),
                StageSpec(depth=6, width=50, act_first="sin",
                          adam_epochs=TRAIN_ADAM, lbfgs_epochs=TRAIN_LBFGS)),
        resample_every=100, density_every=100, plateau_every=200,
        tail_max=50, engine="generic", adam_engine="kernel")
    out = SMOKE_DIR / "train"
    shutil.rmtree(out, ignore_errors=True)
    lines = []
    mlp_taylor.LAUNCHES = taylor_vjp.LAUNCHES = adam.LAUNCHES = 0
    t0 = time.perf_counter()
    res = run_training(problem, spec, output_dir=str(out),
                       log_fn=lines.append, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"taylor2_fwd": mlp_taylor.LAUNCHES,
                "taylor2_bwd": taylor_vjp.LAUNCHES, "adam": adam.LAUNCHES}
    for line in lines:
        print(f"  | {line}")
    n_adam = [int(m.group(1)) for m in
              (re.search(r"Adam done \((\d+) steps", ln) for ln in lines) if m]
    check(len(n_adam) == 2, f"Adam phases logged: {n_adam}")
    print(f"  run_training: {seconds:.1f} s, Adam steps {n_adam}, launches "
          f"{launches}")
    for k, count in launches.items():
        check(count >= sum(n_adam),
              f"{k} launched {count} times for {sum(n_adam)} Adam steps")

    h1, h2 = res.stages[0].history, res.stages[1].history
    drop = h1[0, 0] / h1[n_adam[0] - 1, 0]
    print(f"  stage 1 loss {h1[0, 0]:.4e} -> {h1[n_adam[0] - 1, 0]:.4e} over "
          f"Adam ({drop:.1f}x), {h1[-1, 0]:.4e} after L-BFGS; stage 2 "
          f"{h2[0, 0]:.4e} -> {h2[-1, 0]:.4e}; rel-L2 {res.rel_l2:.4e}")
    check(drop >= 10.0, f"stage-1 Adam loss drop {drop:.2f}x < 10x")
    check(h2[-1, 0] < h2[0, 0], "stage-2 loss did not fall")
    check(res.rel_l2 is not None and math.isfinite(res.rel_l2), "rel-L2")

    # the artifact contract (keys and shapes of tests/test_train_e2e.py)
    nt = spec.testing_size
    for name in artifacts.ARTIFACT_NAMES + ["params_stage_1.npz",
                                            "params_stage_2.npz"]:
        check((out / name).exists(), f"missing {name}")
    expect = {"solution_residual_1.npz": {"r", "t_vec", "U", "F"},
              "solution_residual_2.npz": {"r", "t", "U", "F"},
              "error_1.npz": {"r", "t", "Error"},
              "boundary_loss_1.npz": {"loss_xy_l", "loss_xy_r"},
              "frequency_spectrum.npz": {"freq_x", "freq_t", "log_mag"},
              "collocation_point_1.npz": {"U", "X_col", "limit"}}
    for name, keys in expect.items():
        with np.load(out / name) as d:
            check(set(d.keys()) == keys, f"{name} keys {sorted(d.keys())}")
    with np.load(out / "solution_residual_1.npz") as d:
        check(d["U"].shape == (nt[1], nt[0]), "U shape")
    with np.load(out / "error_1.npz") as d:
        check(d["Error"].shape == (nt[1], nt[0]), "Error shape")
    with np.load(out / "frequency_spectrum.npz") as d:
        check(d["log_mag"].shape == (nt[1], nt[0]), "log_mag shape")
    with np.load(out / "collocation_point_1.npz") as d:
        check(d["X_col"].shape == (RECIPE_N, 2), "X_col shape")
    with np.load(out / "loss_1.npz") as a, np.load(out / "loss_2.npz") as b:
        check(a["loss"].shape[1] == 3 + 2 + 1, "loss_info width")
        check(b["loss"].shape[0] > a["loss"].shape[0], "stage-2 loss rows")
    print(f"  {len(artifacts.ARTIFACT_NAMES)} artifacts and 2 checkpoints "
          f"written, keys and shapes checked")

    # the trained chain, served
    srv = PINNServer(str(out / "params_stage_2.npz"), "annulus_laplace",
                     device=dev)
    rng = np.random.default_rng(SEED)
    pts = np.stack([rng.uniform(0.1, 1.0, 1_000),
                    rng.uniform(0.0, 2 * np.pi, 1_000)], axis=1).astype(
                        np.float32)
    with http_server(srv) as base:
        u = np.asarray(post(base, "/predict", pts.tolist())["u"])
    with torch.no_grad():
        want = res.predict(torch.from_numpy(pts).to(dev))[:, 0].cpu().numpy()
    err_u = float(np.abs(u - want).max())
    check(np.allclose(u, want, rtol=1e-5, atol=1e-6),
          f"served /predict vs trainer's predictor, max err {err_u}")
    print(f"  params_stage_2.npz served: /predict at 1,000 points equals the "
          f"trainer's predictor (max err {err_u:.2e})")
    return launches


def phase_recipe(dev, card, adam_epochs=RECIPE_ADAM,
                 lbfgs_epochs=RECIPE_LBFGS, tail_max=50):
    """The annulus_laplace recipe with its budgets cut, end to end: Adam
    through the kernels, three L-BFGS rounds each followed by the exact
    last-layer solve, the float64 evaluation, the Galerkin defect
    correction, the checkpoint with the correction in its meta, served.
    Returns the kernels' launch counts of the run."""
    import dataclasses

    import numpy as np
    import torch

    from tpinn_torch import problems
    from tpinn_torch.app.serve import PINNServer
    from tpinn_torch.core import polish
    from tpinn_torch.core.train import run_training
    from tpinn_torch.kernels import adam, mlp_taylor, taylor_vjp
    from tpinn_torch.utils import checkpoint

    problem, spec = problems.get_recipe("annulus_laplace")
    stage = spec.stages[0]
    check((stage.depth, stage.width, stage.lbfgs_grid, stage.lbfgs_rounds)
          == (6, 80, 450, 3) and spec.lsq_polish == "auto"
          and spec.deflation == "full" and spec.adam_precision == "default"
          and spec.n_col + spec.n_band + spec.n_adaptive + 2 * spec.n_bd
          == RECIPE_N, "the annulus_laplace recipe is not the flagship's")
    # only the budgets are cut: Adam and L-BFGS epochs, and the Adam tail
    # (up to tail_max further steps while the loss still improves)
    spec = dataclasses.replace(
        spec, tail_max=tail_max,
        stages=(dataclasses.replace(stage, adam_epochs=adam_epochs,
                                    lbfgs_epochs=lbfgs_epochs),))
    out = SMOKE_DIR / "recipe"
    shutil.rmtree(out, ignore_errors=True)
    lines = []
    tf32_before = torch.backends.cuda.matmul.allow_tf32
    mlp_taylor.LAUNCHES = taylor_vjp.LAUNCHES = adam.LAUNCHES = 0
    t0 = time.perf_counter()
    res = run_training(problem, spec, output_dir=str(out),
                       log_fn=lines.append, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"taylor2_fwd": mlp_taylor.LAUNCHES,
                "taylor2_bwd": taylor_vjp.LAUNCHES, "adam": adam.LAUNCHES}
    for line in lines:
        print(f"  | {line}")
    check(torch.backends.cuda.matmul.allow_tf32 == tf32_before,
          "adam_precision leaked out of the Adam phase")
    n_adam = [int(m.group(1)) for m in
              (re.search(r"Adam done \((\d+) steps", ln) for ln in lines) if m]
    check(len(n_adam) == 1 and n_adam[0] >= adam_epochs,
          f"Adam phase logged: {n_adam}")
    print(f"  run_training(get_recipe('annulus_laplace'), budgets "
          f"{adam_epochs} Adam steps + tail and {lbfgs_epochs} L-BFGS "
          f"epochs): {seconds:.1f} s, Adam steps {n_adam[0]}, launches "
          f"{launches}")
    for k, count in launches.items():
        check(count >= n_adam[0],
              f"{k} launched {count} times for {n_adam[0]} Adam steps")

    # the exact last-layer solve after every L-BFGS round
    polished = [re.search(r"lsq polish objective (\S+) -> (\S+)( \(not "
                          r"applied\))? in (\S+) s", ln) for ln in lines]
    polished = [m for m in polished if m]
    check(len(polished) == stage.lbfgs_rounds,
          f"{len(polished)} lsq polish lines for {stage.lbfgs_rounds} rounds")
    for k, m in enumerate(polished):
        obj0, obj1, secs = (float(m.group(k)) for k in (1, 2, 4))
        check(m.group(3) is None and obj1 <= obj0,
              f"round {k + 1}: lsq polish {obj0} -> {obj1} {m.group(3) or ''}")
        print(f"  round {k + 1}: last-layer solve on the 202,500-point grid, "
              f"objective {obj0:.4e} -> {obj1:.4e}, {secs:.2f} s wall on "
              f"{card}")

    # the correction: kind, what it absorbed, accuracy before and after
    _, meta = checkpoint.load_pytree(out / "params_stage_1.npz",
                                     res.stages[0].params)
    defl = meta.get("deflation")
    check(bool(defl), "the checkpoint's meta carries no deflation")
    check(defl["kind"] == "galerkin" and not defl.get("soft"),
          f"correction kind {defl['kind']} (r faces vanish, θ is periodic: "
          f"expected the hard-BC galerkin family)")
    wall = [float(m.group(1)) for m in
            (re.search(r"galerkin correction in (\S+) s", ln) for ln in lines)
            if m]
    check(len(wall) == 1, "no correction wall time logged")
    before, after = defl["rel_l2_before"], res.rel_l2
    print(f"  correction: kind {defl['kind']}, {len(defl['modes'])} modes, "
          f"resid_drop {defl['resid_drop']:.4e}, {wall[0]:.2f} s wall on "
          f"{card}")
    print(f"  rel-L2 before the correction {before:.4e}, after {after:.4e} "
          f"({before / after:.2f}x)")
    check(math.isfinite(after) and after <= before,
          f"rel-L2 {before} -> {after}: the correction made it worse")

    # the checkpoint, served with and without its correction
    bare = out / "uncorrected.npz"
    checkpoint.save_pytree(bare, res.stages[0].params,
                           {**meta, "deflation": None})
    rng = np.random.default_rng(SEED)
    pts = np.stack([rng.uniform(0.1, 1.0, 1_000),
                    rng.uniform(0.0, 2 * np.pi, 1_000)], axis=1).astype(
                        np.float32)
    answers = []
    for path in (out / "params_stage_1.npz", bare):
        srv = PINNServer(str(path), "annulus_laplace", device=dev)
        with http_server(srv) as base:
            answers.append(np.asarray(post(base, "/predict",
                                           pts.tolist())["u"]))
            if path != bare:
                b1_before = mlp_taylor.LAUNCHES
                f_served = np.asarray(post(base, "/residual",
                                           pts.tolist())["f"])
                b1_grew = mlp_taylor.LAUNCHES - b1_before
                compiled = srv.compiled
    z = torch.from_numpy(pts).to(dev)
    with torch.no_grad():
        want = res.predict(z)[:, 0].cpu().numpy()
        term = polish.deflation_term(defl)(z)[:, 0].cpu().numpy()
    err_u = float(np.abs(answers[0] - want).max())
    err_t = float(np.abs((answers[1] - answers[0]) - term).max())
    check(err_u <= 1e-6, f"served /predict vs the trainer's corrected "
                         f"predictor: max err {err_u}")
    check(float(np.abs(term).max()) > 0.0 and err_t <= 1e-6,
          f"uncorrected - corrected /predict vs the term: max err {err_t}, "
          f"max |term| {np.abs(term).max()}")
    print(f"  params_stage_1.npz served: /predict at 1,000 points equals the "
          f"trainer's corrected predictor (max abs difference {err_u:.2e}) "
          f"and differs from the uncorrected net by the term (max |term| "
          f"{np.abs(term).max():.3e}, max abs difference {err_t:.2e})")

    # the served residual of the corrected checkpoint.  The correction term
    # hides the net's structure from the dispatcher, so the request is
    # answered by the generic jvp engine and launches B1 no time (the count
    # is printed); it is held against the trainer's corrected predictor.
    f_want = compiled.residual_fast(lambda _, zz: res.predict(zz), None,
                                    z)[:, 0].detach().cpu().numpy()
    err_f = float(np.abs(f_served - f_want).max())
    check(f_served.shape == (1_000,) and bool(np.isfinite(f_served).all()),
          "served /residual of the corrected checkpoint: shape or values")
    check(np.allclose(f_served, f_want, rtol=RES_RTOL, atol=RES_ATOL),
          f"served /residual vs the trainer's corrected predictor: max err "
          f"{err_f}")
    print(f"  params_stage_1.npz served: /residual at 1,000 points equals the "
          f"residual of the trainer's corrected predictor (max abs difference "
          f"{err_f:.2e}, max |f| {np.abs(f_want).max():.3e}); engine: "
          f"{'kernel B1' if b1_grew else 'generic jvp'}, taylor2_fwd launches "
          f"+{b1_grew}")
    return launches


def queued_ms(fn, blocker) -> float:
    """Device time per launch of ``fn`` in a queue of QUEUED launches: the
    host enqueues them while ``blocker`` (a long kernel) still runs, so the
    two events bracket back-to-back device work, not the host calls.
    Median of five queues."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        blocker()
        a.record()
        for _ in range(QUEUED):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / QUEUED)
    return statistics.median(times)


def event_ms(fn) -> float:
    """Median device time of ``fn`` between two CUDA events."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def alternating_ms(fns) -> dict:
    """Median synchronised host time of each of two callables, alternated
    run by run (a, b, b, a, ...) after three warm-up calls each."""
    names = list(fns)
    for _ in range(3):
        for k in names:
            fns[k]()
    ts = {k: [] for k in names}
    for r in range(TIMED_RUNS):
        for k in (names if r % 2 == 0 else names[::-1]):
            ts[k].append(sync_ms(fns[k]))
    return {k: statistics.median(v) for k, v in ts.items()}


def adam_step(loss_fn, params, data, lw, ref, update):
    """One Adam step as the flat-layout phase takes it: loss, the flat
    gradient in one autograd call, then ``update`` in place."""
    import torch

    from tpinn_torch.core import optim

    flat, unravel = optim.ravel_tree(params)
    m, v = torch.zeros_like(flat), torch.zeros_like(flat)
    lr = torch.full((1,), 1e-3, device=flat.device)
    t = [0]

    def step():
        t[0] += 1
        flat.requires_grad_(True)
        loss_n, _ = loss_fn(unravel(flat), data, lw, ref)
        (g,) = torch.autograd.grad(loss_n, flat)
        with torch.no_grad():
            update(g, flat.detach(), m, v, lr, t[0])

    return step


def phase_timing_train(dev):
    """The Adam step, kernel engine (B1 + B2 + B3) against the plain
    engine (plain B1, autograd, plain Adam), and B2 and B3 alone."""
    import torch

    from tpinn_torch import problems
    from tpinn_torch.core import loss as loss_mod
    from tpinn_torch.core import net
    from tpinn_torch.kernels import adam, taylor_vjp

    out = {}
    shapes = (("recipe", problems.with_hard_bc(problems.annulus_laplace()),
               annulus_spec(80), RECIPE_COUNTS),
              ("bench", problems.annulus_laplace(), annulus_spec(60),
               BENCH_COUNTS))
    for label, problem, mspec, counts in shapes:
        pred, compiled, params, data, lw = loss_setup(problem, mspec, dev,
                                                      counts=counts)
        n = data["x_col"].shape[0]
        with torch.no_grad():
            ref = loss_mod.make_loss(pred, compiled)(
                params, data, lw, torch.ones((), device=dev))[1][0]
        steps = {
            "kernel": adam_step(loss_mod.make_loss(pred, compiled,
                                                   engine="kernel"),
                                params, data, lw, ref, adam.adam_update_flat),
            "plain": adam_step(loss_mod.make_loss(plain_engine(pred), compiled,
                                                  engine="fused"),
                               params, data, lw, ref,
                               adam.adam_update_reference)}
        ms = alternating_ms(steps)
        out[f"step_{label}"] = (ms["kernel"], ms["plain"])
        print(f"  Adam step, {label} shape ({mspec.depth}x{mspec.width}"
              f"{' hard-BC' if problem.hard_bc else ' soft-BC'}, N={n}): "
              f"kernel engine {ms['kernel']:.3f} ms, plain engine "
              f"{ms['plain']:.3f} ms (synchronised host clock, median of "
              f"{TIMED_RUNS}, alternating)")

    # B2 alone at the recipe's batch: the raw 6x80 net under the hard-BC
    # residual's stream set
    spec, fm = annulus_spec(), net.feature_map_for(("minmax", "periodic"))
    lo, hi = (0.1, 0.0), (1.0, 2 * math.pi)
    gen = torch.Generator().manual_seed(SEED)
    layers = net.init_params(gen, spec, fm, dev)["layers"]
    z = box_points(gen, RECIPE_N, lo, hi, dev)
    ct = torch.randn((RECIPE_N, len(IDX5)), generator=gen).to(dev)
    args = (layers, z, ct, spec, fm, lo, hi, IDX5)
    k_ms = event_ms(lambda: taylor_vjp.taylor2_backward(*args))
    p_ms = event_ms(lambda: taylor_vjp.taylor2_backward_reference(*args))
    n_flop = 3 * 2 * RECIPE_N * len(IDX5) * (5 * 80 * 80)
    out["taylor2_bwd"] = (k_ms, p_ms)
    print(f"  taylor2_bwd alone N={RECIPE_N} S=5 6x80: kernel {k_ms:.3f} ms "
          f"({n_flop / k_ms / 1e9:.2f} TFLOP/s fp32 on the hidden layers), "
          f"plain {p_ms:.3f} ms (CUDA events, median of {TIMED_RUNS})")

    # B3 alone on the 6x80 net's parameter count
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vecs = [torch.randn(ADAM_N, generator=gen, device=dev) for _ in range(2)]
    g, p = vecs
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    lr = torch.full((1,), 1e-3, device=dev)
    k_ms = event_ms(lambda: adam.adam_update_flat(g, p, m, v, lr, 10))
    p_ms = event_ms(lambda: adam.adam_update_reference(g, p, m, v, lr, 10))
    out["adam"] = (k_ms, p_ms)
    print(f"  adam alone n={ADAM_N}: kernel {k_ms * 1e3:.1f} us, plain "
          f"{p_ms * 1e3:.1f} us (CUDA events, median of {TIMED_RUNS})")

    # the one PyTorch call that computes the same update, on the same
    # vectors and hyperparameters; timed here, used nowhere in the port
    step10 = [torch.full((), 10.0, device=dev)]

    def library(pp=p, mm=m, vv=v):
        torch._fused_adam_([pp], [g], [mm], [vv], [], step10, lr=1e-3,
                           beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
                           amsgrad=False, maximize=False)

    state = [t.clone() for t in (p, m, v)]
    want = [t.clone() for t in state]
    library(*state)
    adam.adam_update_reference(g, *want, lr, 10)
    err = max((a - b).abs().max().item() for a, b in zip(state, want))
    check(err <= 1e-5 * max(t.abs().max().item() for t in want),
          f"torch._fused_adam_ vs B3's plain version: max abs err {err}")
    l_ms = event_ms(library)
    big = torch.randn((8192, 8192), device=dev)
    blocker = lambda: [torch.matmul(big, big) for _ in range(4)]
    kq_ms = queued_ms(lambda: adam.adam_update_flat(g, p, m, v, lr, 10),
                      blocker)
    lq_ms = queued_ms(library, blocker)
    out["adam_library"] = (l_ms, kq_ms, lq_ms)
    print(f"  adam alone n={ADAM_N}: torch._fused_adam_ {l_ms * 1e3:.1f} us "
          f"(CUDA events around one call, median of {TIMED_RUNS}; agrees "
          f"with the plain version to {err:.1e}); device time per launch in "
          f"a queue of {QUEUED} behind a long kernel: kernel "
          f"{kq_ms * 1e3:.2f} us, torch._fused_adam_ {lq_ms * 1e3:.2f} us")
    return out


def phase_timing(dev, gen, servers):
    import torch

    from tpinn_torch.core import net
    from tpinn_torch.kernels import mlp_taylor

    out = {}
    name, srv = servers[0]
    compiled = srv.compiled
    for n in (65_536, 262_144):
        z = box_points(gen, n, (0.1, 0.0), (1.0, 2 * math.pi), dev)
        kern = lambda: compiled.residual_fast(srv.predictor, srv.params, z)
        plain = lambda: compiled.evaluate(
            z, plain_partials(srv.predictor, srv.params, z, compiled.indices))
        for _ in range(3):
            kern()
            plain()
        ts = {"kernel": [], "plain": []}
        for r in range(TIMED_RUNS):  # alternate: plain, kernel, kernel, plain
            order = ("plain", "kernel") if r % 2 == 0 else ("kernel", "plain")
            for which in order:
                ts[which].append(sync_ms(kern if which == "kernel" else plain))
        k_ms, p_ms = statistics.median(ts["kernel"]), statistics.median(ts["plain"])
        out[f"residual_{n}"] = (k_ms, p_ms)
        print(f"  residual ({name}) N={n}: kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms (median of {TIMED_RUNS} synchronised runs each)")

    # the kernel alone against its plain version, at the served shape
    spec = net.MLPSpec(depth=6, width=80)
    fm = net.feature_map_for(("minmax", "periodic"))
    lo, hi = (0.1, 0.0), (1.0, 2 * math.pi)
    params = net.init_params(gen, spec, fm, dev)
    z = box_points(gen, 262_144, lo, hi, dev)
    args = (params, z, spec, fm, lo, hi, IDX5)
    events = {}
    for which, fn in (("kernel", mlp_taylor.taylor2_streams),
                      ("plain", mlp_taylor.taylor2_streams_reference)):
        for _ in range(3):
            fn(*args)
        times = []
        for _ in range(TIMED_RUNS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        events[which] = statistics.median(times)
    n_flop = 2 * 262_144 * len(IDX5) * (3 * 80 + 5 * 80 * 80 + 80)
    print(f"  taylor2_fwd alone N=262144 S=5 6x80: kernel {events['kernel']:.3f}"
          f" ms ({n_flop / events['kernel'] / 1e9:.2f} TFLOP/s fp32), plain "
          f"{events['plain']:.3f} ms (CUDA events, median of {TIMED_RUNS})")
    out["kernel_alone"] = (events["kernel"], events["plain"])
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpinn_torch.kernels import _build, mlp_taylor

    phase("1. device")
    card = card_line()
    print(f"  card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    phase("2. build")
    _build.load_all(KERNELS)
    for name in KERNELS:
        info = _build.BUILD_INFO[name]
        print(f"  built {Path(info['path']).name} in {info['seconds']:.2f} s "
              f"(cached: {info['cached']})")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas: " + line.strip())

    gen = torch.Generator().manual_seed(SEED)
    phase("3a. B1 vs plain")
    err_fwd = phase_kernel_vs_plain(dev, gen)
    phase("3b. B2 vs plain")
    err_bwd = phase_b2(dev, gen)
    phase("3c. B3 vs plain")
    err_adam = phase_b3(dev)

    phase("4. serve (the first slice's path)")
    ckpts = write_checkpoints(gen)
    mlp_taylor.LAUNCHES = 0
    servers = phase_serve(dev, ckpts)
    serve_launches = mlp_taylor.LAUNCHES
    check(serve_launches > 0, "serving launched kernel B1 no time")
    print(f"  taylor2_fwd launches during serving: {serve_launches}")

    phase("5. train (the second slice's path)")
    train_launches = phase_train(dev)

    phase("5b. recipe (this slice's main path)")
    launches = phase_recipe(dev, card)

    phase("6. timing")
    times = phase_timing(dev, gen, servers)
    times.update(phase_timing_train(dev))
    for n in (65_536, 262_144):
        k_ms, p_ms = times[f"residual_{n}"]
        print(f"  residual N={n}: kernel {k_ms:.3f} ms vs plain {p_ms:.3f} ms "
              f"on {card}")
    for label in ("recipe", "bench"):
        k_ms, p_ms = times[f"step_{label}"]
        print(f"  Adam step ({label}): kernel engine {k_ms:.3f} ms vs plain "
              f"{p_ms:.3f} ms on {card}")

    print(f"  card: {card}")
    # the least time the card could take for each kernel's timed call: the
    # larger of its bytes (inputs read once, outputs written once) over the
    # memory rate and its operations over the fp32 FMA peak.  Per point and
    # stream a 6x80 net on 3 features costs 2*(3*80 + 5*80*80 + 80) FLOP
    # forward; the backward recomputes it and takes two products per layer.
    per_point = 2 * len(IDX5) * (3 * 80 + 5 * 80 * 80 + 80)
    work = {  # name: (bytes, operations) of the call timed in phase 6
        "taylor2_fwd": (4 * (262_144 * (2 + len(IDX5)) + ADAM_N),
                        262_144 * per_point),
        "taylor2_bwd": (4 * (RECIPE_N * (2 + len(IDX5)) + 2 * ADAM_N),
                        3 * RECIPE_N * per_point),
        "adam": (4 * 7 * ADAM_N, 16 * ADAM_N)}
    l_ms, kq_ms, lq_ms = times["adam_library"]
    rows = (("taylor2_fwd", "taylor2_fwd", "tpinn/kernels/mlp_taylor.py:155",
             err_fwd, times["kernel_alone"], None, {}),
            ("taylor2_bwd", "taylor2_bwd", "tpinn/kernels/taylor_vjp.py:203",
             err_bwd, times["taylor2_bwd"], None, {}),
            ("adam_update", "adam", "tpinn/kernels/adam.py:46", err_adam,
             times["adam"], l_ms,
             {"queued_ms": kq_ms, "library_queued_ms": lq_ms}))
    kernels = []
    for name, src, where, err, (k_ms, p_ms), lib_ms, extra in rows:
        n_bytes, n_ops = work[src]
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpinn_torch/kernels/csrc/{src}.cu", "replaces": where,
            "launches": launches[src], "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "launches_by_path": {"serve": serve_launches if src ==
                                 "taylor2_fwd" else 0,
                                 "train": train_launches[src],
                                 "recipe": launches[src]}, **extra})
        print(f"  {name}: {k_ms:.4f} ms, bound {kernels[-1]['bound_ms']:.5f} "
              f"ms by {kernels[-1]['bound_by']} "
              f"({100 * kernels[-1]['bound_ms'] / k_ms:.1f}% of the time), "
              f"launches on the recipe path {launches[src]}, on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
