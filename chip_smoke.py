#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpinn_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: require CUDA, print the card (nvidia-smi name and power
   limit), turn TF32 off everywhere.
2. Build: compile kernel B1 (tpinn_torch/kernels/csrc/taylor2_fwd.cu)
   with nvcc for sm_90a and print the build time and ptxas report.
3. Kernel vs plain: kernel B1 against its plain PyTorch version and
   against the generic torch.func.jvp engine, per stream, on the 6x80
   annulus net (N = 262,144 and a ragged 1,077), a sin-first net with
   pad_to=3, and a 3-coordinate net.
4. Serve (the main path): two annulus checkpoints written from a seeded
   initialisation in the format run_training writes — the 6x80 hard-BC
   net and a 2-stage hard-BC chain — each served by PINNServer on the
   card behind ThreadingHTTPServer; /health, /predict and /residual at 1,
   1,000 and 65,536 points, checked against the direct predictor, the
   plain-version residual and the exact hard-BC boundary values.  The
   kernel's launch count is reset before this phase and must grow with
   every /residual request.
5. Timing: kernel vs plain version, alone and inside the residual, at the
   serving shapes (medians of synchronised runs).

The line before the last is a JSON object describing the kernels; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
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
TIMED_RUNS = 15


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


def phase_serve(dev, ckpts):
    import numpy as np
    import torch

    from tpinn_torch.app.serve import PINNServer, make_handler
    from tpinn_torch.kernels import mlp_taylor

    rng = np.random.default_rng(SEED)
    servers = []
    for name, path in ckpts:
        srv = PINNServer(str(path), "annulus_laplace", device=dev)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
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
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=60)
        check(not th.is_alive(), f"{name}: server thread did not stop")
        servers.append((name, srv))
    return servers


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
    _build.load("taylor2_fwd")
    info = _build.BUILD_INFO["taylor2_fwd"]
    print(f"  built {Path(info['path']).name} in {info['seconds']:.2f} s "
          f"(cached: {info['cached']})")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())

    gen = torch.Generator().manual_seed(SEED)
    phase("3. kernel vs plain")
    worst_abs = phase_kernel_vs_plain(dev, gen)

    phase("4. serve (main path)")
    ckpts = write_checkpoints(gen)
    mlp_taylor.LAUNCHES = 0
    servers = phase_serve(dev, ckpts)
    launches = mlp_taylor.LAUNCHES
    check(launches > 0, "the main path launched kernel B1 no time")
    print(f"  taylor2_fwd launches during serving: {launches}")

    phase("5. timing")
    times = phase_timing(dev, gen, servers)
    for n in (65_536, 262_144):
        k_ms, p_ms = times[f"residual_{n}"]
        print(f"  residual N={n}: kernel {k_ms:.3f} ms vs plain {p_ms:.3f} ms "
              f"on {card}")

    k_ms, p_ms = times["kernel_alone"]
    print(f"  card: {card}")
    print(json.dumps({"kernels": [{
        "name": "taylor2_fwd", "route": "cuda",
        "source": "tpinn_torch/kernels/csrc/taylor2_fwd.cu",
        "replaces": "tpinn/kernels/mlp_taylor.py:155",
        "launches": launches, "max_abs_err": worst_abs,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
