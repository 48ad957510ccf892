"""Model serving: evaluate trained PINN checkpoints over HTTP.

Port of ``tpinn.app.serve`` for forward scalar checkpoints (the format
``run_training`` writes, by either package): the spec-chain and legacy
single-net layouts, optionally wrapped in the hard-BC ansatz.  On a CUDA
device the residual's u-partials come from kernel B1
(tpinn_torch.kernels.mlp_taylor); ``/predict`` is the plain forward
(feature map, then a ``torch.matmul`` chain).

Run:  python -m tpinn_torch.app.serve --checkpoint out/params_stage_1.npz \
          [--problem annulus_laplace] [--port 8060] [--device cuda]

API:
    POST /predict   {"points": [[r, t], ...]}      -> {"u": [...]}
    POST /residual  {"points": [[r, t], ...]}      -> {"f": [...]}
    POST /uncertainty {"points": ...}  -> {"std": [...]}   (ensembles)
    GET  /health                                   -> {"ok": true, ...}

Queries are padded to batch tiers (powers of two, at least 64), as the
JAX server does to bound its compiled shapes; here the tiers also bound
the shapes kernel B1 and cuBLAS see.

A checkpoint whose meta carries a spectral ``deflation`` correction (the
trainer's final stage, polish.defect_correction) is served with the
correction subtracted, u(z) − T(z); ``deflate="auto" | "full"`` computes
one at load for a checkpoint trained without it.  The corrected residual
differentiates through T(z) with the generic jvp engine.

A time-marching record (``march.json``, core.march.run_time_marching,
given as the file or the directory that holds it) is served as the
piecewise-in-time composite of its window checkpoints, one sub-server per
window.  The composite hides the window nets from
``taylor.fast_partials``, so its ``/residual`` takes the generic jvp
engine.

A coupled-system checkpoint (core.system.run_system) describes itself:
its meta carries the equations, fields, coordinates, box and feature
kinds, so it is served with no preset (``problem_name=None``).  Any
unknown coefficients it identified enter the residual at their recovered
values.  ``/predict`` answers one row of m fields per point and
``/residual`` one row of E equation columns, through the generic jvp
engine (kernel B1 is scalar).

A scalar inverse checkpoint (core.inverse.run_inverse) describes itself
the same way, with its equation and the recovered coefficients in the
meta: served with no preset, ``/residual`` evaluated at the recovered
values (through kernel B1 on the card), ``/health`` reporting them.

An ensemble record (``ensemble.json``, core.ensemble.
run_ensemble_training, the file or the directory that holds it;
``--problem`` required) is served as the weighted sum of one sub-server
per member, minus the record's ``deflation`` term when it has one; its
``/residual`` takes the generic jvp engine on the composite, and
``/uncertainty`` answers the weighted member spread
``sqrt(Σ w_i (u_i − ū)²)``.

An overlapping-patch checkpoint (core.patch.run_patched, ``patch`` in its
meta) is served through the partition-of-unity predictor rebuilt from the
meta, its parameters stacked on a leading patch axis; its derivatives
take the generic jvp engine.
"""

from __future__ import annotations

import argparse
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from tpinn_torch import problems
from tpinn_torch.core import net, pde, polish
from tpinn_torch.utils import checkpoint as ckpt


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to serve on the host")
    return dev


def _described_problem(meta: dict) -> SimpleNamespace:
    """The problem record of a self-describing checkpoint (run_system's or
    run_inverse's meta: coordinates, box and equations)."""
    if "coords" not in meta or "lb" not in meta:
        raise ValueError(
            "--problem is required: this checkpoint's meta does not "
            "describe its own domain/equation")
    sysm = meta.get("system")
    eq = (meta.get("equation")
          or ("; ".join(sysm["equations"]) if sysm else ""))
    if not eq:
        raise ValueError(
            "--problem is required: this (forward) checkpoint's meta has "
            "no equation record")
    coords = tuple(meta["coords"])
    return SimpleNamespace(
        name=meta.get("problem", "checkpoint"), coords=coords,
        dim=len(coords), equation=eq,
        feature_kinds=tuple(meta.get("feature_kinds") or ()),
        lb=tuple(meta["lb"]), ub=tuple(meta["ub"]), source=None,
        bc_groups=())


class PINNServer:
    def __init__(self, checkpoint: str, problem_name: Optional[str] = None,
                 depth: Optional[int] = None, width: Optional[int] = None,
                 deflate: str = "off", *, device):
        self.device = _resolve_device(device)
        self._spread = None

        cpath = Path(checkpoint)
        if cpath.is_dir() and (cpath / "ensemble.json").exists():
            cpath = cpath / "ensemble.json"
        if cpath.is_dir() and (cpath / "march.json").exists():
            cpath = cpath / "march.json"
        if cpath.name == "march.json":
            self._load_march(cpath, problem_name)
            return
        if cpath.name == "ensemble.json":
            self._load_ensemble(cpath, problem_name)
            return

        with np.load(checkpoint) as raw:
            meta = (json.loads(bytes(raw["__meta__"]).decode())
                    if "__meta__" in raw else {})
            w_shapes = [raw[k].shape for k in sorted(raw.files)
                        if k.endswith("/w")]
        sysm = meta.get("system")
        coefm = meta.get("coef") or {}
        problem = (problems.get_problem(problem_name)
                   if problem_name is not None else _described_problem(meta))
        self.problem = problem
        coords = tuple(meta.get("coords", problem.coords))
        if sysm:
            # one residual column per equation, coefficients at their
            # recovered values
            self.compiled = pde.compile_system(
                sysm["equations"], coords, sysm["fields"],
                params=tuple(coefm))
        elif meta.get("inverse") and meta.get("equation"):
            # identified model: the equation's unknown coefficients at
            # their recovered values
            self.compiled = pde.compile_pde(meta["equation"], coords,
                                            params=tuple(coefm))
        else:
            self.compiled = pde.compile_pde(problem.equation, problem.coords)
        self._coef = {k: torch.tensor(float(v), device=self.device)
                      for k, v in coefm.items()} or None
        if (sysm or coefm) and deflate != "off":
            raise ValueError(
                "--deflate targets scalar forward checkpoints; system/"
                "identified checkpoints have no spectral correction path")

        dev = self.device
        fm = net.feature_map_for(
            tuple(meta.get("feature_kinds") or problem.feature_kinds),
            pad_to=meta.get("pad_features", 0))
        lb = torch.tensor(meta.get("lb", problem.lb), dtype=torch.float32,
                          device=dev)
        ub = torch.tensor(meta.get("ub", problem.ub), dtype=torch.float32,
                          device=dev)

        def template_for(spec):
            # structure (and dtype/device) for load_pytree; values unused
            return net.init_params(torch.Generator().manual_seed(0), spec,
                                   fm, dev)

        if meta.get("patch"):
            # overlapping patches: the partition-of-unity predictor, its
            # parameters stacked on a leading patch axis
            from tpinn_torch.core.patch import (PatchSpec, init_patch_params,
                                                make_patch_predictor)

            pspec = PatchSpec(n=tuple(meta["patch"]["n"]),
                              overlap=float(meta["patch"]["overlap"]))
            mspec = net.spec_from_dict(meta["chain"][0])
            pad = meta.get("pad_features", 0)
            predictor = make_patch_predictor(
                mspec, pspec, meta.get("lb", problem.lb),
                meta.get("ub", problem.ub), pad_features=pad, device=dev)
            template = init_patch_params(torch.Generator().manual_seed(0),
                                         mspec, pspec, pad_features=pad,
                                         device=dev)
        elif "chain" in meta:
            # the full multilevel chain as trained: every stage's
            # act_first/scl/epsil from its saved spec, params nested
            # {"stage", "prev"}
            specs = [net.spec_from_dict(d) for d in meta["chain"]]
            predictor = net.make_predictor(specs[0], fm, lb, ub)
            template = template_for(specs[0])
            for s in specs[1:]:
                predictor = net.compose_stages(predictor, s, fm, lb, ub)
                template = net.compose_params(template_for(s), template)
        else:
            # legacy checkpoint without a spec chain: one plain MLP
            # inferred from the layer shapes
            spec = net.MLPSpec(
                depth=depth or (len(w_shapes) - 1),
                width=width or w_shapes[0][1],
                scl=float(meta.get("scl", 1.0)),
                epsil=float(meta.get("epsil", 1.0)),
            )
            template = template_for(spec)
            predictor = net.make_predictor(spec, fm, lb, ub)
        if meta.get("hard_bc"):
            lift_fn, bubble_fn = (
                pde.compile_coord_expr(e, coords) for e in meta["hard_bc"]
            )
            predictor = net.wrap_hard_bc(predictor, lift_fn, bubble_fn)
        self.params, _ = ckpt.load_pytree(checkpoint, template)
        defl = meta.get("deflation")
        if not defl and deflate != "off":
            # retroactive correction for a checkpoint trained WITHOUT one
            # (float64, once at load; the guards make it a no-op where it
            # cannot help).  The dispatcher the trainer uses.
            src = (pde.compile_coord_expr(problem.source, problem.coords)
                   if problem.source else None)
            defl = polish.defect_correction(
                predictor, self.params, self.compiled,
                problem.lb, problem.ub,
                tuple(meta["hard_bc"]) if meta.get("hard_bc") else None,
                mode=deflate, source_fn=src,
                coords=coords, bc_groups=problem.bc_groups)
            print(f"[serve] deflate={deflate}: "
                  + (f"{defl['kind']} correction, {len(defl['modes'])} "
                     f"modes" if defl else "no applicable correction"),
                  file=sys.stderr)
        self.deflation = defl or None
        if defl:
            # subtract the correction term (the trained run's meta or the
            # retroactive solve above)
            term = polish.deflation_term(defl)
            raw = predictor
            predictor = lambda p, z: raw(p, z) - term(z)
        self.predictor = predictor

    def _load_march(self, record: Path, problem_name: Optional[str]):
        """The composite of a time-marching record's window checkpoints
        (their paths relative to the record's directory)."""
        from tpinn_torch.core.march import make_march_predictor

        if problem_name is None:
            raise ValueError("march serving needs --problem")
        problem = problems.get_problem(problem_name)
        self.problem = problem
        self.compiled = pde.compile_pde(problem.equation, problem.coords)
        self.deflation = None
        self._coef = None
        rec = json.loads(record.read_text())
        subs = [PINNServer(str(record.parent / w), problem_name,
                           device=self.device) for w in rec["windows"]]
        preds = tuple(s.predictor for s in subs)
        edges = tuple(rec["edges"])
        ai = int(rec["axis_index"])

        def predictor(params_list, z):
            fns = [lambda zz, f=f, p=p: f(p, zz)
                   for f, p in zip(preds, params_list)]
            return make_march_predictor(fns, edges, ai)(z)

        self.params = [s.params for s in subs]
        self.predictor = predictor

    def _load_ensemble(self, record: Path, problem_name: Optional[str]):
        """The convex combination of an ensemble record's member
        checkpoints (their paths relative to the record's directory),
        minus the record's correction; ``_spread`` for /uncertainty."""
        from tpinn_torch.core.ensemble import _mean_predictor

        if problem_name is None:
            raise ValueError("ensemble serving needs --problem")
        problem = problems.get_problem(problem_name)
        self.problem = problem
        self.compiled = pde.compile_pde(problem.equation, problem.coords)
        self._coef = None
        rec = json.loads(record.read_text())
        subs = [PINNServer(str(record.parent / m), problem_name,
                           device=self.device) for m in rec["members"]]
        preds = tuple(s.predictor for s in subs)
        wts = tuple(float(v) for v in rec["weights"])
        predictor = _mean_predictor(wts, preds)
        self.deflation = rec.get("deflation") or None
        if self.deflation:
            term = polish.deflation_term(self.deflation)
            mean = predictor
            predictor = lambda p, z: mean(p, z) - term(z)

        def spread(params_list, z):
            # weighted std across members: the epistemic band the
            # ensemble disagrees by (convex weights, Σw = 1)
            vals = torch.stack([f(p, z) for f, p in zip(preds, params_list)])
            w = torch.tensor(wts, dtype=vals.dtype,
                             device=vals.device)[:, None, None]
            mean_u = torch.sum(w * vals, dim=0)
            return torch.sqrt(torch.sum(w * (vals - mean_u) ** 2, dim=0))

        self.params = [s.params for s in subs]
        self.predictor = predictor
        self._spread = spread

    def _predict(self, z: torch.Tensor) -> torch.Tensor:
        return self.predictor(self.params, z)

    def _residual(self, z: torch.Tensor) -> torch.Tensor:
        if isinstance(self.compiled, pde.CompiledSystem):
            return self.compiled.residual(
                lambda zz: self.predictor(self.params, zz), z, self._coef)
        return self.compiled.residual_fast(self.predictor, self.params, z,
                                           self._coef)

    @staticmethod
    def _tier(n: int) -> int:
        t = 64
        while t < n:
            t *= 2
        return t

    def _eval(self, fn, points):
        pts = np.asarray(points, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] != self.problem.dim:
            raise ValueError(
                f"points must be [n, {self.problem.dim}] for "
                f"{self.problem.name}"
            )
        n = pts.shape[0]
        tier = self._tier(n)
        padded = np.zeros((tier, pts.shape[1]), np.float32)
        padded[:n] = pts
        padded[n:] = pts[-1] if n else 0.5
        z = torch.from_numpy(padded).to(self.device)
        out = fn(z).detach().cpu().numpy()[:n]
        if out.shape[1] > 1:
            # coupled systems: one row per point (fields for /predict,
            # equation columns for /residual)
            return out.tolist()
        return out[:, 0].tolist()

    def predict(self, points):
        return self._eval(self._predict, points)

    def residual(self, points):
        return self._eval(self._residual, points)

    def uncertainty(self, points):
        """Per-point epistemic spread (weighted member std) — ensemble
        records only."""
        if self._spread is None:
            raise ValueError("uncertainty needs an ensemble checkpoint "
                             "(serve an ensemble.json directory)")
        return self._eval(lambda z: self._spread(self.params, z), points)


def make_handler(server: PINNServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                info = {"ok": True, "problem": server.problem.name,
                        "equation": server.problem.equation,
                        "device": str(server.device)}
                if server._coef is not None:
                    info["coef"] = {k: float(v)
                                    for k, v in server._coef.items()}
                self._json(info)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length))
                points = body["points"]
                if self.path == "/predict":
                    self._json({"u": server.predict(points)})
                elif self.path == "/residual":
                    self._json({"f": server.residual(points)})
                elif self.path == "/uncertainty":
                    self._json({"std": server.uncertainty(points)})
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # request boundary: report, keep serving
                self._json({"error": str(e)}, 400)

    return Handler


def main():  # pragma: no cover
    p = argparse.ArgumentParser(description="serve a trained tpinn model "
                                            "with the PyTorch port")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--problem", default=None,
                   help="problem preset (optional for a system or inverse "
                        "checkpoint, whose meta describes it; required for "
                        "march and ensemble records)")
    p.add_argument("--port", type=int, default=8060)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails without a card")
    p.add_argument("--deflate", default="off",
                   choices=("off", "auto", "full"),
                   help="compute a spectral defect correction at load for a "
                        "checkpoint trained without one")
    args = p.parse_args()
    # full fp32 products: TF32 would spoil the second-derivative streams
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    server = PINNServer(args.checkpoint, args.problem, deflate=args.deflate,
                        device=args.device)
    httpd = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(server))
    print(f"serving {server.problem.name} on :{args.port} "
          f"({server.device})")
    httpd.serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
