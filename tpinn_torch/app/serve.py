"""Model serving: evaluate trained PINN checkpoints over HTTP.

Port of ``tpinn.app.serve`` for forward scalar checkpoints (the format
``run_training`` writes, by either package): the spec-chain and legacy
single-net layouts, optionally wrapped in the hard-BC ansatz.  On a CUDA
device the residual's u-partials come from kernel B1
(tpinn_torch.kernels.mlp_taylor); ``/predict`` is the plain forward
(feature map, then a ``torch.matmul`` chain).

Run:  python -m tpinn_torch.app.serve --checkpoint out/params_stage_1.npz \
          --problem annulus_laplace [--port 8060] [--device cuda]

API:
    POST /predict   {"points": [[r, t], ...]}      -> {"u": [...]}
    POST /residual  {"points": [[r, t], ...]}      -> {"f": [...]}
    GET  /health                                   -> {"ok": true, ...}

Queries are padded to batch tiers (powers of two, at least 64), as the
JAX server does to bound its compiled shapes; here the tiers also bound
the shapes kernel B1 and cuBLAS see.

A checkpoint whose meta carries a spectral ``deflation`` correction (the
trainer's final stage, polish.defect_correction) is served with the
correction subtracted, u(z) − T(z); ``deflate="auto" | "full"`` computes
one at load for a checkpoint trained without it.  The corrected residual
differentiates through T(z) with the generic jvp engine.

Not ported yet, and refused with NotImplementedError rather than served
wrong: ensembles (``ensemble.json``), time-marching (``march.json``),
patch, coupled-system and inverse checkpoints.  ROADMAP.md Queue A items
13 and 15 bring them.
"""

from __future__ import annotations

import argparse
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
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


def _refuse(what: str, item: str):
    raise NotImplementedError(
        f"{what} checkpoints are not served by tpinn_torch yet (ROADMAP.md "
        f"Queue A item {item}); serve them with tpinn.app.serve")


class PINNServer:
    def __init__(self, checkpoint: str, problem_name: Optional[str] = None,
                 depth: Optional[int] = None, width: Optional[int] = None,
                 deflate: str = "off", *, device):
        self.device = _resolve_device(device)

        cpath = Path(checkpoint)
        for record, what, item in (("ensemble.json", "ensemble", "13"),
                                   ("march.json", "time-marching", "13")):
            if cpath.name == record or (cpath.is_dir()
                                        and (cpath / record).exists()):
                _refuse(what, item)

        with np.load(checkpoint) as raw:
            meta = (json.loads(bytes(raw["__meta__"]).decode())
                    if "__meta__" in raw else {})
            w_shapes = [raw[k].shape for k in sorted(raw.files)
                        if k.endswith("/w")]
        if meta.get("system"):
            _refuse("coupled-system", "13")
        if meta.get("inverse") or meta.get("coef"):
            _refuse("inverse", "13")
        if meta.get("patch"):
            _refuse("patch", "13")
        if problem_name is None:
            raise ValueError(
                "--problem is required: forward checkpoints do not describe "
                "their own equation")
        problem = problems.get_problem(problem_name)
        self.problem = problem
        self.compiled = pde.compile_pde(problem.equation, problem.coords)

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

        if "chain" in meta:
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
            coords = tuple(meta.get("coords", problem.coords))
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
                coords=tuple(meta.get("coords", problem.coords)),
                bc_groups=problem.bc_groups)
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

    def _predict(self, z: torch.Tensor) -> torch.Tensor:
        return self.predictor(self.params, z)

    def _residual(self, z: torch.Tensor) -> torch.Tensor:
        return self.compiled.residual_fast(self.predictor, self.params, z)

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
        return out[:, 0].tolist()

    def predict(self, points):
        return self._eval(self._predict, points)

    def residual(self, points):
        return self._eval(self._residual, points)


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
                self._json({"ok": True, "problem": server.problem.name,
                            "equation": server.problem.equation,
                            "device": str(server.device)})
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
                else:
                    self._json({"error": "not found"}, 404)
            except Exception as e:  # request boundary: report, keep serving
                self._json({"error": str(e)}, 400)

    return Handler


def main():  # pragma: no cover
    p = argparse.ArgumentParser(description="serve a trained tpinn model "
                                            "with the PyTorch port")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--problem", required=True, help="problem preset")
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
    print(f"serving {args.problem} on :{args.port} ({server.device})")
    httpd.serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
