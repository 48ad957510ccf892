"""Figure data loaders: .npz artifacts → JSON-serializable plot payloads.

A copy of ``tpinn.app.figure_data`` (numpy and scipy only), so that the
port imports nothing from ``tpinn``; it reads the 11 artifacts that
``tpinn_torch.utils.artifacts`` writes.  Mirrors the reference's six
figure functions (figures.py:52-273) — same files, same fields, same
upsampling semantics — but emits plain data dicts; rendering happens in
the frontend (canvas JS in the lite app).

The 11-tab → file map reproduces callbacks/result_graph.py:62-87.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
from scipy.ndimage import zoom


def _lists(a):
    return np.asarray(a).tolist()


def load_collocation(path) -> Dict:
    d = np.load(path)
    U, X_col, limit = d["U"], d["X_col"], d["limit"]
    x1min, x1max, x2min, x2max = [float(v) for v in limit]
    x = np.linspace(x1min, x1max, U.shape[1])
    y = np.linspace(x2min, x2max, U.shape[0])
    return {
        "type": "heatmap_scatter",
        "x": _lists(x), "y": _lists(y), "z": _lists(U),
        "points_x": _lists(X_col[:, 0]), "points_y": _lists(X_col[:, 1]),
        "xlabel": "t", "ylabel": "h",
    }


def load_solution_residual(path, upsample: int = 4) -> Dict:
    """Side-by-side u and f heatmaps.  The reference upsamples 10× with
    spline zoom (figures.py:84-89); 4× keeps payloads browser-friendly with
    the same visual effect."""
    d = np.load(path)
    U, F = d["U"], d["F"]
    U_f = zoom(U, upsample) if min(U.shape) > 3 else U
    F_f = zoom(F, upsample) if min(F.shape) > 3 else F
    ny, nx = U_f.shape
    # the reference hardcodes r∈[0.1,1], t∈[0,2π] (figures.py:91-92) —
    # correct only for its single problem.  The artifact carries the real
    # axes (write_solution_residual); use them, fall back to the
    # reference's constants for legacy files without them.
    if "r" in d.files and d["r"].size >= 2:
        r = np.linspace(float(d["r"][0]), float(d["r"][-1]), nx)
    else:
        r = np.linspace(0.1, 1.0, nx)
    # stage-1 files store the second axis as 't_vec', stage-2 as 't'
    # (reference key drift, write_solution_residual) — honor both
    t_ax = next((d[k] for k in ("t_vec", "t")
                 if k in d.files and d[k].size >= 2), None)
    if t_ax is not None:
        t = np.linspace(float(t_ax[0]), float(t_ax[-1]), ny)
    else:
        t = np.linspace(0, 2 * np.pi, ny)
    return {
        "type": "dual_heatmap",
        "x": _lists(r), "y": _lists(t),
        "z1": _lists(U_f), "z2": _lists(F_f),
        "titles": ["u", "f"], "xlabel": "r", "ylabel": "θ",
    }


def load_error(path, upsample: int = 4) -> Dict:
    d = np.load(path)
    r, t, err = d["r"], d["t"], d["Error"]
    if min(err.shape) > 3:
        err_f = zoom(err, upsample, order=3)
    else:
        err_f = err
    r_f = np.linspace(r.min(), r.max(), err_f.shape[1])
    t_f = np.linspace(t.min(), t.max(), err_f.shape[0])
    return {
        "type": "heatmap",
        "x": _lists(r_f), "y": _lists(t_f), "z": _lists(err_f),
        "xlabel": "r", "ylabel": "θ",
    }


MAX_CURVE_POINTS = 2000


def _stride(n: int) -> int:
    return max(1, n // MAX_CURVE_POINTS)


def load_loss(path) -> Dict:
    loss = np.load(path)["loss"]
    s = _stride(loss.shape[0])
    return {
        "type": "lines_log",
        "series": [
            {"name": "Total Loss", "y": _lists(loss[::s, 0])},
            {"name": "Data Loss", "y": _lists(loss[::s, 1])},
            {"name": "Eqn Loss", "y": _lists(loss[::s, 2])},
        ],
        "xlabel": "Iteration",
        "x_stride": s,
    }


def load_boundary_loss(path) -> Dict:
    d = np.load(path)
    s = _stride(d["loss_xy_l"].shape[0])
    return {
        "type": "lines_log_pair",
        "series": [
            {"name": "Boundary Loss - xy_l", "y": _lists(d["loss_xy_l"][::s])},
            {"name": "Boundary Loss - xy_r", "y": _lists(d["loss_xy_r"][::s])},
        ],
        "xlabel": "Iteration",
        "x_stride": s,
    }


def load_spectrum(path) -> Dict:
    d = np.load(path)
    return {
        "type": "heatmap",
        "x": _lists(d["freq_x"]), "y": _lists(d["freq_t"]),
        "z": _lists(d["log_mag"]),
        "xlim": [0, 5], "ylim": [0, 5],     # figures.py:267-268 window
        "xlabel": "r", "ylabel": "t",
    }


# tab key → (artifact file, loader) — callbacks/result_graph.py:62-87
FIGURES = {
    "colloc_1": ("collocation_point_1.npz", load_collocation),
    "colloc_2": ("collocation_point_2.npz", load_collocation),
    "solution_1": ("solution_residual_1.npz", load_solution_residual),
    "solution_2": ("solution_residual_2.npz", load_solution_residual),
    "error_1": ("error_1.npz", load_error),
    "error_2": ("error_2.npz", load_error),
    "loss_1": ("loss_1.npz", load_loss),
    "loss_2": ("loss_2.npz", load_loss),
    "boundary_1": ("boundary_loss_1.npz", load_boundary_loss),
    "boundary_2": ("boundary_loss_2.npz", load_boundary_loss),
    "spectrum": ("frequency_spectrum.npz", load_spectrum),
}


def figure_payload(session_dir, name: str) -> Dict:
    """Load a figure payload, or a 'missing' placeholder (the reference's
    make_missing_fig behavior, including swallowing torn reads)."""
    if name not in FIGURES:
        return {"type": "missing", "message": f"unknown figure {name!r}"}
    fname, loader = FIGURES[name]
    path = Path(session_dir) / fname
    try:
        return loader(path)
    except Exception:
        return {"type": "missing",
                "message": "The result has not yet been generated..."}
