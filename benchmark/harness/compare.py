"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference works out, each held to its limit.

All gaps are taken in float64 on the host.

- ``row_gap``: the widest gap of a loss row's column, as a share of the
  reference row's total loss (``loss_info[0]``), over the rows compared.
- ``leaf_gap``: per parameter leaf, the gap between the two norms (not the
  norm of the difference), as a share of the reference's norm of that
  leaf or of the median leaf, whichever is larger; the worst leaf.
- ``moving``: the leaves whose reference gradient is not nought to
  rounding (its norm at least a thousandth of the median leaf's).
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

LIMITS = Path(__file__).resolve().parents[1] / "limits"


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.detach().double().cpu()))


def row_gap(prog_rows: Sequence, ref_rows: Sequence) -> float:
    worst = 0.0
    for p, r in zip(prog_rows, ref_rows, strict=True):
        p = torch.as_tensor(p).double().cpu()
        r = torch.as_tensor(r).double().cpu()
        if p.shape != r.shape:
            return math.inf
        scale = abs(float(r[0]))
        gap = float((p - r).abs().max()) / scale if scale > 0 else math.inf
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def moving(ref_grad: Sequence) -> List[bool]:
    norms = [_norm(g) for g in ref_grad]
    med = statistics.median(norms)
    return [n >= 1e-3 * med for n in norms]


def leaf_gap(prog: Sequence, ref: Sequence,
             keep: Optional[Sequence[bool]] = None) -> float:
    rn = [_norm(r) for r in ref]
    pn = [_norm(p) for p in prog]
    if len(rn) != len(pn):
        return math.inf
    kept = [i for i in range(len(rn)) if keep is None or keep[i]]
    med = statistics.median([rn[i] for i in kept])
    worst = 0.0
    for i in kept:
        gap = abs(pn[i] - rn[i]) / max(rn[i], med)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def max_abs(a, b) -> float:
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape:
        return math.inf
    return float((a.double() - b.double()).abs().max())


def limits_for(cell: str) -> Dict[str, float]:
    path = LIMITS / f"{cell}.json"
    if not path.exists():
        return {}
    return {k: float(v) for k, v in json.loads(path.read_text()).items()
            if not k.startswith("_")}


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """``(correct, compared)``: every reading finite and within its limit;
    ``compared`` maps each name to its value and limit (None where the
    cell has no limit for it, which fails)."""
    compared, ok = {}, bool(readings)
    for name, value in readings.items():
        lim = limits.get(name)
        compared[name] = {"value": value, "limit": lim}
        if lim is None or not (math.isfinite(value) and value <= lim):
            ok = False
    return ok, compared
