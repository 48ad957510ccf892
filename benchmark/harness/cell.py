"""One run of one cell: its driver measures, its readers reduce the traced
stretch, the plain reference judges, and the result line is assembled.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import torch

from benchmark.harness import compare, trace

KERNELS = ("taylor2_fwd", "taylor2_bwd", "adam")


def build_kernels() -> None:
    """The program's three CUDA kernels, built by nvcc into the checkout's
    ``build/kernels/`` on a first run and loaded from there on later ones
    (set-up either way); what happened goes to standard error."""
    from tpinn_torch.kernels import _build

    _build.load_all(KERNELS)
    for name in KERNELS:
        info = _build.BUILD_INFO[name]
        print(f"kernel {name}: cached={info['cached']} "
              f"seconds={info['seconds']:.3f}", file=sys.stderr)


def run_cell(cell, seed: int, seconds: float, do_trace: bool, t_start: float,
             device: torch.device, ranks=None) -> Optional[dict]:
    """The result line of this run (None on ranks other than 0).

    The cell's driver returns ``end_to_end`` ({metric: value}, which must
    hold every end-to-end metric the cell lists), ``attempted``, ``failed``,
    ``memory_peak_bytes``, ``judge`` (the readings compared) and, traced,
    ``layer_ctx`` (what the per-layer readers take)."""
    if device.type == "cuda":
        torch.zeros(1, device=device)
        t_cuda = time.perf_counter()
        build_kernels()
        print(f"set-up: CUDA context at {t_cuda - t_start:.3f} s, kernels "
              f"loaded at {time.perf_counter() - t_start:.3f} s",
              file=sys.stderr)
    out = cell.driver().run(cell, seed, seconds, do_trace, t_start, device,
                            ranks)
    ctx = out.get("layer_ctx")
    busy = trace.busy_ns(ctx["events"]) / 1e9 if ctx else None
    peak = out["memory_peak_bytes"]
    if ranks is not None:
        both = ranks.objects((peak, busy))
        peak = max(p for p, _ in both)
        if busy is not None:
            busy = sum(b for _, b in both) / len(both)
    readings = out["judge"]()
    if ranks is not None:
        ranks.close()
        if ranks.rank != 0:
            return None
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if not do_trace:
        # each end-to-end metric the cell lists, as its driver measured it
        for name in cell.metric_names(False):
            if name not in out["end_to_end"]:
                raise KeyError(f"{cell.name} lists {name!r}; its driver "
                               f"measures {sorted(out['end_to_end'])}")
            metrics[name] = {"value": out["end_to_end"][name],
                             "unit": units[name]}
    else:
        for name, reader in cell.readers().items():
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    line = {"correct": False, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if ctx is not None:
        dev["busy_s"] = busy
        dev["window_s"] = ctx["seconds"]
        line["breakdown"] = {"device_ops": trace.device_ops(ctx["events"]),
                             "idle_gaps": trace.idle_gaps(ctx["events"])}
    correct, compared = compare.judge(readings or {},
                                      compare.limits_for(cell.name))
    line["correct"] = correct
    line["compared"] = compared
    return line
