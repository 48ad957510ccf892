"""The readings that a cell's limits are set from, on the card at the cell's
own size, in one process:

- the program's readings on each of ``--seeds`` (its set-up and first
  steps through the cell's driver, then the plain reference): the lower
  reading of each number is the largest of these;
- on each of ``--control-seeds``, the control (the reference in the
  nearest precision below the configuration's, put in the program's
  place) and the faults planted in the reference (the point set cut to
  ``--fractions`` of itself): the upper reading is the least of these
  that separates.

    python benchmark/calibrate.py --cell annulus_laplace.adam \
        --seeds 101 102 ... --control-seeds 101 102 103

A cell on several cards is calibrated on one: its program readings come
from its own runs; here its control and its faults are read on the global
point set, which one process draws alike.  Prints one JSON line per seed
and a summary; writes them to ``--out`` if given.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LOWER = {"fp32": "tf32", "tf32": "bf16"}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fractions", type=float, nargs="*", default=[0.5])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import spec
    from benchmark.harness.cell import build_kernels

    cell = spec.Cell(args.cell)
    device = torch.device("cuda", 0)
    build_kernels()
    drv = cell.driver()
    phase = "adam" if cell.traffic["driver"] == "adam" else "lbfgs"
    prec = LOWER[cell.config["precision"][phase]]
    rows = []
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t0 = time.perf_counter()
        out = drv.run(cell, seed, 0.0, False, t0, device)
        row = {"seed": seed}
        if seed in args.seeds:
            row["program"] = out["judge"]()
        if seed in args.control_seeds:
            row.update(drv.controls(cell, seed, out, prec, args.fractions))
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        del out
    summary = {"cell": cell.name, "control": prec}
    for kind in sorted({k for r in rows for k in r} - {"seed", "seconds"}):
        vals = [r[kind] for r in rows if kind in r]
        pick = max if kind == "program" else min
        summary[kind] = {n: pick(v[n] for v in vals) for n in vals[0]}
    print("SUMMARY " + json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
