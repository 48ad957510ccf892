"""The benchmark of tpinn_torch: one run of one cell of BENCHMARK.json.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the CUDA context, the kernels built or loaded from the
checkout's ``build/``, the program's set-up and its first steps) runs
first; then the cell's window is measured for ``--seconds``; with
``--trace 1`` a stretch after it is profiled and the per-layer metrics
are read from it, with ``--trace 0`` the end-to-end metrics are printed.
Then the plain reference judges what the timed path produced.  The last
line of standard output is the result's JSON; the numbers compared, each
beside its limit, are the last lines of standard error.

Exit codes: 0 done; 3 no card, or fewer than the cell asks for; 4 JAX or
the JAX package was loaded (each rank looks in its own process); 5 a
rank's process failed.  A cell on several
cards starts one process per card from here (rank 0 is this one).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tpinn")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank's own process (started by rank 0 of a cell on several cards)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def forbidden_modules():
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.harness import spec

    cell = spec.Cell(args.workload)
    import torch

    # one process a card, one intra-op thread: the host's other cores stay
    # free for the step's own dispatch, which sets the pace
    torch.set_num_threads(1)

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {have}", file=sys.stderr)
        return 3

    from benchmark.harness import ranks as ranks_mod
    from benchmark.harness.cell import run_cell

    children, ranks = [], None
    if cell.chips > 1:
        if args.rank is None:
            port = ranks_mod.free_port()
            children = ranks_mod.spawn([str(Path(__file__).resolve()),
                                        *argv], cell.chips, port)
            ranks = ranks_mod.Ranks(0, cell.chips, port)
        else:
            ranks = ranks_mod.Ranks(args.rank, args.world, args.port)
    device = ranks.device if ranks is not None else torch.device("cuda", 0)
    try:
        line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                        T_START, device, ranks)
    finally:
        codes = ranks_mod.wait(children)
    return report(line, codes)


def report(line, codes) -> int:
    """After the window, on every rank: 4 where this process holds JAX or
    the JAX package, 5 on rank 0 where another rank's process failed
    (such as with 4), else 0, rank 0 printing the result (``line``; None
    on the other ranks)."""
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    if line is None:
        return 0
    if any(codes):
        print(f"rank processes exited with {codes}", file=sys.stderr)
        return 5
    print(json.dumps(line), flush=True)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
