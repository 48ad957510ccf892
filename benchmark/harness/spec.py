"""``BENCHMARK.json`` and the files it names, found by name:

- ``configs/<config>.json`` and its plain reference ``reference/<config>.py``;
- ``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``;
- ``metrics/<metric>.py`` for each per-layer metric;
- ``limits/<cell>.json``, the limit of each number that decides
  ``correct``.

A cell taken out of ``BENCHMARK.json`` until it can be measured keeps its
entries in ``pending/<cell>.json`` and its files in place; the tests run
it through :func:`with_pending`.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def with_pending(bench: dict, name: str) -> dict:
    """``bench`` with the pending cell ``name`` put back: its workload,
    its own per-layer metrics, and its name in the ``workloads`` of the
    metrics that list it."""
    pend = load_json(BENCH / "pending" / f"{name}.json")
    bench = json.loads(json.dumps(bench))
    bench["workloads"] += pend["workloads"]
    bench["per_layer"] += pend["per_layer"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in pend["listed_in"]:
            m["workloads"].append(name)
    return bench


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, bench: dict = None):
        bench = bench or benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; the benchmark has "
                           f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = load_json(BENCH / "configs" / f"{self.entry['config']}"
                                ".json")
        self.traffic = load_json(BENCH / "traffic" / f"{self.entry['traffic']}"
                                 ".json")
        self.run_seconds = int(bench["run_seconds"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.peaks = load_json(BENCH / "peaks.json")

    def driver(self) -> ModuleType:
        return load_module(BENCH / "drivers" / f"{self.traffic['driver']}.py",
                           f"bench_driver_{self.traffic['driver']}")

    def reference(self) -> ModuleType:
        return load_module(BENCH / "reference" / f"{self.config['name']}.py",
                           f"bench_reference_{self.config['name']}")

    def readers(self) -> Dict[str, ModuleType]:
        return {m["name"]: load_module(BENCH / "metrics" / f"{m['name']}.py",
                                       "bench_metric_" + m["name"]
                                       .replace(".", "_"))
                for m in self.per_layer}

    def metric_names(self, trace: bool) -> List[str]:
        return [m["name"] for m in (self.per_layer if trace
                                    else self.end_to_end)]
