"""What the benchmark loads: no top-level jax, jaxlib, flax or tpinn in any
process it runs; the plain reference loads nothing of tpinn_torch; a run
without a card exits non-zero and prints no result."""

import os
import subprocess
import sys
import types

import pytest

from benchmark import run as bench_run
from benchmark.harness import spec

ROOT = spec.ROOT

LOAD_ALL = """
import sys
sys.path.insert(0, {root!r})
from benchmark.harness import spec, cell, compare, layer, ranks, trace
import benchmark.run, benchmark.calibrate
for name in [w["name"] for w in spec.benchmark()["workloads"]]:
    c = spec.Cell(name)
    c.driver(); c.reference(); c.readers()
from tpinn_torch.core import train, optim, loss, net, pde
from tpinn_torch import parallel
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_any_benchmark_module():
    found = _modules(LOAD_ALL.format(root=str(ROOT)))
    assert not found & {"jax", "jaxlib", "flax", "tpinn"}
    assert "tpinn_torch" in found


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import benchmark.reference.common
from benchmark.harness import spec
for name in ("annulus_laplace", "poisson_3d"):
    spec.load_module(spec.BENCH / "reference" / (name + ".py"), "r_" + name)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    found = _modules(code)
    assert not found & {"jax", "jaxlib", "flax", "tpinn", "tpinn_torch"}


def test_run_without_a_card_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "annulus_laplace.adam", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_run_without_the_program_exits_non_zero(tmp_path):
    # a directory that holds only BENCHMARK.json and the benchmark's files
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "annulus_laplace.adam", "--seed", "7", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


LINE = {"correct": True, "compared": {"loss_gap": {"value": 0.0,
                                                    "limit": 1.0}}}


@pytest.mark.parametrize("line, codes, planted, expected", [
    (None, [], False, 0),        # a rank other than 0
    (None, [], True, 4),         # ... that holds JAX after the window
    (LINE, [0, 0, 0], False, 0),
    (LINE, [0, 4, 0], False, 5),  # rank 0 sees rank 1's 4
    (LINE, [0, 0, 0], True, 4),
], ids=["rank", "rank_jax", "rank0", "rank0_other_failed", "rank0_jax"])
def test_every_rank_checks_its_modules(line, codes, planted, expected,
                                       monkeypatch, capsys):
    if planted:
        monkeypatch.setitem(sys.modules, "jax.numpy",
                            types.ModuleType("jax.numpy"))
    assert bench_run.report(line, codes) == expected
    out = capsys.readouterr()
    assert (out.out != "") is (expected == 0 and line is not None)
    if planted:
        assert "jax" in out.err
