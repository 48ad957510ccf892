"""The comparison that decides ``correct``, shown to fail: each cell's run
is driven on the CPU at a size a test run holds (the look for a card
skipped, the kernels' plain versions standing in), with its limits from
``benchmark/limits``.  A sound run comes out correct; the control (the
plain reference in the nearest precision below the configuration's, put
in the program's place) and every fault the cell can have, planted in the
program underneath the harness, come out not correct: a step that returns
its state unchanged, half of the batch left out with the mean taken over
the rest, and, on a mesh, the exchange between ranks left out."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import compare, spec
from benchmark.harness.cell import run_cell

ADAM = ["annulus_laplace.adam", "poisson_3d.adam"]
LOWER = {"fp32": "tf32", "tf32": "bf16"}
SEED = 2_147_483_701


def small(name):
    cell = spec.Cell(name)
    if cell.traffic["driver"] == "adam":
        cell.traffic = dict(cell.traffic, n_col=400, n_band=100,
                            n_adaptive=100, n_bd=50)
    else:
        cell.traffic = dict(cell.traffic, grid=24)
    return cell


def run(cell):
    torch.manual_seed(0)
    return run_cell(cell, SEED, 0.2, False, time.perf_counter(),
                    torch.device("cpu"))


def half_batch(monkeypatch):
    """The loss takes the mean over the first half of every point set."""
    from tpinn_torch.core import loss as loss_mod

    make = loss_mod.make_loss

    def make_half(*args, **kwargs):
        fn = make(*args, **kwargs)

        def loss_fn(params, data, lw, ref):
            half = {k: ([x[:x.shape[0] // 2] for x in v]
                        if isinstance(v, list) else v[:v.shape[0] // 2])
                    for k, v in data.items()}
            return fn(params, half, lw, ref)

        return loss_fn

    monkeypatch.setattr(loss_mod, "make_loss", make_half)


def unchanged_adam(monkeypatch):
    """Kernel B3's update returns the state as it was."""
    from tpinn_torch.kernels import adam

    monkeypatch.setattr(adam.FusedAdam, "step",
                        lambda self, g: (self.p, self.m, self.v))


def iid_collocation(monkeypatch):
    """The sampler's uniform block drawn point by point, not in strata."""
    from tpinn_torch.core import sample

    def iid(gen, n, dim, dtype=torch.float32):
        return torch.rand((n, dim), generator=gen, device=gen.device,
                          dtype=dtype)

    monkeypatch.setattr(sample, "lhs", iid)


def band_inside(monkeypatch):
    """The boundary band drawn from the box's interior."""
    from tpinn_torch.core import sample

    frame = sample.boundary_band_density

    monkeypatch.setattr(sample, "boundary_band_density",
                        lambda *a: 1.0 - frame(*a))
    frame_nd = sample.boundary_band_density_nd
    monkeypatch.setattr(sample, "boundary_band_density_nd",
                        lambda *a: 1.0 - frame_nd(*a))


def unchanged_lbfgs(monkeypatch):
    """Every evaluation of L-BFGS lands on the starting point."""
    from tpinn_torch.core import optim

    minimize = optim.lbfgs_minimize

    def stuck(vg, x0, config):
        return minimize(lambda x, _x0=x0.clone(): vg(_x0), x0, config)

    monkeypatch.setattr(optim, "lbfgs_minimize", stuck)


@pytest.mark.parametrize("name", ADAM + ["annulus_laplace.lbfgs"])
def test_sound_run_is_correct(name):
    line = run(small(name))
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("name, fault", [
    *[(n, unchanged_adam) for n in ADAM],
    *[(n, half_batch) for n in ADAM + ["annulus_laplace.lbfgs"]],
    *[(n, f) for n in ADAM for f in (iid_collocation, band_inside)],
    ("annulus_laplace.lbfgs", unchanged_lbfgs),
])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line = run(small(name))
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("name", ADAM + ["annulus_laplace.lbfgs"])
def test_control_is_not_correct(name):
    cell = small(name)
    phase = "adam" if cell.traffic["driver"] == "adam" else "lbfgs"
    out = cell.driver().run(cell, SEED, 0.2, False, time.perf_counter(),
                            torch.device("cpu"))
    res = cell.driver().controls(cell, SEED, out,
                                 LOWER[cell.config["precision"][phase]], [])
    ok, compared = compare.judge(res["control"],
                                 compare.limits_for(cell.name))
    assert not ok, compared


MESH_RANK = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from benchmark.harness import spec, ranks
from benchmark.harness.cell import run_cell
rank, world, port, fault = {rank}, {world}, {port}, {fault!r}
name = "annulus_laplace.adam_mesh4"
cell = spec.Cell(name, spec.with_pending(spec.benchmark(), name))
cell.traffic = dict(cell.traffic, n_col=400 * world, n_band=100 * world,
                    n_adaptive=100 * world, n_bd=50 * world)
if fault:
    from tpinn_torch.parallel import mesh
    mesh.Mesh.reduce_step = (lambda self, loss_n, info, grads,
                             sum_ensemble=False: (loss_n, info, grads))
r = ranks.Ranks(rank, world, port, "cpu")
line = run_cell(cell, {seed}, 0.2, False, time.perf_counter(),
                torch.device("cpu"), r)
if line is not None:
    print("RESULT " + json.dumps({{"correct": line["correct"],
                                  "compared": line["compared"]}}))
if {jax_on} == rank:
    import types
    sys.modules["jax"] = types.ModuleType("jax")
from benchmark import run
sys.exit(run.report(None, []))
"""


@pytest.mark.parametrize("fault, jax_on", [(False, None), (True, None),
                                           (False, 1)],
                         ids=["sound", "exchange_left_out", "jax_on_rank_1"])
def test_mesh_on_two_gloo_ranks(fault, jax_on):
    from benchmark.harness.ranks import free_port

    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_RANK.format(
            root=str(spec.ROOT), rank=r, world=2, port=port, fault=fault,
            seed=SEED, jax_on=jax_on)], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, env=env) for r in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    # a rank that holds JAX after the window exits 4, which rank 0 of
    # run.py turns into 5 and no result
    assert [p.returncode for p in procs] == [0, 4 if jax_on == 1 else 0]
    line = json.loads(outs[0].split("RESULT ", 1)[1])
    assert line["correct"] is (not fault), line["compared"]
