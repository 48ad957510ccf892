"""The cell allen_cahn_pirate.adam on the CPU: its per-layer readers on
synthetic profiler events, work/pirate.py's count by hand, and the driver
drivers/adam_arch.py at a small traffic (the cell's own 256-wide
PirateNet on 112 points a step): a sound run is correct, and the control
(the reference in TF32 put in the program's place), half of the batch
left out in the program, and a gradient of the gates or the blocks scaled
in the program are not."""

import itertools
import math
import time

import pytest
import torch

from benchmark.harness import compare, spec
from benchmark.harness.cell import run_cell
from benchmark.work import pirate

CELL = "allen_cahn_pirate.adam"
SEED = 2_147_483_701
MS = 1_000_000  # ns


def reader(name):
    return spec.load_module(spec.BENCH / "metrics" / f"{name}.py",
                            "test_pirate_" + name.replace(".", "_"))


def host(name, start, end, thread=1):
    return ("host", name, thread, round(start * MS), round(end * MS))


# two steps; the engine's calls on the main thread, one on a second
# thread; a call still open when the stretch ends at 30 ms
EVENTS = [
    host("partials.generic", 0, 6), host("partials.generic.pass", 0.5, 3),
    host("partials.generic.pass", 3, 5.5),
    host("partials.generic", 10, 14, thread=2),
    host("partials.generic.pass", 10, 12, thread=2),
    host("partials.generic.pass", 12, 13.5, thread=2),
    host("partials.lift_bubble", 14, 15),
    host("partials.generic", 20, 30), host("partials.generic.pass", 21, 30),
    ("device", "ampere_sgemm_128x64_nn", 0, 1 * MS, 29 * MS),
    ("runtime", "cudaLaunchKernel", 1, 29 * MS, 30 * MS),
]


def ctx(events=EVENTS, units=2):
    return {"events": events, "seconds": 0.030, "units": units,
            "calls": {}, "work": {}, "window_units": 300, "window_s": 30.0,
            "unit_flops": 1.5e12,
            "peaks": {"tf32_flop_per_s": 495e12, "fp32_flop_per_s": 67e12,
                      "hbm_byte_per_s": 3.35e12}}


def test_readers_on_synthetic_events():
    # complete calls: 6 ms and 4 ms; the one open at the end is left out
    assert reader("generic_ms.adam").read(ctx()) == pytest.approx(
        (6 + 4) / 2, rel=1e-12)
    assert reader("generic_passes_per_step.adam").read(ctx()) == 4 / 2
    assert reader("adam_step_mfu_pct").read(ctx()) == pytest.approx(
        100 * 1.5e12 * 300 / 30.0 / 495e12, rel=1e-12)


@pytest.mark.parametrize("name", ["generic_ms.adam",
                                  "generic_passes_per_step.adam"])
def test_readers_without_the_spans_read_none(name):
    # the parent's program opens neither span
    plain = [e for e in EVENTS if not e[1].startswith("partials.generic")]
    assert reader(name).read(ctx(plain)) is None
    assert reader(name).read(ctx([])) is None


def test_operations_by_hand():
    # 3*128 + (2 + 9)*256*256 + 256 multiply-adds a stream at a point
    assert pirate.macs(256, 3, 3) == 384 + 11 * 65_536 + 256 == 721_536
    # three products each, less the Fourier projection's cotangent
    assert pirate.operations(66_048, 256, 3, 3, 4) == (
        2 * 66_048 * 4 * (3 * 721_536 - 384))
    assert pirate.operations(66_048, 256, 3, 3, 4) == pytest.approx(
        1.1435e12, rel=1e-4)


def small():
    cell = spec.Cell(CELL)
    cell.traffic = dict(cell.traffic, n_col=64, n_adaptive=32, n_bd=16,
                        log_every=1, warm_steps=10, trace_steps=5)
    return cell


def test_sound_run_is_correct():
    line = run_cell(small(), SEED, 0.0, True, time.perf_counter(),
                    torch.device("cpu"))
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["metrics"]["generic_passes_per_step.adam"]["value"] == 2.0
    for name in ("generic_ms.adam", "adam_step_mfu_pct",
                 "forward_ms.adam", "backward_ms.adam"):
        assert line["metrics"][name]["value"] > 0, name


def test_half_batch_in_the_program_is_not_correct(monkeypatch):
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
    line = run_cell(small(), SEED, 0.0, False, time.perf_counter(),
                    torch.device("cpu"))
    assert not line["correct"], line["compared"]


def test_tf32_control_is_not_correct():
    cell = small()
    assert cell.config["precision"]["lbfgs"] == "fp32"
    out = cell.driver().run(cell, SEED, 0.0, False, time.perf_counter(),
                            torch.device("cpu"))
    res = cell.driver().controls(cell, SEED, out, "tf32", [0.5])
    for kind in ("control", "fault_part_0.5"):
        ok, compared = compare.judge(res[kind], compare.limits_for(CELL))
        assert not ok, (kind, compared)


@pytest.mark.parametrize("part, scale", [("blocks", 1.5), ("gates", 0.5)])
def test_scaled_gradient_of_gates_or_blocks_is_not_correct(monkeypatch, part,
                                                           scale):
    # The program hands B3 a gradient whose gate or block leaves are
    # scaled.  Their first gradient is exactly 0 (every alpha is 0), and
    # Adam's update sees a leaf's gradient scaled only through eps; the
    # second gradient, recovered from B3's first moments, shows it whole.
    from tpinn_torch.kernels import adam as adam_kernel

    cell = small()
    sizes = [math.prod(s) for s in cell.reference().shapes(cell.config)]
    offs = list(itertools.accumulate([0] + sizes))
    # leaves: alpha, fourier_b, gate_u and gate_v (b, g, v each), the
    # blocks' layers, the output layer
    lo, hi = {"gates": (offs[2], offs[8]), "blocks": (offs[8], offs[-4])}[part]
    base = adam_kernel.FusedAdam

    class Faulty(base):
        def step(self, g):
            g = g.clone()
            g[lo:hi] *= scale
            return base.step(self, g)

    monkeypatch.setattr(adam_kernel, "FusedAdam", Faulty)
    line = run_cell(cell, SEED, 0.0, False, time.perf_counter(),
                    torch.device("cpu"))
    assert not line["correct"], line["compared"]
    gap = line["compared"]["grad1_gap"]
    assert gap["value"] > 100 * gap["limit"], line["compared"]
    assert line["compared"]["grad_gap"]["value"] <= (
        line["compared"]["grad_gap"]["limit"])
