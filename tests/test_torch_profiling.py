"""tpinn_torch.utils.profiling against tpinn.utils.profiling, on the CPU.

tests/test_utils.py's StepTimer and timed case on the port, the two
summaries equal for the same step times, and the Chrome trace written
by ``trace``.  On the CPU the timer reads the host clock.  Then the
port's own spans (``span``, ``read``, ``SPANS``): off without a profiler,
by name in the trace, each opened where the program says, and the Adam
phase and L-BFGS bit for bit the same under a profiler.
"""

import contextlib
import json
import re
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from tpinn.utils import profiling as jprof
from tpinn_torch.core import net, optim, pde
from tpinn_torch.utils import profiling


def test_step_timer():
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer.step() as t:
            t.observe(torch.ones(8) * 2)
    assert len(timer.times) == 3
    assert "steps=3" in timer.summary()

    out, secs = profiling.timed(lambda x: x + 1, torch.zeros(4), iters=3)
    assert secs >= 0
    assert torch.equal(out, torch.ones(4))


@pytest.mark.parametrize("times", [[], [0.002], [0.004, 0.001, 0.0125],
                                   [1e-4 * k for k in range(1, 12)]])
def test_summary_equals_tpinn(times):
    ours, theirs = profiling.StepTimer(), jprof.StepTimer()
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary() == theirs.summary()
    assert ours.mean == theirs.mean
    with theirs.step() as t:
        t.observe(jnp.ones(2))
    assert len(theirs.times) == len(times) + 1


@pytest.mark.parametrize("warmup", [0, 2])
def test_timed_calls_warmup_then_iters(warmup):
    calls = []
    out, secs = profiling.timed(lambda: calls.append(1) or len(calls),
                                warmup=warmup, iters=2)
    assert len(calls) == warmup + 2 and out == warmup + 2 and secs >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        x = torch.randn(64, 64)
        y = (x @ x).sum()
    assert float(y) == pytest.approx(float((x @ x).sum()))
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names
    assert any(e.key in ("aten::mm", "aten::matmul")
               for e in prof.key_averages())


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _count(prof, name):
    return sum(1 for e in prof.events() if e.name == name)


def test_span_is_the_shared_null_context_without_a_profiler(monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    null = profiling.span("adam.forward")
    assert null is profiling.span("b2.launch") is profiling.span("no.such")
    assert isinstance(null, contextlib.nullcontext)
    with profiling.span("lbfgs.iter"):
        pass
    assert profiling.read(torch.tensor(2.5), "lbfgs.iter") == 2.5


def test_span_in_the_trace_by_name(tmp_path, one_thread):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        with profiling.span("adam.forward"):
            torch.ones(4).sum()
        assert profiling.read(torch.tensor(1.5), "lbfgs.search") == 1.5
    assert _count(prof, "adam.forward") == 1
    assert _count(prof, "read.lbfgs.search") == 1
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = [e.get("name") for e in events["traceEvents"]]
    assert names.count("adam.forward") == 1
    assert names.count("read.lbfgs.search") == 1


def test_span_outside_spans_raises_while_profiling(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with pytest.raises(ValueError, match="not one of"):
            profiling.span("adam.update")
        with pytest.raises(ValueError, match="not one of"):
            profiling.read(torch.tensor(1.0), "adam.tail")


def test_every_span_is_opened_in_the_program():
    root = Path(profiling.__file__).resolve().parents[1]
    src = "\n".join(p.read_text() for p in root.rglob("*.py")
                    if p.name != "profiling.py")
    opened = set(re.findall(r'\bspan\("([\w.]+)"\)', src))
    read_at = {"read." + s for s in re.findall(r'\bread\([^()]*(?:\([^()]*\)'
                                               r'[^()]*)*, "([\w.]+)"\)', src)}
    assert opened | read_at == set(profiling.SPANS)
    assert len(profiling.SPANS) == len(set(profiling.SPANS)) == 13


def _adam_run(profiled, tmp_path):
    def loss_fn(params, data, lw, ref):
        r = params["w"][None, :] * data["x"] - data["y"]
        loss = (r ** 2).mean()
        return loss / ref, torch.stack([loss, loss, lw[0] * loss])

    def sample_fn(gen, F):
        x = torch.rand((16, 3), generator=gen)
        return {"x": x, "y": torch.sin(x) * F[0, 0]}

    phase = optim.make_adam_phase(
        loss_fn, sample_fn, None,
        optim.AdamConfig(epochs=25, lr=0.05, resample_every=10, tail_max=0,
                         log_every=5), info_width=3)
    gen = torch.Generator().manual_seed(3)
    args = (gen, {"w": torch.zeros(3)}, sample_fn(gen, torch.ones(1, 1)),
            torch.ones(1, 1), torch.ones(1), torch.tensor(1.0))
    if not profiled:
        return phase(*args), None
    with profiling.trace(str(tmp_path / "prof")) as prof:
        res = phase(*args)
    return res, prof


def test_adam_phase_spans_and_bit_identical(tmp_path, one_thread):
    plain, _ = _adam_run(False, tmp_path)
    traced, prof = _adam_run(True, tmp_path)
    assert _count(prof, "adam.forward") == 25
    assert _count(prof, "adam.backward") == 25
    # resamples after steps 10 and 20
    assert _count(prof, "adam.resample") == 2
    assert torch.equal(plain.params["w"], traced.params["w"])
    assert torch.equal(plain.history, traced.history)


def _lbfgs_run(profiled, tmp_path):
    c = torch.tensor([1.0, 3.0, 10.0, 30.0, 100.0])
    evals = []

    def loss_fn(params, data, lw, ref):
        evals.append(1)
        loss = (c * (params["w"] - data["t"]) ** 2).sum()
        return loss / ref, torch.stack([loss, loss])

    cfg = optim.LBFGSConfig(max_iters=6, memory=4, tolerance=1e-30)
    args = (loss_fn, {"w": torch.zeros(5)}, {"t": torch.linspace(1, 2, 5)},
            torch.ones(1), torch.tensor(1.0), cfg)
    if not profiled:
        return optim.lbfgs_over_pytree(*args), len(evals), None
    with profiling.trace(str(tmp_path / "prof")) as prof:
        res = optim.lbfgs_over_pytree(*args)
    return res, len(evals), prof


def test_lbfgs_spans_reads_and_bit_identical(tmp_path, one_thread):
    (p0, h0, rows0), n0, _ = _lbfgs_run(False, tmp_path)
    (p1, h1, rows1), n_evals, prof = _lbfgs_run(True, tmp_path)
    assert torch.equal(p0["w"], p1["w"]) and torch.equal(h0, h1)
    assert rows0 == rows1 and n0 == n_evals
    iters = rows1 - 1      # one history row per accepted iterate
    assert iters == 6
    assert _count(prof, "lbfgs.iter") == iters
    assert _count(prof, "lbfgs.eval") == n_evals
    # the line search reads phi0 and dphi0, then f and df at each probe
    # (every evaluation but the first)
    assert _count(prof, "read.lbfgs.search") == 2 * iters + 2 * (n_evals - 1)
    # an iterate reads d.g, s.y, |s|, |y|, y.y and max |g|; the first also
    # |g|_1, and the result max |g| once more
    assert _count(prof, "read.lbfgs.iter") == 6 * iters + 1 + 1


def test_hard_bc_partials_one_lift_bubble_span(tmp_path, one_thread):
    coords = ("r", "t")
    spec = net.MLPSpec(depth=2, width=8)
    fm = net.feature_map_for(("minmax", "periodic"))
    lb, ub = torch.tensor([0.1, 0.0]), torch.tensor([1.0, 6.283])
    hard = net.wrap_hard_bc(net.make_predictor(spec, fm, lb, ub),
                            pde.compile_coord_expr("(1 - r)/0.9", coords),
                            pde.compile_coord_expr("(r - 0.1)*(1 - r)",
                                                   coords))
    params = net.init_params(torch.Generator().manual_seed(0), spec, fm,
                             torch.device("cpu"))
    z = lb + torch.rand((32, 2), generator=torch.Generator().manual_seed(1)) \
        * (ub - lb)
    idx = [(), (0,), (1,), (0, 0), (1, 1)]
    with profiling.trace(str(tmp_path / "prof")) as prof:
        out = hard.tpinn_partials(params, z, idx)
    assert _count(prof, "partials.lift_bubble") == 1
    assert set(out) == set(idx)


def test_hard_bc_partials_hit_span_on_the_second_call(tmp_path, one_thread):
    coords = ("r", "t")
    spec = net.MLPSpec(depth=2, width=8)
    fm = net.feature_map_for(("minmax", "periodic"))
    lb, ub = torch.tensor([0.1, 0.0]), torch.tensor([1.0, 6.283])
    hard = net.wrap_hard_bc(net.make_predictor(spec, fm, lb, ub),
                            pde.compile_coord_expr("(1 - r)/0.9", coords),
                            pde.compile_coord_expr("(r - 0.1)*(1 - r)",
                                                   coords))
    params = net.init_params(torch.Generator().manual_seed(0), spec, fm,
                             torch.device("cpu"))
    z = lb + torch.rand((32, 2), generator=torch.Generator().manual_seed(1)) \
        * (ub - lb)
    idx = [(), (0,), (1,), (0, 0), (1, 1)]
    with profiling.trace(str(tmp_path / "first")) as prof:
        first = hard.tpinn_partials(params, z, idx)
    assert _count(prof, "partials.lift_bubble") == 1
    assert _count(prof, "partials.lift_bubble.hit") == 0
    with profiling.trace(str(tmp_path / "second")) as prof:
        second = hard.tpinn_partials(params, z, idx)
    calls = [e for e in prof.events() if e.name == "partials.lift_bubble"]
    hits = [e for e in prof.events() if e.name == "partials.lift_bubble.hit"]
    assert len(calls) == len(hits) == 1
    assert (calls[0].time_range.start <= hits[0].time_range.start
            and hits[0].time_range.end <= calls[0].time_range.end)
    for ix in idx:
        assert torch.equal(first[ix], second[ix])
