"""tpinn_torch.utils.profiling against tpinn.utils.profiling, on the CPU.

tests/test_utils.py's StepTimer and timed case on the port, the two
summaries equal for the same step times, and the Chrome trace written
by ``trace``.  On the CPU the timer reads the host clock.
"""

import json

import jax.numpy as jnp
import pytest
import torch

from tpinn.utils import profiling as jprof
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
