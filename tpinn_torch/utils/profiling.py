"""Profiling and timing hooks (port of ``tpinn.utils.profiling``).

- ``trace(logdir)``: a ``torch.profiler`` trace of the CPU and, where a
  card is present, of its CUDA kernels, written to ``logdir`` as a Chrome
  trace (Perfetto, chrome://tracing);
- ``span(name)``: a named range of the program (one of ``SPANS``) while a
  profiler runs, nothing otherwise; ``read(x, site)``: a host read of a
  device scalar inside the span ``read.<site>``;
- ``StepTimer``: per-step times, from CUDA events when the step's observed
  output lies on a card, else from the host clock;
- ``timed(fn)``: time per call of ``fn`` after warm-up calls, the card
  synchronised around the timed calls.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Iterator

import torch

# The program's named ranges, where they are opened:
#   adam.forward, adam.backward  core/optim.py, the Adam step's loss and its
#                                torch.autograd.grad
#   adam.resample                core/optim.py, the Adam phase's new points
#   partials.lift_bubble         core/net.py hard_bc_partials, the lift's
#                                and the bubble's partials
#   partials.lift_bubble.hit     inside it, on a call that reuses the
#                                partials kept for its point set
#   partials.generic             core/deriv.py partials, the generic jvp
#                                engine's partials of one call
#   partials.generic.pass        inside it, one jvp pass: a pair_pass, a
#                                first_pass or a nested directional
#   b1.launch, b2.launch         kernels/mlp_taylor.py, kernels/taylor_vjp.py
#                                ``_launch``: a kernel's host path (B2's on
#                                autograd's device thread)
#   lbfgs.iter                   core/optim.py lbfgs_minimize, one iterate:
#                                two-loop, line search, history update
#   lbfgs.eval                   core/optim.py lbfgs_over_pytree, one
#                                loss-and-gradient evaluation
#   read.lbfgs.search,           host reads of a device scalar in the line
#   read.lbfgs.iter              search and in the iterate (``read``)
SPANS = ("adam.forward", "adam.backward", "adam.resample",
         "partials.lift_bubble", "partials.lift_bubble.hit", "b1.launch",
         "b2.launch", "lbfgs.iter", "lbfgs.eval", "read.lbfgs.search",
         "read.lbfgs.iter", "partials.generic", "partials.generic.pass")

_NULL = contextlib.nullcontext()
# set by torch.profiler while it runs, for every thread
_autograd_profiler = torch.autograd.profiler


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler runs (a
    range on the profiler's clock, in ``trace``'s Chrome trace), else a
    shared null context: one flag check.  ``name`` must be one of
    ``SPANS``; while profiling another name raises ValueError."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    if name not in SPANS:
        raise ValueError(f"span {name!r} is not one of {SPANS}")
    return torch.profiler.record_function(name)


def read(x, site: str) -> float:
    """``float(x)`` inside the span ``read.<site>``: a host read of a
    device value (the host waits for the card)."""
    with span("read." + site):
        return float(x)


def _cuda_ready() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _sync() -> None:
    if _cuda_ready():
        torch.cuda.synchronize()


def _cuda_leaf(out) -> bool:
    """Whether ``out`` (a tensor, or dicts, lists and tuples of them)
    holds a tensor on a card."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_cuda_leaf(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return any(_cuda_leaf(v) for v in out)
    return False


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the body: CPU operations and, with a card, its CUDA
    kernels; on exit the Chrome trace goes to ``logdir/trace.json``.
    Yields the profiler (``key_averages()``, ``events()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            try:
                yield prof
            finally:
                _sync()
    finally:
        prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Accumulates per-step times (seconds).

    >>> timer = StepTimer()
    >>> with timer.step():
    ...     timer.observe(train_step(...))

    With a card, a CUDA event is recorded on the current stream as the
    step starts; if the step observed a tensor on the card, another one
    is recorded as it ends, and the step's time is the time between the
    two (waiting for the second).  Otherwise the host clock times the
    step.
    """

    def __init__(self):
        self.times = []
        self._out = None

    @contextlib.contextmanager
    def step(self):
        start = None
        if _cuda_ready():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        yield self
        out, self._out = self._out, None
        if start is not None and _cuda_leaf(out):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            self.times.append(start.elapsed_time(end) / 1e3)
        else:
            self.times.append(time.perf_counter() - t0)

    def observe(self, out):
        """Register the step's output: a tensor on a card makes the step
        timed by CUDA events."""
        self._out = out
        return out

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def summary(self) -> str:
        if not self.times:
            return "no steps recorded"
        ts = sorted(self.times)
        p50 = ts[len(ts) // 2]
        return (f"steps={len(ts)} mean={self.mean*1e3:.2f}ms "
                f"p50={p50*1e3:.2f}ms max={ts[-1]*1e3:.2f}ms")


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 10):
    """(result, seconds per call): ``warmup`` untimed calls (a kernel
    builds at its first use; 0 where the caller has run ``fn``'s kernels
    already), then ``iters`` timed calls, the card synchronised before and
    after them.  tpinn makes at least one warm-up call (its compile)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync()
    return out, (time.perf_counter() - t0) / iters
