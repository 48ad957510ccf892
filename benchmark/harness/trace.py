"""The traced stretch: ``torch.profiler`` over CPU and CUDA, its events kept
in memory and reduced to plain tuples that the metric readers take.

An event is ``(kind, name, thread, start_ns, end_ns)`` with ``kind`` one
of "device" (a kernel, copy or set on the card), "runtime" (a CUDA runtime
or driver call on the host), "host" (an operator or annotation on the
host) and "mark" (an annotation the profiler mirrors onto the card's
timeline, such as ``nccl:all_reduce`` around NCCL's kernel: no operation
of its own).  Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Dict, Iterable, List, Sequence, Tuple

Event = Tuple[str, str, int, int, int]

# a CUDA runtime or driver call by its name, where the activity type does
# not say so (it does not in every build of the profiler)
RUNTIME = re.compile(r"cu(da)?[A-Z]")
# annotations of torch.distributed's NCCL calls, which the profiler mirrors
# onto the card's timeline with the kernel's own interval
MARKS = ("nccl:",)

# runtime calls in which the host waits for the card, by exact name
WAIT_CALLS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize", "cuMemcpyDtoH", "cuMemcpyDtoH_v2"))
# an asynchronous copy waits only where it reads the card back into
# pageable memory: then the card's copy ends inside the call
ASYNC_COPY = "cudaMemcpyAsync"
READ_BACK = "Memcpy DtoH"


class Stretch:
    """A profiled stretch: ``start()`` and ``stop()`` at points where the
    card has drained (the caller synchronises); ``events`` and ``seconds``
    after ``stop()``."""

    def __init__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self.events: List[Event] = []
        self.seconds = 0.0

    def start(self):
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self._t0
        self._prof.stop()
        self.events = convert(self._prof.profiler.kineto_results.events())
        self._prof = None


def convert(raw: Iterable) -> List[Event]:
    """Kineto's events as :data:`Event` tuples."""
    out = []
    for e in raw:
        dev = str(e.device_type())
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        name = str(e.name())
        act = str(e.activity_type()).lower() if hasattr(
            e, "activity_type") else ""
        mark = ("annotation" in act or name.startswith(MARKS)
                or bool(getattr(e, "is_user_annotation", bool)()))
        if "cuda" in dev.lower() and "cpu" not in dev.lower():
            kind = "mark" if mark else "device"
        elif "runtime" in act or "driver" in act or RUNTIME.match(name):
            kind = "runtime"
        else:
            kind = "host"
        out.append((kind, name, int(e.start_thread_id()), start, end))
    return out


def merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of ``[start, end)`` intervals, sorted and disjoint."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in merge(intervals))


def device(events: Sequence[Event]) -> List[Event]:
    return [e for e in events if e[0] == "device"]


def kernel_ns(events: Sequence[Event], names: Sequence[str]) -> Tuple[int,
                                                                    int]:
    """``(launches of names[0], summed device ns of every name)``: a
    kernel's name matches where it contains one of ``names``."""
    n, total = 0, 0
    for kind, name, _, s, e in events:
        if kind != "device":
            continue
        if names[0] in name:
            n += 1
        if any(k in name for k in names):
            total += e - s
    return n, total


def busy_ns(events: Sequence[Event]) -> int:
    """The time in which some operation ran on the card."""
    return covered_ns((s, e) for _, _, _, s, e in device(events))


def wait_ns(events: Sequence[Event]) -> int:
    """The time in which the host waited for the card (any thread): the
    waiting calls, and each asynchronous copy in which a copy from the
    card ends."""
    ends = sorted(e for k, n, _, _, e in events
                  if k == "device" and n.startswith(READ_BACK))
    waits = []
    for k, n, _, s, e in events:
        if k != "runtime":
            continue
        if n in WAIT_CALLS:
            waits.append((s, e))
        elif n == ASYNC_COPY:
            i = bisect.bisect_left(ends, s)
            if i < len(ends) and ends[i] <= e:
                waits.append((s, e))
    return covered_ns(waits)


def device_ops(events: Sequence[Event], top: int = 10) -> List[list]:
    """The device operations that took most time: ``[[name, seconds],
    ...]`` summed by name."""
    by: Dict[str, int] = {}
    for _, name, _, s, e in device(events):
        by[name] = by.get(name, 0) + (e - s)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:200], ns / 1e9] for name, ns in rows]


def idle_gaps(events: Sequence[Event], top: int = 10) -> List[list]:
    """The longest gaps between device operations, each named by what the
    host was doing in its middle: the innermost host operator (or runtime
    call) that spans it, ``host`` where none does."""
    busy = merge((s, e) for _, _, _, s, e in device(events))
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])
                   if b[0] > a[1]), reverse=True)[:top]
    hosts = [(s, e, n) for k, n, _, s, e in events
             if k in ("host", "runtime")]
    out = []
    for length, s, e in gaps:
        mid = (s + e) // 2
        spans = [(he - hs, n) for hs, he, n in hosts if hs <= mid <= he]
        name = min(spans)[1] if spans else "host"
        out.append([name[:200], length / 1e9])
    return out
