"""Arithmetic shared by the per-layer readers (``metrics/<name>.py``).

Each reader takes the traced run's context: ``events`` (harness.trace's
tuples over the traced stretch), ``seconds`` (its length on the host's
clock), ``units`` (steps or evaluations in it), ``calls`` ({kernel: [(work
arguments, calls)]}), ``work`` ({kernel: module}), ``window_units`` and
``window_s`` (the untraced window before it), ``unit_flops`` and ``peaks``.
A reader that finds nothing to read returns None.
"""

from __future__ import annotations

from benchmark.harness import trace


def roofline_pct(ctx, kernel: str):
    """The least time the kernel's work in the stretch needs (per call the
    larger of operations over the TF32 peak and bytes over the memory
    bandwidth) over its summed device time, in percent; None where it did
    not run or its launches are not the calls counted."""
    mod = ctx["work"][kernel]
    launches, ns = trace.kernel_ns(ctx["events"], mod.KERNELS)
    expected = sum(c for _, c in ctx["calls"][kernel])
    if ns <= 0 or launches != expected:
        return None
    peaks = ctx["peaks"]
    least = 0.0
    for args, count in ctx["calls"][kernel]:
        n_bytes, n_ops = mod.work(*args)
        least += count * max(n_ops / peaks["tf32_flop_per_s"],
                             n_bytes / peaks["hbm_byte_per_s"])
    return 100.0 * least / (ns / 1e9)


def host_busy_ms(ctx):
    """The host's time per unit outside calls that wait for the card."""
    if ctx["units"] <= 0:
        return None
    busy = ctx["seconds"] - trace.wait_ns(ctx["events"]) / 1e9
    return 1e3 * busy / ctx["units"]


def launches_per_unit(ctx):
    n = len(trace.device(ctx["events"]))
    return n / ctx["units"] if n and ctx["units"] > 0 else None


def idle_pct(ctx):
    """The stretch's share in which no operation ran on the card, not
    clipped: a reading below 0 shows device intervals counted beyond the
    stretch."""
    busy = trace.busy_ns(ctx["events"]) / 1e9
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx["seconds"])


def mfu_pct(ctx):
    """The model's operations per unit times the untraced window's units,
    over its length and the card's TF32 peak."""
    if ctx["window_units"] <= 0:
        return None
    rate = ctx["unit_flops"] * ctx["window_units"] / ctx["window_s"]
    return 100.0 * rate / ctx["peaks"]["tf32_flop_per_s"]


def nccl_ms_per_unit(ctx):
    ns = sum(e - s for kind, name, _, s, e in ctx["events"]
             if kind == "device" and "nccl" in name.lower())
    if ns <= 0 or ctx["units"] <= 0:
        return None
    return ns / 1e6 / ctx["units"]
