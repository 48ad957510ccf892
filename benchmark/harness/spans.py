"""The program's own spans in a traced stretch: the arithmetic shared by the
per-layer readers that read them (``metrics/<name>.py``).

tpinn_torch opens a span (``tpinn_torch.utils.profiling.span``) only while
a profiler runs, as a ``record_function`` range: a "host" event of
harness.trace on the profiler's clock.  A span already open when the
stretch starts is never recorded (the spans inside it are); one still open
when it stops is closed by the profiler at the stretch's last instant, the
latest end of any event, and is left out here as partial.  Every span
below is complete.  A program without spans reads None throughout.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from benchmark.harness.trace import Event, covered_ns

# the names tpinn_torch.utils.profiling.SPANS documents
NAMES = frozenset((
    "adam.forward", "adam.backward", "adam.resample", "partials.lift_bubble",
    "b1.launch", "b2.launch", "lbfgs.iter", "lbfgs.eval",
    "read.lbfgs.search", "read.lbfgs.iter"))
READ = "read."

Span = Tuple[int, int, str]       # (start_ns, end_ns, name)


def program(events: Sequence[Event]) -> List[Span]:
    """The complete program spans, any thread, in order of start."""
    if not events:
        return []
    last = max(e for _, _, _, _, e in events)
    return sorted((s, e, n) for k, n, _, s, e in events
                  if k == "host" and n in NAMES and e < last)


def named(spans: Sequence[Span], *names: str) -> List[Span]:
    return [sp for sp in spans if sp[2] in names]


def inside(spans: Sequence[Span], outer: Span) -> List[Span]:
    """The spans other than ``outer`` that start and end inside it."""
    return [sp for sp in spans if sp is not outer
            and outer[0] <= sp[0] and sp[1] <= outer[1]]


def self_ns(spans: Sequence[Span], outer: Span) -> int:
    """``outer``'s interval less the union of the spans inside it."""
    return (outer[1] - outer[0]) - covered_ns(
        (s, e) for s, e, _ in inside(spans, outer))


def total_ns(spans: Sequence[Span]) -> int:
    return sum(e - s for s, e, _ in spans)


def ms_per_unit(ctx, ns: int):
    """``ns`` in ms per step or evaluation; None where nothing was read."""
    if ns <= 0 or ctx["units"] <= 0:
        return None
    return ns / 1e6 / ctx["units"]


def time_per_unit(ctx, *names: str):
    """The time of the spans ``names`` per unit, in ms."""
    return ms_per_unit(ctx, total_ns(named(program(ctx["events"]), *names)))


def self_per_unit(ctx, name: str):
    """The self time of the spans ``name`` per unit, in ms."""
    spans = program(ctx["events"])
    return ms_per_unit(ctx, sum(self_ns(spans, sp)
                                for sp in named(spans, name)))


def mean_ms(values: Sequence[int]):
    return sum(values) / len(values) / 1e6 if values else None


def mean_duration_ms(ctx, name: str):
    return mean_ms([e - s for s, e, _ in named(program(ctx["events"]),
                                               name)])


def mean_self_ms(ctx, name: str):
    spans = program(ctx["events"])
    return mean_ms([self_ns(spans, sp) for sp in named(spans, name)])


def iterates(ctx):
    """Over the complete ``lbfgs.iter`` spans: (their number, their time,
    the ``lbfgs.eval`` spans inside them, the ``read.`` spans inside
    them)."""
    spans = program(ctx["events"])
    iters = named(spans, "lbfgs.iter")
    evals, reads = [], []
    for it in iters:
        within = inside(spans, it)
        evals += named(within, "lbfgs.eval")
        reads += [sp for sp in within if sp[2].startswith(READ)]
    return len(iters), total_ns(iters), evals, reads


def search_ms(ctx):
    """The complete iterates' time less their evaluations, per evaluation
    inside them: the optimizer's own host work and its reads' waits."""
    _, ns, evals, _ = iterates(ctx)
    if not evals:
        return None
    return (ns - total_ns(evals)) / 1e6 / len(evals)


def evals_per_iter(ctx):
    n, _, evals, _ = iterates(ctx)
    return len(evals) / n if evals else None


def reads_per_eval(ctx):
    _, _, evals, reads = iterates(ctx)
    return len(reads) / len(evals) if evals else None
