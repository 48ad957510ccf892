"""The readers of the program's spans (benchmark/harness/spans.py and the
eleven metrics that use it) on synthetic profiler events worked out by
hand: nested spans on two threads, partial spans at the stretch's edges,
and None where a span is absent."""

import pytest

from benchmark.harness import spans, spec

MS = 1_000_000  # ns

SPAN_METRICS = ("forward_ms.adam", "backward_ms.adam", "lift_bubble_ms.adam",
                "kernel_host_ms.adam", "resample_ms.adam",
                "lift_bubble_ms.lbfgs", "kernel_host_ms.lbfgs",
                "eval_ms.lbfgs", "search_ms.lbfgs", "evals_per_iter.lbfgs",
                "reads_per_eval.lbfgs")


def reader(name):
    return spec.load_module(spec.BENCH / "metrics" / f"{name}.py",
                            "test_spans_" + name.replace(".", "_"))


def host(name, start, end, thread=1):
    return ("host", name, thread, round(start * MS), round(end * MS))


# two Adam steps of 10 ms; thread 2 is autograd's device thread, whose B2
# launch overlaps a tensor op of the main thread; the stretch ends at 21 ms
ADAM = [
    host("adam.forward", 0, 3), host("partials.lift_bubble", 0.5, 2),
    host("b1.launch", 2, 2.5), host("aten::mul", 0.2, 0.4),
    host("adam.backward", 3, 7), host("b2.launch", 4, 5, thread=2),
    host("aten::sum", 4.5, 5.5, thread=2),
    host("partials.lift_bubble", 5, 6),
    host("adam.resample", 7.5, 9.5),
    host("adam.forward", 10, 12), host("partials.lift_bubble", 10.5, 11.5),
    host("b1.launch", 11.5, 11.75),
    host("adam.backward", 12, 15), host("b2.launch", 13, 13.5, thread=2),
    ("device", "taylor2_bwd_kernel", 0, 13 * MS, 20 * MS),
    ("runtime", "cudaDeviceSynchronize", 1, 15 * MS, 21 * MS),
]


def adam_ctx(events=ADAM, units=2):
    return {"events": events, "seconds": 0.021, "units": units}


def test_adam_readers_nested_spans_on_two_threads():
    # forward: 3 - (1.5 + 0.5) and 2 - (1 + 0.25); the tensor op is no span
    assert reader("forward_ms.adam").read(adam_ctx()) == pytest.approx(
        (1.0 + 0.75) / 2, rel=1e-12)
    # backward: 4 less the union of B2 on thread 2 (4-5) and the lift on
    # thread 1 (5-6), then 3 - 0.5
    assert reader("backward_ms.adam").read(adam_ctx()) == pytest.approx(
        (2.0 + 2.5) / 2, rel=1e-12)
    assert reader("lift_bubble_ms.adam").read(adam_ctx()) == pytest.approx(
        (1.5 + 1 + 1) / 2, rel=1e-12)
    assert reader("kernel_host_ms.adam").read(adam_ctx()) == pytest.approx(
        (0.5 + 1 + 0.25 + 0.5) / 2, rel=1e-12)
    assert reader("resample_ms.adam").read(adam_ctx()) == pytest.approx(
        2.0, rel=1e-12)


def test_self_time_takes_the_union_of_overlapping_inner_spans():
    outer = (0, 10 * MS, "lbfgs.eval")
    inner = [outer, (1 * MS, 4 * MS, "b2.launch"),
             (3 * MS, 5 * MS, "partials.lift_bubble"),
             (6 * MS, 7 * MS, "b1.launch"),
             # starts inside, ends outside: not inside
             (9 * MS, 11 * MS, "adam.forward")]
    assert spans.self_ns(inner, outer) == 10 * MS - (4 + 1) * MS


# an L-BFGS stretch: it opens inside an iterate's evaluation (that iterate
# and evaluation were never recorded: only their later reads are), holds
# two complete iterates, of one and two evaluations, and closes at 30 ms
# inside a third iterate's evaluation, which the profiler ends there
LBFGS = [
    host("partials.lift_bubble", 0.1, 0.6), host("b1.launch", 0.6, 0.7),
    host("b2.launch", 0.9, 1.0, thread=2),
    host("read.lbfgs.search", 1.1, 1.2), host("read.lbfgs.search", 1.2, 1.3),
    host("read.lbfgs.iter", 1.4, 1.5),
    # iterate 1: 2-8 ms, one evaluation at 3-6
    host("lbfgs.iter", 2, 8),
    host("read.lbfgs.iter", 2.1, 2.2), host("read.lbfgs.search", 2.2, 2.3),
    host("read.lbfgs.search", 2.3, 2.4),
    host("lbfgs.eval", 3, 6), host("partials.lift_bubble", 3.5, 4.5),
    host("b1.launch", 4.5, 4.75), host("b2.launch", 5, 5.5, thread=2),
    host("read.lbfgs.search", 6.1, 6.2), host("read.lbfgs.search", 6.2, 6.3),
    host("read.lbfgs.iter", 6.5, 6.6), host("read.lbfgs.iter", 6.6, 6.7),
    host("read.lbfgs.iter", 6.7, 6.8), host("read.lbfgs.iter", 6.8, 6.9),
    host("read.lbfgs.iter", 6.9, 7.0),
    # iterate 2: 10-20 ms, two evaluations
    host("lbfgs.iter", 10, 20),
    host("read.lbfgs.iter", 10.1, 10.2),
    host("read.lbfgs.search", 10.2, 10.3),
    host("read.lbfgs.search", 10.3, 10.4),
    host("lbfgs.eval", 11, 13), host("partials.lift_bubble", 11.5, 12),
    host("read.lbfgs.search", 13.1, 13.2),
    host("read.lbfgs.search", 13.2, 13.3),
    host("lbfgs.eval", 14, 18), host("b2.launch", 15, 16, thread=2),
    host("read.lbfgs.search", 18.1, 18.2),
    host("read.lbfgs.search", 18.2, 18.3),
    host("read.lbfgs.iter", 18.5, 18.6), host("read.lbfgs.iter", 18.6, 18.7),
    host("read.lbfgs.iter", 18.7, 18.8), host("read.lbfgs.iter", 18.8, 18.9),
    host("read.lbfgs.iter", 18.9, 19.0),
    # iterate 3, open at the stretch's end
    host("lbfgs.iter", 22, 30), host("read.lbfgs.iter", 22.1, 22.2),
    host("lbfgs.eval", 23, 30), host("partials.lift_bubble", 23.5, 24),
    ("runtime", "cudaStreamSynchronize", 1, 24 * MS, 29 * MS),
]


def lbfgs_ctx(events=LBFGS, units=4):
    return {"events": events, "seconds": 0.030, "units": units}


@pytest.mark.parametrize("name, expected", [
    # the evaluations that ran in the stretch: 0.5 + 1 + 0.5 + 0.5 ms
    ("lift_bubble_ms.lbfgs", (0.5 + 1 + 0.5 + 0.5) / 4),
    ("kernel_host_ms.lbfgs", (0.1 + 0.1 + 0.25 + 0.5 + 1) / 4),
    # the three complete evaluations: 3 - 1.75, 2 - 0.5, 4 - 1
    ("eval_ms.lbfgs", (1.25 + 1.5 + 3) / 3),
    # iterates 6 + 10 ms less evaluations 3 + 2 + 4 ms, over 3 evaluations
    ("search_ms.lbfgs", (16 - 9) / 3),
    ("evals_per_iter.lbfgs", 3 / 2),
    # reads inside the two iterates: 3 + 2 + 5, then 3 + 2 + 2 + 5
    ("reads_per_eval.lbfgs", 22 / 3),
])
def test_lbfgs_readers_leave_out_the_partial_edges(name, expected):
    assert reader(name).read(lbfgs_ctx()) == pytest.approx(expected,
                                                           rel=1e-12)


def test_partial_spans_are_those_ending_at_the_last_instant():
    complete = spans.program(LBFGS)
    assert ("lbfgs.iter" in {n for _, _, n in complete}
            and all(e < 30 * MS for _, e, _ in complete))
    assert len(spans.named(complete, "lbfgs.iter")) == 2
    assert len(spans.named(complete, "lbfgs.eval")) == 3


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_none_where_no_span_is_recorded(name):
    # a program without spans: operators, runtime calls and the card only
    bare = [e for e in ADAM + LBFGS if e[1] not in spans.NAMES]
    assert reader(name).read(adam_ctx(bare)) is None
    assert reader(name).read(adam_ctx([])) is None


@pytest.mark.parametrize("name", ["forward_ms.adam", "lift_bubble_ms.lbfgs",
                                  "kernel_host_ms.adam"])
def test_none_where_no_unit_was_traced(name):
    assert reader(name).read(adam_ctx(units=0)) is None


def test_absent_span_reads_none_beside_present_ones():
    no_resample = [e for e in ADAM if e[1] != "adam.resample"]
    assert reader("resample_ms.adam").read(adam_ctx(no_resample)) is None
    assert reader("forward_ms.adam").read(adam_ctx(no_resample)) is not None
    # L-BFGS readers on Adam spans, and Adam readers on L-BFGS spans
    for name in ("eval_ms.lbfgs", "search_ms.lbfgs", "evals_per_iter.lbfgs",
                 "reads_per_eval.lbfgs"):
        assert reader(name).read(adam_ctx()) is None
    assert reader("forward_ms.adam").read(lbfgs_ctx()) is None


def test_names_are_the_programs():
    from tpinn_torch.utils import profiling

    assert spans.NAMES == set(profiling.SPANS)


# every reader on one stretch of 18 ms that also holds operators, runtime
# calls and kernels (none of which is a program span): an Adam step in the
# first 10 ms, then an L-BFGS iterate; thread 2 is autograd's device thread
MIXED = [
    ("device", "void taylor2_fwd_kernel<5>(float const*)", 0, 0, 2 * MS),
    ("device", "void taylor2_bwd_kernel<5>(float const*)", 0, 3 * MS,
     5 * MS),
    ("runtime", "cudaMemcpy", 1, 17 * MS, 18 * MS),
    host("aten::mul", 2, 3.5), host("aten::linear", 6, 10),
    host("adam.forward", 0, 2.5), host("partials.lift_bubble", 0.5, 1.5),
    host("b1.launch", 1.5, 1.75),
    host("adam.backward", 2.5, 5.5), host("b2.launch", 3, 3.5, thread=2),
    host("adam.resample", 6.5, 7),
    # a read of an iterate that opened before the stretch
    host("read.lbfgs.search", 10.5, 10.6),
    host("lbfgs.iter", 11, 16),
    host("read.lbfgs.iter", 11, 11.25),
    host("read.lbfgs.search", 11.25, 11.5),
    host("read.lbfgs.search", 11.5, 11.75),
    host("lbfgs.eval", 12, 14), host("partials.lift_bubble", 12.25, 12.75),
    host("b1.launch", 12.75, 13), host("b2.launch", 13.25, 13.5, thread=2),
    host("read.lbfgs.search", 14, 14.25),
    host("read.lbfgs.search", 14.25, 14.5),
    host("read.lbfgs.iter", 14.5, 14.75), host("read.lbfgs.iter", 14.75, 15),
    host("read.lbfgs.iter", 15, 15.25), host("read.lbfgs.iter", 15.25, 15.5),
    # an iterate and its evaluation still open at the stretch's end (18 ms)
    host("lbfgs.iter", 16.5, 18), host("read.lbfgs.iter", 16.6, 16.7),
    host("lbfgs.eval", 17, 18),
]


@pytest.mark.parametrize("name, expected", [
    # adam.forward 2.5 ms less the lift/bubble 1 ms and B1's 0.25 ms
    ("forward_ms.adam", (2.5 - 1 - 0.25) / 2),
    # adam.backward 3 ms less B2's 0.5 ms on the other thread
    ("backward_ms.adam", (3 - 0.5) / 2),
    ("lift_bubble_ms.adam", (1 + 0.5) / 2),
    ("lift_bubble_ms.lbfgs", (1 + 0.5) / 2),
    ("kernel_host_ms.adam", (0.25 + 0.5 + 0.25 + 0.25) / 2),
    ("kernel_host_ms.lbfgs", (0.25 + 0.5 + 0.25 + 0.25) / 2),
    ("resample_ms.adam", 0.5),
    # the complete evaluation: 2 ms less 0.5 + 0.25 + 0.25 ms inside
    ("eval_ms.lbfgs", 2 - 1),
    # the complete iterate, 5 ms, less its evaluation, over one evaluation
    ("search_ms.lbfgs", (5 - 2) / 1),
    ("evals_per_iter.lbfgs", 1 / 1),
    ("reads_per_eval.lbfgs", 9 / 1),
])
def test_reader_among_operators_and_kernels(name, expected):
    ctx = {"events": MIXED, "seconds": 0.018, "units": 2}
    assert reader(name).read(ctx) == pytest.approx(expected, rel=1e-12)


def test_every_span_metric_is_checked_among_operators():
    checked = {p[0] for p in
               test_reader_among_operators_and_kernels.pytestmark[0].args[1]}
    assert checked == set(SPAN_METRICS)
