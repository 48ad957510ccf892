"""The readers of the lift-and-bubble reuse share (lift_bubble_hit_pct.adam,
lift_bubble_hit_pct.lbfgs) on synthetic profiler events: 0 without hit
spans, the share of calls with a hit span inside them, and None without a
complete partials.lift_bubble span."""

import pytest

from benchmark.harness import spec

MS = 1_000_000  # ns
READERS = ("lift_bubble_hit_pct.adam", "lift_bubble_hit_pct.lbfgs")


def reader(name):
    return spec.load_module(spec.BENCH / "metrics" / f"{name}.py",
                            "test_hit_" + name.replace(".", "_"))


def host(name, start, end, thread=1):
    return ("host", name, thread, round(start * MS), round(end * MS))


def stretch(n_calls, n_hits):
    """``n_calls`` lift-and-bubble calls 1 ms apart, a hit span inside each
    of the last ``n_hits``, operators and a kernel around them; the stretch
    ends at a wait after the last call."""
    events = []
    for i in range(n_calls):
        events.append(host("partials.lift_bubble", i, i + 0.5))
        if i >= n_calls - n_hits:
            events.append(host("partials.lift_bubble.hit", i + 0.1, i + 0.2))
        else:
            events.append(host("aten::mul", i + 0.1, i + 0.4))
    events.append(("device", "taylor2_bwd_kernel", 0, 0, n_calls * MS))
    events.append(("runtime", "cudaDeviceSynchronize", 1, n_calls * MS,
                   (n_calls + 1) * MS))
    return {"events": events, "seconds": (n_calls + 1) / 1e3,
            "units": n_calls}


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("n_calls, n_hits, expected", [
    (100, 0, 0.0), (100, 99, 99.0), (40, 40, 100.0), (3, 1, 100.0 / 3)])
def test_share_of_calls_with_a_hit(name, n_calls, n_hits, expected):
    assert reader(name).read(stretch(n_calls, n_hits)) == pytest.approx(
        expected, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_complete_call(name):
    bare = [e for e in stretch(10, 5)["events"]
            if e[1] != "partials.lift_bubble"]
    assert reader(name).read({"events": bare, "units": 10}) is None
    assert reader(name).read({"events": [], "units": 0}) is None
    # the one call still open when the stretch stops is partial
    open_call = [host("partials.lift_bubble", 0, 2),
                 host("partials.lift_bubble.hit", 0.5, 1),
                 host("aten::add", 1, 2)]
    assert reader(name).read({"events": open_call, "units": 1}) is None


@pytest.mark.parametrize("name", READERS)
def test_hits_count_only_inside_a_complete_call_on_their_thread(name):
    ctx = stretch(4, 4)
    # a hit whose call began before the stretch, and one on another thread
    ctx["events"] += [host("partials.lift_bubble.hit", 0.1, 0.2, thread=2),
                      host("partials.lift_bubble.hit", 4.6, 4.7)]
    assert reader(name).read(ctx) == pytest.approx(100.0, rel=1e-12)
