"""Each per-layer reader of benchmark/metrics on a small synthetic list of
profiler events, against values worked out by hand."""

import json

import pytest

from benchmark.harness import spec, trace
from benchmark.work import b1, b2

MS = 1_000_000  # ns

# two steps of 10 ms each on the host's clock: B1 2 ms and B2 (its kernel
# and its sum) 3 ms a step, one NCCL kernel of 0.5 ms, a copy of 0.5 ms
# overlapping B2's sum; the host waits 4 ms in all
EVENTS = [
    ("device", "void taylor2_fwd_kernel<5>(float const*)", 0, 0 * MS, 2 * MS),
    ("device", "void taylor2_bwd_kernel<5>(float const*)", 0, 3 * MS, 5 * MS),
    ("device", "sum_partials(float const*, int)", 0, 5 * MS, 6 * MS),
    ("device", "Memcpy DtoH (Device -> Pinned)", 0, 5 * MS + MS // 2,
     6 * MS + MS // 2),
    ("device", "void taylor2_fwd_kernel<5>(float const*)", 0, 10 * MS,
     12 * MS),
    ("device", "void taylor2_bwd_kernel<5>(float const*)", 0, 13 * MS,
     15 * MS),
    ("device", "sum_partials(float const*, int)", 0, 15 * MS, 16 * MS),
    ("device", "ncclDevKernel_AllReduce_Sum_f32", 0, 16 * MS,
     16 * MS + MS // 2),
    # the profiler's mirror of NCCL's annotation: no operation of its own
    ("mark", "nccl:all_reduce", 0, 16 * MS, 16 * MS + MS // 2),
    ("runtime", "cudaStreamSynchronize", 1, 6 * MS, 9 * MS),
    ("runtime", "cudaLaunchKernel", 1, 9 * MS, 10 * MS),
    ("runtime", "cudaMemcpy", 1, 17 * MS, 18 * MS),
    ("host", "aten::mul", 1, 2 * MS, 3 * MS + MS // 2),
    ("host", "aten::linear", 1, 6 * MS, 10 * MS),
]
PEAKS = {"tf32_flop_per_s": 495e12, "fp32_flop_per_s": 67e12,
         "hbm_byte_per_s": 3.35e12}
SHAPE = (184_000, 6, 80, 3, 2, 5)


def ctx(events=EVENTS):
    return {"events": events, "seconds": 0.020, "units": 2,
            "calls": {"b1": [(SHAPE, 2), ((12_321, 6, 80, 3, 2, 5), 0)],
                      "b2": [(SHAPE, 2)]},
            "work": {"b1": b1, "b2": b2}, "window_units": 400,
            "window_s": 10.0, "unit_flops": 1e11, "peaks": PEAKS}


def reader(name):
    return spec.load_module(spec.BENCH / "metrics" / f"{name}.py",
                            "test_" + name.replace(".", "_"))


def least(mod):
    n_bytes, n_ops = mod.work(*SHAPE)
    return 2 * max(n_ops / 495e12, n_bytes / 3.35e12)


@pytest.mark.parametrize("name, expected", [
    ("host_busy_ms.adam", (20 - 4) / 2),
    ("host_busy_ms.lbfgs", (20 - 4) / 2),
    ("launches_per_step.adam", 8 / 2),
    ("launches_per_eval.lbfgs", 8 / 2),
    ("b1_roofline.adam", 100 * least(b1) / 0.004),
    ("b1_roofline.lbfgs", 100 * least(b1) / 0.004),
    ("b2_roofline.adam", 100 * least(b2) / 0.006),
    ("b2_roofline.lbfgs", 100 * least(b2) / 0.006),
    ("adam_step_mfu_pct", 100 * 1e11 * 400 / 10.0 / 495e12),
    ("lbfgs_eval_mfu_pct", 100 * 1e11 * 400 / 10.0 / 495e12),
    # busy: [0,2] [3,6.5] [10,12] [13,16.5] = 11 ms of 20
    ("device_idle_pct.adam", 100 * (1 - 11 / 20)),
    ("device_idle_pct.lbfgs", 100 * (1 - 11 / 20)),
    ("nccl_ms_per_step.adam", 0.5 / 2),
])
def test_reader(name, expected):
    assert reader(name).read(ctx()) == pytest.approx(expected, rel=1e-12)


def test_every_per_layer_metric_has_a_reader_checked_here():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for pending in (spec.BENCH / "pending").glob("*.json"):
        bench = spec.with_pending(bench, pending.stem)
    names = {m["name"] for m in bench["per_layer"]}
    checked = {p[0] for p in test_reader.pytestmark[0].args[1]}
    assert names == checked


@pytest.mark.parametrize("name", ["b1_roofline.adam", "b2_roofline.lbfgs",
                                  "nccl_ms_per_step.adam",
                                  "device_idle_pct.adam",
                                  "launches_per_step.adam"])
def test_reader_finds_nothing_returns_none(name):
    host_only = [e for e in EVENTS if e[0] != "device"]
    assert reader(name).read(ctx(host_only)) is None


def test_idle_share_is_not_clipped():
    # device intervals that outlast the stretch read below 0
    c = ctx()
    c["seconds"] = 0.010
    assert reader("device_idle_pct.adam").read(c) == pytest.approx(
        100 * (1 - 11 / 10), rel=1e-12)


@pytest.mark.parametrize("name, device_copy, waits", [
    ("cudaMemcpyAsync", "Memcpy DtoH (Device -> Pageable)", True),
    ("cudaMemcpyAsync", "Memcpy HtoD (Pageable -> Device)", False),
    ("cudaMemcpyAsync", None, False),
    ("cudaMemcpy2DAsync", "Memcpy DtoH (Device -> Pageable)", False),
    ("cudaMemcpyToSymbol", None, False),
    ("cudaMemcpy", None, True),
    ("cuMemcpyDtoH_v2", None, True),
    ("cudaStreamSynchronize", None, True),
])
def test_waits_by_exact_name(name, device_copy, waits):
    # a 2 ms runtime call; the card's copy, where there is one, ends inside
    events = [("runtime", name, 1, 30 * MS, 32 * MS)]
    if device_copy:
        events.append(("device", device_copy, 0, 29 * MS, 31 * MS))
    assert trace.wait_ns(events) == (2 * MS if waits else 0)


def test_roofline_is_none_where_launches_are_not_the_calls_counted():
    c = ctx()
    c["calls"]["b1"] = [(SHAPE, 3)]
    assert reader("b1_roofline.adam").read(c) is None


def test_breakdown():
    ops = trace.device_ops(EVENTS)
    assert ops[0][0].startswith("void taylor2_fwd_kernel")
    assert ops[0][1] == pytest.approx(0.004)
    gaps = trace.idle_gaps(EVENTS)
    # the longest gap, 6.5-10 ms, is named by the innermost host call
    # spanning its middle (8.25 ms): the synchronise
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(0.0035)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)


class _Raw:
    def __init__(self, dev, act, name):
        self._dev, self._act, self._name = dev, act, name

    def device_type(self):
        return self._dev

    def activity_type(self):
        return self._act

    def name(self):
        return self._name

    def start_ns(self):
        return 10

    def duration_ns(self):
        return 5

    def start_thread_id(self):
        return 1


def test_convert_classifies_kineto_events():
    raw = [_Raw("DeviceType.CUDA", "kernel", "taylor2_fwd_kernel"),
           _Raw("DeviceType.CUDA", "gpu_memcpy", "Memcpy DtoH"),
           _Raw("DeviceType.CUDA", "gpu_user_annotation", "nccl:all_reduce"),
           # the same mirror where the activity type does not say so
           _Raw("DeviceType.CUDA", "kernel", "nccl:all_reduce"),
           _Raw("DeviceType.CPU", "cuda_runtime", "cudaLaunchKernel"),
           # runtime and driver calls where the activity type does not
           # say so
           _Raw("DeviceType.CPU", "", "cudaStreamSynchronize"),
           _Raw("DeviceType.CPU", "cpu_op", "cuMemcpyDtoH_v2"),
           _Raw("DeviceType.CPU", "cpu_op", "aten::mul"),
           _Raw("DeviceType.CPU", "cpu_op", "cudnn_convolution")]
    assert [e[0] for e in trace.convert(raw)] == [
        "device", "device", "mark", "mark", "runtime", "runtime", "runtime",
        "host", "host"]
    assert trace.convert(raw)[0][3:] == (10, 15)
