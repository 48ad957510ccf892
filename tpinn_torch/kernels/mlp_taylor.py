"""Kernel B1: fused MLP value + first/second derivative evaluation.

Replaces the Pallas TPU kernel ``tpinn/kernels/mlp_taylor.py``
(``taylor2_streams_pallas``).  One CUDA kernel
(``csrc/taylor2_fwd.cu``, built by ``_build`` with nvcc for ``sm_90a``)
evaluates, for a tile of points, the Taylor-2 stream set (u, u_i, u_ij —
the ingredients of any second-order residual) through the whole dense
chain without touching device memory between layers.  It implements the
recurrence of ``tpinn_torch.core.taylor.taylor2_mlp`` — the same math and
stream plan — and that function is its plain version here.

What bounds it on the card: fp32 FMAs on the CUDA cores (about 2·S·W²
FLOP per point and hidden layer) and the shared-memory reads that feed
them; device traffic is only the points in, the weights once per block
and [N, S] floats out.  The design: a persistent grid of at most one
block per SM walking tiles of points; the weights staged in shared
memory by cp.async (the whole net once per block where it fits); each
layer's product register-tiled, a lane pair owning one point's S streams
× 8 columns (a thread 4 columns at S > 7), with the Taylor-2 activation —
and, after the last hidden layer, the output layer — as its epilogue
(details in the source).
``tiling`` plans each call from the sizes alone.  Scope: the plain dense
family, scalar output, order ≤ 2, feature kinds minmax/periodic/identity.

``taylor2_streams`` launches the kernel for a CUDA tensor and runs the
plain version only for a CPU tensor; anything else, or a net outside the
kernel's scope, raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, NamedTuple, Sequence

import torch

from tpinn_torch.core import net as net_mod
from tpinn_torch.core import taylor
from tpinn_torch.core.net import FeatureMap, MLPSpec
from tpinn_torch.utils.profiling import span

# kernel launches since import (or since the caller last reset it)
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

# limits of csrc/taylor2_fwd.cu
MAX_LAYERS = 16
MAX_COORDS = 4
MAX_STREAMS = 10
MAX_FEATURES = 16
SMEM_LIMIT = 232_448          # bytes of shared memory one block may use
# the kernel's largest block (kMaxThreads) and the tile sizes the plan
# may choose, largest first (multiples of 4 points)
THREADS = 512
TILE_POINTS = (32, 28, 24, 20, 16, 12, 8, 4)
# where the kernel reads the weights from, by its code
W_MODES = {"resident": 0, "layer": 1, "l1": 2}

_KIND_CODE = {net_mod.MINMAX: 0, net_mod.PERIODIC: 1, net_mod.IDENTITY: 2}
_ACT_CODE = {"tanh": 0, "sin": 1}

_ERRORS = {
    -1: "empty batch", -2: "unsupported coordinate count",
    -3: "unsupported layer count", -4: "unsupported stream count",
    -5: "tile size not a multiple of 4", -6: "bad layer widths",
    -7: "unsupported feature kind", -8: "bad stream plan",
    -9: "tile exceeds shared memory", -10: "bad grid or block size",
    -11: "bad W mode or rows", -12: "bad row stride",
}


class Plan(NamedTuple):
    """How one call of kernel B1 is cut (``tiling``)."""
    tp: int           # points per tile
    blocks: int       # persistent blocks (at most one per SM)
    threads: int      # threads per block
    w_mode: str       # "resident", "layer" or "l1" (see ``tiling``)
    kc: int           # rows of W staged at once: the whole net's when
                      # resident, a layer's or a chunk of it, 0 for l1
    ks: int           # floats per row of the stream buffers and staged W
    smem_bytes: int   # shared memory of one block


def _r4(x: int) -> int:
    return (x + 3) & ~3


def _row_stride(widest: int) -> int:
    """``widest`` rounded up to a multiple of 8 floats (staged W is read up
    to 8 columns at a time), plus 4: a stride of 4 mod 8, so a warp's rows
    hit distinct shared-memory banks."""
    return ((widest + 7) & ~7) + 4


def threads_per_point(width: int, n_streams: int) -> int:
    """Threads for one point of a layer ``width`` wide: a lane pair per 8
    columns up to S = 7, a thread per 4 columns beyond
    (csrc/taylor2_fwd.cu ``threads_per_point``)."""
    if n_streams <= 7:
        return 2 * ((width + 7) // 8)
    return (width + 3) // 4


def smem_bytes(n_streams: int, tp: int, kc: int, ks: int) -> int:
    """Shared memory of one block: [KC rows of W][two S·TP-row stream
    buffers], rows of KS floats (csrc/taylor2_fwd.cu ``smem_bytes``)."""
    return 4 * ks * (kc + 2 * n_streams * tp)


def tiling(dims: Sequence[int], n_streams: int, n_points: int,
           n_sms: int = 132) -> Plan:
    """The plan of one B1 call, from the sizes alone.

    The tile is the largest of at most 32 points whose threads (a lane
    pair per 8 columns of the widest hidden layer and point, a thread per
    4 columns at S > 7) fill no more than one round of the block's 512 (4
    points where even those take more), and whose two stream buffers fit
    in one block's 232,448 bytes.  At that tile the weights are
    "resident" (every hidden layer's W staged once per block) where they
    fit beside the buffers, else staged per "layer" (in chunks of at least
    4 rows where the whole does not fit), else read through "l1" (the
    widest nets, where the buffers alone nearly fill the block; there the
    row stride drops its bank padding where it must).  The grid is the
    fewest blocks that take as few rounds of tiles as the SMs allow, and
    the block the fewest warps that hold a tile's threads."""
    return _tiling(tuple(int(v) for v in dims), int(n_streams),
                   int(n_points), int(n_sms))


@functools.lru_cache(maxsize=256)
def _tiling(dims, n_streams, n_points, n_sms) -> Plan:
    widest = max(dims[:-1])
    hidden_in = dims[:-2]                  # inputs of the hidden layers
    k_max = _r4(max(hidden_in)) if hidden_in else 0
    resident_rows = sum(_r4(k) for k in hidden_in)
    per_point = (threads_per_point(max(dims[1:-1]), n_streams)
                 if len(dims) > 2 else 1)
    tp_cap = max(TILE_POINTS[-1], THREADS // per_point // 4 * 4)
    for tp in (t for t in TILE_POINTS if t <= tp_cap):
        for mode, ks in (("resident", _row_stride(widest)),
                         ("layer", _row_stride(widest)),
                         ("l1", _row_stride(widest)), ("l1", _r4(widest))):
            room = SMEM_LIMIT - smem_bytes(n_streams, tp, 0, ks)
            if mode == "resident":
                kc = resident_rows
            elif mode == "layer":
                kc = min(k_max, room // (4 * ks) // 4 * 4)
                if kc < 4:
                    continue
            else:
                kc = 0
            if smem_bytes(n_streams, tp, kc, ks) > SMEM_LIMIT:
                continue
            n_tiles = -(-max(1, n_points) // tp)
            rounds = -(-n_tiles // n_sms)
            blocks = -(-n_tiles // rounds)
            threads = min(THREADS, -(-tp * per_point // 32) * 32)
            return Plan(tp, blocks, threads, mode, kc, ks,
                        smem_bytes(n_streams, tp, kc, ks))
    raise ValueError(f"widths {dims} with {n_streams} streams exceed the "
                     f"kernel's shared memory")


def supports(spec: MLPSpec, fm: FeatureMap) -> bool:
    """Whether kernel B1 takes this net (for any order-≤2 stream plan of
    its coordinates)."""
    if not (spec.is_plain and spec.out_dim == 1):
        return False
    if any(k not in _KIND_CODE for k in fm.kinds):
        return False
    d = len(fm.kinds)
    worst_s = 1 + d + d * (d + 1) // 2
    if d > MAX_COORDS or worst_s > MAX_STREAMS:
        return False
    widest = max(spec.width, fm.num_features)
    return (spec.depth + 1 <= MAX_LAYERS and fm.num_features <= MAX_FEATURES
            and 2 * worst_s * TILE_POINTS[-1] * _r4(widest) * 4 <= SMEM_LIMIT)


@functools.lru_cache(maxsize=256)
def _check_streams(streams: tuple, d: int) -> None:
    """Raises for a stream plan kernel B1 does not take (a function of the
    plan alone, so its verdict is cached)."""
    if not streams or streams[0] != ():
        raise ValueError("the value stream () must come first")
    if len(set(streams)) != len(streams):
        raise ValueError("duplicate streams")
    firsts = {st for st in streams if len(st) == 1}
    for st in streams:
        if len(st) > 2:
            raise ValueError("kernel B1 handles order <= 2 only")
        if any(not 0 <= i < d for i in st) or tuple(sorted(st)) != st:
            raise ValueError(f"bad stream {st!r}")
        if len(st) == 2 and not {(st[0],), (st[1],)} <= firsts:
            raise ValueError(f"pair stream {st!r} needs its first-derivative "
                             f"streams")


def _check(params: dict, z: torch.Tensor, spec: MLPSpec, fm: FeatureMap,
           streams: Sequence[tuple]) -> list:
    """Raises for arguments kernel B1 does not take; returns the layer
    widths [features, hidden..., 1]."""
    if not spec.is_plain:
        raise ValueError("kernel B1 supports the plain dense family")
    if spec.out_dim != 1:
        raise ValueError("kernel B1 assumes scalar output (out_dim == 1)")
    for k in fm.kinds:
        if k not in _KIND_CODE:
            raise ValueError(f"kernel B1 does not build streams for feature "
                             f"kind {k!r}")
    if z.dim() != 2 or z.shape[1] != len(fm.kinds):
        raise ValueError(f"z must be [N, {len(fm.kinds)}], got {tuple(z.shape)}")
    if z.dtype != torch.float32:
        raise TypeError(f"kernel B1 computes in float32, got {z.dtype}")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")
    _check_streams(tuple(map(tuple, streams)), len(fm.kinds))
    layers = params["layers"]
    din = fm.num_features
    dims = [din]
    for li, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        for t in (w, b):
            if t.device != z.device or t.dtype != torch.float32:
                raise ValueError(f"layer {li} must be float32 on {z.device}")
            if not t.is_contiguous():
                raise ValueError(f"layer {li} weights must be contiguous")
        if w.dim() != 2 or w.shape[0] != din or b.shape != (w.shape[1],):
            raise ValueError(f"layer {li} has shape {tuple(w.shape)}, "
                             f"expected [{din}, *] with a matching bias")
        din = w.shape[1]
        dims.append(din)
    if din != 1:
        raise ValueError("the last layer must have one output")
    return dims


def taylor2_streams_reference(params: dict, z: torch.Tensor, spec: MLPSpec,
                              fm: FeatureMap, lb, ub, streams) -> torch.Tensor:
    """Plain PyTorch version of kernel B1 (the ``taylor2_mlp`` recurrence):
    [N, S] stream columns in the order of ``streams``."""
    lb = torch.as_tensor(lb, dtype=z.dtype, device=z.device)
    ub = torch.as_tensor(ub, dtype=z.dtype, device=z.device)
    parts = taylor.taylor2_mlp(params, z, spec, fm, lb, ub, streams)
    return torch.cat([parts[tuple(st)] for st in streams], dim=1)


def _kernel_fn(lib):
    """The library's entry point with its argument types set."""
    fn = lib.tpinn_taylor2_fwd
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pi, pf, pvp = (ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_void_p))
    fn.argtypes = [vp, ctypes.c_longlong, ci, pi, pf, pf, ci, ci, pvp, pvp, pi,
                   ci, pi, pi, pi, pi, pi, ci, ci, cf, cf, ci, ci, ci, ci, ci,
                   ci, vp, vp]
    fn.restype = ci
    return fn


def _ints(v):
    return (ctypes.c_int * len(v))(*v)


@functools.lru_cache(maxsize=64)
def _static_args(dims, streams, kinds, pad_to, act_first, act_hidden, scl,
                 epsil, lb, ub, n, sms):
    """(the call's arguments that depend on the sizes and the net's
    structure only), built once per shape: the ctypes arrays cost more
    host time than the launch."""
    L, S = len(dims) - 1, len(streams)
    pos = {st: k for k, st in enumerate(streams)}
    st_kind, ii, jj, ppi, ppj = [], [], [], [], []
    for st in streams:
        st_kind.append(len(st))
        ii.append(st[0] if st else 0)
        jj.append(st[1] if len(st) == 2 else 0)
        ppi.append(pos[(st[0],)] if len(st) == 2 else 0)
        ppj.append(pos[(st[1],)] if len(st) == 2 else 0)
    plan = tiling(dims, S, n, sms)
    head = (len(lb), _ints([_KIND_CODE[k] for k in kinds]),
            (ctypes.c_float * len(lb))(*lb), (ctypes.c_float * len(ub))(*ub),
            pad_to, L)
    mid = (_ints(dims), S, _ints(st_kind), _ints(ii), _ints(jj), _ints(ppi),
           _ints(ppj), _ACT_CODE[act_first], _ACT_CODE[act_hidden], scl,
           epsil, plan.tp, plan.blocks, plan.threads, W_MODES[plan.w_mode],
           plan.kc, plan.ks)
    return head, mid


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(params: dict, z: torch.Tensor, spec: MLPSpec, fm: FeatureMap,
            lb, ub, streams, dims) -> torch.Tensor:
    global LAUNCHES
    with span("b1.launch"):
        from tpinn_torch.kernels import _build

        lib = _build.load("taylor2_fwd")
        fn = lib.tpinn_taylor2_fwd if lib.tpinn_taylor2_fwd.argtypes else \
            _kernel_fn(lib)

        layers = params["layers"]
        n = z.shape[0]
        sms = _sm_count(z.device.index)
        head, mid = _static_args(
            tuple(dims), tuple(tuple(st) for st in streams), tuple(fm.kinds),
            fm.pad_to, spec.act_first, spec.act_hidden, float(spec.scl),
            float(spec.epsil), tuple(lb), tuple(ub), n, sms)

        def ptrs(ts):
            return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])

        out = torch.empty((n, len(streams)), dtype=torch.float32,
                          device=z.device)
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream(z.device).cuda_stream
            err = fn(z.data_ptr(), n, *head,
                     ptrs([layer["w"] for layer in layers]),
                     ptrs([layer["b"] for layer in layers]), *mid,
                     out.data_ptr(), stream)
        if err != 0:
            what = _ERRORS.get(err) or f"CUDA error {err}"
            raise RuntimeError(f"taylor2_fwd launch failed: {what}")
        with _COUNT_LOCK:
            LAUNCHES += 1
        return out


def taylor2_streams(params: dict, z: torch.Tensor, spec: MLPSpec,
                    fm: FeatureMap, lb, ub, streams) -> torch.Tensor:
    """Fused Taylor-2 forward: [N, S] stream columns (order = ``streams``).

    ``lb``/``ub`` are the feature-map bounds as host floats (or tensors).
    A CUDA tensor launches kernel B1; a CPU tensor runs the plain version.
    Anything outside the kernel's scope raises; there is no fallback."""
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kernel B1 runs on CUDA (plain version on CPU), "
                         f"not on {z.device}")
    streams = [tuple(st) for st in streams]
    dims = _check(params, z, spec, fm, streams)
    lb = [float(v) for v in lb]
    ub = [float(v) for v in ub]
    if z.device.type == "cpu":
        return taylor2_streams_reference(params, z, spec, fm, lb, ub, streams)
    if z.shape[0] == 0:
        return torch.empty((0, len(streams)), dtype=torch.float32,
                           device=z.device)
    return _launch(params, z, spec, fm, lb, ub, streams, dims)


def taylor2_mlp_kernel(params: dict, z: torch.Tensor, spec: MLPSpec,
                       fm: FeatureMap, lb, ub, indices):
    """{multi-index: [N, 1]} u-derivative columns from kernel B1, laid out
    as ``tpinn_torch.core.taylor.taylor2_mlp`` (out_dim must be 1)."""
    streams = taylor.plan_streams(indices)
    out = taylor2_streams(params, z, spec, fm, lb, ub, streams)
    return {st: out[:, k : k + 1] for k, st in enumerate(streams)}


def residual_kernel_fn(predictor, compiled) -> Callable:
    """``f(params, z) -> residual`` with the u-partials of a plain
    predictor (net.make_predictor) from kernel B1."""
    spec = predictor.tpinn_spec
    fm = predictor.tpinn_feature_map
    lb, ub = (t.tolist() for t in predictor.tpinn_bounds)

    def fn(params, z):
        parts = taylor2_mlp_kernel(params, z, spec, fm, lb, ub,
                                   compiled.indices)
        return compiled.evaluate(z, parts)

    return fn
