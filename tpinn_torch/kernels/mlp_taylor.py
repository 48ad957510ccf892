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
FLOP per point and hidden layer) and shared-memory reads; device traffic
is only the points in and [N, S] floats out.  The design keeps the S
streams of a (point, column) in registers so that each weight feeds S
FMAs and the activation algebra runs between layers without a round trip
to memory (details in the source).  Scope: the plain dense family, scalar
output, order ≤ 2, feature kinds minmax/periodic/identity.

``taylor2_streams`` launches the kernel for a CUDA tensor and runs the
plain version only for a CPU tensor; anything else, or a net outside the
kernel's scope, raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Sequence

import torch

from tpinn_torch.core import net as net_mod
from tpinn_torch.core import taylor
from tpinn_torch.core.net import FeatureMap, MLPSpec

# kernel launches since import (or since the caller last reset it)
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

# limits of csrc/taylor2_fwd.cu
MAX_LAYERS = 16
MAX_COORDS = 4
MAX_STREAMS = 10
MAX_FEATURES = 16
POINTS_PER_THREAD = 4
SMEM_LIMIT = 232_448          # bytes of shared memory one block may use
SMEM_TWO_BLOCKS = 113 * 1024  # a tile this size lets two blocks share an SM

_KIND_CODE = {net_mod.MINMAX: 0, net_mod.PERIODIC: 1, net_mod.IDENTITY: 2}
_ACT_CODE = {"tanh": 0, "sin": 1}

_ERRORS = {
    -1: "empty batch", -2: "unsupported coordinate count",
    -3: "unsupported layer count", -4: "unsupported stream count",
    -5: "tile size not a multiple of 4", -6: "bad layer widths",
    -7: "unsupported feature kind", -8: "bad stream plan",
    -9: "tile exceeds shared memory",
}


def tile_points(n_streams: int, widest: int) -> int:
    """Points per block: the largest tile whose double-buffered streams
    (2·S·TP·KS floats) let two blocks share an SM, else one block."""
    ks = (widest + 3) & ~3
    for budget in (SMEM_TWO_BLOCKS, SMEM_LIMIT):
        for tp in (64, 32, 16, 8, 4):
            if 2 * n_streams * tp * ks * 4 <= budget:
                return tp
    raise ValueError(f"width {widest} with {n_streams} streams exceeds the "
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
            and 2 * worst_s * POINTS_PER_THREAD * ((widest + 3) & ~3) * 4
            <= SMEM_LIMIT)


def _check(params: dict, z: torch.Tensor, spec: MLPSpec, fm: FeatureMap,
           streams: Sequence[tuple]) -> None:
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
    if not streams or tuple(streams[0]) != ():
        raise ValueError("the value stream () must come first")
    if len(set(map(tuple, streams))) != len(streams):
        raise ValueError("duplicate streams")
    firsts = {st for st in streams if len(st) == 1}
    for st in streams:
        if len(st) > 2:
            raise ValueError("kernel B1 handles order <= 2 only")
        if any(not 0 <= i < len(fm.kinds) for i in st) or tuple(sorted(st)) != tuple(st):
            raise ValueError(f"bad stream {st!r}")
        if len(st) == 2 and not {(st[0],), (st[1],)} <= firsts:
            raise ValueError(f"pair stream {st!r} needs its first-derivative "
                             f"streams")
    layers = params["layers"]
    din = fm.num_features
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
    if din != 1:
        raise ValueError("the last layer must have one output")


def taylor2_streams_reference(params: dict, z: torch.Tensor, spec: MLPSpec,
                              fm: FeatureMap, lb, ub, streams) -> torch.Tensor:
    """Plain PyTorch version of kernel B1 (the ``taylor2_mlp`` recurrence):
    [N, S] stream columns in the order of ``streams``."""
    lb = torch.as_tensor(lb, dtype=z.dtype, device=z.device)
    ub = torch.as_tensor(ub, dtype=z.dtype, device=z.device)
    parts = taylor.taylor2_mlp(params, z, spec, fm, lb, ub, streams)
    return torch.cat([parts[tuple(st)] for st in streams], dim=1)


def _launch(params: dict, z: torch.Tensor, spec: MLPSpec, fm: FeatureMap,
            lb, ub, streams) -> torch.Tensor:
    global LAUNCHES
    from tpinn_torch.kernels import _build

    lib = _build.load("taylor2_fwd")
    fn = lib.tpinn_taylor2_fwd
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pi, pf, pvp = (ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_void_p))
    fn.argtypes = [vp, ctypes.c_longlong, ci, pi, pf, pf, ci, ci, pvp, pvp, pi,
                   ci, pi, pi, pi, pi, pi, ci, ci, cf, cf, ci, vp, vp]
    fn.restype = ci

    layers = params["layers"]
    n, d = z.shape
    L, S = len(layers), len(streams)
    pos = {tuple(st): k for k, st in enumerate(streams)}
    kinds, ii, jj, ppi, ppj = [], [], [], [], []
    for st in streams:
        kinds.append(len(st))
        ii.append(st[0] if st else 0)
        jj.append(st[1] if len(st) == 2 else 0)
        ppi.append(pos[(st[0],)] if len(st) == 2 else 0)
        ppj.append(pos[(st[1],)] if len(st) == 2 else 0)
    dims = [fm.num_features] + [int(layer["w"].shape[1]) for layer in layers]
    tp = tile_points(S, max(dims[:-1]))

    def ints(v):
        return (ctypes.c_int * len(v))(*v)

    def floats(v):
        return (ctypes.c_float * len(v))(*v)

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])

    out = torch.empty((n, S), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = fn(z.data_ptr(), n, d, ints([_KIND_CODE[k] for k in fm.kinds]),
                 floats(lb), floats(ub), fm.pad_to, L,
                 ptrs([layer["w"] for layer in layers]),
                 ptrs([layer["b"] for layer in layers]), ints(dims), S,
                 ints(kinds), ints(ii), ints(jj), ints(ppi), ints(ppj),
                 _ACT_CODE[spec.act_first], _ACT_CODE[spec.act_hidden],
                 float(spec.scl), float(spec.epsil), tp, out.data_ptr(), stream)
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
    _check(params, z, spec, fm, streams)
    lb = [float(v) for v in lb]
    ub = [float(v) for v in ub]
    if z.device.type == "cpu":
        return taylor2_streams_reference(params, z, spec, fm, lb, ub, streams)
    if z.shape[0] == 0:
        return torch.empty((0, len(streams)), dtype=torch.float32,
                           device=z.device)
    return _launch(params, z, spec, fm, lb, ub, streams)


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
