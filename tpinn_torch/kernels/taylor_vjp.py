"""Kernel B2 and the differentiable Taylor-2 forward (B1 + B2).

Replaces the Pallas TPU kernel ``tpinn/kernels/taylor_vjp.py``
(``taylor2_backward_pallas``) and its ``custom_vjp`` pairing
(``make_kernel_partials``).  ``taylor2_backward`` returns ∂L/∂layers of a
plain dense net given the cotangent ``ct`` [N, S] of kernel B1's stream
columns: on a CUDA tensor it launches ``csrc/taylor2_bwd.cu`` (built by
``_build`` with nvcc for ``sm_90a``), on a CPU tensor it runs the plain
version ``taylor2_backward_reference``.  ``LAUNCHES`` counts kernel
launches.

Backward math (per hidden layer; φ', φ'', φ''' at the pre-activation x0):

    forward:  X = (H @ W)·scl₀,  x0 = X⁽⁾ + b
              H'⁽⁾ = φ(x0),  H'⁽ᵏ⁾ = φ'·X⁽ᵏ⁾,  H'⁽ⁱʲ⁾ = φ''·X⁽ⁱ⁾·X⁽ʲ⁾ + φ'·X⁽ⁱʲ⁾
    reverse:  ∂X⁽ⁱʲ⁾ = φ'·ct⁽ⁱʲ⁾
              ∂X⁽ᵏ⁾  = φ'·ct⁽ᵏ⁾ + Σ_{(i,j)∋k} φ''·X⁽other⁾·ct⁽ⁱʲ⁾
              ∂x0    = φ'·ct⁽⁾ + Σ_k φ''·X⁽ᵏ⁾·ct⁽ᵏ⁾
                       + Σ_ij (φ'''·X⁽ⁱ⁾·X⁽ʲ⁾ + φ''·X⁽ⁱʲ⁾)·ct⁽ⁱʲ⁾
              ∂b = Σ_points ∂x0,  ∂W = Hᵀ·(∂X·scl₀),  ∂H = (∂X·scl₀)·Wᵀ

Third derivatives:  tanh: (6a²−2)·(1−a²);  sin: −cos.

``kernel_partials`` wraps the pair as a ``torch.autograd.Function``:
forward = B1 (``mlp_taylor.taylor2_streams``), backward = B2.  Unlike the
TPU version, which returned a silent zero cotangent for the points, it
refuses points that require a gradient and defines no ``jvp``, so
``torch.func.jvp`` through it raises: the residual-gradient loss term
(``deriv_loss``) must take another engine (tpinn_torch.core.loss).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, NamedTuple, Sequence

import torch

from tpinn_torch.core import taylor
from tpinn_torch.core.net import FeatureMap, MLPSpec
from tpinn_torch.kernels import mlp_taylor
from tpinn_torch.utils.profiling import span

# kernel launches since import (or since the caller last reset it)
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

_ERRORS = dict(mlp_taylor._ERRORS)
_ERRORS[-10] = "bad grid or workspace size"
_ERRORS[-11] = "bad W chunk or accumulation mode"

# the kernel's block (csrc/taylor2_bwd.cu kThreads) and the tile sizes
# the plan may choose, largest first (multiples of 4 points)
THREADS = 416
TILE_POINTS = (20, 16, 12, 8, 4)


class Plan(NamedTuple):
    """How one call of kernel B2 is cut (``tiling``)."""
    tp: int             # points per tile
    blocks: int         # persistent blocks (at most one per SM)
    kc: int             # rows of a layer's W staged in shared memory at once
    accumulate: str     # "smem": dW/db summed on chip; "global": per tile
    smem_bytes: int     # shared memory of one block
    scratch_bytes: int  # device scratch of the call: partials, workspace, grad


def _r4(x: int) -> int:
    return (x + 3) & ~3


def _row_stride(widest: int) -> int:
    """Floats per row of the kernel's stream buffers: ``widest`` rounded up
    to a multiple of 4 that is 4 mod 8 (a warp's four rows hit distinct
    shared-memory banks)."""
    k = _r4(widest)
    return k if k & 7 else k + 4


def smem_bytes(dims: Sequence[int], n_streams: int, tp: int, kc: int,
               accumulate: str) -> int:
    """Shared memory of one block: [accumulator][two S·TP-row stream
    buffers][KC rows of W][TP rows of dx0] (csrc/taylor2_bwd.cu
    ``smem_bytes``)."""
    ks = _row_stride(max(dims[:-1]))
    n_params = sum(dims[l] * dims[l + 1] + dims[l + 1]
                   for l in range(len(dims) - 1))
    acc = _r4(n_params) if accumulate == "smem" else 0
    return 4 * (acc + 2 * n_streams * tp * ks + kc * ks + tp * ks)


def _ws_stride(dims: Sequence[int], n_streams: int, tp: int) -> int:
    """Workspace floats of one block: X of every hidden layer and H of all
    but the last, S·TP rows of round4(width) floats each."""
    hidden = [_r4(w) for w in dims[1:-1]]
    return n_streams * tp * (sum(hidden) + sum(hidden[:-1]))


def tiling(dims: Sequence[int], n_streams: int, n_points: int,
           n_sms: int = 132) -> Plan:
    """The plan of one B2 call, from the sizes alone.

    The gradient is summed in shared memory ("smem") where the
    accumulator, the stream buffers and the whole of a layer's W fit in
    one block's 232,448 bytes at some tile size, else added per tile into
    the block's row of partials in device memory ("global"), with W staged
    in chunks of at least 4 rows where the whole W does not fit.  Within
    the mode the tile is the largest that fits, and the grid the fewest
    blocks that take as few rounds of tiles as the SMs allow, so no block
    has more than one tile more than another."""
    return _tiling(tuple(int(v) for v in dims), int(n_streams),
                   int(n_points), int(n_sms))


@functools.lru_cache(maxsize=256)
def _tiling(dims, n_streams, n_points, n_sms) -> Plan:
    ks = _row_stride(max(dims[:-1]))
    k_max = _r4(max(dims[:-1]))
    n_params = sum(dims[l] * dims[l + 1] + dims[l + 1]
                   for l in range(len(dims) - 1))
    for accumulate in ("smem", "global"):
        for tp in TILE_POINTS:
            room = (mlp_taylor.SMEM_LIMIT
                    - smem_bytes(dims, n_streams, tp, 0, accumulate))
            kc = min(k_max, room // (4 * ks) // 4 * 4)
            if kc == k_max or (accumulate == "global" and kc >= 4):
                n_tiles = -(-max(1, n_points) // tp)
                rounds = -(-n_tiles // n_sms)
                blocks = -(-n_tiles // rounds)
                ws_stride = _ws_stride(dims, n_streams, tp)
                return Plan(tp, blocks, kc, accumulate,
                            smem_bytes(dims, n_streams, tp, kc, accumulate),
                            4 * (blocks * (n_params + ws_stride) + n_params))
    raise ValueError(f"widths {dims} with {n_streams} streams exceed the "
                     f"backward kernel's shared memory")


def _act3(name: str, x0, a, d1):
    """Third derivative of the activation."""
    if name == "tanh":
        return (6.0 * a * a - 2.0) * d1
    return -torch.cos(x0)


def taylor2_backward_reference(layers: Sequence[dict], z: torch.Tensor,
                               ct: torch.Tensor, spec: MLPSpec,
                               fm: FeatureMap, lb, ub, streams) -> List[dict]:
    """Plain PyTorch version of kernel B2: the closed-form reverse sweep of
    ``tpinn/kernels/taylor_vjp.py::_make_bwd_kernel`` (recompute the
    forward stacks, then push the cotangent through φ', φ'', φ''').  Not
    autograd, so it is an oracle independent of autograd through
    ``taylor.taylor2_mlp``."""
    streams = [tuple(st) for st in streams]
    pos = {st: k for k, st in enumerate(streams)}
    S = len(streams)
    firsts = [st for st in streams if len(st) == 1]
    pairs = [st for st in streams if len(st) == 2]
    lb = torch.as_tensor(lb, dtype=z.dtype, device=z.device)
    ub = torch.as_tensor(ub, dtype=z.dtype, device=z.device)
    n_layers = len(layers)

    # ---- forward recompute: per-layer input stacks H and pre-activations X
    H = taylor.feature_streams(fm, z, lb, ub, streams)      # [S, N, nf]
    Hs, Xs = [], []
    for li, layer in enumerate(layers):
        Hs.append(H)
        X = torch.matmul(H, layer["w"])
        if li == 0:
            X = X * spec.scl
        Xs.append(X)
        if li == n_layers - 1:
            break
        name = spec.act_first if li == 0 else spec.act_hidden
        a, d1, d2 = taylor._act_derivs(name, X[0] + layer["b"])
        new = [a]
        for st in streams[1:]:
            if len(st) == 1:
                new.append(d1 * X[pos[st]])
            else:
                i, j = st
                new.append(d2 * X[pos[(i,)]] * X[pos[(j,)]] + d1 * X[pos[st]])
        H = torch.stack(new, dim=0)

    # ---- reverse sweep
    grads: List[dict] = [None] * n_layers
    dX = (ct * spec.epsil).t().unsqueeze(-1)                # [S, N, 1]
    li = n_layers - 1
    scl_here = spec.scl if li == 0 else 1.0
    db = dX[0].sum(dim=0)                 # the bias adds after the scl scale
    dXraw = dX * scl_here
    grads[li] = {"w": torch.einsum("snk,snc->kc", Hs[li], dXraw), "b": db}
    dH = torch.matmul(dXraw, layers[li]["w"].t())
    for li in range(n_layers - 2, -1, -1):
        X = Xs[li]
        name = spec.act_first if li == 0 else spec.act_hidden
        x0 = X[0] + layers[li]["b"]
        a, d1, d2 = taylor._act_derivs(name, x0)
        d3 = _act3(name, x0, a, d1)
        c = list(dH.unbind(0))
        dx0 = c[0] * d1
        parts = [None] * S
        for st in firsts:
            dx0 = dx0 + c[pos[st]] * d2 * X[pos[st]]
            parts[pos[st]] = c[pos[st]] * d1
        for st in pairs:
            i, j = st
            cs = c[pos[st]]
            Xi, Xj = X[pos[(i,)]], X[pos[(j,)]]
            dx0 = dx0 + cs * (d3 * Xi * Xj + d2 * X[pos[st]])
            # i == j hits the same slot twice -> 2·φ''·X_i, as required
            parts[pos[(i,)]] = parts[pos[(i,)]] + cs * d2 * Xj
            parts[pos[(j,)]] = parts[pos[(j,)]] + cs * d2 * Xi
            parts[pos[st]] = cs * d1
        parts[0] = dx0
        scl_here = spec.scl if li == 0 else 1.0
        dXraw = torch.stack(parts, dim=0) * scl_here
        grads[li] = {"w": torch.einsum("snk,snc->kc", Hs[li], dXraw),
                     "b": dx0.sum(dim=0)}
        if li > 0:
            dH = torch.matmul(dXraw, layers[li]["w"].t())
    return grads


def _kernel_fn(lib):
    """The library's entry point with its argument types set."""
    fn = lib.tpinn_taylor2_bwd
    vp, ci, cf, cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
    pi, pf, pvp = (ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_void_p))
    fn.argtypes = [vp, cll, ci, pi, pf, pf, ci, ci, pvp, pvp, pi, ci, pi, pi,
                   pi, pi, pi, ci, ci, cf, cf, ci, ci, ci, vp, ci, vp, cll, vp,
                   vp, vp]
    fn.restype = ci
    return fn


def _ints(v):
    return (ctypes.c_int * len(v))(*v)


@functools.lru_cache(maxsize=64)
def _static_args(dims, streams, kinds, pad_to, act_first, act_hidden, scl,
                 epsil, lb, ub, n, sms):
    """(plan, ws_stride, n_params, the call's arguments that depend on the
    sizes and the net's structure only), built once per shape: the
    ctypes arrays cost more host time than the launch."""
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
    ws_stride = _ws_stride(dims, S, plan.tp)
    n_params = sum(dims[l] * dims[l + 1] + dims[l + 1] for l in range(L))
    head = (len(lb), _ints([mlp_taylor._KIND_CODE[k] for k in kinds]),
            (ctypes.c_float * len(lb))(*lb), (ctypes.c_float * len(ub))(*ub),
            pad_to, L)
    mid = (_ints(dims), S, _ints(st_kind), _ints(ii), _ints(jj), _ints(ppi),
           _ints(ppj), mlp_taylor._ACT_CODE[act_first],
           mlp_taylor._ACT_CODE[act_hidden], scl, epsil, plan.tp, plan.kc,
           int(plan.accumulate == "smem"))
    return plan, ws_stride, n_params, head, mid


def _launch(layers, z, ct, spec, fm, lb, ub, streams) -> List[dict]:
    global LAUNCHES
    with span("b2.launch"):
        from tpinn_torch.kernels import _build

        lib = _build.load("taylor2_bwd")
        fn = lib.tpinn_taylor2_bwd if lib.tpinn_taylor2_bwd.argtypes else \
            _kernel_fn(lib)

        n = z.shape[0]
        dims = [fm.num_features] + [int(layer["w"].shape[1])
                                    for layer in layers]
        sms = torch.cuda.get_device_properties(z.device).multi_processor_count
        plan, ws_stride, n_params, head, mid = _static_args(
            tuple(dims), tuple(tuple(st) for st in streams), tuple(fm.kinds),
            fm.pad_to, spec.act_first, spec.act_hidden, float(spec.scl),
            float(spec.epsil), tuple(lb), tuple(ub), n, sms)
        L = len(layers)

        def ptrs(ts):
            return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])

        grad = torch.empty(n_params, dtype=torch.float32, device=z.device)
        # every block zeroes and writes its own row
        partial = torch.empty((plan.blocks, n_params), dtype=torch.float32,
                              device=z.device)
        workspace = torch.empty(max(1, plan.blocks * ws_stride),
                                dtype=torch.float32, device=z.device)
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream(z.device).cuda_stream
            err = fn(z.data_ptr(), n, *head,
                     ptrs([layer["w"] for layer in layers]),
                     ptrs([layer["b"] for layer in layers]), *mid,
                     ct.data_ptr(),
                     plan.blocks, workspace.data_ptr(), ws_stride,
                     partial.data_ptr(), grad.data_ptr(), stream)
        if err != 0:
            what = _ERRORS.get(err) or f"CUDA error {err}"
            raise RuntimeError(f"taylor2_bwd launch failed: {what}")
        with _COUNT_LOCK:
            LAUNCHES += 1
        grads, off = [], 0
        for l in range(L):
            w_n = dims[l] * dims[l + 1]
            grads.append({"w": grad[off:off + w_n].view(dims[l], dims[l + 1]),
                          "b": grad[off + w_n:off + w_n + dims[l + 1]]})
            off += w_n + dims[l + 1]
        return grads


def taylor2_backward(layers: Sequence[dict], z: torch.Tensor, ct: torch.Tensor,
                     spec: MLPSpec, fm: FeatureMap, lb, ub,
                     streams) -> List[dict]:
    """∂L/∂layers (a list of {"w", "b"}) given the cotangent ``ct`` [N, S]
    on kernel B1's stream columns, summed over the N points.

    A CUDA tensor launches kernel B2; a CPU tensor runs the plain version.
    The checks are B1's; anything outside the kernels' scope raises."""
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kernel B2 runs on CUDA (plain version on CPU), "
                         f"not on {z.device}")
    streams = [tuple(st) for st in streams]
    layers = list(layers)
    mlp_taylor._check({"layers": layers}, z, spec, fm, streams)
    if ct.shape != (z.shape[0], len(streams)) or ct.dtype != torch.float32 \
            or ct.device != z.device:
        raise ValueError(f"ct must be float32 [{z.shape[0]}, {len(streams)}] "
                         f"on {z.device}, got {ct.dtype} {tuple(ct.shape)} "
                         f"on {ct.device}")
    lb = [float(v) for v in lb]
    ub = [float(v) for v in ub]
    if z.device.type == "cpu":
        return taylor2_backward_reference(layers, z, ct, spec, fm, lb, ub,
                                          streams)
    if z.shape[0] == 0:
        return [{"w": torch.zeros_like(l["w"]), "b": torch.zeros_like(l["b"])}
                for l in layers]
    return _launch(layers, z, ct.contiguous(), spec, fm, lb, ub, streams)


class _Taylor2Streams(torch.autograd.Function):
    """B1 forward, B2 backward; gradients for the layer tensors only."""

    @staticmethod
    def forward(ctx, z, meta, *leaves):
        spec, fm, lb, ub, streams = meta
        layers = [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                  for i in range(len(leaves) // 2)]
        ctx.meta = meta
        ctx.save_for_backward(z, *leaves)
        return mlp_taylor.taylor2_streams({"layers": layers}, z, spec, fm,
                                          lb, ub, streams)

    @staticmethod
    def backward(ctx, ct):
        spec, fm, lb, ub, streams = ctx.meta
        z, *leaves = ctx.saved_tensors
        layers = [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                  for i in range(len(leaves) // 2)]
        grads = taylor2_backward(layers, z, ct.contiguous(), spec, fm, lb, ub,
                                 streams)
        return (None, None) + tuple(g for layer in grads
                                    for g in (layer["w"], layer["b"]))


def kernel_streams(params: dict, z: torch.Tensor, spec: MLPSpec,
                   fm: FeatureMap, lb, ub, streams) -> torch.Tensor:
    """[N, S] stream columns from kernel B1, differentiable in the layer
    tensors through kernel B2.  Points that require a gradient raise: the
    kernels produce no cotangent for them."""
    if z.requires_grad:
        raise ValueError("the Taylor-2 kernels give no gradient for the "
                         "points (z.requires_grad is set); use the generic "
                         "engine to differentiate in z")
    leaves = [t for layer in params["layers"] for t in (layer["w"], layer["b"])]
    meta = (spec, fm, tuple(float(v) for v in lb), tuple(float(v) for v in ub),
            [tuple(st) for st in streams])
    return _Taylor2Streams.apply(z, meta, *leaves)


def kernel_partials(params: dict, z: torch.Tensor, spec: MLPSpec,
                    fm: FeatureMap, lb, ub, indices):
    """{multi-index: [N, 1]} u-partials from kernels B1/B2, laid out as
    ``taylor.taylor2_mlp`` (the full planned stream set)."""
    streams = taylor.plan_streams(indices)
    out = kernel_streams(params, z, spec, fm, lb, ub, streams)
    return {st: out[:, k : k + 1] for k, st in enumerate(streams)}


def make_kernel_partials(spec: MLPSpec, fm: FeatureMap, lb, ub, indices):
    """``partials(params, z, indices) -> dict`` whose forward is kernel B1
    and whose backward is kernel B2 (port of ``tpinn.kernels.taylor_vjp.
    make_kernel_partials``; the plain versions stand in on the CPU).
    Plain dense family, scalar output, order ≤ 2."""
    if not spec.is_plain:
        raise ValueError("the Taylor-2 kernels support the plain dense family")
    lb = [float(v) for v in lb]
    ub = [float(v) for v in ub]
    indices = tuple(indices)

    def partials(params, z, indices_req):
        return kernel_partials(params, z, spec, fm, lb, ub, indices)

    return partials
