"""Kernel B3: fused Adam update on the flattened parameter vector.

Replaces the Pallas TPU kernel ``tpinn/kernels/adam.py``
(``adam_update_flat``).  One CUDA kernel (``csrc/adam.cu``, built by
``_build`` with nvcc for ``sm_90a``) performs the whole optax-Adam
recurrence — moment updates, bias correction, parameter step — in one
grid-stride pass over the flat parameter/moment vectors.  The learning
rate is a 1-element device tensor read by pointer, so the plateau halving
of the Adam phase changes it on the device without a host sync; the
1-based step is a host int, which the loop knows anyway.

``adam_update_flat`` launches the kernel for CUDA tensors and runs the
plain version ``adam_update_reference`` (the same recurrence in torch
ops) for CPU tensors; anything else raises.  ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

# kernel launches since import (or since the caller last reset it)
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

BLOCKS_PER_SM = 8
_THREADS = 256


def _constants(b1: float, b2: float, step: int):
    """float32 (1 − β₁, 1 − β₂, 1 − β₁ᵗ, 1 − β₂ᵗ), as optax forms them
    with its hyperparameters injected as float32 arrays (the Adam phase of
    ``tpinn.core.optim``): every difference is taken in float32 from the
    float32 decay."""
    f32 = np.float32
    one, fb1, fb2 = f32(1.0), f32(b1), f32(b2)
    with np.errstate(under="ignore"):
        bc1 = one - np.power(fb1, f32(step))
        bc2 = one - np.power(fb2, f32(step))
    return one - fb1, one - fb2, f32(bc1), f32(bc2)


def _check(g, p, m, v, lr, step):
    if step < 1:
        raise ValueError(f"step is 1-based (the count after this update), "
                         f"got {step}")
    # the kernel computes in float32; the plain version also takes float64
    dtypes = (torch.float32,) if p.device.type == "cuda" else (
        torch.float32, torch.float64)
    if p.dtype not in dtypes:
        raise TypeError(f"kernel B3 computes in float32, got {p.dtype}")
    for name, t in (("g", g), ("p", p), ("m", m), ("v", v)):
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor, got "
                             f"{tuple(t.shape)}")
        if t.shape != p.shape or t.device != p.device or t.dtype != p.dtype:
            raise ValueError(f"{name} must match p: {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
    if lr.shape != (1,) or lr.dtype != p.dtype or lr.device != p.device:
        raise ValueError(f"lr must be a 1-element {p.dtype} tensor on "
                         f"{p.device}, got {lr.dtype} {tuple(lr.shape)} on "
                         f"{lr.device}")


def adam_update_reference(g, p, m, v, lr, step: int, b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8):
    """Plain PyTorch version of kernel B3 (same operations, same order,
    in place on p, m and v).  Returns (p, m, v)."""
    c1, c2, bc1, bc2 = _constants(b1, b2, step)
    with torch.no_grad():
        m.copy_(float(c1) * g + float(np.float32(b1)) * m)
        v.copy_(float(c2) * (g * g) + float(np.float32(b2)) * v)
        upd = (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + eps)
        p.sub_(lr * upd)
    return p, m, v


def _launch(g, p, m, v, lr, step, b1, b2, eps):
    global LAUNCHES
    from tpinn_torch.kernels import _build

    lib = _build.load("adam")
    fn = lib.tpinn_adam_update
    vp, cf = ctypes.c_void_p, ctypes.c_float
    fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, cf, cf, cf, cf, cf,
                   cf, cf, ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    c1, c2, bc1, bc2 = _constants(b1, b2, step)
    n = p.shape[0]
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    blocks = max(1, min(-(-n // _THREADS), sms * BLOCKS_PER_SM))
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
                 lr.data_ptr(), n, float(np.float32(b1)), float(np.float32(b2)),
                 float(c1), float(c2), float(np.float32(eps)), float(bc1),
                 float(bc2), blocks, stream)
    if err != 0:
        raise RuntimeError(f"adam_update launch failed: error {err}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return p, m, v


def adam_update_flat(g, p, m, v, lr, step: int, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8):
    """One fused Adam step on 1-D vectors, IN PLACE on ``p``, ``m`` and
    ``v`` (returned as ``(p, m, v)``).  ``lr`` is a 1-element tensor of the
    vectors' dtype on their device; ``step`` is 1-based (the count AFTER
    this update, as optax counts).  The kernel takes float32; the plain
    version also float64.

    CUDA tensors launch kernel B3; CPU tensors run the plain version."""
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kernel B3 runs on CUDA (plain version on CPU), "
                         f"not on {p.device}")
    step = int(step)
    _check(g, p, m, v, lr, step)
    if p.device.type == "cpu":
        return adam_update_reference(g, p, m, v, lr, step, b1, b2, eps)
    if p.shape[0] == 0:
        return p, m, v
    return _launch(g, p, m, v, lr, step, b1, b2, eps)
