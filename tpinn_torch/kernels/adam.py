"""Kernel B3: fused Adam update on the flattened parameter vector.

Replaces the Pallas TPU kernel ``tpinn/kernels/adam.py``
(``adam_update_flat``).  One CUDA kernel (``csrc/adam.cu``, built by
``_build`` with nvcc for ``sm_90a``) performs the whole optax-Adam
recurrence — moment updates, bias correction, parameter step — in one
pass over the flat parameter/moment vectors.

``FusedAdam`` is the launcher of one parameter vector for one Adam phase.
It checks the vectors once, and keeps the per-step state on the device:
the learning rate (a 1-element tensor the plateau rule halves in place)
and, in a slot per block that the kernel advances after each update, the
1-based step t with its bias corrections, read from a float32 table (one
row per step of the phase, formed once from ``_constants``).  Every
launch argument but the gradient's pointer is therefore fixed, built
once, and a CUDA graph can replay ``step``.  ``step(g)`` checks g and
makes one ctypes call on PyTorch's current stream.  On CPU tensors the
same object runs the plain version ``adam_update_reference`` with its
host step; a CUDA tensor launches the kernel or raises.

``adam_update_flat`` is the one-call form (the step given by the caller)
that ``tpinn.kernels.adam.adam_update_flat`` has; it launches the same
kernel through a one-step launcher, which it builds on every call: a
slow path for tests and comparisons, not for a training loop.
``LAUNCHES`` counts kernel launches made by ``step`` (not a graph's
capture, which launches nothing, nor its replays, which bypass ``step``).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

# kernel launches since import (or since the caller last reset it)
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

# the most elements a vector may have (the kernel's indices are 32-bit)
MAX_N = 1 << 30


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


def bias_table(b1: float, b2: float, start: int, steps: int) -> np.ndarray:
    """float32 ``[steps, 2]``: row k holds (1 − β₁ᵗ, 1 − β₂ᵗ) for t =
    start + k, each from ``_constants`` (so bitwise the plain version's
    values, also where β₁ᵗ underflows)."""
    table = np.empty((steps, 2), np.float32)
    for k in range(steps):
        table[k] = _constants(b1, b2, start + k)[2:]
    return table


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


class _Args(ctypes.Structure):
    """``AdamArgs`` of csrc/adam.cu, field for field."""
    _fields_ = [("p", ctypes.c_void_p), ("m", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("lr", ctypes.c_void_p),
                ("bc", ctypes.c_void_p), ("state", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("b1", ctypes.c_float),
                ("b2", ctypes.c_float), ("one_minus_b1", ctypes.c_float),
                ("one_minus_b2", ctypes.c_float), ("eps", ctypes.c_float),
                ("t_first", ctypes.c_int), ("steps", ctypes.c_int),
                ("blocks", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _library():
    """The library, its entry points' argument types set once (and the
    struct's size held against the kernel's)."""
    from tpinn_torch.kernels import _build

    lib = _build.load("adam")
    size = lib.tpinn_adam_args_size
    size.argtypes, size.restype = [], ctypes.c_int
    if size() != ctypes.sizeof(_Args):
        raise RuntimeError(f"csrc/adam.cu's AdamArgs has {size()} bytes, the "
                           f"wrapper's {ctypes.sizeof(_Args)}")
    lib.tpinn_adam_blocks.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.tpinn_adam_blocks.restype = ctypes.c_int
    lib.tpinn_adam_step.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p,
                                    ctypes.c_void_p]
    lib.tpinn_adam_step.restype = ctypes.c_int
    return lib


def _check_state(p, m, v, lr):
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kernel B3 runs on CUDA (plain version on CPU), "
                         f"not on {p.device}")
    # the kernel computes in float32; the plain version also takes float64
    dtypes = (torch.float32,) if p.device.type == "cuda" else (
        torch.float32, torch.float64)
    if p.dtype not in dtypes:
        raise TypeError(f"kernel B3 computes in float32, got {p.dtype}")
    for name, t in (("p", p), ("m", m), ("v", v)):
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


class FusedAdam:
    """Kernel B3's launcher for one parameter vector through one Adam
    phase: ``steps`` updates, IN PLACE on ``p``, ``m`` and ``v``, the first
    of them step ``start`` (1-based, the count AFTER the update, as optax
    counts).  ``lr`` is a 1-element tensor of p's dtype on its device, read
    at every update.  The kernel takes float32; the plain version, which
    runs for CPU tensors, also float64.

    The launcher keeps references to p, m, v and lr: their storage must
    not move while it is in use.  ``step`` launches on PyTorch's current
    stream, so a CUDA graph that captures it replays the update and the
    step count advances on the device at every replay (``t`` reads it).
    A capture neither moves the host's count nor adds to ``LAUNCHES``;
    once a launcher has been captured, ``step`` outside a capture reads
    the device's count (a sync) before it launches.  A launch at a step
    past the table (a replay too many) updates nothing and flags the
    device's count, and ``t`` raises on the flag.
    """

    def __init__(self, p, m, v, lr, steps: int, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, start: int = 1):
        _check_state(p, m, v, lr)
        steps, start = int(steps), int(start)
        if steps < 0 or start < 1:
            raise ValueError(f"steps must be >= 0 and start (1-based) >= 1, "
                             f"got {steps}, {start}")
        self.p, self.m, self.v, self.lr = p, m, v, lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self._next = start               # the host's count: t of the next step
        self._end = start + steps
        self._shape, self._dtype, self._device = p.shape, p.dtype, p.device
        self._fn = None
        self._captured = False
        if p.device.type != "cuda" or p.numel() == 0 or steps == 0:
            return
        self._index = p.device.index
        n = p.numel()
        if n > MAX_N:
            raise ValueError(f"kernel B3 takes at most {MAX_N} elements, got "
                             f"{n}")
        lib = _library()
        grid = lib.tpinn_adam_blocks(n, self._index)
        if grid < 1:
            raise RuntimeError(f"kernel B3's grid for cuda:{self._index}: "
                               f"error {-grid}")
        # one row past the last step: the kernel reads the next row ahead
        table = bias_table(b1, b2, start, steps + 1)
        self._bc = torch.from_numpy(table).to(p.device)
        # a slot per block: {t, bc1, bc2 (float32 bits), flag}
        slot = np.array([start, *table[0].view(np.int32), 0], np.int32)
        self._state = torch.from_numpy(np.tile(slot, (grid, 1))).to(p.device)
        c1, c2, _, _ = _constants(b1, b2, start)
        f32 = np.float32
        self._args = _Args(p.data_ptr(), m.data_ptr(), v.data_ptr(),
                           lr.data_ptr(), self._bc.data_ptr(),
                           self._state.data_ptr(), n, float(f32(b1)),
                           float(f32(b2)), float(c1), float(c2),
                           float(f32(eps)), start, steps, grid)
        self._args_ptr = ctypes.pointer(self._args)
        self._fn = lib.tpinn_adam_step

    @property
    def t(self) -> int:
        """The 1-based step the next update takes: on the device for a
        launching vector (a sync; graph replays advance it too; every
        block's slot must hold it, and none may be flagged), else the
        host's count."""
        if self._fn is None:
            return self._next
        state = self._state.cpu()
        lo, hi = int(state[:, 0].min()), int(state[:, 0].max())
        if lo != hi:
            raise RuntimeError(f"kernel B3's blocks hold steps {lo} to {hi}")
        if bool(state[:, 3].any()):
            raise RuntimeError(f"kernel B3 was launched at step {lo}, past "
                               f"the last step this launcher was built for "
                               f"({self._end - 1}): those launches updated "
                               f"nothing")
        return lo

    def step(self, g):
        """One Adam update with gradient ``g`` (contiguous, p's shape, dtype
        and device).  Returns (p, m, v)."""
        global LAUNCHES
        if (g.shape != self._shape or g.dtype != self._dtype
                or g.device != self._device or not g.is_contiguous()):
            raise ValueError(f"g must be a contiguous 1-D {self._dtype} "
                             f"tensor of {tuple(self._shape)} on "
                             f"{self._device}, got {g.dtype} "
                             f"{tuple(g.shape)} on {g.device}")
        capturing = (self._fn is not None
                     and torch._C._cuda_isCurrentStreamCapturing())
        if self._captured and not capturing:
            self._next = self.t              # replays moved the device's
        t = self._next
        if t >= self._end:
            raise ValueError(f"step {t} is past the last step this launcher "
                             f"was built for ({self._end - 1})")
        if self._fn is None:
            if self._device.type == "cpu":
                adam_update_reference(g, self.p, self.m, self.v, self.lr, t,
                                      self.b1, self.b2, self.eps)
            self._next = t + 1
            return self.p, self.m, self.v
        if torch.cuda.current_device() != self._index:
            raise RuntimeError(f"kernel B3's launcher is on "
                               f"cuda:{self._index}, the current device is "
                               f"cuda:{torch.cuda.current_device()}")
        # PyTorch's current stream (a graph's capture stream included), read
        # as its raw handle: the torch.cuda.Stream object costs as much host
        # time as the launch itself
        err = self._fn(self._args_ptr, g.data_ptr(),
                       torch._C._cuda_getCurrentRawStream(self._index))
        if err != 0:
            raise RuntimeError(f"adam_update launch failed: error {err}")
        if capturing:
            self._captured = True
            return self.p, self.m, self.v
        self._next = t + 1
        with _COUNT_LOCK:
            LAUNCHES += 1
        return self.p, self.m, self.v


def adam_update_flat(g, p, m, v, lr, step: int, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8):
    """One fused Adam step on 1-D vectors, IN PLACE on ``p``, ``m`` and
    ``v`` (returned as ``(p, m, v)``).  ``lr`` is a 1-element tensor of the
    vectors' dtype on their device; ``step`` is 1-based (the count AFTER
    this update, as optax counts).  The kernel takes float32; the plain
    version also float64.

    CUDA tensors launch kernel B3 through a one-step ``FusedAdam`` built
    for this call (its table and slots allocated and uploaded each time:
    a slow path, for tests and comparisons; a training loop keeps one
    launcher for its phase); CPU tensors run the plain version."""
    step = int(step)
    if step < 1:
        raise ValueError(f"step is 1-based (the count after this update), "
                         f"got {step}")
    return FusedAdam(p, m, v, lr, 1, b1, b2, eps, start=step).step(g)
