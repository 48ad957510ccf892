"""Optimizers: the scheduled Adam phase and L-BFGS, as eager loops.

Port of ``tpinn.core.optim``.  ``tpinn`` compiles each phase into one XLA
computation; here the same automata run as Python loops over device
tensors.

Adam
----
- resample all points after the update when ``step % resample_every == 0
  and step > 0``;
- refresh the adaptive density at ``(step + 1) % density_every == 0``;
- at ``(step + 1) % plateau_every == 0`` compare the mean loss of the two
  halves of the last ``plateau_every`` steps and halve the learning rate
  when ``|Δmean| / std < plateau_ratio``, floored at ``lr_min``; the
  moment estimates are NOT reset on an lr change (the reference's quirk);
- after the main loop keep stepping (≤ ``tail_max``) until the last loss
  beats the minimum of the final ``epochs/5`` window.

The learning rate is a 1-element device tensor that the plateau rule
changes in place, and the loss rows go into a preallocated device
history: the main loop never reads the host.  Only the tail condition,
the ``log_fn`` replay (every ``10·log_every`` steps) and a mid-stage
checkpoint's save do.  The parameter update is kernel B3
(tpinn_torch.kernels.adam) on CUDA tensors, its plain version on CPU
tensors, through one ``FusedAdam`` launcher per vector built at the start
of the phase for ``epochs + tail_max`` steps: with ``layout="flat"`` ONE
vector holds every parameter (one launch per step, the loss sees views of
it), with ``layout="tree"`` one per leaf.

On a mesh (``loss_fn`` from parallel.make_parallel_loss) the step's
gradient, loss and loss_info are reduced in one all-reduce
(``loss_fn.tpinn_reduce``) before B3 sees them, so every rank takes the
same update and the same branches.

Checkpoint and resume: ``ckpt_cb(done, state, hist)`` gets the whole
phase state at the end of every log chunk (``10·log_every`` steps, with or
without a ``log_fn``) and at the end of the main loop; ``init=(done,
state, hist)`` continues there, the launchers built at ``start = done +
1`` so that B3's bias corrections and device step go on where they were.
A resumed phase ends bit for bit where the uninterrupted one ends.

L-BFGS
------
Fixed-memory two-loop recursion with circular history buffers and a
strong-Wolfe line search (bracket + zoom, Nocedal & Wright alg. 3.5/3.6,
safeguarded quadratic interpolation), the state machine of
``tpinn.core.optim.wolfe_linesearch``; the vectors stay on the device and
the host takes the line search's decisions.  The history records one
loss_info row per accepted iterate (``history="iters"``) or per function
evaluation (``"evals"``, the reference's cadence).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional

import torch

from tpinn_torch.core.net import detach_tree
from tpinn_torch.kernels import adam as adam_kernel
from tpinn_torch.utils.profiling import read, span

Tensor = torch.Tensor


# ===========================================================================
# Parameter pytrees as flat vectors
# ===========================================================================


def tree_leaves(tree) -> List[Tensor]:
    """Leaves in JAX's order: dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def ravel_tree(tree):
    """``(flat, unravel)``: a new 1-D tensor holding every leaf (JAX's
    ravel_pytree order), and ``unravel(vec)`` giving the tree as VIEWS of
    ``vec`` (so autograd through them reaches ``vec`` in one piece)."""
    leaves = tree_leaves(tree)
    shapes = [tuple(x.shape) for x in leaves]
    flat = torch.cat([x.detach().reshape(-1) for x in leaves])

    def unravel(vec: Tensor):
        views, off = [], 0
        for shp in shapes:
            n = math.prod(shp)
            views.append(vec[off:off + n].view(shp))
            off += n
        return _rebuild(tree, iter(views))

    return flat, unravel


# ===========================================================================
# Adam phase
# ===========================================================================


@dataclass(frozen=True)
class AdamConfig:
    epochs: int
    lr: float = 1e-3
    resample_every: int = 100
    density_every: int = 2000
    plateau_every: int = 4000
    plateau_ratio: float = 0.4
    # floor of the plateau halving (0.0 = the reference's unbounded halving)
    lr_min: float = 0.0
    tail_max: int = 4000
    log_every: int = 100
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # "flat": one vector holding every parameter, one B3 launch per step;
    # "tree": one update per leaf.  Same math (Adam is elementwise).
    layout: str = "flat"

    def __post_init__(self):
        if self.layout not in ("flat", "tree"):
            raise ValueError(f"layout must be 'flat'|'tree', "
                             f"got {self.layout!r}")


class AdamPhaseResult(NamedTuple):
    params: dict
    history: Tensor         # [epochs + tail_max, k] loss_info rows
    n_valid: int            # epochs + tail steps actually taken
    density: Tensor         # final adaptive density F
    data: dict              # final point set
    generator: torch.Generator
    lr: Tensor              # final learning rate, [1]


def make_adam_phase(
    loss_fn: Callable,
    sample_fn: Optional[Callable],
    density_fn: Optional[Callable],
    config: AdamConfig,
    info_width: int,
    log_fn: Optional[Callable] = None,
):
    """Build the Adam phase.

    :param loss_fn: ``(params, data, lw, ref) -> (loss_n, loss_info)``.
    :param sample_fn: ``(generator, F) -> data``, or None for a fixed set.
    :param density_fn: ``params -> F`` adaptive-density refresh, or None.
    :param log_fn: optional ``(step, loss_info_row)``, replayed from the
        history on the host every ``10 * log_every`` steps for each step
        with ``step > 0 and step % log_every == 0``.
    :returns: ``phase(generator, params, data, F, lw, ref, ckpt_cb=None,
        init=None)`` -> AdamPhaseResult, with ``phase.make_state0(
        generator, params, data, F, ref)`` the template of its state.  The
        caller's params are not modified.
    """
    cfg = config
    reduce = getattr(loss_fn, "tpinn_reduce", None)
    # the plateau ring; where the rule never fires in the main loop, one
    # slot (plateau_every=10**9, "off", would otherwise take gigabytes)
    ring_n = cfg.plateau_every if 0 < cfg.plateau_every <= cfg.epochs else 1
    half = cfg.plateau_every // 2
    tail_window = max(1, int(round(cfg.epochs / 5)))
    log_chunk = max(cfg.log_every * 10, 1)

    def vectors(params):
        """The phase's Adam vectors of ``params`` (new tensors) and
        ``to_tree(vectors)`` giving the tree as views of them."""
        leaves = tree_leaves(params)
        if cfg.layout == "flat":
            flat, unravel = ravel_tree(params)
            return [flat], lambda vs: unravel(vs[0])
        shapes = [tuple(x.shape) for x in leaves]
        vecs = [x.detach().reshape(-1).clone() for x in leaves]
        return vecs, lambda vs: _rebuild(params, iter(
            v.view(s) for v, s in zip(vs, shapes)))

    def make_state0(gen, params, data, F, ref):
        """The phase state at step 0: the template a mid-stage checkpoint
        loads into (utils.checkpoint.load_phase_state).  Everything the
        loop reads: each Adam vector ``p`` with its moments ``m`` and
        ``v``, the learning rate, the plateau ring, the point set, the
        density and the generator's state."""
        vecs, _ = vectors(params)
        return {"p": vecs, "m": [torch.zeros_like(x) for x in vecs],
                "v": [torch.zeros_like(x) for x in vecs],
                "lr": torch.full((1,), cfg.lr, dtype=vecs[0].dtype,
                                 device=vecs[0].device),
                "ring": torch.zeros((ring_n,), dtype=ref.dtype,
                                    device=vecs[0].device),
                "data": data, "F": F, "gen": gen.get_state()}

    def phase(gen, params, data, F, lw, ref, ckpt_cb=None, init=None):
        """Run the phase.

        :param ckpt_cb: optional ``ckpt_cb(done, state, hist)``, called at
            the end of every log chunk (``10 * log_every`` steps) and once
            more at the end of the main loop, after the step's resample,
            density refresh and plateau rule: ``state`` (make_state0's
            structure, the live tensors) is what step ``done`` reads,
            ``hist`` the loss rows ``[:done]``.  The tail is not
            checkpointed.
        :param init: optional ``(done, state, hist)`` from a ``ckpt_cb``
            (utils.checkpoint.load_phase_state): the loop continues at
            step ``done`` with the same numerics as a run that was never
            stopped (``gen`` takes the saved generator state).
        """
        vecs, to_tree = vectors(params)
        dev = vecs[0].device
        h_dtype = ref.dtype
        hist = torch.zeros((cfg.epochs, info_width), dtype=h_dtype, device=dev)
        done, state, hist0 = init if init is not None else (
            0, make_state0(gen, params, data, F, ref), hist[:0])
        done = int(done)
        if not 0 <= done <= cfg.epochs:
            raise ValueError(f"init: step {done} lies outside this "
                             f"phase's {cfg.epochs} steps")
        for x, saved in zip(vecs, state["p"]):
            x.copy_(saved)
        ms = [x.clone() for x in state["m"]]
        vs = [x.clone() for x in state["v"]]
        lr, ring = state["lr"].clone(), state["ring"].clone()
        data, F = state["data"], state["F"]
        gen.set_state(state["gen"])
        hist[:done] = hist0[:done].to(device=dev, dtype=h_dtype)
        # one launcher per vector for the rest of the phase: step t = done
        # + 1, ... counted on the device, its bias corrections tabled once
        updates = [adam_kernel.FusedAdam(
            x.detach(), m, v, lr, cfg.epochs + cfg.tail_max - done, cfg.b1,
            cfg.b2, cfg.eps, start=done + 1) for x, m, v in zip(vecs, ms, vs)]

        def step_update():
            for x in vecs:
                x.requires_grad_(True)
            with span("adam.forward"):
                loss_n, info = loss_fn(to_tree(vecs), data, lw, ref)
            with span("adam.backward"):
                grads = torch.autograd.grad(loss_n, vecs, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g.contiguous()
                     for x, g in zip(vecs, grads)]
            if reduce is not None:
                _, info, grads = reduce(loss_n, info, grads)
            with torch.no_grad():
                for g, update in zip(grads, updates):
                    update.step(g)
            return info.detach()

        logged = done
        for step in range(done, cfg.epochs):
            info = step_update()
            hist[step] = info
            ring[step % ring_n] = info[0]
            with torch.no_grad():
                # resample AFTER the update (the reference's loop order)
                if (sample_fn is not None and step % cfg.resample_every == 0
                        and step > 0):
                    with span("adam.resample"):
                        data = sample_fn(gen, F)
                if (density_fn is not None
                        and (step + 1) % cfg.density_every == 0):
                    F = density_fn(detach_tree(to_tree(vecs)))
                if cfg.plateau_every > 0 and (step + 1) % cfg.plateau_every == 0:
                    lc1, lc2 = ring[:half], ring[half:]
                    mm12 = torch.abs(lc1.mean() - lc2.mean())
                    # 0/0 (a flat loss) is NaN, and NaN < ratio is False
                    halve = mm12 / lc2.std(correction=0) < cfg.plateau_ratio
                    lr.copy_(torch.clamp(torch.where(halve, lr * 0.5, lr),
                                         min=cfg.lr_min))
            if (step + 1) % log_chunk == 0 or step + 1 == cfg.epochs:
                if log_fn is not None:
                    rows = hist[logged:step + 1].cpu().numpy()
                    for k, row in enumerate(rows):
                        s = logged + k
                        if s > 0 and s % cfg.log_every == 0:
                            log_fn(s, row)
                    logged = step + 1
                if ckpt_cb is not None:
                    ckpt_cb(step + 1, {
                        "p": [x.detach() for x in vecs], "m": ms, "v": vs, "lr": lr, "ring": ring,
                        "data": data, "F": F, "gen": gen.get_state()},
                        hist[:step + 1])

        def result(history, n_valid):
            out = detach_tree(to_tree(vecs))
            for x in vecs:
                x.requires_grad_(False)
            return AdamPhaseResult(out, history, n_valid, F, data, gen, lr)

        if cfg.tail_max == 0 or cfg.epochs == 0:
            return result(hist, cfg.epochs)

        # the tail: step until the last loss beats the final window's min
        lmin = float(hist[-tail_window:, 0].min())
        llast = float(hist[-1, 0])
        tail = torch.zeros((cfg.tail_max, info_width), dtype=h_dtype,
                           device=dev)
        n_tail = 0
        while llast >= lmin and n_tail < cfg.tail_max:
            info = step_update()
            tail[n_tail] = info
            llast = float(info[0])
            n_tail += 1
        return result(torch.cat([hist, tail], dim=0), cfg.epochs + n_tail)

    phase.make_state0 = make_state0
    return phase


# ===========================================================================
# L-BFGS with strong-Wolfe line search
# ===========================================================================


@dataclass(frozen=True)
class LBFGSConfig:
    max_iters: int
    memory: int = 10
    tolerance: float = 1e-10       # sup-norm gradient tolerance
    c1: float = 1e-4               # Armijo (sufficient decrease)
    c2: float = 0.9                # curvature (strong Wolfe)
    max_linesearch: int = 20
    max_bracket: int = 10
    # "iters": one loss_info row per ACCEPTED iterate; "evals": one row
    # per FUNCTION EVALUATION, line-search probes included (the
    # reference's cadence)
    history: str = "iters"

    def __post_init__(self):
        if self.history not in ("iters", "evals"):
            raise ValueError(f"history must be 'iters'|'evals', got "
                             f"{self.history!r}")

    @property
    def history_rows(self) -> int:
        """Preallocated history length (row 0 is the initial loss)."""
        if self.history == "evals":
            return 1 + self.max_iters * (self.max_bracket
                                         + self.max_linesearch)
        return 1 + self.max_iters


class LBFGSResult(NamedTuple):
    x: Tensor
    f: Tensor
    g: Tensor
    history: Tensor     # [history_rows, k] loss_info rows
    n_iters: int
    n_rows: int         # rows written to history (incl. row 0)
    converged: bool
    failed: bool


def _two_loop(g, S, Y, rho, count, head, gamma, memory):
    """Two-loop recursion with circular buffers (Nocedal & Wright alg
    7.4): the direction −H·g from the ``count`` newest pairs."""
    q = g
    alpha = [None] * memory
    for j in range(count):
        pos = (head - 1 - j) % memory
        a = rho[pos] * torch.dot(S[pos], q)
        q = q - a * Y[pos]
        alpha[pos] = a
    r = gamma * q
    for j in range(count):
        pos = (head - count + j) % memory
        b = rho[pos] * torch.dot(Y[pos], r)
        r = r + (alpha[pos] - b) * S[pos]
    return -r


def _interp(a_lo, a_hi, phi_lo, dphi_lo, phi_hi):
    """Safeguarded quadratic trial inside (a_lo, a_hi); bisect fallback."""
    span = a_hi - a_lo
    denom = phi_hi - phi_lo - dphi_lo * span
    if denom == 0.0:
        return 0.5 * (a_lo + a_hi)
    a_q = a_lo - 0.5 * dphi_lo * span * span / denom
    t = (a_q - a_lo) / (span if span != 0.0 else 1.0)
    if math.isfinite(a_q) and 0.1 < t < 0.9:
        return a_q
    return 0.5 * (a_lo + a_hi)


def wolfe_linesearch(vg, x, f0, g0, info0, d, alpha0: float,
                     cfg: LBFGSConfig, record=None):
    """Strong-Wolfe line search along ``d``: bracketing, then zoom, as one
    state machine (mode 0 = bracketing, 1 = zooming, 2 = accepted, 3 =
    failed).  ``record(info)`` is called for every function evaluation
    (the "evals" history).  Returns (alpha, f, g, info, ok)."""
    c1, c2 = cfg.c1, cfg.c2
    dphi0 = read(torch.dot(g0, d), "lbfgs.search")
    phi0 = read(f0, "lbfgs.search")
    max_evals = cfg.max_bracket + cfg.max_linesearch
    mode, evals = 0, 0
    a_prev, phi_prev, dphi_prev = 0.0, phi0, dphi0
    a_cur = float(alpha0)
    a_lo, a_hi, phi_lo, dphi_lo, phi_hi = 0.0, float(alpha0), phi0, dphi0, phi0
    acc = (0.0, f0, g0, info0)
    while mode < 2 and evals < max_evals:
        a = a_cur
        f_t, g, info = vg(x + a * d)
        if record is not None:
            record(info)
        f = read(f_t, "lbfgs.search")
        df = read(torch.dot(g, d), "lbfgs.search")
        armijo = f <= phi0 + c1 * a * dphi0
        curv = abs(df) <= -c2 * dphi0
        bracketing = mode == 0
        if bracketing:
            hi = (not armijo) or (f >= phi_prev and evals > 0)
            accept = armijo and curv and not hi
            flip = not hi and not accept and df >= 0.0
            if hi:
                a_lo, phi_lo, dphi_lo, a_hi, phi_hi = (a_prev, phi_prev,
                                                       dphi_prev, a, f)
            else:
                a_lo, phi_lo, dphi_lo, a_hi, phi_hi = a, f, df, a_prev, phi_prev
            zooming_next = hi or flip
        else:
            hi = (not armijo) or (f >= phi_lo)
            accept = not hi and curv
            flip = not hi and not curv and df * (a_hi - a_lo) >= 0.0
            if hi:
                a_hi, phi_hi = a, f
            else:
                if flip:
                    a_hi, phi_hi = a_lo, phi_lo
                a_lo, phi_lo, dphi_lo = a, f, df
            zooming_next = not accept
        if accept:
            mode = 2
            acc = (a, f_t, g, info)
        else:
            mode = 1 if zooming_next else 0
            a_cur = (_interp(a_lo, a_hi, phi_lo, dphi_lo, phi_hi)
                     if zooming_next else 2.0 * a)
            if evals + 1 >= max_evals:
                mode = 3                 # budget exhausted
        evals += 1
        a_prev, phi_prev, dphi_prev = a, f, df
    return acc + (mode == 2,)


def lbfgs_minimize(value_and_grad_fn: Callable, x0: Tensor,
                   config: LBFGSConfig) -> LBFGSResult:
    """Minimize ``f(x)`` over a flat parameter vector.

    :param value_and_grad_fn: ``x -> (f, g, loss_info)``; the loss_info
        rows go into ``history`` at the configured cadence."""
    m = config.memory
    f, g, info = value_and_grad_fn(x0)
    x = x0
    n = x0.shape[0]
    hist = torch.zeros((config.history_rows, info.shape[0]), dtype=info.dtype,
                       device=info.device)
    hist[0] = info
    rows = 1
    S = torch.zeros((m, n), dtype=x0.dtype, device=x0.device)
    Y = torch.zeros_like(S)
    rho = torch.zeros((m,), dtype=x0.dtype, device=x0.device)
    gamma = torch.ones((), dtype=x0.dtype, device=x0.device)
    count = head = it = 0
    done = failed = False

    def record(row):
        nonlocal rows
        hist[rows] = row
        rows += 1

    while not done and it < config.max_iters:
        with span("lbfgs.iter"):
            d = _two_loop(g, S, Y, rho, count, head, gamma, m)
            # not a descent direction
            if not read(torch.dot(d, g), "lbfgs.iter") < 0.0:
                d = -g
            alpha0 = (min(1.0, 1.0 / max(read(g.abs().sum(), "lbfgs.iter"),
                                         1e-12))
                      if count == 0 else 1.0)
            alpha, f_new, g_new, info_new, ok = wolfe_linesearch(
                value_and_grad_fn, x, f, g, info, d, alpha0, config,
                record if config.history == "evals" else None)
            x_new = x + alpha * d
            sk = x_new - x
            yk = g_new - g
            sy = read(torch.dot(sk, yk), "lbfgs.iter")
            s_norm = read(torch.linalg.norm(sk), "lbfgs.iter")
            y_norm = read(torch.linalg.norm(yk), "lbfgs.iter")
            curv_ok = sy > 1e-12 * s_norm * y_norm
            if ok and curv_ok:
                S[head % m] = sk
                Y[head % m] = yk
                rho[head % m] = 1.0 / sy
                count = min(count + 1, m)
                head = (head + 1) % m
                yy = read(torch.dot(yk, yk), "lbfgs.iter")
                gamma = torch.as_tensor(sy / max(yy, 1e-30), dtype=x0.dtype,
                                        device=x0.device)
            it += 1
            if config.history == "iters" and ok:
                record(info_new)
            converged = (read(g_new.abs().max(), "lbfgs.iter")
                         <= config.tolerance)
            if ok:
                x, f, g, info = x_new, f_new, g_new, info_new
            done = (not ok) or converged
            failed = not ok

    converged = read(g.abs().max(), "lbfgs.iter") <= config.tolerance
    return LBFGSResult(x=x, f=f, g=g, history=hist, n_iters=it, n_rows=rows,
                       converged=converged, failed=failed)


def evaluate_loss(loss_fn: Callable, params, data, lw, ref):
    """``loss_fn(params, data, lw, ref)``, reduced over the mesh when
    ``loss_fn`` is a meshed loss (parallel.make_parallel_loss): the
    global ``(loss_n, loss_info)`` on every rank."""
    loss_n, info = loss_fn(params, data, lw, ref)
    reduce = getattr(loss_fn, "tpinn_reduce", None)
    if reduce is not None:
        loss_n, info, _ = reduce(loss_n, info, [])
    return loss_n, info


def lbfgs_over_pytree(loss_fn: Callable, params, data, lw, ref,
                      config: LBFGSConfig):
    """L-BFGS on a parameter pytree (ravel/unravel wrapper).  Returns
    (params, history, n_rows) with history[:n_rows] the valid loss rows.
    A meshed loss (parallel.make_parallel_loss) has its value and
    gradient reduced over the mesh at every evaluation, so the line
    search takes the same branches on every rank."""
    flat0, unravel = ravel_tree(params)

    reduce = getattr(loss_fn, "tpinn_reduce", None)

    def vg(x):
        with span("lbfgs.eval"):
            x = x.detach().requires_grad_(True)
            loss_n, info = loss_fn(unravel(x), data, lw, ref)
            (g,) = torch.autograd.grad(loss_n, x)
            if reduce is not None:
                loss_n, info, (g,) = reduce(loss_n, info, [g])
            return loss_n.detach(), g, info.detach()

    res = lbfgs_minimize(vg, flat0, config)
    return detach_tree(unravel(res.x)), res.history, res.n_rows
