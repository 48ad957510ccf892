"""Training orchestrator: the multi-stage PINN pipeline (``run_training``).

Port of ``tpinn.core.train`` for the forward scalar pipeline:

    stage 1: tanh net → Adam phase (resample / density refresh / plateau
             lr / tail automaton) → L-BFGS → float64 evaluation →
             artifacts + checkpoint
    stage ≥ 2: a correction net composed on the frozen chain,
             u = u_prev(z) + ε₂·NN₂(z), with scl₂ = 30 if e₁ > 50 else
             r₁/e₁ (capped by ``auto_scl_cap``), ε₂ = e₁, weights
             lw₂ = [f/diff, df/diff²]; or a warm start of the same net
             (``init_from="prev"``).

On a CUDA device the Adam phase's residual runs through kernel B1, its
parameter gradient through kernel B2 (``engine``/``adam_engine``
"kernel", or "auto" on float32 plain nets) and the flat parameter update
through kernel B3.  The float64 evaluation runs on the device through the
generic engine (the TPU needed a hop to the host CPU for it).

After every L-BFGS round a linear equation gets the exact last-layer
least-squares solve (``lsq_polish``, polish.last_layer_lsq: with
``lbfgs_rounds`` > 1 this is variable projection), and the final stage
closes with the spectral defect correction (``deflation``,
polish.defect_correction): the corrected fields go into the artifacts,
the correction into the checkpoint meta, and ``TrainResult.predict``
subtracts it.  Both run in float64 on the training device.
``ring_weight`` > 0 adds the resonance-band penalty to the stage loss.

``adam_precision`` sets the ``torch.matmul`` precision of the Adam phase
and of nothing else (:func:`adam_matmul_precision`): None, "highest" and
"high" keep IEEE fp32 products (torch has no 3-pass mode to map "high"
to), "default" allows TF32.  It reaches the dense products autograd sees
(the boundary terms' forward, any net outside the kernels' scope);
kernels B1 and B2 compute in fp32 FMA whatever it says.  L-BFGS, the
float64 evaluation and all of polish.py never see TF32.

Mid-stage checkpoints: with ``checkpoint_every > 0`` and an
``output_dir`` the Adam phase's whole state goes to
``adam_state_stage_N.npz`` (utils.checkpoint.save_phase_state) at the end
of a log chunk once ``checkpoint_every`` steps have passed since the last
save, and at the end of the main loop; ``resume=True`` continues a stage
from it, bit for bit where the uninterrupted run would be (a finished
stage's ``params_stage_N.npz`` still wins).  ``lbfgs_device="cpu"`` runs
every L-BFGS round on the host CPU: the round's density draw stays on the
training device, the stage's loss is rebuilt on the CPU, and the
parameters come back.

``mesh``: a tpinn_torch.parallel.Mesh (make_mesh; every rank calls
``run_training`` with the same arguments) — the sample counts round up
to multiples of its points axis (round_count), every rank draws the
global batch and trains on its shard, the Adam phase and L-BFGS reduce
the gradient and loss_info in one all-reduce a step (causal runs add
the slab statistics' one), the density refresh, the polish, the
correction and the float64 evaluation run whole on every rank, and rank
0 alone writes the artifacts and checkpoints (a phase file holds the
global point set; every rank reads it on resume).  Every rank returns
the same result, its parameters checked equal across ranks after each
stage.  Anything but a Mesh raises TypeError, and ``lbfgs_device="cpu"``
with a mesh ValueError.  ``cpu_fallback=True`` raises ValueError: the
port never retries a phase elsewhere, so ``TrainResult.fell_back`` is
always False; ``lbfgs_device`` takes None and "cpu" only (tpinn ignores
other values).

``run_pinn_training`` is the online calculator's entry: the reference's
kwarg schema (a typed equation, boundary groups, a 2-D box) turned into a
ProblemSpec and a two-stage TrainSpec, with the whitelisted UI options of
``UI_OPTION_SPEC``; it dispatches to ``run_training``, to
``core.march.run_time_marching`` (``options.march``) or to
``core.inverse.run_inverse`` (``options.inverse_params``).
"""

from __future__ import annotations

import contextlib
import functools
import math
import sys
import threading
import time
import zipfile
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpinn_torch.core import loss as loss_mod
from tpinn_torch.core import net, optim, pde, polish, sample
from tpinn_torch.utils import artifacts
from tpinn_torch.utils import checkpoint as ckpt

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ProblemSpec:
    """What to solve: PDE + domain + BCs + (optional) analytic oracle."""

    name: str
    equation: str                          # residual expression (or lhs = rhs)
    coords: Tuple[str, ...]                # e.g. ("r", "t"), ("x",), ("x", "t")
    lb: Tuple[float, ...]
    ub: Tuple[float, ...]
    bc_groups: Tuple[sample.BCGroup, ...]
    feature_kinds: Tuple[str, ...] = None  # defaults to all-minmax
    exact: Optional[Callable[[Tensor], Tensor]] = None  # analytic solution z->u
    source: Optional[str] = None           # forcing g(z): residual -= g
    # hard Dirichlet constraints: coordinate-expression strings
    # (lift, bubble) -> u = lift(z) + bubble(z)·N(z); see net.wrap_hard_bc
    hard_bc: Optional[Tuple[str, str]] = None
    # pointwise residual weight w(z) (expression string or callable)
    residual_weight: Optional[object] = None
    # evaluation mask m(z) -> [N,1] in {0,1}
    eval_mask: Optional[Callable[[Tensor], Tensor]] = None

    def __post_init__(self):
        if self.feature_kinds is None:
            object.__setattr__(
                self, "feature_kinds", tuple([net.MINMAX] * len(self.coords))
            )
        if len(self.feature_kinds) != len(self.coords):
            raise ValueError("feature_kinds must match coords")

    @property
    def dim(self) -> int:
        return len(self.coords)


@dataclass(frozen=True)
class StageSpec:
    """Architecture/schedule of one training stage (the fields and defaults
    of ``tpinn.core.train.StageSpec``, and the port's PirateNet fields
    ``pirate_blocks`` and ``weight_fact``, net.MLPSpec's).  ``None`` scales
    are derived from the previous stage's diagnostics (stage ≥ 2 only)."""

    depth: int
    width: int
    act_first: str = "tanh"
    act_hidden: str = "tanh"
    scl: Optional[float] = None
    epsil: Optional[float] = None
    adam_epochs: int = 1000
    lbfgs_epochs: int = 1000               # max L-BFGS iters = epochs/3
    lbfgs_rounds: int = 1                  # restarts on fresh draws
    lbfgs_sample_scale: float = 1.0        # point-count multiplier for L-BFGS
    lbfgs_grid: int = 0                    # > 0: deterministic L-BFGS grid
    sample_scale: float = 1.0              # multiplies all sample counts
    fourier_features: int = 0
    fourier_scale: float = 1.0
    modified: bool = False
    init_from: Optional[str] = None        # "prev": warm start, same net
    lr: Optional[float] = None             # per-stage Adam lr
    equation: Optional[str] = None         # per-stage equation override
    lw: Optional[Tuple[float, float]] = None  # per-stage (f, df) weights
    pirate_blocks: int = 0                 # > 0: a PirateNet (net.MLPSpec)
    weight_fact: Optional[Tuple[float, float]] = None  # its RWF (mean, std)


@dataclass(frozen=True)
class TrainSpec:
    """Full training configuration (the fields and defaults of
    ``tpinn.core.train.TrainSpec``; see there for each option)."""

    n_col: int = 3000
    n_band: int = 1000
    n_adaptive: int = 1000
    n_bd: int = 100
    testing_size: Tuple[int, ...] = (111, 111)
    lw: Tuple[float, float] = (0.05, 0.0)
    stages: Tuple[StageSpec, ...] = ()
    grid: int = 111
    seed: int = 1234
    dtype: str = "float32"
    lr: float = 1e-3
    log_every: int = 100
    resample_every: int = 100
    density_every: int = 2000
    plateau_every: int = 4000
    lr_min: float = 0.0
    tail_max: int = 4000
    deriv_loss: bool = False
    lbfgs_dtype: Optional[str] = None      # "float64": L-BFGS on the device in f64
    lbfgs_history: str = "iters"
    lbfgs_device: Optional[str] = None
    cpu_fallback: bool = False
    lsq_polish: str = "off"
    deflation: str = "off"
    ring_weight: float = 0.0
    ring_band: float = 0.35
    ring_max_mode: int = 16
    causal_eps: float = 0.0
    causal_bins: int = 32
    causal_axis: str = "t"
    engine: str = "auto"
    adam_precision: Optional[str] = None
    adam_engine: Optional[str] = None      # Adam phase only (None = engine)
    adam_layout: str = "flat"
    pad_features: int = 0
    checkpoint_every: int = 0
    auto_scl_cap: Union[str, float, None] = "auto"

    def with_default_stages(self, depth=6, width=50, adam=1000, lbfgs=1000):
        """Reference-like two stages: user net then 6×50 sin correction."""
        s1 = StageSpec(depth=depth, width=width, act_first="tanh",
                       scl=1.0, epsil=1.0, adam_epochs=adam, lbfgs_epochs=lbfgs)
        s2 = StageSpec(depth=6, width=50, act_first="sin", scl=None, epsil=None,
                       adam_epochs=3 * adam, lbfgs_epochs=3 * lbfgs,
                       sample_scale=2.0)
        return replace(self, stages=(s1, s2))


@dataclass
class StageResult:
    params: dict
    predictor_frozen: Callable[[Tensor], Tensor]  # z -> u with params baked in
    history: np.ndarray                           # [n, k] loss_info rows
    r_rms: float                                  # residual RMS on eval grid
    e_rms: Optional[float]                        # error RMS vs analytic
    U: np.ndarray                                 # solution field on eval grid
    F: np.ndarray                                 # residual field on eval grid
    scl: float
    epsil: float


@dataclass
class TrainResult:
    problem: ProblemSpec
    spec: TrainSpec
    stages: List[StageResult]
    predict: Callable[[Tensor], Tensor]           # final composed u(z)
    rel_l2: Optional[float]                       # vs analytic, final stage
    history: np.ndarray                           # concatenated loss rows
    fell_back: bool = False                       # always False in the port


def rms(x) -> Tensor:
    """Global RMS (the reference's double-RMS reduction collapses to it)."""
    x = torch.as_tensor(x)
    return torch.sqrt(torch.mean(torch.square(x)))


# ---------------------------------------------------------------------------
# Evaluation grids + density refresh
# ---------------------------------------------------------------------------


def eval_grid(problem: ProblemSpec, testing_size: Sequence[int], dtype,
              device="cpu"):
    """Test grid X_star, its axes and its meshes (the JAX package's
    layout: 'xy' meshgrid in 2-D, 'ij' for d ≥ 3)."""
    axes = [torch.linspace(problem.lb[i], problem.ub[i], int(testing_size[i]),
                           dtype=dtype, device=device)
            for i in range(problem.dim)]
    if problem.dim == 1:
        return axes[0][:, None], axes, (axes[0][:, None],)
    if problem.dim == 2:
        R, T = torch.meshgrid(axes[0], axes[1], indexing="xy")
        return torch.stack([R.reshape(-1), T.reshape(-1)], dim=1), axes, (R, T)
    grids = torch.meshgrid(*axes, indexing="ij")
    return (torch.stack([G.reshape(-1) for G in grids], dim=1), axes,
            tuple(grids))


def resolve_testing_size(problem, testing_size, log=None, label=""):
    """``testing_size`` if its rank matches the problem, else a per-axis
    fallback grid."""
    if len(testing_size) == problem.dim:
        return tuple(int(v) for v in testing_size)
    per_axis = {1: 256, 2: 64, 3: 24}.get(problem.dim, 12)
    tsize = (per_axis,) * problem.dim
    if log is not None:
        log(f"{label}testing_size {tuple(testing_size)} is not "
            f"{problem.dim}-D; evaluating on {tsize}")
    return tsize


def resolve_residual_weight(problem):
    """``w(z)`` from ProblemSpec.residual_weight: a callable passes
    through, a string compiles as a coordinate expression."""
    if problem.residual_weight is None:
        return None
    if callable(problem.residual_weight):
        return problem.residual_weight
    return pde.compile_coord_expr(problem.residual_weight, problem.coords)


def _cast_tree(tree, dtype):
    return optim._rebuild(tree, iter(
        x.to(dtype) if torch.is_floating_point(x) else x
        for x in optim.tree_leaves(tree)))


def _to_device(tree, device):
    """``tree`` with every tensor leaf on ``device`` (the same tensors
    where they are there already); other leaves as they are."""
    return optim._rebuild(tree, iter(
        x.to(device) if torch.is_tensor(x) else x
        for x in optim.tree_leaves(tree)))


def _raw_chain(mspecs, feature_map, lb, ub):
    """The raw predictor of a stage chain (make_predictor, then one
    compose_stages per later stage) on ``lb``'s and ``ub``'s device."""
    pred = net.make_predictor(mspecs[0], feature_map, lb, ub)
    for mspec in mspecs[1:]:
        pred = net.compose_stages(pred, mspec, feature_map, lb, ub)
    return pred


# what makes a mid-stage checkpoint unusable: the phase restarts
_UNUSABLE = (KeyError, ValueError, OSError, EOFError, zipfile.BadZipFile)


def _load_phase(path, phase, layout, epochs, gen, params, data, F, ref,
                mesh=None):
    """``(done, state, hist)`` of the phase file ``path`` for ``phase``
    (its make_state0 the template, ``data`` the global point set); raises
    one of ``_UNUSABLE`` where the file cannot continue this phase.  On a
    mesh the saved point set is cut to this rank's shard."""
    like = phase.make_state0(gen, params, data, F, ref)
    done, state, hist = ckpt.load_phase_state(path, like, layout)
    if done > epochs:
        raise ValueError(f"saved at step {done}, past this phase's "
                         f"{epochs}")
    if mesh is not None:
        from tpinn_torch.parallel.mesh import shard_data

        state = dict(state, data=shard_data(state["data"], mesh))
    return done, state, hist


def _phase_saver(path, every, epochs, layout, done0, mesh=None):
    """The Adam phase's ``ckpt_cb``: the state goes to ``path`` once
    ``every`` steps have passed since the last save (``done0`` at the
    start), and at the end of the main loop.  On a mesh every rank calls
    it (the shards' point sets are gathered into the global one) and rank
    0 writes."""
    from tpinn_torch.parallel.mesh import gather_data, is_writer

    last = done0

    def ckpt_cb(done, state, hist):
        nonlocal last
        if done - last >= every or done >= epochs:
            if mesh is not None:
                state = dict(state, data=gather_data(state["data"], mesh))
            if is_writer(mesh):
                ckpt.save_phase_state(path, done, state, hist, layout)
            last = done

    return ckpt_cb


def eval_stage_f64(predictor, params, X_star, compiled, source_fn, exact):
    """u, the residual (and the analytic oracle) in float64, on X_star's
    device, through the generic engine (``fast_partials`` sends float64
    points there).  The measurement must be more precise than the float32
    model it measures.  Returns numpy arrays (u, f, exact_or_None)."""
    p64 = _cast_tree(net.detach_tree(params), torch.float64)
    z64 = X_star.to(torch.float64)
    with torch.no_grad():
        u = predictor(p64, z64)
        f = compiled.residual_fast(predictor, p64, z64)
        if source_fn is not None:
            f = f - source_fn(z64)
        e = exact(z64).cpu().numpy() if exact is not None else None
    return u.cpu().numpy(), f.cpu().numpy(), e


def make_density_fn(predictor, compiled: pde.CompiledPDE, grids,
                    source_fn=None, mask_fn=None):
    """The adaptive density (predictF): residual² normalized + 0.5 floor,
    Gaussian-smoothed, on the sampler's grid; ``mask_fn`` zeroes it outside
    a masked non-box domain.  ``density(params, coef)`` evaluates the
    residual at the equation's unknown coefficients ``coef``, if it has
    any (core.inverse).  Call it under ``torch.no_grad()``."""
    z, reshape, smooth = sample.density_geometry(grids)

    def density(params, coef=None):
        f0 = compiled.residual_fast(predictor, params, z, coef)
        if source_fn is not None:
            f0 = f0 - source_fn(z)
        f_sq = f0 ** 2
        f_nm = f_sq / torch.mean(f_sq) + 0.5
        if mask_fn is not None:
            f_nm = f_nm * mask_fn(z)
        return smooth(reshape(f_nm))

    return density


# adam_precision -> whether torch.matmul may use TF32 in the Adam phase
_ADAM_TF32 = {None: False, "highest": False, "high": False, "default": True}


@contextlib.contextmanager
def adam_matmul_precision(name):
    """Set the global ``torch.matmul`` float32 precision for the Adam phase
    (``TrainSpec.adam_precision``) and restore what it was on the way out,
    also when the phase raises."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = _ADAM_TF32[name]
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


# One training run at a time in this process: adam_matmul_precision sets
# torch's process-wide TF32 flag, so two overlapping runs (the calculator's
# sessions run in threads) would leak it into each other's phases or leave
# it changed.  Re-entrant: marching, ensembles and run_pinn_training call
# run_training inside a run.  tpinn's precision is per computation, and
# its runs overlap.
_RUN_LOCK = threading.RLock()


def one_run_at_a_time(entry):
    """``entry``, a training entry point, run under the process's training
    lock; a caller that has to wait says so first through its ``log_fn``
    keyword (on stderr without one)."""

    @functools.wraps(entry)
    def run(*args, **kwargs):
        if not _RUN_LOCK.acquire(blocking=False):
            log = kwargs.get("log_fn") or (
                lambda m: print(m, file=sys.stderr))
            log("waiting for the device (another training run holds it)")
            _RUN_LOCK.acquire()
        try:
            return entry(*args, **kwargs)
        finally:
            _RUN_LOCK.release()

    return run


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" without a card raises (the port
    never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    return dev


def _check_supported(spec: TrainSpec, mesh) -> None:
    from tpinn_torch.parallel.mesh import check_mesh

    check_mesh(mesh)
    if spec.cpu_fallback:
        raise ValueError("cpu_fallback=True: tpinn_torch never retries a "
                         "phase on another device")
    if mesh is not None and spec.lbfgs_device is not None:
        raise ValueError("lbfgs_device='cpu' with a mesh: a meshed run's "
                         "L-BFGS reduces over the mesh on the training "
                         "device")
    if spec.lsq_polish not in ("off", "auto", "on"):
        raise ValueError(f"lsq_polish={spec.lsq_polish!r}")
    if spec.deflation not in ("off", "auto", "full"):
        raise ValueError(f"deflation={spec.deflation!r}")
    if spec.adam_precision not in _ADAM_TF32:
        raise ValueError(
            f"adam_precision={spec.adam_precision!r}: expected None, "
            f"'highest', 'high' or 'default'")
    if spec.lbfgs_device not in (None, "cpu"):
        raise ValueError(f"lbfgs_device={spec.lbfgs_device!r}: expected "
                         f"None (the training device) or 'cpu'")
    if spec.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------


@one_run_at_a_time
def run_training(
    problem: ProblemSpec,
    spec: TrainSpec,
    output_dir: Optional[str] = None,
    log_fn: Optional[Callable] = None,
    print_log: bool = False,
    resume: bool = False,
    mesh=None,
    *,
    device,
) -> TrainResult:
    """Run the multi-stage pipeline on ``device`` ("cuda" fails without a
    card).  Writes the 11-artifact contract and ``params_stage_N.npz``
    (the JAX package's checkpoint format and meta) into ``output_dir``
    when given; ``resume=True`` reloads a finished stage's checkpoint and
    skips its training, or continues an unfinished stage's Adam phase from
    its ``adam_state_stage_N.npz`` (written with ``checkpoint_every >
    0``)."""
    _check_supported(spec, mesh)
    if not spec.stages:
        spec = spec.with_default_stages()
    dev = resolve_device(device)
    dtype = _DTYPES[spec.dtype]
    from tpinn_torch import parallel
    from tpinn_torch.parallel.mesh import is_writer

    # out: where resume reads (every rank); wout: where this rank writes
    # (rank 0 of a mesh)
    out = Path(output_dir) if output_dir else None
    wout = out if is_writer(mesh) else None
    if wout:
        wout.mkdir(parents=True, exist_ok=True)

    def log(msg: str):
        if log_fn is not None:
            log_fn(msg)
        if print_log:
            print(msg, file=sys.stderr)

    def seeded(k: int, where) -> torch.Generator:
        # stream k of the run: 4 per stage (init, Adam draws, L-BFGS draws)
        return torch.Generator(device=where).manual_seed(spec.seed * 1000 + k)

    compiled = pde.compile_pde(problem.equation, problem.coords)
    source_fn = (pde.compile_coord_expr(problem.source, problem.coords)
                 if problem.source else None)
    bc_ops = tuple(pde.compile_pde(g.operator, problem.coords)
                   if g.operator else None for g in problem.bc_groups)
    has_op_bc = any(o is not None for o in bc_ops)
    if not has_op_bc:
        bc_ops = None
    hard_fns = None
    if problem.hard_bc is not None:
        hard_fns = tuple(pde.compile_coord_expr(e, problem.coords)
                         for e in problem.hard_bc)
    rw_fn = resolve_residual_weight(problem)
    if spec.lsq_polish == "on" and problem.eval_mask is not None:
        # fail BEFORE spending the training budget: the polish would be
        # rejected at its call site anyway (bounding-box quadrature over
        # the dead region)
        raise ValueError("lsq_polish='on' is not supported on masked "
                         "(eval_mask) domains")
    feature_map = net.feature_map_for(problem.feature_kinds,
                                      pad_to=spec.pad_features)
    lb = torch.tensor(problem.lb, dtype=dtype, device=dev)
    ub = torch.tensor(problem.ub, dtype=dtype, device=dev)

    X_star, axes, _ = eval_grid(problem, spec.testing_size, dtype, dev)
    exact_star = (problem.exact(X_star).to(dtype).cpu().numpy()
                  if problem.exact else None)

    info_width = loss_mod.loss_info_width(len(problem.bc_groups))
    if spec.deriv_loss:
        info_width += 1  # extra eqn_err column for the gradient term
    lw = torch.tensor(spec.lw, dtype=dtype, device=dev)

    prev_predictor: Optional[Callable] = None
    prev_specs: List[net.MLPSpec] = []  # the raw chain of prev_predictor
    prev_params = None
    prev_diag: Optional[Tuple[float, Optional[float]]] = None
    stage_results: List[StageResult] = []
    histories: List[np.ndarray] = []
    chain_specs: List[dict] = []  # per-stage MLPSpec dicts for checkpoint meta
    u_star = exact64 = None

    for si, st in enumerate(spec.stages):
        stage_no = si + 1
        log(f"===== stage {stage_no}/{len(spec.stages)} =====")
        if st.equation:
            compiled_st = pde.compile_pde(st.equation, problem.coords)
            log(f"stage {stage_no}: equation override {st.equation!r}")
        else:
            compiled_st = compiled
        if st.init_from == "prev" and si == 0:
            raise ValueError(
                "StageSpec.init_from='prev' on stage 1 has nothing to warm "
                "from — remove it or reorder the stages")
        warm = st.init_from == "prev" and si > 0
        # --- scales from the previous stage's diagnostics
        if si == 0:
            scl = st.scl if st.scl is not None else 1.0
            epsil = st.epsil if st.epsil is not None else 1.0
            stage_lw = lw
        elif warm:
            scl = st.scl if st.scl is not None else stage_results[-1].scl
            epsil = (st.epsil if st.epsil is not None
                     else stage_results[-1].epsil)
            stage_lw = lw
            log(f"stage {stage_no}: warm start from stage {si} "
                f"(scl={scl:.4g} epsil={epsil:.4g})")
        else:
            r_prev, e_prev = prev_diag
            e_prev = e_prev if e_prev is not None else r_prev
            diff = r_prev / max(e_prev, 1e-30)
            if st.scl is not None:
                scl = st.scl
            else:
                scl = 30.0 if e_prev > 50 else diff
                cap = (spec.grid / 4.0 if spec.auto_scl_cap == "auto"
                       else spec.auto_scl_cap)
                if cap is not None and scl > cap:
                    log(f"stage {stage_no}: derived scl {scl:.4g} exceeds the "
                        f"sampler Nyquist guard — capped to {cap:.4g} "
                        f"(grid {spec.grid}/axis)")
                    scl = float(cap)
            epsil = st.epsil if st.epsil is not None else e_prev
            stage_lw = torch.tensor([spec.lw[0] / diff, spec.lw[1] / diff ** 2],
                                    dtype=dtype, device=dev)
            log(f"stage {stage_no}: scl={scl:.4g} epsil={epsil:.4g} "
                f"diff={diff:.4g}")
        if st.lw is not None:
            stage_lw = torch.tensor(st.lw, dtype=dtype, device=dev)
            log(f"stage {stage_no}: lw override {tuple(st.lw)}")

        mspec = net.MLPSpec(
            depth=st.depth, width=st.width, act_first=st.act_first,
            act_hidden=st.act_hidden, scl=float(scl), epsil=float(epsil),
            fourier_features=st.fourier_features,
            fourier_scale=st.fourier_scale, modified=st.modified,
            pirate_blocks=st.pirate_blocks, weight_fact=st.weight_fact,
        )
        params = net.init_params(seeded(4 * si, "cpu"), mspec, feature_map,
                                 dev, dtype)
        if warm:
            shapes = lambda t: [tuple(x.shape) for x in optim.tree_leaves(t)]
            if (not isinstance(prev_params, dict) or "prev" in prev_params
                    or shapes(params) != shapes(prev_params)):
                raise ValueError(
                    f"stage {stage_no}: init_from='prev' requires the same "
                    f"architecture as stage {si}")
            params = _cast_tree(prev_params, dtype)
            chain_specs[-1] = net.spec_to_dict(mspec)
        else:
            chain_specs.append(net.spec_to_dict(mspec))
        if prev_predictor is None or warm:
            raw_predictor = net.make_predictor(mspec, feature_map, lb, ub)
            raw_specs = [mspec]
        else:
            raw_predictor = net.compose_stages(prev_predictor, mspec,
                                               feature_map, lb, ub)
            raw_specs = prev_specs + [mspec]
            params = net.compose_params(params, prev_params)
        # the hard-BC ansatz wraps the WHOLE raw chain
        predictor = (net.wrap_hard_bc(raw_predictor, *hard_fns)
                     if hard_fns is not None else raw_predictor)

        # --- sampler (counts scaled per stage; on a mesh rounded up to
        #     multiples of its points axis, as tpinn rounds them)
        sc = st.sample_scale
        _rc = ((lambda n: n) if mesh is None
               else (lambda n: parallel.round_count(max(1, n), mesh)))
        cfg = sample.SamplerConfig(
            n_col=_rc(int(spec.n_col * sc)),
            n_band=_rc(int(spec.n_band * sc)),
            n_adaptive=_rc(int(spec.n_adaptive * sc)),
            n_bd=_rc(int(spec.n_bd * sc)), grid=spec.grid)
        sample_fn, grids = sample.sampler_for(
            cfg, problem.bc_groups, problem.lb, problem.ub, dtype, dev)
        F0 = torch.ones_like(grids[0])
        density_fn = make_density_fn(predictor, compiled_st, grids, source_fn,
                                     mask_fn=problem.eval_mask)

        ring_arg = None
        if spec.ring_weight > 0 and problem.eval_mask is not None:
            log(f"stage {stage_no}: ring penalty inert (masked non-box "
                "domain: bounding-box quadrature would integrate the "
                "unconstrained dead region)")
        elif spec.ring_weight > 0:
            setup = polish.ring_penalty_setup(
                compiled_st, problem.lb, problem.ub,
                band=spec.ring_band, max_mode=spec.ring_max_mode)
            if setup is not None:
                z_r, P_r = setup
                ring_arg = {"z": torch.as_tensor(z_r, dtype=dtype, device=dev),
                            "P": torch.as_tensor(P_r, dtype=dtype, device=dev),
                            "weight": spec.ring_weight}
                log(f"stage {stage_no}: ring penalty on {P_r.shape[1]} "
                    f"band modes (weight {spec.ring_weight:g})")
            else:
                log(f"stage {stage_no}: ring penalty inert "
                    "(no resonance-band modes for this operator)")

        causal_arg = None
        if spec.causal_eps > 0:
            if spec.causal_axis not in problem.coords:
                raise ValueError(
                    f"causal_eps>0 needs coordinate {spec.causal_axis!r} "
                    f"in the problem's coords {problem.coords} — set "
                    "TrainSpec.causal_axis to the evolution coordinate")
            cax = problem.coords.index(spec.causal_axis)
            causal_arg = {"axis": cax, "t0": float(problem.lb[cax]),
                          "t1": float(problem.ub[cax]),
                          "bins": int(spec.causal_bins),
                          "eps": float(spec.causal_eps), "mesh": mesh}
            log(f"stage {stage_no}: causal weighting on "
                f"{spec.causal_axis!r} ({spec.causal_bins} slabs, "
                f"eps {spec.causal_eps:g}, Adam phase)")

        def build_loss(pred, engine, causal=None, ring=ring_arg):
            # the kernels serve plain dense (optionally hard-BC wrapped)
            # predictors without deriv_loss: decided by structure, before
            # any kernel runs
            if engine == "kernel":
                why = loss_mod.kernel_engine_unavailable(pred, spec.deriv_loss)
                if why is not None:
                    log(f"[stage {stage_no}] engine='kernel' unavailable for "
                        f"this stage ({why}); using 'auto'")
                    engine = "auto"
            return loss_mod.make_loss(pred, compiled_st, source_fn,
                                      deriv_loss=spec.deriv_loss,
                                      engine=engine,
                                      residual_weight_fn=rw_fn,
                                      bc_operators=bc_ops, ring=ring,
                                      causal=causal)

        loss_fn = build_loss(predictor, spec.engine)
        # Adam-phase loss: another engine and/or causal weighting (causal
        # is Adam-only: the line search needs a self-consistent objective)
        adam_engine = spec.adam_engine or spec.engine
        if adam_engine != spec.engine or causal_arg is not None:
            loss_fn_adam = build_loss(predictor, adam_engine,
                                      causal=causal_arg)
        else:
            loss_fn_adam = loss_fn

        gen_adam = seeded(4 * si + 1, dev)
        gen_lbfgs = seeded(4 * si + 2, dev)
        data0_all = data0 = sample_fn(gen_adam, F0)
        sample_all = sample_fn
        if mesh is not None:
            # every rank draws the global batch and trains on its shard;
            # the losses' values and gradients reduce over the mesh
            shared = loss_fn_adam is loss_fn
            loss_fn = parallel.make_parallel_loss(loss_fn, mesh)
            loss_fn_adam = (loss_fn if shared else
                            parallel.make_parallel_loss(loss_fn_adam, mesh))
            sample_fn = parallel.sharded_sampler(sample_all, mesh)
            data0 = parallel.shard_data(data0_all, mesh)

        if wout and problem.dim <= 2:
            limit = [problem.lb[0], problem.ub[0]] + (
                [problem.lb[1], problem.ub[1]] if problem.dim == 2
                else [0.0, 1.0])
            x_col = data0_all["x_col"]
            if problem.dim == 1:
                x_col = torch.cat([x_col, torch.zeros_like(x_col)], dim=1)
            f0_np = F0.cpu().numpy()
            artifacts.write_collocation(
                wout / f"collocation_point_{stage_no}.npz",
                U=f0_np if problem.dim == 2 else f0_np.T,
                X_col=x_col.cpu().numpy(), limit=limit)

        # --- resume: reload a finished stage's checkpoint, skip training
        resumed = False
        ckpt_path = out / f"params_stage_{stage_no}.npz" if out else None
        if resume and ckpt_path is not None and ckpt_path.exists():
            try:
                loaded, meta = ckpt.load_pytree(ckpt_path, params)
            except (KeyError, ValueError, OSError) as e:
                log(f"stage {stage_no}: checkpoint unusable ({e}); retraining")
            else:
                if meta.get("problem") == problem.name:
                    params = loaded
                    resumed = True
                    log(f"stage {stage_no}: resumed from {ckpt_path.name}")

        if not resumed:
            # --- normalization reference = the loss at initialization
            with torch.no_grad():
                ref = optim.evaluate_loss(
                    loss_fn, params, data0, stage_lw,
                    torch.ones((), dtype=dtype, device=dev))[1][0]
            log(f"stage {stage_no}: initial loss {float(ref):.4e}")

            adam_cfg = optim.AdamConfig(
                epochs=st.adam_epochs,
                lr=(st.lr if st.lr is not None else spec.lr),
                resample_every=spec.resample_every,
                density_every=spec.density_every,
                plateau_every=spec.plateau_every, lr_min=spec.lr_min,
                tail_max=spec.tail_max, log_every=spec.log_every,
                layout=spec.adam_layout)
            adam_log = None
            if log_fn is not None or print_log:
                from tpinn_torch.utils.logging import format_step_line

                def adam_log(step, loss_info):
                    log(format_step_line(int(step), loss_info))

            phase = optim.make_adam_phase(loss_fn_adam, sample_fn, density_fn,
                                          adam_cfg, info_width, adam_log)

            # --- mid-stage checkpoint / resume (log-chunk granularity)
            adam_ckpt = (out / f"adam_state_stage_{stage_no}.npz"
                         if out else None)
            init_phase = None
            if resume and adam_ckpt is not None and adam_ckpt.exists():
                def load_state(ph, layout):
                    return _load_phase(adam_ckpt, ph, layout, st.adam_epochs,
                                       gen_adam, params, data0_all, F0, ref,
                                       mesh)

                try:
                    init_phase = load_state(phase, spec.adam_layout)
                    log(f"stage {stage_no}: resuming Adam mid-stage at step "
                        f"{init_phase[0]}/{st.adam_epochs}")
                except _UNUSABLE as e:
                    # a file written under the other adam_layout finishes
                    # THIS stage under its own layout (same math)
                    other = "tree" if spec.adam_layout == "flat" else "flat"
                    cfg_other = replace(adam_cfg, layout=other)
                    phase_other = optim.make_adam_phase(
                        loss_fn_adam, sample_fn, density_fn, cfg_other,
                        info_width, adam_log)
                    try:
                        init_phase = load_state(phase_other, other)
                    except _UNUSABLE:
                        log(f"stage {stage_no}: mid-stage checkpoint "
                            f"unusable ({e}); restarting the Adam phase")
                    else:
                        phase, adam_cfg = phase_other, cfg_other
                        log(f"stage {stage_no}: checkpoint predates the "
                            f"'{spec.adam_layout}' Adam layout — resuming "
                            f"this stage under layout='{other}' at step "
                            f"{init_phase[0]}/{st.adam_epochs}")
            ckpt_cb = None
            if adam_ckpt is not None and spec.checkpoint_every > 0:
                ckpt_cb = _phase_saver(adam_ckpt, spec.checkpoint_every,
                                       st.adam_epochs, adam_cfg.layout,
                                       init_phase[0] if init_phase else 0,
                                       mesh)

            with adam_matmul_precision(spec.adam_precision):
                res = phase(gen_adam, params, data0, F0, stage_lw, ref,
                            ckpt_cb=ckpt_cb, init=init_phase)
            params = res.params
            n_adam = res.n_valid
            hist_adam = res.history[:n_adam].cpu().numpy()
            if n_adam:
                log(f"stage {stage_no}: Adam done ({n_adam} steps, "
                    f"final loss {hist_adam[-1, 0]:.4e}, "
                    f"lr {float(res.lr):.2e})")

            # --- L-BFGS (max_iters = epochs/3), in `lbfgs_rounds` restarts
            #     with a density refresh + fresh point draw between rounds
            rounds = max(1, st.lbfgs_rounds)
            lbfgs_cfg = optim.LBFGSConfig(
                max_iters=max(1, int(st.lbfgs_epochs / 3 / rounds)),
                tolerance=1e-10, history=spec.lbfgs_history)
            lbfgs_dtype = dtype
            if spec.lbfgs_dtype is not None:
                lbfgs_dtype = _DTYPES[spec.lbfgs_dtype]
                if lbfgs_dtype == torch.float64:
                    log(f"stage {stage_no}: L-BFGS polish in float64")

            grid_fixed = None
            if st.lbfgs_grid:
                grid_fixed = _grid_data(problem, st.lbfgs_grid, dtype, dev)
                log(f"stage {stage_no}: L-BFGS on deterministic "
                    f"{st.lbfgs_grid}^{problem.dim} grid "
                    f"({grid_fixed['x_col'].shape[0]} pts)")
                sample_fn_l = None
            elif st.lbfgs_sample_scale != 1.0:
                ls = st.lbfgs_sample_scale * sc
                lcfg = sample.SamplerConfig(
                    n_col=_rc(int(spec.n_col * ls)),
                    n_band=_rc(int(spec.n_band * ls)),
                    n_adaptive=_rc(int(spec.n_adaptive * ls)),
                    n_bd=_rc(int(spec.n_bd * ls)), grid=spec.grid)
                mk = (sample.make_sampler_1d if problem.dim == 1
                      else sample.make_sampler)
                sample_fn_l, _ = mk(lcfg, problem.bc_groups, problem.lb,
                                    problem.ub, dtype, dev)
            else:
                sample_fn_l = sample_all

            # lbfgs_device="cpu": the rounds run on the host CPU on the
            # stage's loss rebuilt there (its chain and constants on the
            # CPU; on a CPU run the same loss, built anew); the density
            # draws stay on the training device
            where, loss_l = dev, loss_fn
            if spec.lbfgs_device == "cpu":
                where = torch.device("cpu")
                lb_c, ub_c = lb.to(where), ub.to(where)
                pred_c = _raw_chain(raw_specs, feature_map, lb_c, ub_c)
                if hard_fns is not None:
                    pred_c = net.wrap_hard_bc(pred_c, *hard_fns)
                loss_l = build_loss(pred_c, spec.engine, ring=None if (
                    ring_arg is None) else _to_device(ring_arg, where))
                log(f"stage {stage_no}: L-BFGS on the host CPU "
                    f"(lbfgs_device='cpu')")

            hist_parts = []
            for ri in range(rounds):
                if grid_fixed is not None:
                    data_lbfgs = grid_fixed
                else:
                    with torch.no_grad():
                        Fs = density_fn(params)
                    data_lbfgs = sample_fn_l(gen_lbfgs, Fs)
                if lbfgs_dtype != dtype:
                    params = _cast_tree(params, lbfgs_dtype)
                    data_lbfgs = _cast_tree(data_lbfgs, lbfgs_dtype)
                # this rank's shard; the polish solves over the global set
                data_l = (data_lbfgs if mesh is None
                          else parallel.shard_data(data_lbfgs, mesh))
                params, hist_full, n_rows = optim.lbfgs_over_pytree(
                    loss_l, _to_device(params, where),
                    _to_device(data_l, where),
                    stage_lw.to(where, lbfgs_dtype),
                    ref.to(where, lbfgs_dtype), lbfgs_cfg)
                params = _to_device(params, dev)
                if lbfgs_dtype != dtype:
                    # back to the training dtype for later stages
                    params = _cast_tree(params, dtype)
                part = hist_full[:n_rows].cpu().numpy()
                hist_parts.append(part)
                unit = ("fn evaluations" if spec.lbfgs_history == "evals"
                        else "accepted iterations")
                log(f"stage {stage_no}: L-BFGS round {ri + 1}/{rounds} done "
                    f"({n_rows - 1} {unit}, final loss {part[-1, 0]:.4e})")
                params = _lsq_polish_round(
                    spec, problem, stage_no, predictor, compiled_st, params,
                    grid_fixed if grid_fixed is not None else data_lbfgs,
                    float(stage_lw[0]), source_fn, rw_fn, has_op_bc, dtype,
                    log)
            hist_lbfgs = np.concatenate(hist_parts, axis=0)
        else:
            hist_adam = np.zeros((0, info_width), np.float64)
            hist_lbfgs = np.zeros((0, info_width), np.float64)

        # --- evaluation + diagnostics (float64 on the device)
        frozen = _freeze(predictor, params)
        u_star, f_star, exact64 = eval_stage_f64(
            predictor, params, X_star, compiled_st, source_fn, problem.exact)

        # --- spectral error correction (final stage only)
        defl = None
        if si == len(spec.stages) - 1 and spec.deflation != "off":
            defl = _final_correction(spec, problem, predictor, compiled_st,
                                     params, source_fn, has_op_bc, log)
        if defl is not None:
            du, df = polish.deflation_fields(
                defl, compiled_st, X_star.to(torch.float64).cpu().numpy())
            if exact64 is not None:
                # pre-correction accuracy, kept in the correction meta so
                # every run records its own before/after pair
                defl["rel_l2_before"] = float(
                    rms(u_star - exact64) / (rms(exact64) + 1e-300))
            u_star = u_star - du
            term = polish.deflation_term(defl)
            frozen = lambda z, _raw=frozen, _t=term: _raw(z) - _t(z)
            if df is None:
                # nonlinear: the residual is not affine in the correction
                # — recompute it from the corrected predictor instead of
                # adjusting the field
                pred_corr = (lambda p, z, _p=predictor, _t=term:
                             _p(p, z) - _t(z))
                _, f_star, _ = eval_stage_f64(
                    pred_corr, params, X_star, compiled_st, source_fn, None)
            else:
                f_star = f_star - df
            log(f"stage {stage_no}: spectral correction "
                f"({defl['kind']}) removed {len(defl['modes'])} modes, "
                f"|du|_rms {float(np.sqrt((du ** 2).mean())):.3e}")

        if problem.dim == 1:
            U = u_star[:, 0][None, :]                 # [1, nx]
            F = f_star[:, 0][None, :]
        elif problem.dim == 2:
            ny, nx = int(spec.testing_size[1]), int(spec.testing_size[0])
            U = u_star.reshape(ny, nx)
            F = f_star.reshape(ny, nx)
        else:
            U, F = u_star, f_star

        r_rms = float(rms(f_star))
        e_rms = None
        if exact64 is not None:
            e_rms = float(rms(u_star - exact64))
        log(f"stage {stage_no}: residual RMS {r_rms:.4e}"
            + (f", error RMS {e_rms:.4e}" if e_rms is not None else ""))

        hist_stage = np.concatenate([hist_adam, hist_lbfgs], axis=0)
        histories.append(hist_stage)
        hist_cum = np.concatenate(histories, axis=0)

        if mesh is not None:
            mesh.check_replicas(params, f"stage {stage_no} parameters")
        if wout and not resumed:
            if problem.dim <= 2:
                _write_stage_artifacts(
                    wout, stage_no, problem, spec, axes, U, F, exact_star,
                    hist_stage if stage_no == 1 else hist_cum)
            else:
                artifacts.write_loss(wout / f"loss_{stage_no}.npz",
                                     hist_stage if stage_no == 1 else hist_cum)
            ckpt.save_pytree(
                wout / f"params_stage_{stage_no}.npz", params,
                meta={"stage": stage_no, "scl": float(scl),
                      "epsil": float(epsil), "problem": problem.name,
                      "chain": chain_specs,
                      "feature_kinds": list(problem.feature_kinds),
                      "lb": list(problem.lb), "ub": list(problem.ub),
                      "hard_bc": (list(problem.hard_bc)
                                  if problem.hard_bc else None),
                      "coords": list(problem.coords),
                      "pad_features": spec.pad_features,
                      # JSON-safe spectral correction; serving subtracts
                      # polish.deflation_term(meta["deflation"])
                      "deflation": defl})

        stage_results.append(StageResult(
            params=params, predictor_frozen=frozen, history=hist_stage,
            r_rms=r_rms, e_rms=e_rms, U=U, F=F, scl=float(scl),
            epsil=float(epsil)))
        prev_predictor = raw_predictor  # composition extends the raw chain
        prev_specs = raw_specs
        prev_params = params
        prev_diag = (r_rms, e_rms)

    final = stage_results[-1]
    rel_l2 = None
    if exact64 is not None:
        if problem.eval_mask is not None:
            m = problem.eval_mask(X_star).to(torch.float64).cpu().numpy()
            m = m.reshape(-1)
            du = (u_star.reshape(-1) - exact64.reshape(-1)) * m
            rel_l2 = float(np.linalg.norm(du)
                           / np.linalg.norm(exact64.reshape(-1) * m))
            log(f"final rel-L2 vs analytic (masked, "
                f"{int(m.sum())}/{m.size} pts): {rel_l2:.4e}")
        else:
            rel_l2 = float(np.linalg.norm(u_star - exact64)
                           / np.linalg.norm(exact64))
            log(f"final rel-L2 vs analytic: {rel_l2:.4e}")

    return TrainResult(problem=problem, spec=spec, stages=stage_results,
                       predict=final.predictor_frozen, rel_l2=rel_l2,
                       history=np.concatenate(histories, axis=0))


def _lsq_polish_round(spec, problem, stage_no, predictor, compiled, params,
                      data, lw0, source_fn, rw_fn, has_op_bc, dtype, log):
    """The exact last-layer least-squares solve after one L-BFGS round
    (linear PDEs).  Applied after EVERY round: with lbfgs_rounds > 1 this
    is variable projection — L-BFGS moves the hidden features, the float64
    solve re-lands the output layer on the convex subproblem's optimum
    each time.  Returns the parameters to go on with, in ``dtype``."""
    if spec.lsq_polish == "off":
        return params
    if problem.eval_mask is not None:
        # masked non-box domain: the polish's quadrature spans the
        # BOUNDING box, and the dead region's residual is unconstrained —
        # a solve over it would bake garbage ("on" was refused up front)
        log(f"stage {stage_no}: lsq_polish skipped (masked non-box domain)")
        return params
    if has_op_bc and problem.hard_bc is None:
        # the polish's soft-BC rows pin VALUES at z_bd; operator groups
        # (Neumann/Robin) would be silently treated as Dirichlet.  Hard-BC
        # runs are unaffected (boundary rows unused).
        if spec.lsq_polish == "on":
            raise ValueError(
                "lsq_polish='on' with operator (Neumann/Robin) BC groups "
                "needs hard_bc; use lsq_polish='off'")
        log(f"stage {stage_no}: lsq_polish skipped (operator BC groups pin "
            f"derivatives, not values)")
        return params
    if not compiled.is_linear and spec.lsq_polish == "auto":
        log(f"stage {stage_no}: lsq_polish skipped (equation nonlinear in u)")
        return params
    t0 = time.perf_counter()
    new_params, pinfo = polish.last_layer_lsq(
        predictor, compiled, params, data, lw0, source_fn,
        residual_weight_fn=rw_fn)
    log(f"stage {stage_no}: lsq polish objective {pinfo['pre']:.4e} -> "
        f"{pinfo['post']:.4e}{'' if pinfo['applied'] else ' (not applied)'} "
        f"in {time.perf_counter() - t0:.2f} s")
    return _cast_tree(new_params, dtype) if pinfo["applied"] else params


def _final_correction(spec, problem, predictor, compiled, params, source_fn,
                      has_op_bc, log):
    """The final stage's spectral defect correction (polish.
    defect_correction), or None where it does not apply."""
    if problem.eval_mask is not None:
        # box-spectral correctors integrate the bounding box; the dead
        # region's unconstrained residual would pollute every modal
        # coefficient
        log("deflation skipped: masked non-box domain")
        return None
    if has_op_bc and problem.hard_bc is None:
        # the soft-BC Chebyshev path treats the boundary trace as known
        # Dirichlet data; operator groups don't provide one
        log("deflation skipped: operator (Neumann/Robin) BC groups have no "
            "Dirichlet boundary trace")
        return None
    if not (compiled.is_linear or spec.deflation == "full"):
        # nonlinear operators are admitted on "full" only: the Galerkin
        # path linearizes the residual (one Newton step in the error);
        # "auto" deflation stays linear-only
        return None
    t0 = time.perf_counter()
    defl = polish.defect_correction(
        predictor, params, compiled, problem.lb, problem.ub, problem.hard_bc,
        mode=spec.deflation, source_fn=source_fn, coords=problem.coords,
        bc_groups=problem.bc_groups)
    log(f"deflation={spec.deflation!r}: "
        + (f"{defl['kind']} correction" if defl else "no applicable "
           "correction") + f" in {time.perf_counter() - t0:.2f} s")
    return defl


def _freeze(predictor, params):
    from tpinn_torch.core import taylor

    frozen = lambda z: predictor(params, z)
    return taylor.attach_frozen_meta(frozen, predictor, params)


def _grid_data(problem: ProblemSpec, g: int, dtype, device="cpu") -> dict:
    """Deterministic L-BFGS point set: a g^dim tensor grid of collocation
    points plus g evenly spaced points per BC group along its box."""
    axes = [torch.linspace(problem.lb[i], problem.ub[i], g, dtype=dtype,
                           device=device) for i in range(problem.dim)]
    if problem.dim == 1:
        x_col = axes[0][:, None]
    elif problem.dim == 2:
        A, B = torch.meshgrid(axes[0], axes[1], indexing="xy")
        x_col = torch.stack([A.reshape(-1), B.reshape(-1)], dim=1)
    else:
        meshes = torch.meshgrid(*axes, indexing="ij")
        x_col = torch.stack([A.reshape(-1) for A in meshes], dim=1)
    x_bd, u_bd = [], []
    for grp in problem.bc_groups:
        lo = torch.tensor(grp.lo, dtype=dtype, device=device)
        hi = torch.tensor(grp.hi, dtype=dtype, device=device)
        varying = [i for i in range(problem.dim) if grp.hi[i] != grp.lo[i]]
        if len(varying) <= 1:
            ts = torch.linspace(0.0, 1.0, g, dtype=dtype, device=device)[:, None]
            pts = lo[None, :] + ts * (hi - lo)[None, :]
        else:
            m = int(np.ceil(g ** (1.0 / len(varying))))
            axes_v = [torch.linspace(grp.lo[i], grp.hi[i], m, dtype=dtype,
                                     device=device) for i in varying]
            mesh_v = torch.meshgrid(*axes_v, indexing="ij")
            n_pts = mesh_v[0].numel()
            cols = [mesh_v[varying.index(i)].reshape(-1) if i in varying
                    else torch.full((n_pts,), grp.lo[i], dtype=dtype,
                                    device=device)
                    for i in range(problem.dim)]
            pts = torch.stack(cols, dim=1)
        x_bd.append(pts)
        u_bd.append(grp.target(pts))
    return {"x_col": x_col, "x_bd": x_bd, "u_bd": u_bd}


def _residual_with_source(compiled, source_fn, frozen, z):
    f = compiled.residual(frozen, z)
    if source_fn is not None:
        f = f - source_fn(z)
    return f


def _write_stage_artifacts(out, stage_no, problem, spec, axes, U, F,
                           exact_star, hist):
    """The per-stage artifact set (numpy in, the JAX package's files out)."""
    r_vec = axes[0].cpu().numpy()
    if problem.dim == 1:
        t_vec = np.zeros(1)
        ny, nx = 1, r_vec.shape[0]
    else:
        t_vec = axes[1].cpu().numpy()
        ny, nx = t_vec.shape[0], r_vec.shape[0]

    artifacts.write_solution_residual(
        out / f"solution_residual_{stage_no}.npz", r_vec, t_vec, U, F, stage_no)
    if exact_star is not None:
        U_real = np.asarray(exact_star).reshape(ny, nx)
        artifacts.write_error(out / f"error_{stage_no}.npz", r_vec, t_vec,
                              U - U_real)
    artifacts.write_loss(out / f"loss_{stage_no}.npz", hist)

    k = hist.shape[1]
    xy_l = hist[:, 3] if k > 3 else np.zeros(hist.shape[0])
    xy_r = hist[:, 4] if k > 4 else np.zeros(hist.shape[0])
    artifacts.write_boundary_loss(out / f"boundary_loss_{stage_no}.npz",
                                  xy_l, xy_r)

    # frequency spectrum of the STAGE-1 residual field
    if stage_no == 1:
        mag = np.abs(np.fft.fftshift(np.fft.fft2(F)))
        dx = r_vec[1] - r_vec[0] if nx > 1 else 1.0
        dt = t_vec[1] - t_vec[0] if ny > 1 else 1.0
        freq_x = np.fft.fftshift(np.fft.fftfreq(nx, d=dx))
        freq_t = np.fft.fftshift(np.fft.fftfreq(ny, d=dt))
        artifacts.write_spectrum(out / "frequency_spectrum.npz", freq_x,
                                 freq_t, np.log1p(mag))


# ---------------------------------------------------------------------------
# Reference-schema entry point (the online calculator's)
# ---------------------------------------------------------------------------


# Whitelisted "advanced options" the UI may pass to run_pinn_training: the
# single source of truth shared with the controller's validation
# (tpinn_torch.app.controller.TrainingRequest).  Values are a tuple of
# allowed choices or a coercion type (int = must be integral).
UI_OPTION_SPEC = {
    "deflation": ("off", "auto", "full"),
    "lsq_polish": ("off", "auto", "on"),
    "adam_precision": ("highest", "high", "default"),
    "adam_engine": loss_mod.ENGINES,
    "lr_min": float,
    "lbfgs_rounds": int,
    "lbfgs_grid": int,
    "ring_weight": float,
    # causal residual weighting (TrainSpec.causal_eps/_bins): evolution
    # presets only; the axis stays the default "t"
    "causal_eps": float,
    "causal_bins": int,
    # time marching (core.march.run_time_marching): N sequential windows
    # along the SECOND coordinate (the UI's y/t axis); 0 = off
    "march": int,
    # inverse mode (core.inverse): unknown equation coefficients
    # "name=init[,name=init…]"; observations are synthesized from the
    # oracle preset's analytic solution
    "inverse_params": "coef_list",
    "n_obs": int,
    "obs_noise": float,
    "oracle": "preset_name",
}
_UI_STAGE_OPTIONS = frozenset({"lbfgs_rounds", "lbfgs_grid"})
_UI_INVERSE_OPTIONS = frozenset({"inverse_params", "n_obs", "obs_noise",
                                 "oracle"})
# the reference's polar Laplacian, the one equation whose analytic oracle
# u = log(r)/log(0.1) exact="auto" installs
_POLAR_LAPLACE = ("u_rr+1/r*u_r+1/r**2*u_tt", "u_rr+u_r/r+u_tt/r**2")


def parse_coef_list(s: str):
    """'lam=0.5,k=1' → (('lam', 'k'), (0.5, 1.0)); '' → ((), ())."""
    names, inits = [], []
    for part in str(s).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"inverse_params entries must be NAME=INIT, got {part!r}")
        n, v = part.split("=", 1)
        n = n.strip()
        if not n.isidentifier():
            raise ValueError(f"bad coefficient name {n!r}")
        names.append(n)
        inits.append(float(v))
    return tuple(names), tuple(inits)


def coerce_ui_option(key: str, value):
    """Validate and coerce one UI option against UI_OPTION_SPEC.

    Raises KeyError for unknown keys and ValueError for bad values (a
    non-integral number for an int option, a value outside the choices),
    so that callers validate BEFORE the training thread starts."""
    spec = UI_OPTION_SPEC[key]
    if isinstance(spec, tuple):
        if value not in spec:
            raise ValueError(f"option {key} must be one of {spec}, "
                             f"got {value!r}")
        return value
    if spec == "coef_list":
        parse_coef_list(value)  # raises ValueError on bad format
        return str(value)
    if spec == "preset_name":
        if not value:
            return ""
        from tpinn_torch import problems as _problems

        if str(value) not in _problems.PRESETS:
            raise ValueError(f"option {key}: unknown preset {value!r}")
        return str(value)
    try:
        f = float(value)
    except (TypeError, ValueError):
        raise ValueError(f"option {key} must be numeric, "
                         f"got {value!r}") from None
    if spec is int:
        i = int(f)
        if f != i:
            raise ValueError(f"option {key} must be an integer, "
                             f"got {value!r}")
        return i
    return f


def _polar_oracle(z: Tensor) -> Tensor:
    return torch.log(z[:, 0:1]) / math.log(0.1)


@one_run_at_a_time
def run_pinn_training(
    equation: str,
    boundary: dict,
    domain: dict,
    scl: float,
    epsil: float,
    sample_points: dict,
    network_size: dict,
    testing_size: dict,
    epochs: dict,
    equation_weight: dict,
    output_dir: str,
    coords: Optional[Tuple[str, ...]] = None,
    feature_kinds: Optional[Tuple[str, ...]] = None,
    exact: Optional[Callable] = "auto",
    log_fn: Optional[Callable] = None,
    dtype: str = "float32",
    options: Optional[dict] = None,
    device="cuda",
) -> TrainResult:
    """The reference's public entry (its kwarg schema, the equation string
    actually used), run on ``device`` ("cuda" fails without a card): the
    run that :func:`ui_problem_spec` describes."""
    problem, spec, march_n, inv_opts = ui_problem_spec(
        equation, boundary, domain, scl, epsil, sample_points, network_size,
        testing_size, epochs, equation_weight, coords=coords,
        feature_kinds=feature_kinds, exact=exact, dtype=dtype,
        options=options)
    if march_n:
        # windows along the second (y/t) coordinate; the composite's
        # artifact set lands at output_dir's top level
        from tpinn_torch.core.march import run_time_marching

        mres = run_time_marching(problem, spec, march_n,
                                 axis=problem.coords[1],
                                 output_dir=output_dir, log_fn=log_fn,
                                 print_log=log_fn is None, device=device)
        return TrainResult(
            problem=problem, spec=spec, stages=[], predict=mres.predict,
            rel_l2=mres.rel_l2,
            history=np.concatenate([r.history for r in mres.windows],
                                   axis=0))

    if inv_opts.get("inverse_params"):
        # identify the declared coefficients from observations synthesized
        # from an analytic oracle: the problem's own or a named preset's
        from tpinn_torch.core.inverse import InverseSpec, run_inverse

        names, inits = parse_coef_list(inv_opts["inverse_params"])
        if problem.exact is None and inv_opts.get("oracle"):
            from tpinn_torch import problems as _problems

            oracle = _problems.get_problem(inv_opts["oracle"])
            if oracle.dim != problem.dim:
                raise ValueError(
                    f"oracle preset {inv_opts['oracle']!r} is "
                    f"{oracle.dim}-D but the problem is {problem.dim}-D")
            problem = replace(problem, exact=oracle.exact)
        if problem.exact is None:
            raise ValueError(
                "inverse mode needs an analytic oracle to synthesize "
                "observations from — pick a preset (options.oracle) or use "
                "tpinn_torch.core.inverse.run_inverse with observations=")
        inv = InverseSpec(
            params=names, init=inits,
            n_obs=int(inv_opts.get("n_obs") or 200),
            obs_noise=float(inv_opts.get("obs_noise") or 0.0))
        dropped = [k for k in ("lsq_polish", "deflation")
                   if getattr(spec, k, "off") != "off"]
        if spec.ring_weight > 0:
            dropped.append("ring_weight")
        if spec.causal_eps > 0:
            dropped.append("causal_eps")
        if dropped:
            msg = ("inverse mode: option(s) "
                   f"{', '.join(dropped)} have no inverse-path "
                   "implementation and are ignored")
            (log_fn or (lambda m: print(m, file=sys.stderr)))(msg)
        # single stage: the coefficient stays live through every phase
        single = replace(spec, stages=spec.stages[:1])
        res = run_inverse(problem, inv, single, log_fn=log_fn,
                          print_log=log_fn is None, output_dir=output_dir,
                          device=device)
        return TrainResult(
            problem=problem, spec=single, stages=[], predict=res.predict,
            rel_l2=res.rel_l2, history=res.history)

    return run_training(problem, spec, output_dir=output_dir, log_fn=log_fn,
                        print_log=log_fn is None, device=device)


def ui_problem_spec(
    equation: str,
    boundary: dict,
    domain: dict,
    scl: float,
    epsil: float,
    sample_points: dict,
    network_size: dict,
    testing_size: dict,
    epochs: dict,
    equation_weight: dict,
    coords: Optional[Tuple[str, ...]] = None,
    feature_kinds: Optional[Tuple[str, ...]] = None,
    exact: Optional[Callable] = "auto",
    dtype: str = "float32",
    options: Optional[dict] = None,
):
    """What :func:`run_pinn_training` runs for its arguments: ``(problem,
    spec, march, inverse options)``, ``march`` the number of time windows
    (0: no marching) and the inverse options those of
    ``_UI_INVERSE_OPTIONS`` given.

    Coordinates default to inference from the equation (pde.infer_coords):
    polar r/t gets the hard periodic-θ embedding, cartesian x/y (or x/t)
    plain min-max features.  ``exact="auto"`` installs the analytic oracle
    u = log(r)/log(0.1) only when the equation is the polar Laplacian.
    The net reads its coordinates unpadded (``pad_features=0``; tpinn pads
    to 3 to dodge a TPU compiler fault, which leaves the function class
    unchanged).
    """
    if coords is None:
        coords = pde.infer_coords(equation)
        if len(coords) == 1:
            coords = ("x", "t")  # the UI always supplies a 2-D domain
    if feature_kinds is None:
        feature_kinds = tuple(
            net.PERIODIC if c == "t" and coords[0] == "r" else net.MINMAX
            for c in coords)
    if exact == "auto":
        exact = (_polar_oracle if coords == ("r", "t")
                 and equation.replace(" ", "") in _POLAR_LAPLACE else None)
    elif exact == "annulus":  # legacy explicit oracle selector
        exact = _polar_oracle

    groups = []
    for i in range(1, len(boundary) // 5 + 1):
        raw_u = boundary[f"bd_u{i}"]
        try:
            value, value_fn, value_expr = float(raw_u), None, None
        except (TypeError, ValueError):
            # expression-valued BC (e.g. the heat IC "sin(pi*x)")
            value = 0.0
            value_expr = str(raw_u)
            value_fn = pde.compile_coord_expr(value_expr, coords)
        groups.append(sample.BCGroup(
            lo=(boundary[f"bd_x{i}_min"], boundary[f"bd_y{i}_min"]),
            hi=(boundary[f"bd_x{i}_max"], boundary[f"bd_y{i}_max"]),
            value=value, value_fn=value_fn, value_expr=value_expr))

    problem = ProblemSpec(
        name="ui", equation=equation, coords=coords,
        lb=(domain["x_min"], domain["y_min"]),
        ub=(domain["x_max"], domain["y_max"]),
        bc_groups=tuple(groups), feature_kinds=feature_kinds, exact=exact)

    # the reference swaps depth and width: UI "width" is the hidden-layer
    # count, UI "depth" the units per layer
    spec = TrainSpec(
        n_col=int(sample_points["n_col"]), n_band=int(sample_points["n_bd"]),
        n_adaptive=int(sample_points["n_add"]), n_bd=100,
        testing_size=(int(testing_size["x"]), int(testing_size["y"])),
        lw=(float(equation_weight["f"]), float(equation_weight["df"])),
        dtype=dtype,
        # one loss row per L-BFGS function evaluation, as the reference's
        # loss curves have
        lbfgs_history="evals",
    ).with_default_stages(
        depth=int(network_size["width"]), width=int(network_size["depth"]),
        adam=int(epochs["adam"]), lbfgs=int(epochs["lbfgs"]))
    s1 = replace(spec.stages[0], scl=float(scl), epsil=float(epsil))
    spec = replace(spec, stages=(s1, spec.stages[1]))

    # whitelisted TrainSpec / per-stage overrides, coerced through the
    # registry the controller validates against
    inv_opts = {}
    march_n = 0
    if options:
        coerced = {k: coerce_ui_option(k, v) for k, v in options.items()
                   if k in UI_OPTION_SPEC}
        inv_opts = {k: coerced.pop(k) for k in list(coerced)
                    if k in _UI_INVERSE_OPTIONS}
        march_n = int(coerced.pop("march", 0) or 0)
        spec_keys = {k: v for k, v in coerced.items()
                     if k not in _UI_STAGE_OPTIONS}
        if spec_keys:
            spec = replace(spec, **spec_keys)
        st_keys = {k: v for k, v in coerced.items()
                   if k in _UI_STAGE_OPTIONS}
        if st_keys:
            spec = replace(spec, stages=tuple(
                replace(s, **st_keys) for s in spec.stages))

    if march_n and inv_opts.get("inverse_params"):
        raise ValueError("march has no inverse-path implementation — "
                         "drop one of options.march / inverse_params")
    return problem, spec, march_n, inv_opts
