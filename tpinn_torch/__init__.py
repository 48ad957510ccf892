"""tpinn_torch — the PyTorch/CUDA port of tpinn.

It mirrors ``tpinn``'s module layout so that the counterpart of every
ported module sits at the same path (``tpinn.core.pde`` ↔
``tpinn_torch.core.pde``), and keeps the JAX package's parameter pytree
(``{"layers": [{"w": [din, dout], "b": [dout]}, ...]}``, nested
``{"stage", "prev"}`` for composed chains) and checkpoint format, so the
two packages load each other's checkpoints and the parity tests feed both
the same weights.

The package imports ``torch`` and never ``jax``.  Ported so far: the
serving path (``app.serve``) for forward scalar checkpoints — the PDE
compiler, the generic ``torch.func.jvp`` derivative engine, the plain MLP
family with feature maps, hard-BC ansatz and stage composition, the
Taylor-2 stream recurrence; the training path (``core.train``) — samplers,
loss, the Adam automaton and L-BFGS, artifacts and checkpoints; and the
flagship recipe's float64 post-processing (``core.polish``: the exact
last-layer solve and the spectral defect corrections) with the recipes of
``problems``.  The hot path's three kernels are hand-written CUDA for
Hopper: the fused Taylor-2 forward (``kernels.mlp_taylor``), its backward
(``kernels.taylor_vjp``) and the flat Adam update (``kernels.adam``).  See
ROADMAP.md for what is still to come.
"""

__version__ = "0.1.0"
