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
Taylor-2 stream recurrence, and kernel B1 (the fused Taylor-2 forward) as
a hand-written CUDA kernel for Hopper (``kernels.mlp_taylor``).  See
ROADMAP.md for what is still to come.
"""

__version__ = "0.1.0"
