"""Artifact writers of the 11-file ``.npz`` contract (numpy only).

A copy of ``tpinn.utils.artifacts``'s writers, so that the port imports
nothing from ``tpinn``: the same names, keys and atomic writes (temp file
+ rename, so a polling reader never sees a torn file).

    collocation_point_{1,2}.npz   {U, X_col, limit}
    solution_residual_1.npz       {r, t_vec, U, F}
    solution_residual_2.npz       {r, t, U, F}
    error_{1,2}.npz               {r, t, Error}
    loss_{1,2}.npz                {loss}           (stage 2 = concatenated)
    boundary_loss_{1,2}.npz       {loss_xy_l, loss_xy_r}
    frequency_spectrum.npz        {freq_x, freq_t, log_mag}
"""

from __future__ import annotations

import numpy as np

from tpinn_torch.utils.checkpoint import atomic_savez


def write_collocation(path, U, X_col, limit) -> None:
    atomic_savez(path, U=np.asarray(U), X_col=np.asarray(X_col),
                 limit=np.asarray(limit))


def write_solution_residual(path, r, t, U, F, stage: int) -> None:
    """Stage 1 uses the key 't_vec', later stages 't' (the reference's
    spelling; figure loaders read only U and F)."""
    kw = {"r": np.asarray(r), "U": np.asarray(U), "F": np.asarray(F)}
    kw["t_vec" if stage == 1 else "t"] = np.asarray(t)
    atomic_savez(path, **kw)


def write_error(path, r, t, Error) -> None:
    atomic_savez(path, r=np.asarray(r), t=np.asarray(t), Error=np.asarray(Error))


def write_loss(path, loss) -> None:
    atomic_savez(path, loss=np.asarray(loss))


def write_boundary_loss(path, loss_xy_l, loss_xy_r) -> None:
    atomic_savez(path, loss_xy_l=np.asarray(loss_xy_l),
                 loss_xy_r=np.asarray(loss_xy_r))


def write_spectrum(path, freq_x, freq_t, log_mag) -> None:
    atomic_savez(path, freq_x=np.asarray(freq_x), freq_t=np.asarray(freq_t),
                 log_mag=np.asarray(log_mag))


ARTIFACT_NAMES = [
    "collocation_point_1.npz",
    "collocation_point_2.npz",
    "solution_residual_1.npz",
    "solution_residual_2.npz",
    "error_1.npz",
    "error_2.npz",
    "loss_1.npz",
    "loss_2.npz",
    "boundary_loss_1.npz",
    "boundary_loss_2.npz",
    "frequency_spectrum.npz",
]
