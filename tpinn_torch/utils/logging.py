"""The training progress line (a copy of ``tpinn.utils.logging``'s
``format_step_line``, so that the port imports nothing from ``tpinn``)."""

from __future__ import annotations


def format_step_line(step: int, loss_info) -> str:
    """The reference's per-100-step progress line."""
    return (
        f"Step: {step} | Loss: {float(loss_info[0]):.4e} |"
        f" Loss_d: {float(loss_info[1]):.4e} | Loss_e: {float(loss_info[2]):.4e} | "
    )
