"""Boundary-condition groups (port of ``tpinn.core.sample.BCGroup``).

Only the ``BCGroup`` record is ported so far, so that problem presets
carry their boundary data; the samplers are ROADMAP.md Queue A item 7.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class BCGroup:
    """One boundary-condition group: the box [lo, hi] where the solution is
    pinned to ``value`` (constant) or to a coordinate expression
    (``value_fn``; ``value_expr`` carries its source string).  ``field``
    selects the component of a coupled system; ``operator`` is a
    Neumann/Robin expression over u and its derivatives (None = Dirichlet).
    """

    lo: Tuple[float, ...]
    hi: Tuple[float, ...]
    value: float = 0.0
    value_fn: Optional[Callable[[Tensor], Tensor]] = None
    value_expr: Optional[str] = None
    field: int = 0
    operator: Optional[str] = None

    def target(self, pts: Tensor) -> Tensor:
        if self.value_fn is not None:
            return self.value_fn(pts)
        return torch.full((pts.shape[0], 1), self.value, dtype=pts.dtype,
                          device=pts.device)
