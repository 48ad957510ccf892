"""Problem specification (port of ``tpinn.core.train.ProblemSpec``).

Only the ``ProblemSpec`` record is ported so far; the training pipeline is
ROADMAP.md Queue A item 9.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from tpinn_torch.core import net, sample

Tensor = torch.Tensor


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
