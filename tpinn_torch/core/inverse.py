"""Inverse problems: recover unknown PDE coefficients from observations.

Port of ``tpinn.core.inverse``, so far only :class:`InverseSpec`, which
``core.system.run_system(..., inverse=)`` reads to identify the unknown
coefficients of a coupled system.  The equation string declares the
coefficients (``params=("lam",)``), they become 0-d leaves of the joint
``{"net", "coef"}`` training tree, and an observation term identifies
them jointly with the network weights.

The scalar path (``make_inverse_loss``, ``synth_observations``,
``run_inverse``, the eigenvalue mode) is ROADMAP.md Queue A item 13c.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class InverseSpec:
    """What to identify: coefficient names, initial guesses, observations.

    ``params``/``init`` must align; the names must appear in the problem's
    equation strings.  When no observations are passed, ``n_obs`` points
    are LHS-drawn over the domain from a generator seeded with
    ``obs_seed`` and labelled by ``problem.exact`` (+ optional Gaussian
    noise of std ``obs_noise``).  ``normalize`` > 0 selects the eigenvalue
    mode of the scalar path (item 13c).
    """

    params: Tuple[str, ...]
    init: Tuple[float, ...]
    n_obs: int = 200
    obs_noise: float = 0.0
    obs_weight: float = 1.0
    obs_seed: int = 0
    normalize: float = 0.0

    def __post_init__(self):
        if len(self.params) != len(self.init):
            raise ValueError("InverseSpec.init must align with .params")
        if not self.params:
            raise ValueError("InverseSpec needs at least one parameter")
        if self.normalize < 0:
            raise ValueError("InverseSpec.normalize must be >= 0")
