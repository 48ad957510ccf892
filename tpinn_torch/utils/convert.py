"""Carry parameter pytrees, and an Adam phase's carry, between numpy (and
so the JAX package) and torch.

A tree is nested dicts and lists with array leaves — ``{"layers": [{"w",
"b"}, ...]}`` and ``{"stage": ..., "prev": ...}`` for composed chains.
The structure is kept as it is, so the same weights feed ``tpinn`` (as
numpy or JAX arrays) and ``tpinn_torch`` (as tensors).
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device, dtype=torch.float32):
    """Tree of array-likes (numpy, JAX arrays) → tree of tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    return torch.tensor(np.array(tree), dtype=dtype, device=device)


def params_to_numpy(tree):
    """Tree of tensors → tree of numpy arrays (on the host)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def phase_init_from_tpinn(params, count, mu, nu, lr, ring, data, F, hist,
                          generator, layout="flat", device="cpu",
                          dtype=torch.float32):
    """tpinn's Adam scan carry, as numpy, as the port's phase ``init``
    (core.optim.make_adam_phase): ``(done, state, hist)``.

    The carry is ``params`` with optax's ``count``, ``mu`` and ``nu``, the
    injected learning rate ``lr``, the plateau ``ring``, the point set
    ``data`` and the density ``F``; ``hist`` holds the loss rows so far.
    Under ``layout="flat"`` params, mu and nu are one vector each, under
    "tree" trees of the params' structure.  The JAX key is left out: the
    state takes ``generator``'s state in its place (the two packages'
    random streams differ by design)."""
    from tpinn_torch.core.optim import tree_leaves

    if layout not in ("flat", "tree"):
        raise ValueError(f"layout must be 'flat'|'tree', got {layout!r}")

    def vectors(tree):
        leaves = [tree] if layout == "flat" else tree_leaves(tree)
        return [torch.tensor(np.array(x).reshape(-1), dtype=dtype,
                             device=device) for x in leaves]

    state = {"p": vectors(params), "m": vectors(mu), "v": vectors(nu),
             "lr": torch.tensor(np.array(lr).reshape(1), dtype=dtype,
                                device=device),
             "ring": torch.tensor(np.array(ring), dtype=dtype, device=device),
             "data": params_from_numpy(data, device, dtype),
             "F": torch.tensor(np.array(F), dtype=dtype, device=device),
             "gen": generator.get_state()}
    return (int(np.asarray(count)), state,
            torch.tensor(np.array(hist), dtype=dtype, device=device))
