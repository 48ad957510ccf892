"""Carry parameter pytrees between numpy (and so the JAX package) and torch.

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
