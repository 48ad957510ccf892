"""Checkpoints of parameter pytrees (port of ``tpinn.utils.checkpoint``).

The same flat npz format as the JAX package: one array per leaf under
``leaf:<path>``, the path joining dict keys and list indices with ``/``
(dict keys in sorted order, as JAX flattens them), plus the JSON meta as
uint8 bytes under ``__meta__``.  A checkpoint written by either package
loads in the other.  Writes are atomic (temp file + rename), so a reader
never sees a torn file.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def atomic_savez(path, **arrays) -> None:
    """np.savez to a temp file in the same directory, then atomic rename."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _leaves_with_paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def save_pytree(path, tree, meta: Optional[Dict[str, Any]] = None) -> None:
    """Save a pytree of tensors as flat npz with path-string keys."""
    arrays = {f"leaf:{p}": v.detach().cpu().numpy()
              for p, v in _leaves_with_paths(tree)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    atomic_savez(path, **arrays)


def load_pytree(path, like) -> Tuple[Any, Dict[str, Any]]:
    """Load into the structure of the template pytree ``like``: each leaf
    takes the dtype and device of the template's leaf."""
    with np.load(path) as data:
        meta = (json.loads(bytes(data["__meta__"]).decode())
                if "__meta__" in data else {})

        def build(tree, prefix):
            if isinstance(tree, dict):
                return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(build(v, prefix + (str(i),))
                                  for i, v in enumerate(tree))
            key = "leaf:" + "/".join(prefix)
            if key not in data:
                raise KeyError(f"checkpoint {path} missing leaf {key}")
            if data[key].shape != tuple(tree.shape):
                raise ValueError(
                    f"checkpoint {path} leaf {key} has shape "
                    f"{data[key].shape}, expected {tuple(tree.shape)}")
            return torch.as_tensor(data[key], dtype=tree.dtype,
                                   device=tree.device)

        return build(like, ()), meta
