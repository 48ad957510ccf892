"""Network zoo on tensors: dense PINN MLPs, feature maps, stage composition.

Port of ``tpinn.core.net`` with the same parameter pytree
(``{"layers": [{"w": [din, dout], "b": [dout]}, ...]}``) so checkpoints
and converted JAX parameters plug in unchanged:

- Xavier-scaled truncated-normal (±2σ) init for weights AND biases, drawn
  from a ``torch.Generator``.
- Per-coordinate feature map (minmax, periodic, periodic_fit, identity,
  with ``pad_to`` column duplication for checkpoints trained that way).
- First activation tanh/sin with ``scl`` inside it, hidden activation,
  linear output, output amplitude ``epsil``.
- Multi-stage composition u = u_prev + NN with the previous stage frozen
  (its parameters go through ``detach``), and the hard-BC ansatz
  u = lift + bubble·N.

- The random-Fourier-feature family (``fourier_features`` > 0: the
  embedded input goes through ``[cos(h·B), sin(h·B)]`` with a trainable
  projection ``fourier_b``) and the modified MLP of Wang et al.
  (``modified``: two gate encoders ``gate_u``, ``gate_v`` and the
  per-layer interpolation ``h ← (1−t)·u + t·v``).  Both extend the
  pytree beside ``layers``; they lie outside kernels B1/B2 (plain dense
  only), so their derivatives come from the generic jvp engine.

Every dense product is full fp32 (``torch.matmul`` with TF32 left off):
``MLPSpec.precision`` is carried only so JAX checkpoint metas load.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Callable, List, Sequence, Tuple

import torch

Tensor = torch.Tensor
Params = List[dict]  # [{"w": [din, dout], "b": [dout]} per layer]

# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_mlp(
    generator: torch.Generator,
    sizes: Sequence[int],
    device,
    dtype=torch.float32,
) -> Params:
    """Xavier truncated-normal init for a dense chain ``sizes[0]→…→sizes[-1]``.

    Draws happen on ``generator``'s device, then move to ``device``, so a
    CPU generator gives the same weights on every device."""
    params: Params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        std = math.sqrt(2.0 / (din + dout))
        layer = {}
        for name, shape in (("w", (din, dout)), ("b", (dout,))):
            t = torch.empty(shape, dtype=dtype, device=generator.device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            layer[name] = (t * std).to(device)
        params.append(layer)
    return params


# ---------------------------------------------------------------------------
# Feature maps
# ---------------------------------------------------------------------------

MINMAX = "minmax"
PERIODIC = "periodic"
PERIODIC_FIT = "periodic_fit"
IDENTITY = "identity"

_FEATURE_WIDTH = {MINMAX: 1, PERIODIC: 2, PERIODIC_FIT: 2, IDENTITY: 1}


@dataclass(frozen=True)
class FeatureMap:
    """Per-coordinate input embedding.

    ``kinds[i]`` ∈ {"minmax", "periodic", "periodic_fit", "identity"}.
    ``pad_to``: minimum output width; duplicates of the first column are
    appended until the embedding has at least this many columns (the
    model class is unchanged)."""

    kinds: Tuple[str, ...]
    pad_to: int = 0

    @property
    def num_features(self) -> int:
        base = sum(_FEATURE_WIDTH[k] for k in self.kinds)
        return max(base, self.pad_to)

    def __call__(self, z: Tensor, lb: Tensor, ub: Tensor) -> Tensor:
        cols = []
        for i, kind in enumerate(self.kinds):
            x = z[:, i : i + 1]
            if kind == MINMAX:
                cols.append(2.0 * (x - lb[i]) / (ub[i] - lb[i]) - 1.0)
            elif kind == PERIODIC:
                cols.append(torch.cos(x))
                cols.append(torch.sin(x))
            elif kind == PERIODIC_FIT:
                w = 2.0 * math.pi * (x - lb[i]) / (ub[i] - lb[i])
                cols.append(torch.cos(w))
                cols.append(torch.sin(w))
            elif kind == IDENTITY:
                cols.append(x)
            else:  # pragma: no cover - guarded by feature_map_for
                raise ValueError(f"unknown feature kind {kind!r}")
        while len(cols) < self.pad_to:
            cols.append(cols[0])
        return torch.cat(cols, dim=1)


def feature_map_for(kinds: Sequence[str], pad_to: int = 0) -> FeatureMap:
    for k in kinds:
        if k not in _FEATURE_WIDTH:
            raise ValueError(f"unknown feature kind {k!r}")
    return FeatureMap(tuple(kinds), pad_to=int(pad_to))


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

_ACTIVATIONS = {"tanh": torch.tanh, "sin": torch.sin}


def activation(name: str) -> Callable[[Tensor], Tensor]:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None


# ---------------------------------------------------------------------------
# Model specs / apply functions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLPSpec:
    """Architecture + scaling of one PINN stage network (fields as in
    ``tpinn.core.net.MLPSpec``).

    :param depth: number of hidden layers.
    :param width: units per hidden layer.
    :param out_dim: network outputs (1 for scalar PDEs).
    :param act_first: first-layer activation, "tanh" or "sin".
    :param act_hidden: hidden-layer activation.
    :param scl: frequency scale applied inside the first activation.
    :param epsil: output amplitude multiplier.
    :param fourier_features: if > 0, the embedded input is replaced by
        this many random Fourier features (cos and sin of each), drawn
        with std ``fourier_scale``.
    :param modified: the modified-MLP gating of Wang et al. (2021).
    :param precision: carried for checkpoint compatibility; products are
        always full fp32 here.
    """

    depth: int
    width: int
    out_dim: int = 1
    act_first: str = "tanh"
    act_hidden: str = "tanh"
    scl: float = 1.0
    epsil: float = 1.0
    fourier_features: int = 0
    fourier_scale: float = 1.0
    modified: bool = False
    precision: str = "highest"

    @property
    def is_plain(self) -> bool:
        return not (self.fourier_features or self.modified)


def init_params(
    generator: torch.Generator,
    spec: MLPSpec,
    feature_map: FeatureMap,
    device,
    dtype=torch.float32,
) -> dict:
    """Initialize the parameter pytree for ``spec``: ``{"layers": [...]}``,
    with ``fourier_b`` [n_in, F] and the ``gate_u``/``gate_v`` layers beside
    it for the other families.  Draw order: ``fourier_b``, the layers, the
    gates."""
    n_in = feature_map.num_features
    p: dict = {}
    if spec.fourier_features:
        b = torch.randn((n_in, spec.fourier_features), dtype=dtype,
                        device=generator.device, generator=generator)
        p["fourier_b"] = (b * spec.fourier_scale).to(device)
        n_in = 2 * spec.fourier_features
    sizes = [n_in] + [spec.width] * spec.depth + [spec.out_dim]
    p["layers"] = init_mlp(generator, sizes, device, dtype)
    if spec.modified:
        for name in ("gate_u", "gate_v"):
            p[name] = init_mlp(generator, [n_in, spec.width], device, dtype)[0]
    return p


def mlp_hidden(params: dict, h: Tensor, spec: MLPSpec) -> Tensor:
    """Dense chain up to (and excluding) the output layer: the feature
    basis ``[N, width]`` that the output layer combines linearly (the
    last-layer solve of core.polish treats the net as this basis)."""
    act0 = activation(spec.act_first)
    acth = activation(spec.act_hidden)
    if spec.fourier_features:
        proj = torch.matmul(h, params["fourier_b"])
        h = torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)
    first, *hidden, _last = params["layers"]
    if spec.modified:
        gu, gv = params["gate_u"], params["gate_v"]
        u = torch.tanh(torch.matmul(h, gu["w"]) + gu["b"])
        v = torch.tanh(torch.matmul(h, gv["w"]) + gv["b"])
        h = act0(torch.matmul(h, first["w"]) * spec.scl + first["b"])
        h = (1.0 - h) * u + h * v
        for layer in hidden:
            t = acth(torch.matmul(h, layer["w"]) + layer["b"])
            h = (1.0 - t) * u + t * v
    else:
        h = act0(torch.matmul(h, first["w"]) * spec.scl + first["b"])
        for layer in hidden:
            h = acth(torch.matmul(h, layer["w"]) + layer["b"])
    return h


def mlp_apply(params: dict, h: Tensor, spec: MLPSpec) -> Tensor:
    """Dense chain on already-embedded features ``h``."""
    h = mlp_hidden(params, h, spec)
    last = params["layers"][-1]
    return torch.matmul(h, last["w"]) + last["b"]


# ---------------------------------------------------------------------------
# Predictors (feature map + network + amplitude), and stage composition
# ---------------------------------------------------------------------------


def make_predictor(
    spec: MLPSpec,
    feature_map: FeatureMap,
    lb: Tensor,
    ub: Tensor,
) -> Callable[[dict, Tensor], Tensor]:
    """Build ``u(params, z)`` = epsil * MLP(features(z)).

    ``lb``/``ub`` are tensors on the device the predictor will run on."""

    def f_u(params: dict, z: Tensor) -> Tensor:
        h = feature_map(z, lb, ub)
        return spec.epsil * mlp_apply(params, h, spec)

    from tpinn_torch.core import taylor  # late import (taylor imports net)

    return taylor.attach_mlp_meta(f_u, spec, feature_map, lb, ub)


def detach_tree(tree):
    """The params pytree with every tensor detached (frozen stage)."""
    if isinstance(tree, dict):
        return {k: detach_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(detach_tree(v) for v in tree)
    return tree.detach()


def compose_stages(
    prev_predictor: Callable[[dict, Tensor], Tensor],
    spec: MLPSpec,
    feature_map: FeatureMap,
    lb: Tensor,
    ub: Tensor,
) -> Callable[[dict, Tensor], Tensor]:
    """Multilevel predictor ``u(z) = u_prev(prev_params, z) + NN(params, z)``
    on the nested pytree ``{"stage": <this stage>, "prev": <previous
    chain>}``; the ``prev`` subtree is detached, so it stays frozen."""

    stage_fn = make_predictor(spec, feature_map, lb, ub)

    def f_comb(params: dict, z: Tensor) -> Tensor:
        prev_u = prev_predictor(detach_tree(params["prev"]), z)
        return prev_u + stage_fn(params["stage"], z)

    from tpinn_torch.core import taylor  # late import (taylor imports net)

    return taylor.attach_sum_meta(f_comb, prev_predictor, stage_fn)


def compose_params(stage_params, prev_params) -> dict:
    """Parameter pytree for a composed predictor (see compose_stages)."""
    return {"stage": stage_params, "prev": prev_params}


def hard_bc_partials(raw_partials, lift_fn, bubble_fn):
    """Partials of ``u = lift + bubble·v`` from the RAW net's partials by
    the product rule:

        u_i  = l_i + b_i·v + b·v_i
        u_ij = l_ij + b_ij·v + b_i·v_j + b_j·v_i + b·v_ij

    lift/bubble derivatives come from the generic jvp engine;
    ``raw_partials(params, z, need)`` supplies v and its derivatives and
    may return a superset of ``need`` (kernel B1 returns its full stream
    set)."""

    def tpinn_partials(params, z, indices):
        from tpinn_torch.core import deriv

        need = set()
        for ix in indices:
            need.add(ix)
            if len(ix) == 2:
                need.add((ix[0],))
                need.add((ix[1],))
        need.add(())
        need = sorted(need, key=lambda t: (len(t), t))
        v = raw_partials(params, z, need)
        l = deriv.partials(lift_fn, z, need)
        b = deriv.partials(bubble_fn, z, need)
        out = {}
        for ix in indices:
            if ix == ():
                out[ix] = l[()] + b[()] * v[()]
            elif len(ix) == 1:
                out[ix] = (l[ix] + b[ix] * v[()] + b[()] * v[ix])
            else:
                i, j = ix
                out[ix] = (l[ix] + b[ix] * v[()]
                           + b[(i,)] * v[(j,)] + b[(j,)] * v[(i,)]
                           + b[()] * v[ix])
        return out

    return tpinn_partials


def wrap_hard_bc(raw_predictor, lift_fn, bubble_fn):
    """Hard boundary-condition ansatz ``u(z) = lift(z) + bubble(z)·N(z)``:
    ``lift`` meets the Dirichlet data, ``bubble`` vanishes on the
    constrained boundary, so u meets the BCs exactly for any net output.
    The raw chain stays reachable (``tpinn_raw``, ``tpinn_hard``)."""

    def f_hard(params, z):
        return lift_fn(z) + bubble_fn(z) * raw_predictor(params, z)

    raw_partials = getattr(raw_predictor, "tpinn_partials", None)
    if raw_partials is not None:
        f_hard.tpinn_partials = hard_bc_partials(
            raw_partials, lift_fn, bubble_fn
        )

    f_hard.tpinn_raw = raw_predictor
    f_hard.tpinn_hard = (lift_fn, bubble_fn)
    return f_hard


def spec_to_dict(spec: MLPSpec) -> dict:
    return asdict(spec)


def spec_from_dict(d: dict) -> MLPSpec:
    return MLPSpec(**d)
