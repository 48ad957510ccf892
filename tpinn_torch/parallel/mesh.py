"""Process meshes for PINN training, on ``torch.distributed``.

Port of ``tpinn.parallel.mesh``.  tpinn annotates shardings under ``jit``
and lets XLA insert the collectives; here the run is multi-controller:
every rank calls the same ``run_*`` with the same arguments (``torchrun
--nproc_per_node=N``, or any launch that initializes the default process
group), and the collectives are explicit.  A mesh changes where the work
is done, never what is computed: every rank lands on the numbers of one
process at the mesh-rounded counts.

- **points** (data parallelism): every rank draws the GLOBAL batch with
  the same seeded generator and keeps its contiguous slice
  (:func:`sharded_sampler`, :func:`shard_data`); the loss is a mean over
  equal shards, or a term every rank computes whole (the ring penalty,
  the observations, ``ref``), so the global loss and gradient are the
  average over the points group of the local ones.  The optimizers
  (core.optim) pack ``[gradient, loss, loss_info]`` into one buffer and
  all-reduce it once a step (:meth:`Mesh.reduce_step`): the Adam update
  (kernel B3), the plateau and tail rules and the line search see the
  same numbers on every rank and take the same branches.
- **ensemble**: stacked members or patches; each ensemble group
  evaluates its ``1/E`` of them (core.patch's patch-parallelism,
  :func:`make_ensemble_loss`), the parameters stay whole on every rank,
  and the step's all-reduce sums each gradient from its owner.

Parameters are plain local tensors, not DTensors: kernels B1/B2 are
ctypes launches on raw pointers and the generic engine is
``torch.func.jvp``, neither of which dispatches through DTensor.
:func:`points_sharding` and :func:`replicated` keep tpinn's names and
return the placements that :func:`shard_data` applies.  Rank 0 writes
the artifacts and checkpoints (:func:`is_writer`).
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor

POINTS_AXIS = "points"
ENSEMBLE_AXIS = "ensemble"


def _require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "a mesh needs an initialized default process group: call "
            "torch.distributed.init_process_group (or launch with torchrun) "
            "on every rank first")


class _SumBackIdentity(torch.autograd.Function):
    """All-reduce SUM over ``group`` whose backward passes the cotangent
    through unchanged: every rank of the group computes the same loss
    from the sum, so each rank's own addend gets exactly its gradient
    (torch.distributed.nn's all_reduce sums the cotangents too, which
    scales the gradient by the group size here)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class Mesh:
    """An ``(ensemble, points)`` layout of the default group's ranks.

    ``ranks`` is the ``[E, P]`` array of global ranks; ``device_mesh`` the
    ``torch.distributed.device_mesh.DeviceMesh`` over it with dims
    ``("ensemble", "points")``; ``shape`` a dict, as tpinn's mesh.shape.
    This rank sits at ``(ensemble_index, points_index)``."""

    def __init__(self, ranks):
        from torch.distributed.device_mesh import DeviceMesh

        _require_group()
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != 2:
            raise ValueError(f"mesh ranks must be [ensemble, points], got "
                             f"shape {ranks.shape}")
        world = dist.get_world_size()
        if sorted(ranks.ravel().tolist()) != list(range(world)):
            raise ValueError(f"the mesh must hold every rank of the world "
                             f"({world}) once, got {ranks.tolist()}")
        self.ranks = ranks
        self.backend = str(dist.get_backend())
        self.device_mesh = DeviceMesh(
            "cuda" if self.backend == "nccl" else "cpu",
            torch.as_tensor(ranks), mesh_dim_names=(ENSEMBLE_AXIS,
                                                    POINTS_AXIS))
        self.shape = {ENSEMBLE_AXIS: int(ranks.shape[0]),
                      POINTS_AXIS: int(ranks.shape[1])}
        self.rank = dist.get_rank()
        e, p = np.argwhere(ranks == self.rank)[0]
        self.ensemble_index, self.points_index = int(e), int(p)
        self._groups = {ax: self.device_mesh.get_group(ax)
                        for ax in (ENSEMBLE_AXIS, POINTS_AXIS)}

    def __repr__(self):
        return (f"Mesh({self.shape}, ranks={self.ranks.tolist()}, "
                f"backend={self.backend!r})")

    def group(self, axis: str):
        return self._groups[axis]

    def all_reduce(self, x: Tensor, axis: str) -> Tensor:
        """Sum of ``x`` over this rank's group along ``axis``, a new
        tensor; no gradient."""
        y = x.detach().clone()
        dist.all_reduce(y, group=self.group(axis))
        return y

    def ensemble_sum(self, x: Tensor) -> Tensor:
        """Differentiable sum of ``x`` over this rank's ensemble group (the
        backward passes the cotangent through: every rank of the group
        then computes the same loss from the sum)."""
        if self.shape[ENSEMBLE_AXIS] == 1:
            return x
        return _SumBackIdentity.apply(x, self.group(ENSEMBLE_AXIS))

    def ensemble_gather(self, x: Tensor) -> Tensor:
        """``x`` of every rank of this rank's ensemble group, concatenated
        along dim 0 in ensemble order; no gradient."""
        n = self.shape[ENSEMBLE_AXIS]
        if n == 1:
            return x.detach()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.detach().contiguous(),
                        group=self.group(ENSEMBLE_AXIS))
        return torch.cat(parts, dim=0)

    def reduce_step(self, loss_n: Tensor, info: Tensor, grads,
                    sum_ensemble: bool = False):
        """The step's one collective: ``[gradient leaves, loss_n,
        loss_info]`` packed into one buffer and all-reduced once.  The
        points group averages them (equal shards: the global means).  With
        ``sum_ensemble`` (each ensemble group evaluated its own members or
        patches, the others' gradients are zero here) the gradient is also
        summed over the ensemble axis, over the whole world in the same
        call; the loss, equal within a group, is not.  Returns the reduced
        ``(loss_n, info, grads)``."""
        parts = [g.reshape(-1) for g in grads]
        n_grad = sum(p.numel() for p in parts)
        buf = torch.cat(parts + [loss_n.detach().reshape(1),
                                 info.detach().reshape(-1)])
        n_ens, n_pts = self.shape[ENSEMBLE_AXIS], self.shape[POINTS_AXIS]
        if sum_ensemble and n_ens > 1:
            buf[n_grad:] /= n_ens
            group = None
        else:
            group = self.group(POINTS_AXIS)
        dist.all_reduce(buf, group=group)
        if n_pts > 1:
            buf /= n_pts
        out, off = [], 0
        for g in grads:
            out.append(buf[off:off + g.numel()].view(g.shape))
            off += g.numel()
        return (buf[n_grad].reshape(loss_n.shape),
                buf[n_grad + 1:].view(info.shape), out)

    def check_replicas(self, tree, what: str = "parameters") -> str:
        """Raise RuntimeError unless every rank holds bitwise the same
        ``tree`` (a digest of its leaves' bytes, all-gathered); returns
        this rank's digest."""
        from tpinn_torch.core.optim import tree_leaves

        h = hashlib.sha256()
        for x in tree_leaves(tree):
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
        digest = h.hexdigest()
        code = int(digest[:15], 16)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if self.backend == "nccl" else torch.device("cpu"))
        mine = torch.tensor([code], dtype=torch.int64, device=dev)
        every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(every, mine)
        codes = [int(t.item()) for t in every]
        if len(set(codes)) != 1:
            raise RuntimeError(f"meshed run: the ranks' {what} differ "
                               f"(digest prefixes {codes})")
        return digest


def mesh_layout(ranks: Sequence[int], ensemble: int = 1,
                n_slices: Optional[int] = None) -> np.ndarray:
    """The ``[ensemble, points]`` rank array of make_multislice_mesh
    (tpinn's layout with contiguous blocks of ``len(ranks) / n_slices``
    standing in for slices): each ensemble row takes its chunk of every
    slice, slice-major along the points axis."""
    ranks = list(ranks)
    n_slices = 1 if n_slices is None else n_slices
    if len(ranks) % n_slices:
        raise ValueError(f"{len(ranks)} ranks not divisible by "
                         f"n_slices={n_slices}")
    per = len(ranks) // n_slices
    groups = [ranks[i * per:(i + 1) * per] for i in range(n_slices)]
    if per % ensemble:
        raise ValueError(f"per-slice rank count {per} not divisible by "
                         f"ensemble={ensemble}")
    chunk = per // ensemble
    rows = [[r for g in groups for r in g[e * chunk:(e + 1) * chunk]]
            for e in range(ensemble)]
    return np.asarray(rows, dtype=np.int64)


def make_mesh(devices: Optional[Sequence[int]] = None,
              ensemble: int = 1) -> Mesh:
    """An ``(ensemble, points)`` mesh over the default group's ranks.

    ``devices``: the global ranks in mesh order (default: every rank);
    ``ensemble`` divides their count, the rest is the points (data-
    parallel) axis.  Raises ValueError without an initialized process
    group."""
    _require_group()
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    n = len(ranks)
    if n % ensemble != 0:
        raise ValueError(f"{n} ranks not divisible by ensemble={ensemble}")
    return Mesh(np.asarray(ranks, dtype=np.int64).reshape(ensemble,
                                                          n // ensemble))


def make_multislice_mesh(devices: Optional[Sequence[int]] = None,
                         ensemble: int = 1,
                         n_slices: Optional[int] = None) -> Mesh:
    """``(ensemble, points)`` mesh whose points axis enumerates slice 0's
    ranks, then slice 1's, ... (:func:`mesh_layout`): with one host per
    slice, the points group's all-reduce keeps its in-host traffic on
    NVLink and sends one exchange across hosts."""
    _require_group()
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    return Mesh(mesh_layout(ranks, ensemble, n_slices))


def points_sharding(mesh: Mesh):
    """The placements of a point batch: Shard(0) over the points axis,
    Replicate() over the ensemble axis."""
    from torch.distributed.tensor import Replicate, Shard

    return (Replicate(), Shard(0))


def replicated(mesh: Mesh):
    """The placements of parameters and scalars: Replicate() on both
    axes."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def _local_rows(x: Tensor, mesh: Mesh) -> Tensor:
    n_pts = mesh.shape[POINTS_AXIS]
    n = x.shape[0]
    if n % n_pts:
        raise ValueError(
            f"{n} points do not divide the mesh's points axis ({n_pts}): "
            f"round the counts (round_count)")
    k = n // n_pts
    return x[mesh.points_index * k:(mesh.points_index + 1) * k]


def shard_data(data: Dict, mesh: Mesh) -> Dict:
    """This rank's shard of a GLOBAL sampler output dict: the contiguous
    ``1/P`` of ``x_col`` and of every BC group's points, P the points
    axis (:func:`points_sharding`).  Every count must divide P
    (:func:`round_count`), as tpinn's device_put requires."""
    out = dict(data)
    out["x_col"] = _local_rows(data["x_col"], mesh)
    out["x_bd"] = [_local_rows(x, mesh) for x in data["x_bd"]]
    out["u_bd"] = [_local_rows(u, mesh) for u in data["u_bd"]]
    return out


def gather_data(data: Dict, mesh: Mesh) -> Dict:
    """The GLOBAL point set of this rank's shard (:func:`shard_data`'s
    inverse): every rank's shard all-gathered over the points group, in
    points order.  A collective: every rank of the group calls it."""
    n_pts = mesh.shape[POINTS_AXIS]
    group = mesh.group(POINTS_AXIS)

    def whole(x):
        if n_pts == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(n_pts)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    out = dict(data)
    out["x_col"] = whole(data["x_col"])
    out["x_bd"] = [whole(x) for x in data["x_bd"]]
    out["u_bd"] = [whole(u) for u in data["u_bd"]]
    return out


def round_count(n: int, mesh: Mesh) -> int:
    """Round a sample count up to a multiple of the points-axis size."""
    size = mesh.shape[POINTS_AXIS]
    return int(-(-n // size) * size)


def sharded_sampler(sample_fn: Callable, mesh: Mesh) -> Callable:
    """Wrap a sampler: every rank draws the global batch (the same
    generator state on every rank gives the same points, bit for bit)
    and keeps its shard."""

    def fn(gen, F):
        return shard_data(sample_fn(gen, F), mesh)

    return fn


def make_parallel_loss(loss_fn: Callable, mesh: Mesh,
                       sum_ensemble: bool = False) -> Callable:
    """``loss_fn`` on this rank's shard, tagged for the optimizers: they
    take its value and gradient and reduce them through
    ``fn.tpinn_reduce`` (:meth:`Mesh.reduce_step`, one all-reduce);
    :func:`tpinn_torch.core.optim.evaluate_loss` gives the global value
    without a gradient."""

    def fn(params, data, lw, ref):
        return loss_fn(params, data, lw, ref)

    def reduce(loss_n, info, grads):
        return mesh.reduce_step(loss_n, info, grads,
                                sum_ensemble=sum_ensemble)

    fn.tpinn_reduce = reduce
    return fn


def counts_rounder(mesh: Optional[Mesh]) -> Callable[[int], int]:
    """``n -> n`` without a mesh; on one, a count rounded up to a multiple
    of the points axis with 0 kept (tpinn's run_system, run_inverse and
    run_patched rule; run_training rounds 0 up too)."""
    if mesh is None:
        return lambda n: n
    return lambda n: round_count(max(1, n), mesh) if n else 0


def meshed(loss_fn: Callable, sample_fn: Callable, mesh: Optional[Mesh],
           sum_ensemble: bool = False):
    """``(loss_fn, sample_fn)`` of a run on ``mesh``: the loss tagged for
    the optimizers' reduction (:func:`make_parallel_loss`), the sampler
    drawing the global batch and keeping this rank's shard
    (:func:`sharded_sampler`); both unchanged without a mesh."""
    if mesh is None:
        return loss_fn, sample_fn
    return (make_parallel_loss(loss_fn, mesh, sum_ensemble),
            sharded_sampler(sample_fn, mesh))


def is_writer(mesh: Optional[Mesh]) -> bool:
    """Whether this rank writes a run's files: every unmeshed run, and
    rank 0 of a meshed one."""
    return mesh is None or mesh.rank == 0


def check_mesh(mesh) -> None:
    """TypeError unless ``mesh`` is None or a :class:`Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a tpinn_torch.parallel.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")


# ---------------------------------------------------------------------------
# Ensemble parallelism: N independent nets, stacked, split over the
# mesh's ensemble axis
# ---------------------------------------------------------------------------


def _stack(trees):
    from tpinn_torch.core.optim import _rebuild, tree_leaves

    leaves = [torch.stack(ls) for ls in zip(*(tree_leaves(t)
                                               for t in trees))]
    return _rebuild(trees[0], iter(leaves))


def _member(stacked, i: int):
    from tpinn_torch.core.optim import _rebuild, tree_leaves

    return _rebuild(stacked, iter(x[i] for x in tree_leaves(stacked)))


def ensemble_init(generator: torch.Generator, init_fn: Callable, n: int,
                  mesh: Optional[Mesh] = None):
    """``n`` parameter trees drawn in turn from ``generator``
    (``init_fn(generator)``), stacked on a leading axis of every leaf.
    On a mesh every rank draws and keeps all of them (the same draws on
    every rank); each ensemble group evaluates its ``n / E``."""
    if mesh is not None and n % mesh.shape[ENSEMBLE_AXIS]:
        raise ValueError(f"{n} members not divisible by the mesh's "
                         f"ensemble axis ({mesh.shape[ENSEMBLE_AXIS]})")
    return _stack([init_fn(generator) for _ in range(n)])


def make_ensemble_loss(loss_fn: Callable,
                       mesh: Optional[Mesh] = None) -> Callable:
    """``loss_fn`` over stacked members (shared data): the summed loss, so
    that one backward pass trains every member, and the stacked
    per-member ``loss_info`` ``[n, k]``.

    The members run in turn, not under ``torch.func.vmap``: the kernel
    engine's launches (B1/B2 through ctypes) do not batch under vmap.  On
    a mesh this rank runs its ensemble group's ``n / E`` members, the sum
    crosses the group (:meth:`Mesh.ensemble_sum`) and the rows are
    all-gathered; the returned loss is tagged, as make_parallel_loss's,
    so that the optimizers sum the gradients over the ensemble axis and
    average them over the points axis."""

    def fn(params, data, lw, ref):
        from tpinn_torch.core.optim import tree_leaves

        n = tree_leaves(params)[0].shape[0]
        lo, hi = 0, n
        if mesh is not None:
            k = n // mesh.shape[ENSEMBLE_AXIS]
            lo, hi = mesh.ensemble_index * k, (mesh.ensemble_index + 1) * k
        outs = [loss_fn(_member(params, i), data, lw, ref)
                for i in range(lo, hi)]
        total = torch.sum(torch.stack([o[0] for o in outs]))
        info = torch.stack([o[1] for o in outs])
        if mesh is not None:
            total = mesh.ensemble_sum(total)
            info = mesh.ensemble_gather(info)
        return total, info

    if mesh is not None:
        return make_parallel_loss(fn, mesh, sum_ensemble=True)
    return fn
