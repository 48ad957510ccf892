"""One rank of the port's multi-rank tests, on the CPU with gloo.

    python tests/torch_mesh_worker.py SUITE RANK WORLD PORT OUT

joins a ``WORLD``-rank gloo group at ``tcp://127.0.0.1:PORT``, runs every
case of ``SUITE`` ("loss": sharded losses and gradients; "runs": the
meshed training entry points) with torch on one thread, saves its arrays
to ``OUT/rank<RANK>.npz`` and prints one JSON line.  It imports torch and
tpinn_torch only; the case builders below serve the tests too, which
hold the results against one process and against tpinn (passing the JAX
package's modules to the same builders).
"""

from __future__ import annotations

import hashlib
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

POISSON_2D = "u_xx + u_yy + 2*pi**2*sin(pi*x)*sin(pi*y)"
INVERSE_2D = "lam*(u_xx + u_yy) + 2*pi**2*sin(pi*x)*sin(pi*y)"
HEAT = "u_t - 0.1*u_xx"
# (equation, coords, box, BC groups (lo, hi), unknown coefficients)
LOSS_CASES = {
    "plain": (POISSON_2D, ("x", "y"), ((0.0, 0.0), (1.0, 1.0)),
              (((0.0, 0.0), (0.0, 1.0)), ((1.0, 0.0), (1.0, 1.0)),
               ((0.0, 0.0), (1.0, 0.0)), ((0.0, 1.0), (1.0, 1.0))), {}),
    "causal": (HEAT, ("x", "t"), ((0.0, 0.0), (1.0, 1.0)),
               (((0.0, 0.0), (0.0, 1.0)), ((1.0, 0.0), (1.0, 1.0)),
                ((0.0, 0.0), (1.0, 0.0))), {}),
    "inverse": (INVERSE_2D, ("x", "y"), ((0.0, 0.0), (1.0, 1.0)),
                (((0.0, 0.0), (0.0, 1.0)), ((1.0, 0.0), (1.0, 1.0))),
                {"lam": 0.7}),
    "system": (("u_x - v", "v_x + w2*u"), ("x",), ((0.0,), (1.0,)),
               (((0.0,), (0.0,)), ((1.0,), (1.0,))), {"w2": 8.0}),
}
CAUSAL = {"axis": 1, "t0": 0.0, "t1": 1.0, "bins": 8, "eps": 2.0}
N_COL, N_BD, N_OBS = 128, 16, 24
PATCH_W = 4 * math.pi
PATCH_EQ = f"u_xx + {PATCH_W * PATCH_W}*sin({PATCH_W}*x)"
N_PATCH, N_MEMBERS = 4, 4


def _mlp(rng, sizes):
    return {"layers": [
        {"w": (rng.standard_normal((a, b)) * math.sqrt(2.0 / (a + b))
               ).astype(np.float32),
         "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
        for a, b in zip(sizes[:-1], sizes[1:])]}


def loss_inputs(case: str) -> dict:
    """The numpy inputs of a loss case, from a seed: net weights (2x16),
    points (N_COL collocation, N_BD per BC group), targets, observations,
    lw and ref."""
    eq, coords, (lb, ub), groups, coef = LOSS_CASES[case]
    d = len(coords)
    m = 2 if case == "system" else 1
    rng = np.random.default_rng(7)
    data = {"x_col": rng.uniform(lb, ub, (N_COL, d)).astype(np.float32),
            "x_bd": [rng.uniform(lo, hi, (N_BD, d)).astype(np.float32)
                     for lo, hi in groups],
            "u_bd": [rng.standard_normal((N_BD, 1)).astype(np.float32)
                     for _ in groups]}
    return dict(
        params=_mlp(rng, [d, 16, 16, m]), data=data, coef=coef,
        z_obs=rng.uniform(lb, ub, (N_OBS, d)).astype(np.float32),
        u_obs=rng.standard_normal((N_OBS, m)).astype(np.float32),
        lw=np.asarray([0.7, 0.0], np.float32), ref=np.float32(2.0))


def build_loss(pkg, case: str, inp: dict, conv, causal_extra=None):
    """``(loss_fn, params_tree, data)`` of a loss case in one package:
    ``pkg`` has its ``pde``, ``net``, ``loss``, ``inverse`` and ``system``
    modules, ``conv`` makes its arrays."""
    eq, coords, (lb, ub), groups, coef = LOSS_CASES[case]
    m = 2 if case == "system" else 1
    spec = pkg.net.MLPSpec(depth=2, width=16, out_dim=m)
    fm = pkg.net.feature_map_for(("minmax",) * len(coords))
    pred = pkg.net.make_predictor(spec, fm, conv(np.float32(lb)),
                                  conv(np.float32(ub)))
    net_p = pkg.params(inp["params"])
    if case == "system":
        cs = pkg.pde.compile_system(list(eq), coords, ("u", "v"),
                                    tuple(coef))
        loss_fn = pkg.system.make_system_loss(
            pred, cs, (0, 1), observations=(conv(inp["z_obs"]),
                                            conv(inp["u_obs"])),
            obs_weight=2.5)
    elif case == "inverse":
        compiled = pkg.pde.compile_pde(eq, coords, tuple(coef))
        loss_fn = pkg.inverse.make_inverse_loss(
            pred, compiled, conv(inp["z_obs"]), conv(inp["u_obs"]))
    else:
        compiled = pkg.pde.compile_pde(eq, coords)
        causal = (dict(CAUSAL, **(causal_extra or {}))
                  if case == "causal" else None)
        loss_fn = pkg.loss.make_loss(pred, compiled, causal=causal)
    tree = ({"net": net_p, "coef": {k: conv(np.float32(v))
                                    for k, v in coef.items()}}
            if coef else net_p)
    data = {"x_col": conv(inp["data"]["x_col"]),
            "x_bd": [conv(a) for a in inp["data"]["x_bd"]],
            "u_bd": [conv(a) for a in inp["data"]["u_bd"]]}
    return loss_fn, tree, data


def patch_inputs() -> dict:
    """tpinn's patch-parallel case (tests/test_patch.py): 4 patches of 2x8
    on sin(4 pi x), 64 collocation points and 8 per BC group, numpy
    weights stacked on a leading patch axis."""
    rng = np.random.default_rng(5)
    trees = [_mlp(rng, [1, 8, 8, 1]) for _ in range(N_PATCH)]
    stacked = {"layers": [
        {k: np.stack([t["layers"][i][k] for t in trees]) for k in "wb"}
        for i in range(3)]}
    return dict(params=stacked,
                data={"x_col": rng.uniform(0, 1, (64, 1)).astype(np.float32),
                      "x_bd": [np.full((8, 1), v, np.float32)
                               for v in (0.0, 1.0)],
                      "u_bd": [np.zeros((8, 1), np.float32)] * 2},
                lw=np.asarray([1e-4, 0.0], np.float32), ref=np.float32(1.0))


def ensemble_inputs() -> dict:
    """tpinn's ensemble case (tests/test_parallel.py): 4 members of 2x16
    on poisson_1d, 64 collocation points and 8 per BC group."""
    rng = np.random.default_rng(9)
    trees = [_mlp(rng, [1, 16, 16, 1]) for _ in range(N_MEMBERS)]
    stacked = {"layers": [
        {k: np.stack([t["layers"][i][k] for t in trees]) for k in "wb"}
        for i in range(3)]}
    return dict(params=stacked,
                data={"x_col": rng.uniform(0, 1, (64, 1)).astype(np.float32),
                      "x_bd": [np.full((8, 1), v, np.float32)
                               for v in (0.0, 1.0)],
                      "u_bd": [np.zeros((8, 1), np.float32)] * 2},
                lw=np.asarray([1.0, 0.0], np.float32), ref=np.float32(1.0))


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------


def torch_pkg():
    import torch

    from tpinn_torch.core import inverse, loss, net, pde, system
    from tpinn_torch.utils.convert import params_from_numpy

    return SimpleNamespace(pde=pde, net=net, loss=loss, inverse=inverse,
                           system=system,
                           params=lambda p: params_from_numpy(p, "cpu")), (
        lambda a: torch.from_numpy(np.asarray(a, np.float32)))


def value_and_grad(loss_fn, tree, data, lw, ref):
    """``(loss_n, info, flat gradient)`` of ``loss_fn`` at ``tree``,
    reduced over the mesh when the loss is a meshed one."""
    import torch

    from tpinn_torch.core import optim

    flat, unravel = optim.ravel_tree(tree)
    x = flat.requires_grad_(True)
    loss_n, info = loss_fn(unravel(x), data, lw, ref)
    (g,) = torch.autograd.grad(loss_n, x)
    reduce = getattr(loss_fn, "tpinn_reduce", None)
    if reduce is not None:
        loss_n, info, (g,) = reduce(loss_n, info, [g])
    return (float(loss_n.detach()), info.detach().numpy(),
            g.detach().numpy())


def patch_loss(mesh=None):
    """The port's patch-parallel loss (on ``mesh``) or plain one."""
    from tpinn_torch import parallel
    from tpinn_torch.core import loss, net, pde
    from tpinn_torch.core.patch import (PatchSpec, make_patch_predictor,
                                        shard_patches)

    pred = make_patch_predictor(net.MLPSpec(depth=2, width=8),
                                PatchSpec(n=(N_PATCH,), overlap=0.5),
                                (0.0,), (1.0,))
    compiled = pde.compile_pde(PATCH_EQ, ("x",))
    if mesh is None:
        return loss.make_loss(pred, compiled)
    sharded = shard_patches(pred, N_PATCH, mesh)
    return parallel.make_parallel_loss(
        loss.make_loss(sharded, compiled, engine="fused"), mesh,
        sum_ensemble=mesh.shape["ensemble"] > 1)


def _tensors(inp):
    import torch

    from tpinn_torch.utils.convert import params_from_numpy

    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    data = {"x_col": t(inp["data"]["x_col"]),
            "x_bd": [t(a) for a in inp["data"]["x_bd"]],
            "u_bd": [t(a) for a in inp["data"]["u_bd"]]}
    return (params_from_numpy(inp["params"], "cpu"), data, t(inp["lw"]),
            t(inp["ref"]))


def suite_loss(world, rank):
    """Every loss case on a (1, world) mesh; the patch case on (1, world)
    and (2, world / 2); the ensemble case and the multislice layout on
    (2, 2) at 4 ranks."""
    from tpinn_torch import parallel
    from tpinn_torch.core import loss as loss_mod
    from tpinn_torch.core import net, pde

    pkg, conv = torch_pkg()
    mesh = parallel.make_mesh()
    arrays, summary = {}, {"shape": mesh.shape}
    for case in LOSS_CASES:
        inp = loss_inputs(case)
        loss_fn, tree, data = build_loss(pkg, case, inp, conv,
                                         causal_extra={"mesh": mesh})
        loss_fn = parallel.make_parallel_loss(loss_fn, mesh)
        loss_n, info, g = value_and_grad(
            loss_fn, tree, parallel.shard_data(data, mesh),
            conv(inp["lw"]), conv(inp["ref"]))
        arrays[f"{case}/loss"] = np.float32(loss_n)
        arrays[f"{case}/info"], arrays[f"{case}/grad"] = info, g
    meshes = {"points": mesh, "ensemble": parallel.make_mesh(ensemble=2)}
    inp = patch_inputs()
    for name, m in meshes.items():
        tree, data, lw, ref = _tensors(inp)
        loss_n, info, g = value_and_grad(
            patch_loss(m), tree, parallel.shard_data(data, m), lw, ref)
        arrays[f"patch_{name}/info"], arrays[f"patch_{name}/grad"] = info, g
    if world == 4:
        m = meshes["ensemble"]
        inp = ensemble_inputs()
        tree, data, lw, ref = _tensors(inp)
        fm = net.feature_map_for(("minmax",))
        pred = net.make_predictor(net.MLPSpec(depth=2, width=16), fm,
                                  conv((0.0,)), conv((1.0,)))
        member_loss = loss_mod.make_loss(
            pred, pde.compile_pde("u_xx + pi**2*sin(pi*x)", ("x",)))
        eloss = parallel.make_ensemble_loss(member_loss, m)
        total, infos, g = value_and_grad(
            eloss, tree, parallel.shard_data(data, m), lw, ref)
        arrays["ensemble/loss"] = np.float32(total)
        arrays["ensemble/info"], arrays["ensemble/grad"] = infos, g
        ms = parallel.make_multislice_mesh(ensemble=2, n_slices=2)
        summary["multislice"] = ms.ranks.tolist()
        summary["multislice_shape"] = ms.shape
    return arrays, summary


# ---------------------------------------------------------------------------
# the meshed entry points
# ---------------------------------------------------------------------------


def train_case():
    """tpinn's test_run_training_with_mesh (poisson_2d, 2x16) at a budget
    that is quick in torch."""
    from tpinn_torch import problems
    from tpinn_torch.core.train import StageSpec, TrainSpec

    return problems.poisson_2d(), TrainSpec(
        n_col=128, n_band=32, n_adaptive=32, n_bd=16,
        testing_size=(31, 31), grid=31, lw=(1.0, 0.0),
        stages=(StageSpec(depth=2, width=16, scl=1.0, epsil=1.0,
                          adam_epochs=40, lbfgs_epochs=15),),
        density_every=20, plateau_every=40, tail_max=10,
        checkpoint_every=20)


def system_case():
    """tpinn's test_run_system_with_mesh (the inverse oscillator), its
    budgets cut."""
    import torch

    from tpinn_torch.core import sample
    from tpinn_torch.core.inverse import InverseSpec
    from tpinn_torch.core.system import SystemSpec
    from tpinn_torch.core.train import StageSpec, TrainSpec

    prob = SystemSpec(
        name="osc_inverse_mesh", equations=("u_x - v", "v_x + w2*u"),
        fields=("u", "v"), coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0,
                                  field=0),),
        exact=lambda z: torch.cat([torch.sin(math.pi * z[:, :1]),
                                   math.pi * torch.cos(math.pi * z[:, :1])],
                                  dim=1))
    inv = InverseSpec(params=("w2",), init=(5.0,), n_obs=80)
    spec = TrainSpec(
        n_col=256, n_band=0, n_adaptive=64, n_bd=16,
        stages=(StageSpec(depth=3, width=24, adam_epochs=60,
                          lbfgs_epochs=30),),
        grid=64, lw=(1.0, 0.0), testing_size=(201,), pad_features=3,
        log_every=200)
    return prob, spec, inv


def inverse_case():
    """heat's diffusivity from observations (tpinn's heat_2d inverse),
    small."""
    import torch

    from tpinn_torch.core import sample
    from tpinn_torch.core.inverse import InverseSpec
    from tpinn_torch.core.train import ProblemSpec, StageSpec, TrainSpec

    prob = ProblemSpec(
        name="heat_inverse_mesh", equation="u_t - lam*u_xx",
        coords=("x", "t"), lb=(0.0, 0.0), ub=(1.0, 0.5),
        bc_groups=(sample.BCGroup(lo=(0.0, 0.0), hi=(0.0, 0.5), value=0.0),
                   sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 0.5), value=0.0)),
        exact=lambda z: (torch.exp(-math.pi ** 2 * z[:, 1:2])
                         * torch.sin(math.pi * z[:, 0:1])))
    inv = InverseSpec(params=("lam",), init=(0.3,), n_obs=64)
    spec = TrainSpec(
        n_col=200, n_band=0, n_adaptive=56, n_bd=16, grid=32,
        testing_size=(21, 21), lw=(1.0, 0.0), log_every=50,
        density_every=20, plateau_every=40, tail_max=5,
        stages=(StageSpec(depth=2, width=16, adam_epochs=40,
                          lbfgs_epochs=15),))
    return prob, inv, spec


def march_case():
    """Causal weighting inside a marching window: heat in two windows."""
    import torch

    from tpinn_torch.core import sample
    from tpinn_torch.core.train import ProblemSpec, StageSpec, TrainSpec

    prob = ProblemSpec(
        name="heat_march_mesh", equation=HEAT, coords=("x", "t"),
        lb=(0.0, 0.0), ub=(1.0, 0.5),
        bc_groups=(sample.BCGroup(lo=(0.0, 0.0), hi=(0.0, 0.5), value=0.0),
                   sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 0.5), value=0.0),
                   sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0), value=0.0,
                                  value_fn=lambda z: torch.sin(
                                      math.pi * z[:, 0:1]))),
        exact=lambda z: (torch.exp(-0.1 * math.pi ** 2 * z[:, 1:2])
                         * torch.sin(math.pi * z[:, 0:1])))
    spec = TrainSpec(
        n_col=128, n_band=32, n_adaptive=32, n_bd=16, grid=31,
        testing_size=(21, 21), lw=(1.0, 0.0), density_every=20,
        plateau_every=40, tail_max=5, causal_eps=1.0, causal_bins=8,
        stages=(StageSpec(depth=2, width=16, scl=1.0, epsil=1.0,
                          adam_epochs=30, lbfgs_epochs=9),))
    return prob, spec


def ensemble_case():
    from tpinn_torch import problems
    from tpinn_torch.core.train import StageSpec, TrainSpec

    return problems.poisson_1d(), TrainSpec(
        n_col=128, n_band=32, n_adaptive=32, n_bd=8, grid=33,
        testing_size=(64,), lw=(1.0, 0.0), density_every=20,
        plateau_every=40, tail_max=5,
        stages=(StageSpec(depth=2, width=16, scl=1.0, epsil=1.0,
                          adam_epochs=30, lbfgs_epochs=9),))


def patch_case(ensemble_mesh=False):
    """tpinn's two patch mesh cases (tests/test_patch.py): sin(4 pi x) on
    4 patches, points mesh at 200 / 60 and 2x8 nets; ensemble mesh at
    100 / 30."""
    import torch

    from tpinn_torch.core import sample
    from tpinn_torch.core.patch import PatchSpec
    from tpinn_torch.core.train import ProblemSpec, StageSpec, TrainSpec

    w = PATCH_W
    prob = ProblemSpec(
        name="hf_poisson", equation=PATCH_EQ, coords=("x",), lb=(0.0,),
        ub=(1.0,), bc_groups=(sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0),
                              sample.BCGroup(lo=(1.0,), hi=(1.0,),
                                             value=0.0)),
        exact=lambda z: torch.sin(w * z))
    if ensemble_mesh:
        spec = TrainSpec(
            n_col=64, n_band=0, n_adaptive=0, n_bd=8, testing_size=(64,),
            lw=(1e-4, 0.0), grid=17,
            stages=(StageSpec(depth=2, width=8, scl=1.0, epsil=1.0,
                              adam_epochs=100, lbfgs_epochs=30),),
            log_every=100, density_every=10 ** 9, plateau_every=10 ** 9)
    else:
        spec = TrainSpec(
            n_col=256, n_band=0, n_adaptive=0, n_bd=16, testing_size=(128,),
            lw=(1e-4, 0.0), grid=64, pad_features=3,
            stages=(StageSpec(depth=2, width=8, scl=1.0, epsil=1.0,
                              adam_epochs=200, lbfgs_epochs=60),),
            log_every=200, density_every=10 ** 9, plateau_every=10 ** 9)
    return prob, spec, PatchSpec(n=(N_PATCH,), overlap=0.5)


def digest(tree) -> str:
    from tpinn_torch.core.optim import tree_leaves

    h = hashlib.sha256()
    for x in tree_leaves(tree):
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_entry(name, mesh=None, out=None):
    """One meshed (or, with ``mesh=None``, one-process) run of an entry
    point: ``(history, params, rel_l2, log lines)``."""
    from tpinn_torch.core.ensemble import run_ensemble_training
    from tpinn_torch.core.inverse import run_inverse
    from tpinn_torch.core.march import run_time_marching
    from tpinn_torch.core.patch import run_patched
    from tpinn_torch.core.system import run_system
    from tpinn_torch.core.train import run_training

    lines = []
    kw = dict(mesh=mesh, log_fn=lines.append, device="cpu")
    out = None if out is None else str(out)
    if name == "train":
        prob, spec = train_case()
        r = run_training(prob, spec, output_dir=out, **kw)
        return r.history, r.stages[-1].params, r.rel_l2, lines
    if name == "system":
        prob, spec, inv = system_case()
        r = run_system(prob, spec, inverse=inv, output_dir=out, **kw)
        return r.history, r.params, r.rel_l2, lines
    if name == "inverse":
        prob, inv, spec = inverse_case()
        r = run_inverse(prob, inv, spec, output_dir=out, **kw)
        return r.history, r.params, r.rel_l2, lines
    if name == "march":
        prob, spec = march_case()
        r = run_time_marching(prob, spec, 2, axis="t", output_dir=out, **kw)
        return (r.windows[0].history,
                [w.stages[-1].params for w in r.windows], r.rel_l2, lines)
    if name == "ensemble":
        prob, spec = ensemble_case()
        r = run_ensemble_training(prob, spec, n_members=2, output_dir=out,
                                  **kw)
        return (r.members[0].history,
                [m.stages[-1].params for m in r.members], r.rel_l2, lines)
    prob, spec, pspec = patch_case(ensemble_mesh=name == "patch_ensemble")
    r = run_patched(prob, spec, pspec, output_dir=out, **kw)
    return r.history, r.params, r.rel_l2, lines


RUNS = ("train", "system", "inverse", "march", "ensemble", "patch_points",
        "patch_ensemble")


def suite_runs(world, rank, out):
    """Every entry point on a (1, world) mesh (the ensemble patch case on
    (2, world / 2)), each into OUT/<name>/ with its file writes counted;
    then the multislice gradient of tests/test_distributed.py."""
    import torch

    from tpinn_torch import parallel
    from tpinn_torch.core import optim
    from tpinn_torch.utils import artifacts, checkpoint

    writes = {"n": 0}
    inner = checkpoint.atomic_savez

    def counted(*a, **k):
        writes["n"] += 1
        return inner(*a, **k)

    checkpoint.atomic_savez = artifacts.atomic_savez = counted
    arrays, summary = {}, {}
    for name in RUNS:
        mesh = parallel.make_mesh(ensemble=2 if name == "patch_ensemble"
                                  else 1)
        writes["n"] = 0
        hist, params, rel, lines = run_entry(name, mesh, Path(out) / name)
        arrays[f"{name}/history"] = np.asarray(hist)
        summary[name] = {"digest": digest(params), "writes": writes["n"],
                         "rel_l2": rel,
                         "sharded": any("ensemble-axis groups" in ln
                                        for ln in lines)}

    # the train case resumed from its end-of-loop phase file (saved with
    # the global point set) on the same mesh: the same parameters
    import shutil

    import torch.distributed as dist

    again = Path(out) / "train_resumed"
    if rank == 0:
        again.mkdir(parents=True, exist_ok=True)
        shutil.copy(Path(out) / "train" / "adam_state_stage_1.npz", again)
    dist.barrier()
    from tpinn_torch.core.train import run_training

    prob, spec = train_case()
    lines = []
    r = run_training(prob, spec, output_dir=str(again), resume=True,
                     mesh=parallel.make_mesh(), log_fn=lines.append,
                     device="cpu")
    summary["train_resumed"] = {
        "digest": digest(r.stages[-1].params),
        "resumed": any("resuming Adam mid-stage at step 40/40" in ln
                       for ln in lines)}

    # tests/test_distributed.py's multislice gradient: each process one
    # slice, the points axis over both
    ms = parallel.make_multislice_mesh(n_slices=world)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 3)).astype(np.float32))
    params = {"W1": torch.from_numpy(
        (rng.standard_normal((3, 16)) / 4).astype(np.float32)),
        "W2": torch.from_numpy(
            (rng.standard_normal((16, 1)) / 4).astype(np.float32))}

    def loss(p, data, lw, ref):
        h = torch.tanh(data["x_col"] @ p["W1"])
        val = torch.mean((h @ p["W2"]) ** 2)
        return val, val.reshape(1)

    ploss = parallel.make_parallel_loss(loss, ms)
    data = parallel.shard_data({"x_col": x, "x_bd": [], "u_bd": []}, ms)
    flat, unravel = optim.ravel_tree(params)
    xg = flat.requires_grad_(True)
    val, info = ploss(unravel(xg), data, None, None)
    (g,) = torch.autograd.grad(val, xg)
    _, _, (g,) = ploss.tpinn_reduce(val, info, [g])
    arrays["multislice/grad"] = g.numpy()
    summary["multislice"] = {"shape": ms.shape, "ranks": ms.ranks.tolist(),
                             "checksum": float(g.sum())}
    return arrays, summary


def launch(suite: str, world: int, out, timeout: float = 240.0):
    """Run ``world`` ranks of ``suite`` into ``out``: a list of
    ``(summary, arrays)`` per rank.  Fails with every rank's stderr if a
    rank fails or the launch outlasts ``timeout`` seconds."""
    import os
    import socket
    import subprocess

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__)), suite, str(r), str(world),
         str(port), str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=str(ROOT)) for r in range(world)]
    results = []
    try:
        for r, p in enumerate(procs):
            o, e = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"rank {r} of {suite}@{world}: rc "
                                     f"{p.returncode}\n{e[-4000:]}")
            with np.load(out / f"rank{r}.npz") as z:
                arrays = {k: z[k] for k in z.files}
            results.append((json.loads(o.strip().splitlines()[-1]), arrays))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results



def main(argv):
    import torch
    import torch.distributed as dist

    suite, rank, world, port, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        fn = {"loss": lambda: suite_loss(world, rank),
              "runs": lambda: suite_runs(world, rank, out)}[suite]
        arrays, summary = fn()
        np.savez(Path(out) / f"rank{rank}.npz", **arrays)
        print(json.dumps({"rank": rank, "world": world, **summary}))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
