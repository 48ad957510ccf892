"""tpinn_torch.parallel against tpinn.parallel, on the CPU with gloo.

The port's mesh is multi-controller: every rank runs the same code on its
shard and the optimizers reduce the gradient and loss_info in one
all-reduce.  The multi-rank cases run in subprocess workers
(tests/torch_mesh_worker.py: one launch per world size, every case in
it, a timeout per launch, torch on one thread); this process holds their
results against one process of the port and against tpinn's single-
device ``jax.grad`` on the same numpy-seeded weights and points.

Tolerances: the sharded loss, loss_info and gradient against the port's
one process rtol 1e-5 (atol 1e-7; the points' partial sums change order
with the shard size); against tpinn rtol 1e-5 / atol 1e-6 for loss_info
and rtol 1e-4 / atol 1e-6 for the gradient (the port's parity bars);
patch-parallel gradients 1e-5 in relative norm (tests/test_patch.py's
bar).  Every rank's reduced numbers are bitwise equal.
"""

import functools
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_mesh_worker as W  # noqa: E402

from tpinn import parallel as jparallel  # noqa: E402
from tpinn.core import inverse as jinverse  # noqa: E402
from tpinn.core import loss as jloss  # noqa: E402
from tpinn.core import net as jnet  # noqa: E402
from tpinn.core import pde as jpde  # noqa: E402
from tpinn.core import system as jsystem  # noqa: E402
from tpinn_torch import parallel  # noqa: E402

RTOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The loss suite at 2 and 4 ranks: {world: [(summary, arrays)]}."""
    root = tmp_path_factory.mktemp("mesh_loss")
    return {w: W.launch("loss", w, root / f"w{w}") for w in (2, 4)}


def _one_process(case):
    pkg, conv = W.torch_pkg()
    inp = W.loss_inputs(case)
    loss_fn, tree, data = W.build_loss(pkg, case, inp, conv)
    return W.value_and_grad(loss_fn, tree, data, conv(inp["lw"]),
                            conv(inp["ref"]))


def _tpinn(case):
    inp = W.loss_inputs(case)
    pkg = SimpleNamespace(pde=jpde, net=jnet, loss=jloss, inverse=jinverse,
                          system=jsystem,
                          params=lambda p: jax.tree_util.tree_map(
                              jnp.asarray, p))
    loss_fn, tree, data = W.build_loss(pkg, case, inp, jnp.asarray)
    (loss_n, info), g = jax.value_and_grad(loss_fn, has_aux=True)(
        tree, data, jnp.asarray(inp["lw"]), jnp.asarray(inp["ref"]))
    flat = np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree_util.tree_leaves(g)])
    return float(loss_n), np.asarray(info), flat


def _same_on_every_rank(results, key):
    first = results[0][1][key]
    for _, arrays in results[1:]:
        np.testing.assert_array_equal(arrays[key], first)
    return first


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(W.LOSS_CASES))
def test_sharded_loss_and_grad_match_one_process(ranks, case, world):
    """The plain, causal, inverse and system losses on a (1, world) mesh:
    the reduced loss, loss_info and gradient equal one process's."""
    res = ranks[world]
    loss_n = _same_on_every_rank(res, f"{case}/loss")
    info = _same_on_every_rank(res, f"{case}/info")
    grad = _same_on_every_rank(res, f"{case}/grad")
    l1, i1, g1 = _one_process(case)
    np.testing.assert_allclose(loss_n, l1, rtol=RTOL)
    np.testing.assert_allclose(info, i1, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(grad, g1, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("case", list(W.LOSS_CASES))
def test_sharded_loss_and_grad_match_tpinn(ranks, case):
    """The 4-rank reduction against tpinn's single-device value_and_grad on
    the carried weights."""
    arrays = ranks[4][0][1]
    lj, ij, gj = _tpinn(case)
    np.testing.assert_allclose(arrays[f"{case}/loss"], lj, rtol=1e-5)
    np.testing.assert_allclose(arrays[f"{case}/info"], ij, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(arrays[f"{case}/grad"], gj, rtol=1e-4,
                               atol=1e-6)


def test_causal_slab_weights_cross_the_mesh(ranks):
    """Without the slab statistics' all-reduce a shard weighs its points by
    its own slabs: the one-process loss differs from the average of the
    shards' unreduced causal losses, and the meshed one does not."""
    pkg, conv = W.torch_pkg()
    inp = W.loss_inputs("causal")
    loss_fn, tree, data = W.build_loss(pkg, "causal", inp, conv)
    lw, ref = conv(inp["lw"]), conv(inp["ref"])
    whole = float(loss_fn(tree, data, lw, ref)[0])
    n = data["x_col"].shape[0] // 4
    shards = []
    for r in range(4):
        part = dict(data, x_col=data["x_col"][r * n:(r + 1) * n],
                    x_bd=[x[r * 4:(r + 1) * 4] for x in data["x_bd"]],
                    u_bd=[u[r * 4:(r + 1) * 4] for u in data["u_bd"]])
        shards.append(float(loss_fn(tree, part, lw, ref)[0]))
    assert abs(np.mean(shards) - whole) > 1e-4 * abs(whole)
    np.testing.assert_allclose(ranks[4][0][1]["causal/loss"], whole,
                               rtol=RTOL)


@functools.lru_cache(maxsize=None)
def _patch_grads():
    """(the port's one-process gradient, tpinn's) of the patch case."""
    from tpinn.core.patch import PatchSpec, make_patch_predictor

    inp = W.patch_inputs()
    tree, data, lw, ref = W._tensors(inp)
    _, _, g1 = W.value_and_grad(W.patch_loss(), tree, data, lw, ref)
    pred = make_patch_predictor(jnet.MLPSpec(depth=2, width=8),
                                PatchSpec(n=(W.N_PATCH,), overlap=0.5),
                                (0.0,), (1.0,))
    loss_fn = jloss.make_loss(pred, jpde.compile_pde(W.PATCH_EQ, ("x",)))
    djax = jax.tree_util.tree_map(jnp.asarray, inp["data"])
    gj = jax.grad(lambda p: loss_fn(p, djax, jnp.asarray(inp["lw"]),
                                    jnp.asarray(inp["ref"]))[0])(
        jax.tree_util.tree_map(jnp.asarray, inp["params"]))
    return g1, np.concatenate([np.asarray(x).ravel()
                               for x in jax.tree_util.tree_leaves(gj)])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mesh", ["points", "ensemble"])
def test_patch_gradient_over_the_mesh(ranks, mesh, world):
    """tpinn's patch-parallel case: the stacked 4-patch tree on a points
    mesh (1, world) and split over the ensemble axis (2, world / 2): the
    gradient within 1e-5 in relative norm of one process's and of
    tpinn's jax.grad, and the same on every rank."""
    grad = _same_on_every_rank(ranks[world], f"patch_{mesh}/grad")
    g1, gj = _patch_grads()
    for ref in (g1, gj):
        dev = np.linalg.norm(grad - ref) / np.linalg.norm(ref)
        assert dev < 1e-5, dev


def test_make_ensemble_loss_matches_tpinn(ranks):
    """make_ensemble_loss on a (2, 2) mesh against tpinn's on the carried
    members: the summed loss, the stacked per-member loss_info and the
    gradient of every member."""
    arrays = ranks[4][0][1]
    for key in ("ensemble/loss", "ensemble/info", "ensemble/grad"):
        _same_on_every_rank(ranks[4], key)
    inp = W.ensemble_inputs()
    fm = jnet.feature_map_for(("minmax",))
    pred = jnet.make_predictor(jnet.MLPSpec(depth=2, width=16), fm,
                               jnp.asarray([0.0]), jnp.asarray([1.0]))
    member = jloss.make_loss(pred, jpde.compile_pde("u_xx + pi**2*sin(pi*x)",
                                                    ("x",)))
    eloss = jparallel.make_ensemble_loss(member)
    djax = jax.tree_util.tree_map(jnp.asarray, inp["data"])
    args = (djax, jnp.asarray(inp["lw"]), jnp.asarray(inp["ref"]))
    params = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    (total, infos), g = jax.value_and_grad(eloss, has_aux=True)(params,
                                                                *args)
    assert arrays["ensemble/info"].shape == (W.N_MEMBERS, 6)
    np.testing.assert_allclose(arrays["ensemble/loss"], float(total),
                               rtol=1e-5)
    np.testing.assert_allclose(arrays["ensemble/info"], np.asarray(infos),
                               rtol=1e-5, atol=1e-6)
    gj = np.concatenate([np.asarray(x).ravel()
                         for x in jax.tree_util.tree_leaves(g)])
    np.testing.assert_allclose(arrays["ensemble/grad"], gj, rtol=1e-4,
                               atol=1e-6)


def test_mesh_layouts_match_tpinn(ranks):
    """make_mesh's and make_multislice_mesh's rank layouts index for index
    against tpinn's on its 8 virtual devices, and the 4-rank multislice
    mesh the workers built."""
    devices = jax.devices()
    assert len(devices) == 8
    ids = lambda m: [[d.id for d in row] for row in m.devices]
    for ens, n_slices in ((1, None), (2, 2), (2, 1), (1, 4), (4, 2)):
        jm = jparallel.make_multislice_mesh(devices, ensemble=ens,
                                            n_slices=n_slices)
        assert parallel.mesh.mesh_layout(range(8), ens,
                                          n_slices).tolist() == ids(jm)
        assert dict(jm.shape) == {"ensemble": ens, "points": 8 // ens}
    for ens in (1, 2, 4):
        jm = jparallel.make_mesh(devices, ensemble=ens)
        assert np.arange(8).reshape(ens, -1).tolist() == ids(jm)
    summary = ranks[4][0][0]
    jm = jparallel.make_multislice_mesh(devices[:4], ensemble=2, n_slices=2)
    assert summary["multislice"] == [[d.id for d in row]
                                     for row in jm.devices]
    assert summary["multislice_shape"] == dict(jm.shape)
    with pytest.raises(ValueError, match="n_slices"):
        parallel.mesh.mesh_layout(range(8), 1, 3)
    with pytest.raises(ValueError, match="ensemble"):
        parallel.mesh.mesh_layout(range(8), 3, 2)


@pytest.mark.parametrize("n", [1, 100, 104, 105])
def test_round_count_matches_tpinn(n):
    jm = jparallel.make_mesh()
    tm = SimpleNamespace(shape={"ensemble": 1, "points": 8})
    assert parallel.round_count(n, tm) == jparallel.round_count(n, jm)


def test_shard_data_and_gather_roundtrip():
    """shard_data's contiguous shards put back in points order are the
    global set; a count that does not divide the axis is refused."""
    x = torch.arange(24.0).reshape(12, 2)
    data = {"x_col": x, "x_bd": [x[:8]], "u_bd": [x[:8, :1]]}
    parts = [parallel.shard_data(data, SimpleNamespace(
        shape={"ensemble": 1, "points": 4}, points_index=r))
        for r in range(4)]
    assert torch.equal(torch.cat([p["x_col"] for p in parts]), x)
    assert [tuple(p["x_bd"][0].shape) for p in parts] == [(2, 2)] * 4
    with pytest.raises(ValueError, match="round_count"):
        parallel.shard_data(data, SimpleNamespace(
            shape={"ensemble": 1, "points": 5}, points_index=0))


def test_make_mesh_needs_a_process_group():
    """No quiet world of one: make_mesh without init_process_group raises
    ValueError."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from tpinn_torch import parallel\n"
            "try:\n    parallel.make_mesh()\n"
            "except ValueError as e:\n    print('refused', e)\n"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "refused" in out.stdout, out.stderr


def test_parallel_imports_no_jax():
    """tpinn_torch.parallel imports neither jax nor the JAX package."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import tpinn_torch.parallel\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'tpinn' or "
            "m.startswith('tpinn.'))\n"
            "assert not bad, bad\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
