"""Overlapping patches: tpinn_torch.core.patch against tpinn.core.patch,
on the CPU.

Stacked weights are drawn by the JAX package (init_patch_params) and
carried (utils/convert, which keeps the leading patch axis); points are
made with numpy from a seed.  Tolerances (float32 unless stated): the
predictor rtol 1e-5, atol 1e-6; the generic-engine residual (float64)
rtol 1e-4, atol 1e-6; the
loss (normalized by its value at these weights) and its gradient per
stacked leaf rtol 1e-4, atol 1e-6; served /predict rtol 1e-5, atol 1e-6;
the flat and tree Adam layouts rtol 1e-6, atol 1e-7.  Training runs
use tpinn's own test sizes (tests/test_patch.py); the two packages'
random streams differ, so runs are not compared across packages.  The
mesh cases of tpinn's file run in tests/test_torch_parallel.py (gloo
ranks in subprocesses).
"""

import contextlib
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.app.serve import PINNServer as JaxServer
from tpinn.core import loss as jloss
from tpinn.core import net as jnet
from tpinn.core import patch as jpatch
from tpinn.core import pde as jpde
from tpinn.utils import checkpoint as jckpt
from tpinn.utils.x64 import force_x64
from tpinn_torch.app.serve import PINNServer
from tpinn_torch.core import loss as loss_mod
from tpinn_torch.core import net, pde, sample
from tpinn_torch.core.optim import tree_leaves
from tpinn_torch.core.patch import (PatchSpec, init_patch_params,
                                    make_patch_predictor, patch_geometry,
                                    run_patched)
from tpinn_torch.core.train import ProblemSpec, StageSpec, TrainSpec
from tpinn_torch.utils.convert import params_from_numpy

PI = np.pi
HELMHOLTZ = "u_xx + u_yy + 400.0*u + 400.0*sin(20.0*x)*sin(20.0*y)"
# (name, patches per axis, lb, ub, equation, pad_features)
CASES = {
    "1d-8-pad0": ((8,), (0.0,), (1.0,), "u_xx + u", 0),
    "1d-8-pad3": ((8,), (0.0,), (1.0,), "u_xx + u", 3),
    "2d-2x3-pad0": ((2, 3), (0.0, 0.0), (1.0, 1.0), HELMHOLTZ, 0),
    "2d-2x3-pad3": ((2, 3), (0.0, 0.0), (1.0, 1.0), HELMHOLTZ, 3),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _hf_poisson(w):
    return ProblemSpec(
        name="hf_poisson", equation=f"u_xx + {w * w}*sin({w}*x)",
        coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0),
                   sample.BCGroup(lo=(1.0,), hi=(1.0,), value=0.0)),
        exact=lambda z: torch.sin(w * z),
    )


def _both(name, depth=2, width=8, seed=0, f64=False, **family):
    """The case's patched predictor in both packages on the same stacked
    weights: (jax predictor, jax params, torch predictor, torch params,
    points [n, d] in numpy), in float32 or (``f64``) float64; call the
    JAX side of a float64 case under force_x64.  ``family``: the
    MLPSpec fields of another net family (Fourier features, modified)."""
    n, lb, ub, _, pad = CASES[name]
    jdt, tdt, ndt = ((jnp.float64, torch.float64, np.float64) if f64 else
                     (jnp.float32, torch.float32, np.float32))
    pspec_j = jpatch.PatchSpec(n=n)
    mspec_j = jnet.MLPSpec(depth=depth, width=width, scl=1.3, epsil=0.7,
                           **family)
    with force_x64() if f64 else contextlib.nullcontext():
        pred_j = jpatch.make_patch_predictor(mspec_j, pspec_j, lb, ub, jdt,
                                             pad_features=pad)
        p_j = jax.jit(lambda k: jpatch.init_patch_params(
            k, mspec_j, pspec_j, jdt, pad_features=pad))(
                jax.random.PRNGKey(seed))
        c, h = (np.asarray(a) for a in pred_j.tpinn_patch)
    pred_t = make_patch_predictor(
        net.MLPSpec(depth=depth, width=width, scl=1.3, epsil=0.7, **family),
        PatchSpec(n=n), lb, ub, tdt, pad_features=pad)
    p_t = params_from_numpy(jax.tree.map(np.asarray, p_j), "cpu", tdt)
    rng = np.random.default_rng(seed)
    z = rng.uniform(lb, ub, (40, len(n)))
    # the patch centres and the window edges c ± h
    z = np.concatenate([z, c, np.clip(c - h, lb, ub), np.clip(c + h, lb, ub)])
    return pred_j, p_j, pred_t, p_t, z.astype(ndt)


def test_patch_geometry_matches_tpinn():
    for n, lb, ub in (((4,), (0.0,), (1.0,)),
                      ((2, 3), (0.0, -1.0), (1.0, 2.0))):
        c_j, h_j = jpatch.patch_geometry(jpatch.PatchSpec(n=n), lb, ub)
        c_t, h_t = patch_geometry(PatchSpec(n=n), lb, ub)
        assert c_t.dtype == h_t.dtype == torch.float32
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
        np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    c, h = patch_geometry(PatchSpec(n=(4,), overlap=0.5), (0.0,), (1.0,),
                          torch.float64)
    np.testing.assert_allclose(c[:, 0].numpy(), [0.125, 0.375, 0.625, 0.875])
    assert float(h[0]) == pytest.approx(0.1875)  # 1.5 cells / 2
    with pytest.raises(ValueError, match="axes"):
        patch_geometry(PatchSpec(n=(2,)), (0.0, 0.0), (1.0, 1.0))


@pytest.mark.parametrize("kw", [dict(n=()), dict(n=(2, 0)),
                                dict(n=(2,), overlap=0.0),
                                dict(n=(2,), overlap=2.5)])
def test_patch_spec_checks(kw):
    with pytest.raises(ValueError, match="PatchSpec"):
        PatchSpec(**kw)
    with pytest.raises(ValueError, match="PatchSpec"):
        jpatch.PatchSpec(**kw)


@pytest.mark.parametrize("name", list(CASES))
def test_predictor_matches_tpinn(name):
    pred_j, p_j, pred_t, p_t, z = _both(name)
    u_j = np.asarray(jax.jit(pred_j)(p_j, jnp.asarray(z)))
    u_t = pred_t(p_t, torch.from_numpy(z))
    assert u_t.shape == (z.shape[0], 1) and u_t.dtype == torch.float32
    np.testing.assert_allclose(u_t.detach().numpy(), u_j, rtol=1e-5,
                               atol=1e-6)
    assert len(tree_leaves(p_t)) == 2 * 3
    assert all(x.shape[0] == PatchSpec(n=CASES[name][0]).count
               for x in tree_leaves(p_t))


@pytest.mark.parametrize("family", [
    dict(fourier_features=6, fourier_scale=2.0), dict(modified=True)],
    ids=["fourier", "modified"])
@pytest.mark.parametrize("name", ["1d-8-pad3", "2d-2x3-pad0"])
def test_predictor_of_other_families_matches_tpinn(name, family):
    """Fourier-feature and modified patch nets (tpinn's jax.vmap over
    net.mlp_apply takes every family) on carried stacked weights."""
    pred_j, p_j, pred_t, p_t, z = _both(name, **family)
    u_j = np.asarray(jax.jit(pred_j)(p_j, jnp.asarray(z)))
    u_t = pred_t(p_t, torch.from_numpy(z))
    assert u_t.shape == (z.shape[0], 1)
    np.testing.assert_allclose(u_t.detach().numpy(), u_j, rtol=1e-5,
                               atol=1e-6)
    assert set(p_t) == ({"layers", "fourier_b"} if "fourier_features" in
                        family else {"layers", "gate_u", "gate_v"})


def test_partition_of_unity_positive_and_local():
    """tpinn's case: the predictor is finite everywhere, and at a patch
    centre it equals that patch's own net."""
    spec = PatchSpec(n=(8,), overlap=0.5)
    mspec = net.MLPSpec(depth=2, width=8)
    pred = make_patch_predictor(mspec, spec, (0.0,), (1.0,))
    params = init_patch_params(torch.Generator().manual_seed(0), mspec, spec)
    z = torch.linspace(0.0, 1.0, 257)[:, None]
    assert bool(torch.isfinite(pred(params, z)).all())
    centers, half = pred.tpinn_patch
    fm = net.feature_map_for((net.MINMAX,))
    for p in (0, 3, 7):
        zc = centers[p][None, :]
        own = mspec.epsil * net.mlp_apply(
            {"layers": [{k: v[p] for k, v in layer.items()}
                        for layer in params["layers"]]},
            fm(zc, centers[p] - half, centers[p] + half), mspec)
        np.testing.assert_allclose(pred(params, zc).detach().numpy(),
                                   own.detach().numpy(), rtol=1e-6)


@pytest.mark.parametrize("name", ["1d-8-pad0", "2d-2x3-pad3"])
def test_generic_residual_matches_tpinn(name):
    """The composite advertises no structured partials: the residual takes
    the generic nested-jvp engine, finite at the centres and at the
    window edges, and equal to tpinn's residual_fast.  In float64: the
    windows' 1/h² makes u_xx hundreds of times u, and float32 residuals
    that cancel to O(0.1) carry absolute rounding of ~1e-5."""
    pred_j, p_j, pred_t, p_t, z = _both(name, f64=True)
    _, _, _, eq, _ = CASES[name]
    coords = ("x",) if z.shape[1] == 1 else ("x", "y")
    with force_x64():
        compiled = jpde.compile_pde(eq, coords)
        f_j = np.asarray(jax.jit(lambda p, zz: compiled.residual_fast(
            pred_j, p, zz))(p_j, jnp.asarray(z)))
    assert not hasattr(pred_t, "tpinn_partials")
    with torch.no_grad():
        f_t = pde.compile_pde(eq, coords).residual_fast(
            pred_t, p_t, torch.from_numpy(z))
    assert bool(torch.isfinite(f_t).all())
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["1d-8-pad3", "2d-2x3-pad0"])
def test_loss_gradient_matches_jax_grad(name):
    pred_j, p_j, pred_t, p_t, z = _both(name, seed=7)
    n, lb, ub, eq, _ = CASES[name]
    coords = ("x",) if len(n) == 1 else ("x", "y")
    rng = np.random.default_rng(8)
    x_bd = rng.uniform(lb, ub, (12, len(n))).astype(np.float32)
    x_bd[:, 0] = lb[0]
    u_bd = np.sin(x_bd[:, :1]).astype(np.float32)
    data = {"x_col": z, "x_bd": [x_bd], "u_bd": [u_bd]}
    lw = np.array([1e-2, 0.0], np.float32)
    loss_j = jloss.make_loss(pred_j, jpde.compile_pde(eq, coords))
    d_j = jax.tree.map(jnp.asarray, data)
    vg = jax.jit(jax.value_and_grad(loss_j, has_aux=True))
    ref = float(vg(p_j, d_j, jnp.asarray(lw), jnp.float32(1.0))[0][1][0])
    (l_j, info_j), g_j = vg(p_j, d_j, jnp.asarray(lw), jnp.float32(ref))
    loss_t = loss_mod.make_loss(pred_t, pde.compile_pde(eq, coords))
    leaves = [x.requires_grad_(True) for x in tree_leaves(p_t)]
    l_t, info_t = loss_t(p_t, params_from_numpy(data, "cpu"),
                         torch.tensor(lw), torch.tensor(ref))
    g_t = torch.autograd.grad(l_t, leaves)
    np.testing.assert_allclose(info_t.detach().numpy(), np.asarray(info_j),
                               rtol=1e-4, atol=1e-6)
    for a, b in zip(g_t, jax.tree.leaves(g_j)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def _serve_spec(**kw):
    return TrainSpec(
        n_col=256, n_band=0, n_adaptive=0, n_bd=16, testing_size=(128,),
        lw=(1e-3, 0.0), grid=64,
        stages=(StageSpec(depth=2, width=12, scl=1.0, epsil=1.0,
                          adam_epochs=400, lbfgs_epochs=150),),
        log_every=400, density_every=10**9, plateau_every=10**9, **kw)


@pytest.fixture(scope="module")
def served_run(tmp_path_factory):
    """tpinn's serve case (4 patches of 2x12, 400 / 150) trained by the
    port, its checkpoint written."""
    out = tmp_path_factory.mktemp("patched")
    r = run_patched(_hf_poisson(2 * PI), _serve_spec(),
                    PatchSpec(n=(4,), overlap=0.5), output_dir=str(out),
                    device="cpu")
    return out, r


def test_patched_checkpoint(tmp_path):
    """tpinn's case: params_stage_1.npz and patched.json written, with
    tpinn's meta keys."""
    spec = dataclasses.replace(_serve_spec(), n_col=128, n_bd=8, grid=32,
                               testing_size=(64,), stages=(StageSpec(
                                   depth=2, width=8, scl=1.0, epsil=1.0,
                                   adam_epochs=50, lbfgs_epochs=0),))
    r = run_patched(_hf_poisson(2 * PI), spec, PatchSpec(n=(2,), overlap=0.5),
                    output_dir=str(tmp_path), device="cpu")
    assert r.n_patches == 2 and r.history.shape[0] >= 50
    rec = json.loads((tmp_path / "patched.json").read_text())
    assert rec == {"problem": "hf_poisson", "n_patches": 2, "n": [2],
                   "overlap": 0.5, "rel_l2": r.rel_l2}
    with np.load(tmp_path / "params_stage_1.npz") as raw:
        meta = json.loads(bytes(raw["__meta__"]).decode())
        assert raw["leaf:layers/0/w"].shape == (2, 1, 8)
    assert meta["patch"] == {"n": [2], "overlap": 0.5}
    assert meta["hard_bc"] is None and meta["equation"].startswith("u_xx")
    assert set(meta) == {"stage", "scl", "epsil", "problem", "chain",
                         "feature_kinds", "lb", "ub", "hard_bc", "coords",
                         "pad_features", "equation", "patch"}


def test_patched_rejects_hard_bc():
    prob = dataclasses.replace(_hf_poisson(2 * PI), hard_bc=("0", "x*(1-x)"))
    spec = TrainSpec(n_col=64, n_band=0, n_adaptive=0, n_bd=8,
                     stages=(StageSpec(depth=2, width=8, adam_epochs=10,
                                       lbfgs_epochs=0),))
    with pytest.raises(ValueError, match="hard_bc"):
        run_patched(prob, spec, PatchSpec(n=(2,)), device="cpu")


def test_patched_checkpoint_serves_both_ways(served_run):
    """The port's checkpoint served by both servers equals the trainer's
    predictor."""
    out, r = served_run
    z = np.linspace(0.1, 0.9, 9)[:, None]
    want = r.predict(torch.tensor(z, dtype=torch.float32))[:, 0]
    want = want.detach().numpy()
    for srv in (PINNServer(str(out / "params_stage_1.npz"), "poisson_1d",
                           device="cpu"),
                JaxServer(str(out / "params_stage_1.npz"), "poisson_1d")):
        np.testing.assert_allclose(np.asarray(srv.predict(z.tolist())), want,
                                   rtol=1e-5, atol=1e-6)


def test_tpinn_patch_checkpoint_served_by_port(tmp_path):
    """A checkpoint in the layout tpinn's run_patched writes (2-D, 2x3
    patches on 3 padded features), served by the port and by tpinn's
    server: the same /predict, and /residual through the generic engine."""
    pred_j, p_j, _, _, z = _both("2d-2x3-pad3", depth=2, width=10, seed=4)
    mspec = jnet.MLPSpec(depth=2, width=10, scl=1.3, epsil=0.7)
    path = tmp_path / "params_stage_1.npz"
    jckpt.save_pytree(path, p_j, meta={
        "stage": 1, "scl": 1.3, "epsil": 0.7, "problem": "helmholtz_2d",
        "chain": [jnet.spec_to_dict(mspec)],
        "feature_kinds": ["minmax", "minmax"], "lb": [0.0, 0.0],
        "ub": [1.0, 1.0], "hard_bc": None, "coords": ["x", "y"],
        "pad_features": 3, "equation": HELMHOLTZ,
        "patch": {"n": [2, 3], "overlap": 0.5}})
    ours = PINNServer(str(path), "helmholtz_2d", device="cpu")
    theirs = JaxServer(str(path), "helmholtz_2d")
    pts = z.tolist()
    np.testing.assert_allclose(ours.predict(pts), theirs.predict(pts),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.predict(pts),
                               np.asarray(pred_j(p_j, jnp.asarray(z)))[:, 0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.residual(pts), theirs.residual(pts),
                               rtol=1e-4, atol=1e-4)


def test_finished_run_resumes_without_training(served_run, tmp_path):
    out, r = served_run
    copy = tmp_path / "copy"
    shutil.copytree(out, copy)
    r2 = run_patched(_hf_poisson(2 * PI), _serve_spec(),
                     PatchSpec(n=(4,), overlap=0.5), output_dir=str(copy),
                     resume=True, device="cpu")
    assert r2.history.shape[0] == 0
    assert r2.rel_l2 == pytest.approx(r.rel_l2, rel=1e-6)


@pytest.mark.parametrize("what", ["checkpoint_every", "mesh", "cuda"])
def test_refusals(what, monkeypatch, tmp_path):
    """a mesh that is not a tpinn_torch.parallel.Mesh (TypeError) and a
    missing card are refused; checkpoint_every, refused
    before mid-Adam checkpoints were ported, now runs and saves the phase
    (and lbfgs_device, which run_patched does not take, is refused)."""
    if what == "checkpoint_every":
        spec = dataclasses.replace(_serve_spec(checkpoint_every=20),
                                   stages=(StageSpec(
                                       depth=2, width=8, scl=1.0, epsil=1.0,
                                       adam_epochs=20, lbfgs_epochs=0),))
        with pytest.raises(ValueError, match="lbfgs_device"):
            run_patched(_hf_poisson(2 * PI), dataclasses.replace(
                spec, lbfgs_device="cpu"), PatchSpec(n=(2,)), device="cpu")
        run_patched(_hf_poisson(2 * PI), spec, PatchSpec(n=(2,)),
                    output_dir=str(tmp_path), device="cpu")
        assert (tmp_path / "adam_state_stage_1.npz").exists()
        return
    kw = {"mesh": object()} if what == "mesh" else {}
    if what == "cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    err = RuntimeError if what == "cuda" else TypeError
    with pytest.raises(err, match="cuda" if what == "cuda" else "Mesh"):
        run_patched(_hf_poisson(2 * PI), _serve_spec(), PatchSpec(n=(2,)),
                    device="cuda" if what == "cuda" else "cpu", **kw)


def test_flat_and_tree_layouts_agree():
    """One B3 vector for the stacked tree, or one per stacked leaf: the
    same Adam math, f32 rounding apart."""
    spec = dataclasses.replace(_serve_spec(), n_col=64, n_bd=8, grid=32,
                               tail_max=0, stages=(StageSpec(
                                   depth=2, width=8, scl=1.0, epsil=1.0,
                                   adam_epochs=30, lbfgs_epochs=0),))
    runs = [run_patched(_hf_poisson(2 * PI),
                        dataclasses.replace(spec, adam_layout=lay),
                        PatchSpec(n=(3,)), device="cpu")
            for lay in ("flat", "tree")]
    np.testing.assert_allclose(runs[0].history, runs[1].history, rtol=1e-6,
                               atol=1e-7)
    for a, b in zip(tree_leaves(runs[0].params), tree_leaves(runs[1].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.slow
def test_patched_solves_what_single_net_cannot():
    """tpinn's headline case: u = sin(15πx) with 8 patches of 2x16 at
    15,000 / 4,500 reaches rel-L2 < 2e-2."""
    spec = TrainSpec(
        n_col=2048, n_band=0, n_adaptive=0, n_bd=32, testing_size=(512,),
        lw=(1e-5, 0.0), grid=128, pad_features=3,
        stages=(StageSpec(depth=2, width=16, scl=2.0, epsil=1.0,
                          adam_epochs=15000, lbfgs_epochs=4500),),
        log_every=5000, density_every=10**9, plateau_every=3000)
    r = run_patched(_hf_poisson(15 * PI), spec, PatchSpec(n=(8,), overlap=0.5),
                    device="cpu")
    assert r.n_patches == 8
    assert r.rel_l2 is not None and r.rel_l2 < 2e-2, r.rel_l2
