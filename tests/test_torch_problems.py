"""The port's presets and recipes (tpinn_torch.problems) against tpinn's.

Every preset the port has is held to ``tpinn.problems`` field by field;
its oracle, its BC targets, its mask and, at seeded parameters carried
across with ``params_from_numpy``, its residual are held on points drawn
with numpy from a seed.  Tolerances:

- oracles and BC targets in float32: rtol 1e-5, atol 1e-6;
  ``burgers_shock``'s float64 quadrature: 1e-12 absolute;
- residuals in float32: max |diff| <= 1e-4 * max |ref| (order-2 and
  order-3 streams of a random net, held relative to the stream's max);
- the hard-BC ansatz on its boundary: 1e-6 absolute;
- the first loss row of each new training path (same parameters, same
  point set, both packages): rtol 2e-4, atol 1e-6 of the row's max.

``run_training`` runs once per new code path at a narrow width and a short
budget with the port on the CPU (the kernels' plain versions).  The RNG
streams of the two packages differ by design, so whole trajectories are
not compared: the runs are held by the loss drop, a finite rel-L2 below a
stated bar and the log lines of the path, and ``kdv_1d`` also against
tpinn's run of the same configuration (same accuracy class, a factor 3).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn import problems as jproblems
from tpinn.core import loss as jloss
from tpinn.core import net as jnet
from tpinn.core import pde as jpde
from tpinn.problems.recipes import RECIPES as JRECIPES
from tpinn_torch import problems as tproblems
from tpinn_torch.core import loss as tloss
from tpinn_torch.core import net as tnet
from tpinn_torch.core import pde as tpde
from tpinn_torch.core import sample as tsample
from tpinn_torch.core import train as ttrain
from tpinn_torch.utils.convert import params_from_numpy
from torch_spec_compare import field_names, tpinn_asdict

NAMES = sorted(tproblems.PRESETS)
NEW = [n for n in NAMES if n not in ("annulus_laplace", "poisson_1d")]
RES_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These nets are tiny: one intra-op thread is as fast as eight alone,
    and many times faster when several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _points(problem, n, seed=0, inset=0.0):
    rng = np.random.default_rng(seed)
    lb, ub = np.asarray(problem.lb), np.asarray(problem.ub)
    lo, hi = lb + inset * (ub - lb), ub - inset * (ub - lb)
    return rng.uniform(lo, hi, (n, len(lb))).astype(np.float32)


def _group_points(grp, n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(grp.lo, grp.hi, (n, len(grp.lo))).astype(np.float32)


def test_registry_is_tpinns():
    """The registry is tpinn's, in tpinn's order: every preset, every
    recipe and every hard-BC row, ``allen_cahn`` included."""
    assert len(tproblems.PRESETS) == 13 and len(tproblems.RECIPES) == 13
    assert list(tproblems.PRESETS) == list(jproblems.PRESETS)
    assert list(tproblems.RECIPES) == list(JRECIPES)
    for getter in (tproblems.get_problem, tproblems.get_recipe):
        assert getter("allen_cahn") is not None
        with pytest.raises(KeyError, match="no_such"):
            getter("no_such_problem")
    assert list(tproblems.HARD_BC) == list(jproblems.HARD_BC)
    assert len(NEW) == 11


@pytest.mark.parametrize("name", NAMES)
def test_problem_spec_equals_tpinn(name):
    """Every ProblemSpec field, then the callables on seeded points."""
    jp, tp = jproblems.get_problem(name), tproblems.get_problem(name)
    assert [f.name for f in dataclasses.fields(tp)] == [
        f.name for f in dataclasses.fields(jp)]
    for field in ("name", "equation", "coords", "lb", "ub", "feature_kinds",
                  "source", "hard_bc", "dim"):
        assert getattr(tp, field) == getattr(jp, field), field
    assert len(tp.bc_groups) == len(jp.bc_groups)
    for gi, (gt, gj) in enumerate(zip(tp.bc_groups, jp.bc_groups)):
        for field in ("lo", "hi", "value", "value_expr", "field", "operator"):
            assert getattr(gt, field) == getattr(gj, field), (gi, field)
        assert (gt.value_fn is None) == (gj.value_fn is None)
        pts = _group_points(gt, 40, seed=gi)
        got = gt.target(torch.from_numpy(pts))
        assert tuple(got.shape) == (40, 1) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(gj.target(jnp.asarray(pts))),
                                   rtol=1e-5, atol=1e-6, err_msg=f"group {gi}")
    z = _points(tp, 300, seed=1)
    u_t = tp.exact(torch.from_numpy(z))
    assert tuple(u_t.shape) == (300, 1) and u_t.dtype == torch.float32
    np.testing.assert_allclose(u_t.numpy(), np.asarray(jp.exact(jnp.asarray(z))),
                               rtol=1e-5, atol=1e-6)
    assert tp.exact(torch.from_numpy(z).double()).dtype == torch.float64
    for field in ("residual_weight", "eval_mask"):
        ft, fj = getattr(tp, field), getattr(jp, field)
        assert (ft is None) == (fj is None), field
        if ft is not None:
            m = ft(torch.from_numpy(z))
            np.testing.assert_array_equal(m.numpy(),
                                          np.asarray(fj(jnp.asarray(z))))
            assert 0.6 < float(m.mean()) < 0.9      # the L is 3/4 of the box
            assert ft(torch.from_numpy(z).double()).dtype == torch.float64


def _seeded_net(jp, depth=2, width=12, pad=0, seed=3, **kw):
    """The same small net in both packages: (jax predictor, jax params,
    port predictor, port params)."""
    spec_j = jnet.MLPSpec(depth=depth, width=width, **kw)
    fm_j = jnet.feature_map_for(jp.feature_kinds, pad_to=pad)
    p_j = jnet.init_params(jax.random.PRNGKey(seed), spec_j, fm_j)
    pred_j = jnet.make_predictor(spec_j, fm_j, jnp.asarray(jp.lb),
                                 jnp.asarray(jp.ub))
    pred_t = tnet.make_predictor(
        tnet.spec_from_dict(jnet.spec_to_dict(spec_j)),
        tnet.feature_map_for(jp.feature_kinds, pad_to=pad),
        torch.tensor(jp.lb), torch.tensor(jp.ub))
    return pred_j, p_j, pred_t, params_from_numpy(p_j, "cpu")


def _hard(pred_j, pred_t, hard_bc, coords):
    return (jnet.wrap_hard_bc(pred_j, *(jpde.compile_coord_expr(e, coords)
                                        for e in hard_bc)),
            tnet.wrap_hard_bc(pred_t, *(tpde.compile_coord_expr(e, coords)
                                        for e in hard_bc)))


@pytest.mark.parametrize("name", NEW)
def test_residual_equals_tpinn_at_seeded_parameters(name):
    """The compiled equation (less the source) on the same net and points,
    through the engine the port's dispatcher picks."""
    jp, tp = jproblems.get_problem(name), tproblems.get_problem(name)
    pred_j, p_j, pred_t, p_t = _seeded_net(jp)
    cj = jpde.compile_pde(jp.equation, jp.coords)
    ct = tpde.compile_pde(tp.equation, tp.coords)
    assert ct.indices == cj.indices and ct.is_linear == cj.is_linear
    assert ct.max_order == cj.max_order == {"kdv_1d": 3,
                                            "convection_1d": 1}.get(name, 2)
    z = _points(tp, 150, seed=2)
    want = cj.residual(lambda zz: pred_j(p_j, zz), jnp.asarray(z))
    got = ct.residual_fast(pred_t, p_t, torch.from_numpy(z))
    if tp.source:
        want = want - jpde.compile_coord_expr(jp.source, jp.coords)(
            jnp.asarray(z))
        got = got - tpde.compile_coord_expr(tp.source, tp.coords)(
            torch.from_numpy(z))
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape == (150, 1)
    assert np.abs(got.detach().numpy() - want).max() <= RES_REL * np.abs(
        want).max()


@pytest.mark.parametrize("name", sorted(tproblems.HARD_BC))
def test_hard_bc_rows_equal_tpinn_and_ansatz_is_exact(name):
    assert tproblems.HARD_BC[name] == jproblems.HARD_BC[name]
    jp = jproblems.with_hard_bc(jproblems.get_problem(name))
    tp = tproblems.with_hard_bc(tproblems.get_problem(name))
    assert tp.hard_bc == jp.hard_bc == tproblems.HARD_BC[name]
    pred_j, p_j, pred_t, p_t = _seeded_net(jp)
    hard_j, hard_t = _hard(pred_j, pred_t, tp.hard_bc, tp.coords)
    z = _points(tp, 100, seed=4)
    np.testing.assert_allclose(
        hard_t(p_t, torch.from_numpy(z)).detach().numpy(),
        np.asarray(hard_j(p_j, jnp.asarray(z))), rtol=1e-4, atol=1e-5)
    # on every BC group's box the ansatz equals the group's data, whatever
    # the net says (an operator group pins that operator of u)
    for gi, grp in enumerate(tp.bc_groups):
        pts = torch.from_numpy(_group_points(grp, 60, seed=10 + gi))
        f = lambda zz: hard_t(p_t, zz)
        val = (tpde.compile_pde(grp.operator, tp.coords).residual(f, pts)
               if grp.operator else f(pts))
        err = float((val - grp.target(pts)).abs().max())
        assert err <= 1e-6, (gi, err)
    # and the net does matter inside
    inner = torch.from_numpy(_points(tp, 50, seed=5, inset=0.2))
    lift = tpde.compile_coord_expr(tp.hard_bc[0], tp.coords)
    assert float((hard_t(p_t, inner) - lift(inner)).abs().max()) > 1e-5


def test_burgers_shock_oracle_equals_tpinn():
    """Host float64 quadrature, to 1e-12; a float32 tensor in gives a
    float32 tensor out (one round trip through numpy per call)."""
    jp, tp = (jproblems.get_problem("burgers_shock"),
              tproblems.get_problem("burgers_shock"))
    rng = np.random.default_rng(6)
    z = np.concatenate([rng.uniform((-1.0, 0.0), (1.0, 1.0), (400, 2)),
                        [[0.0, 0.0], [0.01, 1.0], [-1.0, 0.5], [1.0, 1.0]]])
    want = np.asarray(jp.exact(z), np.float64)
    got = tp.exact(torch.from_numpy(z))
    assert got.dtype == torch.float64 and tuple(got.shape) == (404, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # the front: steep at x = 0 by t = 1, antisymmetric, IC at t = 0
    np.testing.assert_allclose(got.numpy()[400, 0], 0.0, atol=1e-12)
    assert abs(got.numpy()[401, 0]) > 0.5
    np.testing.assert_allclose(got.numpy()[402:, 0], 0.0, atol=1e-12)
    x0 = np.stack([np.linspace(-1, 1, 9), np.zeros(9)], axis=1)
    np.testing.assert_allclose(tp.exact(torch.from_numpy(x0)).numpy()[:, 0],
                               -np.sin(np.pi * x0[:, 0]), atol=1e-12)
    z32 = torch.from_numpy(z.astype(np.float32))
    u32 = tp.exact(z32)
    assert u32.dtype == torch.float32 and u32.device == z32.device
    custom = tproblems.burgers_shock(nu=0.05)
    assert custom.equation == jproblems.burgers_shock(nu=0.05).equation


@pytest.mark.parametrize("which", ["allen_cahn", "nls"])
def test_oracles_equal_tpinn(which):
    """problems.oracles is a copy of tpinn's: the same solves at a reduced
    grid and step count give the same bits, and so does the periodic
    interpolant on points past the seam and past the last frame."""
    from tpinn.problems import oracles as joracles
    from tpinn_torch.problems import oracles as toracles

    if which == "allen_cahn":
        kw = dict(n=64, dt=2e-3, t_final=0.1, frame_every=5)
        run = lambda m: m.allen_cahn_solution(**kw)
        period = 2.0
    else:
        kw = dict(n=128, nsteps=200, t_final=0.2, frame_every=20)
        run = lambda m: m.nls_solution(**kw)
        period = 10.0
    got, want = run(toracles), run(joracles)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    t, x, U = got
    assert U.shape == (len(t), len(x)) and np.isfinite(U).all()
    U = U.real
    rng = np.random.default_rng(11)
    z = np.stack([rng.uniform(x[0] - period, x[0] + 2 * period, 200),
                  rng.uniform(t[0], 1.2 * t[-1], 200)], axis=1)
    np.testing.assert_array_equal(
        toracles.grid_interpolant(t, x, U, period)(z),
        joracles.grid_interpolant(t, x, U, period)(z))


def test_allen_cahn_preset_equals_tpinn():
    """The preset's oracle against tpinn's at sample points to 1e-12 in
    float64 (the oracle runs on the host in float64 in both), its IC
    against the closed form to 1e-12, a
    float32 tensor in giving a float32 tensor out; the oracle's IC row is
    the IC."""
    jp, tp = jproblems.get_problem("allen_cahn"), tproblems.allen_cahn()
    assert tp.feature_kinds == ("periodic_fit", "minmax") == jp.feature_kinds
    assert tp.hard_bc is None and tp.source is None and tp.eval_mask is None
    rng = np.random.default_rng(12)
    z = np.concatenate([rng.uniform((-1.0, 0.0), (1.0, 1.0), (300, 2)),
                        [[-1.0, 0.0], [1.0, 1.0], [0.3, 0.0]]])
    got = tp.exact(torch.from_numpy(z))
    assert got.dtype == torch.float64 and tuple(got.shape) == (303, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jp.exact(z)),
                               rtol=0, atol=1e-12)
    # the IC in float64 against its closed form (tpinn's compiles to
    # float32 without x64: test_problem_spec_equals_tpinn holds it there)
    ic = tp.bc_groups[0]
    x0 = np.stack([np.linspace(-1, 1, 41), np.zeros(41)], axis=1)
    np.testing.assert_allclose(
        ic.target(torch.from_numpy(x0)).numpy()[:, 0],
        x0[:, 0] ** 2 * np.cos(np.pi * x0[:, 0]), rtol=0, atol=1e-12)
    assert ic.value_expr == jp.bc_groups[0].value_expr
    # away from the seam, where the cubic interpolant meets the kink of
    # the periodic extension
    xi = x0[4:-4]
    np.testing.assert_allclose(tp.exact(torch.from_numpy(xi)).numpy()[:, 0],
                               xi[:, 0] ** 2 * np.cos(np.pi * xi[:, 0]),
                               atol=1e-4)
    z32 = torch.from_numpy(z.astype(np.float32))
    assert tp.exact(z32).dtype == torch.float32


@pytest.mark.parametrize("name", NAMES)
def test_recipe_equals_tpinn(name):
    """TrainSpec and Recipe field for field, and what get_recipe returns."""
    jp, jspec = jproblems.get_recipe(name)
    tp, tspec = tproblems.get_recipe(name)
    assert tpinn_asdict(tspec) == dataclasses.asdict(jspec)
    assert field_names(tspec) == [f.name for f in dataclasses.fields(jspec)]
    for st, sj in zip(tspec.stages, jspec.stages):
        assert field_names(st) == [f.name for f in dataclasses.fields(sj)]
    jrec, trec = JRECIPES[name], tproblems.RECIPES[name]
    assert [f.name for f in dataclasses.fields(trec)] == [
        f.name for f in dataclasses.fields(jrec)]
    for f in dataclasses.fields(jrec):
        if f.name != "spec":
            assert getattr(trec, f.name) == getattr(jrec, f.name), f.name
    assert trec.spec is tspec
    assert tp.hard_bc == jp.hard_bc
    assert (tp.hard_bc is not None) == trec.hard_bc
    if trec.hard_bc:
        assert tp.hard_bc == tproblems.HARD_BC[name]
    for field in ("name", "equation", "coords", "lb", "ub", "feature_kinds",
                  "source"):
        assert getattr(tp, field) == getattr(jp, field), field
    if trec.march:
        assert not trec.hard_bc and name in ("convection_1d", "allen_cahn",
                                             "wave_1d")


# ---------------------------------------------------------------------------
# The new training paths: the first loss row, then a cut-budget run
# ---------------------------------------------------------------------------

PATHS = ["poisson_3d", "helmholtz_2d", "burgers_1d", "lshape_laplace",
         "kdv_1d"]


def _cut(name, adam=40, lbfgs=30, width=12, **kw):
    """The recipe as written with only its size cut: 2 hidden layers of
    ``width``, a few hundred points, a small density grid."""
    prob, spec = tproblems.get_recipe(name)
    stages = tuple(dataclasses.replace(
        s, depth=2, width=width, adam_epochs=adam, lbfgs_epochs=lbfgs,
        lbfgs_grid=(10 if s.lbfgs_grid else 0),
        fourier_features=(8 if s.fourier_features else 0))
        for s in spec.stages)
    spec = dataclasses.replace(
        spec, n_col=200, n_band=(40 if spec.n_band else 0), n_adaptive=60,
        n_bd=16, grid=11, tail_max=5, density_every=20, plateau_every=20,
        resample_every=10, log_every=1000,
        testing_size=(16,) * prob.dim, stages=stages, **kw)
    return prob, spec


def _to_jax_problem(name, hard):
    jp = jproblems.get_problem(name)
    return jproblems.with_hard_bc(jp) if hard else jp


@pytest.mark.parametrize("name", PATHS)
def test_first_loss_row_equals_tpinn(name):
    """The loss of the path as run_training builds it (stage-1 equation,
    source, residual weight, hard BC, the stage's net family, pad_features)
    on the port's own first point draw, in both packages at tpinn's
    initial parameters."""
    tp, spec = _cut(name)
    st = spec.stages[0]
    jp = _to_jax_problem(name, tp.hard_bc is not None)
    fam = dict(fourier_features=st.fourier_features,
               fourier_scale=(2.0 if st.fourier_features else 1.0))
    pred_j, p_j, pred_t, p_t = _seeded_net(jp, pad=spec.pad_features, **fam)
    if tp.hard_bc:
        pred_j, pred_t = _hard(pred_j, pred_t, tp.hard_bc, tp.coords)
    eq = st.equation or tp.equation
    kw_j, kw_t = {}, {}
    if tp.source:
        kw_j["source_fn"] = jpde.compile_coord_expr(jp.source, jp.coords)
        kw_t["source_fn"] = tpde.compile_coord_expr(tp.source, tp.coords)
    if tp.residual_weight is not None:
        kw_j["residual_weight_fn"] = jp.residual_weight
        kw_t["residual_weight_fn"] = tp.residual_weight
    loss_j = jloss.make_loss(pred_j, jpde.compile_pde(eq, jp.coords), **kw_j)
    loss_t = tloss.make_loss(pred_t, tpde.compile_pde(eq, tp.coords), **kw_t)
    cfg = tsample.SamplerConfig(spec.n_col, spec.n_band, spec.n_adaptive,
                                spec.n_bd, grid=spec.grid)
    fn, grids = tsample.sampler_for(cfg, tp.bc_groups, tp.lb, tp.ub)
    data_t = fn(torch.Generator().manual_seed(0), torch.ones_like(grids[0]))
    n_groups = len(tp.bc_groups)
    assert data_t["x_col"].shape[0] == (spec.n_col + spec.n_band
                                        + spec.n_adaptive
                                        + n_groups * spec.n_bd)
    data_j = {"x_col": jnp.asarray(data_t["x_col"].numpy()),
              "x_bd": [jnp.asarray(x.numpy()) for x in data_t["x_bd"]],
              "u_bd": [jnp.asarray(u.numpy()) for u in data_t["u_bd"]]}
    lw = spec.lw
    _, info_j = jax.jit(loss_j)(p_j, data_j, jnp.asarray(lw, jnp.float32),
                                jnp.asarray(1.0))
    l_t, info_t = loss_t(p_t, data_t, torch.tensor(lw), torch.tensor(1.0))
    info_j = np.asarray(info_j)
    assert info_t.shape == info_j.shape == (tloss.loss_info_width(n_groups),)
    np.testing.assert_allclose(info_t.detach().numpy(), info_j, rtol=2e-4,
                               atol=1e-6 * np.abs(info_j).max())
    assert np.isfinite(info_j).all() and float(l_t) > 0


def _run(name, tmp_path, **kw):
    prob, spec = _cut(name, **kw)
    lines = []
    res = ttrain.run_training(prob, spec, output_dir=str(tmp_path),
                              log_fn=lines.append, device="cpu")
    return prob, spec, res, lines


def _meta(path):
    with np.load(path) as raw:
        return json.loads(bytes(raw["__meta__"]).decode()), list(raw.files)


def _polish_pairs(lines):
    out = []
    for ln in lines:
        if "lsq polish objective" in ln:
            w = ln.split()
            out.append((float(w[5]), float(w[7]), "not applied" in ln))
    return out


def test_poisson_3d_recipe_path(tmp_path):
    """Hard BC, the n-D sampler and density, the 3-D L-BFGS grid, a
    last-layer solve at d = 3 after both rounds, the 3-D evaluation, and
    the checkpoint served at 3-coordinate points."""
    from tpinn_torch.app.serve import PINNServer

    prob, spec, res, lines = _run("poisson_3d", tmp_path, adam=120, lbfgs=60,
                                  width=16)
    assert prob.hard_bc and spec.stages[0].lbfgs_rounds == 2
    assert any("deterministic 10^3 grid (1000 pts)" in ln for ln in lines)
    pairs = _polish_pairs(lines)
    assert len(pairs) == 2
    assert all(post <= pre for pre, post, _ in pairs) and not pairs[0][2]
    st = res.stages[0]
    assert st.U.shape == (16 ** 3, 1) and st.F.shape == (16 ** 3, 1)
    # the bubble peaks at 1/64, so 120 Adam steps barely move u; L-BFGS
    # and the two solves do: the loss falls over the stage as a whole
    assert st.history[-1, 0] < 0.5 * st.history[0, 0]
    assert np.isfinite(res.rel_l2) and res.rel_l2 < 0.5, res.rel_l2
    # d = 3 writes the loss history and the checkpoint, no 2-D figures
    assert (tmp_path / "loss_1.npz").exists()
    assert not (tmp_path / "solution_residual_1.npz").exists()
    meta, files = _meta(tmp_path / "params_stage_1.npz")
    assert meta["coords"] == ["x", "y", "z"] and meta["deflation"] is None
    assert meta["hard_bc"] == list(tproblems.HARD_BC["poisson_3d"])
    srv = PINNServer(str(tmp_path / "params_stage_1.npz"), "poisson_3d",
                     device="cpu")
    pts = _points(prob, 40, seed=8)
    want = res.predict(torch.from_numpy(pts))[:, 0].detach().numpy()
    np.testing.assert_allclose(srv.predict(pts.tolist()), want, rtol=1e-5,
                               atol=1e-6)
    f = np.asarray(srv.residual(pts.tolist()))
    compiled = tpde.compile_pde(prob.equation, prob.coords)
    f_want = compiled.residual(res.predict, torch.from_numpy(pts))
    # float32 second derivatives of a freshly solved output layer (large,
    # cancelling weights) through two engines: relative to the field's max
    f_want = f_want[:, 0].detach().numpy()
    assert np.abs(f - f_want).max() <= 1e-3 * np.abs(f_want).max()
    face = np.array([[0.0, 0.3, 0.7], [0.4, 1.0, 0.2], [0.9, 0.5, 0.0]],
                    np.float32)
    assert np.abs(srv.predict(face.tolist())).max() <= 1e-6


def test_helmholtz_2d_recipe_path(tmp_path):
    """Two Fourier stages: stage 1 on its own equation (k = 10), stage 2
    the same net warm-started at the preset's k = 20; soft BC; the
    last-layer solve reaches mlp_hidden of the Fourier family."""
    prob, spec, res, lines = _run("helmholtz_2d", tmp_path, deflation="off")
    assert prob.hard_bc is None and spec.lw == (1e-4, 0.0)
    assert spec.stages[1].init_from == "prev" and spec.stages[0].equation
    assert any("stage 1: equation override 'u_xx + u_yy + 100*u" in ln
               for ln in lines)
    assert any("stage 2: warm start from stage 1" in ln for ln in lines)
    assert not any("engine='kernel'" in ln for ln in lines)
    assert len(res.stages) == 2
    for st in res.stages:
        assert sorted(st.params) == ["fourier_b", "layers"]   # no chain
        assert tuple(st.params["fourier_b"].shape) == (3, 8)
        assert st.history[-1, 0] < st.history[0, 0]
    assert len(_polish_pairs(lines)) == 2
    assert all(post <= pre for pre, post, _ in _polish_pairs(lines))
    # the warm start moved stage 1's weights on, not fresh ones
    assert not torch.equal(res.stages[0].params["fourier_b"],
                           res.stages[1].params["fourier_b"])
    assert np.isfinite(res.rel_l2)
    meta, files = _meta(tmp_path / "params_stage_2.npz")
    assert len(meta["chain"]) == 1 and meta["chain"][0]["fourier_features"] == 8
    assert meta["chain"][0]["fourier_scale"] == 10.0
    assert "leaf:fourier_b" in files and meta["pad_features"] == 3
    assert (tmp_path / "solution_residual_2.npz").exists()


def test_burgers_1d_recipe_path(tmp_path):
    """Two composed stages on a nonlinear equation: the last-layer solve
    is skipped, the final correction is the Galerkin family's Newton step
    (or declined by its own guard), and it does not make rel-L2 worse."""
    prob, spec, res, lines = _run("burgers_1d", tmp_path)
    assert prob.hard_bc and prob.source and len(res.stages) == 2
    assert sum("lsq_polish skipped (equation nonlinear in u)" in ln
               for ln in lines) == 2
    assert not _polish_pairs(lines)
    assert any(ln.startswith("stage 2: scl=") for ln in lines)
    assert sorted(res.stages[1].params) == ["prev", "stage"]
    defl_lines = [ln for ln in lines if ln.startswith("deflation='full'")]
    assert len(defl_lines) == 1
    meta, _ = _meta(tmp_path / "params_stage_2.npz")
    defl = meta["deflation"]
    if defl is None:
        assert "no applicable correction" in defl_lines[0]
    else:
        assert defl["kind"] == "galerkin" and "galerkin" in defl_lines[0]
        assert 0.0 <= defl["resid_drop"] < 0.8
        assert res.rel_l2 <= defl["rel_l2_before"]
        z = torch.from_numpy(_points(prob, 30, seed=9))
        assert float((res.stages[1].predictor_frozen(z)
                      - res.predict(z)).abs().max()) == 0.0
    h1 = res.stages[0].history
    assert h1[-1, 0] < 0.1 * h1[0, 0]
    assert np.isfinite(res.rel_l2) and res.rel_l2 < 0.05, res.rel_l2
    assert len(meta["chain"]) == 2 and meta["chain"][1]["act_first"] == "sin"


def test_lshape_laplace_recipe_path(tmp_path):
    """The masked domain: the density and the metric see the L only."""
    prob, spec, res, lines = _run("lshape_laplace", tmp_path,
                                  lsq_polish="auto", deflation="full")
    assert prob.eval_mask is not None and prob.residual_weight is not None
    assert any("lsq_polish skipped (masked non-box domain)" in ln
               for ln in lines)
    assert any("deflation skipped: masked non-box domain" in ln
               for ln in lines)
    masked = [ln for ln in lines if "final rel-L2 vs analytic (masked" in ln]
    assert len(masked) == 1 and "192/256 pts" in masked[0]
    assert np.isfinite(res.rel_l2) and res.rel_l2 < 0.5, res.rel_l2
    h = res.stages[0].history
    assert h[-1, 0] < 0.2 * h[0, 0]
    meta, _ = _meta(tmp_path / "params_stage_1.npz")
    assert meta["deflation"] is None
    # the recipe as written leaves both off: nothing to skip, nothing said
    _, _, res2, lines2 = _run("lshape_laplace", tmp_path / "plain", adam=5,
                              lbfgs=3)
    assert not any("skipped" in ln for ln in lines2)
    assert np.isfinite(res2.rel_l2)


def test_kdv_1d_recipe_path_against_tpinn(tmp_path):
    """Order 3: only the generic engine computes u_xxx.  tpinn's run of the
    same configuration lands in the same accuracy class (the soliton is
    barely resolved at this size: both sit near rel-L2 0.9)."""
    from tpinn.core import train as jtrain

    prob, spec, res, lines = _run("kdv_1d", tmp_path)
    compiled = tpde.compile_pde(prob.equation, prob.coords)
    assert compiled.max_order == 3 and not compiled.is_linear
    assert not any("polish" in ln or "deflation" in ln for ln in lines)
    h = res.stages[0].history
    assert h.shape[1] == tloss.loss_info_width(3)
    assert h[-1, 0] < 0.5 * h[0, 0]
    assert np.isfinite(res.rel_l2)
    jprob, jspec = jproblems.get_recipe("kdv_1d")
    _, cut = _cut("kdv_1d")
    jspec = dataclasses.replace(
        jspec, **{f.name: getattr(cut, f.name)
                  for f in dataclasses.fields(cut) if f.name != "stages"},
        stages=tuple(dataclasses.replace(
            sj, **tpinn_asdict(st))
            for sj, st in zip(jspec.stages, cut.stages)))
    assert dataclasses.asdict(jspec) == tpinn_asdict(spec)
    jres = jtrain.run_training(jprob, jspec)
    assert jres.history[-1, 0] < 0.5 * jres.history[0, 0]
    assert res.rel_l2 < 3.0 * jres.rel_l2 and jres.rel_l2 < 3.0 * res.rel_l2, (
        res.rel_l2, jres.rel_l2)
