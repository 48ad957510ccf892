"""Time marching: tpinn_torch.core.march against tpinn.core.march.

The same window nets (numpy-seeded parameters carried across with
``params_from_numpy``) and the same points go through both packages.
Tolerances, float32 on the CPU:

- window problems group by group: boxes, expressions, operators and
  fields equal; handoff targets (the previous window's value and, for
  wave, its time derivative) within 1e-6, the other targets rtol 1e-5,
  atol 1e-6;
- ``axis_derivative`` of a net: 1e-5;
- the composite, points on the inner edges included: 1e-6;
- the composite's u-partials at interior points: rtol 1e-4, atol 1e-6;
  its residual the same for heat_2d, and for allen_cahn (terms of order
  5 that cancel) rtol 1e-4, atol 1e-4·max|f|.

End to end (the port alone: the two packages' random streams differ by
design, so trajectories are not compared): a 2-window ``heat_2d`` run with
its ``march.json`` keys held to tpinn's (tpinn's driver run over stub
windows), its composite artifacts to tests/goldens/artifacts, the
composite to each window inside its slab, ``resume=True`` retraining
nothing, and earlier windows' parameters bitwise unchanged with no
``.grad`` after later windows train; a 2-window ``wave_1d`` run for the
velocity handoff.
"""

import dataclasses
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn import problems as jproblems
from tpinn.core import march as jmarch
from tpinn.core import net as jnet
from tpinn.core import pde as jpde
from tpinn_torch import problems as tproblems
from tpinn_torch.core import march as tmarch
from tpinn_torch.core import net as tnet
from tpinn_torch.core import optim as toptim
from tpinn_torch.core import pde as tpde
from tpinn_torch.core.train import StageSpec, TrainSpec
from tpinn_torch.utils.convert import params_from_numpy

GOLDEN = Path(__file__).resolve().parent / "goldens" / "artifacts"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These nets are tiny: one intra-op thread is as fast as eight alone,
    and many times faster when several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _nets(problem, n, seed=0):
    """``n`` window-sized nets (2x12 on the problem's features), each as a
    (jax z -> u, port z -> u) pair on the same parameters."""
    out = []
    fm_j = jnet.feature_map_for(problem.feature_kinds)
    fm_t = tnet.feature_map_for(problem.feature_kinds)
    for k in range(n):
        spec = jnet.MLPSpec(depth=2, width=12)
        p_j = jnet.init_params(jax.random.PRNGKey(seed + k), spec, fm_j)
        pred_j = jnet.make_predictor(spec, fm_j, jnp.asarray(problem.lb),
                                     jnp.asarray(problem.ub))
        pred_t = tnet.make_predictor(
            tnet.spec_from_dict(jnet.spec_to_dict(spec)), fm_t,
            torch.tensor(problem.lb), torch.tensor(problem.ub))
        p_t = params_from_numpy(p_j, "cpu")
        out.append((lambda z, f=pred_j, p=p_j: f(p, z),
                    lambda z, f=pred_t, p=p_t: f(p, z)))
    return out


def _box_points(lo, hi, n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, len(lo))).astype(np.float32)


def _both(fj, ft, z):
    return (np.asarray(fj(jnp.asarray(z))),
            ft(torch.from_numpy(z)).detach().numpy())


def tiny_spec(adam=120, lbfgs=60, **kw):
    return TrainSpec(
        n_col=200, n_band=0, n_adaptive=50, n_bd=40,
        testing_size=kw.pop("testing_size", (21, 21)), grid=21, tail_max=0,
        pad_features=3,
        stages=(StageSpec(depth=2, width=12, scl=1.0, epsil=1.0,
                          adam_epochs=adam, lbfgs_epochs=lbfgs),), **kw)


# ---------------------------------------------------------------------------
# Parity of the pieces
# ---------------------------------------------------------------------------

W = 4


@pytest.mark.parametrize("k", [0, 1, W - 1])
@pytest.mark.parametrize("name", ["heat_2d", "convection_1d", "wave_1d",
                                  "allen_cahn"])
def test_window_problem_equals_tpinn(name, k):
    jp, tp = jproblems.get_problem(name), tproblems.get_problem(name)
    ai = tp.coords.index("t")
    edges = np.linspace(tp.lb[ai], tp.ub[ai], W + 1)
    compiled = tpde.compile_pde(tp.equation, tp.coords)
    velocity = max(ix.count(ai) for ix in compiled.indices) == 2
    assert velocity == (name == "wave_1d")
    prev_j, prev_t = _nets(tp, 1, seed=7)[0] if k else (None, None)
    wj = jmarch.window_problem(jp, ai, edges[k], edges[k + 1], k, prev_j,
                               handoff_velocity=velocity)
    wt = tmarch.window_problem(tp, ai, edges[k], edges[k + 1], k, prev_t,
                               handoff_velocity=velocity)
    for field in ("name", "equation", "coords", "lb", "ub", "feature_kinds",
                  "source", "hard_bc"):
        assert getattr(wt, field) == getattr(wj, field), field
    assert wt.lb[ai] == edges[k] and wt.ub[ai] == edges[k + 1]
    assert len(wt.bc_groups) == len(wj.bc_groups)
    n_handoff = (1 + velocity) if k else 0
    assert sum(g.value_expr is not None and g.value_expr.startswith(
        "<window") for g in wt.bc_groups) == n_handoff
    if velocity and k:
        assert wt.bc_groups[-1].operator == "u_t"
    for gi, (gt, gj) in enumerate(zip(wt.bc_groups, wj.bc_groups)):
        for field in ("lo", "hi", "value", "value_expr", "field",
                      "operator"):
            assert getattr(gt, field) == getattr(gj, field), (gi, field)
        assert (gt.value_fn is None) == (gj.value_fn is None)
        pts = _box_points(gt.lo, gt.hi, 50, seed=gi)
        got = gt.target(torch.from_numpy(pts))
        want = np.asarray(gj.target(jnp.asarray(pts)))
        assert tuple(got.shape) == want.shape == (50, 1)
        assert not got.requires_grad
        handoff = gi >= len(wt.bc_groups) - n_handoff
        np.testing.assert_allclose(
            got.numpy(), want, rtol=(1e-6 if handoff else 1e-5),
            atol=1e-6, err_msg=f"group {gi}")
    if k:
        assert not any(g.lo[ai] == 0.0 == g.hi[ai] for g in wt.bc_groups)


@pytest.mark.parametrize("axis", [0, 1])
def test_axis_derivative_equals_tpinn(axis):
    """The derivative of a net on convection_1d's periodic/minmax features
    along each coordinate, and the velocity carries no autograd graph into
    parameters that do not require one."""
    tp = tproblems.convection_1d()
    fj, ft = _nets(tp, 1, seed=3)[0]
    z = _box_points(tp.lb, tp.ub, 200, seed=4)
    want, got = _both(jmarch.axis_derivative(fj, axis),
                      tmarch.axis_derivative(ft, axis), z)
    assert got.shape == want.shape == (200, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(want).max() > 0.1


EDGES = [0.0, 1.0 / 3.0, 0.5, 1.0]


def _edge_points():
    """Points in every slab and exactly on every edge (the float32 values
    of the edges, which is what the composite compares against)."""
    z = _box_points((0.0, 0.0), (1.0, 1.0), 120, seed=9)
    on = np.array([[0.2, e] for e in EDGES] + [[0.7, e] for e in EDGES],
                  np.float32)
    return np.concatenate([z, on])


def test_march_predictor_equals_tpinn():
    """Values at 1e-6, a point on an inner edge in the later window, and
    the coordinate gradient (forward and reverse) through the selected
    window only."""
    tp = tproblems.heat_2d()
    nets = _nets(tp, 3, seed=11)
    cj = jmarch.make_march_predictor([f for f, _ in nets], EDGES, 1)
    ct = tmarch.make_march_predictor([f for _, f in nets], EDGES, 1)
    z = _edge_points()
    want, got = _both(cj, ct, z)
    assert got.shape == want.shape == (len(z), 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    zt = torch.from_numpy(z)
    sel = np.searchsorted(np.float32(EDGES[1:-1]), z[:, 1], side="right")
    assert sel[-8:].tolist() == [0, 1, 2, 2, 0, 1, 2, 2]
    vals = [f(zt).detach().numpy() for _, f in nets]
    np.testing.assert_array_equal(
        got, np.stack(vals)[sel, np.arange(len(z))])
    for ax in (0, 1):
        d_c = tmarch.axis_derivative(ct, ax)(zt).detach().numpy()
        d_w = np.stack([tmarch.axis_derivative(f, ax)(zt).detach().numpy()
                        for _, f in nets])[sel, np.arange(len(z))]
        np.testing.assert_array_equal(d_c, d_w)
    zg = zt.clone().requires_grad_(True)
    (g_c,) = torch.autograd.grad(ct(zg).sum(), zg)
    g_w = []
    for _, f in nets:
        zk = zt.clone().requires_grad_(True)
        g_w.append(torch.autograd.grad(f(zk).sum(), zk)[0].numpy())
    np.testing.assert_array_equal(g_c.numpy(),
                                  np.stack(g_w)[sel, np.arange(len(z))])


@pytest.mark.parametrize("name", ["heat_2d", "allen_cahn"])
def test_composite_residual_equals_tpinn(name):
    """The equation's u-partials and the equation itself on the 3-window
    composite at interior points, through each package's engine (the
    port's dispatcher sends the composite to the generic one).  heat_2d's
    residual at rtol 1e-4, atol 1e-6; allen_cahn's (u_t − 1e-4·u_xx
    + 5u³ − 5u, terms of order 5 that cancel to 1e-3 at some points) at
    rtol 1e-4 with the float32 rounding of those terms held relative to
    the field, atol 1e-4·max|f| (tests/test_torch_problems.py's rule)."""
    from tpinn.core import deriv as jderiv
    from tpinn_torch.core import deriv as tderiv

    jp, tp = jproblems.get_problem(name), tproblems.get_problem(name)
    nets = _nets(tp, 3, seed=21)
    cj = jmarch.make_march_predictor([f for f, _ in nets], EDGES, 1)
    ct = tmarch.make_march_predictor([f for _, f in nets], EDGES, 1)
    z = _box_points((tp.lb[0], 0.02), (tp.ub[0], 0.98), 150, seed=22)
    z = z[np.min(np.abs(z[:, 1:2] - np.asarray(EDGES)[None]), axis=1) > 0.02]
    compiled = tpde.compile_pde(tp.equation, tp.coords)
    pj = jderiv.partials(cj, jnp.asarray(z), compiled.indices)
    pt = tderiv.partials(ct, torch.from_numpy(z), compiled.indices)
    assert set(pt) == set(pj) >= set(compiled.indices)
    for ix in pj:
        np.testing.assert_allclose(pt[ix].detach().numpy(),
                                   np.asarray(pj[ix]), rtol=1e-4, atol=1e-6,
                                   err_msg=str(ix))
    want = np.asarray(jpde.compile_pde(jp.equation, jp.coords).residual(
        cj, jnp.asarray(z)))
    got = compiled.residual(ct, torch.from_numpy(z)).detach().numpy()
    got_fast = compiled.residual_fast(lambda p, zz: ct(zz), None,
                                      torch.from_numpy(z)).detach().numpy()
    assert got.shape == want.shape == (len(z), 1)
    atol = 1e-6 if compiled.is_linear else 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    np.testing.assert_array_equal(got_fast, got)


def _order3_in_t(p):
    return dataclasses.replace(p, equation="u_ttt - u_xx")


@pytest.mark.parametrize("case", ["one_window", "axis", "hard_bc", "order"])
def test_validation_messages_equal_tpinn(case):
    """The refusals raise before any training, with tpinn's messages."""
    jp, tp = jproblems.heat_2d(), tproblems.heat_2d()
    kw = {"n_windows": 2}
    if case == "one_window":
        kw["n_windows"] = 1
    elif case == "axis":
        kw["axis"] = "z"
    elif case == "hard_bc":
        jp, tp = jproblems.with_hard_bc(jp), tproblems.with_hard_bc(tp)
    else:
        jp, tp = _order3_in_t(jp), _order3_in_t(tp)
    with pytest.raises(ValueError) as ej:
        jmarch.run_time_marching(jp, jmarch.TrainSpec(), **kw)
    with pytest.raises(ValueError) as et:
        tmarch.run_time_marching(tp, tiny_spec(), device="cpu", **kw)
    assert str(et.value) == str(ej.value)


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tmarch.run_time_marching(tproblems.heat_2d(), tiny_spec(), 2,
                                 device="cuda")


# ---------------------------------------------------------------------------
# End to end (the port on the CPU)
# ---------------------------------------------------------------------------


def _tpinn_record_keys(tmp_path):
    """tpinn's march.json and top-level artifacts from its own driver over
    stub windows (zero predictors), which is all the record needs."""
    def stub(sub, spec, output_dir=None, **kw):
        return types.SimpleNamespace(
            predict=lambda z: jnp.zeros((z.shape[0], 1), z.dtype),
            stages=[None], history=np.zeros((3, 7)), rel_l2=0.5,
            fell_back=False)

    out = tmp_path / "tpinn"
    real = jmarch.run_training
    jmarch.run_training = stub
    try:
        jmarch.run_time_marching(jproblems.heat_2d(), jmarch.TrainSpec(
            testing_size=(41, 41)), 2, output_dir=str(out))
    finally:
        jmarch.run_training = real
    return out


def _snapshots(monkeypatch):
    """Records every window's parameters as run_training returns them."""
    taken = []
    real = tmarch.run_training

    def recorded(*a, **kw):
        res = real(*a, **kw)
        taken.append([x.clone() for x in
                      toptim.tree_leaves(res.stages[-1].params)])
        return res

    monkeypatch.setattr(tmarch, "run_training", recorded)
    return taken


def _unchanged(res, taken):
    """Every window's parameters are the ones it ended its training with,
    bitwise, and hold no gradient."""
    assert len(taken) == len(res.windows)
    for k, (win, snap) in enumerate(zip(res.windows, taken)):
        leaves = toptim.tree_leaves(win.stages[-1].params)
        assert len(leaves) == len(snap)
        for x, y in zip(leaves, snap):
            assert x.grad is None and not x.requires_grad, k
            assert torch.equal(x, y), k


def test_heat_2d_two_windows_end_to_end(tmp_path, monkeypatch):
    taken = _snapshots(monkeypatch)
    out = tmp_path / "port"
    lines = []
    res = tmarch.run_time_marching(
        tproblems.heat_2d(), tiny_spec(testing_size=(41, 41)), 2,
        output_dir=str(out), log_fn=lines.append, device="cpu")
    assert res.rel_l2 is not None and np.isfinite(res.rel_l2)
    assert res.rel_l2 < 1.0
    assert res.edges.tolist() == [0.0, 0.5, 1.0] and res.axis_index == 1
    assert [w.problem.name for w in res.windows] == ["heat_2d_w1",
                                                     "heat_2d_w2"]
    assert any("march window 2/2: t in [0.5, 1], 3 BC groups" in ln
               for ln in lines)
    _unchanged(res, taken)

    # march.json: tpinn's keys, the port's values
    rec = json.loads((out / "march.json").read_text())
    ref = _tpinn_record_keys(tmp_path)
    jrec = json.loads((ref / "march.json").read_text())
    assert list(rec) == list(jrec)
    for key in ("problem", "axis", "axis_index", "edges", "windows"):
        assert rec[key] == jrec[key], key
    assert rec["rel_l2"] == res.rel_l2
    assert rec["rel_l2_windows"] == [w.rel_l2 for w in res.windows]
    assert not (out / "march.json.tmp").exists()
    for w in rec["windows"]:
        assert (out / w).exists()

    # the composite artifacts: tpinn's files, the golden run's keys and
    # (but for the per-step and per-point counts) shapes
    top = sorted(p.name for p in out.glob("*.npz"))
    assert top == sorted({p.name for p in ref.glob("*.npz")}
                         | {"collocation_point_1.npz"})
    for name in top:
        mine, gold = np.load(out / name), np.load(GOLDEN / name)
        assert mine.files == gold.files, name
        for key in gold.files:
            if name.startswith(("loss", "boundary")) or key == "X_col":
                assert mine[key].ndim == gold[key].ndim, (name, key)
            else:
                assert mine[key].shape == gold[key].shape, (name, key)
    with np.load(out / "collocation_point_1.npz") as d:
        assert d["X_col"].shape[0] == sum(
            np.load(out / f"window_{k}" / "collocation_point_1.npz")
            ["X_col"].shape[0] for k in (1, 2))

    # the composite is window k inside slab k (t = 0.5 is window 2's)
    z = torch.tensor([[0.4, 0.0], [0.4, 0.2], [0.7, 0.49], [0.4, 0.5],
                      [0.1, 0.8], [0.6, 1.0]])
    with torch.no_grad():
        u = res.predict(z)
        u0, u1 = (w.predict(z) for w in res.windows)
    assert torch.equal(u[:3], u0[:3]) and torch.equal(u[3:], u1[3:])
    assert float((u0[3:] - u1[3:]).abs().max()) > 0.0

    # resume: every window from its checkpoint, nothing trained
    def refuse(*a, **kw):
        raise AssertionError("resume=True trained a window")

    monkeypatch.setattr(toptim, "make_adam_phase", refuse)
    monkeypatch.setattr(toptim, "lbfgs_over_pytree", refuse)
    lines2 = []
    res2 = tmarch.run_time_marching(
        tproblems.heat_2d(), tiny_spec(testing_size=(41, 41)), 2,
        output_dir=str(out), log_fn=lines2.append, resume=True,
        device="cpu")
    assert sum("resumed from params_stage_1.npz" in ln for ln in lines2) == 2
    with torch.no_grad():
        assert torch.equal(res2.predict(z), u)
    assert res2.rel_l2 == res.rel_l2


def test_wave_1d_two_windows_velocity_handoff(monkeypatch):
    """Second order in t: window 2 is pinned to window 1's terminal value
    and velocity on the plane t = 0.5 (an operator group "u_t"), both
    targets what window 1 says there, and window 1 is untouched by
    window 2's training, whose velocity target is a jvp of it."""
    taken = _snapshots(monkeypatch)
    res = tmarch.run_time_marching(tproblems.wave_1d(),
                                   tiny_spec(adam=80, lbfgs=30), 2,
                                   device="cpu")
    assert np.isfinite(res.rel_l2)
    _unchanged(res, taken)
    w2 = res.windows[1].problem
    value, velocity = w2.bc_groups[-2:]
    assert (value.lo, value.hi) == ((0.0, 0.5), (1.0, 0.5))
    assert value.operator is None and velocity.operator == "u_t"
    assert velocity.value_expr == "<window 1 terminal velocity>"
    assert len(w2.bc_groups) == 4                  # 2 edges + u + u_t
    assert res.windows[0].problem.bc_groups[1].operator == "u_t"
    plane = torch.tensor([[x, 0.5] for x in np.linspace(0, 1, 11)],
                         dtype=torch.float32)
    prev = res.windows[0].predict
    np.testing.assert_array_equal(value.target(plane).numpy(),
                                  prev(plane).detach().numpy())
    v = velocity.target(plane)
    np.testing.assert_array_equal(
        v.numpy(), tmarch.axis_derivative(prev, 1)(plane).detach().numpy())
    assert float(v.abs().max()) > 0.0
    # one loss column per BC group: the handoff groups are in the loss
    assert res.windows[1].history.shape[1] == res.windows[0].history.shape[1]
    assert np.isfinite(res.windows[1].history).all()
