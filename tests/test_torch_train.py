"""The port's loss and training pipeline against tpinn's.

Loss parity: ``tpinn_torch.core.loss.make_loss`` and tpinn's on the same
numpy-seeded parameters and points — the loss, the ``loss_info`` row and
the parameter gradients, for the residual engines ``generic``, ``auto``
and ``kernel`` (tpinn's kernel engine in interpret mode, the port's
through B1/B2's plain versions on the CPU), Neumann BC operators, causal
weighting, a source and a residual weight, and ``deriv_loss``.
Tolerances: loss and loss_info rtol 1e-4 (atol 1e-7), gradients rtol
2e-3, atol 2e-5 (tests/test_kernels.py).

End to end: ``run_training`` on ``poisson_1d`` at the budget and gate of
tests/test_train_e2e.py, and the hard-BC annulus in two stages with
``engine="kernel"``, whose artifacts load in ``tpinn.app.figure_data``
with the keys and shapes of the tpinn run committed in
tests/goldens/artifacts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.core import loss as jloss
from tpinn.core import net as jnet
from tpinn.core import pde as jpde
from tpinn_torch import problems as tproblems
from tpinn_torch.core import loss as tloss
from tpinn_torch.core import net as tnet
from tpinn_torch.core import pde as tpde
from tpinn_torch.core import train as ttrain
from tpinn_torch.utils.convert import params_from_numpy

LAPLACE = "u_rr + 1/r*u_r + 1/r**2*u_tt"
COORDS = ("r", "t")
LB, UB = (0.1, 0.0), (1.0, 2 * np.pi)
HARD = ("(1 - r)/0.9", "(r - 0.1)*(1 - r)")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These nets are tiny: one intra-op thread is as fast as eight alone,
    and many times faster when several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setup(hard=False, seed=0):
    fm_j = jnet.feature_map_for(("minmax", "periodic"))
    spec_j = jnet.MLPSpec(depth=3, width=24, scl=1.5, epsil=0.8)
    p_j = jnet.init_params(jax.random.PRNGKey(seed), spec_j, fm_j)
    pred_j = jnet.make_predictor(spec_j, fm_j, jnp.asarray(LB), jnp.asarray(UB))
    pred_t = tnet.make_predictor(
        tnet.spec_from_dict(jnet.spec_to_dict(spec_j)),
        tnet.feature_map_for(("minmax", "periodic")), torch.tensor(LB),
        torch.tensor(UB))
    if hard:
        pred_j = jnet.wrap_hard_bc(pred_j, *(jpde.compile_coord_expr(e, COORDS)
                                             for e in HARD))
        pred_t = tnet.wrap_hard_bc(pred_t, *(tpde.compile_coord_expr(e, COORDS)
                                             for e in HARD))
    rng = np.random.default_rng(seed + 1)
    z = rng.uniform(LB, UB, (200, 2)).astype(np.float32)
    theta = rng.uniform(0.0, 2 * np.pi, (2, 30)).astype(np.float32)
    x_bd = [np.stack([np.full(30, r, np.float32), th], axis=1)
            for r, th in zip((0.1, 1.0), theta)]
    u_bd = [np.ones((30, 1), np.float32), np.zeros((30, 1), np.float32)]
    data_np = {"x_col": z, "x_bd": x_bd, "u_bd": u_bd}
    data_j = jax.tree_util.tree_map(jnp.asarray, data_np)
    data_t = jax.tree_util.tree_map(torch.from_numpy, data_np)
    return pred_j, pred_t, p_j, params_from_numpy(p_j, "cpu"), data_j, data_t


def _kernel_interpret(monkeypatch):
    """tpinn's kernel engine in interpret mode (tests/test_kernels.py)."""
    import tpinn.kernels.taylor_vjp as tv

    orig = tv.make_kernel_partials
    monkeypatch.setattr(tv, "make_kernel_partials",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


# name: (engine, hard BC, make_loss extras as (jax kwargs, torch kwargs), lw)
def _extras(kind):
    if kind == "neumann":
        return ({"bc_operators": (None, jpde.compile_pde("u_r", COORDS))},
                {"bc_operators": (None, tpde.compile_pde("u_r", COORDS))})
    if kind == "causal":
        c = {"axis": 1, "t0": LB[1], "t1": UB[1], "bins": 8, "eps": 1.0}
        return {"causal": c}, {"causal": c}
    if kind == "source_weight":
        src, w = "sin(t)*r", "1 + r"
        return ({"source_fn": jpde.compile_coord_expr(src, COORDS),
                 "residual_weight_fn": jpde.compile_coord_expr(w, COORDS)},
                {"source_fn": tpde.compile_coord_expr(src, COORDS),
                 "residual_weight_fn": tpde.compile_coord_expr(w, COORDS)})
    if kind == "deriv_loss":
        return {"deriv_loss": True}, {"deriv_loss": True}
    return {}, {}


LOSS_CASES = {
    "generic": ("generic", False, None, (0.05, 0.0)),
    "auto": ("auto", False, None, (0.05, 0.0)),
    "kernel": ("kernel", False, None, (0.05, 0.0)),
    "kernel-hard-bc": ("kernel", True, None, (0.05, 0.0)),
    "auto-hard-bc": ("auto", True, None, (0.05, 0.0)),
    "neumann-bc": ("auto", False, "neumann", (0.05, 0.0)),
    "causal-kernel": ("kernel", False, "causal", (0.05, 0.0)),
    "source-weight-kernel": ("kernel", False, "source_weight", (0.05, 0.0)),
    "deriv-loss-auto": ("auto", False, "deriv_loss", (0.05, 0.1)),
    "deriv-loss-generic": ("generic", False, "deriv_loss", (0.05, 0.1)),
}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_loss_matches_tpinn(name, monkeypatch):
    engine, hard, kind, lw = LOSS_CASES[name]
    pred_j, pred_t, p_j, p_t, data_j, data_t = _setup(hard)
    kw_j, kw_t = _extras(kind)
    if engine == "kernel":
        _kernel_interpret(monkeypatch)
    loss_j = jloss.make_loss(pred_j, jpde.compile_pde(LAPLACE, COORDS),
                             engine=engine, **kw_j)
    loss_t = tloss.make_loss(pred_t, tpde.compile_pde(LAPLACE, COORDS),
                             engine=engine, **kw_t)
    lw_j, lw_t = jnp.asarray(lw, jnp.float32), torch.tensor(lw)
    ref = 2.0
    (l_j, info_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: loss_j(p, data_j, lw_j, jnp.asarray(ref)), has_aux=True))(p_j)
    leaves = [t.requires_grad_(True) for layer in p_t["layers"]
              for t in (layer["w"], layer["b"])]
    l_t, info_t = loss_t(p_t, data_t, lw_t, torch.tensor(ref))
    g_t = torch.autograd.grad(l_t, leaves)
    width = tloss.loss_info_width(2) + (1 if kind == "deriv_loss" else 0)
    assert info_t.shape == (width,) == info_j.shape
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-4)
    np.testing.assert_allclose(info_t.detach().numpy(), np.asarray(info_j),
                               rtol=1e-4, atol=1e-7)
    want = [a for layer in g_j["layers"] for a in (layer["w"], layer["b"])]
    for a, b in zip(g_t, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-5)


def test_loss_refusals_and_helpers():
    pred_j, pred_t, p_j, p_t, data_j, data_t = _setup()
    compiled = tpde.compile_pde("u_rr + u_tt", COORDS)
    with pytest.raises(ValueError, match="deriv_loss"):
        tloss.make_loss(pred_t, compiled, deriv_loss=True, engine="kernel")
    spec = pred_t.tpinn_spec
    composed = tnet.compose_stages(pred_t, spec, pred_t.tpinn_feature_map,
                                   *pred_t.tpinn_bounds)
    with pytest.raises(ValueError, match="plain dense"):
        tloss.make_loss(composed, compiled, engine="kernel")
    assert tloss.kernel_engine_unavailable(composed, False) is not None
    assert tloss.kernel_engine_unavailable(pred_t, False) is None
    # the ring penalty adds weight * ||P^T r(z)||^2 to the loss column only
    ring = {"z": data_t["x_col"][:50], "P": torch.full((50, 2), 0.1),
            "weight": 3.0}
    lw, ref = torch.tensor([0.05, 0.0]), torch.tensor(1.0)
    l0, info0 = tloss.make_loss(pred_t, compiled)(p_t, data_t, lw, ref)
    l1, info1 = tloss.make_loss(pred_t, compiled, ring=ring)(p_t, data_t, lw,
                                                             ref)
    r = compiled.residual_fast(pred_t, p_t, ring["z"])
    extra = 3.0 * float(torch.sum(torch.square(ring["P"].T @ r)))
    assert float(l1 - l0) == pytest.approx(extra, rel=1e-4)
    assert float(info1[0] - info0[0]) == pytest.approx(extra, rel=1e-4)
    np.testing.assert_array_equal(info1[1:].detach().numpy(),
                                  info0[1:].detach().numpy())
    with pytest.raises(ValueError, match="engine"):
        tloss.make_loss(pred_t, compiled, engine="bogus")
    assert tloss.ms_error(torch.zeros((0, 1))).shape == (1,)
    assert float(tloss.ms_error(torch.zeros((0, 1)))[0]) == 0.0
    assert tloss.loss_info_width(2) == 6
    u = torch.tensor([1.0, 2.0, 2.0])
    assert float(tloss.relative_l2(u * 1.1, u)) == pytest.approx(0.1)


# ---------------------------------------------------------------------------
# run_training
# ---------------------------------------------------------------------------


def _quick_spec(adam=400, lbfgs=150):
    """tests/test_train_e2e.py's one-stage spec."""
    from tpinn_torch.core.train import StageSpec, TrainSpec

    return TrainSpec(n_col=256, n_band=64, n_adaptive=64, n_bd=32,
                     testing_size=(64, 64), lw=(1.0, 0.0), grid=41,
                     stages=(StageSpec(depth=2, width=24, scl=1.0, epsil=1.0,
                                       adam_epochs=adam,
                                       lbfgs_epochs=lbfgs),),
                     density_every=100, plateau_every=200, tail_max=50)


def test_poisson_1d_trains_to_low_error(tmp_path):
    spec = dataclasses.replace(_quick_spec(adam=500, lbfgs=300),
                               testing_size=(128,))
    res = ttrain.run_training(tproblems.poisson_1d(), spec,
                              output_dir=str(tmp_path), device="cpu")
    assert res.rel_l2 is not None and res.rel_l2 < 5e-2, res.rel_l2
    assert res.history[-1, 0] < res.history[0, 0] * 1e-2
    assert res.fell_back is False
    # resume: the finished stage reloads, trains nothing, predicts the same
    res2 = ttrain.run_training(tproblems.poisson_1d(), spec,
                               output_dir=str(tmp_path), device="cpu",
                               resume=True)
    assert res2.history.shape[0] == 0
    z = torch.linspace(0.1, 0.9, 17)[:, None]
    np.testing.assert_allclose(res2.predict(z).detach().numpy(),
                               res.predict(z).detach().numpy(), rtol=1e-6)


def _figure_shapes(run_dir):
    from tpinn.app.figure_data import FIGURES, figure_payload

    out = {}
    for name in FIGURES:
        payload = figure_payload(run_dir, name)
        assert payload.get("type") != "missing", (name, payload)
        out[name] = {k: np.shape(v) for k, v in payload.items()}
    return out


def test_annulus_hard_bc_kernel_engine_two_stages(tmp_path):
    """engine='kernel': stage 1 (the hard-BC plain net) through the B1/B2
    Function (plain versions on the CPU), stage 2 (a composed chain) on
    'auto', with tpinn's log line once.  The 11 artifacts load in
    tpinn's figure_data with the keys and shapes of the committed tpinn
    run in tests/goldens/artifacts (same counts, grid and test grid)."""
    from pathlib import Path

    from tpinn_torch.core.train import StageSpec, TrainSpec

    stages = tuple(StageSpec(depth=2, width=16, act_first=act, scl=scl,
                             epsil=eps, adam_epochs=60, lbfgs_epochs=25)
                   for act, scl, eps in (("tanh", 1.0, 1.0),
                                         ("sin", None, None)))
    spec = TrainSpec(n_col=400, n_band=100, n_adaptive=100, n_bd=50,
                     testing_size=(41, 41), grid=41, stages=stages,
                     density_every=1000, plateau_every=1000, tail_max=10,
                     log_every=20, engine="kernel")
    lines = []
    res = ttrain.run_training(
        tproblems.with_hard_bc(tproblems.annulus_laplace()), spec,
        output_dir=str(tmp_path), log_fn=lines.append, device="cpu")
    assert res.rel_l2 is not None and np.isfinite(res.rel_l2)
    fallback = [ln for ln in lines if "engine='kernel' unavailable" in ln]
    assert len(fallback) == 1 and "stage 2" in fallback[0]
    assert sum(ln.startswith("Step: 20 ") for ln in lines) == 2

    golden = Path(__file__).resolve().parent / "goldens" / "artifacts"
    port, ref = _figure_shapes(tmp_path), _figure_shapes(golden)
    assert set(port) == set(ref)
    for name in ref:
        assert set(port[name]) == set(ref[name]), name
        if name.startswith(("loss", "boundary")):
            continue        # one row per step: the budgets differ
        assert port[name] == ref[name], name
    meta = np.load(tmp_path / "params_stage_2.npz")
    assert "__meta__" in meta.files


def test_train_refusals():
    problem = tproblems.poisson_1d()
    base = _quick_spec(adam=1, lbfgs=3)
    for kw, exc in ((dict(cpu_fallback=True), ValueError),
                    (dict(lsq_polish="sweep"), ValueError),
                    (dict(deflation="on"), ValueError),
                    (dict(adam_precision="bf16"), ValueError),
                    (dict(lbfgs_device="tpu"), ValueError),
                    (dict(lbfgs_device="cuda"), ValueError)):
        with pytest.raises(exc):
            ttrain.run_training(problem, dataclasses.replace(base, **kw),
                                device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        ttrain.run_training(problem, base, mesh=object(), device="cpu")
    # lsq_polish='on' cannot serve a masked domain or operator BC groups
    masked = dataclasses.replace(problem, eval_mask=lambda z: z * 0 + 1)
    with pytest.raises(ValueError, match="masked"):
        ttrain.run_training(masked, dataclasses.replace(base, lsq_polish="on"),
                            device="cpu")
    neumann = dataclasses.replace(problem, bc_groups=(
        problem.bc_groups[0],
        dataclasses.replace(problem.bc_groups[1], operator="u_x",
                            value=-float(np.pi))))
    with pytest.raises(ValueError, match="operator"):
        ttrain.run_training(neumann, dataclasses.replace(base, lsq_polish="on"),
                            device="cpu")


@pytest.mark.parametrize("case", ["masked", "operator-bc", "nonlinear"])
def test_polish_and_correction_skip_rules(case):
    """lsq_polish='auto' and deflation skip, with a log line, where the
    solve does not apply (the skip rules of tpinn's run_training)."""
    problem = tproblems.poisson_1d()
    spec = dataclasses.replace(_quick_spec(adam=20, lbfgs=9),
                               testing_size=(64,), lsq_polish="auto",
                               deflation="full")
    if case == "masked":
        problem = dataclasses.replace(problem, eval_mask=lambda z: z * 0 + 1)
        want = ("lsq_polish skipped (masked", "deflation skipped: masked")
    elif case == "operator-bc":
        problem = dataclasses.replace(problem, bc_groups=(
            problem.bc_groups[0],
            dataclasses.replace(problem.bc_groups[1], operator="u_x",
                                value=-float(np.pi))))
        want = ("lsq_polish skipped (operator", "deflation skipped: operator")
    else:
        problem = dataclasses.replace(
            problem, equation="u_xx + u*u - sin(pi*x)**2 + pi**2*sin(pi*x)")
        spec = dataclasses.replace(spec, deflation="auto")
        want = ("lsq_polish skipped (equation nonlinear",)
    lines = []
    res = ttrain.run_training(problem, spec, log_fn=lines.append, device="cpu")
    for text in want:
        assert any(text in ln for ln in lines), (text, lines)
    assert not any("lsq polish objective" in ln for ln in lines)
    assert not any("spectral correction" in ln for ln in lines)
    assert np.isfinite(res.rel_l2)


@pytest.mark.parametrize("name", [None, "highest", "high", "default"])
def test_adam_precision_is_scoped_to_the_adam_phase(name, monkeypatch):
    """The three names (and None) are accepted; torch.matmul may use TF32
    inside the Adam phase only with 'default'; the global setting is what
    it was after run_training returns, and after it raises."""
    from tpinn_torch.core import optim as toptim

    seen = []
    real = toptim.make_adam_phase

    def spy(*a, **k):
        phase = real(*a, **k)

        def wrapped(*args, **kw):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return phase(*args, **kw)
        return wrapped

    monkeypatch.setattr(toptim, "make_adam_phase", spy)
    problem = tproblems.poisson_1d()
    spec = dataclasses.replace(_quick_spec(adam=5, lbfgs=3),
                               testing_size=(32,), adam_precision=name)
    for before in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = before
        try:
            ttrain.run_training(problem, spec, device="cpu")
            assert torch.backends.cuda.matmul.allow_tf32 is before
            assert seen[-1] is (name == "default")

            def boom(*a, **k):
                assert torch.backends.cuda.matmul.allow_tf32 is (
                    name == "default")
                raise RuntimeError("boom")

            monkeypatch.setattr(toptim, "make_adam_phase",
                                lambda *a, **k: boom)
            with pytest.raises(RuntimeError, match="boom"):
                ttrain.run_training(problem, spec, device="cpu")
            assert torch.backends.cuda.matmul.allow_tf32 is before
            monkeypatch.setattr(toptim, "make_adam_phase", spy)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False


def test_train_helpers_match_tpinn():
    from tpinn import problems as jproblems
    from tpinn.core import train as jtrain

    for name, tsize in (("annulus_laplace", (7, 5)), ("poisson_1d", (9,))):
        jp, tp = jproblems.get_problem(name), tproblems.get_problem(name)
        xj, _, _ = jtrain.eval_grid(jp, tsize, jnp.float32)
        xt, axes, _ = ttrain.eval_grid(tp, tsize, torch.float32)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6)
        assert len(axes) == tp.dim
        assert (ttrain.resolve_testing_size(tp, (4, 4, 4))
                == jtrain.resolve_testing_size(jp, (4, 4, 4)))
        gj, gt = jtrain._grid_data(jp, 6, jnp.float32), ttrain._grid_data(
            tp, 6, torch.float32)
        np.testing.assert_allclose(gt["x_col"].numpy(), np.asarray(gj["x_col"]),
                                   rtol=1e-6)
        for a, b in zip(gt["x_bd"] + gt["u_bd"], gj["x_bd"] + gj["u_bd"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    x = np.linspace(-1.0, 2.0, 12, dtype=np.float32)
    assert float(ttrain.rms(torch.from_numpy(x))) == pytest.approx(
        float(jtrain.rms(jnp.asarray(x))), rel=1e-6)
    # the residual of a frozen predictor, less the source
    compiled = tpde.compile_pde("u_xx", ("x",))
    src = tpde.compile_coord_expr("x", ("x",))
    z = torch.linspace(0.0, 1.0, 5)[:, None]
    f = ttrain._residual_with_source(compiled, src, lambda zz: zz ** 3, z)
    np.testing.assert_allclose(f.detach().numpy(), (6 * z - z).numpy(),
                               rtol=1e-6)
