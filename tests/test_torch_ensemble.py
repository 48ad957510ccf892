"""Ensembles: tpinn_torch.core.ensemble and the served ensemble record
against tpinn's, on the CPU.

``_lsq_weights`` is held against tpinn's on the same members (weights
drawn by the JAX package and carried, utils/convert): weights within
1e-8 absolute, the same ``how``.  tpinn's own cases (tests/
test_ensemble.py) run through the port at their sizes, seeds and bars
(poisson_1d hard BC, 2 members, seeds 3 and 4, 2x24, 300 / 200).  An
``ensemble.json`` written by either package is served by the port and by
tpinn's server on the same points: /predict and /uncertainty rtol 1e-5,
atol 1e-6; /residual rtol 1e-3, atol 1e-4 (float32).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn import problems as jproblems
from tpinn.app.serve import PINNServer as JaxServer
from tpinn.core import ensemble as jensemble
from tpinn.core import net as jnet
from tpinn.core import pde as jpde
from tpinn.core.train import StageSpec as JStageSpec
from tpinn.core.train import TrainSpec as JTrainSpec
from tpinn_torch import problems
from tpinn_torch.app.serve import PINNServer
from tpinn_torch.core import net, pde, train
from tpinn_torch.core.ensemble import _lsq_weights, run_ensemble_training
from tpinn_torch.core.train import StageSpec, TrainSpec
from tpinn_torch.utils.convert import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spec(**kw):
    st = StageSpec(depth=2, width=24, scl=1.0, epsil=1.0,
                   adam_epochs=300, lbfgs_epochs=200)
    return TrainSpec(
        n_col=256, n_band=64, n_adaptive=64, n_bd=32,
        testing_size=(128,), lw=(1.0, 0.0), grid=41,
        stages=(st,), density_every=100, plateau_every=200,
        tail_max=50, lsq_polish="auto", **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("ens")
    problem = problems.with_hard_bc(problems.poisson_1d())
    res = run_ensemble_training(
        problem, _spec(deflation="full"), n_members=2, seeds=(3, 4),
        output_dir=str(out), device="cpu")
    return out, res


@pytest.fixture(scope="module")
def tpinn_record(tmp_path_factory):
    """An ensemble record written by tpinn's run_ensemble_training (two
    2x8 members of poisson_1d at a few steps: a layout, not an
    accuracy)."""
    out = tmp_path_factory.mktemp("jens")
    spec = JTrainSpec(n_col=64, n_band=0, n_adaptive=0, n_bd=8,
                      testing_size=(32,), lw=(1.0, 0.0), grid=17,
                      stages=(JStageSpec(depth=2, width=8, adam_epochs=10,
                                         lbfgs_epochs=0),),
                      tail_max=0, log_every=10)
    jensemble.run_ensemble_training(jproblems.poisson_1d(), spec,
                                    n_members=2, output_dir=str(out))
    return out


def _members(seeds, perturb=None):
    """Members u_i = sin(πx) + N_i(x) with plain 2x16 nets N_i, in both
    packages on the same weights: (tpinn's frozen closures, the port's
    (predictor, params) pairs).  On poisson_1d the residual of u_i is
    N_i'' alone, so the members' residuals are independent.
    ``perturb``: the second member is the first with its weights scaled
    by (1 + perturb)."""
    fm_j = jnet.feature_map_for(("minmax",))
    spec_j = jnet.MLPSpec(depth=2, width=16)
    pred_j = jnet.make_predictor(spec_j, fm_j, jnp.asarray([0.0]),
                                 jnp.asarray([1.0]))
    trees = [jax.tree.map(np.asarray, jnet.init_params(
        jax.random.PRNGKey(s), spec_j, fm_j)) for s in seeds]
    if perturb is not None:
        trees[1] = jax.tree.map(
            lambda a: (a * (1.0 + perturb)).astype(np.float32), trees[0])
    net_t = net.make_predictor(net.MLPSpec(depth=2, width=16),
                               net.feature_map_for(("minmax",)),
                               torch.tensor([0.0]), torch.tensor([1.0]))
    pred_t = lambda p, z: torch.sin(np.pi * z) + net_t(p, z)
    frozen = [lambda z, p=jax.tree.map(jnp.asarray, t):
              jnp.sin(jnp.pi * z) + pred_j(p, z) for t in trees]
    pairs = [(pred_t, params_from_numpy(t, "cpu")) for t in trees]
    return frozen, pairs


@pytest.mark.parametrize("case", ["lsq", "uniform-fallback"])
def test_lsq_weights_match_tpinn(case):
    if case == "lsq":
        frozen, pairs = _members((0, 1, 2))
    else:
        frozen, pairs = _members((0, 1), perturb=1e-4)
    jp = jproblems.poisson_1d()
    w_j, how_j = jensemble._lsq_weights(
        frozen, jpde.compile_pde(jp.equation, jp.coords), None, jp)
    tp = problems.poisson_1d()
    w_t, how_t = _lsq_weights(pairs, pde.compile_pde(tp.equation, tp.coords),
                              None, tp)
    assert how_t == how_j == case
    assert w_t.dtype == np.float64 and abs(w_t.sum() - 1.0) < 1e-12
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=1e-8)


def test_ensemble_beats_or_matches_members(trained):
    out, res = trained
    assert len(res.members) == 2
    assert all(r is not None for r in res.rel_l2_members)
    assert res.rel_l2 is not None and np.isfinite(res.rel_l2)
    assert res.rel_l2 <= min(res.rel_l2_members) * 1.5, (
        res.rel_l2, res.rel_l2_members)
    assert abs(float(np.sum(res.weights)) - 1.0) < 1e-9
    assert res.err_correlation is not None
    assert res.err_correlation[0][1] < 0.999999
    assert res.fell_back is False


def test_ensemble_record_and_member_checkpoints(trained):
    out, res = trained
    rec = json.loads((out / "ensemble.json").read_text())
    assert rec["problem"] == "poisson_1d"
    assert len(rec["members"]) == 2
    assert rec["seeds"] == [3, 4]
    assert rec["rel_l2"] == pytest.approx(res.rel_l2)
    for m in rec["members"]:
        assert (out / m).exists(), m
    # member checkpoints carry no correction: it applies once, to the mean
    with np.load(out / rec["members"][0]) as raw:
        meta = json.loads(bytes(raw["__meta__"]).decode())
    assert meta.get("deflation") in (None, {})


def test_ensemble_record_keys_match_tpinn(trained, tpinn_record):
    ours = json.loads((trained[0] / "ensemble.json").read_text())
    theirs = json.loads((tpinn_record / "ensemble.json").read_text())
    assert sorted(ours) == sorted(theirs)


def test_ensemble_predict_callable(trained):
    out, res = trained
    z = torch.linspace(0.05, 0.95, 33)[:, None]
    u = res.predict(z).detach().numpy()
    assert u.shape == (33, 1)
    exact = problems.poisson_1d().exact(z).numpy()
    rel = np.linalg.norm(u - exact) / np.linalg.norm(exact)
    assert rel < 5e-2, rel


def test_serving_loads_ensemble_record(trained):
    out, res = trained
    srv = PINNServer(str(out), "poisson_1d", device="cpu")
    pts = [[0.3], [0.62]]
    u = srv.predict(pts)
    want = res.predict(torch.tensor(pts))[:, 0].detach().numpy()
    np.testing.assert_allclose(np.asarray(u), want, rtol=0, atol=1e-5)
    assert np.all(np.isfinite(srv.residual(pts)))
    # epistemic UQ: the member spread is positive and small beside u
    std = np.asarray(srv.uncertainty(pts))
    assert std.shape == (2,) and np.all(std >= 0)
    assert np.all(std < 0.2 * (np.abs(want) + 1e-3))


def test_uncertainty_requires_ensemble(tmp_path):
    spec = train.TrainSpec(
        n_col=128, n_band=0, n_adaptive=0, n_bd=8, testing_size=(64,),
        lw=(1.0, 0.0), grid=32,
        stages=(train.StageSpec(depth=2, width=8, adam_epochs=30,
                                lbfgs_epochs=0),),
        log_every=30)
    train.run_training(problems.poisson_1d(), spec,
                       output_dir=str(tmp_path), device="cpu")
    srv = PINNServer(str(tmp_path / "params_stage_1.npz"), "poisson_1d",
                     device="cpu")
    with pytest.raises(ValueError, match="ensemble"):
        srv.uncertainty([[0.5]])


def test_ensemble_seed_mismatch_raises():
    with pytest.raises(ValueError, match="seeds"):
        run_ensemble_training(problems.poisson_1d(), _spec(), n_members=3,
                              seeds=(1, 2), device="cpu")


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_ensemble_training(problems.poisson_1d(), _spec(), n_members=2,
                              device="cuda")


@pytest.mark.parametrize("writer", ["tpinn_torch", "tpinn"])
def test_record_served_by_both_packages(writer, trained, tpinn_record):
    """The same record, served by the port and by tpinn's server: /predict,
    /uncertainty and /residual on the same points (the record's file or
    its directory)."""
    out = trained[0] if writer == "tpinn_torch" else tpinn_record
    ours = PINNServer(str(out / "ensemble.json"), "poisson_1d", device="cpu")
    theirs = JaxServer(str(out), "poisson_1d")
    pts = np.linspace(0.02, 0.98, 37)[:, None].tolist()
    for route in ("predict", "uncertainty"):
        np.testing.assert_allclose(getattr(ours, route)(pts),
                                   getattr(theirs, route)(pts),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.residual(pts), theirs.residual(pts),
                               rtol=1e-3, atol=1e-4)
    rec = json.loads((out / "ensemble.json").read_text())
    assert ours.deflation == (rec["deflation"] or None)
    assert len(ours.params) == len(rec["members"])


def test_ensemble_serving_needs_problem(trained):
    with pytest.raises(ValueError, match="--problem"):
        PINNServer(str(trained[0]), device="cpu")


def test_members_use_the_spec_seed_streams(tmp_path):
    """Default seeds are spec.seed + 1000·i; one member trains exactly as
    run_training does at that seed, and K = 1 takes uniform weights."""
    spec = dataclasses.replace(
        _spec(), n_col=64, n_band=0, n_adaptive=16, n_bd=8, grid=17,
        seed=11, stages=(StageSpec(depth=2, width=8, adam_epochs=20,
                                   lbfgs_epochs=0),), tail_max=0)
    lines = []
    res = run_ensemble_training(problems.poisson_1d(), spec, n_members=1,
                                output_dir=str(tmp_path), log_fn=lines.append,
                                device="cpu")
    solo = train.run_training(problems.poisson_1d(), spec, device="cpu")
    np.testing.assert_array_equal(res.members[0].history, solo.history)
    assert res.weights.tolist() == [1.0]
    assert any("ensemble weights (uniform)" in ln for ln in lines)
    rec = json.loads((tmp_path / "ensemble.json").read_text())
    assert rec["seeds"] == [11] and rec["weights_how"] == "uniform"
