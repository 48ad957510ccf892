"""The port's optimizers (tpinn_torch.core.optim) against tpinn's.

The Adam phase runs the same losses as tests/test_optim.py with
``sample_fn=None`` (point draws would compare RNG bits, not the
automaton) in both packages: histories, plateau-halved learning rates,
``lr_min``, the tail (also to its last step) and ``epochs=0``, and the
flat layout against the tree layout, through the phase's ``FusedAdam``
launchers (one per vector, stepped once per Adam step).  Tolerances:
rtol 1e-5, atol 1e-6 on histories and parameters (float32 Adam
trajectories of a few hundred steps that round differently in XLA and in
torch).  L-BFGS is held against scipy on
Rosenbrock and against tpinn on a quadratic, with both history cadences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from tpinn.core import optim as jopt
from tpinn_torch.core import optim as topt

RTOL, ATOL = 1e-5, 1e-6
F33 = np.ones((3, 3), np.float32)


def _run_both(loss_j, loss_t, params_np, data_np, cfg_kw, density=None,
              log=False):
    """The same Adam phase in both packages; returns (jax result, torch
    result, jax log rows, torch log rows)."""
    rows_j, rows_t = [], []
    phase_j = jopt.make_adam_phase(
        loss_j, None, (lambda p: jnp.full((3, 3), density)) if density
        else None, jopt.AdamConfig(**cfg_kw), info_width=3,
        log_fn=(lambda s, r: rows_j.append((int(s), float(r[0])))) if log
        else None)
    phase_t = topt.make_adam_phase(
        loss_t, None, (lambda p: torch.full((3, 3), density)) if density
        else None, topt.AdamConfig(**cfg_kw), info_width=3,
        log_fn=(lambda s, r: rows_t.append((int(s), float(r[0])))) if log
        else None)
    pj = jax.tree_util.tree_map(jnp.asarray, params_np)
    pt = jax.tree_util.tree_map(torch.from_numpy, params_np)
    dj = jax.tree_util.tree_map(jnp.asarray, data_np)
    dt = jax.tree_util.tree_map(torch.from_numpy, data_np)
    rj = phase_j(jax.random.PRNGKey(0), pj, dj, jnp.asarray(F33),
                 jnp.array([1.0]), jnp.array(1.0))
    rt = phase_t(torch.Generator().manual_seed(0), pt, dt,
                 torch.from_numpy(F33), torch.tensor([1.0]), torch.tensor(1.0))
    jax.block_until_ready(rj.params)
    return rj, rt, rows_j, rows_t


def _assert_same(rj, rt):
    n = int(rj.n_valid)
    assert rt.n_valid == n
    np.testing.assert_allclose(rt.history[:n].numpy(),
                               np.asarray(rj.history)[:n], rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(jax.tree_util.tree_leaves(rj.params),
                    topt.tree_leaves(rt.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(rt.lr.numpy(), np.asarray(rj.lr).reshape(-1),
                               rtol=1e-6)


def _quad_j(params, data, lw, ref):
    loss = jnp.sum((params["w"] - data["target"]) ** 2)
    return loss / ref, jnp.stack([loss, loss, lw[0] * loss])


def _quad_t(params, data, lw, ref):
    loss = torch.sum((params["w"] - data["target"]) ** 2)
    return loss / ref, torch.stack([loss, loss, lw[0] * loss])


QUAD_DATA = {"target": np.full(2, 5.0, np.float32)}
QUAD_PARAMS = {"w": np.zeros(2, np.float32)}


def test_adam_phase_matches_tpinn_with_tail_and_log():
    cfg = dict(epochs=200, lr=0.05, resample_every=10, density_every=20,
               plateau_every=40, tail_max=50, log_every=10)
    rj, rt, rows_j, rows_t = _run_both(_quad_j, _quad_t, QUAD_PARAMS,
                                       QUAD_DATA, cfg, density=2.0, log=True)
    _assert_same(rj, rt)
    assert rt.n_valid >= 200
    assert rt.history[0, 0] == pytest.approx(50.0, rel=1e-3)
    np.testing.assert_allclose(rt.density.numpy(), 2.0)
    # the log replay: every 10th step, from the history on the host
    assert [s for s, _ in rows_t] == [s for s, _ in rows_j]
    assert [s for s, _ in rows_t][:9] == [10, 20, 30, 40, 50, 60, 70, 80, 90]
    np.testing.assert_allclose([v for _, v in rows_t],
                               [v for _, v in rows_j], rtol=RTOL, atol=ATOL)


def _l1_j(params, data, lw, ref):
    loss = jnp.sum(jnp.abs(params["w"] - data["target"]))
    return loss / ref, jnp.stack([loss, loss, loss])


def _l1_t(params, data, lw, ref):
    loss = torch.sum(torch.abs(params["w"] - data["target"]))
    return loss / ref, torch.stack([loss, loss, loss])


@pytest.mark.parametrize("lr_min", [0.0, 0.02])
def test_adam_plateau_halving_and_floor_match_tpinn(lr_min):
    """On an L1 loss Adam's steps keep their size and circle the minimum:
    the two halves of each 40-step window have close means, so the plateau
    rule halves the rate (floored at lr_min); the moments are kept."""
    cfg = dict(epochs=120, lr=0.05, resample_every=1000, density_every=1000,
               plateau_every=40, tail_max=0, lr_min=lr_min)
    data = {"target": np.full(2, 0.31, np.float32)}
    rj, rt, _, _ = _run_both(_l1_j, _l1_t, QUAD_PARAMS, data, cfg)
    _assert_same(rj, rt)
    assert float(rt.lr) == pytest.approx(max(0.05 / 4, lr_min))


def test_adam_flat_loss_keeps_lr_like_tpinn():
    """A flat loss: 0/0 in the plateau test is NaN, and NaN < ratio is
    False, so the rate stays (tests/test_optim.py)."""
    def flat_j(params, data, lw, ref):
        loss = 0.0 * jnp.sum(params["w"]) + 1.0
        return loss / ref, jnp.stack([loss, loss, loss])

    def flat_t(params, data, lw, ref):
        loss = 0.0 * torch.sum(params["w"]) + 1.0
        return loss / ref, torch.stack([loss, loss, loss])

    cfg = dict(epochs=80, lr=0.1, plateau_every=40, tail_max=0)
    rj, rt, _, _ = _run_both(flat_j, flat_t, QUAD_PARAMS, QUAD_DATA, cfg)
    _assert_same(rj, rt)
    assert float(rt.lr) == pytest.approx(0.1)


def test_adam_zero_epochs_matches_tpinn():
    cfg = dict(epochs=0, lr=0.05, tail_max=50)
    params = {"w": np.ones(2, np.float32)}
    rj, rt, _, _ = _run_both(_quad_j, _quad_t, params, QUAD_DATA, cfg)
    assert rt.n_valid == int(rj.n_valid) == 0
    assert rt.history.shape[0] == 0
    np.testing.assert_allclose(rt.params["w"].numpy(), 1.0)


def _mlp_j(params, data, lw, ref):
    pred = jnp.tanh(data["x"] @ params["l1"]["w"] + params["l1"]["b"])
    pred = pred @ params["l2"]["w"] + params["l2"]["b"]
    loss = jnp.mean((pred - data["y"]) ** 2)
    return loss / ref, jnp.stack([loss, loss, lw[0] * loss])


def _mlp_t(params, data, lw, ref):
    pred = torch.tanh(data["x"] @ params["l1"]["w"] + params["l1"]["b"])
    pred = pred @ params["l2"]["w"] + params["l2"]["b"]
    loss = torch.mean((pred - data["y"]) ** 2)
    return loss / ref, torch.stack([loss, loss, lw[0] * loss])


def _mlp_inputs():
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(32, 3)).astype(np.float32)
    params = {"l1": {"w": (rng.standard_normal((3, 8)) * 0.5).astype(
                         np.float32), "b": np.zeros(8, np.float32)},
              "l2": {"w": (rng.standard_normal((8, 1)) * 0.5).astype(
                         np.float32), "b": np.zeros(1, np.float32)}}
    data = {"x": x, "y": np.sin(x.sum(axis=1, keepdims=True))}
    return params, data


@pytest.fixture
def launchers(monkeypatch):
    """Records every FusedAdam the Adam phase builds; the one-call
    adam_update_flat must not be reached."""
    built = []

    class Recorded(topt.adam_kernel.FusedAdam):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    def refused(*args, **kwargs):
        raise AssertionError("the Adam phase called adam_update_flat")

    monkeypatch.setattr(topt.adam_kernel, "FusedAdam", Recorded)
    monkeypatch.setattr(topt.adam_kernel, "adam_update_flat", refused)
    return built


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_adam_layouts_match_tpinn_flat(layout, launchers):
    """Both layouts of the port against tpinn's flat layout on a 4-leaf
    pytree (Adam is elementwise: one vector or one update per leaf is the
    same math), each through the phase's launchers: one for the flat
    vector, one per leaf for the tree, each built for epochs + tail_max
    steps and stepped once per Adam step."""
    params, data = _mlp_inputs()
    cfg = dict(epochs=120, lr=0.02, resample_every=15, plateau_every=40,
               tail_max=30, log_every=10)
    rj, _, _, _ = _run_both(_mlp_j, _mlp_t, params, data, cfg)
    launchers.clear()
    _, rt, _, _ = _run_both(_mlp_j, _mlp_t, params, data,
                            dict(cfg, layout=layout))
    _assert_same(rj, rt)
    assert set(rt.params) == {"l1", "l2"}
    assert rt.params["l1"]["w"].shape == (3, 8)
    sizes = sorted(int(x.p.numel()) for x in launchers)
    assert sizes == ([3 * 8 + 8 + 8 + 1] if layout == "flat"
                     else [1, 8, 8, 24])
    for x in launchers:
        assert x._end == 1 + 120 + 30 and x.t == 1 + rt.n_valid


def _still_j(params, data, lw, ref):
    loss = jnp.sum((params["w"] - data["target"]) ** 2)
    one = jnp.ones(())
    return loss / ref, jnp.stack([one, one, one])


def _still_t(params, data, lw, ref):
    loss = torch.sum((params["w"] - data["target"]) ** 2)
    one = torch.ones(())
    return loss / ref, torch.stack([one, one, one])


def test_adam_tail_to_the_launchers_last_step(launchers):
    """A loss row that never beats the final window's minimum: the tail
    takes all tail_max steps, so the launcher runs to the last row of its
    bias table, against tpinn's phase."""
    cfg = dict(epochs=60, lr=0.05, plateau_every=0, tail_max=25)
    rj, rt, _, _ = _run_both(_still_j, _still_t, QUAD_PARAMS, QUAD_DATA, cfg)
    _assert_same(rj, rt)
    assert rt.n_valid == 85
    (launcher,) = launchers
    assert launcher.t == launcher._end == 86
    with pytest.raises(ValueError, match="past the last step"):
        launcher.step(torch.zeros(2))


def test_adam_refusals():
    with pytest.raises(ValueError, match="layout"):
        topt.AdamConfig(epochs=1, layout="bogus")
    phase = topt.make_adam_phase(_quad_t, None, None,
                                 topt.AdamConfig(epochs=1), info_width=3)
    args = (torch.Generator(), {"w": torch.zeros(2)},
            {"target": torch.ones(2)}, torch.ones(3, 3), torch.ones(1),
            torch.tensor(1.0))
    # a state saved at a step this phase does not have
    state0 = phase.make_state0(args[0], args[1], args[2], args[3], args[5])
    with pytest.raises(ValueError, match="outside"):
        phase(*args, init=(2, state0, torch.zeros(2, 3)))
    # the checkpoint hook: once, at the end of the one-step loop (not in
    # the tail), with the state after that step
    seen = []
    phase(*args, ckpt_cb=lambda done, state, hist: seen.append(
        (done, state["p"][0].clone(), hist.shape)))
    assert [(d, h) for d, _, h in seen] == [(1, (1, 3))]
    np.testing.assert_allclose(seen[0][1].numpy(), 1e-3, rtol=1e-5)


# ---------------------------------------------------------------------------
# L-BFGS
# ---------------------------------------------------------------------------


def _vg_t(f):
    def vg(x):
        x = x.detach().requires_grad_(True)
        val = f(x)
        (g,) = torch.autograd.grad(val, x)
        return val.detach(), g, torch.stack([val, val, val]).detach()
    return vg


def _vg_j(f):
    def vg(x):
        val, g = jax.value_and_grad(f)(x)
        return val, g, jnp.stack([val, val, val])
    return vg


def _rosen(x):
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()


def test_lbfgs_rosenbrock_matches_scipy():
    x0 = np.array([-1.2, 1.0, -0.5, 0.8])
    res = topt.lbfgs_minimize(_vg_t(_rosen), torch.tensor(x0),
                              topt.LBFGSConfig(max_iters=300, tolerance=1e-6))
    ref = scipy.optimize.minimize(
        lambda x: float(_rosen(torch.tensor(x))), x0, method="L-BFGS-B",
        jac=lambda x: _vg_t(_rosen)(torch.tensor(x))[1].numpy())
    np.testing.assert_allclose(res.x.numpy(), np.ones(4), atol=1e-4)
    np.testing.assert_allclose(res.x.numpy(), ref.x, atol=2e-3)
    assert float(res.f) <= ref.fun + 1e-8
    assert res.converged and not res.failed


@pytest.mark.parametrize("history", ["iters", "evals"])
def test_lbfgs_quadratic_matches_tpinn(history):
    A = np.array([[3.0, 0.5, 0.0], [0.5, 1.0, 0.2], [0.0, 0.2, 2.0]])
    b = np.array([1.0, -2.0, 0.5])
    kw = dict(max_iters=50, tolerance=1e-5, history=history)
    cfg_t, cfg_j = topt.LBFGSConfig(**kw), jopt.LBFGSConfig(**kw)
    assert cfg_t.history_rows == cfg_j.history_rows
    At, bt = torch.tensor(A, dtype=torch.float32), torch.tensor(
        b, dtype=torch.float32)
    Aj, bj = jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32)
    res_t = topt.lbfgs_minimize(
        _vg_t(lambda x: 0.5 * x @ At @ x - bt @ x), torch.zeros(3), cfg_t)
    res_j = jopt.lbfgs_minimize(
        _vg_j(lambda x: 0.5 * x @ Aj @ x - bj @ x), jnp.zeros(3), cfg_j)
    np.testing.assert_allclose(res_t.x.numpy(), np.linalg.solve(A, b),
                               atol=1e-4)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=1e-5, atol=1e-6)
    assert res_t.n_iters == int(res_j.n_iters)
    assert res_t.n_rows == int(res_j.n_rows)
    n = res_t.n_rows
    np.testing.assert_allclose(res_t.history[:n].numpy(),
                               np.asarray(res_j.history)[:n], rtol=1e-5,
                               atol=1e-6)
    assert res_t.converged == bool(res_j.converged)


def test_lbfgs_history_cadences():
    """"evals" records every function evaluation, "iters" every accepted
    iterate; the trajectory is the same."""
    x0 = torch.tensor([-1.2, 1.0])
    res_i = topt.lbfgs_minimize(_vg_t(_rosen), x0,
                                topt.LBFGSConfig(max_iters=100, tolerance=1e-4))
    res_e = topt.lbfgs_minimize(
        _vg_t(_rosen), x0,
        topt.LBFGSConfig(max_iters=100, tolerance=1e-4, history="evals"))
    assert torch.equal(res_i.x, res_e.x)
    assert res_i.n_iters == res_e.n_iters
    assert res_i.n_rows == res_i.n_iters + 1
    assert res_e.n_rows > res_e.n_iters
    assert torch.isfinite(res_e.history[:res_e.n_rows]).all()
    assert float(res_e.history[0, 0]) == pytest.approx(float(_rosen(x0)))
    with pytest.raises(ValueError, match="history"):
        topt.LBFGSConfig(max_iters=1, history="bogus")


def test_lbfgs_over_pytree():
    params = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor(0.5)}

    def loss_fn(p, data, lw, ref):
        loss = torch.sum((p["a"] - 3.0) ** 2) + (p["b"] + 1.0) ** 2
        return loss / ref, torch.stack([loss, loss, loss])

    out, hist, n = topt.lbfgs_over_pytree(
        loss_fn, params, None, torch.tensor([1.0]), torch.tensor(1.0),
        topt.LBFGSConfig(max_iters=50, tolerance=1e-5))
    np.testing.assert_allclose(out["a"].numpy(), 3.0, atol=1e-4)
    np.testing.assert_allclose(out["b"].numpy(), -1.0, atol=1e-4)
    assert out["b"].shape == () and not out["a"].requires_grad
    assert float(hist[0, 0]) == pytest.approx(5.0 + 2.25)
    assert float(hist[n - 1, 0]) < 1e-8
