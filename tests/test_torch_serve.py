"""The serving slice: tpinn_torch.app.serve against tpinn.app.serve.

Checkpoints are written by the JAX package (or by the port) in the format
run_training writes; both servers load the same file and answer the same
points.  Tolerances (f32 on the CPU): /predict rtol 1e-4, atol 1e-5;
/residual rtol 1e-3, atol 1e-4 (the JAX server takes its partials from
the generic jvp engine, the port from the Taylor-2 recurrence, and 1/r²
multiplies u_tt by 100 at r = 0.1).
"""

import json
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpinn.core import net as jnet
from tpinn.utils import checkpoint as jckpt
from tpinn_torch import problems as tproblems
from tpinn_torch.app import serve as tserve
from tpinn_torch.core import net as tnet
from tpinn_torch.utils import checkpoint as tckpt
from tpinn_torch.utils.convert import params_from_numpy, params_to_numpy

REPO = Path(__file__).resolve().parent.parent
TWO_PI = 2.0 * np.pi
HARD = ["(1 - r)/0.9", "(r - 0.1)*(1 - r)"]
KINDS = ["minmax", "periodic"]


def _meta(chain, hard_bc=None, pad=0, **extra):
    return {"stage": len(chain), "scl": chain[-1].scl,
            "epsil": chain[-1].epsil, "problem": "annulus_laplace",
            "chain": [jnet.spec_to_dict(s) for s in chain],
            "feature_kinds": KINDS, "lb": [0.1, 0.0], "ub": [1.0, TWO_PI],
            "hard_bc": hard_bc, "coords": ["r", "t"], "pad_features": pad,
            "deflation": None, **extra}


def _jax_checkpoint(tmp_path, kind):
    """Write one of the served checkpoint layouts with the JAX package."""
    fm = jnet.feature_map_for(KINDS)
    s1 = jnet.MLPSpec(depth=2, width=16)
    p1 = jnet.init_params(jax.random.PRNGKey(0), s1, fm)
    path = tmp_path / f"{kind}.npz"
    if kind == "legacy":
        jckpt.save_pytree(path, p1, meta={"stage": 1, "scl": 1.0, "epsil": 1.0,
                                          "problem": "annulus_laplace"})
    elif kind == "plain":
        jckpt.save_pytree(path, p1, meta=_meta([s1]))
    elif kind == "hard_bc":
        fm3 = jnet.feature_map_for(KINDS, pad_to=4)
        s = jnet.MLPSpec(depth=3, width=20)
        p = jnet.init_params(jax.random.PRNGKey(3), s, fm3)
        jckpt.save_pytree(path, p, meta=_meta([s], HARD, pad=4))
    elif kind == "chain_hard_bc":
        s2 = jnet.MLPSpec(depth=2, width=12, act_first="sin", scl=7.0,
                          epsil=0.03)
        p2 = jnet.init_params(jax.random.PRNGKey(1), s2, fm)
        jckpt.save_pytree(path, jnet.compose_params(p2, p1),
                          meta=_meta([s1, s2], HARD))
    return path


def _points(n=150, seed=5):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.1, 1.0, n), rng.uniform(0.0, TWO_PI, n)],
                    axis=1).astype(np.float32)


@pytest.mark.parametrize("kind", ["legacy", "plain", "hard_bc",
                                  "chain_hard_bc"])
def test_server_matches_jax_server(tmp_path, kind):
    from tpinn.app.serve import PINNServer as JaxServer

    path = _jax_checkpoint(tmp_path, kind)
    jsrv = JaxServer(str(path), "annulus_laplace")
    tsrv = tserve.PINNServer(str(path), "annulus_laplace", device="cpu")
    pts = _points().tolist()
    np.testing.assert_allclose(tsrv.predict(pts), jsrv.predict(pts),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tsrv.residual(pts), jsrv.residual(pts),
                               rtol=1e-3, atol=1e-4)
    # tier padding: one point and a non-power-of-two batch
    np.testing.assert_allclose(tsrv.predict(pts[:1]), jsrv.predict(pts[:1]),
                               rtol=1e-4, atol=1e-5)
    if kind in ("hard_bc", "chain_hard_bc"):
        u = tsrv.predict([[0.1, 0.5], [1.0, 2.5]])
        assert abs(u[0] - 1.0) < 1e-6 and abs(u[1]) < 1e-6
    with pytest.raises(ValueError):
        tsrv.predict([[0.5]])


def test_checkpoints_load_across_packages(tmp_path):
    path = _jax_checkpoint(tmp_path, "chain_hard_bc")
    meta = json.loads(bytes(np.load(path)["__meta__"]).decode())
    fm = tnet.feature_map_for(KINDS)
    gen = torch.Generator().manual_seed(0)
    specs = [tnet.spec_from_dict(d) for d in meta["chain"]]
    like = tnet.compose_params(tnet.init_params(gen, specs[1], fm, "cpu"),
                               tnet.init_params(gen, specs[0], fm, "cpu"))
    params, meta2 = tckpt.load_pytree(path, like)
    assert meta2 == meta and meta["hard_bc"] == HARD
    raw = np.load(path)
    for key in raw.files:
        if key.startswith("leaf:"):
            node = params
            for part in key[5:].split("/"):
                node = node[int(part)] if part.isdigit() else node[part]
            np.testing.assert_array_equal(node.numpy(), raw[key])

    # port → JAX: same keys, same arrays, same meta
    out = tmp_path / "port.npz"
    tckpt.save_pytree(out, params, meta)
    jfm = jnet.feature_map_for(KINDS)
    jlike = jnet.compose_params(
        jnet.init_params(jax.random.PRNGKey(9), jnet.spec_from_dict(meta["chain"][1]), jfm),
        jnet.init_params(jax.random.PRNGKey(9), jnet.spec_from_dict(meta["chain"][0]), jfm))
    jparams, jmeta = jckpt.load_pytree(out, jlike)
    assert jmeta == meta
    assert sorted(np.load(out).files) == sorted(raw.files)
    back = params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(params_from_numpy(back, "cpu"))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    bad = tnet.init_params(gen, tnet.MLPSpec(depth=2, width=8), fm, "cpu")
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_pytree(_jax_checkpoint(tmp_path, "plain"), bad)


def test_server_http_roundtrip(tmp_path):
    path = _jax_checkpoint(tmp_path, "hard_bc")
    srv = tserve.PINNServer(str(path), "annulus_laplace", device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(srv))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(route, body):
        req = urllib.request.Request(base + route, data=json.dumps(body).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            h = json.loads(r.read())
        assert h["ok"] and h["problem"] == "annulus_laplace"
        pts = _points(5).tolist()
        assert post("/predict", {"points": pts})["u"] == srv.predict(pts)
        assert post("/residual", {"points": pts})["f"] == srv.residual(pts)
        with pytest.raises(urllib.error.HTTPError) as e:
            post("/predict", {"points": [[0.5]]})
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
    assert not th.is_alive()


def test_cuda_without_card_raises(tmp_path, monkeypatch):
    path = _jax_checkpoint(tmp_path, "plain")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.PINNServer(str(path), "annulus_laplace", device="cuda")


GALERKIN = {"kind": "galerkin", "lb": [0.1, 0.0], "ub": [1.0, TWO_PI],
            "modes": [[["sin", 1], ["one", 0]], [["sin", 2], ["pcos", 1]],
                      [["sin", 3], ["psin", 2]]],
            "coeffs": [3.1e-3, -1.7e-3, 0.9e-3], "linearized": False}


@pytest.mark.parametrize("what", ["deflation"])
def test_unported_checkpoints_refused(tmp_path, what):
    """No checkpoint kind is refused now: a deflation-corrected one is
    served with the correction in ``deflation`` (march records are
    served: test_march_record_served_by_both_packages; system checkpoints:
    test_torch_system_train.py; scalar inverse checkpoints:
    test_torch_inverse.py; ensemble records: test_torch_ensemble.py;
    patch checkpoints: test_torch_patch.py)."""
    fm = jnet.feature_map_for(KINDS)
    s = jnet.MLPSpec(depth=2, width=8)
    p = jnet.init_params(jax.random.PRNGKey(0), s, fm)
    path = tmp_path / "params_stage_1.npz"
    meta = _meta([s])
    meta.update({"deflation": GALERKIN})
    jckpt.save_pytree(path, p, meta=meta)
    srv = tserve.PINNServer(str(path), "annulus_laplace", device="cpu")
    assert srv.deflation == GALERKIN


@pytest.mark.parametrize("writer", ["tpinn", "tpinn_torch"])
@pytest.mark.parametrize("kind", ["galerkin", "modal", "parabolic"])
def test_deflation_checkpoint_served_by_both_packages(tmp_path, writer, kind):
    """A checkpoint whose meta carries a correction, written by either
    package, is served by both with the same /predict (1e-6 in float32)
    and /residual, and the port's answer is the net's minus the term."""
    from tpinn.app.serve import PINNServer as JaxServer
    from tpinn_torch.core import polish as tpolish

    defl = dict(GALERKIN)
    if kind == "modal":
        defl = {"kind": "modal", "lb": [0.1, 0.0], "ub": [1.0, TWO_PI],
                "modes": [[1, 2], [3, 1]], "coeffs": [2e-3, -1e-3],
                "eps": [-5.0, -7.0]}
    elif kind == "parabolic":
        grid = np.linspace(0.0, TWO_PI, 9)
        defl = {"kind": "parabolic", "lb": [0.1, 0.0], "ub": [1.0, TWO_PI],
                "modes": [[1], [2]], "tau": 1, "spatial": [0],
                "tau_grid": grid.tolist(),
                "series": [(1e-3 * grid).tolist(),
                           (2e-3 * np.sin(grid)).tolist()],
                "rhs": [[0.0] * 9, [0.0] * 9]}
    fm = jnet.feature_map_for(KINDS)
    s = jnet.MLPSpec(depth=2, width=12)
    p = jnet.init_params(jax.random.PRNGKey(4), s, fm)
    meta = _meta([s], HARD, deflation=defl)
    path = tmp_path / "corrected.npz"
    bare = tmp_path / "bare.npz"
    if writer == "tpinn":
        jckpt.save_pytree(path, p, meta=meta)
    else:
        tckpt.save_pytree(path, params_from_numpy(p, "cpu"), meta)
    jckpt.save_pytree(bare, p, meta=_meta([s], HARD))
    jsrv = JaxServer(str(path), "annulus_laplace")
    tsrv = tserve.PINNServer(str(path), "annulus_laplace", device="cpu")
    uncorrected = tserve.PINNServer(str(bare), "annulus_laplace", device="cpu")
    assert tsrv.deflation == defl and uncorrected.deflation is None
    pts = _points(120)
    u_t, u_j = tsrv.predict(pts.tolist()), jsrv.predict(pts.tolist())
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=1e-6)
    term = tpolish.deflation_term(defl)(torch.from_numpy(pts))[:, 0].numpy()
    assert np.abs(term).max() > 1e-4
    np.testing.assert_allclose(
        np.asarray(uncorrected.predict(pts.tolist())) - np.asarray(u_t), term,
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(tsrv.residual(pts.tolist()),
                               jsrv.residual(pts.tolist()), rtol=1e-3,
                               atol=1e-4)


def test_server_computes_a_correction_at_load(tmp_path):
    """deflate='full' on a checkpoint trained without a correction runs
    the trainer's dispatcher at load, as tpinn's server does: on the
    hard-BC poisson_1d net the diagonal full-band family."""
    from tpinn.app.serve import PINNServer as JaxServer

    fm = jnet.feature_map_for(["minmax"])
    s = jnet.MLPSpec(depth=2, width=12, epsil=0.05)
    p = jnet.init_params(jax.random.PRNGKey(2), s, fm)
    path = tmp_path / "p1d.npz"
    jckpt.save_pytree(path, p, meta={
        "stage": 1, "scl": 1.0, "epsil": 0.05, "problem": "poisson_1d",
        "chain": [jnet.spec_to_dict(s)], "feature_kinds": ["minmax"],
        "lb": [0.0], "ub": [1.0], "hard_bc": ["0", "x*(1 - x)"],
        "coords": ["x"], "pad_features": 0, "deflation": None})
    jsrv = JaxServer(str(path), "poisson_1d", deflate="full")
    tsrv = tserve.PINNServer(str(path), "poisson_1d", deflate="full",
                             device="cpu")
    off = tserve.PINNServer(str(path), "poisson_1d", device="cpu")
    assert off.deflation is None
    assert tsrv.deflation["kind"] == "modal" and tsrv.deflation["modes"]
    pts = np.linspace(0.02, 0.98, 41, dtype=np.float32)[:, None].tolist()
    u = np.asarray(tsrv.predict(pts))
    np.testing.assert_allclose(u, jsrv.predict(pts), rtol=1e-4, atol=1e-5)
    assert np.abs(u - np.asarray(off.predict(pts))).max() > 1e-4
    # the correction is the defect's: the corrected net solves the equation
    assert (np.abs(u - np.sin(np.pi * np.asarray(pts)[:, 0])).max()
            < 1e-2 * np.abs(np.asarray(off.predict(pts))
                            - np.sin(np.pi * np.asarray(pts)[:, 0])).max())


def _heat_window_meta(spec, lb, ub, name):
    """The meta run_training writes for a soft-BC heat_2d window."""
    return {"stage": 1, "scl": 1.0, "epsil": 1.0, "problem": name,
            "chain": [jnet.spec_to_dict(spec)],
            "feature_kinds": ["minmax", "minmax"], "lb": list(lb),
            "ub": list(ub), "hard_bc": None, "coords": ["x", "t"],
            "pad_features": 3, "deflation": None}


def _tpinn_march_record(tmp_path):
    """Three heat_2d window checkpoints saved by tpinn from initial
    parameters, and a hand-written march.json over them."""
    edges = [0.0, 0.25, 0.6, 1.0]
    fm = jnet.feature_map_for(["minmax", "minmax"], pad_to=3)
    windows = []
    for k in range(3):
        s = jnet.MLPSpec(depth=2, width=12)
        p = jnet.init_params(jax.random.PRNGKey(20 + k), s, fm)
        rel = f"window_{k + 1}/params_stage_1.npz"
        (tmp_path / rel).parent.mkdir()
        jckpt.save_pytree(tmp_path / rel, p, meta=_heat_window_meta(
            s, (0.0, edges[k]), (1.0, edges[k + 1]), f"heat_2d_w{k + 1}"))
        windows.append(rel)
    (tmp_path / "march.json").write_text(json.dumps({
        "problem": "heat_2d", "axis": "t", "axis_index": 1, "edges": edges,
        "windows": windows, "rel_l2": None, "rel_l2_windows": [None] * 3,
        "fell_back": False}))
    return edges


def _port_march_record(tmp_path):
    """A 2-window heat_2d march run by the port on the CPU."""
    from tpinn_torch.core.march import run_time_marching
    from tpinn_torch.core.train import StageSpec, TrainSpec

    spec = TrainSpec(n_col=200, n_band=0, n_adaptive=50, n_bd=40,
                     testing_size=(21, 21), grid=21, tail_max=0,
                     pad_features=3,
                     stages=(StageSpec(depth=2, width=12, scl=1.0, epsil=1.0,
                                       adam_epochs=60, lbfgs_epochs=30),))
    torch.set_num_threads(1)
    res = run_time_marching(tproblems.heat_2d(), spec, 2,
                            output_dir=str(tmp_path), device="cpu")
    return [float(e) for e in res.edges]


@pytest.mark.parametrize("writer", ["tpinn", "tpinn_torch"])
def test_march_record_served_by_both_packages(tmp_path, writer):
    """A march.json served by both packages' PINNServer, as the directory
    and as the record's own path: /predict within 1e-6 at points in every
    slab and on every edge, /residual at rtol 1e-3, atol 1e-4, and the
    port's /predict is the composite of its window servers."""
    from tpinn.app.serve import PINNServer as JaxServer
    from tpinn_torch.core.march import make_march_predictor

    before = torch.get_num_threads()
    try:
        edges = (_tpinn_march_record if writer == "tpinn"
                 else _port_march_record)(tmp_path)
        jsrv = JaxServer(str(tmp_path), "heat_2d")
        tsrv = tserve.PINNServer(str(tmp_path), "heat_2d", device="cpu")
        trec = tserve.PINNServer(str(tmp_path / "march.json"), "heat_2d",
                                 device="cpu")
        rng = np.random.default_rng(30)
        pts = np.concatenate([
            rng.uniform((0.0, 0.0), (1.0, 1.0), (100, 2)),
            [[0.3, e] for e in edges] + [[0.8, e] for e in edges]]
        ).astype(np.float32)
        u_t = tsrv.predict(pts.tolist())
        np.testing.assert_allclose(u_t, jsrv.predict(pts.tolist()), rtol=0,
                                   atol=1e-6)
        assert trec.predict(pts.tolist()) == u_t
        np.testing.assert_allclose(tsrv.residual(pts.tolist()),
                                   jsrv.residual(pts.tolist()), rtol=1e-3,
                                   atol=1e-4)
        subs = [tserve.PINNServer(str(tmp_path / w), "heat_2d", device="cpu")
                for w in json.loads((tmp_path / "march.json").read_text())
                ["windows"]]
        want = make_march_predictor([s._predict for s in subs], edges, 1)(
            torch.from_numpy(pts))
        np.testing.assert_allclose(u_t, want[:, 0].detach().numpy(), rtol=0,
                                   atol=1e-6)
        with pytest.raises(ValueError, match="--problem"):
            tserve.PINNServer(str(tmp_path), None, device="cpu")
    finally:
        torch.set_num_threads(before)


def test_problem_registry():
    prob = tproblems.with_hard_bc(tproblems.get_problem("annulus_laplace"))
    assert prob.hard_bc == tuple(HARD) and prob.dim == 2
    assert [g.value for g in prob.bc_groups] == [1.0, 0.0]
    z = torch.tensor([[0.1, 0.0], [1.0, 3.0], [0.5, 1.0]])
    np.testing.assert_allclose(prob.exact(z)[:, 0].numpy(),
                               [1.0, 0.0, np.log(0.5) / np.log(0.1)],
                               rtol=1e-6, atol=1e-7)
    assert tuple(prob.bc_groups[0].target(z).shape) == (3, 1)
    assert tproblems.get_problem("allen_cahn").name == "allen_cahn"
    with pytest.raises(KeyError, match="unknown"):
        tproblems.get_problem("no_such_problem")


def test_serve_path_imports_no_jax():
    """The port loads neither jax nor the JAX package tpinn."""
    code = ("import sys; import tpinn_torch.app.serve, "
            "tpinn_torch.core.polish, tpinn_torch.core.train, "
            "tpinn_torch.problems, tpinn_torch.problems.oracles, "
            "tpinn_torch.core.march, tpinn_torch.core.system, "
            "tpinn_torch.core.inverse, tpinn_torch.problems.systems, "
            "tpinn_torch.core.ensemble, tpinn_torch.core.patch, "
            "tpinn_torch.core.refmode, "
            "tpinn_torch.kernels.mlp_taylor, tpinn_torch.kernels._build; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'tpinn')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
