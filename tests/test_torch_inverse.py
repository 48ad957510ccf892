"""Scalar inverse identification: tpinn_torch against tpinn, piece by piece.

The same numpy-seeded net is loaded into both packages
(``params_from_numpy``) and fed the same points, targets and coefficient
values.  Tolerances, float32 on the CPU:

- ``make_inverse_loss``'s ``loss_info`` (and ``loss_n``): rtol 1e-5,
  atol 1e-6, with a hard-BC predictor, a source, a residual weight, a
  Robin operator BC whose transfer coefficient is an unknown, a 2-D
  equation with three BC groups, and the eigenvalue mode;
- its gradient in every net leaf and every coefficient (torch autograd
  through B1's plain version against ``jax.grad`` of tpinn's loss): rtol
  1e-4, atol 1e-6.

``synth_observations`` is held to its contract (box, labels, noise, seed,
the no-oracle error) and the system path's observations to the draw they
had before the two paths shared it.

Checkpoints cross between the packages: a scalar inverse checkpoint
written by either package's ``run_inverse`` (a 1-D hard-BC case and a
2-D soft-BC case) is served by the port's ``PINNServer`` with no preset:
``/predict`` within rtol 1e-5, atol 1e-6 of the writer's predictor and of
tpinn's server on the same file, ``/residual`` within rtol 1e-3, atol
1e-4 of tpinn's server (evaluated at the recovered coefficient),
``/health`` carrying the coefficient, also over HTTP; ``--deflate`` is
refused.  The checkpoint meta, ``inverse.json`` and the UI artifacts
carry tpinn's keys, and the artifacts tpinn's shapes (in 2-D those of
tests/goldens/artifacts).  End-to-end identification is in
test_torch_inverse_train.py.
"""

import dataclasses
import json
import math
import threading
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.core import inverse as jinverse
from tpinn.core import net as jnet
from tpinn.core import pde as jpde
from tpinn.core import sample as jsample
from tpinn.core import train as jtrain
from tpinn_torch.app import serve as tserve
from tpinn_torch.core import inverse as tinverse
from tpinn_torch.core import net as tnet
from tpinn_torch.core import pde as tpde
from tpinn_torch.core import sample as tsample
from tpinn_torch.core import system as tsystem
from tpinn_torch.core import train as ttrain
from tpinn_torch.utils.convert import params_from_numpy

PI = np.pi
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
GOLDEN = Path(__file__).resolve().parent / "goldens" / "artifacts"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# make_inverse_loss
# ---------------------------------------------------------------------------

# (equation, coords, box, params and values, BC groups as (lo, hi, value,
#  operator), hard_bc, source, residual weight, normalize, obs_weight)
LOSS_CASES = {
    "hard_bc_source_weight": (
        "lam*u_xx + sin(pi*x)", ("x",), ((0.0,), (1.0,)), {"lam": 0.3},
        (), ("0", "x*(1-x)"), "x**2", "1 + x", 0.0, 2.5),
    "robin_unknown_coefficient": (
        "u_xx + pi**2*sin(pi*x)", ("x",), ((0.0,), (0.5,)), {"k": 0.7},
        (((0.0,), (0.0,), 0.0, None), ((0.5,), (0.5,), 2.0, "u_x + k*u")),
        None, None, None, 0.0, 1.0),
    "heat_2d": (
        "u_t - lam*u_xx", ("x", "t"), ((0.0, 0.0), (1.0, 0.5)), {"lam": 0.6},
        (((0.0, 0.0), (0.0, 0.5), 0.0, None),
         ((1.0, 0.0), (1.0, 0.5), 0.0, None),
         ((0.0, 0.0), (1.0, 0.0), 0.5, None)),
        None, None, None, 0.0, 1.0),
    "eigen": (
        "u_xx + lam*u", ("x",), ((0.0,), (1.0,)), {"lam": 8.0},
        (((0.0,), (0.0,), 0.0, None), ((1.0,), (1.0,), 0.0, None)),
        None, None, None, 0.5, 10.0),
}


def _loss_inputs(case):
    (eq, coords, (lb, ub), coef, groups, hard, src, weight, normalize,
     obs_w) = LOSS_CASES[case]
    d = len(coords)
    pad = 3
    rng = np.random.default_rng(11)
    sizes = [pad] + [12, 12] + [1]
    p_np = {"layers": [
        {"w": (rng.standard_normal((a, b)) * math.sqrt(2.0 / (a + b))
               ).astype(np.float32),
         "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
        for a, b in zip(sizes[:-1], sizes[1:])]}
    box = lambda n: rng.uniform(lb, ub, (n, d)).astype(np.float32)
    x_col = box(64)
    x_bd = [rng.uniform(lo, hi, (8, d)).astype(np.float32)
            for lo, hi, _, _ in groups]
    u_bd = [np.full((8, 1), v, np.float32) for _, _, v, _ in groups]
    z_obs = box(20)
    u_obs = rng.standard_normal((20, 1)).astype(np.float32)
    lw = np.asarray([0.7, 0.0], np.float32)
    return dict(eq=eq, coords=coords, lb=lb, ub=ub, coef=coef,
                operators=[g[3] for g in groups], hard=hard, src=src,
                weight=weight, normalize=normalize, obs_w=obs_w,
                kinds=("minmax",) * d, pad=pad, p_np=p_np,
                data={"x_col": x_col, "x_bd": x_bd, "u_bd": u_bd},
                z_obs=z_obs, u_obs=u_obs, lw=lw)


def _loss_for(pkg, c):
    """(loss_fn, conv) of one package on the case's inputs."""
    pde_mod, net_mod, inv_mod = pkg
    torch_side = pde_mod is tpde
    conv = _t if torch_side else jnp.asarray
    names = tuple(c["coef"])
    spec = net_mod.MLPSpec(depth=2, width=12)
    fm = net_mod.feature_map_for(c["kinds"], pad_to=c["pad"])
    pred = net_mod.make_predictor(spec, fm, conv(np.float32(c["lb"])),
                                  conv(np.float32(c["ub"])))
    if c["hard"]:
        pred = net_mod.wrap_hard_bc(pred, *(
            pde_mod.compile_coord_expr(e, c["coords"]) for e in c["hard"]))
    compiled = pde_mod.compile_pde(c["eq"], c["coords"], names)
    ops = tuple(pde_mod.compile_pde(o, c["coords"], names) if o else None
                for o in c["operators"])
    expr = lambda e: (pde_mod.compile_coord_expr(e, c["coords"]) if e
                      else None)
    loss_fn = inv_mod.make_inverse_loss(
        pred, compiled, conv(c["z_obs"]), conv(c["u_obs"]),
        source_fn=expr(c["src"]), residual_weight_fn=expr(c["weight"]),
        obs_weight=c["obs_w"],
        bc_operators=ops if any(o is not None for o in ops) else None,
        normalize=c["normalize"])
    return loss_fn, conv


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_inverse_loss_and_gradient_match_tpinn(case):
    c = _loss_inputs(case)
    ref = np.float32(1.7)

    # tpinn: loss_info and jax.grad over the joint tree
    loss_j, conv_j = _loss_for((jpde, jnet, jinverse), c)
    data_j = {"x_col": conv_j(c["data"]["x_col"]),
              "x_bd": [conv_j(a) for a in c["data"]["x_bd"]],
              "u_bd": [conv_j(a) for a in c["data"]["u_bd"]]}
    tree_j = {"net": jax.tree_util.tree_map(jnp.asarray, c["p_np"]),
              "coef": {k: jnp.float32(v) for k, v in c["coef"].items()}}
    (ln_j, info_j), grad_j = jax.value_and_grad(loss_j, has_aux=True)(
        tree_j, data_j, conv_j(c["lw"]), conv_j(ref))

    # the port: loss_info and autograd over the same tree
    loss_t, conv_t = _loss_for((tpde, tnet, tinverse), c)
    data_t = {"x_col": conv_t(c["data"]["x_col"]),
              "x_bd": [conv_t(a) for a in c["data"]["x_bd"]],
              "u_bd": [conv_t(a) for a in c["data"]["u_bd"]]}
    net_t = params_from_numpy(c["p_np"], "cpu")
    coef_t = {k: torch.tensor(v, dtype=torch.float32)
              for k, v in c["coef"].items()}
    leaves = [x for layer in net_t["layers"] for x in (layer["w"],
                                                       layer["b"])]
    for x in leaves + list(coef_t.values()):
        x.requires_grad_(True)
    ln_t, info_t = loss_t({"net": net_t, "coef": coef_t}, data_t,
                          conv_t(c["lw"]), conv_t(ref))
    grads_t = torch.autograd.grad(ln_t, leaves + list(coef_t.values()))

    n_groups = len(c["operators"])
    assert tuple(info_t.shape) == tuple(info_j.shape) == (3 + n_groups + 2,)
    np.testing.assert_allclose(info_t.detach().numpy(), np.asarray(info_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(ln_t.detach()), float(ln_j), rtol=RTOL,
                               atol=ATOL)
    # loss = loss_data + lw0*loss_eqn; the obs column weighted in the sum
    info = np.asarray(info_j)
    np.testing.assert_allclose(
        info[1], info[3:3 + n_groups].sum() + c["obs_w"] * info[-2],
        rtol=1e-5)
    ref_grads = [np.asarray(grad_j["net"]["layers"][i][k])
                 for i in range(len(c["p_np"]["layers"])) for k in "wb"]
    ref_grads += [np.asarray(grad_j["coef"][k]) for k in coef_t]
    assert len(ref_grads) == len(grads_t)
    for k, (got, want) in enumerate(zip(grads_t, ref_grads)):
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"leaf {k}")
    assert float(grads_t[-1].abs()) > 0.0      # the coefficient is live


# ---------------------------------------------------------------------------
# Observations
# ---------------------------------------------------------------------------


def _heat(exact=True):
    problem = dataclasses.replace(
        ttrain.ProblemSpec(
            name="heat_inverse", equation="u_t - lam*u_xx",
            coords=("x", "t"), lb=(0.0, 0.0), ub=(1.0, 0.5), bc_groups=(),
            exact=lambda z: (torch.exp(-PI ** 2 * z[:, 1:2])
                             * torch.sin(PI * z[:, :1]))))
    return problem if exact else dataclasses.replace(problem, exact=None)


def test_synth_observations_contract():
    problem = _heat()
    inv = tinverse.InverseSpec(params=("lam",), init=(0.3,), n_obs=4000,
                               obs_seed=3)
    z, u = tinverse.synth_observations(problem, inv, torch.float32)
    assert tuple(z.shape) == (4000, 2) and tuple(u.shape) == (4000, 1)
    assert z.dtype == u.dtype == torch.float32
    lo, hi = torch.tensor(problem.lb), torch.tensor(problem.ub)
    assert bool(((z >= lo) & (z <= hi)).all())
    torch.testing.assert_close(u, problem.exact(z), rtol=0, atol=0)
    # one point per LHS stratum on each axis
    for i in range(2):
        cells = torch.floor((z[:, i] - lo[i]) / (hi[i] - lo[i]) * 4000)
        assert len(torch.unique(cells.clamp(max=3999))) == 4000
    z2, u2 = tinverse.synth_observations(problem, inv, torch.float32)
    assert torch.equal(z, z2) and torch.equal(u, u2)
    other = dataclasses.replace(inv, obs_seed=4)
    assert not torch.equal(tinverse.synth_observations(
        problem, other, torch.float32)[0], z)
    # noise: the same points, labels off by N(0, obs_noise^2)
    noisy = dataclasses.replace(inv, obs_noise=0.05)
    zn, un = tinverse.synth_observations(problem, noisy, torch.float32)
    assert torch.equal(zn, z)
    resid = (un - problem.exact(zn)).numpy()
    assert abs(float(resid.std()) - 0.05) < 0.05 * 0.05
    assert abs(float(resid.mean())) < 4 * 0.05 / math.sqrt(4000)
    z64, _ = tinverse.synth_observations(problem, inv, torch.float64)
    assert z64.dtype == torch.float64
    with pytest.raises(ValueError, match="analytic solution"):
        tinverse.synth_observations(_heat(exact=False), inv, torch.float32)


@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_system_observations_unchanged(noise):
    """core.system's full-state observations: the draw they had before the
    scalar and system paths shared synth_observations (LHS from a CPU
    generator seeded with obs_seed, then one noise column per field from
    the same generator), bit for bit."""
    problem = tsystem.SystemSpec(
        name="osc", equations=("u_x - v", "v_x + w2*u"), fields=("u", "v"),
        coords=("x",), lb=(0.0,), ub=(1.0,), bc_groups=(),
        exact=lambda z: torch.cat([torch.sin(PI * z), PI * torch.cos(PI * z)],
                                  dim=1))
    inv = tinverse.InverseSpec(params=("w2",), init=(5.0,), n_obs=80,
                               obs_noise=noise, obs_seed=2)
    z, u = tsystem._observations(problem, inv, None, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(2)
    z_ref = tsample.lhs_box(gen, 80, (0.0,), (1.0,), torch.float32)
    u_ref = problem.exact(z_ref)
    if noise:
        u_ref = u_ref + noise * torch.randn((80, 2), generator=gen,
                                            dtype=torch.float32)
    assert torch.equal(z, z_ref) and torch.equal(u, u_ref)
    given = (np.zeros((3, 1)), np.ones((3, 2)))
    zg, ug = tsystem._observations(problem, inv, given, torch.float32, "cpu")
    assert zg.dtype == torch.float32 and tuple(ug.shape) == (3, 2)


def test_inverse_result_fields_match_tpinn():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert names(tinverse.InverseResult) == names(jinverse.InverseResult)
    assert names(tinverse.InverseSpec) == names(jinverse.InverseSpec)
    for bad in (dict(params=("a", "b"), init=(1.0,)),
                dict(params=(), init=()),
                dict(params=("a",), init=(1.0,), normalize=-1.0)):
        with pytest.raises(ValueError):
            tinverse.InverseSpec(**bad)


# ---------------------------------------------------------------------------
# Checkpoints: written by either package, served by both
# ---------------------------------------------------------------------------


def _cases(pkg):
    """The 1-D hard-BC Poisson coefficient and the 2-D heat diffusivity of
    tests/test_inverse.py, in one package's types, at a tiny budget."""
    torch_side = pkg == "tpinn_torch"
    xp = torch if torch_side else jnp
    sample_mod = tsample if torch_side else jsample
    tr = ttrain if torch_side else jtrain
    sin_ic = lambda z: xp.sin(PI * z[:, :1])
    poisson = tr.ProblemSpec(
        name="poisson_1d_inverse", equation="lam*u_xx + sin(pi*x)",
        coords=("x",), lb=(0.0,), ub=(1.0,), bc_groups=(),
        exact=lambda z: xp.sin(PI * z[:, :1]), hard_bc=("0", "x*(1-x)"))
    heat = tr.ProblemSpec(
        name="heat_inverse", equation="u_t - lam*u_xx",
        coords=("x", "t"), lb=(0.0, 0.0), ub=(1.0, 0.5),
        bc_groups=(
            sample_mod.BCGroup(lo=(0.0, 0.0), hi=(0.0, 0.5), value=0.0),
            sample_mod.BCGroup(lo=(1.0, 0.0), hi=(1.0, 0.5), value=0.0),
            sample_mod.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0),
                               value_fn=sin_ic)),
        exact=lambda z: xp.exp(-PI ** 2 * z[:, 1:2]) * xp.sin(PI * z[:, :1]))
    base = dict(n_band=0, n_adaptive=16, n_bd=8, lw=(1.0, 0.0),
                pad_features=3, tail_max=0, log_every=100)
    st = tr.StageSpec(depth=2, width=12, adam_epochs=40, lbfgs_epochs=30)
    return {
        "1d": (poisson, tr.TrainSpec(n_col=64, grid=32, testing_size=(51,),
                                     stages=(st,), **base),
               (0.5,), 20),
        "2d": (heat, tr.TrainSpec(n_col=96, grid=24, testing_size=(41, 41),
                                  stages=(st,), **base),
               (0.3,), 30),
    }


@pytest.fixture(scope="module")
def inverse_checkpoints(tmp_path_factory):
    """{(writer, case): (dir, predict on numpy points, coef)}."""
    out = {}
    for writer in ("tpinn", "tpinn_torch"):
        for case, (prob, spec, init, n_obs) in _cases(writer).items():
            d = tmp_path_factory.mktemp(f"inverse_{writer}_{case}")
            if writer == "tpinn":
                inv = jinverse.InverseSpec(params=("lam",), init=init,
                                           n_obs=n_obs)
                r = jinverse.run_inverse(prob, inv, spec, output_dir=str(d))
                predict = (lambda z, r=r: np.asarray(jax.device_get(
                    r.predict(jnp.asarray(z)))))
            else:
                inv = tinverse.InverseSpec(params=("lam",), init=init,
                                           n_obs=n_obs)
                r = tinverse.run_inverse(prob, inv, spec, output_dir=str(d),
                                         device="cpu")
                predict = (lambda z, r=r: r.predict(
                    torch.from_numpy(z)).detach().numpy())
            out[writer, case] = (d, predict, r.coef)
    return out


def _post(base, route, points):
    req = urllib.request.Request(base + route,
                                 data=json.dumps({"points": points}).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _get(base, route):
    with urllib.request.urlopen(base + route, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("case", ["1d", "2d"])
@pytest.mark.parametrize("writer", ["tpinn", "tpinn_torch"])
def test_inverse_checkpoint_served_by_both_packages(inverse_checkpoints,
                                                    writer, case):
    from tpinn.app.serve import PINNServer as JaxServer

    d, predict, coef = inverse_checkpoints[writer, case]
    path = str(d / "params_stage_1.npz")
    srv = tserve.PINNServer(path, device="cpu")               # no preset
    prob = _cases("tpinn_torch")[case][0]
    assert srv.problem.name == prob.name
    assert srv.problem.equation == prob.equation
    assert srv.compiled.param_names == ("lam",)
    assert {k: float(v) for k, v in srv._coef.items()} == coef
    rng = np.random.default_rng(5)
    z = rng.uniform(prob.lb, prob.ub, (9, prob.dim)).astype(np.float32)
    u = np.asarray(srv.predict(z.tolist()))
    f = np.asarray(srv.residual(z.tolist()))
    assert u.shape == f.shape == (9,) and np.all(np.isfinite(f))
    np.testing.assert_allclose(u, predict(z)[:, 0], rtol=1e-5, atol=1e-6)
    jsrv = JaxServer(path)
    np.testing.assert_allclose(u, np.asarray(jsrv.predict(z.tolist())),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f, np.asarray(jsrv.residual(z.tolist())),
                               rtol=1e-3, atol=1e-4)
    # the residual is evaluated at the recovered coefficient
    moved = tpde.compile_pde(prob.equation, prob.coords, ("lam",))
    zt = torch.from_numpy(z)
    f_moved = moved.residual_fast(srv.predictor, srv.params, zt,
                                  {"lam": torch.tensor(coef["lam"] + 0.5)})
    assert float((f_moved[:, 0] - torch.from_numpy(f)).abs().max()) > 1e-3
    # over HTTP, /health with the coefficient
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(srv))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        health = _get(base, "/health")
        assert health["ok"] is True and health["coef"] == coef
        assert health["equation"] == prob.equation
        np.testing.assert_allclose(_post(base, "/predict",
                                         z[:3].tolist())["u"], u[:3],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_post(base, "/residual",
                                         z[:3].tolist())["f"], f[:3],
                                   rtol=1e-6, atol=1e-7)
    finally:
        httpd.shutdown()
        httpd.server_close()
    with pytest.raises(ValueError, match="deflate"):
        tserve.PINNServer(path, deflate="auto", device="cpu")


def test_inverse_records_carry_tpinns_keys(inverse_checkpoints):
    for case in ("1d", "2d"):
        metas, records = {}, {}
        for writer in ("tpinn", "tpinn_torch"):
            d = inverse_checkpoints[writer, case][0]
            with np.load(d / "params_stage_1.npz") as raw:
                metas[writer] = json.loads(bytes(raw["__meta__"]).decode())
            records[writer] = json.loads((d / "inverse.json").read_text())
        assert list(metas["tpinn_torch"]) == list(metas["tpinn"])
        assert list(records["tpinn_torch"]) == list(records["tpinn"])
        for key in ("stage", "scl", "epsil", "problem", "chain",
                    "feature_kinds", "lb", "ub", "hard_bc", "coords",
                    "pad_features", "equation", "inverse"):
            assert metas["tpinn_torch"][key] == metas["tpinn"][key], key
        for key in ("problem", "equation", "n_obs", "obs_noise"):
            assert records["tpinn_torch"][key] == records["tpinn"][key], key
        assert set(metas["tpinn_torch"]["coef"]) == {"lam"}
        assert records["tpinn_torch"]["coef"] == metas["tpinn_torch"]["coef"]


@pytest.mark.parametrize("case", ["1d", "2d"])
def test_inverse_artifacts_match_tpinns(inverse_checkpoints, case):
    """The UI artifacts: tpinn's files, the golden run's keys, tpinn's
    shapes from the same spec (but for the per-step counts) and, in 2-D
    on the golden's 41 x 41 grid, the golden's shapes."""
    mine_dir = inverse_checkpoints["tpinn_torch", case][0]
    ref_dir = inverse_checkpoints["tpinn", case][0]
    names = sorted(p.name for p in ref_dir.glob("*.npz"))
    assert sorted(p.name for p in mine_dir.glob("*.npz")) == names
    assert len(names) == 7
    for name in names:
        with np.load(mine_dir / name) as mine, np.load(ref_dir / name) as ref:
            assert mine.files == ref.files, name
            if name.startswith("params"):
                continue
            with np.load(GOLDEN / name) as gold:
                assert mine.files == gold.files, name
                for key in mine.files:
                    per_step = name.startswith(("loss", "boundary"))
                    if per_step:
                        assert mine[key].ndim == ref[key].ndim, (name, key)
                        continue
                    assert mine[key].shape == ref[key].shape, (name, key)
                    if case == "2d" and key != "X_col" and not (
                            name.startswith("collocation") and key == "U"):
                        assert mine[key].shape == gold[key].shape, (name, key)
    with np.load(mine_dir / "collocation_point_1.npz") as c:
        n_obs = _cases("tpinn_torch")[case][3]
        assert c["X_col"].shape == (n_obs, 2)
        if case == "1d":
            assert not c["X_col"][:, 1].any()
            assert c["limit"].tolist() == [0.0, 1.0, 0.0, 1.0]
    with np.load(mine_dir / "loss_1.npz") as l_mine:
        # loss, loss_data, loss_eqn, one per BC group, obs, eqn
        groups = len(_cases("tpinn_torch")[case][0].bc_groups)
        assert l_mine["loss"].shape[1] == 3 + groups + 2
