"""Coupled systems end to end in tpinn_torch, on the CPU.

The cases of tests/test_system.py and tests/test_bc_operators.py's system
cases, at their own sizes and thresholds, through
``tpinn_torch.core.system.run_system``.  The two packages' random streams
differ by design (torch generators against JAX keys), so trajectories are
not compared across packages: each run is held to tpinn's accuracy bar.

One case does not run at tpinn's default seed: the inverse oscillator.
The port's draw at seed 1234 starts from an initial equation loss of 24.4
(tpinn's draw: 0.28) and lands at w2 1.38% off and rel-L2 4.96e-3, against
the bars 1e-2 and 5e-3.  At seeds 1 to 9 the port lands 0.03% to 0.52%
off (rel-L2 3.2e-4 to 1.8e-3); tpinn at seeds 1 to 6 lands 0.13% to 0.84%
off.  The test runs seed 1, the first seed after the default.

Checkpoints cross between the packages: a system checkpoint written by
either package's ``run_system`` is served by the port's ``PINNServer``
with no preset (``/predict`` within rtol 1e-5, atol 1e-6 of the writer's
predictor and of tpinn's server on the same file; ``/residual`` [n, E],
within rtol 1e-4, atol 1e-5 of tpinn's server), and the checkpoint meta
and ``system.json`` carry tpinn's keys.
"""

import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from tpinn_torch.app import serve as tserve
from tpinn_torch.core import net as tnet
from tpinn_torch.core import pde as tpde
from tpinn_torch.core import sample
from tpinn_torch.core.inverse import InverseSpec
from tpinn_torch.core.system import SystemSpec, make_system_loss, run_system
from tpinn_torch.core.train import StageSpec, TrainSpec
from tpinn_torch.problems.systems import get_system

PI = np.pi


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny nets: one intra-op thread is as fast as eight alone, and many
    times faster when several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _osc_exact(z):
    return torch.cat([torch.sin(PI * z[:, :1]), PI * torch.cos(PI * z[:, :1])],
                     dim=1)


def _osc_spec(**kw):
    base = dict(
        n_col=256, n_band=0, n_adaptive=64, n_bd=16,
        stages=(StageSpec(depth=3, width=24,
                          adam_epochs=600, lbfgs_epochs=900),),
        grid=64, lw=(1.0, 0.0), testing_size=(201,), pad_features=3,
        log_every=300)
    base.update(kw)
    return TrainSpec(**base)


def _poisson_spec(**kw):
    """tests/test_bc_operators.py's base spec."""
    base = dict(
        n_col=256, n_band=0, n_adaptive=64, n_bd=16,
        stages=(StageSpec(depth=3, width=20, scl=1.0, epsil=1.0,
                          adam_epochs=500, lbfgs_epochs=600),),
        grid=64, lw=(1.0, 0.0), testing_size=(201,), pad_features=3,
        tail_max=0, log_every=250)
    base.update(kw)
    return TrainSpec(**base)


# ---------------------------------------------------------------------------
# tests/test_system.py's end-to-end cases
# ---------------------------------------------------------------------------


def test_train_first_order_system():
    # u' = v, v' = -pi^2 u with u(0)=0, v(0)=pi, u(1)=0:
    # u = sin(pi x), v = pi cos(pi x)
    prob = SystemSpec(
        name="osc_system",
        equations=("u_x - v", "v_x + pi**2*u"),
        fields=("u", "v"), coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0, field=0),
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=float(PI), field=1),
            sample.BCGroup(lo=(1.0,), hi=(1.0,), value=0.0, field=0),
        ),
        exact=_osc_exact,
    )
    r = run_system(prob, _osc_spec(), device="cpu")
    assert r.rel_l2 < 2e-3
    assert len(r.rel_l2_fields) == 2 and max(r.rel_l2_fields) < 3e-3
    # loss_info: 3 + 3 BC groups + 2 equations
    assert r.history.shape[1] == 3 + 3 + 2
    assert r.coef == {}


def test_train_cauchy_riemann():
    exact = lambda z: torch.cat(
        [torch.exp(z[:, :1]) * torch.cos(z[:, 1:2]),
         torch.exp(z[:, :1]) * torch.sin(z[:, 1:2])], dim=1)
    edges = []
    for fi in (0, 1):
        fn = (lambda zz, i=fi: exact(zz)[:, i:i + 1])
        edges += [
            sample.BCGroup(lo=(0.0, 0.0), hi=(0.0, 1.0), value_fn=fn, field=fi),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0), value_fn=fn, field=fi),
            sample.BCGroup(lo=(0.0, 0.0), hi=(1.0, 0.0), value_fn=fn, field=fi),
            sample.BCGroup(lo=(0.0, 1.0), hi=(1.0, 1.0), value_fn=fn, field=fi),
        ]
    prob = SystemSpec(
        name="cauchy_riemann",
        equations=("u_x - v_y", "u_y + v_x"),
        fields=("u", "v"), coords=("x", "y"),
        lb=(0.0, 0.0), ub=(1.0, 1.0),
        bc_groups=tuple(edges), exact=exact,
    )
    spec = _osc_spec(n_col=384, n_adaptive=128, n_bd=24, grid=48,
                     testing_size=(64, 64))
    r = run_system(prob, spec, device="cpu")
    assert r.rel_l2 < 2e-3


def _osc_inverse():
    # u' = v, v' = -w2*u with full-state observations: true w2 = pi^2
    return SystemSpec(
        name="osc_inverse",
        equations=("u_x - v", "v_x + w2*u"),
        fields=("u", "v"), coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0, field=0),
        ),
        exact=_osc_exact,
    )


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_inverse_system_identifies_frequency(layout):
    """The joint {"net", "coef"} tree through both Adam layouts (the tree
    layout updates the coefficient as a 1-element vector of its own) and
    L-BFGS; seed 1 (the module docstring says why)."""
    inv = InverseSpec(params=("w2",), init=(5.0,), n_obs=80)
    r = run_system(_osc_inverse(), _osc_spec(seed=1, adam_layout=layout),
                   inverse=inv, device="cpu")
    assert isinstance(r.coef["w2"], float)
    assert abs(r.coef["w2"] - PI ** 2) / PI ** 2 < 1e-2
    assert r.rel_l2 < 5e-3
    # loss_info: 3 + 1 BC + 2 obs columns (full state) + 2 equations
    assert r.history.shape[1] == 3 + 1 + 2 + 2
    assert set(r.params) == {"net", "coef"}


def test_system_loss_info_layout():
    sys_ = tpde.compile_system(["u_x - v", "v_x + u"], ("x",), ("u", "v"))
    fm = tnet.feature_map_for(("minmax",), pad_to=3)
    mspec = tnet.MLPSpec(depth=2, width=8, out_dim=2)
    params = tnet.init_params(torch.Generator().manual_seed(0), mspec, fm,
                              "cpu")
    pred = tnet.make_predictor(mspec, fm, torch.zeros(1), torch.ones(1))
    loss_fn = make_system_loss(pred, sys_, bc_fields=(0,))
    data = {
        "x_col": torch.linspace(0, 1, 16)[:, None],
        "x_bd": [torch.zeros((4, 1))],
        "u_bd": [torch.zeros((4, 1))],
    }
    loss_n, info = loss_fn(params, data, torch.tensor([1.0, 0.0]),
                           torch.tensor(1.0))
    assert tuple(info.shape) == (3 + 1 + 2,)
    # loss = loss_data + lw0*loss_eqn; columns consistent
    np.testing.assert_allclose(float(info[0]), float(info[1] + info[2]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(info[2]), float(info[4] + info[5]),
                               rtol=1e-6)


def test_system_testing_size_fallback():
    """A testing_size whose rank mismatches the problem (the TrainSpec
    default is 2-D) falls back to a per-axis grid of the right rank."""
    spec = TrainSpec(
        n_col=128, n_band=0, n_adaptive=0, n_bd=8,
        lw=(1.0, 0.0), grid=8,                 # testing_size left (111, 111)
        stages=(StageSpec(depth=2, width=8, scl=1.0, epsil=1.0,
                          adam_epochs=20, lbfgs_epochs=0),),
        log_every=20,
    )
    lines = []
    res = run_system(get_system("taylor_green"), spec, log_fn=lines.append,
                     device="cpu")
    assert res.rel_l2 is not None and np.isfinite(res.rel_l2)
    assert len(res.rel_l2_fields) == 3
    assert any("is not 3-D" in ln for ln in lines)


def test_system_flux_bc():
    # oscillator system with v(0)=pi stated as the flux u_x(0)=pi
    prob = SystemSpec(
        name="osc_flux",
        equations=("u_x - v", "v_x + pi**2*u"),
        fields=("u", "v"), coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0, field=0),
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=float(PI),
                           operator="u_x"),
            sample.BCGroup(lo=(1.0,), hi=(1.0,), value=0.0, field=0),
        ),
        exact=_osc_exact,
    )
    spec = _poisson_spec(
        tail_max=4000,
        stages=(StageSpec(depth=3, width=24,
                          adam_epochs=600, lbfgs_epochs=900),),
    )
    r = run_system(prob, spec, device="cpu")
    assert r.rel_l2 < 3e-3


def test_elliptic_interface_two_materials():
    """Two-material elliptic interface: one field per material, each
    material's Laplace residual gated by a sharp tanh indicator, value
    and flux continuity as operator groups at the interface.  κ₁=1, κ₂=10,
    u(0)=0, u(1)=1: exact flux q = 1/(a/κ₁ + (1−a)/κ₂)."""
    k1, k2, a = 1.0, 10.0, 0.5
    q = 1.0 / (a / k1 + (1.0 - a) / k2)

    def exact(z):
        x = z[:, :1]
        return torch.cat([q * x / k1, 1.0 + q * (x - 1.0) / k2], dim=1)

    prob = SystemSpec(
        name="interface_1d",
        equations=(
            f"(0.5 - 0.5*tanh(200*(x - {a})))*u_xx",
            f"(0.5 + 0.5*tanh(200*(x - {a})))*v_xx",
        ),
        fields=("u", "v"), coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0, field=0),
            sample.BCGroup(lo=(1.0,), hi=(1.0,), value=1.0, field=1),
            sample.BCGroup(lo=(a,), hi=(a,), value=0.0, operator="u - v"),
            sample.BCGroup(lo=(a,), hi=(a,), value=0.0,
                           operator=f"{k1}*u_x - {k2}*v_x"),
        ),
        exact=exact,
    )
    spec = _poisson_spec(
        stages=(StageSpec(depth=3, width=24,
                          adam_epochs=800, lbfgs_epochs=1200),),
    )
    r = run_system(prob, spec, device="cpu")
    assert r.rel_l2_fields[0] < 2e-2, r.rel_l2_fields
    assert r.rel_l2_fields[1] < 2e-2, r.rel_l2_fields
    # the physical solution: u on [0,a], v on [a,1], a derivative jump at a
    z_l = torch.linspace(0.0, a, 101)[:, None]
    z_r = torch.linspace(a, 1.0, 101)[:, None]
    with torch.no_grad():
        u_l = r.predict(z_l)[:, 0].numpy()
        v_r = r.predict(z_r)[:, 1].numpy()
        at = lambda x, i: float(r.predict(torch.tensor([[x]]))[0, i])
        eps = 1e-3
        du = (at(a, 0) - at(a - eps, 0)) / eps
        dv = (at(a + eps, 1) - at(a, 1)) / eps
    np.testing.assert_allclose(u_l, exact(z_l)[:, 0].numpy(), atol=3e-3)
    np.testing.assert_allclose(v_r, exact(z_r)[:, 1].numpy(), atol=3e-3)
    # flux continuity held: k1 u'(a-) == k2 v'(a+) == q
    assert abs(k1 * du - q) < 0.05 * q
    assert abs(k2 * dv - q) < 0.05 * q


@pytest.mark.slow
def test_kovasznay_trains():
    """Steady Navier-Stokes: the nonlinear 3-field system at tpinn's small
    CPU budget."""
    spec = TrainSpec(
        n_col=1024, n_band=0, n_adaptive=256, n_bd=64,
        testing_size=(48, 48), lw=(1.0, 0.0), grid=48, pad_features=3,
        stages=(StageSpec(depth=4, width=48, scl=1.0, epsil=1.0,
                          adam_epochs=2500, lbfgs_epochs=2500),),
        log_every=1000,
    )
    res = run_system(get_system("kovasznay"), spec, device="cpu")
    assert res.rel_l2 is not None and np.isfinite(res.rel_l2)
    # velocity fields tight; pressure (one-edge pin) looser
    assert res.rel_l2_fields[0] < 2e-2
    assert res.rel_l2_fields[1] < 5e-2
    assert res.rel_l2_fields[2] < 1e-1


@pytest.mark.slow
def test_taylor_green_trains():
    """Unsteady Navier-Stokes through the 3-coordinate sampler at tpinn's
    small CPU budget."""
    spec = TrainSpec(
        n_col=1536, n_band=0, n_adaptive=256, n_bd=48,
        testing_size=(16, 16, 16), lw=(1.0, 0.0), grid=16, pad_features=0,
        stages=(StageSpec(depth=4, width=48, scl=1.0, epsil=1.0,
                          adam_epochs=2000, lbfgs_epochs=2000),),
        log_every=1000,
    )
    res = run_system(get_system("taylor_green"), spec, device="cpu")
    assert res.rel_l2 is not None and np.isfinite(res.rel_l2)
    assert res.rel_l2_fields[0] < 5e-2
    assert res.rel_l2_fields[1] < 5e-2


def test_device_and_mesh_refused(monkeypatch):
    prob = _osc_inverse()
    spec = _osc_spec(n_col=16, n_adaptive=0, n_bd=4, stages=(
        StageSpec(depth=1, width=4, adam_epochs=1, lbfgs_epochs=0),))
    with pytest.raises(TypeError, match="Mesh"):
        run_system(prob, spec, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_system(prob, spec, device="cuda")


# ---------------------------------------------------------------------------
# Checkpoints: written by either package, served by both
# ---------------------------------------------------------------------------


def _tiny_inverse_spec():
    return dict(n_col=96, n_band=0, n_adaptive=0, n_bd=8, grid=32,
                lw=(1.0, 0.0), testing_size=(51,), pad_features=3,
                tail_max=0, log_every=100)


@pytest.fixture(scope="module")
def system_checkpoints(tmp_path_factory):
    """The inverse oscillator (coefficient w2 in the meta) at a tiny budget
    through both packages' run_system with an output_dir: {writer: (dir,
    predict on numpy points)}."""
    import jax
    import jax.numpy as jnp

    from tpinn.core import sample as jsample
    from tpinn.core import system as jsystem
    from tpinn.core import train as jtrain
    from tpinn.core.inverse import InverseSpec as JInverseSpec

    out = {}
    st = dict(depth=2, width=12, adam_epochs=60, lbfgs_epochs=30)
    d = tmp_path_factory.mktemp("system_tpinn")
    jprob = jsystem.SystemSpec(
        name="osc_inverse", equations=("u_x - v", "v_x + w2*u"),
        fields=("u", "v"), coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(jsample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0,
                                   field=0),),
        exact=lambda z: jnp.concatenate(
            [jnp.sin(PI * z[:, :1]), PI * jnp.cos(PI * z[:, :1])], axis=1))
    rj = jsystem.run_system(
        jprob, jtrain.TrainSpec(stages=(jtrain.StageSpec(**st),),
                                **_tiny_inverse_spec()),
        inverse=JInverseSpec(params=("w2",), init=(5.0,), n_obs=20),
        output_dir=str(d))
    out["tpinn"] = (d, lambda z: np.asarray(
        jax.device_get(rj.predict(jnp.asarray(z)))), rj.coef)
    d = tmp_path_factory.mktemp("system_tpinn_torch")
    rt = run_system(_osc_inverse(),
                    TrainSpec(stages=(StageSpec(**st),),
                              **_tiny_inverse_spec()),
                    inverse=InverseSpec(params=("w2",), init=(5.0,),
                                        n_obs=20),
                    output_dir=str(d), device="cpu")
    out["tpinn_torch"] = (d, lambda z: rt.predict(
        torch.from_numpy(z)).detach().numpy(), rt.coef)
    return out


def _post(base, route, points):
    req = urllib.request.Request(base + route,
                                 data=json.dumps({"points": points}).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("writer", ["tpinn", "tpinn_torch"])
def test_system_checkpoint_served_by_both_packages(system_checkpoints,
                                                   writer):
    from tpinn.app.serve import PINNServer as JaxServer

    d, predict, coef = system_checkpoints[writer]
    path = str(d / "params_stage_1.npz")
    srv = tserve.PINNServer(path, device="cpu")            # no preset
    assert srv.problem.name == "osc_inverse" and srv.problem.dim == 1
    assert isinstance(srv.compiled, tpde.CompiledSystem)
    assert {k: float(v) for k, v in srv._coef.items()} == coef
    z = np.linspace(0.0, 1.0, 7, dtype=np.float32)[:, None]
    u = np.asarray(srv.predict(z.tolist()))
    f = np.asarray(srv.residual(z.tolist()))
    assert u.shape == (7, 2) and f.shape == (7, 2)
    assert np.all(np.isfinite(f))
    np.testing.assert_allclose(u, predict(z), rtol=1e-5, atol=1e-6)
    jsrv = JaxServer(path)
    np.testing.assert_allclose(u, np.asarray(jsrv.predict(z.tolist())),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f, np.asarray(jsrv.residual(z.tolist())),
                               rtol=1e-4, atol=1e-5)
    # over HTTP: one m-column row per point
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(srv))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        got = _post(base, "/predict", z[:3].tolist())["u"]
        assert np.asarray(got).shape == (3, 2)
        np.testing.assert_allclose(got, u[:3], rtol=1e-6, atol=1e-7)
        assert np.asarray(_post(base, "/residual",
                                z[:3].tolist())["f"]).shape == (3, 2)
    finally:
        httpd.shutdown()
        httpd.server_close()
    with pytest.raises(ValueError, match="deflate"):
        tserve.PINNServer(path, deflate="auto", device="cpu")


def test_system_records_carry_tpinns_keys(system_checkpoints):
    metas, records = {}, {}
    for writer, (d, _, _) in system_checkpoints.items():
        with np.load(d / "params_stage_1.npz") as raw:
            metas[writer] = json.loads(bytes(raw["__meta__"]).decode())
            leaves = sorted(k for k in raw.files if k.startswith("leaf:"))
        records[writer] = json.loads((d / "system.json").read_text())
        assert leaves == ["leaf:layers/0/b", "leaf:layers/0/w",
                          "leaf:layers/1/b", "leaf:layers/1/w",
                          "leaf:layers/2/b", "leaf:layers/2/w"]
    assert list(metas["tpinn_torch"]) == list(metas["tpinn"])
    assert list(records["tpinn_torch"]) == list(records["tpinn"])
    for key in ("system", "coords", "lb", "ub", "feature_kinds",
                "pad_features", "hard_bc", "chain", "problem"):
        assert metas["tpinn_torch"][key] == metas["tpinn"][key], key
    assert set(metas["tpinn_torch"]["coef"]) == {"w2"}


def test_system_checkpoint_serves(tmp_path):
    """A forward system (no coefficients): run_system(output_dir=...)
    served with no preset, /predict equal to the trainer's predictor."""
    prob = SystemSpec(
        name="osc_system_ckpt",
        equations=("u_x - v", "v_x + pi**2*u"),
        fields=("u", "v"), coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0, field=0),
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=float(PI), field=1),
        ),
        exact=_osc_exact,
    )
    spec = _osc_spec(n_col=192, n_adaptive=0, testing_size=(101,),
                     log_every=200, stages=(
                         StageSpec(depth=3, width=16, adam_epochs=200,
                                   lbfgs_epochs=90),))
    r = run_system(prob, spec, output_dir=str(tmp_path),
                   device="cpu")
    rec = json.loads((tmp_path / "system.json").read_text())
    assert rec["fields"] == ["u", "v"] and rec["coef"] == {}
    assert rec["rel_l2"] == r.rel_l2
    srv = tserve.PINNServer(str(tmp_path / "params_stage_1.npz"),
                            device="cpu")
    assert srv._coef is None
    z = np.linspace(0.0, 1.0, 7)[:, None].tolist()
    u_served = np.asarray(srv.predict(z))
    assert u_served.shape == (7, 2)
    with torch.no_grad():
        u_train = r.predict(torch.tensor(z, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(u_served, u_train, rtol=1e-5, atol=1e-6)
    f = np.asarray(srv.residual(z))
    assert f.shape == (7, 2) and np.all(np.isfinite(f))
