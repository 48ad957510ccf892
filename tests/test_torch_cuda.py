"""Kernels B1, B2 and B3, the serving path and the float64 polish on a
CUDA card (marker ``cuda``).

These tests need a card and skip without one.  The file imports torch
and tpinn_torch only, so it also runs where JAX is not installed; run it
on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py imports JAX.)  The kernel is
held against its plain PyTorch version on the same card: per stream,
max |kernel - plain| / max |plain| <= 1e-4 (fp32; the two sum in another
order); residuals rtol 1e-3, atol 1e-4.  B2's gradient, per leaf: max
|kernel - plain| <= 1e-4 * max |plain| + 1e-6.  B3 against its plain
version: max |diff| <= 1e-6 * max |plain| per vector, through
``adam_update_flat`` and through the Adam phase's launcher (aligned and
unaligned vectors, and replayed from a CUDA graph).
"""

import math

import numpy as np
import pytest
import torch

from tpinn_torch.app import serve
from tpinn_torch.core import net, pde, taylor
from tpinn_torch.kernels import adam, mlp_taylor, taylor_vjp
from tpinn_torch.utils import checkpoint, profiling

IDX5 = [(), (0,), (1,), (0, 0), (1, 1)]
IDX6 = IDX5 + [(0, 1)]
TWO_PI = 2.0 * math.pi

# (spec kwargs, kinds, pad_to, lb, ub, streams, n points)
CASES = {
    "annulus-6x80-ragged": (dict(depth=6, width=80), ("minmax", "periodic"), 0,
                            (0.1, 0.0), (1.0, TWO_PI), IDX5, 4_099),
    # B2 cannot keep this net's gradient in shared memory: per-tile sums in
    # device memory
    "annulus-6x128-global": (dict(depth=6, width=128), ("minmax", "periodic"),
                             0, (0.1, 0.0), (1.0, TWO_PI), IDX5, 3_001),
    # too wide for the whole of a layer's W in shared memory: W in chunks
    "annulus-3x256-w-chunked": (dict(depth=3, width=256),
                                ("minmax", "periodic"), 0, (0.1, 0.0),
                                (1.0, TWO_PI), IDX5, 2_003),
    "sin-first-pad_to-3": (dict(depth=3, width=40, act_first="sin", scl=3.0,
                                epsil=0.5), ("minmax", "minmax"), 3,
                           (0.0, 0.0), (1.0, 1.0), IDX6, 1_000),
    "3-coordinates": (dict(depth=3, width=48, act_hidden="sin"),
                      ("minmax", "periodic", "identity"), 0,
                      (0.0, 0.0, -1.0), (1.0, TWO_PI, 1.0),
                      taylor.plan_streams([(i, j) for i in range(3)
                                           for j in range(i, 3)]), 2_053),
}


# kernel B1 only, with the W mode its plan must choose: heat_2d's recipe
# net (each layer's W staged per tile) and the widest net the kernel
# takes at S = 10 (W read through L1, the row stride without its padding)
B1_CASES = {
    "heat_2d-6x96-layer": (dict(depth=6, width=96), ("minmax", "minmax"), 3,
                           (0.0, 0.0), (1.0, 1.0), [(), (0,), (1,), (0, 0)],
                           2_003, "layer"),
    "widest-2x724-S10-l1": (dict(depth=2, width=724, scl=1.3, epsil=0.7),
                            ("minmax", "periodic", "identity"), 0,
                            (0.0, 0.0, -1.0), (1.0, TWO_PI, 1.0),
                            taylor.plan_streams([(i, j) for i in range(3)
                                                 for j in range(i, 3)]),
                            1_001, "l1"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel B1 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _setup(name, dev):
    spec_kw, kinds, pad_to, lb, ub, streams, n = CASES[name]
    spec = net.MLPSpec(**spec_kw)
    fm = net.feature_map_for(kinds, pad_to=pad_to)
    gen = torch.Generator().manual_seed(0)
    params = net.init_params(gen, spec, fm, dev)
    lo, hi = torch.tensor(lb), torch.tensor(ub)
    z = (lo + torch.rand((n, len(lb)), generator=gen) * (hi - lo)).to(dev)
    return params, z, spec, fm, lb, ub, streams


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(cuda_device, name):
    params, z, spec, fm, lb, ub, streams = _setup(name, cuda_device)
    before = mlp_taylor.LAUNCHES
    got = mlp_taylor.taylor2_streams(params, z, spec, fm, lb, ub, streams)
    torch.cuda.synchronize()
    assert mlp_taylor.LAUNCHES == before + 1
    ref = mlp_taylor.taylor2_streams_reference(params, z, spec, fm, lb, ub,
                                               streams)
    assert got.shape == ref.shape == (z.shape[0], len(streams))
    rel = (got - ref).abs().amax(dim=0) / ref.abs().amax(dim=0)
    assert float(rel.max()) <= 1e-4, rel


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(B1_CASES))
def test_kernel_in_every_w_mode_on_card(cuda_device, name):
    *case, mode = B1_CASES[name]
    spec_kw, kinds, pad_to, lb, ub, streams, n = case
    spec = net.MLPSpec(**spec_kw)
    fm = net.feature_map_for(kinds, pad_to=pad_to)
    gen = torch.Generator().manual_seed(0)
    params = net.init_params(gen, spec, fm, cuda_device)
    lo, hi = torch.tensor(lb), torch.tensor(ub)
    z = (lo + torch.rand((n, len(lb)), generator=gen) * (hi - lo)).to(
        cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    dims = [fm.num_features] + [spec.width] * spec.depth + [1]
    assert mlp_taylor.tiling(dims, len(streams), n, sms).w_mode == mode
    before = mlp_taylor.LAUNCHES
    got = mlp_taylor.taylor2_streams(params, z, spec, fm, lb, ub, streams)
    torch.cuda.synchronize()
    assert mlp_taylor.LAUNCHES == before + 1
    ref = mlp_taylor.taylor2_streams_reference(params, z, spec, fm, lb, ub,
                                               streams)
    rel = (got - ref).abs().amax(dim=0) / ref.abs().amax(dim=0)
    assert float(rel.max()) <= 1e-4, rel


@pytest.mark.cuda
def test_kernel_refuses_on_card(cuda_device):
    params, z, spec, fm, lb, ub, streams = _setup("annulus-6x80-ragged",
                                                  cuda_device)
    with pytest.raises(TypeError):
        mlp_taylor.taylor2_streams(params, z.double(), spec, fm, lb, ub,
                                   streams)
    cpu_params = {"layers": [{k: v.cpu() for k, v in layer.items()}
                             for layer in params["layers"]]}
    with pytest.raises(ValueError, match="float32 on"):
        mlp_taylor.taylor2_streams(cpu_params, z, spec, fm, lb, ub, streams)


@pytest.mark.cuda
def test_hard_bc_residual_on_card_matches_cpu(cuda_device, tmp_path):
    """The served residual on the card (kernel B1 + product rule + the
    AST with CPU literals) against the same server on the CPU."""
    fm = net.feature_map_for(("minmax", "periodic"))
    spec = net.MLPSpec(depth=6, width=80)
    params = net.init_params(torch.Generator().manual_seed(1), spec, fm, "cpu")
    path = tmp_path / "params_stage_1.npz"
    checkpoint.save_pytree(path, params, meta={
        "stage": 1, "problem": "annulus_laplace",
        "chain": [net.spec_to_dict(spec)],
        "feature_kinds": ["minmax", "periodic"], "lb": [0.1, 0.0],
        "ub": [1.0, TWO_PI], "coords": ["r", "t"], "pad_features": 0,
        "hard_bc": ["(1 - r)/0.9", "(r - 0.1)*(1 - r)"], "deflation": None})
    on_card = serve.PINNServer(str(path), "annulus_laplace", device=cuda_device)
    on_cpu = serve.PINNServer(str(path), "annulus_laplace", device="cpu")
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(0.1, 1.0, 3000),
                    rng.uniform(0.0, TWO_PI, 3000)], axis=1).tolist()
    before = mlp_taylor.LAUNCHES
    f_card = on_card.residual(pts)
    assert mlp_taylor.LAUNCHES == before + 1
    np.testing.assert_allclose(f_card, on_cpu.residual(pts), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(on_card.predict(pts), on_cpu.predict(pts),
                               rtol=1e-5, atol=1e-6)
    # a constant coordinate expression lands on the points' device
    zero = pde.compile_coord_expr("0", ("r", "t"))
    out = zero(torch.zeros(4, 2, device=cuda_device))
    assert out.device.type == "cuda" and out.shape == (4, 1)


def _leaves(params):
    return [t for layer in params["layers"] for t in (layer["w"], layer["b"])]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_backward_kernel_matches_plain_on_card(cuda_device, name):
    params, z, spec, fm, lb, ub, streams = _setup(name, cuda_device)
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    ct = torch.randn((z.shape[0], len(streams)),
                     generator=torch.Generator().manual_seed(3)).to(z.device)
    before = (mlp_taylor.LAUNCHES, taylor_vjp.LAUNCHES)
    out = taylor_vjp.kernel_streams(params, z, spec, fm, lb, ub, streams)
    got = torch.autograd.grad((out * ct).sum(), leaves)
    again = torch.autograd.grad(
        (taylor_vjp.kernel_streams(params, z, spec, fm, lb, ub, streams)
         * ct).sum(), leaves)
    torch.cuda.synchronize()
    assert (mlp_taylor.LAUNCHES - before[0],
            taylor_vjp.LAUNCHES - before[1]) == (2, 2)
    # the rows of the partial buffer are summed in a fixed order
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    layers = [{k: v.detach() for k, v in layer.items()}
              for layer in params["layers"]]
    ref = _leaves({"layers": taylor_vjp.taylor2_backward_reference(
        layers, z, ct, spec, fm, lb, ub, streams)})
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-6
    with pytest.raises(ValueError, match="requires_grad"):
        taylor_vjp.kernel_streams(params, z.clone().requires_grad_(True), spec,
                                  fm, lb, ub, streams)


@pytest.mark.cuda
def test_kernel_spans_once_a_launch_on_card(cuda_device, tmp_path):
    """Under a profiler, each B1 forward opens one ``b1.launch`` and each
    B2 backward (on autograd's device thread) one ``b2.launch``."""
    params, z, spec, fm, lb, ub, streams = _setup("annulus-6x80-ragged",
                                                  cuda_device)
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    with profiling.trace(str(tmp_path / "prof")) as prof:
        for _ in range(2):
            out = taylor_vjp.kernel_streams(params, z, spec, fm, lb, ub,
                                            streams)
            torch.autograd.grad(out.sum(), leaves)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU]
    assert (names.count("b1.launch"), names.count("b2.launch")) == (2, 2)


@pytest.mark.cuda
def test_adam_kernel_matches_plain_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    n = 4_099
    p = torch.randn(n, generator=gen, device=cuda_device)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    lr = torch.full((1,), 1e-2, device=cuda_device)
    pr, mr, vr, lr_r = p.clone(), m.clone(), v.clone(), lr.clone()
    before = adam.LAUNCHES
    for t in range(1, 201):
        if t == 101:
            lr.mul_(0.5)
            lr_r.mul_(0.5)
        g = torch.randn(n, generator=gen, device=cuda_device)
        adam.adam_update_flat(g, p, m, v, lr, t)
        adam.adam_update_reference(g, pr, mr, vr, lr_r, t)
    torch.cuda.synchronize()
    assert adam.LAUNCHES == before + 200
    for a, b in ((p, pr), (m, mr), (v, vr)):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    with pytest.raises(TypeError):
        adam.adam_update_flat(g.double(), p.double(), m.double(), v.double(),
                              lr.double(), 1)


def _adam_vectors(dev, n, offset, gen):
    """p, m, v as views at ``offset`` floats into buffers of their own (an
    offset of 1 leaves them 4 bytes off 16-byte alignment)."""
    def at(x):
        buf = torch.zeros(n + offset, device=dev)
        buf[offset:] = x
        return buf[offset:]
    return (at(torch.randn(n, generator=gen, device=dev)),
            at(torch.zeros(n, device=dev)), at(torch.zeros(n, device=dev)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(4_099, 0), (4_099, 1), (140_003, 0),
                                      (140_003, 1)])
def test_adam_launcher_matches_plain_on_card(cuda_device, n, offset):
    """The Adam phase's launcher over 200 steps, lr halved at step 101,
    against the plain version: one element a thread (4,099), past one
    grid of a 132-SM card so that the threads loop (140,003), on aligned
    vectors and on views one float off alignment; the step counted on the
    device."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    p, m, v = _adam_vectors(cuda_device, n, offset, gen)
    assert (p.data_ptr() % 16 == 0) == (offset == 0)
    lr = torch.full((1,), 1e-2, device=cuda_device)
    pr, mr, vr, lr_r = p.clone(), m.clone(), v.clone(), lr.clone()
    launcher = adam.FusedAdam(p, m, v, lr, 200)
    before = adam.LAUNCHES
    for t in range(1, 201):
        if t == 101:
            lr.mul_(0.5)
            lr_r.mul_(0.5)
        g = torch.randn(n, generator=gen, device=cuda_device)
        launcher.step(g)
        adam.adam_update_reference(g, pr, mr, vr, lr_r, t)
    torch.cuda.synchronize()
    assert adam.LAUNCHES == before + 200
    assert launcher.t == 201
    for a, b in ((p, pr), (m, mr), (v, vr)):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    with pytest.raises(ValueError, match="past the last step"):
        launcher.step(g)
    with pytest.raises(ValueError, match="contiguous 1-D"):
        launcher.step(g.cpu())


@pytest.mark.cuda
def test_adam_launcher_graph_replay_on_card(cuda_device):
    """Ten launcher steps captured in one CUDA graph, replayed three times
    with a new gradient each time and lr halved between the first and the
    second replay, against 30 plain steps; the step counted on the device
    reads 31, and the capture counts no launch.  A fourth replay runs past
    the launcher's table: it updates nothing and the device step raises."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    n = 32_801
    p, m, v = _adam_vectors(cuda_device, n, 0, gen)
    lr = torch.full((1,), 1e-3, device=cuda_device)
    grads = [torch.randn(n, generator=gen, device=cuda_device)
             for _ in range(3)]
    pr, mr, vr, lr_r = p.clone(), m.clone(), v.clone(), lr.clone()
    launcher = adam.FusedAdam(p, m, v, lr, 30)
    g_static = torch.empty_like(p)
    graph = torch.cuda.CUDAGraph()
    before = adam.LAUNCHES
    with torch.cuda.graph(graph):
        for _ in range(10):
            launcher.step(g_static)
    torch.cuda.synchronize()
    assert launcher.t == 1                  # capture launched nothing
    assert adam.LAUNCHES == before
    for k, g in enumerate(grads):
        if k == 1:
            lr.mul_(0.5)
        g_static.copy_(g)
        graph.replay()
    for t in range(1, 31):
        if t == 11:
            lr_r.mul_(0.5)
        adam.adam_update_reference(grads[(t - 1) // 10], pr, mr, vr, lr_r, t)
    torch.cuda.synchronize()
    assert launcher.t == 31
    for a, b in ((p, pr), (m, mr), (v, vr)):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    kept = [x.clone() for x in (p, m, v)]
    graph.replay()                          # steps 31-40: past the table
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((p, m, v), kept))
    with pytest.raises(RuntimeError, match="past the last step"):
        launcher.t
    with pytest.raises(RuntimeError, match="past the last step"):
        launcher.step(g_static)


@pytest.mark.cuda
def test_polish_on_the_card_matches_the_cpu(cuda_device):
    """The float64 post-processing on the card against the same calls on
    the CPU: the last-layer solve (new output layer rtol 1e-7, objective
    rtol 1e-8), the Galerkin correction of a hard-BC annulus net (same
    kind and modes, coefficients rtol 1e-6) and its term in float32."""
    from tpinn_torch.core import polish

    spec = net.MLPSpec(depth=3, width=24, scl=1.3, epsil=0.9)
    fm = net.feature_map_for(("minmax", "periodic"))
    lo, hi = (0.1, 0.0), (1.0, TWO_PI)
    compiled = pde.compile_pde("u_rr + 1/r*u_r + 1/r**2*u_tt", ("r", "t"))
    g = 65
    results = {}
    for dev in (torch.device("cpu"), cuda_device):
        params = net.init_params(torch.Generator().manual_seed(3), spec, fm, dev)
        pred = net.wrap_hard_bc(
            net.make_predictor(spec, fm, torch.tensor(lo, device=dev),
                               torch.tensor(hi, device=dev)),
            pde.compile_coord_expr("(1 - r)/0.9", ("r", "t")),
            pde.compile_coord_expr("(r - 0.1)*(1 - r)", ("r", "t")))
        R, T = torch.meshgrid(torch.linspace(0.1, 1.0, g),
                              torch.linspace(0.0, TWO_PI, g), indexing="xy")
        data = {"x_col": torch.stack([R.reshape(-1), T.reshape(-1)],
                                     dim=1).to(dev), "x_bd": [], "u_bd": []}
        new, info = polish.last_layer_lsq(pred, compiled, params, data, 0.05)
        assert info["applied"] and new["layers"][-1]["w"].device.type == dev.type
        defl = polish.galerkin_defect(pred, new, compiled, lo, hi,
                                      ["dirichlet", "periodic"], n_grid=41,
                                      max_sin=5, max_fourier=3, drop_tol=1.0)
        z = torch.stack([R.reshape(-1), T.reshape(-1)], dim=1)[::7].to(dev)
        results[dev.type] = (info, new["layers"][-1]["w"].cpu().numpy(), defl,
                             polish.deflation_term(defl)(z).cpu().numpy())
    (i_c, w_c, d_c, t_c), (i_g, w_g, d_g, t_g) = results["cpu"], results["cuda"]
    np.testing.assert_allclose(i_g["pre"], i_c["pre"], rtol=1e-8)
    np.testing.assert_allclose(i_g["post"], i_c["post"], rtol=1e-8)
    np.testing.assert_allclose(w_g, w_c, rtol=1e-7, atol=1e-7 * np.abs(w_c).max())
    assert d_g["kind"] == d_c["kind"] == "galerkin"
    assert d_g["modes"] == d_c["modes"]
    np.testing.assert_allclose(d_g["coeffs"], d_c["coeffs"], rtol=1e-6,
                               atol=1e-9 * np.abs(d_c["coeffs"]).max())
    np.testing.assert_allclose(t_g, t_c, rtol=0, atol=1e-6 * np.abs(t_c).max()
                               + 1e-9)


@pytest.mark.cuda
def test_inverse_loss_gradient_on_card_matches_generic_engine(cuda_device):
    """The scalar inverse loss (heat diffusivity, "u_t - lam*u_xx", three
    BC groups and observations) on the card: its gradient through B1/B2
    (the coefficient multiplying B1's streams inside the expression)
    against the same loss through the generic engine, per net leaf and for
    lam: |kernel - generic| <= 2e-5 + 2e-3 |generic| (fp32, the kernels
    and the nested jvp passes sum in another order)."""
    from tpinn_torch.core.inverse import make_inverse_loss

    dev = cuda_device
    spec = net.MLPSpec(depth=4, width=32)
    fm = net.feature_map_for(("minmax", "minmax"), pad_to=3)
    lb, ub = (0.0, 0.0), (1.0, 1.0)
    pred = net.make_predictor(spec, fm, torch.tensor(lb, device=dev),
                              torch.tensor(ub, device=dev))
    generic = lambda p, z: pred(p, z)          # no structured partials
    compiled = pde.compile_pde("u_t - lam*u_xx", ("x", "t"), ("lam",))
    gen = torch.Generator().manual_seed(4)
    box = lambda n: torch.rand((n, 2), generator=gen).to(dev)
    z_obs = box(200)
    u_obs = torch.exp(-math.pi ** 2 * z_obs[:, 1:]) * torch.sin(
        math.pi * z_obs[:, :1])
    data = {"x_col": box(2_800), "x_bd": [box(100) for _ in range(3)],
            "u_bd": [torch.zeros((100, 1), device=dev) for _ in range(3)]}
    lw = torch.tensor([1.0, 0.0], device=dev)
    ref = torch.tensor(0.7, device=dev)
    grads = {}
    for name, p in (("kernel", pred), ("generic", generic)):
        params = net.init_params(torch.Generator().manual_seed(0), spec, fm,
                                 dev)
        lam = torch.tensor(0.3, device=dev, requires_grad=True)
        leaves = [x.requires_grad_(True) for layer in params["layers"]
                  for x in (layer["w"], layer["b"])]
        loss_fn = make_inverse_loss(p, compiled, z_obs, u_obs)
        before = (mlp_taylor.LAUNCHES, taylor_vjp.LAUNCHES)
        loss_n, info = loss_fn({"net": params, "coef": {"lam": lam}}, data,
                               lw, ref)
        grads[name] = torch.autograd.grad(loss_n, leaves + [lam])
        torch.cuda.synchronize()
        grew = (mlp_taylor.LAUNCHES - before[0],
                taylor_vjp.LAUNCHES - before[1])
        assert grew == ((1, 1) if name == "kernel" else (0, 0)), grew
    assert float(grads["kernel"][-1].abs()) > 0.0
    for k, (a, b) in enumerate(zip(grads["kernel"], grads["generic"])):
        assert bool(((a - b).abs() <= 2e-5 + 2e-3 * b.abs()).all()), (
            k, float((a - b).abs().max()), float(b.abs().max()))


@pytest.mark.cuda
def test_patched_residual_on_card_matches_cpu(cuda_device):
    """The patched predictor (36 stacked 2x16 nets, 6x6 patches on 3
    padded features) on the card against the same on the CPU: /predict in
    float32 (rtol 1e-5, atol 1e-6), the Helmholtz residual through the
    generic engine in float64 (rtol 1e-4; in float32 the windows' 1/h²
    against k² u cancel), B1 launched no time."""
    from tpinn_torch.core.patch import (PatchSpec, init_patch_params,
                                        make_patch_predictor)

    mspec = net.MLPSpec(depth=2, width=16)
    patch = PatchSpec(n=(6, 6))
    eq = "u_xx + u_yy + 400.0*u + 400.0*sin(20.0*x)*sin(20.0*y)"
    compiled = pde.compile_pde(eq, ("x", "y"))
    z = torch.rand((2_000, 2), generator=torch.Generator().manual_seed(3))
    out = {}
    for dev in ("cpu", cuda_device):
        for dtype in (torch.float32, torch.float64):
            pred = make_patch_predictor(mspec, patch, (0.0, 0.0), (1.0, 1.0),
                                        dtype, 3, dev)
            params = init_patch_params(torch.Generator().manual_seed(0),
                                       mspec, patch, dtype, 3, dev)
            zz = z.to(dev, dtype)
            before = mlp_taylor.LAUNCHES
            with torch.no_grad():
                out[str(dev), dtype] = (
                    pred(params, zz).cpu(),
                    compiled.residual_fast(pred, params, zz).cpu())
            assert mlp_taylor.LAUNCHES == before
    card, cpu = str(cuda_device), "cpu"
    np.testing.assert_allclose(out[card, torch.float32][0],
                               out[cpu, torch.float32][0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out[card, torch.float64][1],
                               out[cpu, torch.float64][1], rtol=1e-4)


@pytest.mark.cuda
def test_calculator_sessions_on_card(cuda_device, tmp_path):
    """The calculator's controller on the card: tests/test_app.py's tiny
    request (the polar demo at 2x16) through SessionManager(device=
    "cuda") launches B1, B2 and B3, writes the 11 artifacts and ends
    done; two sessions started together, adam_precision "default" and
    "highest", take turns and leave allow_tf32 as they found it."""
    from tpinn_torch.app.controller import SessionManager, TrainingRequest
    from tpinn_torch.app.figure_data import FIGURES, figure_payload

    bc = {"bd_x1_min": 0.1, "bd_x1_max": 0.1, "bd_y1_min": 0,
          "bd_y1_max": 1, "bd_u1": 1, "bd_x2_min": 1, "bd_x2_max": 1,
          "bd_y2_min": 0, "bd_y2_max": 1, "bd_u2": 0}

    def request(**options):
        return TrainingRequest(
            equation="u_rr + 1/r*u_r + 1/r**2*u_tt", boundary=bc,
            domain={"x_min": 0.1, "x_max": 1, "y_min": 0, "y_max": 1},
            sample_points={"n_col": 120, "n_bd": 30, "n_add": 30},
            network_size={"depth": 16, "width": 2},
            testing_size={"x": 31, "y": 31},
            epochs={"adam": 25, "lbfgs": 12}, options=options)

    def finish(sid):
        mgr.get(sid).thread.join(timeout=600)
        st = mgr.status(sid)
        assert st["status"] == "done", (st["error"], st["log"][-800:])
        return st["log"]

    mgr = SessionManager(str(tmp_path), device="cuda")
    mlp_taylor.LAUNCHES = taylor_vjp.LAUNCHES = adam.LAUNCHES = 0
    assert mgr.start("demo", request()) is None
    finish("demo")
    assert min(mlp_taylor.LAUNCHES, taylor_vjp.LAUNCHES, adam.LAUNCHES) > 0
    for name in FIGURES:
        assert figure_payload(tmp_path / "demo", name)["type"] != "missing"

    before = torch.backends.cuda.matmul.allow_tf32
    for sid, prec in (("a", "default"), ("b", "highest")):
        assert mgr.start(sid, request(adam_precision=prec)) is None
    logs = [finish(sid) for sid in ("a", "b")]
    assert sum("waiting for the device" in log for log in logs) == 1
    assert torch.backends.cuda.matmul.allow_tf32 == before


@pytest.mark.cuda
def test_midstage_resume_on_card_bit_exact(cuda_device, tmp_path,
                                           monkeypatch):
    """A run_training on the card (B1, B2, B3) killed after its step-100
    phase file and resumed ends bit for bit where the uninterrupted run
    ends, the draws and density refreshes inside the resumed window."""
    from tpinn_torch import problems
    from tpinn_torch.core import optim, train

    st = train.StageSpec(depth=2, width=16, scl=1.0, epsil=1.0,
                         adam_epochs=200, lbfgs_epochs=30)
    spec = train.TrainSpec(
        n_col=128, n_band=32, n_adaptive=32, n_bd=16, testing_size=(64,),
        lw=(1.0, 0.0), grid=41, stages=(st,), resample_every=30,
        density_every=40, plateau_every=60, tail_max=20, log_every=5,
        checkpoint_every=50)

    def run(out, **kw):
        return train.run_training(problems.poisson_1d(), spec,
                                  output_dir=str(out), device="cuda", **kw)

    mlp_taylor.LAUNCHES = taylor_vjp.LAUNCHES = adam.LAUNCHES = 0
    res_a = run(tmp_path / "a")
    assert min(mlp_taylor.LAUNCHES, taylor_vjp.LAUNCHES, adam.LAUNCHES) > 0
    orig = checkpoint.save_phase_state

    def killer(path, done, state, hist, layout):
        orig(path, done, state, hist, layout)
        if done >= 100:
            raise KeyboardInterrupt

    monkeypatch.setattr(checkpoint, "save_phase_state", killer)
    with pytest.raises(KeyboardInterrupt):
        run(tmp_path / "b")
    monkeypatch.setattr(checkpoint, "save_phase_state", orig)
    lines = []
    res_b = run(tmp_path / "b", resume=True, log_fn=lines.append)
    assert "stage 1: resuming Adam mid-stage at step 100/200" in lines
    np.testing.assert_array_equal(res_b.history, res_a.history)
    for a, b in zip(optim.tree_leaves(res_a.stages[0].params),
                    optim.tree_leaves(res_b.stages[0].params)):
        assert torch.equal(a, b)
