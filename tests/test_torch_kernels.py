"""Kernels B1, B2 and B3 (tpinn_torch.kernels) against the JAX Pallas kernels.

On the CPU the wrapper runs its plain version; both it and
``taylor2_streams_reference`` are held against
``tpinn.kernels.mlp_taylor.taylor2_streams_pallas`` in interpret mode (as
tests/test_kernels.py runs it) on the same numpy-seeded weights and
points, and against JAX's f32 engine ``tpinn.core.taylor.taylor2_mlp``.
Tolerances: rtol 1e-4, atol 1e-5 for the streams; rtol 1e-3, atol 1e-4
for residuals (1/r² multiplies u_tt by 100 at r = 0.1).  The Pallas
kernel's dots are a three-pass bf16 split (dot_f32) whose own error
against JAX's f32 engine is close to that atol: the 3-coordinate case
runs at width 16, where it stays inside (at width 24 one stream value of
the Pallas kernel is 1.1e-5 off JAX's f32 engine).

B2's plain version ``taylor2_backward_reference`` is held against
``tpinn.kernels.taylor_vjp.taylor2_backward_pallas`` in interpret mode with
the JAX tests' tolerance (rtol 2e-3, atol 2e-5), and against autograd
through ``taylor.taylor2_mlp`` in float64 (rtol 1e-10).  The autograd
Function (B1 forward, B2 backward) is checked with B1's launcher replaced
by a gradient-less call, as the CUDA launch is.  B3's plain version is
held against ``optax.adam`` (rtol 1e-5, atol 1e-7, as
tests/test_kernels.py holds the Pallas Adam), through ``adam_update_flat``
and through the Adam phase's launcher ``FusedAdam`` (its plain path, over
200 steps with an lr change, also against the Pallas Adam in interpret
mode); the launcher's bias table is held against ``_constants`` bitwise.

The CUDA kernel itself runs only on a card: its tests are in
tests/test_torch_cuda.py (marked ``cuda``; they skip without a card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.core import net as jnet
from tpinn.core import pde as jpde
from tpinn.core import taylor as jtaylor
from tpinn.kernels import mlp_taylor as jmt
from tpinn_torch.core import net as tnet
from tpinn_torch.core import pde as tpde
from tpinn_torch.core import taylor as ttaylor
from tpinn_torch.kernels import adam as tadam
from tpinn_torch.kernels import mlp_taylor as tmt
from tpinn_torch.kernels import taylor_vjp as tvjp
from tpinn_torch.utils.convert import params_from_numpy

RTOL, ATOL = 1e-4, 1e-5
IDX5 = [(), (0,), (1,), (0, 0), (1, 1)]
IDX6 = IDX5 + [(0, 1)]
ALL3 = [(i, j) for i in range(3) for j in range(i, 3)]
LAPLACE = "u_rr + 1/r*u_r + 1/r**2*u_tt"

# (act_first, kinds, pad_to, n points, Pallas block, indices, width)
CASES = {
    "tanh-minmax-periodic": ("tanh", ("minmax", "periodic"), 0, 300, 128,
                             IDX6, 24),
    "sin-minmax-minmax": ("sin", ("minmax", "minmax"), 0, 300, 128, IDX5, 24),
    "pad_to-3": ("sin", ("minmax", "minmax"), 3, 256, 128, IDX6, 24),
    "partial-block": ("tanh", ("minmax", "periodic"), 0, 77, 64, [(0, 0)], 24),
    "3-coordinates": ("tanh", ("minmax", "periodic", "identity"), 0, 200,
                      128, ALL3, 16),
}


def _case(name, depth=3, width=None):
    act, kinds, pad_to, n, block, idx, case_width = CASES[name]
    width = width or case_width
    d = len(kinds)
    lb = (0.1, 0.0, -1.0)[:d]
    ub = (1.0, 2 * np.pi, 1.0)[:d]
    fm_j = jnet.feature_map_for(kinds, pad_to=pad_to)
    spec_j = jnet.MLPSpec(depth=depth, width=width, act_first=act, scl=1.5,
                          epsil=0.8)
    p_j = jnet.init_params(jax.random.PRNGKey(0), spec_j, fm_j)
    z = np.random.default_rng(1).uniform(lb, ub, (n, d)).astype(np.float32)
    return dict(
        p_j=p_j, spec_j=spec_j, fm_j=fm_j, lb=lb, ub=ub, z=z, block=block,
        streams=jtaylor.plan_streams(idx),
        p_t=params_from_numpy(p_j, "cpu"),
        spec_t=tnet.spec_from_dict(jnet.spec_to_dict(spec_j)),
        fm_t=tnet.feature_map_for(kinds, pad_to=pad_to),
    )


def _pure(c):
    """JAX's f32 Taylor-2 engine, as [N, S] columns."""
    parts = jtaylor.taylor2_mlp(c["p_j"], jnp.asarray(c["z"]), c["spec_j"],
                                c["fm_j"], jnp.asarray(c["lb"]),
                                jnp.asarray(c["ub"]), c["streams"])
    return np.concatenate([np.asarray(parts[st]) for st in c["streams"]], 1)


def _pallas(c):
    return np.asarray(jmt.taylor2_streams_pallas(
        c["p_j"], jnp.asarray(c["z"]), c["spec_j"], c["fm_j"], c["lb"],
        c["ub"], c["streams"], block=c["block"], interpret=True))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_and_cpu_wrapper_match_pallas(name):
    c = _case(name)
    want = _pallas(c)
    pure = _pure(c)
    args = (c["p_t"], torch.from_numpy(c["z"]), c["spec_t"], c["fm_t"],
            c["lb"], c["ub"], c["streams"])
    before = tmt.LAUNCHES
    ref = tmt.taylor2_streams_reference(*args)
    got = tmt.taylor2_streams(*args)
    assert tmt.LAUNCHES == before   # a CPU tensor launches no kernel
    assert tuple(got.shape) == want.shape == (len(c["z"]), len(c["streams"]))
    for out in (ref, got):
        np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out.numpy(), pure, rtol=RTOL, atol=ATOL)


def test_kernel_dict_and_residual_match_jax():
    c = _case("tanh-minmax-periodic")
    zt = torch.from_numpy(c["z"])
    parts = tmt.taylor2_mlp_kernel(c["p_t"], zt, c["spec_t"], c["fm_t"],
                                   c["lb"], c["ub"], IDX5)
    want = jmt.taylor2_mlp_pallas(c["p_j"], jnp.asarray(c["z"]), c["spec_j"],
                                  c["fm_j"], c["lb"], c["ub"], IDX5,
                                  block=128, interpret=True)
    assert set(parts) == set(want)
    for ix in IDX5:
        assert tuple(parts[ix].shape) == (len(c["z"]), 1)
        np.testing.assert_allclose(parts[ix].numpy(), np.asarray(want[ix]),
                                   rtol=RTOL, atol=ATOL)

    pred_j = jnet.make_predictor(c["spec_j"], c["fm_j"], jnp.asarray(c["lb"]),
                                 jnp.asarray(c["ub"]))
    pred_t = tnet.make_predictor(c["spec_t"], c["fm_t"], torch.tensor(c["lb"]),
                                 torch.tensor(c["ub"]))
    f_j = jmt.residual_kernel_fn(pred_j, jpde.compile_pde(LAPLACE, ("r", "t")),
                                 interpret=True)(c["p_j"], jnp.asarray(c["z"]))
    f_t = tmt.residual_kernel_fn(pred_t, tpde.compile_pde(LAPLACE, ("r", "t")))(
        c["p_t"], zt)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-3,
                               atol=1e-4)


def test_out_of_scope_raises():
    c = _case("tanh-minmax-periodic")
    zt = torch.from_numpy(c["z"])
    base = (c["p_t"], zt, c["spec_t"], c["fm_t"], c["lb"], c["ub"])
    # periodic_fit: the Pallas kernel would treat it as identity
    # (tpinn/kernels/mlp_taylor.py:62-69); here it is refused
    fit = tnet.feature_map_for(("periodic_fit", "minmax"))
    with pytest.raises(ValueError, match="periodic_fit"):
        tmt.taylor2_streams(c["p_t"], zt, c["spec_t"], fit, c["lb"], c["ub"],
                            IDX5)
    with pytest.raises(ValueError, match="periodic_fit"):
        tmt.taylor2_streams_reference(c["p_t"], zt, c["spec_t"], fit,
                                      c["lb"], c["ub"], IDX5)
    assert not tmt.supports(c["spec_t"], fit)
    # order 3
    with pytest.raises(ValueError, match="order"):
        tmt.taylor2_mlp_kernel(*base, [(0, 0, 1)])
    with pytest.raises(ValueError, match="order"):
        tmt.taylor2_streams(*base, [(), (0,), (0, 0, 0)])
    # a pair without its first-derivative streams, value not first
    with pytest.raises(ValueError, match="needs"):
        tmt.taylor2_streams(*base, [(), (0, 0)])
    with pytest.raises(ValueError, match="first"):
        tmt.taylor2_streams(*base, [(0,), ()])
    # dtype, layout, family, output width
    with pytest.raises(TypeError):
        tmt.taylor2_streams(c["p_t"], zt.double(), *base[2:], IDX5)
    with pytest.raises(ValueError, match="contiguous"):
        tmt.taylor2_streams(c["p_t"], zt.t().contiguous().t(), *base[2:], IDX5)
    wide = tnet.MLPSpec(depth=3, width=24, out_dim=2)
    with pytest.raises(ValueError, match="scalar"):
        tmt.taylor2_streams(c["p_t"], zt, wide, *base[3:], IDX5)
    assert not tmt.supports(wide, c["fm_t"])
    with pytest.raises(ValueError, match="runs on CUDA"):
        tmt.taylor2_streams(c["p_t"], zt.to("meta"), *base[2:], IDX5)


# ---------------------------------------------------------------------------
# Kernel B2 (taylor_vjp) and its autograd Function
# ---------------------------------------------------------------------------

B2_CASES = ("tanh-minmax-periodic", "sin-minmax-minmax", "pad_to-3",
            "partial-block")


def _leaves(params):
    return [t for layer in params["layers"] for t in (layer["w"], layer["b"])]


def _ct(c, seed=5):
    """A cotangent on the stream columns, scaled by 1/N as the gradient of
    a mean over the points is (the regime of tests/test_kernels.py)."""
    n, s = len(c["z"]), len(c["streams"])
    return (np.random.default_rng(seed).standard_normal((n, s)) / n).astype(
        np.float32)


@pytest.mark.parametrize("name", B2_CASES)
def test_backward_plain_matches_pallas(name):
    from tpinn.kernels import taylor_vjp as jvjp

    c = _case(name)
    ct = _ct(c)
    want = jvjp.taylor2_backward_pallas(
        c["p_j"]["layers"], jnp.asarray(c["z"]), jnp.asarray(ct), c["spec_j"],
        c["fm_j"], c["lb"], c["ub"], c["streams"], block=c["block"],
        interpret=True)
    args = (c["p_t"]["layers"], torch.from_numpy(c["z"]), torch.from_numpy(ct),
            c["spec_t"], c["fm_t"], c["lb"], c["ub"], c["streams"])
    before = tvjp.LAUNCHES
    got = tvjp.taylor2_backward(*args)
    assert tvjp.LAUNCHES == before       # a CPU tensor launches no kernel
    ref = tvjp.taylor2_backward_reference(*args)
    for g_layer, r_layer, w_layer in zip(got, ref, want):
        for k in ("w", "b"):
            assert torch.equal(g_layer[k], r_layer[k])
            np.testing.assert_allclose(g_layer[k].numpy(),
                                       np.asarray(w_layer[k]), rtol=2e-3,
                                       atol=2e-5)


def _f64_case(name):
    c = _case(name)
    p64 = params_from_numpy(c["p_j"], "cpu", torch.float64)
    z64 = torch.from_numpy(c["z"]).double()
    lb = torch.tensor(c["lb"], dtype=torch.float64)
    ub = torch.tensor(c["ub"], dtype=torch.float64)
    return c, p64, z64, lb, ub


@pytest.mark.parametrize("name", ["tanh-minmax-periodic", "sin-minmax-minmax",
                                  "partial-block", "3-coordinates"])
def test_backward_plain_matches_autograd_f64(name):
    c, p64, z64, lb, ub = _f64_case(name)
    ct = torch.from_numpy(_ct(c)).double()
    leaves = [t.requires_grad_(True) for t in _leaves(p64)]
    parts = ttaylor.taylor2_mlp(p64, z64, c["spec_t"], c["fm_t"], lb, ub,
                                c["streams"])
    cols = torch.cat([parts[st] for st in c["streams"]], dim=1)
    want = torch.autograd.grad((cols * ct).sum(), leaves)
    layers = [{k: v.detach() for k, v in layer.items()}
              for layer in p64["layers"]]
    got = _leaves({"layers": tvjp.taylor2_backward_reference(
        layers, z64, ct, c["spec_t"], c["fm_t"], c["lb"], c["ub"],
        c["streams"])})
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


def _hard_fns():
    lift = tpde.compile_coord_expr("(1 - r)/0.9", ("r", "t"))
    bubble = tpde.compile_coord_expr("(r - 0.1)*(1 - r)", ("r", "t"))
    return lift, bubble


def test_backward_plain_under_hard_bc_product_rule_f64():
    """The residual-MSE gradient of a hard-BC net: the cotangent reaches
    the raw net's stream columns through the product rule, B2's plain
    version turns it into parameter gradients; autograd through
    taylor2_mlp under the same ansatz agrees to rtol 1e-10."""
    c, p64, z64, lb, ub = _f64_case("tanh-minmax-periodic")
    lift, bubble = _hard_fns()
    compiled = tpde.compile_pde(LAPLACE, ("r", "t"))
    streams = c["streams"]
    need = sorted({(), (0,), (1,)} | set(compiled.indices),
                  key=lambda t: (len(t), t))
    layers = [{k: v.detach() for k, v in layer.items()}
              for layer in p64["layers"]]
    cols = torch.cat([ttaylor.taylor2_mlp(
        {"layers": layers}, z64, c["spec_t"], c["fm_t"], lb, ub,
        streams)[st] for st in streams], dim=1).requires_grad_(True)

    def loss_of(raw_partials):
        parts = tnet.hard_bc_partials(raw_partials, lift, bubble)(
            None, z64, compiled.indices)
        return torch.mean(compiled.evaluate(z64, parts) ** 2)

    from_cols = lambda p, z, idx: {st: cols[:, k:k + 1]
                                   for k, st in enumerate(streams)}
    (ct,) = torch.autograd.grad(loss_of(from_cols), cols)
    got = _leaves({"layers": tvjp.taylor2_backward_reference(
        layers, z64, ct, c["spec_t"], c["fm_t"], c["lb"], c["ub"], streams)})

    leaves = [t.requires_grad_(True) for t in _leaves(p64)]
    via_autograd = lambda p, z, idx: ttaylor.taylor2_mlp(
        p64, z, c["spec_t"], c["fm_t"], lb, ub, need)
    want = torch.autograd.grad(loss_of(via_autograd), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


@pytest.fixture
def gradless_b1(monkeypatch):
    """B1's launcher replaced by a no-grad plain call: an output with no
    autograd node, as the CUDA launch gives.  Counts its calls."""
    calls = []
    plain = tmt.taylor2_streams_reference

    def launch(*args):
        with torch.no_grad():
            out = plain(*args)
        assert out.grad_fn is None and not out.requires_grad
        calls.append(out.shape)
        return out

    monkeypatch.setattr(tmt, "taylor2_streams", launch)
    return calls


def test_autograd_function_with_gradless_forward(gradless_b1):
    c = _case("tanh-minmax-periodic")
    zt = torch.from_numpy(c["z"])
    ct = torch.from_numpy(_ct(c))
    p = params_from_numpy(c["p_j"], "cpu")
    leaves = [t.requires_grad_(True) for t in _leaves(p)]
    out = tvjp.kernel_streams(p, zt, c["spec_t"], c["fm_t"], c["lb"], c["ub"],
                              c["streams"])
    assert gradless_b1 == [out.shape] and out.grad_fn is not None
    got = torch.autograd.grad((out * ct).sum(), leaves)
    parts = ttaylor.taylor2_mlp(p, zt, c["spec_t"], c["fm_t"],
                                torch.tensor(c["lb"]), torch.tensor(c["ub"]),
                                c["streams"])
    want = torch.autograd.grad(
        (torch.cat([parts[st] for st in c["streams"]], 1) * ct).sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-5)
    # no silent zero cotangent for the points, and no forward mode
    with pytest.raises(ValueError, match="requires_grad"):
        tvjp.kernel_streams(p, zt.clone().requires_grad_(True), c["spec_t"],
                            c["fm_t"], c["lb"], c["ub"], c["streams"])
    with pytest.raises(RuntimeError):
        torch.func.jvp(
            lambda z: tvjp.kernel_streams(p, z, c["spec_t"], c["fm_t"],
                                          c["lb"], c["ub"], c["streams"]),
            (zt,), (torch.ones_like(zt),))


def test_residual_gradient_on_the_card_route(gradless_b1, monkeypatch):
    """Repair: a float32 residual on the card's route (B1 with no autograd
    node) still carries the parameter gradient of tpinn's kernel engine,
    through the hard-BC product rule."""
    from tpinn.core import net as jnet_mod
    from tpinn.kernels.taylor_vjp import make_kernel_partials

    monkeypatch.setattr(ttaylor, "_kernel_route", lambda z: True)
    c = _case("tanh-minmax-periodic")
    zt = torch.from_numpy(c["z"])
    lift, bubble = _hard_fns()
    pred = tnet.wrap_hard_bc(
        tnet.make_predictor(c["spec_t"], c["fm_t"], torch.tensor(c["lb"]),
                            torch.tensor(c["ub"])), lift, bubble)
    compiled = tpde.compile_pde(LAPLACE, ("r", "t"))
    p = params_from_numpy(c["p_j"], "cpu")
    leaves = [t.requires_grad_(True) for t in _leaves(p)]
    f = compiled.residual_fast(pred, p, zt)
    assert gradless_b1, "the residual did not take B1's route"
    got = torch.autograd.grad(torch.mean(f ** 2), leaves)

    cj = jpde.compile_pde(LAPLACE, ("r", "t"))
    lift_j = jpde.compile_coord_expr("(1 - r)/0.9", ("r", "t"))
    bubble_j = jpde.compile_coord_expr("(r - 0.1)*(1 - r)", ("r", "t"))
    kp = jnet_mod.hard_bc_partials(
        make_kernel_partials(c["spec_j"], c["fm_j"], c["lb"], c["ub"],
                             ((), (0,), (1,), (0, 0), (1, 1)), block=128,
                             interpret=True), lift_j, bubble_j)
    z = jnp.asarray(c["z"])
    want = jax.grad(lambda q: jnp.mean(cj.evaluate(
        z, kp(q, z, cj.indices)) ** 2))(c["p_j"])
    want = [a for layer in want["layers"] for a in (layer["w"], layer["b"])]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=3e-5)


def test_float64_residual_fast_matches_tpinn():
    """Repair: a float64 residual goes to the generic engine (tpinn's f64
    route) instead of raising in B1's float32 check."""
    from tpinn.utils.x64 import force_x64

    c = _case("tanh-minmax-periodic")
    lift, bubble = _hard_fns()
    pred_t = tnet.wrap_hard_bc(
        tnet.make_predictor(c["spec_t"], c["fm_t"],
                            torch.tensor(c["lb"], dtype=torch.float64),
                            torch.tensor(c["ub"], dtype=torch.float64)),
        lift, bubble)
    p64 = params_from_numpy(c["p_j"], "cpu", torch.float64)
    z64 = torch.from_numpy(c["z"]).double()
    got = tpde.compile_pde(LAPLACE, ("r", "t")).residual_fast(pred_t, p64, z64)
    assert got.dtype == torch.float64
    with force_x64():
        pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    c["p_j"])
        pred_j = jnet.wrap_hard_bc(
            jnet.make_predictor(c["spec_j"], c["fm_j"],
                                jnp.asarray(c["lb"], jnp.float64),
                                jnp.asarray(c["ub"], jnp.float64)),
            jpde.compile_coord_expr("(1 - r)/0.9", ("r", "t")),
            jpde.compile_coord_expr("(r - 0.1)*(1 - r)", ("r", "t")))
        want = np.asarray(jpde.compile_pde(LAPLACE, ("r", "t")).residual_fast(
            pred_j, pj, jnp.asarray(c["z"], jnp.float64)))
    assert want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def test_backward_refuses_out_of_scope():
    c = _case("tanh-minmax-periodic")
    zt = torch.from_numpy(c["z"])
    layers = c["p_t"]["layers"]
    rest = (c["spec_t"], c["fm_t"], c["lb"], c["ub"], c["streams"])
    with pytest.raises(ValueError, match="ct must be"):
        tvjp.taylor2_backward(layers, zt, torch.zeros(len(zt), 2), *rest)
    with pytest.raises(TypeError):
        tvjp.taylor2_backward(layers, zt.double(),
                              torch.zeros(len(zt), len(c["streams"])), *rest)
    with pytest.raises(ValueError, match="runs on CUDA"):
        tvjp.taylor2_backward(layers, zt.to("meta"),
                              torch.zeros(len(zt), len(c["streams"])), *rest)
    with pytest.raises(ValueError, match="shared memory"):
        tvjp.tiling([3, 4096, 1], 10, 1_000)


def _recipe_b2_nets():
    """(name, dims, S, [point counts]) of every shipped recipe stage whose
    loss goes through kernel B2: plain dense nets (no Fourier features) of
    order <= 2, the stream plan of the kernel engine (the product rule's
    superset under a hard BC), at the recipe's batch and L-BFGS grid."""
    from tpinn_torch import problems
    from tpinn_torch.problems.recipes import RECIPES

    out = []
    for name, rec in RECIPES.items():
        prob, spec = problems.get_recipe(name)
        for k, st in enumerate(spec.stages):
            idx = tpde.compile_pde(st.equation or prob.equation,
                                   prob.coords).indices
            if st.fourier_features or any(len(ix) > 2 for ix in idx):
                continue
            need = set(idx) | {()}
            if rec.hard_bc:
                need |= {(i,) for ix in idx for i in ix}
            fm = tnet.feature_map_for(prob.feature_kinds,
                                      pad_to=spec.pad_features)
            dims = [fm.num_features] + [st.width] * st.depth + [1]
            sizes = [spec.n_col + spec.n_band + spec.n_adaptive, 1]
            if st.lbfgs_grid:
                sizes.append(st.lbfgs_grid ** len(prob.coords))
            out.append((f"{name}/{k + 1}", dims,
                        len(ttaylor.plan_streams(need)), sizes))
    return out


# chip_smoke.py's kernel_cases(): (dims, S, points)
_SMOKE_B2 = [([3] + [80] * 6 + [1], 5, n)
             for n in (262_144, 46_000, 1_077, 202_500)] + [
    ([3] + [64] * 6 + [1], 6, 65_536), ([4] + [48] * 4 + [1], 10, 32_768),
    ([3] + [64] * 5 + [1], 7, 7_200), ([3] + [64] * 5 + [1], 7, 13_824)]
# the one shipped recipe net whose gradient does not fit on chip beside
# the whole of a layer's W
_GLOBAL_RECIPES = {"heat_2d/1"}
_B2_PLAN_CASES = (
    [pytest.param(dims, s, sizes,
                  "global" if name in _GLOBAL_RECIPES else "smem", False,
                  id=name)
     for name, dims, s, sizes in _recipe_b2_nets()]
    + [pytest.param(dims, s, [n], "smem", False, id=f"smoke-{dims[1]}x"
                    f"{len(dims) - 2}-S{s}-N{n}") for dims, s, n in _SMOKE_B2]
    + [pytest.param([3] + [128] * 6 + [1], 5, [16_384, 1], "global", False,
                    id="6x128-too-large-for-shared-memory"),
       pytest.param([3] + [256] * 3 + [1], 5, [4_096, 1], "global", True,
                    id="3x256-W-in-chunks")])


@pytest.mark.parametrize("dims,n_streams,sizes,mode,chunked",
                         _B2_PLAN_CASES)
def test_backward_plan(dims, n_streams, sizes, mode, chunked):
    """B2's plan: within one block's shared memory, the accumulation mode
    named and chosen from the sizes alone (every shipped recipe but
    heat_2d keeps the gradient on chip, always beside the whole of a
    layer's W), W in chunks only where the whole W does not fit, the
    largest tile that fits, a multiple of 4 points, spread over at most
    one block per SM with no block more than one tile ahead of another."""
    assert len(_recipe_b2_nets()) >= 10   # every plain order-2 recipe stage
    for n in sizes:
        plan = tvjp.tiling(dims, n_streams, n, 132)
        assert plan == tvjp.tiling(dims, n_streams, n, 132)
        assert plan.accumulate == mode
        assert plan.smem_bytes == tvjp.smem_bytes(
            dims, n_streams, plan.tp, plan.kc, mode) <= 232_448
        assert plan.tp % 4 == 0 and plan.kc % 4 == 0 and plan.kc >= 4
        k_max = (max(dims[:-1]) + 3) // 4 * 4
        assert (plan.kc < k_max) == chunked and plan.kc <= k_max
        larger = [tp for tp in tvjp.TILE_POINTS if tp > plan.tp]
        least_w = k_max if mode == "smem" else 4    # rows of W to stage
        assert all(tvjp.smem_bytes(dims, n_streams, tp, least_w, mode)
                   > 232_448 for tp in larger)
        n_tiles = -(-n // plan.tp)
        rounds = -(-n_tiles // plan.blocks)
        assert plan.blocks <= min(132, n_tiles)
        assert rounds == -(-n_tiles // 132)      # as few rounds as the SMs allow
        assert (plan.blocks - 1) * rounds < n_tiles
        n_params = sum(dims[l] * dims[l + 1] + dims[l + 1]
                       for l in range(len(dims) - 1))
        hidden = [(w + 3) // 4 * 4 for w in dims[1:-1]]   # X, and H but the last
        ws = n_streams * plan.tp * (sum(hidden) + sum(hidden[:-1]))
        assert plan.scratch_bytes == 4 * (plan.blocks * (n_params + ws)
                                          + n_params)



@pytest.mark.parametrize("n_streams", [2, 5, 10])
def test_backward_plan_takes_every_width_the_earlier_kernel_took(n_streams):
    """The earlier B2 took a net while its three stream buffers and the
    bias sums (12·S + 1 rows of round4(width) floats at 4 points a tile)
    fit in a block; the plan takes every such width, staging W in chunks
    where the whole does not fit."""
    r4 = lambda w: (w + 3) // 4 * 4
    widest = max(w for w in range(1, 5_000)
                 if (12 * n_streams + 1) * r4(w) * 4 <= 232_448)
    for w in range(1, widest + 1):
        plan = tvjp.tiling([3, w, w, 1], n_streams, 1_000)
        assert plan.smem_bytes <= 232_448 and plan.kc >= 4
    with pytest.raises(ValueError, match="shared memory"):
        tvjp.tiling([3, 4 * widest, 1], n_streams, 1_000)

# the nets of chip_smoke.py's b1_mode_cases(), which B1 cannot keep
# resident: (dims, S, points, W mode, W in chunks)
_SMOKE_B1_MODES = [([3] + [96] * 6 + [1], 4, 28_000, "layer", False),
                   ([3] + [128] * 6 + [1], 5, 16_384, "layer", False),
                   ([3] + [256] * 3 + [1], 5, 4_096, "layer", True),
                   ([4] + [700] * 3 + [1], 10, 2_048, "l1", False)]
_B1_PLAN_CASES = (
    [pytest.param(dims, s, sizes, "layer" if name == "heat_2d/1" else
                  "resident", False, id=name)
     for name, dims, s, sizes in _recipe_b2_nets()]
    + [pytest.param(dims, s, [n], "resident", False, id=f"smoke-{dims[1]}x"
                    f"{len(dims) - 2}-S{s}-N{n}") for dims, s, n in _SMOKE_B2]
    + [pytest.param(dims, s, [n], mode, chunked, id=f"smoke-{mode}-{dims[1]}x"
                    f"{len(dims) - 2}-S{s}-N{n}")
       for dims, s, n, mode, chunked in _SMOKE_B1_MODES]
    + [pytest.param([3] + [128] * 6 + [1], 5, [16_384, 1], "layer", False,
                    id="6x128-layer")])


def _r4(x):
    return (x + 3) // 4 * 4


@pytest.mark.parametrize("dims,n_streams,sizes,mode,chunked", _B1_PLAN_CASES)
def test_forward_plan(dims, n_streams, sizes, mode, chunked):
    """B1's plan: within one block's shared memory, the W mode named and
    chosen from the sizes alone (every shipped recipe but heat_2d keeps
    the whole net's W resident), W in chunks only where a layer's W does
    not fit, the largest tile of at most 32 points whose threads fill one
    round of the block's 512 and fit, a multiple of 4 points, the fewest
    warps that hold them, spread over at most one block per SM
    with no block more than one tile ahead of another."""
    k_in = [_r4(k) for k in dims[:-2]]          # inputs of the hidden layers
    wide = max(dims[1:-1])
    # threads a point: a lane pair per 8 columns, a thread per 4 at S > 7
    per_point = 2 * -(-wide // 8) if n_streams <= 7 else -(-wide // 4)
    stride = tmt._row_stride(max(dims[:-1]))
    for n in sizes:
        plan = tmt.tiling(dims, n_streams, n, 132)
        assert plan == tmt.tiling(dims, n_streams, n, 132)
        assert plan.w_mode == mode and mode in tmt.W_MODES
        assert plan.smem_bytes == tmt.smem_bytes(
            n_streams, plan.tp, plan.kc, plan.ks) <= 232_448
        assert plan.ks % 4 == 0 and plan.ks >= (
            _r4(max(dims[:-1])) if mode == "l1" else stride - 4)
        assert plan.tp % 4 == 0 and plan.tp <= 32
        assert plan.threads == min(tmt.THREADS,
                                   -(-plan.tp * per_point // 32) * 32)
        if mode == "resident":
            assert plan.kc == sum(k_in)
        elif mode == "layer":
            assert 4 <= plan.kc <= max(k_in) and plan.kc % 4 == 0
            assert (plan.kc < max(k_in)) == chunked
            assert tmt.smem_bytes(n_streams, plan.tp, sum(k_in),
                                  stride) > 232_448
        else:
            assert plan.kc == 0
            assert tmt.smem_bytes(n_streams, plan.tp, 4, stride) > 232_448
        for tp in (t for t in tmt.TILE_POINTS if t > plan.tp):
            assert (tp * per_point > tmt.THREADS or tmt.smem_bytes(
                n_streams, tp, 0, _r4(max(dims[:-1]))) > 232_448)
        n_tiles = -(-n // plan.tp)
        rounds = -(-n_tiles // plan.blocks)
        assert plan.blocks <= min(132, n_tiles)
        assert rounds == -(-n_tiles // 132)      # as few rounds as the SMs allow
        assert (plan.blocks - 1) * rounds < n_tiles


@pytest.mark.parametrize("n_streams", [2, 5, 10])
def test_forward_plan_takes_every_width_the_earlier_kernel_took(n_streams):
    """The earlier B1 took a net while its two stream buffers fit in a
    block at 4 points a tile (2·S·4·round4(width) floats); the plan takes
    every such width and refuses the next."""
    widest = max(w for w in range(1, 10_000)
                 if 2 * n_streams * 4 * _r4(w) * 4 <= 232_448)
    for w in range(1, widest + 1):
        plan = tmt.tiling([3, w, w, 1], n_streams, 1_000)
        assert plan.smem_bytes <= 232_448 and plan.w_mode in tmt.W_MODES
    with pytest.raises(ValueError, match="shared memory"):
        tmt.tiling([3, widest + 1, widest + 1, 1], n_streams, 1_000)


def test_supports_is_unchanged():
    """``supports`` accepts exactly the nets the earlier B1 took (its rule
    is frozen below), over coordinates, feature kinds, widths, depths and
    families; and the plan takes each accepted net at its worst stream
    count."""
    def earlier(spec, fm):
        if not (spec.is_plain and spec.out_dim == 1):
            return False
        if any(k not in ("minmax", "periodic", "identity") for k in fm.kinds):
            return False
        d = len(fm.kinds)
        worst_s = 1 + d + d * (d + 1) // 2
        if d > 4 or worst_s > 10:
            return False
        widest = max(spec.width, fm.num_features)
        return (spec.depth + 1 <= 16 and fm.num_features <= 16
                and 2 * worst_s * 4 * ((widest + 3) & ~3) * 4 <= 232_448)

    kind_sets = [("minmax",), ("periodic",), ("identity",), ("periodic_fit",),
                 ("minmax", "periodic"), ("minmax", "periodic_fit"),
                 ("minmax",) * 3, ("minmax", "periodic", "identity"),
                 ("minmax",) * 4]
    widths = (1, 16, 80, 96, 724, 725, 1000, 1208, 1209, 1452, 1453, 2420,
              2421, 4000)
    families = ({}, {"out_dim": 2}, {"fourier_features": 8},
                {"modified": True})
    taken = 0
    for kinds in kind_sets:
        for pad in (0, 3):
            fm = tnet.feature_map_for(kinds, pad_to=pad)
            for width in widths:
                for depth in (0, 1, 6, 15, 16):
                    for extra in families:
                        spec = tnet.MLPSpec(depth=depth, width=width, **extra)
                        want = earlier(spec, fm)
                        assert tmt.supports(spec, fm) == want, (kinds, pad,
                                                                width, depth,
                                                                extra)
                        if want:
                            d = len(kinds)
                            dims = [fm.num_features] + [width] * depth + [1]
                            tmt.tiling(dims, 1 + d + d * (d + 1) // 2, 1_000)
                            taken += 1
    assert taken > 100


# ---------------------------------------------------------------------------
# Kernel B3 (adam)
# ---------------------------------------------------------------------------


def test_adam_plain_matches_optax_with_lr_change():
    import optax

    n, steps = 1_001, 300
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(n).astype(np.float32)
    grads = rng.standard_normal((steps, n)).astype(np.float32)
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    p_ox = jnp.asarray(p0)
    state = opt.init(p_ox)
    p = torch.from_numpy(p0.copy())
    m, v = torch.zeros(n), torch.zeros(n)
    lr = torch.full((1,), 1e-3)
    before = tadam.LAUNCHES
    for t in range(1, steps + 1):
        if t == steps // 2 + 1:
            lr.mul_(0.5)
            state.hyperparams["learning_rate"] = jnp.asarray(5e-4)
        upd, state = opt.update(jnp.asarray(grads[t - 1]), state)
        p_ox = optax.apply_updates(p_ox, upd)
        out = tadam.adam_update_flat(torch.from_numpy(grads[t - 1]), p, m, v,
                                     lr, t)
        assert out[0] is p             # in place
    assert tadam.LAUNCHES == before
    # atol 1e-6: over 300 steps the parameter picks up one-ulp differences
    # (XLA fuses the final multiply-subtract; torch rounds each op), a
    # random walk of a few 1e-7 that stays put when p crosses zero
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ox), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(m.numpy(), np.asarray(state.inner_state[0].mu),
                               rtol=1e-5, atol=1e-7)


def test_adam_plain_matches_pallas_and_refuses():
    from tpinn.kernels import adam as jadam

    n = 777
    g = np.full(n, 0.1, np.float32)
    p2, _, _ = jadam.adam_update_flat(jnp.asarray(g), jnp.zeros(n),
                                      jnp.zeros(n), jnp.zeros(n), 0.01, 1,
                                      block=256, interpret=True)
    p, m, v = torch.zeros(n), torch.zeros(n), torch.zeros(n)
    tadam.adam_update_flat(torch.from_numpy(g), p, m, v, torch.full((1,), 0.01),
                           1)
    # the Pallas kernel takes 1 - beta in float64 (Python floats), the port
    # in float32 as tpinn's optax phase does: 6.6e-6 apart at step 1
    np.testing.assert_allclose(p.numpy(), np.asarray(p2), rtol=1e-5)
    assert float(p[0]) < 0 and bool((p == p[0]).all())
    lr = torch.full((1,), 0.01)
    with pytest.raises(ValueError, match="1-based"):
        tadam.adam_update_flat(torch.from_numpy(g), p, m, v, lr, 0)
    with pytest.raises(ValueError, match="lr must be"):
        tadam.adam_update_flat(torch.from_numpy(g), p, m, v, 0.01 * lr[0], 1)
    with pytest.raises(ValueError, match="contiguous 1-D"):
        tadam.adam_update_flat(torch.zeros(n, 1), p, m, v, lr, 1)


def _adam_inputs(n=1_001, steps=200):
    rng = np.random.default_rng(0)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((steps, n)).astype(np.float32))


def test_adam_launcher_matches_optax_with_lr_change():
    """The Adam phase's launcher (one FusedAdam for the phase, its step
    counted by the launcher) on its plain path against optax.adam, the lr
    halved in place at step 101."""
    import optax

    p0, grads = _adam_inputs()
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    p_ox = jnp.asarray(p0)
    state = opt.init(p_ox)
    p = torch.from_numpy(p0.copy())
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    lr = torch.full((1,), 1e-3)
    launcher = tadam.FusedAdam(p, m, v, lr, len(grads))
    before = tadam.LAUNCHES
    for t, g in enumerate(grads, start=1):
        if t == 101:
            lr.mul_(0.5)
            state.hyperparams["learning_rate"] = jnp.asarray(5e-4)
        upd, state = opt.update(jnp.asarray(g), state)
        p_ox = optax.apply_updates(p_ox, upd)
        assert launcher.t == t
        assert launcher.step(torch.from_numpy(g))[0] is p      # in place
    assert launcher.t == len(grads) + 1
    assert tadam.LAUNCHES == before                # the plain path
    for got, want in ((p, p_ox), (m, state.inner_state[0].mu),
                      (v, state.inner_state[0].nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


def test_adam_launcher_matches_pallas_with_lr_change():
    """The launcher against the Pallas kernel in interpret mode (jitted,
    lr and step traced) over the same 200 steps.  The betas go to the
    Pallas kernel as float32 scalars, so it forms 1 − β in float32 as
    tpinn's optax phase and the port do (from Python floats it takes them
    in float64: v then sits 1.3e-5 apart, the gap of 1 − 0.999 in the two
    precisions)."""
    import functools

    from tpinn.kernels import adam as jadam

    p0, grads = _adam_inputs()
    pallas = jax.jit(functools.partial(
        jadam.adam_update_flat, b1=np.float32(0.9), b2=np.float32(0.999),
        block=256, interpret=True))
    pj, mj, vj = jnp.asarray(p0), jnp.zeros(len(p0)), jnp.zeros(len(p0))
    p = torch.from_numpy(p0.copy())
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    lr = torch.full((1,), 1e-3)
    launcher = tadam.FusedAdam(p, m, v, lr, len(grads))
    for t, g in enumerate(grads, start=1):
        if t == 101:
            lr.mul_(0.5)
        pj, mj, vj = pallas(jnp.asarray(g), pj, mj, vj,
                            jnp.float32(lr.item()), t)
        launcher.step(torch.from_numpy(g))
    for got, want in ((p, pj), (m, mj), (v, vj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


def test_adam_bias_table_matches_constants():
    """The launcher's table of (1 − β₁ᵗ, 1 − β₂ᵗ) holds ``_constants``'s
    float32 values bitwise for every step, also past t ≈ 985, where
    β₁ᵗ = 0.9ᵗ underflows float32, and from a later start."""
    steps = 1_200
    table = tadam.bias_table(0.9, 0.999, 1, steps)
    assert table.dtype == np.float32 and table.shape == (steps, 2)
    for t in range(1, steps + 1):
        _, _, bc1, bc2 = tadam._constants(0.9, 0.999, t)
        assert table[t - 1, 0] == bc1 and table[t - 1, 1] == bc2
    with np.errstate(under="ignore"):
        assert np.power(np.float32(0.9), np.float32(steps)) == 0.0
    assert table[-1, 0] == 1.0
    np.testing.assert_array_equal(tadam.bias_table(0.9, 0.999, 501, 700),
                                  table[500:])


def test_adam_launcher_refuses():
    n = 33
    p, m, v = torch.zeros(n), torch.zeros(n), torch.zeros(n)
    lr = torch.full((1,), 0.01)
    launcher = tadam.FusedAdam(p, m, v, lr, 2)
    g = torch.ones(n)
    launcher.step(g)
    launcher.step(g)
    with pytest.raises(ValueError, match="past the last step"):
        launcher.step(g)
    assert launcher.t == 3
    launcher = tadam.FusedAdam(p, m, v, lr, 5, start=4)
    with pytest.raises(ValueError, match="contiguous 1-D"):
        launcher.step(torch.ones(n + 1))                   # shape
    with pytest.raises(ValueError, match="contiguous 1-D"):
        launcher.step(torch.ones(n, 1))
    with pytest.raises(ValueError, match="contiguous 1-D"):
        launcher.step(torch.ones(n, dtype=torch.float64))  # dtype
    with pytest.raises(ValueError, match="contiguous 1-D"):
        launcher.step(torch.ones(n, device="meta"))        # device
    with pytest.raises(ValueError, match="contiguous 1-D"):
        launcher.step(torch.ones(2 * n)[::2])              # not contiguous
    assert launcher.t == 4                   # nothing taken by a refusal
    with pytest.raises(ValueError, match="start"):
        tadam.FusedAdam(p, m, v, lr, 5, start=0)
    with pytest.raises(ValueError, match="steps"):
        tadam.FusedAdam(p, m, v, lr, -1)
    with pytest.raises(ValueError, match="lr must be"):
        tadam.FusedAdam(p, m, v, torch.full((1,), 0.01, dtype=torch.float64),
                        5)
    with pytest.raises(ValueError, match="must match p"):
        tadam.FusedAdam(p, m[1:], v, lr, 5)
    with pytest.raises(ValueError, match="runs on CUDA"):
        tadam.FusedAdam(*(torch.zeros(n, device="meta"),) * 3,
                        torch.zeros(1, device="meta"), 5)
