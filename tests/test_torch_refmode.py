"""Reference-semantics mode: tpinn_torch.core.refmode and
deriv.vect_grad_reverse against tpinn's, on the CPU in float64.

Inputs are made with numpy from a seed; the net's weights are drawn by
the JAX package and carried (utils/convert).  Tolerances, float64:
vect_grad_reverse 1e-12 absolute; the polar residual rtol 1e-9 against
tpinn's and rtol 1e-8 (atol 1e-10) against the port's generic forward
engine; the reference loss, its loss_info and its gradient rtol 1e-9;
50 reference Adam steps against optax's, per leaf, rtol 1e-9 (atol
1e-12).  Nets and batches are small so tpinn's reverse-over-reverse
compiles stay short.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.core import deriv as jderiv
from tpinn.core import net as jnet
from tpinn.core import refmode as jref
from tpinn.utils.x64 import force_x64
from tpinn_torch.core import deriv, net, pde, refmode
from tpinn_torch.core.optim import tree_leaves
from tpinn_torch.utils.convert import params_from_numpy, params_to_numpy

F64 = torch.float64
KINDS = ("minmax", "periodic")
LB, UB = (0.1, 0.0), (1.0, 1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _nets(depth, width, seed=0):
    """The same float64 net in both packages: (jax predictor, jax params,
    torch predictor, torch params)."""
    fm_j = jnet.feature_map_for(KINDS)
    spec_j = jnet.MLPSpec(depth=depth, width=width)
    with force_x64():
        p_j = jnet.init_params(jax.random.PRNGKey(seed), spec_j, fm_j,
                               jnp.float64)
        pred_j = jnet.make_predictor(spec_j, fm_j,
                                     jnp.asarray(LB, jnp.float64),
                                     jnp.asarray(UB, jnp.float64))
    p_np = jax.tree.map(np.asarray, p_j)
    spec_t = net.MLPSpec(depth=depth, width=width)
    fm_t = net.feature_map_for(KINDS)
    pred_t = net.make_predictor(spec_t, fm_t, torch.tensor(LB, dtype=F64),
                                torch.tensor(UB, dtype=F64))
    return pred_j, p_np, pred_t, params_from_numpy(p_np, "cpu", F64)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform((0.2, 0.0), (0.95, 1.0), (n, 2))


def _data(n_col, n_bd, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, n_bd)
    return {"x_col": rng.uniform((0.15, 0.0), (0.95, 1.0), (n_col, 2)),
            "x_bd": [np.stack([np.full(n_bd, 0.1), t], axis=1),
                     np.stack([np.full(n_bd, 1.0), t], axis=1)],
            "u_bd": [np.ones((n_bd, 1)), np.zeros((n_bd, 1))]}


def _on_jax(data):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), data)


def _on_torch(data):
    return params_from_numpy(data, "cpu", F64)


def test_vect_grad_reverse_matches_tpinn_and_layout():
    z_np = _points(7, 1)

    def f_j(z):
        return jnp.stack([jnp.sin(z[:, 0] * z[:, 1]) + z[:, 0] ** 2,
                          jnp.exp(z[:, 1]) * z[:, 0]], axis=1)

    def f_t(z):
        return torch.stack([torch.sin(z[:, 0] * z[:, 1]) + z[:, 0] ** 2,
                            torch.exp(z[:, 1]) * z[:, 0]], dim=1)

    with force_x64():
        g_j, s_j = jderiv.vect_grad_reverse(f_j, jnp.asarray(z_np))
        g_j, s_j = np.asarray(g_j), np.asarray(s_j)
    g_t, s_t = deriv.vect_grad_reverse(f_t, torch.tensor(z_np, dtype=F64))
    assert g_t.shape == (7, 4) and s_t.shape == (7, 2)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=0, atol=1e-12)
    # output-major: column o*d + i is d(out_o)/d(z_i)
    x, y = z_np[:, 0], z_np[:, 1]
    want = np.stack([np.cos(x * y) * y + 2 * x, np.cos(x * y) * x,
                     np.exp(y), np.exp(y) * x], axis=1)
    np.testing.assert_allclose(g_t.numpy(), want, rtol=0, atol=1e-12)


def test_reference_residual_matches_tpinn_and_the_forward_engine():
    pred_j, p_np, pred_t, p_t = _nets(3, 20)
    z_np = _points(16, 2)
    with force_x64():
        p_j = jax.tree.map(jnp.asarray, p_np)
        f_j = np.asarray(jref.reference_residual_polar(
            lambda zz: pred_j(p_j, zz), jnp.asarray(z_np)))
    z = torch.tensor(z_np, dtype=F64)
    f_t = refmode.reference_residual_polar(lambda zz: pred_t(p_t, zz), z)
    assert f_t.shape == (16, 1) and f_t.dtype == F64
    np.testing.assert_allclose(f_t.detach().numpy(), f_j, rtol=1e-9,
                               atol=0)
    compiled = pde.compile_pde("u_rr + 1/r*u_r + 1/r**2*u_tt",
                               coords=("r", "t"))
    f_fwd = compiled.residual(lambda zz: pred_t(p_t, zz), z)
    np.testing.assert_allclose(f_t.detach().numpy(), f_fwd.detach().numpy(),
                               rtol=1e-8, atol=1e-10)


def test_reference_loss_and_gradient_match_tpinn():
    pred_j, p_np, pred_t, p_t = _nets(2, 12, seed=3)
    data_np = _data(24, 6, 4)
    lw_np, ref = np.array([0.05, 0.0]), 1.7
    with force_x64():
        loss_j = jref.make_reference_loss(pred_j)
        p_j = jax.tree.map(jnp.asarray, p_np)
        (l_j, info_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
            p_j, _on_jax(data_np), jnp.asarray(lw_np), jnp.float64(ref))
        l_j, info_j = float(l_j), np.asarray(info_j)
        g_j = [np.asarray(x) for x in jax.tree.leaves(g_j)]
    loss_t = refmode.make_reference_loss(pred_t)
    leaves = [x.requires_grad_(True) for x in tree_leaves(p_t)]
    l_t, info_t = loss_t(p_t, _on_torch(data_np),
                         torch.tensor(lw_np, dtype=F64),
                         torch.tensor(ref, dtype=F64))
    g_t = torch.autograd.grad(l_t, leaves)
    assert info_t.shape == (3 + 2 + 1,)
    np.testing.assert_allclose(float(l_t.detach()), l_j, rtol=1e-9)
    np.testing.assert_allclose(info_t.detach().numpy(), info_j, rtol=1e-9)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9,
                                   atol=1e-12 * np.abs(b).max())


def test_reference_adam_steps_match_optax():
    pred_j, p_np, pred_t, p_t = _nets(2, 8, seed=5)
    data_np = _data(16, 4, 6)
    lw_np = np.array([0.05, 0.0])
    with force_x64():
        loss_j = jref.make_reference_loss(pred_j)
        opt_j, step_j = jref.make_reference_adam_step(loss_j, lr=1e-3)
        p_j = jax.tree.map(jnp.asarray, p_np)
        s_j = opt_j.init(p_j)
        d_j, lw_j = _on_jax(data_np), jnp.asarray(lw_np)
        for _ in range(50):
            p_j, s_j, info_j = step_j(p_j, s_j, d_j, lw_j, jnp.float64(1.0))
        p_j = [np.asarray(x) for x in jax.tree.leaves(p_j)]
        info_j = np.asarray(info_j)
    opt_t, step_t = refmode.make_reference_adam_step(
        refmode.make_reference_loss(pred_t), lr=1e-3)
    s_t = opt_t.init(p_t)
    d_t, lw_t = _on_torch(data_np), torch.tensor(lw_np, dtype=F64)
    one = torch.tensor(1.0, dtype=F64)
    for _ in range(50):
        p_t, s_t, info_t = step_t(p_t, s_t, d_t, lw_t, one)
    assert s_t["count"] == 50
    np.testing.assert_allclose(info_t.numpy(), info_j, rtol=1e-9)
    for a, b in zip(tree_leaves(params_to_numpy(p_t)), p_j):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_reference_adam_step_decreases_loss():
    """tpinn's case (tests/test_refmode.py) on the port: a 3x20 float64
    net, 400 collocation points, 50 steps lower the loss."""
    _, _, pred_t, p_t = _nets(3, 20)
    gen = torch.Generator().manual_seed(2)
    x_col = torch.rand((400, 2), generator=gen, dtype=F64) * 0.8 + 0.15
    t = torch.linspace(0.0, 1.0, 50, dtype=F64)
    data = {"x_col": x_col,
            "x_bd": [torch.stack([torch.full((50,), 0.1, dtype=F64), t], 1),
                     torch.stack([torch.full((50,), 1.0, dtype=F64), t], 1)],
            "u_bd": [torch.ones((50, 1), dtype=F64),
                     torch.zeros((50, 1), dtype=F64)]}
    opt, step = refmode.make_reference_adam_step(
        refmode.make_reference_loss(pred_t), lr=1e-3)
    state = opt.init(p_t)
    lw = torch.tensor([0.05, 0.0], dtype=F64)
    ref = torch.tensor(1.0, dtype=F64)
    _, _, info0 = step(p_t, state, data, lw, ref)
    p, s = p_t, state
    for _ in range(50):
        p, s, info = step(p, s, data, lw, ref)
    assert float(info[0]) < float(info0[0])
