"""The port's sampler (tpinn_torch.core.sample) against tpinn's and scipy.

The cases of tests/test_sample.py.  The generators' streams differ from
``jax.random``'s, so draws are held by their statistics (LHS strata,
where the inverse CDF puts its mass) and deterministic functions by equal
outputs on equal inputs: the Gaussian smoothing against scipy and
``tpinn`` (rtol 1e-4, atol 1e-6, the tolerance of tests/test_sample.py),
the boundary band exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import scipy.stats
import torch

from tpinn.core import sample as jsample
from tpinn_torch.core import sample


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_lhs_stratification_and_box():
    n = 50
    pts = sample.lhs(_gen(0), n, 2)
    assert pts.shape == (n, 2) and pts.dtype == torch.float32
    assert float(pts.min()) >= 0.0 and float(pts.max()) <= 1.0
    for d in range(2):
        bins = np.floor(pts[:, d].numpy() * n).astype(int)
        assert sorted(bins.tolist()) == list(range(n))
    box = sample.lhs_box(_gen(1), 40, [0.1, 0.0], [1.0, 2.0])
    assert float(box[:, 0].min()) >= 0.1 and float(box[:, 0].max()) <= 1.0
    assert float(box[:, 1].max()) <= 2.0
    # the draw is a function of the generator's state
    assert torch.equal(sample.lhs(_gen(0), n, 2), pts)


def test_inverse_cdf_follows_density():
    g = 41
    x = torch.linspace(0.0, 1.0, g)
    X, Y = torch.meshgrid(x, x, indexing="xy")
    F = torch.where(X < 0.5, 1.0, 0.0)
    pts = sample.inverse_cdf_2d(_gen(2), X, Y, F, 500)
    assert pts.shape == (500, 2)
    assert float((pts[:, 0] < 0.5 + 1.5 / g).float().mean()) > 0.97
    # a single live cell: every point lands in it
    F1 = torch.zeros_like(X)
    F1[7, 30] = 1.0
    one = sample.inverse_cdf_2d(_gen(3), X, Y, F1, 200)
    assert bool(((one[:, 0] >= x[30]) & (one[:, 0] <= x[31])
                 & (one[:, 1] >= x[7]) & (one[:, 1] <= x[8])).all())

    x1 = torch.linspace(0.0, 1.0, 101)[:, None]
    f1 = torch.where(x1 > 0.7, 1.0, 0.0)
    p1 = sample.inverse_cdf_1d(_gen(4), x1, f1, 400)
    assert p1.shape == (400, 1)
    assert float((p1[:, 0] > 0.7 - 0.02).float().mean()) > 0.97


def test_gaussian_smooth_2d_matches_scipy_and_tpinn():
    rng = np.random.default_rng(0)
    F = rng.random((32, 28)).astype(np.float32)
    sig, wid = [1.0, 1.0], [5, 5]
    xg = np.linspace(-sig[0], sig[0], wid[0])
    yg = np.linspace(-sig[1], sig[1], wid[1])
    window = scipy.stats.norm.pdf(xg) * scipy.stats.norm.pdf(yg)[:, None]
    expected = scipy.signal.convolve2d(F, window / window.sum(), mode="same")
    got = sample.gaussian_smooth_2d(torch.from_numpy(F), sig, wid).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-6)
    tp = np.asarray(jsample.gaussian_smooth_2d(jnp.asarray(F), sig, wid))
    np.testing.assert_allclose(got, tp, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("wid", [5, 4])
def test_gaussian_smooth_1d_matches_scipy_and_tpinn(wid):
    rng = np.random.default_rng(1)
    f = rng.random((64, 1)).astype(np.float32)
    w = scipy.stats.norm.pdf(np.linspace(-1.0, 1.0, wid))
    expected = scipy.signal.convolve(f[:, 0], w / w.sum(), mode="same")
    got = sample.gaussian_smooth_1d(torch.from_numpy(f), 1.0, wid).numpy()
    np.testing.assert_allclose(got[:, 0], expected, rtol=1e-4, atol=1e-6)
    tp = np.asarray(jsample.gaussian_smooth_1d(jnp.asarray(f), 1.0, wid))
    np.testing.assert_allclose(got, tp, rtol=1e-4, atol=1e-6)


def test_boundary_band_density_equals_tpinn():
    x = np.linspace(0.0, 1.0, 21, dtype=np.float32)
    y = np.linspace(0.1, 2.0, 17, dtype=np.float32)
    X, Y = np.meshgrid(x, y)
    lb, ub = [0.0, 0.1], [1.0, 2.0]
    got = sample.boundary_band_density(torch.from_numpy(X), torch.from_numpy(Y),
                                       lb, ub).numpy()
    want = np.asarray(jsample.boundary_band_density(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(lb), jnp.asarray(ub)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 1.0 and got[8, 10] == 0.0 and got[0, 10] == 1.0


def _groups_2d():
    return [sample.BCGroup(lo=(0.1, 0.0), hi=(0.1, 1.0), value=1.0),
            sample.BCGroup(lo=(1.0, 0.0), hi=(1.0, 1.0), value=0.0)]


def test_make_sampler_shapes_and_concat():
    cfg = sample.SamplerConfig(n_col=100, n_band=40, n_adaptive=30, n_bd=20,
                               grid=31)
    fn, (R, T) = sample.make_sampler(cfg, _groups_2d(), lb=[0.1, 0.0],
                                     ub=[1.0, 1.0])
    assert R.shape == (31, 31)
    data = fn(_gen(4), torch.ones_like(R))
    assert data["x_col"].shape == (100 + 40 + 30 + 2 * 20, 2)
    assert len(data["x_bd"]) == 2 and data["x_bd"][0].shape == (20, 2)
    assert data["u_bd"][0].shape == (20, 1)
    np.testing.assert_allclose(data["u_bd"][0].numpy(), 1.0)
    np.testing.assert_allclose(data["x_bd"][0][:, 0].numpy(), 0.1, atol=1e-6)
    assert float(data["x_col"][:, 0].min()) >= 0.1 - 1e-5
    # BC points sit inside the collocation set (the reference's concat)
    assert torch.equal(data["x_col"][140:160], data["x_bd"][0])
    # same generator state, same draw
    again = fn(_gen(4), torch.ones_like(R))
    assert torch.equal(again["x_col"], data["x_col"])


def test_make_sampler_1d_and_dispatch():
    cfg = sample.SamplerConfig(n_col=64, n_band=0, n_adaptive=32, n_bd=8,
                               grid=101)
    groups = [sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0),
              sample.BCGroup(lo=(1.0,), hi=(1.0,), value=0.0)]
    fn, (x_nodes,) = sample.sampler_for(cfg, groups, lb=[0.0], ub=[1.0])
    data = fn(_gen(5), torch.ones_like(x_nodes))
    assert data["x_col"].shape == (64 + 32 + 16, 1)
    assert data["x_bd"][0].shape == (8, 1)
    np.testing.assert_allclose(data["x_bd"][1].numpy(), 1.0)
    z, reshape, smooth = sample.density_geometry((x_nodes,))
    assert z.shape == (101, 1) and smooth(reshape(z)).shape == (101, 1)


def test_bc_value_fn_and_float64():
    from tpinn_torch.core import pde

    g = pde.compile_coord_expr("sin(pi*t)", coords=("r", "t"))
    grp = sample.BCGroup(lo=(0.1, 0.0), hi=(0.1, 1.0), value_fn=g)
    cfg = sample.SamplerConfig(n_col=10, n_band=4, n_adaptive=4, n_bd=16,
                               grid=21)
    fn, (R, T) = sample.make_sampler(cfg, [grp], [0.1, 0.0], [1.0, 1.0],
                                     dtype=torch.float64)
    data = fn(_gen(6), torch.ones_like(R))
    assert data["x_col"].dtype == torch.float64
    pts = data["x_bd"][0]
    np.testing.assert_allclose(data["u_bd"][0].numpy()[:, 0],
                               np.sin(np.pi * pts[:, 1].numpy()), rtol=1e-12)


def test_nd_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="later PR"):
        sample.sampler_for(sample.SamplerConfig(1, 1, 1, 1),
                           [], lb=[0.0] * 3, ub=[1.0] * 3)
    for fn in (lambda: sample.inverse_cdf_nd(_gen(0), None, None, 1),
               lambda: sample.gaussian_smooth_nd(None),
               lambda: sample.boundary_band_density_nd(None, None, None)):
        with pytest.raises(NotImplementedError):
            fn()
