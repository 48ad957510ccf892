"""The port's sampler (tpinn_torch.core.sample) against tpinn's and scipy.

The cases of tests/test_sample.py.  The generators' streams differ from
``jax.random``'s, so draws are held by their statistics (LHS strata,
where the inverse CDF puts its mass) and deterministic functions by equal
outputs on equal inputs: the Gaussian smoothing against scipy and
``tpinn`` (rtol 1e-4, atol 1e-6, the tolerance of tests/test_sample.py),
the boundary band exactly.

The d >= 3 functions (the cases of tests/test_nd.py): the N-D smoothing
against tpinn's at the same tolerance, the N-D band and the density
geometry exactly; ``inverse_cdf_nd`` by the cell histogram of 40,000 draws
against the density (each cell's share within 5 standard deviations of
its binomial spread) and by zero-mass cells never being drawn;
``make_sampler_nd`` by its layout.
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
    """The n-D sampler IS ported now: d = 3 dispatches to it, and it
    refuses only d < 3, as tpinn's does."""
    cfg = sample.SamplerConfig(4, 2, 2, 3, grid=5)
    fn, grids = sample.sampler_for(cfg, [], lb=[0.0] * 3, ub=[1.0] * 3)
    assert len(grids) == 3 and grids[0].shape == (5, 5, 5)
    assert fn(_gen(0), torch.ones_like(grids[0]))["x_col"].shape == (8, 3)
    for d in (1, 2):
        with pytest.raises(ValueError, match="d >= 3"):
            sample.make_sampler_nd(cfg, [], [0.0] * d, [1.0] * d)
        with pytest.raises(ValueError, match="d >= 3"):
            jsample.make_sampler_nd(jsample.SamplerConfig(4, 2, 2, 3, grid=5),
                                    [], [0.0] * d, [1.0] * d)


# ---------------------------------------------------------------------------
# d >= 3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,wid", [((9, 7, 8), 5), ((6, 5, 4, 3), 5),
                                       ((12, 10), 4), ((17,), 5)])
def test_gaussian_smooth_nd_equals_tpinn(shape, wid):
    rng = np.random.default_rng(2)
    F = rng.random(shape).astype(np.float32)
    got = sample.gaussian_smooth_nd(torch.from_numpy(F), 1.0, wid).numpy()
    want = np.asarray(jsample.gaussian_smooth_nd(jnp.asarray(F), 1.0, wid))
    assert got.shape == shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    # a normalized window keeps a constant's interior
    ones = sample.gaussian_smooth_nd(torch.ones(shape), 1.0, wid)
    mid = tuple(n // 2 for n in shape)
    if min(shape) > wid:
        assert float(ones[mid]) == pytest.approx(1.0, abs=1e-6)
    f64 = sample.gaussian_smooth_nd(torch.from_numpy(F).double(), 1.0, wid)
    assert f64.dtype == torch.float64


def _ij_grids(g, lb, ub, d=3):
    axes = [np.linspace(lb[i], ub[i], g, dtype=np.float32) for i in range(d)]
    return axes, np.meshgrid(*axes, indexing="ij")


def test_boundary_band_density_nd_equals_tpinn():
    lb, ub = [0.0, -1.0, 0.5], [1.0, 1.0, 2.5]
    _, grids = _ij_grids(21, lb, ub)
    got = sample.boundary_band_density_nd(
        [torch.from_numpy(G) for G in grids], lb, ub).numpy()
    want = np.asarray(jsample.boundary_band_density_nd(
        [jnp.asarray(G) for G in grids], jnp.asarray(lb), jnp.asarray(ub)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.shape == (21, 21, 21)
    assert got[0, 10, 10] == 1.0 and got[10, 10, 10] == 0.0
    assert got[10, 10, 20] == 1.0 and got[1, 10, 10] == 1.0
    # 2 of 21 nodes per side lie in the band: 1 - (17/21)^3 of the nodes
    assert got.mean() == pytest.approx(1.0 - (17.0 / 21.0) ** 3, abs=1e-6)


def test_density_geometry_nd_equals_tpinn():
    _, grids = _ij_grids(6, [0.0] * 3, [1.0, 2.0, 3.0])
    zt, reshape_t, smooth_t = sample.density_geometry(
        tuple(torch.from_numpy(G) for G in grids))
    zj, reshape_j, smooth_j = jsample.density_geometry(
        tuple(jnp.asarray(G) for G in grids))
    assert zt.shape == (216, 3)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    col = np.random.default_rng(3).random((216, 1)).astype(np.float32)
    Ft = smooth_t(reshape_t(torch.from_numpy(col)))
    Fj = smooth_j(reshape_j(jnp.asarray(col)))
    assert Ft.shape == (6, 6, 6)
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), rtol=1e-4,
                               atol=1e-6)
    # 2-D keeps its own branch
    X, Y = torch.meshgrid(torch.linspace(0, 1, 5), torch.linspace(0, 1, 4),
                          indexing="xy")
    z2, _, _ = sample.density_geometry((X, Y))
    assert z2.shape == (20, 2)


def test_inverse_cdf_nd_follows_the_density():
    g, n = 7, 40_000
    axes = [torch.linspace(0.0, 1.0, g), torch.linspace(-1.0, 1.0, g),
            torch.linspace(2.0, 5.0, g)]
    rng = np.random.default_rng(4)
    F = rng.random((g, g, g)).astype(np.float32)
    F[F < 0.3] = 0.0                       # a third of the cells carry nothing
    pts = sample.inverse_cdf_nd(_gen(5), axes, torch.from_numpy(F), n)
    assert pts.shape == (n, 3) and pts.dtype == torch.float32
    cell = [np.clip(np.floor((pts[:, i].numpy() - float(a[0]))
                             / float(a[1] - a[0])).astype(int), 0, g - 2)
            for i, a in enumerate(axes)]
    hist = np.zeros((g - 1,) * 3)
    np.add.at(hist, tuple(cell), 1.0)
    mass = F[:-1, :-1, :-1].astype(np.float64)
    share = mass / mass.sum()
    assert hist[share == 0.0].sum() == 0          # zero-mass cells: never
    sd = np.sqrt(n * share * (1.0 - share))
    assert np.all(np.abs(hist - n * share) <= 5.0 * sd + 1.0)
    for i, a in enumerate(axes):
        assert float(pts[:, i].min()) >= float(a[0])
        assert float(pts[:, i].max()) <= float(a[-1])
    # one live cell: every point lands in it, jittered on every axis
    F1 = torch.zeros((g, g, g))
    F1[2, 4, 1] = 1.0
    one = sample.inverse_cdf_nd(_gen(6), axes, F1, 300)
    for i, k in enumerate((2, 4, 1)):
        assert bool(((one[:, i] >= axes[i][k])
                     & (one[:, i] <= axes[i][k + 1])).all())
        assert float(one[:, i].std()) > 0.0
    # d = 2 through the same function agrees with the cell layout of 'ij'
    two = sample.inverse_cdf_nd(_gen(7), axes[:2], F1[:, :, 1], 50)
    assert bool(((two[:, 0] >= axes[0][2]) & (two[:, 0] <= axes[0][3])
                 & (two[:, 1] >= axes[1][4]) & (two[:, 1] <= axes[1][5])).all())


@pytest.mark.parametrize("where", ["front", "middle", "back", "band"])
def test_cell_index_never_lands_on_a_zero_mass_cell(where):
    """Plateaus of the cumulative sum, at either end and inside, and the
    3-D band density (zero on most cells), in float32 as on the card."""
    if where == "band":
        _, grids = _ij_grids(31, [0.0] * 3, [1.0] * 3)
        F = sample.boundary_band_density_nd(
            [torch.from_numpy(G) for G in grids], [0.0] * 3, [1.0] * 3)
        f = F[:-1, :-1, :-1].reshape(-1)
        assert f.numel() == 27_000 and float((f == 0).float().mean()) > 0.5
    else:
        f = torch.ones(3000)
        lo = {"front": 0, "middle": 1000, "back": 2000}[where]
        f[lo:lo + 1000] = 0.0
    pos = sample._cell_index(_gen(8), f, 200_000)
    assert int(pos.min()) >= 0 and int(pos.max()) < f.numel()
    assert bool((f[pos] > 0).all())
    live = torch.nonzero(f > 0)[:, 0]
    assert int(pos.max()) <= int(live.max())
    # a draw that rounds up to the total mass goes to the last live cell
    top = sample._cell_index(_TopGen(), f, 4)
    assert bool((top == int(live.max())).all())
    counts = torch.bincount(pos, minlength=f.numel()).float()
    assert float(counts[f > 0].std() / counts[f > 0].mean()) < 1.0


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 27_000, 29_791,
                               100_003])
@pytest.mark.parametrize("plateaus", [False, True])
def test_fixed_order_cdf_equals_cumsum(n, plateaus):
    """The cumulative mass of the draws (fixed order on the host) against
    torch.cumsum on the CPU and against float64 np.cumsum rounded to
    float32, bitwise, at lengths from one to past a hundred tiles of a
    device scan's 1,024, multiples of it and not, with runs of zero-mass
    cells at the front, inside and at the back; in float64 the float64
    sums themselves.  The result has f's dtype and device."""
    rng = np.random.default_rng(n)
    f = rng.uniform(0.0, 3.0, n).astype(np.float32)
    if plateaus:
        f[: n // 7] = 0.0
        f[n // 3: n // 3 + n // 5] = 0.0
        f[n - n // 9:] = 0.0
    got = sample.fixed_order_cdf(torch.from_numpy(f))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n + 1,)
    assert float(got[0]) == 0.0 and got.device.type == "cpu"
    np.testing.assert_array_equal(
        got[1:].numpy(), torch.cumsum(torch.from_numpy(f), 0).numpy())
    np.testing.assert_array_equal(
        got[1:].numpy(), np.cumsum(f.astype(np.float64)).astype(np.float32))
    assert bool((got[1:] >= got[:-1]).all())
    # a zero-mass cell leaves the sum exactly where it was
    zero = np.nonzero(f == 0.0)[0]
    np.testing.assert_array_equal(got[zero + 1].numpy(), got[zero].numpy())
    f64 = torch.from_numpy(f.astype(np.float64) / 3.0)
    got64 = sample.fixed_order_cdf(f64)
    assert got64.dtype == torch.float64
    np.testing.assert_array_equal(got64[1:].numpy(),
                                  np.cumsum(f64.numpy()))


class _TopGen:
    """Stands in for a generator whose every uniform draw is the largest
    float32 below 1 (torch.rand is patched to honour it)."""
    device = torch.device("cpu")


@pytest.fixture(autouse=True)
def _rand_honours_topgen(monkeypatch):
    real = torch.rand

    def rand(*a, generator=None, **k):
        if isinstance(generator, _TopGen):
            return torch.full(*a, 1.0 - 2.0 ** -24, **k)
        return real(*a, generator=generator, **k)

    monkeypatch.setattr(torch, "rand", rand)


def _faces_3d():
    return [sample.BCGroup(lo=(0.0, 0.0, 0.0), hi=(0.0, 1.0, 1.0), value=2.0),
            sample.BCGroup(lo=(0.0, 1.0, 0.0), hi=(1.0, 1.0, 1.0), value=0.0),
            sample.BCGroup(lo=(0.0, 0.0, 1.0), hi=(1.0, 1.0, 1.0), value=-1.0)]


def test_make_sampler_nd_layout():
    cfg = sample.SamplerConfig(n_col=200, n_band=50, n_adaptive=40, n_bd=10,
                               grid=11)
    lb, ub = [0.0] * 3, [1.0] * 3
    fn, grids = sample.make_sampler_nd(cfg, _faces_3d(), lb, ub)
    assert len(grids) == 3 and all(G.shape == (11, 11, 11) for G in grids)
    # 'ij': axis 0 varies along dimension 0
    assert float(grids[0][3, 0, 0]) == pytest.approx(0.3)
    assert float(grids[2][0, 0, 7]) == pytest.approx(0.7)
    F = torch.zeros_like(grids[0])
    F[5, 5, 5] = 1.0                      # adaptive mass in one central cell
    data = fn(_gen(9), F)
    jfn, _ = jsample.make_sampler_nd(
        jsample.SamplerConfig(200, 50, 40, 10, grid=11),
        [jsample.BCGroup(lo=g.lo, hi=g.hi, value=g.value)
         for g in _faces_3d()], lb, ub)
    import jax
    jdata = jfn(jax.random.PRNGKey(0), jnp.asarray(F.numpy()))
    assert tuple(data["x_col"].shape) == jdata["x_col"].shape == (320, 3)
    assert [tuple(x.shape) for x in data["x_bd"]] == [(10, 3)] * 3
    assert [tuple(u.shape) for u in data["u_bd"]] == [(10, 1)] * 3
    x = data["x_col"]
    # order of parts: uniform, band, BC groups, adaptive (tpinn's order:
    # the BC points BEFORE the adaptive ones)
    band = x[200:250]
    edge = torch.minimum(band, 1.0 - band).min(dim=1).values
    assert float(edge.max()) <= 0.1 + 1e-6      # cells that touch the shell
    for gi in range(3):
        assert torch.equal(x[250 + 10 * gi:260 + 10 * gi], data["x_bd"][gi])
    adapt = x[290:]
    assert bool(((adapt >= 0.5) & (adapt <= 0.6 + 1e-6)).all())
    xj = np.asarray(jdata["x_col"])
    assert np.all((xj[290:] >= 0.5) & (xj[290:] <= 0.6 + 1e-6))
    for gi in range(3):
        np.testing.assert_array_equal(xj[250 + 10 * gi:260 + 10 * gi],
                                      np.asarray(jdata["x_bd"][gi]))
    # BC points on their faces, with their values
    np.testing.assert_allclose(data["x_bd"][0][:, 0].numpy(), 0.0, atol=1e-7)
    np.testing.assert_allclose(data["x_bd"][1][:, 1].numpy(), 1.0, atol=1e-7)
    np.testing.assert_allclose(data["x_bd"][2][:, 2].numpy(), 1.0, atol=1e-7)
    assert float(data["x_bd"][0][:, 1].std()) > 0.1
    np.testing.assert_allclose(data["u_bd"][0].numpy(), 2.0)
    np.testing.assert_allclose(data["u_bd"][2].numpy(), -1.0)
    # the uniform part is a Latin hypercube: one point per 1/200 slab
    for d in range(3):
        bins = np.floor(x[:200, d].numpy() * 200).astype(int)
        assert sorted(bins.tolist()) == list(range(200))
    assert torch.equal(fn(_gen(9), F)["x_col"], x)
    # no band, no adaptive draws: those parts vanish from the set
    fn0, _ = sample.make_sampler_nd(
        sample.SamplerConfig(n_col=30, n_band=0, n_adaptive=0, n_bd=4,
                             grid=5), _faces_3d(), lb, ub,
        dtype=torch.float64)
    d0 = fn0(_gen(1), None)
    assert tuple(d0["x_col"].shape) == (30 + 12, 3)
    assert d0["x_col"].dtype == torch.float64
