"""Kernel B1 (tpinn_torch.kernels.mlp_taylor) against the JAX Pallas kernel.

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
from tpinn_torch.kernels import mlp_taylor as tmt
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


def test_tile_points_fits_shared_memory():
    assert tmt.tile_points(5, 80) == 32          # 102,400 B: two blocks per SM
    assert tmt.tile_points(10, 80) == 16
    assert tmt.tile_points(5, 24) == 64
    for s, w in ((5, 80), (10, 512), (1, 16)):
        tp = tmt.tile_points(s, w)
        assert tp % tmt.POINTS_PER_THREAD == 0
        assert 2 * s * tp * ((w + 3) // 4 * 4) * 4 <= tmt.SMEM_LIMIT
    with pytest.raises(ValueError):
        tmt.tile_points(10, 4096)
