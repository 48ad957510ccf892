"""Kernel B1 and the serving path on a CUDA card (marker ``cuda``).

These tests need a card and skip without one.  The file imports torch
and tpinn_torch only, so it also runs where JAX is not installed; run it
on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` because tests/conftest.py imports JAX.)  The kernel is
held against its plain PyTorch version on the same card: per stream,
max |kernel - plain| / max |plain| <= 1e-4 (fp32; the two sum in another
order); residuals rtol 1e-3, atol 1e-4.
"""

import math

import numpy as np
import pytest
import torch

from tpinn_torch.app import serve
from tpinn_torch.core import net, pde, taylor
from tpinn_torch.kernels import mlp_taylor
from tpinn_torch.utils import checkpoint

IDX5 = [(), (0,), (1,), (0, 0), (1, 1)]
IDX6 = IDX5 + [(0, 1)]
TWO_PI = 2.0 * math.pi

# (spec kwargs, kinds, pad_to, lb, ub, streams, n points)
CASES = {
    "annulus-6x80-ragged": (dict(depth=6, width=80), ("minmax", "periodic"), 0,
                            (0.1, 0.0), (1.0, TWO_PI), IDX5, 4_099),
    "sin-first-pad_to-3": (dict(depth=3, width=40, act_first="sin", scl=3.0,
                                epsil=0.5), ("minmax", "minmax"), 3,
                           (0.0, 0.0), (1.0, 1.0), IDX6, 1_000),
    "3-coordinates": (dict(depth=3, width=48, act_hidden="sin"),
                      ("minmax", "periodic", "identity"), 0,
                      (0.0, 0.0, -1.0), (1.0, TWO_PI, 1.0),
                      taylor.plan_streams([(i, j) for i in range(3)
                                           for j in range(i, 3)]), 2_053),
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
