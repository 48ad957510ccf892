"""The plain reference against the port on the CPU at a tiny width: the
loss row, the gradient and one Adam update; and its lower precisions."""

import math

import pytest
import torch

from benchmark.harness import compare, spec
from benchmark.reference import common

CONFIGS = ["annulus_laplace", "poisson_3d"]


def tiny(name):
    cfg = spec.load_json(spec.BENCH / "configs" / f"{name}.json")
    return dict(cfg, depth=2, width=8)


def points(cfg, n, seed):
    gen = torch.Generator().manual_seed(seed)
    lb, ub = torch.tensor(cfg["lb"]), torch.tensor(cfg["ub"])
    x_col = lb + (ub - lb) * torch.rand((n, len(lb)), generator=gen)
    x_bd = []
    for g in cfg["bc_groups"]:
        lo, hi = torch.tensor(g["lo"]), torch.tensor(g["hi"])
        x_bd.append(lo + (hi - lo) * torch.rand((16, len(lb)),
                                                generator=gen))
    return {"x_col": x_col, "x_bd": x_bd,
            "u_bd": [torch.full((16, 1), float(g["value"]))
                     for g in cfg["bc_groups"]]}


def port(cfg, seed):
    from tpinn_torch.core import loss, net, pde
    from tpinn_torch.problems import get_recipe

    problem, _ = get_recipe(cfg["recipe"])
    mspec = net.MLPSpec(depth=cfg["depth"], width=cfg["width"])
    fm = net.feature_map_for(problem.feature_kinds)
    lb, ub = torch.tensor(problem.lb), torch.tensor(problem.ub)
    pred = net.wrap_hard_bc(net.make_predictor(mspec, fm, lb, ub),
                            *(pde.compile_coord_expr(e, problem.coords)
                              for e in problem.hard_bc))
    fn = loss.make_loss(pred, pde.compile_pde(problem.equation,
                                              problem.coords))
    params = net.init_params(torch.Generator().manual_seed(seed * 1000),
                             mspec, fm, "cpu")
    return fn, params


def port_value_and_grad(fn, params, data, lw, ref):
    from tpinn_torch.core import optim

    flat, unravel = optim.ravel_tree(params)
    flat.requires_grad_(True)
    loss_n, info = fn(unravel(flat), data, lw, ref)
    (g,) = torch.autograd.grad(loss_n, flat)
    return loss_n.detach(), info.detach(), flat.detach(), g


@pytest.mark.parametrize("name", CONFIGS)
def test_init_matches_the_port(name):
    cfg = tiny(name)
    _, params = port(cfg, 5)
    from tpinn_torch.core import optim

    flat, _ = optim.ravel_tree(params)
    ref = torch.cat([x.reshape(-1) for x in
                     common.leaves(common.init_layers(5, cfg, "cpu"))])
    assert torch.equal(flat, ref)


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_row_gradient_and_adam_step(name):
    from tpinn_torch.kernels.adam import FusedAdam

    cfg = tiny(name)
    problem = spec.load_module(spec.BENCH / "reference" / f"{name}.py",
                               "ref_" + name)
    fn, params = port(cfg, 3)
    data = points(cfg, 300, 3)
    lw = torch.tensor(cfg["lw"])
    ref = fn(params, data, lw, torch.ones(()))[1][0].detach()
    loss_n, info, flat, g = port_value_and_grad(fn, params, data, lw, ref)

    layers = common.init_layers(3, cfg, "cpu")
    with common.no_tf32():
        r_loss, r_info, r_grad = common.value_and_grad(
            problem, layers, data, cfg, float(ref), block=128)
    assert compare.row_gap([info], [r_info]) < 1e-5
    assert float(loss_n) == pytest.approx(float(r_loss), rel=1e-5)
    g_leaves = common.split_flat(g, cfg)
    assert compare.leaf_gap(g_leaves, r_grad) < 1e-4

    # one Adam update by the port's launcher (its plain version on the
    # CPU) against the reference's formulas
    p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
    FusedAdam(p, m, v, torch.full((1,), cfg["lr"]), 1).step(g)
    r = common.adam_steps(problem, layers, data, cfg, steps=1)
    r_p = torch.cat([x.reshape(-1) for x in r["params"]])
    assert float((p - r_p).abs().max()) < 1e-6


def test_round_mantissa():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -1.5,
                      1.0 + 2.0 ** -8], dtype=torch.float32)
    # TF32 keeps 10 mantissa bits, ties to even; bf16 keeps 7
    assert common.round_mantissa(x, 10).tolist() == [
        1.0, 1.0 + 2 * 2.0 ** -10, -1.5, 1.0 + 2.0 ** -8]
    assert common.round_mantissa(x, 7).tolist()[3] == 1.0
    assert torch.equal(common.round_mantissa(x, 23), x)


@pytest.mark.parametrize("prec", ["tf32", "bf16"])
def test_lower_precision_moves_the_loss_row(prec):
    cfg = tiny("annulus_laplace")
    problem = spec.load_module(spec.BENCH / "reference" /
                               "annulus_laplace.py", "ref_annulus")
    layers = common.init_layers(4, cfg, "cpu")
    data = points(cfg, 300, 4)
    rows = {}
    for p in ("fp32", prec):
        _, rows[p], _ = common.value_and_grad(problem, layers, data, cfg,
                                              None, p, grad=False)
    gap = compare.row_gap([rows[prec]], [rows["fp32"]])
    assert math.isfinite(gap) and gap > 1e-5
