"""The PirateNet family (``net.MLPSpec.pirate_blocks``, ``weight_fact``) and
the port's recipe ``allen_cahn_pirate``, on one thread at a small size
(width 16, 2 blocks, 64 points), against the plain reference
``benchmark/reference/allen_cahn_pirate.py``: its parameter tree and its
random weight factorisation, the net with every alpha at 0, its partials
in float64, the first three Adam steps of ``run_training`` with causal
weights in float32, the spec through a checkpoint, its spans, and the
paths that refuse it with a ValueError."""

import dataclasses
import json

import pytest
import torch

from benchmark.drivers import adam as bench_adam
from benchmark.reference import allen_cahn_pirate as ref
from tpinn_torch import problems
from tpinn_torch.core import deriv, net, optim, pde, polish, train
from tpinn_torch.utils import checkpoint as ckpt
from tpinn_torch.utils import profiling

WIDTH, BLOCKS, FEATURES = 16, 2, 3
SPEC = net.MLPSpec(depth=3 * BLOCKS, width=WIDTH, fourier_features=WIDTH // 2,
                   fourier_scale=2.0, pirate_blocks=BLOCKS,
                   weight_fact=(1.0, 0.1))
FM = net.feature_map_for(("periodic_fit", "minmax"))
# the reference's reading of SPEC and of the recipe's loss
CFG = {"width": WIDTH, "pirate_blocks": BLOCKS, "n_features": FEATURES,
       "fourier_features": WIDTH // 2, "fourier_scale": 2.0,
       "weight_fact": [1.0, 0.1], "epsil": 1.0, "coords": ["x", "t"],
       "lb": [-1.0, 0.0], "ub": [1.0, 1.0], "causal_eps": 1.0,
       "causal_bins": 32, "causal_axis": "t", "lw": [1.0, 0.0],
       "lr": 1e-3}
SEED = 2_147_483_999


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _points(n, dtype, seed=5):
    u = torch.rand((n, 2), generator=torch.Generator().manual_seed(seed),
                   dtype=dtype)
    return u * torch.tensor([2.0, 1.0], dtype=dtype) + torch.tensor(
        [-1.0, 0.0], dtype=dtype)


def _hard_predictor(dtype):
    prob = problems.with_hard_bc(problems.get_problem("allen_cahn"))
    lb = torch.tensor(prob.lb, dtype=dtype)
    ub = torch.tensor(prob.ub, dtype=dtype)
    lift, bubble = (pde.compile_coord_expr(e, prob.coords)
                    for e in prob.hard_bc)
    return net.wrap_hard_bc(net.make_predictor(SPEC, FM, lb, ub), lift,
                            bubble), (lb, ub)


def test_parameter_tree_rwf_draw_and_alpha():
    params = net.init_params(torch.Generator().manual_seed(3), SPEC, FM,
                             "cpu")
    assert sorted(params) == ["alpha", "fourier_b", "gate_u", "gate_v",
                              "layers"]
    assert torch.equal(params["alpha"], torch.zeros(BLOCKS))
    assert len(params["layers"]) == 3 * BLOCKS + 1
    # the draw replayed: B, then per dense layer w, b (init_mlp) and s
    gen = torch.Generator().manual_seed(3)
    b_mat = torch.randn((FEATURES, WIDTH // 2), generator=gen) * 2.0
    assert torch.equal(params["fourier_b"], b_mat)
    dense = [params["gate_u"], params["gate_v"], *params["layers"]]
    for k, layer in enumerate(dense):
        dout = 1 if k == len(dense) - 1 else WIDTH
        assert sorted(layer) == ["b", "g", "v"]
        w0 = net.init_mlp(gen, [WIDTH, dout], "cpu")[0]
        s = torch.randn((dout,), generator=gen)
        g = torch.exp(1.0 + 0.1 * s)
        assert torch.equal(layer["g"], g) and torch.equal(layer["b"], w0["b"])
        assert torch.equal(layer["v"], w0["w"] / g)
        # W = v diag(g) gives the Xavier draw back to rounding
        torch.testing.assert_close(layer["g"] * layer["v"], w0["w"],
                                   rtol=1e-6, atol=0.0)
    # the reference draws the same tree from the run's seed, bit for bit
    params = net.init_params(torch.Generator().manual_seed(SEED * 1000),
                             SPEC, FM, "cpu")
    leaves = optim.tree_leaves(params)
    mine = ref.init(SEED, CFG, "cpu")
    assert [tuple(x.shape) for x in leaves] == ref.shapes(CFG)
    assert all(torch.equal(a, b) for a, b in zip(leaves, mine, strict=True))


@pytest.mark.parametrize("kw, match", [
    (dict(fourier_features=4), "fourier_features"),
    (dict(modified=True), "modified"),
    (dict(depth=5), "depth"),
    (dict(act_first="sin"), "act_first"),
    (dict(scl=2.0), "scl"),
    (dict(pirate_blocks=0), "weight_fact"),
])
def test_spec_refuses_what_the_block_cannot_be(kw, match):
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(SPEC, **kw)


def test_every_alpha_zero_is_the_output_layer_on_the_features():
    params = net.init_params(torch.Generator().manual_seed(4), SPEC, FM,
                             "cpu")
    h = FM(_points(64, torch.float32), torch.tensor([-1.0, 0.0]),
           torch.tensor([1.0, 1.0]))
    proj = h @ params["fourier_b"]
    phi = torch.cat([torch.cos(proj), torch.sin(proj)], dim=1)
    out = params["layers"][-1]
    want = phi @ (out["g"] * out["v"]) + out["b"]
    assert torch.equal(net.mlp_apply(params, h, SPEC), want)
    assert not SPEC.is_plain


def _random_leaves(dtype, seed=11):
    gen = torch.Generator().manual_seed(seed)
    return [0.5 * torch.randn(s, generator=gen, dtype=dtype)
            for s in ref.shapes(CFG)]


def test_partials_against_the_reference_in_float64():
    """The generic engine's u, u_x, u_xx and u_t of the hard-IC PirateNet
    on seeded random weights (every alpha away from 0) against the
    reference's autograd: the same function in float64, so only rounding
    of the order 1e-16 parts them."""
    predictor, _ = _hard_predictor(torch.float64)
    leaves = _random_leaves(torch.float64)
    like = net.init_params(torch.Generator().manual_seed(0), SPEC, FM,
                           "cpu", torch.float64)
    _, unravel = optim.ravel_tree(like)
    params = unravel(torch.cat([x.reshape(-1) for x in leaves]))
    z = _points(64, torch.float64)
    got = deriv.partials(lambda zz: predictor(params, zz), z,
                         [(), (0, 0), (1,)])
    u, u_x, u_t, u_xx = ref.partials(leaves, z, CFG)
    for ix, want in (((), u), ((0,), u_x), ((1,), u_t), ((0, 0), u_xx)):
        gap = float((got[ix] - want).abs().max() / want.abs().max())
        assert gap < 1e-10, (ix, gap)


class _Stop(Exception):
    pass


def _stop_at_first_row(msg):
    if msg.startswith("Step: "):
        raise _Stop


def test_first_adam_steps_through_run_training_in_float32():
    """``run_training`` on ``get_recipe("allen_cahn_pirate")`` cut to the
    small net and 64 points: the loss rows of steps 0-2 (causal weights
    over 32 slabs), the first gradient and the parameters' change after
    three steps, watched as the benchmark watches them, against the
    reference's own three Adam steps in float32.

    Tolerances: the port takes u_xx by forward-over-forward jvp, the
    reference by reverse-mode autograd, so the two agree to float32
    rounding through 8 dense layers, not bit for bit.  Over three seeds
    the gaps were at most 1.8e-7 of the total loss in the rows, 3.5e-7 of
    the largest first-gradient entry and 2.4e-7 in the change (two ulps
    of an Adam step of lr 1e-3): each bound is ten times or more above
    that, and a TF32 product (1e-3 relative) lands far outside it."""
    problem, spec = problems.get_recipe("allen_cahn_pirate")
    st = dataclasses.replace(spec.stages[0], depth=3 * BLOCKS, width=WIDTH,
                             fourier_features=WIDTH // 2, pirate_blocks=BLOCKS,
                             adam_epochs=12)
    spec = dataclasses.replace(spec, n_col=40, n_adaptive=16, n_bd=8,
                               grid=21, log_every=1, seed=SEED, stages=(st,))
    with bench_adam.Capture() as cap:
        with pytest.raises(_Stop):
            train.run_training(problem, spec, output_dir=None,
                               log_fn=_stop_at_first_row, device="cpu")
    assert cap.ready()
    data = {"x_col": cap.local[0][0]["x_col"],
            "x_bd": list(cap.local[0][0]["x_bd"])}
    assert data["x_col"].shape == (64, 2)
    leaves0 = ref.init(SEED, CFG, "cpu")
    assert torch.equal(cap.x0, torch.cat([x.reshape(-1) for x in leaves0]))
    r = ref.adam_steps(leaves0, data, CFG, 3)
    for got, want in zip(cap.rows(), r["rows"], strict=True):
        gap = float((got.double() - want).abs().max() / want[0])
        assert gap < 2e-6, gap
    # the rows are causally weighted: loss_eqn differs from the plain MSE
    assert float(r["rows"][0][2]) != float(r["rows"][0][4])
    g0 = cap.m1 / (torch.tensor(1.0) - torch.tensor(0.9))
    g_ref = torch.cat([g.reshape(-1) for g in r["grad0"]])
    assert float((g0 - g_ref).abs().max()) < 5e-6 * float(g_ref.abs().max())
    change = torch.cat([(p - x).reshape(-1)
                        for p, x in zip(r["params"], leaves0)])
    assert float((cap.p3 - cap.x0 - change).abs().max()) < 3e-6


def test_spec_through_a_checkpoint(tmp_path):
    d = json.loads(json.dumps(net.spec_to_dict(SPEC)))
    assert d["pirate_blocks"] == BLOCKS and d["weight_fact"] == [1.0, 0.1]
    back = net.spec_from_dict(d)
    assert back == SPEC and back.weight_fact == (1.0, 0.1)
    # a plain net's meta has tpinn's keys only
    assert "pirate_blocks" not in net.spec_to_dict(net.MLPSpec(2, 8))
    params = net.init_params(torch.Generator().manual_seed(6), SPEC, FM,
                             "cpu")
    path = tmp_path / "pirate.npz"
    ckpt.save_pytree(path, params, meta={"chain": [d]})
    like = net.init_params(torch.Generator().manual_seed(7), SPEC, FM, "cpu")
    loaded, meta = ckpt.load_pytree(path, like)
    assert net.spec_from_dict(meta["chain"][0]) == SPEC
    assert all(torch.equal(a, b) for a, b in zip(
        optim.tree_leaves(loaded), optim.tree_leaves(params), strict=True))


def test_recipe_is_the_ports_own():
    assert len(problems.RECIPES) == 13
    assert "allen_cahn_pirate" not in problems.RECIPES
    problem, spec = problems.get_recipe("allen_cahn_pirate")
    assert problem.name == "allen_cahn"
    assert problem.hard_bc == problems.HARD_BC["allen_cahn"]
    (st,) = spec.stages
    assert (st.pirate_blocks, st.width, st.fourier_features,
            st.weight_fact) == (3, 256, 128, (1.0, 0.1))
    assert (spec.n_col, spec.n_band, spec.n_adaptive, spec.n_bd) == (
        6144, 0, 2048, 512)
    assert spec.causal_eps == 1.0 and spec.adam_precision is None
    from tpinn_torch import cli

    args = cli.build_parser().parse_args(
        ["train", "--problem", "allen_cahn_pirate", "--recipe"])
    assert cli.train_spec(args)[1] is spec


def test_generic_spans_under_a_profiler(tmp_path):
    predictor, _ = _hard_predictor(torch.float32)
    params = net.init_params(torch.Generator().manual_seed(8), SPEC, FM,
                             "cpu")
    z = _points(16, torch.float32)
    with profiling.trace(str(tmp_path / "prof")) as prof:
        deriv.partials(lambda zz: predictor(params, zz), z,
                       [(), (0, 0), (1,)])
    names = [e.name for e in prof.events()]
    # one call: a pair pass for u_xx (and u_x), a first pass for u_t
    assert names.count("partials.generic") == 1
    assert names.count("partials.generic.pass") == 2


def test_paths_without_a_factorised_output_refuse_it():
    predictor, (lb, ub) = _hard_predictor(torch.float32)
    params = net.init_params(torch.Generator().manual_seed(9), SPEC, FM,
                             "cpu")
    prob = problems.with_hard_bc(problems.get_problem("allen_cahn"))
    # a linear equation, so that the solve would otherwise apply
    compiled = pde.compile_pde("u_t - 0.0001*u_xx", prob.coords)
    data = {"x_col": _points(32, torch.float32)}
    with pytest.raises(ValueError, match="weight-factorised"):
        polish.last_layer_lsq(predictor, compiled, params, data, 1.0, None)
    _, spec = problems.get_recipe("allen_cahn_pirate")
    from tpinn_torch.core import ensemble, patch

    with pytest.raises(ValueError, match="PirateNet"):
        patch.run_patched(problems.get_problem("allen_cahn"), spec,
                          patch.PatchSpec(n=(2, 1)), device="cpu")
    with pytest.raises(ValueError, match="lsq_polish"):
        ensemble.run_ensemble_training(
            prob, dataclasses.replace(spec, lsq_polish="auto"), n_members=2,
            device="cpu")
