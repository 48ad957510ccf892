"""The hard-BC lift's and bubble's partials kept per point set
(``net.hard_bc_partials``): a call on the same plain tensor, unchanged and
with the same streams, reuses them, bit for bit what computing them again
gives; any other point set, a write to it, other streams, a tensor with
autograd or functorch state compute them afresh."""

import pytest
import torch

from tpinn_torch import problems
from tpinn_torch.core import deriv, loss, net, optim, pde

CASES = {
    # name: (feature kinds, depth, width)
    "annulus_laplace": (("minmax", "periodic"), 2, 8),
    "poisson_3d": (("minmax", "minmax", "minmax"), 2, 6),
}


def _case(name):
    """(predictor, its lift and bubble, compiled PDE, bounds, params of
    three seeds) for a preset under its hard-BC ansatz, a small net."""
    prob = problems.with_hard_bc(problems.get_problem(name))
    kinds, depth, width = CASES[name]
    spec = net.MLPSpec(depth=depth, width=width)
    fm = net.feature_map_for(kinds)
    lb, ub = torch.tensor(prob.lb), torch.tensor(prob.ub)
    lift, bubble = (pde.compile_coord_expr(e, prob.coords)
                    for e in prob.hard_bc)
    hard = net.wrap_hard_bc(net.make_predictor(spec, fm, lb, ub), lift,
                            bubble)
    params = [net.init_params(torch.Generator().manual_seed(s), spec, fm,
                              torch.device("cpu")) for s in (0, 1, 2)]
    compiled = pde.compile_pde(prob.equation, prob.coords)
    return hard, lift, bubble, compiled, (lb, ub), params


def _points(lb, ub, n=64, seed=5):
    u = torch.rand((n, len(lb)), generator=torch.Generator().manual_seed(seed))
    return lb + u * (ub - lb)


def _need(indices):
    need = {()}
    for ix in indices:
        need.add(ix)
        if len(ix) == 2:
            need |= {(ix[0],), (ix[1],)}
    return sorted(need, key=lambda t: (len(t), t))


def _product_rule(hard, lift, bubble, params, z, indices):
    """The partials of lift + bubble·N from direct deriv.partials calls."""
    need = _need(indices)
    v = hard.tpinn_raw.tpinn_partials(params, z, need)
    l = deriv.partials(lift, z, need)
    b = deriv.partials(bubble, z, need)
    out = {}
    for ix in indices:
        if ix == ():
            out[ix] = l[()] + b[()] * v[()]
        elif len(ix) == 1:
            out[ix] = (l[ix] + b[ix] * v[()] + b[()] * v[ix])
        else:
            i, j = ix
            out[ix] = (l[ix] + b[ix] * v[()]
                       + b[(i,)] * v[(j,)] + b[(j,)] * v[(i,)]
                       + b[()] * v[ix])
    return out


@pytest.fixture
def fills(monkeypatch):
    """Counts deriv.partials calls on each function it is handed."""
    counts = {}
    inner = deriv.partials

    def counted(f, z, indices):
        counts[f] = counts.get(f, 0) + 1
        return inner(f, z, indices)

    monkeypatch.setattr(deriv, "partials", counted)
    return counts


def _cols(parts, indices):
    return torch.cat([parts[ix] for ix in indices], dim=1)


def _equal(got, want):
    assert set(got) == set(want)
    for ix in want:
        assert torch.equal(got[ix], want[ix]), ix


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_calls_on_one_point_set_fill_once(name, fills):
    hard, lift, bubble, compiled, (lb, ub), params = _case(name)
    z = _points(lb, ub)
    idx = list(compiled.indices)
    wants = [_product_rule(hard, lift, bubble, p, z, idx) for p in params]
    fills.clear()
    for p, want in zip(params, wants):
        _equal(hard.tpinn_partials(p, z, idx), want)
    assert fills == {lift: 1, bubble: 1}


def _refill_cases():
    """(name, change): each change hands back the points and the indices of
    the next call after a first call on ``z`` with ``idx``."""
    def new_tensor(z, idx):
        return z.clone(), idx

    def write_in_place(z, idx):
        z.mul_(0.5).add_(0.25)
        return z, idx

    def write_to_a_view(z, idx):
        z[:8, 0:1].mul_(0.75)
        return z, idx

    def other_indices(z, idx):
        return z, [(), (0,)]

    return [new_tensor, write_in_place, write_to_a_view, other_indices]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("change", _refill_cases(), ids=lambda f: f.__name__)
def test_refill(name, change, fills):
    hard, lift, bubble, compiled, (lb, ub), params = _case(name)
    z = _points(lb, ub)
    idx = list(compiled.indices)
    hard.tpinn_partials(params[0], z, idx)
    hard.tpinn_partials(params[1], z, idx)
    assert fills == {lift: 1, bubble: 1}
    z2, idx2 = change(z, idx)
    want = _product_rule(hard, lift, bubble, params[2], z2, idx2)
    fills.clear()
    _equal(hard.tpinn_partials(params[2], z2, idx2), want)
    _equal(hard.tpinn_partials(params[2], z2, idx2), want)
    assert fills == {lift: 1, bubble: 1}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nothing_kept_for_a_point_set_with_autograd_state(name, fills):
    hard, lift, bubble, compiled, (lb, ub), params = _case(name)
    idx = list(compiled.indices)
    fresh = lambda: _case(name)[0]      # a closure that has kept nothing

    # points that require grad: value and z-derivative as uncached
    zg = _points(lb, ub).requires_grad_(True)
    for p in params[:2]:
        got = hard.tpinn_partials(p, zg, idx)
        want = fresh().tpinn_partials(p, zg, idx)
        _equal(got, want)
        (dgot,) = torch.autograd.grad(_cols(got, idx).sum(), zg)
        (dwant,) = torch.autograd.grad(_cols(want, idx).sum(), zg)
        assert torch.equal(dgot, dwant)

    # points under torch.func.jvp; a plain call on them before and after
    z = _points(lb, ub, seed=7)
    t = torch.ones_like(z)
    fills.clear()
    hard.tpinn_partials(params[0], z, idx)
    assert fills == {lift: 1, bubble: 1}
    for p in params[:2]:
        got = torch.func.jvp(
            lambda zz: _cols(hard.tpinn_partials(p, zz, idx), idx), (z,),
            (t,))
        want = torch.func.jvp(
            lambda zz: _cols(fresh().tpinn_partials(p, zz, idx), idx), (z,),
            (t,))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    fills.clear()
    hard.tpinn_partials(params[2], z, idx)
    assert fills == {}          # the plain entry survived the wrapped calls


def test_fused_engine_with_the_residual_gradient_term(fills):
    hard, lift, bubble, compiled, (lb, ub), params = _case("annulus_laplace")
    data = {"x_col": _points(lb, ub), "x_bd": [], "u_bd": []}
    lw, ref = torch.tensor([1.0, 0.5]), torch.tensor(1.0)
    fresh_loss = lambda: loss.make_loss(_case("annulus_laplace")[0], compiled,
                                        deriv_loss=True, engine="fused")
    loss_fn = loss.make_loss(hard, compiled, deriv_loss=True, engine="fused")
    for p in params:
        leaves = [x.requires_grad_(True) for x in optim.tree_leaves(p)]
        got, got_info = loss_fn(p, data, lw, ref)
        want, want_info = fresh_loss()(p, data, lw, ref)
        assert torch.equal(got, want) and torch.equal(got_info, want_info)
        for a, b in zip(torch.autograd.grad(got, leaves),
                        torch.autograd.grad(want, leaves)):
            assert torch.equal(a, b)
    # the plain residual fills once; its z-derivative's two jvp passes run
    # on wrapped points, which fill every time
    assert fills[lift] == fills[bubble] == 1 + 2 * len(params)


def test_adam_phase_fills_once_per_point_set(fills):
    hard, lift, bubble, compiled, (lb, ub), params = _case("annulus_laplace")
    loss_fn = loss.make_loss(hard, compiled, engine="auto")
    seen = []

    def sample_fn(gen, F):
        z = lb + torch.rand((48, 2), generator=gen) * (ub - lb)
        seen.append(z)
        return {"x_col": z, "x_bd": [z[:4]], "u_bd": [torch.zeros(4, 1)]}

    gen, F = torch.Generator().manual_seed(3), torch.ones(1, 1)
    data = sample_fn(gen, F)
    lw, ref = torch.tensor([1.0, 0.0]), torch.tensor(1.0)
    # the loss row's width, from a call on the first point set
    width = loss_fn(params[0], data, lw, ref)[1].shape[0]
    phase = optim.make_adam_phase(
        loss_fn, sample_fn, None,
        optim.AdamConfig(epochs=6, lr=1e-3, resample_every=2, tail_max=0,
                         log_every=2), info_width=width)
    res = phase(gen, params[0], data, F, lw, ref)
    # resamples after steps 2 and 4: three point sets over six steps, the
    # first filled by the call above
    assert len(seen) == 3 and res.n_valid == 6
    assert fills == {lift: 3, bubble: 3}
