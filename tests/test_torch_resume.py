"""Mid-stage Adam checkpoints and resume, and ``lbfgs_device``, in the port.

The Adam phase resumed from one carried state in both packages: tpinn's
scan carry (params, optax count/mu/nu, an already halved learning rate,
the plateau ring, the history) and the port's phase state made from it
by ``utils.convert.phase_init_from_tpinn``, with ``sample_fn=None`` so
that only the automaton is compared (tests/test_torch_optim.py), in both
layouts; a plateau halving and the tail fall in the resumed part.
Tolerances: rtol 1e-5, atol 1e-6 on histories and parameters, rtol 1e-6
on the learning rate (tests/test_torch_optim.py).

End to end, bit for bit on the CPU (tests/test_train_e2e.py,
tests/test_patch.py): a ``run_training`` killed after a mid-scan save and
resumed equals the uninterrupted run, the point draws and the density
refreshes inside the resumed window; a run that saves equals one that
does not; a file written under the other Adam layout finishes its stage
under that layout; a tpinn phase file restarts the phase; ``run_patched``
resumes the same way; ``lbfgs_device="cpu"`` (the loss rebuilt for the
CPU) equals the training device on a CPU run.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.core import optim as jopt
from tpinn.utils import checkpoint as jckpt
from tpinn_torch import problems
from tpinn_torch.core import optim as topt
from tpinn_torch.core import sample, train
from tpinn_torch.core.inverse import InverseSpec, run_inverse
from tpinn_torch.core.patch import PatchSpec, run_patched
from tpinn_torch.core.system import SystemSpec, run_system
from tpinn_torch.core.train import ProblemSpec, StageSpec, TrainSpec
from tpinn_torch.utils import checkpoint as ckpt
from tpinn_torch.utils.convert import phase_init_from_tpinn

RTOL, ATOL = 1e-5, 1e-6
PI = np.pi


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny nets: one intra-op thread is as fast as eight alone, and many
    times faster when several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Killed(Exception):
    pass


def _killed_at(monkeypatch, module, step):
    """Make ``module.save_phase_state`` raise right after its save at or
    past ``step`` (a run killed after a mid-scan checkpoint)."""
    orig = module.save_phase_state

    def killer(path, done, state, hist, *layout):
        orig(path, done, state, hist, *layout)
        if done >= step:
            raise Killed(f"simulated kill at step {done}")

    monkeypatch.setattr(module, "save_phase_state", killer)
    return lambda: monkeypatch.setattr(module, "save_phase_state", orig)


def _same_leaves(a, b):
    la, lb = topt.tree_leaves(a), topt.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# The Adam phase resumed from a carried tpinn carry
# ---------------------------------------------------------------------------


def _l1_j(params, data, lw, ref):
    loss = (jnp.sum(jnp.abs(params["a"] - data["ta"]))
            + jnp.sum(jnp.abs(params["b"] - data["tb"])))
    return loss / ref, jnp.stack([loss, loss, lw[0] * loss])


def _l1_t(params, data, lw, ref):
    loss = (torch.sum(torch.abs(params["a"] - data["ta"]))
            + torch.sum(torch.abs(params["b"] - data["tb"])))
    return loss / ref, torch.stack([loss, loss, lw[0] * loss])


@pytest.mark.parametrize("layout", ["flat", "tree"])
def test_adam_phase_resume_matches_tpinn(layout):
    """An L1 loss: Adam's steps keep their size and circle the minimum, so
    the plateau rule halves the rate at step 80 and the tail runs, both
    after the resume at step 50 with an already halved rate."""
    rng = np.random.default_rng(0)
    done, cfg = 50, dict(epochs=120, lr=0.05, plateau_every=40, tail_max=30,
                         layout=layout)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    data = {"ta": np.full(2, 0.31, np.float32),
            "tb": np.full(3, -0.2, np.float32)}
    params = {k: v + 0.05 * f32(*v.shape) for k, v in
              zip(("a", "b"), data.values())}
    mu = {"a": 0.01 * f32(2), "b": 0.01 * f32(3)}
    nu = {"a": 1e-3 * np.abs(f32(2)), "b": 1e-3 * np.abs(f32(3))}
    lr, ring = np.float32(0.025), 0.2 + 0.01 * np.abs(f32(40))
    hist = 0.2 + 0.01 * np.abs(f32(done, 3))
    F = np.ones((3, 3), np.float32)
    ravel = lambda t: np.concatenate([t["a"], t["b"]])
    if layout == "flat":
        p_c, mu_c, nu_c = ravel(params), ravel(mu), ravel(nu)
    else:
        p_c, mu_c, nu_c = params, mu, nu

    # tpinn: its step-0 carry with the carried leaves put in
    phase_j = jopt.make_adam_phase(_l1_j, None, None,
                                   jopt.AdamConfig(**cfg), info_width=3)
    key = jax.random.PRNGKey(0)
    asj = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    _, opt0, _, _, _, _ = phase_j.make_state0(key, asj(params), asj(data),
                                              jnp.asarray(F), jnp.array(1.0))
    adam = opt0.inner_state[0]._replace(count=jnp.int32(done), mu=asj(mu_c),
                                        nu=asj(nu_c))
    opt = opt0._replace(
        count=jnp.int32(done),
        hyperparams={**opt0.hyperparams, "learning_rate": jnp.asarray(lr)},
        inner_state=(adam,) + tuple(opt0.inner_state[1:]))
    carry = (asj(p_c), opt, asj(data), jnp.asarray(F), key, jnp.asarray(ring))
    rj = phase_j(key, asj(params), asj(data), jnp.asarray(F),
                 jnp.array([1.0]), jnp.array(1.0),
                 init=(done, carry, jnp.asarray(hist)))

    # the port, from the same carry
    phase_t = topt.make_adam_phase(_l1_t, None, None,
                                   topt.AdamConfig(**cfg), info_width=3)
    gen = torch.Generator().manual_seed(0)
    init = phase_init_from_tpinn(p_c, done, mu_c, nu_c, lr, ring, data, F,
                                 hist, gen, layout=layout)
    pt = jax.tree_util.tree_map(torch.from_numpy, params)
    rt = phase_t(gen, pt, init[1]["data"], torch.from_numpy(F),
                 torch.tensor([1.0]), torch.tensor(1.0), init=init)

    n = int(rj.n_valid)
    assert rt.n_valid == n > cfg["epochs"]         # the tail ran
    hj = np.asarray(rj.history)[:n]
    np.testing.assert_array_equal(rt.history[:done].numpy(), hist)
    np.testing.assert_allclose(rt.history[:n].numpy(), hj, rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(jax.tree_util.tree_leaves(rj.params),
                    topt.tree_leaves(rt.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(rt.lr.numpy(), np.asarray(rj.lr).reshape(-1),
                               rtol=1e-6)
    assert float(rt.lr) == pytest.approx(0.0125)   # halved once more


# ---------------------------------------------------------------------------
# run_training: killed, resumed, bit for bit
# ---------------------------------------------------------------------------


def _spec(layout="flat", checkpoint_every=50, **kw):
    """tests/test_train_e2e.py's resume spec with the draws, the density
    refreshes and a plateau check inside every window of 100 steps, and a
    tail."""
    st = StageSpec(depth=2, width=16, scl=1.0, epsil=1.0, adam_epochs=200,
                   lbfgs_epochs=30)
    return TrainSpec(
        n_col=128, n_band=32, n_adaptive=32, n_bd=16, testing_size=(64,),
        lw=(1.0, 0.0), grid=41, stages=(st,), resample_every=30,
        density_every=40, plateau_every=60, tail_max=20, log_every=5,
        checkpoint_every=checkpoint_every, adam_layout=layout, **kw)


def _run(spec, out=None, **kw):
    return train.run_training(problems.poisson_1d(), spec,
                              output_dir=None if out is None else str(out),
                              device="cpu", **kw)


def _kill_and_resume(tmp_path, monkeypatch, save_spec, resume_spec):
    out = tmp_path / "b"
    restore = _killed_at(monkeypatch, ckpt, 100)
    with pytest.raises(Killed):
        _run(save_spec, out)
    restore()
    meta = json.loads(bytes(np.load(out / "adam_state_stage_1.npz")[
        "__meta__"]).decode())
    assert meta["done"] == 100
    assert not (out / "params_stage_1.npz").exists()
    lines = []
    res = _run(resume_spec, out, resume=True, log_fn=lines.append)
    return res, lines


def test_midstage_resume_bit_exact(tmp_path, monkeypatch):
    res_a = _run(_spec(), tmp_path / "a")
    res_b, lines = _kill_and_resume(tmp_path, monkeypatch, _spec(), _spec())
    assert "stage 1: resuming Adam mid-stage at step 100/200" in lines
    assert res_a.stages[0].history.shape[0] > 200    # the tail ran
    np.testing.assert_array_equal(res_b.stages[0].history,
                                  res_a.stages[0].history)
    assert _same_leaves(res_a.stages[0].params, res_b.stages[0].params)
    assert res_b.rel_l2 == res_a.rel_l2


def test_checkpointing_does_not_perturb(tmp_path):
    saving = _run(_spec(), tmp_path)
    plain = _run(_spec(checkpoint_every=0))
    np.testing.assert_array_equal(saving.history, plain.history)
    assert _same_leaves(saving.stages[0].params, plain.stages[0].params)
    with np.load(tmp_path / "adam_state_stage_1.npz") as f:
        meta = json.loads(bytes(f["__meta__"]).decode())
        assert f["__hist__"].shape == (200, saving.history.shape[1])
    assert meta == {"done": 200, "layout": "flat",
                    "format": ckpt.PHASE_FORMAT}


def test_midstage_resume_across_adam_layout(tmp_path, monkeypatch):
    """A file written under layout="tree" resumes under a "flat" spec: the
    stage finishes under the file's layout, as an uninterrupted tree-layout
    run does."""
    res_a = _run(_spec("tree"), tmp_path / "a")
    res_b, lines = _kill_and_resume(tmp_path, monkeypatch, _spec("tree"),
                                    _spec("flat"))
    assert any("resuming this stage under layout='tree' at step 100/200" in ln
               for ln in lines), lines[:20]
    np.testing.assert_array_equal(res_b.stages[0].history,
                                  res_a.stages[0].history)
    assert _same_leaves(res_a.stages[0].params, res_b.stages[0].params)


def test_tpinn_phase_file_restarts_the_phase(tmp_path):
    """A phase file of tpinn (its scan carry, saved by its
    save_phase_state) is refused by load_phase_state, and a resumed run
    logs it unusable and trains from step 0: the fresh run's result."""
    key = jax.random.PRNGKey(0)
    phase_j = jopt.make_adam_phase(_l1_j, None, None,
                                   jopt.AdamConfig(epochs=10), info_width=3)
    carry = phase_j.make_state0(
        key, {"a": jnp.zeros(2), "b": jnp.zeros(3)},
        {"ta": jnp.zeros(2), "tb": jnp.zeros(3)}, jnp.ones((3, 3)),
        jnp.array(1.0))
    path = tmp_path / "adam_state_stage_1.npz"
    jckpt.save_phase_state(path, 5, carry, jnp.ones((5, 3)))
    like = {"p": [torch.zeros(5)], "gen": torch.Generator().get_state()}
    with pytest.raises(ValueError, match="not a tpinn_torch phase file"):
        ckpt.load_phase_state(path, like, "flat")

    lines = []
    res = _run(_spec(checkpoint_every=0), tmp_path, resume=True,
               log_fn=lines.append)
    assert any("mid-stage checkpoint unusable (" in ln
               and "restarting the Adam phase" in ln for ln in lines)
    fresh = _run(_spec(checkpoint_every=0))
    np.testing.assert_array_equal(res.history, fresh.history)


def test_phase_file_leaf_shape_is_checked(tmp_path):
    """A phase file whose point set no longer fits the sampler (n_col
    changed since the save): ValueError naming the leaf."""
    _run(dataclasses.replace(_spec(), stages=(dataclasses.replace(
        _spec().stages[0], adam_epochs=50),)), tmp_path)
    phase = topt.make_adam_phase(None, None, None, topt.AdamConfig(
        epochs=50, plateau_every=60), info_width=5)
    params = {"layers": [{"w": torch.zeros(1, 16), "b": torch.zeros(16)},
                         {"w": torch.zeros(16, 16), "b": torch.zeros(16)},
                         {"w": torch.zeros(16, 1), "b": torch.zeros(1)}]}
    data = {"x_col": torch.zeros(100, 1), "x_bd": [torch.zeros(16, 1)] * 2,
            "u_bd": [torch.zeros(16, 1)] * 2}
    like = phase.make_state0(torch.Generator(), params, data,
                             torch.ones(41), torch.tensor(1.0))
    with pytest.raises(ValueError, match="leaf:data/x_col"):
        ckpt.load_phase_state(tmp_path / "adam_state_stage_1.npz", like,
                              "flat")


# ---------------------------------------------------------------------------
# run_patched
# ---------------------------------------------------------------------------


def _hf_poisson(w):
    return ProblemSpec(
        name="hf_poisson", equation=f"u_xx + {w * w}*sin({w}*x)",
        coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0),
                   sample.BCGroup(lo=(1.0,), hi=(1.0,), value=0.0)),
        exact=lambda z: torch.sin(w * z),
    )


def _patch_spec(log_every=50, adam=50):
    """tests/test_patch.py's resume spec (log_every 2: a save every 20
    steps, the draws every 10)."""
    return TrainSpec(
        n_col=128, n_band=0, n_adaptive=0, n_bd=8, testing_size=(64,),
        lw=(1e-3, 0.0), grid=32, checkpoint_every=20, resample_every=10,
        stages=(StageSpec(depth=2, width=8, scl=1.0, epsil=1.0,
                          adam_epochs=adam, lbfgs_epochs=0),),
        log_every=log_every, density_every=10**9, plateau_every=10**9)


def test_patched_resume(tmp_path):
    """tests/test_patch.py's case: resume=True short-circuits a finished
    run and picks a killed one back up from the mid-Adam checkpoint."""
    prob, spec, pspec = _hf_poisson(2 * PI), _patch_spec(), PatchSpec(n=(2,))
    r1 = run_patched(prob, spec, pspec, output_dir=str(tmp_path),
                     device="cpu")
    assert (tmp_path / "adam_state_stage_1.npz").exists()
    r2 = run_patched(prob, spec, pspec, output_dir=str(tmp_path),
                     resume=True, device="cpu")
    assert r2.history.shape[0] == 0
    assert r2.rel_l2 == pytest.approx(r1.rel_l2, rel=1e-6)
    (tmp_path / "params_stage_1.npz").unlink()
    lines = []
    r3 = run_patched(prob, spec, pspec, output_dir=str(tmp_path),
                     resume=True, log_fn=lines.append, device="cpu")
    assert "patched: resuming Adam mid-run at step 50/50" in lines
    assert np.isfinite(r3.rel_l2)
    assert (tmp_path / "params_stage_1.npz").exists()


def test_patched_resume_bit_exact(tmp_path, monkeypatch):
    prob, pspec = _hf_poisson(2 * PI), PatchSpec(n=(2,))
    spec = _patch_spec(log_every=2, adam=60)
    res_a = run_patched(prob, spec, pspec, output_dir=str(tmp_path / "a"),
                        device="cpu")
    restore = _killed_at(monkeypatch, ckpt, 20)
    with pytest.raises(Killed):
        run_patched(prob, spec, pspec, output_dir=str(tmp_path / "b"),
                    device="cpu")
    restore()
    lines = []
    res_b = run_patched(prob, spec, pspec, output_dir=str(tmp_path / "b"),
                        resume=True, log_fn=lines.append, device="cpu")
    assert "patched: resuming Adam mid-run at step 20/60" in lines
    np.testing.assert_array_equal(res_b.history, res_a.history)
    assert _same_leaves(res_a.params, res_b.params)


# ---------------------------------------------------------------------------
# lbfgs_device; the entry points that take no phase file
# ---------------------------------------------------------------------------


def test_lbfgs_device_cpu_equals_the_training_device():
    """Two composed hard-BC stages with a ring penalty, two L-BFGS rounds
    on density draws: the loss rebuilt for the CPU gives the same bits."""
    prob = problems.with_hard_bc(problems.helmholtz_2d())
    st1 = StageSpec(depth=2, width=12, scl=1.0, epsil=1.0, adam_epochs=20,
                    lbfgs_epochs=6, lbfgs_rounds=2)
    st2 = StageSpec(depth=2, width=10, act_first="sin", adam_epochs=10,
                    lbfgs_epochs=3)
    spec = TrainSpec(n_col=200, n_band=40, n_adaptive=40, n_bd=20, grid=21,
                     testing_size=(21, 21), tail_max=5, stages=(st1, st2),
                     ring_weight=0.1, density_every=10, plateau_every=20)
    base = train.run_training(prob, spec, device="cpu")
    lines = []
    on_cpu = train.run_training(
        prob, dataclasses.replace(spec, lbfgs_device="cpu"), device="cpu",
        log_fn=lines.append)
    assert sum("L-BFGS on the host CPU" in ln for ln in lines) == 2
    assert any("ring penalty on" in ln for ln in lines)
    np.testing.assert_array_equal(on_cpu.history, base.history)
    assert _same_leaves(on_cpu.stages[-1].params, base.stages[-1].params)
    with pytest.raises(ValueError, match="lbfgs_device"):
        train.run_training(prob, dataclasses.replace(spec, lbfgs_device="tpu"),
                           device="cpu")


def _osc_system():
    return SystemSpec(
        name="osc_system", equations=("u_x - v", "v_x + pi**2*u"),
        fields=("u", "v"), coords=("x",), lb=(0.0,), ub=(1.0,),
        bc_groups=(
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=0.0, field=0),
            sample.BCGroup(lo=(0.0,), hi=(0.0,), value=float(PI), field=1)))


@pytest.mark.parametrize("entry", ["run_system", "run_inverse"])
@pytest.mark.parametrize("field", ["checkpoint_every", "lbfgs_device"])
def test_entries_without_phase_files_refuse(entry, field):
    """tpinn's run_system and run_inverse write no phase file and ignore
    both fields; the port refuses them before any work."""
    spec = TrainSpec(n_col=32, n_band=0, n_adaptive=0, n_bd=4,
                     stages=(StageSpec(depth=1, width=4, adam_epochs=1,
                                       lbfgs_epochs=3),),
                     **{field: 10 if field == "checkpoint_every" else "cpu"})
    with pytest.raises(ValueError, match=f"{entry}.*{field}"):
        if entry == "run_system":
            run_system(_osc_system(), spec, device="cpu")
        else:
            run_inverse(problems.poisson_1d(),
                        InverseSpec(params=("lam",), init=(0.5,), n_obs=8),
                        spec, device="cpu")
