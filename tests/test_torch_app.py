"""The online calculator in tpinn_torch against tpinn's, on the CPU.

- The UI option registry, ``parse_coef_list`` and ``coerce_ui_option``:
  the same values, or the same exception type, over a table of good and
  bad inputs.
- ``TrainingRequest.validate``: the same verdict and message over
  tests/test_app.py's cases.
- ``run_pinn_training``: both packages' training entries replaced by
  stubs (``run_training``, ``run_time_marching``, ``run_inverse``), the
  same request through both, and what they build compared field by field
  (tests/torch_spec_compare.py: plain fields equal, callables on seeded
  float32 points at rtol 1e-6, atol 1e-6).  The one field that differs
  is ``pad_features``: 0 in the port, tpinn's 3 a TPU workaround.
- Figure payloads, equal on artifacts written by tpinn_torch.utils.
  artifacts; preset payloads equal but for the note's command; the log
  buffers, log callback and Tee alike.
- The port alone (the packages' random streams differ by design): a
  SessionManager run of tests/test_app.py's tiny request on the CPU,
  two overlapping sessions that take turns on the device and leave
  ``torch.backends.cuda.matmul.allow_tf32`` as they found it, and a lite
  HTTP round trip.
"""

import io
import json
import logging
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import tpinn.app.controller as jcontroller
import tpinn.app.figure_data as jfigures
import tpinn.app.presets as jpresets
import tpinn.core.inverse as jinverse
import tpinn.core.march as jmarch
import tpinn.core.train as jtrain
import tpinn.utils.logging as jlogging
import tpinn_torch.app.controller as tcontroller
import tpinn_torch.app.figure_data as tfigures
import tpinn_torch.app.presets as tpresets
import tpinn_torch.core.inverse as tinverse
import tpinn_torch.core.march as tmarch
import tpinn_torch.core.train as ttrain
import tpinn_torch.utils.logging as tlogging
from tpinn_torch import problems as tproblems
from tpinn_torch.utils import artifacts
from torch_spec_compare import (assert_dataclass_equal, assert_problem_equal,
                                assert_spec_equal)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny nets: one intra-op thread is as fast as eight alone, and many
    times faster when several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ANNULUS_BC = {
    "bd_x1_min": 0.1, "bd_x1_max": 0.1, "bd_y1_min": 0, "bd_y1_max": 1,
    "bd_u1": 1,
    "bd_x2_min": 1, "bd_x2_max": 1, "bd_y2_min": 0, "bd_y2_max": 1,
    "bd_u2": 0,
}
HEAT_BC = {
    "bd_x1_min": 0, "bd_x1_max": 1, "bd_y1_min": 0, "bd_y1_max": 0,
    "bd_u1": "sin(pi*x)",
    "bd_x2_min": 0, "bd_x2_max": 0, "bd_y2_min": 0, "bd_y2_max": 1,
    "bd_u2": 0,
    "bd_x3_min": 1, "bd_x3_max": 1, "bd_y3_min": 0, "bd_y3_max": 1,
    "bd_u3": 0,
}
SQUARE_BC = {
    "bd_x1_min": 0, "bd_x1_max": 0, "bd_y1_min": 0, "bd_y1_max": 1,
    "bd_u1": 0,
    "bd_x2_min": 1, "bd_x2_max": 1, "bd_y2_min": 0, "bd_y2_max": 1,
    "bd_u2": 0,
}
UNIT = {"x_min": 0, "x_max": 1, "y_min": 0, "y_max": 1}


def _tiny(**over):
    """tests/test_app.py's _tiny_request, as keyword arguments."""
    base = dict(
        equation="u_rr + 1/r*u_r + 1/r**2*u_tt", boundary=ANNULUS_BC,
        domain={"x_min": 0.1, "x_max": 1, "y_min": 0, "y_max": 1},
        sample_points={"n_col": 120, "n_bd": 30, "n_add": 30},
        network_size={"depth": 16, "width": 2},
        testing_size={"x": 31, "y": 31},
        epochs={"adam": 25, "lbfgs": 12},
    )
    base.update(over)
    return base


# ---------------------------------------------------------------------------
# The option registry
# ---------------------------------------------------------------------------


def test_ui_option_registry_equals_tpinn():
    assert ttrain.UI_OPTION_SPEC == jtrain.UI_OPTION_SPEC
    assert list(ttrain.UI_OPTION_SPEC) == list(jtrain.UI_OPTION_SPEC)
    assert ttrain._UI_STAGE_OPTIONS == jtrain._UI_STAGE_OPTIONS
    assert ttrain._UI_INVERSE_OPTIONS == jtrain._UI_INVERSE_OPTIONS
    from tpinn_torch.core import loss

    assert ttrain.UI_OPTION_SPEC["adam_engine"] == loss.ENGINES


def _same_outcome(f_port, f_tpinn, *args):
    """Both calls return equal values, or raise the same exception type."""
    outcomes = []
    for f in (f_port, f_tpinn):
        try:
            outcomes.append(("ok", f(*args)))
        except Exception as e:  # the type is what is compared
            outcomes.append(("raised", type(e)))
    assert outcomes[0] == outcomes[1], outcomes
    return outcomes[0]


@pytest.mark.parametrize("text", [
    "", "lam=0.5", "lam=0.5,k=1", " a = 2 , ", "lam=1,,k=-3e-2", "lam",
    "1x=2", "lam=abc", "a.b=1", "k=1=2", 0, None,
])
def test_parse_coef_list_equals_tpinn(text):
    _same_outcome(ttrain.parse_coef_list, jtrain.parse_coef_list, text)


@pytest.mark.parametrize("key,value", [
    ("deflation", "full"), ("deflation", "sometimes"), ("lsq_polish", "on"),
    ("adam_precision", "default"), ("adam_precision", "low"),
    ("adam_engine", "kernel"), ("adam_engine", "fast"),
    ("lr_min", "1e-5"), ("lr_min", "tiny"), ("lr_min", None),
    ("lbfgs_rounds", 3), ("lbfgs_rounds", "3.0"), ("lbfgs_rounds", 2.5),
    ("lbfgs_grid", "x"), ("ring_weight", 0), ("causal_eps", "0.1"),
    ("causal_bins", 16.0), ("march", "4"), ("march", 0),
    ("inverse_params", "lam=1,k=2"), ("inverse_params", "lam"),
    ("n_obs", "50"), ("obs_noise", "1e-2"), ("oracle", ""),
    ("oracle", "heat_2d"), ("oracle", "no_such_preset"), ("rm_rf", "/"),
])
def test_coerce_ui_option_equals_tpinn(key, value):
    kind, got = _same_outcome(ttrain.coerce_ui_option,
                              jtrain.coerce_ui_option, key, value)
    if kind == "ok":
        assert type(got) is type(jtrain.coerce_ui_option(key, value))


# ---------------------------------------------------------------------------
# Request validation
# ---------------------------------------------------------------------------


_OPT_BASE = dict(
    equation="u_xx + u_yy",
    boundary={"bd_x1_min": 0.0, "bd_x1_max": 0.0, "bd_y1_min": 0.0,
              "bd_y1_max": 1.0, "bd_u1": 0.0},
    domain={"x_min": 0.0, "x_max": 1.0, "y_min": 0.0, "y_max": 1.0})

REQUESTS = {
    "tiny": _tiny(),
    "bad_equation": _tiny(equation="u_x ++"),
    "bad_domain": _tiny(domain={"x_min": 1, "x_max": 0.1, "y_min": 0,
                                "y_max": 1}),
    "bad_y_domain": _tiny(domain={"x_min": 0.1, "x_max": 1, "y_min": 1,
                                  "y_max": 1}),
    "missing_boundary": _tiny(boundary={"bd_x1_min": 0.1}),
    "no_groups": _tiny(boundary={}),
    "expression_bc": _tiny(equation="u_t - u_xx", boundary=HEAT_BC,
                           domain=UNIT),
    "bc_references_u": _tiny(equation="u_t - u_xx",
                             boundary={**HEAT_BC, "bd_u1": "sin(pi*u)"},
                             domain=UNIT),
    "bc_not_an_expression": _tiny(boundary={**ANNULUS_BC, "bd_u1": "1 +"}),
    "options_ok": dict(_OPT_BASE, options={"deflation": "full",
                                           "lsq_polish": "auto",
                                           "lbfgs_rounds": 3}),
    "option_bad_value": dict(_OPT_BASE, options={"deflation": "sometimes"}),
    "option_unknown": dict(_OPT_BASE, options={"rm_rf": "/"}),
    "option_not_numeric": dict(_OPT_BASE, options={"lr_min": "tiny"}),
    "option_not_integral": dict(_OPT_BASE, options={"march": 2.5}),
    "options_not_a_dict": dict(_OPT_BASE, options=["march"]),
    "inverse_declared": _tiny(equation="u_t - lam*u_xx", boundary=HEAT_BC,
                              domain=UNIT,
                              options={"inverse_params": "lam=0.5",
                                       "oracle": "heat_2d"}),
    "inverse_undeclared": _tiny(equation="u_t - lam*u_xx",
                                boundary=HEAT_BC, domain=UNIT),
    "inverse_bad_list": _tiny(equation="u_t - lam*u_xx", boundary=HEAT_BC,
                              domain=UNIT,
                              options={"inverse_params": "lam"}),
    "oracle_unknown": _tiny(options={"oracle": "no_such_preset"}),
}


@pytest.mark.parametrize("case", list(REQUESTS))
def test_request_validation_equals_tpinn(case):
    got = tcontroller.TrainingRequest(**REQUESTS[case]).validate()
    want = jcontroller.TrainingRequest(**REQUESTS[case]).validate()
    assert got == want
    assert (got is None) == (case in ("tiny", "expression_bc", "options_ok",
                                      "inverse_declared"))


# ---------------------------------------------------------------------------
# What run_pinn_training builds
# ---------------------------------------------------------------------------


def _window(rel_l2, rows):
    return types.SimpleNamespace(rel_l2=rel_l2,
                                 history=np.full((rows, 5), rel_l2))


RESULT = types.SimpleNamespace(
    rel_l2=0.25, history=np.arange(15.0).reshape(3, 5), predict=None,
    fell_back=False, windows=[_window(0.5, 2), _window(0.75, 4)])


@pytest.fixture
def captured(monkeypatch):
    """Both packages' training entries replaced by stubs that record their
    arguments: {"port": [...], "tpinn": [...]} of (name, args, kwargs)."""
    calls = {"port": [], "tpinn": []}

    def stub(pkg, name):
        def record(*args, **kwargs):
            calls[pkg].append((name, args, kwargs))
            return RESULT
        return record

    for pkg, mods in (("port", (ttrain, tmarch, tinverse)),
                      ("tpinn", (jtrain, jmarch, jinverse))):
        for mod, name in zip(mods, ("run_training", "run_time_marching",
                                    "run_inverse")):
            monkeypatch.setattr(mod, name, stub(pkg, name))
    return calls


UI_CASES = {
    # tpinn's __main__ demo: polar Laplace, the oracle installed by "auto"
    "plain": dict(_tiny(), options=None),
    "options": dict(_tiny(), options={
        "deflation": "full", "lsq_polish": "auto", "lbfgs_rounds": 3,
        "lbfgs_grid": "50", "adam_engine": "kernel",
        "adam_precision": "default", "lr_min": "1e-5", "ring_weight": 0.5,
        "not_an_option": 1}),
    "expression_bc": dict(_tiny(equation="u_t - u_xx", boundary=HEAT_BC,
                                domain=UNIT)),
    "cartesian": dict(_tiny(
        equation="u_xx + u_yy + 2*3.14159**2*sin(3.14159*x)*sin(3.14159*y)",
        boundary=SQUARE_BC, domain=UNIT)),
    "one_coordinate": dict(_tiny(equation="u_xx + sin(pi*x)",
                                 boundary=SQUARE_BC, domain=UNIT)),
    "march": dict(_tiny(equation="u_t - u_xx", boundary=HEAT_BC,
                        domain=UNIT),
                  options={"march": 3, "causal_eps": "0.1"}),
    "inverse": dict(_tiny(equation="u_t - lam*u_xx", boundary=HEAT_BC,
                          domain=UNIT),
                    options={"inverse_params": "lam=0.5", "oracle": "heat_2d",
                             "n_obs": 50, "obs_noise": 0.01,
                             "lsq_polish": "auto", "ring_weight": 1.0}),
    "inverse_polar": dict(_tiny(equation="u_rr + 1/r*u_r + k/r**2*u_tt"),
                          options={"inverse_params": "k=2",
                                   "oracle": "annulus_laplace"}),
}
UI_ERRORS = {
    "march_and_inverse": dict(_tiny(), options={
        "march": 2, "inverse_params": "lam=1"}),
    "inverse_without_oracle": dict(_tiny(
        equation="u_t - lam*u_xx", boundary=HEAT_BC, domain=UNIT),
        options={"inverse_params": "lam=0.5"}),
    "oracle_of_another_dimension": dict(_tiny(
        equation="u_t - lam*u_xx", boundary=HEAT_BC, domain=UNIT),
        options={"inverse_params": "lam=0.5", "oracle": "poisson_1d"}),
    "bad_option": dict(_tiny(), options={"deflation": "sometimes"}),
}


def _ui_kwargs(case):
    kw = dict(scl=2.0, epsil=0.5, equation_weight={"f": 0.05, "df": 0},
              output_dir="unused")
    kw.update(case)
    return kw


@pytest.mark.parametrize("case", list(UI_CASES))
def test_run_pinn_training_builds_tpinns_specs(case, captured):
    logs = {"port": [], "tpinn": []}
    res_t = ttrain.run_pinn_training(**_ui_kwargs(UI_CASES[case]),
                                     log_fn=logs["port"].append,
                                     device="cpu")
    res_j = jtrain.run_pinn_training(**_ui_kwargs(UI_CASES[case]),
                                     log_fn=logs["tpinn"].append)
    assert logs["port"] == logs["tpinn"]
    (name_t, args_t, kw_t), = captured["port"]
    (name_j, args_j, kw_j), = captured["tpinn"]
    assert name_t == name_j
    assert kw_t.pop("device") == "cpu"
    assert kw_t.pop("log_fn") == logs["port"].append
    assert kw_j.pop("log_fn") == logs["tpinn"].append
    assert kw_t == kw_j
    assert len(args_t) == len(args_j)
    assert_problem_equal(args_t[0], args_j[0])
    spec_t, spec_j = args_t[-1 if name_t == "run_inverse" else 1], \
        args_j[-1 if name_j == "run_inverse" else 1]
    # the one deviation: the port reads the coordinates unpadded
    assert (spec_t.pad_features, spec_j.pad_features) == (0, 3)
    assert_spec_equal(spec_t, spec_j, skip=("pad_features",))
    if name_t == "run_time_marching":
        assert args_t[2] == args_j[2] == 3
    if name_t == "run_inverse":
        assert_dataclass_equal(args_t[1], args_j[1])
        assert len(spec_t.stages) == 1
    # the result: run_training's own, or a TrainResult over the stub's
    if name_t == "run_training":
        assert res_t is RESULT and res_j is RESULT
        return
    for field in ("rel_l2", "fell_back", "stages"):
        assert getattr(res_t, field) == getattr(res_j, field), field
    np.testing.assert_array_equal(res_t.history, np.asarray(res_j.history))
    assert res_t.stages == [] and res_t.fell_back is False
    assert_problem_equal(res_t.problem, res_j.problem)
    assert_spec_equal(res_t.spec, res_j.spec, skip=("pad_features",))


@pytest.mark.parametrize("case", list(UI_ERRORS))
def test_run_pinn_training_refuses_as_tpinn(case, captured):
    kinds = []
    for f, kw in ((ttrain.run_pinn_training, {"device": "cpu"}),
                  (jtrain.run_pinn_training, {})):
        with pytest.raises(ValueError) as e:
            f(**_ui_kwargs(UI_ERRORS[case]), **kw)
        kinds.append(str(e.value).replace("tpinn_torch.", "tpinn."))
    assert kinds[0] == kinds[1]
    assert captured == {"port": [], "tpinn": []}


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        tcontroller.SessionManager(str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.run_pinn_training(**_ui_kwargs(_tiny()))


# ---------------------------------------------------------------------------
# Figures, presets, logs
# ---------------------------------------------------------------------------


def _write_artifacts(out, seed=0):
    """All 11 artifacts through tpinn_torch.utils.artifacts, seeded."""
    rng = np.random.default_rng(seed)
    r, t = np.linspace(0.1, 1.0, 9), np.linspace(0.0, 2.0, 7)
    for stage in (1, 2):
        artifacts.write_collocation(out / f"collocation_point_{stage}.npz",
                                    U=rng.random((7, 9)),
                                    X_col=rng.random((40, 2)),
                                    limit=[0.1, 1.0, 0.0, 2.0])
        artifacts.write_solution_residual(
            out / f"solution_residual_{stage}.npz", r, t,
            rng.random((7, 9)), rng.standard_normal((7, 9)), stage)
        artifacts.write_error(out / f"error_{stage}.npz", r, t,
                              rng.standard_normal((7, 9)))
        artifacts.write_loss(out / f"loss_{stage}.npz",
                             np.abs(rng.standard_normal((2500, 6))) + 1e-3)
        artifacts.write_boundary_loss(out / f"boundary_loss_{stage}.npz",
                                      rng.random(30), rng.random(30))
    artifacts.write_spectrum(out / "frequency_spectrum.npz",
                             np.linspace(-5, 5, 9), np.linspace(-5, 5, 7),
                             rng.random((7, 9)))


def test_figure_payloads_equal_tpinn(tmp_path):
    assert {k: v[0] for k, v in tfigures.FIGURES.items()} == {
        k: v[0] for k, v in jfigures.FIGURES.items()}
    for name in (*jfigures.FIGURES, "nope"):
        assert tfigures.figure_payload(tmp_path, name) == \
            jfigures.figure_payload(tmp_path, name)
    _write_artifacts(tmp_path)
    for name in jfigures.FIGURES:
        got = tfigures.figure_payload(tmp_path, name)
        assert got["type"] != "missing", name
        assert json.dumps(got) == json.dumps(
            jfigures.figure_payload(tmp_path, name)), name


def test_preset_payloads_equal_tpinn():
    assert tpresets.preset_names() == jpresets.preset_names()
    assert tpresets.oracle_names() == jpresets.oracle_names()
    for name in tproblems.PRESETS:
        got, want = tpresets.preset_payload(name), \
            jpresets.preset_payload(name)
        if want["train"] is not None:
            assert got["train"]["note"] == want["train"]["note"].replace(
                "python -m tpinn ", "python -m tpinn_torch ")
            got["train"].pop("note")
            want["train"].pop("note")
        assert got == want, name
        assert tpresets._ui_expressible(tproblems.get_problem(name)) == \
            (name in jpresets.preset_names())
    with pytest.raises(KeyError):
        tpresets.preset_payload("no_such_preset")


def _log_trace(mod):
    """One sequence of operations on a package's logging module, and what
    it shows."""
    buf = mod.LogBuffer(maxlen=3)
    for k in range(5):
        buf.append(f"line {k}")
    seen = [buf.lines(), len(buf)]
    buf.extend(["a", "b"])
    seen += [buf.text(), len(buf)]
    buf.clear()
    seen.append(buf.lines())
    logs = mod.SessionLogs(maxlen=2)
    first = logs.get("s1")
    seen.append(logs.get("s1") is first)
    logs.drop("s1")
    seen.append(logs.get("s1") is first)
    log_fn = mod.make_log_fn(first)
    log_fn(np.int64(100), np.array([1.5, 2.5e-3, 7.0]))
    seen.append(first.lines())
    sink = io.StringIO()
    tee = mod.Tee(sink, first)
    seen.append(tee.write("part"))
    tee.write("ial\n\n  \nnext\nlast")
    seen += [first.lines(), sink.getvalue(), tee.isatty()]
    handler = mod.BufferHandler(first)
    seen.append(handler.level == logging.INFO)
    return seen


def test_logging_behaves_as_tpinns():
    assert _log_trace(tlogging) == _log_trace(jlogging)
    assert tlogging.format_step_line(7, [1.0, 2.0, 3.0]) == \
        jlogging.format_step_line(7, [1.0, 2.0, 3.0])


def test_redirect_std_streams(capsys):
    import sys

    buf = tlogging.LogBuffer()
    before = sys.stdout, sys.stderr
    tlogging.redirect_std_streams(buf)
    try:
        print("to the log")
        print("and the errors", file=sys.stderr)
    finally:
        sys.stdout, sys.stderr = before
    assert buf.lines() == ["to the log", "and the errors"]
    assert capsys.readouterr().out == "to the log\n"


# ---------------------------------------------------------------------------
# Sessions and the lite app (the port alone)
# ---------------------------------------------------------------------------


def _finish(mgr, sid, timeout=300):
    thread = mgr.get(sid).thread
    thread.join(timeout=timeout)
    assert not thread.is_alive(), f"session {sid} still running"
    return mgr.status(sid)


def test_session_trains_tiny_request_on_the_cpu(tmp_path):
    mgr = tcontroller.SessionManager(str(tmp_path), device="cpu")
    assert mgr.device == torch.device("cpu")
    sid = mgr.new_session_id()
    assert mgr.start(sid, tcontroller.TrainingRequest(**_tiny())) is None
    if mgr.get(sid).status == "running":
        assert mgr.start(sid, tcontroller.TrainingRequest(**_tiny())) == \
            "training already running for this session"
    st = _finish(mgr, sid)
    assert st["status"] == "done", (st["error"], st["log"][-800:])
    assert "training finished" in st["log"]
    assert "final rel-L2 vs analytic" in st["log"]
    assert sorted(p.name for p in (tmp_path / sid).glob("*.npz")
                  if not p.name.startswith("params")) == sorted(
        f for f, _ in tfigures.FIGURES.values())
    for name in tfigures.FIGURES:
        assert tfigures.figure_payload(tmp_path / sid, name)["type"] != \
            "missing", name
    # an invalid request never starts a thread
    assert "parse" in mgr.start(sid, tcontroller.TrainingRequest(
        **_tiny(equation="u_x ++")))


def test_session_surfaces_errors(tmp_path):
    mgr = tcontroller.SessionManager(str(tmp_path), device="cpu")
    req = tcontroller.TrainingRequest(**_tiny(
        equation="u_t - lam*u_xx", boundary=HEAT_BC, domain=UNIT,
        options={"inverse_params": "lam=0.5"}))
    assert req.validate() is None
    assert mgr.start("s", req) is None
    st = _finish(mgr, "s")
    assert st["status"] == "error"
    assert "analytic oracle" in st["error"]
    assert "TRAINING FAILED" in st["log"]
    assert _run_lock_free()


def _run_lock_free() -> bool:
    """No thread holds the port's training lock (core.train._RUN_LOCK)."""
    if not ttrain._RUN_LOCK.acquire(blocking=False):
        return False
    ttrain._RUN_LOCK.release()
    return True


def test_overlapping_sessions_take_turns_and_restore_tf32(tmp_path,
                                                          monkeypatch):
    """Two sessions started together, adam_precision "default" (TF32 on in
    its Adam phase) and "highest": the second waits for the device, each
    Adam phase sees its own setting, and the process-wide flag is back at
    its starting value at the end."""
    seen = []
    inner = ttrain.adam_matmul_precision

    def spy(name):
        ctx = inner(name)

        class Spy:
            def __enter__(self):
                ctx.__enter__()
                seen.append((name, torch.backends.cuda.matmul.allow_tf32))

            def __exit__(self, *exc):
                return ctx.__exit__(*exc)
        return Spy()

    monkeypatch.setattr(ttrain, "adam_matmul_precision", spy)
    before = torch.backends.cuda.matmul.allow_tf32
    mgr = tcontroller.SessionManager(str(tmp_path), device="cpu")
    small = _tiny(network_size={"depth": 8, "width": 2},
                  epochs={"adam": 10, "lbfgs": 6})
    with ttrain._RUN_LOCK:              # a third party holds the device
        for sid, prec in (("fast", "default"), ("exact", "highest")):
            assert mgr.start(sid, tcontroller.TrainingRequest(
                **small, options={"adam_precision": prec})) is None
        deadline = time.time() + 60
        while time.time() < deadline and not all(
                "waiting for the device" in mgr.status(s)["log"]
                for s in ("fast", "exact")):
            time.sleep(0.01)
        for sid in ("fast", "exact"):
            st = mgr.status(sid)
            assert st["status"] == "running"
            assert st["log"].splitlines() == [
                f"session {sid}: training started",
                "waiting for the device (another training run holds it)"]
    for sid in ("fast", "exact"):
        st = _finish(mgr, sid)
        assert st["status"] == "done", (st["error"], st["log"][-800:])
    assert torch.backends.cuda.matmul.allow_tf32 == before
    # two stages a session, one Adam phase each, never interleaved
    assert sorted(seen) == [("default", True)] * 2 + [("highest", False)] * 2
    assert seen[0][0] == seen[1][0] and seen[2][0] == seen[3][0]
    assert _run_lock_free()


def test_sessions_never_overlap_under_stress(tmp_path, monkeypatch):
    """More sessions than cores, the interpreter switching threads as
    often as it can: no two training runs overlap, each sees the TF32
    flag its own Adam phase set, and the flag ends as it began."""
    import sys

    active, most, seen = [0], [0], []

    def fake_run(problem, spec, **kw):
        active[0] += 1
        most[0] = max(most[0], active[0])
        prec = spec.adam_precision
        with ttrain.adam_matmul_precision(prec):
            time.sleep(0.002)
            seen.append((prec, torch.backends.cuda.matmul.allow_tf32))
        active[0] -= 1

    # run_pinn_training's own turn on the device, around a stand-in for
    # the training it dispatches to
    monkeypatch.setattr(ttrain, "run_training", fake_run)
    before = torch.backends.cuda.matmul.allow_tf32
    mgr = tcontroller.SessionManager(str(tmp_path), device="cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sids = [f"s{k}" for k in range(24)]
        for k, sid in enumerate(sids):
            prec = ("default", "highest")[k % 2]
            assert mgr.start(sid, tcontroller.TrainingRequest(
                **_tiny(), options={"adam_precision": prec})) is None
        states = [_finish(mgr, sid, timeout=60)["status"] for sid in sids]
    finally:
        sys.setswitchinterval(interval)
    assert states == ["done"] * len(sids)
    assert most[0] == 1 and len(seen) == len(sids)
    assert all(flag == (prec == "default") for prec, flag in seen)
    assert torch.backends.cuda.matmul.allow_tf32 == before
    assert _run_lock_free()


@pytest.mark.parametrize("entry", [
    "train.run_training", "train.run_pinn_training", "inverse.run_inverse",
    "system.run_system", "patch.run_patched"])
def test_training_entries_take_turns(entry):
    """Every training entry waits while another run holds the training
    lock, and says so through its ``log_fn`` first; its arguments here are
    bad, so it raises as soon as its turn comes, and lets the lock go."""
    import importlib

    module, name = entry.split(".")
    fn = getattr(importlib.import_module(f"tpinn_torch.core.{module}"), name)
    lines, raised = [], []

    def call():
        try:
            fn(None, None, log_fn=lines.append, device="cpu")
        except Exception as e:
            raised.append(e)

    with ttrain._RUN_LOCK:
        th = threading.Thread(target=call)
        th.start()
        deadline = time.time() + 30
        while time.time() < deadline and not lines:
            time.sleep(0.01)
        assert lines == [
            "waiting for the device (another training run holds it)"]
        assert th.is_alive() and not raised
    th.join(timeout=30)
    assert not th.is_alive() and len(raised) == 1
    assert _run_lock_free()


def _get(base, path):
    return json.loads(urllib.request.urlopen(base + path).read())


def test_lite_http_roundtrip(tmp_path):
    """The lite server on an ephemeral port: page, validate, presets,
    preset, start, status and every figure tab, through real HTTP."""
    from tpinn_torch.app import lite

    mgr = tcontroller.SessionManager(str(tmp_path), device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), lite.make_handler(mgr))
    base = f"http://127.0.0.1:{server.server_address[1]}"
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        html = urllib.request.urlopen(base + "/").read().decode()
        assert "tpinn_torch" in html and "Start Training" in html
        assert "TPU" not in html and "%ORACLE_OPTIONS%" not in html
        for n in tpresets.oracle_names():
            assert f"<option>{n}</option>" in html

        assert _get(base, "/api/validate?eq=u_rr%2Bu_tt")["valid"] is True
        assert _get(base, "/api/validate?eq=u_rr%2B%2B")["valid"] is False
        assert _get(base, "/api/validate?eq=u_t-lam*u_xx")["valid"] is False
        assert _get(base, "/api/validate?eq=u_t-lam*u_xx&params=lam%3D1"
                    )["valid"] is True
        assert _get(base, "/api/presets") == {
            "presets": tpresets.preset_names()}
        assert _get(base, "/api/preset?name=heat_2d") == json.loads(
            json.dumps(tpresets.preset_payload("heat_2d")))
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/api/preset?name=nope")
        assert e.value.code == 404

        body = json.dumps({"session": "websess", **_tiny(),
                           "scl": 1.0, "epsil": 1.0,
                           "equation_weight": {"f": 0.05, "df": 0}}).encode()
        post = urllib.request.Request(base + "/api/start", data=body,
                                      method="POST")
        assert json.loads(urllib.request.urlopen(post).read()) == {"ok": True}
        bad = urllib.request.Request(base + "/api/start", method="POST",
                                     data=json.dumps({"session": "x",
                                                      "nope": 1}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad)
        assert e.value.code == 400

        deadline = time.time() + 300
        while time.time() < deadline:
            status = _get(base, "/api/status?session=websess")
            if status["status"] in ("done", "error"):
                break
            time.sleep(0.2)
        assert status["status"] == "done", status
        for name in tfigures.FIGURES:
            fig = _get(base, f"/api/figure?session=websess&name={name}")
            assert fig == json.loads(json.dumps(tfigures.figure_payload(
                mgr.session_dir("websess"), name))), name
            assert fig["type"] != "missing", name
        assert _get(base, "/api/figure?session=websess&name=nope")[
            "type"] == "missing"
    finally:
        server.shutdown()
        server.server_close()
