"""The port's Dash frontend (tpinn_torch.app.dash_app, app.wsgi) against
tpinn's, driven through the in-process dash double (tests/dash_double.py;
dash is not installed here).

tpinn's eight dash tests (tests/test_dash_app.py) run against the port;
the constants, the layout's component ids and the callbacks' wiring equal
tpinn's; a tiny session on the CPU is started and polled through the
callbacks to ``done`` and its 11 tab figures build; ``app.wsgi`` builds
its server with the CPU named and raises with the default ("cuda")
without a card; none of it imports jax or the JAX package.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
sys.path.insert(0, str(TESTS))

import dash_double  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _install(monkeypatch):
    dash = dash_double.install(monkeypatch)
    monkeypatch.delitem(sys.modules, "tpinn_torch.app.dash_app",
                        raising=False)
    return dash


@pytest.fixture()
def app(monkeypatch, tmp_path):
    dash = _install(monkeypatch)
    from tpinn_torch.app import dash_app

    return (dash_app.create_app(data_root=str(tmp_path), device="cpu"), dash,
            dash_app)


def _field_values():
    # all 17 static fields non-empty (order = dash_app.FIELD_KEYS)
    return [0.1, 1.0, 0.0, 1.0, 1.0, 1.0, 3000, 1000, 1000, 60, 6, 111, 111,
            1000, 1000, 0.05, 0.0]


def _flat(gates):
    flat = []
    for g in gates:
        flat.extend(g if isinstance(g, list) else [g])
    return flat


def test_layout_contains_reference_components(app):
    application, dash, dash_app = app
    ids = {c.id for c in dash_double.walk(application.layout)
           if isinstance(c.id, str)}
    expected = {
        "session-id", "input-equation", "equation-tooltip", "bd-groups",
        "btn-add-bd", "btn-del-bd", "btn-start-training", "result-tabs-1",
        "result-tabs-2", "result-graph", "training-log", "log-interval",
        "fig-interval", "graph-subtitle",
    } | {f"input-{k}" for k in dash_app.FIELD_KEYS}
    missing = expected - ids
    assert not missing, f"layout missing: {missing}"
    tips = [c for c in dash_double.walk(application.layout)
            if c.id == "equation-tooltip"]
    assert "u_rr" in str(tips[0].children) or "u_" in str(tips[0].children)
    assert any("scrollTop" in js for js, _ in application.clientside)


def test_equation_validation_callback(app):
    application, dash, _ = app
    cb = application.find("on_equation_change")["fn"]
    assert cb("u_rr + 1/r*u_r", "") is False
    assert cb("u_q + ", "") is True
    assert cb("u_t - lam*u_xx", "") is True
    assert cb("u_t - lam*u_xx", "lam=0.5") is False


def test_bd_group_add_del(app):
    application, dash, dash_app = app
    cb = application.find("update_bd_groups")["fn"]
    children = [dash_app.make_bd_group(1)]
    dash.callback_context.triggered_id = "btn-add-bd"
    children = cb(1, 0, children)
    assert len(children) == 2
    dash.callback_context.triggered_id = "btn-del-bd"
    children = cb(1, 1, children)
    assert len(children) == 1
    children = cb(1, 2, children)
    assert len(children) == 1


def test_toggle_all_gating(app):
    application, dash, _ = app
    cb = application.find("toggle_all")["fn"]
    bd = [[0.1], [0.1], [0.0], [1.0], [1.0]]
    *gates, start_disabled = cb(0, "u_rr + u_tt", "sess", *bd,
                                *_field_values(), "")
    assert start_disabled is False
    assert not any(_flat(gates)), "inputs must be enabled while idle"
    fields = _field_values()
    fields[3] = ""
    assert cb(0, "u_rr + u_tt", "sess", *bd, *fields, "")[-1] is True
    assert cb(0, "u_q +", "sess", *bd, *_field_values(), "")[-1] is True
    bd_bad = [[0.1], [None], [0.0], [1.0], [1.0]]
    assert cb(0, "u_rr + u_tt", "sess", *bd_bad, *_field_values(),
              "")[-1] is True


def test_toggle_all_disables_everything_while_running(app, monkeypatch):
    application, dash, dash_app = app
    cb = application.find("toggle_all")["fn"]
    from tpinn_torch.app.controller import SessionManager

    bd = [[0.1], [0.1], [0.0], [1.0], [1.0]]
    monkeypatch.setattr(SessionManager, "status",
                        lambda self, s: {"status": "running", "log": ""})
    *gates, start_disabled = cb(0, "u_rr + u_tt", "sess", *bd,
                                *_field_values(), "")
    assert start_disabled is True
    assert all(_flat(gates)), "all inputs must be disabled while training runs"


def test_two_row_tab_exclusivity(app, tmp_path):
    application, dash, _ = app
    cb = application.find("update_result_graph")["fn"]
    dash.callback_context.triggered_id = "result-tabs-2"
    fig, subtitle, tab1, tab2 = cb("loss_1", "loss_2", 0, "sess")
    assert tab1 is None and tab2 == "loss_2"
    assert subtitle == "Loss 2"
    dash.callback_context.triggered_id = "result-tabs-1"
    fig, subtitle, tab1, tab2 = cb("error_1", None, 0, "sess")
    assert tab1 == "error_1" and tab2 is None
    assert fig.annotations, "missing-artifact placeholder expected"


def test_payload_to_figure_types(app):
    _, dash, dash_app = app
    f = dash_app.payload_to_figure({"type": "missing", "message": "nope"})
    assert f.annotations[0]["text"] == "nope"
    f = dash_app.payload_to_figure(
        {"type": "heatmap", "x": [0, 1], "y": [0, 1],
         "z": [[0, 1], [1, 0]], "xlim": [0, 1], "ylim": [0, 1]})
    assert f.data and f.layout["xaxis"]["range"] == [0, 1]
    f = dash_app.payload_to_figure(
        {"type": "lines_log", "series": [{"name": "loss", "y": [1.0, 0.1]}]})
    assert f.layout["yaxes"]["type"] == "log"


def test_build_options_and_declared_params(app):
    _, _, dash_app = app
    assert dash_app._declared_params("lam=0.5, k=2") == ("lam", "k")
    assert dash_app._declared_params("") == ()
    assert dash_app._declared_params("garbage") == ()
    opts = dash_app._build_options("auto", "full", " lam=0.5 ", "heat_2d")
    assert opts == {"lsq_polish": "auto", "deflation": "full",
                    "inverse_params": "lam=0.5", "oracle": "heat_2d"}
    assert dash_app._build_options("off", "off", "", "heat_2d") == {
        "lsq_polish": "off", "deflation": "off"}


def _ids(layout):
    return sorted(repr(c.id) for c in dash_double.walk(layout)
                  if c.id is not None)


def _wiring(application):
    return [(cb["name"], [repr(s) for s in cb["outputs"]],
             [repr(s) for s in cb["inputs"]],
             [repr(s) for s in cb["states"]])
            for cb in application.callbacks]


def test_constants_layout_and_callbacks_equal_tpinn(monkeypatch, tmp_path):
    """TAB_ROW_1/2, GRAMMAR_HINT, FIELD_KEYS and GATED_IDS, every layout id,
    the clientside snippet and every callback's outputs, inputs and
    states are tpinn's."""
    _install(monkeypatch)
    from tpinn.app import dash_app as jdash

    from tpinn_torch.app import dash_app as tdash

    for name in ("TAB_ROW_1", "TAB_ROW_2", "TAB_LABELS", "GRAMMAR_HINT",
                 "FIELD_KEYS", "GATED_IDS"):
        assert getattr(tdash, name) == getattr(jdash, name), name
    ja = jdash.create_app(data_root=str(tmp_path / "j"))
    ta = tdash.create_app(data_root=str(tmp_path / "t"), device="cpu")
    assert _ids(ta.layout) == _ids(ja.layout)
    assert _wiring(ta) == _wiring(ja)
    assert [js for js, _ in ta.clientside] == [js for js, _ in ja.clientside]
    assert len(ta.callbacks) == 6


def test_tiny_cpu_session_to_done(app):
    """A session on the CPU started through start_training, polled through
    toggle_all (every gated input disabled while it runs) until done; then
    every one of the 11 tabs builds a figure from its artifacts."""
    application, dash, dash_app = app
    start = application.find("start_training")["fn"]
    toggle = application.find("toggle_all")["fn"]
    graph = application.find("update_result_graph")["fn"]
    bd = [[0.1, 1.0], [0.1, 1.0], [0.0, 0.0], [1.0, 1.0], [1.0, 0.0]]
    fields = [0.1, 1.0, 0.0, 1.0, 1.0, 1.0, 60, 20, 20, 2, 8, 21, 21, 20, 6,
              0.05, 0.0]
    eq = "u_rr + 1/r*u_r + 1/r**2*u_tt"
    dash.callback_context.triggered_id = "btn-start-training"
    log = start(1, 0, "tiny", eq, *bd, *fields, "off", "off", "", "")
    assert not log.startswith("ERROR"), log
    dash.callback_context.triggered_id = "log-interval"
    deadline = time.monotonic() + 240
    seen_running = False
    while True:
        *gates, start_disabled = toggle(1, eq, "tiny", *bd, *fields, "")
        log = start(1, 1, "tiny", eq, *bd, *fields, "off", "off", "", "")
        if "training finished" in log or "TRAINING FAILED" in log:
            break
        if all(_flat(gates)) and start_disabled:
            seen_running = True
        assert time.monotonic() < deadline, log[-2000:]
        time.sleep(0.2)
    assert "training finished" in log, log[-3000:]
    assert seen_running
    *gates, start_disabled = toggle(1, eq, "tiny", *bd, *fields, "")
    assert not any(_flat(gates)) and start_disabled is False
    tabs = ([("result-tabs-1", k, None) for k, _ in dash_app.TAB_ROW_1]
            + [("result-tabs-2", None, k) for k, _ in dash_app.TAB_ROW_2])
    for trig, t1, t2 in tabs:
        dash.callback_context.triggered_id = trig
        fig, subtitle, _, _ = graph(t1, t2, 0, "tiny")
        assert fig.data and not fig.annotations, (t1 or t2, subtitle)


def _sub(code, cwd, env=None):
    full = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import dash_double\n"
            "class MP:\n"
            "    setitem = staticmethod(lambda d, k, v: d.__setitem__(k, v))\n"
            "    delitem = staticmethod(lambda d, k, raising=False: "
            "d.pop(k, None))\n"
            "dash_double.install(MP)\n"
            "sys.modules['dash'].Dash.server = 'wsgi-server'\n"
            % (str(ROOT), str(TESTS))) + code
    return subprocess.run([sys.executable, "-c", full], cwd=str(cwd),
                          capture_output=True, text=True, timeout=180,
                          env=dict(os.environ, **(env or {})))


def test_wsgi_builds_server_on_the_named_device(tmp_path):
    """TPINN_TORCH_DEVICE=cpu: app.wsgi builds ``server`` and wipes the
    stale session directories under ./data."""
    (tmp_path / "data" / "stale").mkdir(parents=True)
    out = _sub("import tpinn_torch.app.wsgi as w\n"
               "print(w.server, w.app.layout is not None)\n", tmp_path,
               {"TPINN_TORCH_DEVICE": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["wsgi-server", "True"]
    assert not (tmp_path / "data" / "stale").exists()


def test_wsgi_default_device_raises_without_a_card(tmp_path):
    """With no device named, app.wsgi asks for "cuda" and raises where
    there is no card: no CPU fallback."""
    env = {k: v for k, v in os.environ.items() if k != "TPINN_TORCH_DEVICE"}
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
         "import dash_double, torch\n"
         "class MP:\n"
         "    setitem = staticmethod(lambda d, k, v: d.__setitem__(k, v))\n"
         "    delitem = staticmethod(lambda d, k, raising=False: "
         "d.pop(k, None))\n"
         "dash_double.install(MP)\n"
         "torch.cuda.is_available = lambda: False\n"
         "try:\n    import tpinn_torch.app.wsgi\n"
         "except RuntimeError as e:\n    print('refused', e)\n"
         % (str(ROOT), str(TESTS))],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=180,
        env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("refused") and "cuda" in out.stdout


def test_dash_app_without_dash_raises_a_clear_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "dash", None)
    monkeypatch.delitem(sys.modules, "tpinn_torch.app.dash_app",
                        raising=False)
    from tpinn_torch.app import dash_app

    with pytest.raises(ImportError, match="tpinn_torch.app.lite"):
        dash_app.create_app(device="cpu")


def test_frontend_and_parallel_import_no_jax(tmp_path):
    """tpinn_torch.parallel, app.dash_app and app.wsgi (its app built)
    load neither jax nor the JAX package tpinn."""
    out = _sub("import tpinn_torch.parallel, tpinn_torch.app.dash_app\n"
               "import tpinn_torch.app.wsgi\n"
               "print(sorted(m for m in sys.modules "
               "if m.split('.')[0] in ('jax', 'tpinn')))\n", tmp_path,
               {"TPINN_TORCH_DEVICE": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
