"""Dash frontend preserving the reference UI behaviorally (the port of
``tpinn.app.dash_app``).

Requires ``dash`` + ``plotly`` + ``dash-bootstrap-components`` (where they
are missing, use ``tpinn_torch.app.lite``; this module imports them lazily
and raises a clear ImportError otherwise).  Sessions train on ``device``
("cuda" by default, which raises without a card: no CPU fallback) through
the port's session controller.

Parity map to the reference:
- create_layout / make_bd_group          → layout.py:7-64, 67-583
- input validation callback              → callbacks/input_validation.py
  (same Output("input-equation","invalid") contract, backed by the parser)
- dynamic BC groups                      → callbacks/bd_groups.py
- start/log-poll callback                → callbacks/training.py
- result-graph tab polling               → callbacks/result_graph.py
- figure builders                        → figures.py (plotly figures built
  from tpinn_torch.app.figure_data payloads; 1s dcc.Interval polling)
- session UUID in dcc.Store              → callbacks/set_session_id.py

Intentional fixes (SURVEY §2b.14): per-session log/figure state, figures
refresh as training progresses (the reference caches the first successful
load forever), training restartable, exceptions surfaced in the log.
"""

from __future__ import annotations

import uuid

from tpinn_torch.app.controller import SessionManager, TrainingRequest
from tpinn_torch.app.figure_data import figure_payload
from tpinn_torch.core import pde


def _require_dash():
    try:
        import dash  # noqa: F401
        import plotly  # noqa: F401
    except ImportError as e:  # pragma: no cover - exercised only w/o dash
        raise ImportError(
            "tpinn_torch.app.dash_app needs dash+plotly; this environment "
            "lacks them — run the dependency-free UI instead: "
            "python -m tpinn_torch.app.lite"
        ) from e


# two tab rows as in the reference (6 stage-1 + 5 stage-2, layout.py:493-517)
TAB_ROW_1 = [
    ("colloc_1", "Collocation 1"), ("solution_1", "Solution 1"),
    ("error_1", "Error 1"), ("loss_1", "Loss 1"),
    ("boundary_1", "Boundary 1"), ("spectrum", "Spectrum"),
]
TAB_ROW_2 = [
    ("colloc_2", "Collocation 2"), ("solution_2", "Solution 2"),
    ("error_2", "Error 2"), ("loss_2", "Loss 2"), ("boundary_2", "Boundary 2"),
]
TAB_LABELS = TAB_ROW_1 + TAB_ROW_2

# the equation-grammar hint of the reference tooltip (layout.py:114-121)
GRAMMAR_HINT = (
    "Allowed: numbers, coordinates r t x y, u and derivatives u_r, u_rr, "
    "u_rt…, operators + - * / ** ( ), functions sin cos tan exp log sqrt "
    "tanh sinh cosh abs, constants pi e, optional 'lhs = rhs'."
)

# static input ids gated by toggle_all (the reference disables all 27+
# inputs while training runs, training.py:121-267)
FIELD_KEYS = ("x-min", "x-max", "y-min", "y-max", "scl", "epsil", "n-col",
              "n-bd", "n-add", "depth", "width", "test-x", "test-y", "adam",
              "lbfgs", "wf", "wdf")
GATED_IDS = ["input-equation"] + [f"input-{k}" for k in FIELD_KEYS] + [
    "btn-add-bd", "btn-del-bd",
    # round-3/4 advanced options (may be empty; gated but not
    # required-filled): polish/correction selectors + UI inverse mode
    "opt-lsq-polish", "opt-deflation", "input-inverse-params", "opt-oracle",
]


def _oracle_names() -> list:
    from tpinn_torch.app.presets import oracle_names

    return oracle_names()


def _declared_params(inverse_params) -> tuple:
    """Coefficient names declared in the UI inverse field, () on any
    malformed input (the grammar check then rejects the bare unknown)."""
    if not inverse_params or not str(inverse_params).strip():
        return ()
    from tpinn_torch.core.train import parse_coef_list

    try:
        names, _ = parse_coef_list(inverse_params)
        return names
    except (TypeError, ValueError):
        return ()


def _build_options(lsq_polish, deflation, inverse_params, oracle) -> dict:
    """Advanced-options dict for TrainingRequest (train.UI_OPTION_SPEC)."""
    options = {}
    if lsq_polish:
        options["lsq_polish"] = lsq_polish
    if deflation:
        options["deflation"] = deflation
    if inverse_params and str(inverse_params).strip():
        options["inverse_params"] = str(inverse_params).strip()
        if oracle:
            options["oracle"] = oracle
    return options


def payload_to_figure(d: dict):
    """figure_data payload → plotly Figure (figures.py equivalents)."""
    import plotly.graph_objects as go
    from plotly.subplots import make_subplots

    if d["type"] == "missing":
        fig = go.Figure()
        fig.add_annotation(text=d["message"], x=0.5, y=0.5, xref="paper",
                           yref="paper", showarrow=False,
                           font=dict(size=20, color="grey"))
        fig.update_layout(xaxis=dict(visible=False), yaxis=dict(visible=False))
        return fig
    if d["type"] == "heatmap":
        fig = go.Figure(go.Heatmap(x=d["x"], y=d["y"], z=d["z"],
                                   colorscale="Jet"))
        if "xlim" in d:
            fig.update_layout(xaxis=dict(range=d["xlim"]),
                              yaxis=dict(range=d["ylim"]))
        return fig
    if d["type"] == "heatmap_scatter":
        fig = go.Figure([
            go.Heatmap(x=d["x"], y=d["y"], z=d["z"], colorscale="Rainbow"),
            go.Scatter(x=d["points_x"], y=d["points_y"], mode="markers",
                       marker=dict(symbol="x", color="black", size=6),
                       name="Collocation Points"),
        ])
        return fig
    if d["type"] == "dual_heatmap":
        fig = make_subplots(rows=1, cols=2, subplot_titles=d["titles"],
                            shared_yaxes=True)
        fig.add_trace(go.Heatmap(x=d["x"], y=d["y"], z=d["z1"],
                                 colorscale="Jet"), row=1, col=1)
        fig.add_trace(go.Heatmap(x=d["x"], y=d["y"], z=d["z2"],
                                 colorscale="Jet"), row=1, col=2)
        return fig
    if d["type"] in ("lines_log", "lines_log_pair"):
        fig = go.Figure()
        for s in d["series"]:
            fig.add_trace(go.Scatter(y=s["y"], mode="lines", name=s["name"]))
        fig.update_yaxes(type="log")
        fig.update_layout(hovermode="x unified")
        return fig
    raise ValueError(f"unknown payload type {d['type']}")


def make_bd_group(idx: int):
    """One boundary-condition input row (layout.py:7-64)."""
    import dash_bootstrap_components as dbc
    from dash import html

    def num(idq, ph):
        return dbc.Input(id={"type": idq, "index": idx}, type="number",
                         placeholder=ph, size="sm")

    return html.Div(
        [
            html.Span(f"BC {idx}:"),
            num("bd-x-min", "x min"), num("bd-x-max", "x max"),
            num("bd-y-min", "y min"), num("bd-y-max", "y max"),
            num("bd-u", "u"),
        ],
        id={"type": "bd-group", "index": idx},
        className="bd-group",
    )


def create_app(data_root: str = "data", device="cuda"):
    """App factory (the reference's create_app, __init__.py:6-14); the
    sessions train on ``device`` ("cuda" raises here without a card)."""
    _require_dash()
    import dash
    import dash_bootstrap_components as dbc
    from dash import ALL, Input, Output, State, dcc, html

    manager = SessionManager(data_root, device=device)
    manager.wipe_all()

    app = dash.Dash(__name__, external_stylesheets=[dbc.themes.BOOTSTRAP])
    app.layout = html.Div([
        dcc.Store(id="session-id", storage_type="session"),
        html.H3("tpinn — PINN-based online PDE calculator"),
        dbc.Input(id="input-equation", value="u_rr + 1/r*u_r + 1/r**2*u_tt",
                  type="text"),
        dbc.Tooltip(GRAMMAR_HINT, target="input-equation",
                    placement="bottom", id="equation-tooltip"),
        html.Div(id="bd-groups", children=[make_bd_group(1), make_bd_group(2)]),
        dbc.Button("+", id="btn-add-bd", size="sm"),
        dbc.Button("−", id="btn-del-bd", size="sm"),
        *[
            dbc.Input(id=f"input-{k}", type="number", value=v, size="sm")
            for k, v in [
                ("x-min", 0.1), ("x-max", 1.0), ("y-min", 0.0), ("y-max", 1.0),
                ("scl", 1.0), ("epsil", 1.0),
                ("n-col", 3000), ("n-bd", 1000), ("n-add", 1000),
                ("depth", 60), ("width", 6), ("test-x", 111), ("test-y", 111),
                ("adam", 1000), ("lbfgs", 1000), ("wf", 0.05), ("wdf", 0.0),
            ]
        ],
        # advanced options (beyond the reference schema; the value rules
        # live in train.UI_OPTION_SPEC, validated by the controller)
        dcc.Dropdown(id="opt-lsq-polish", value="off", clearable=False,
                     options=[{"label": v, "value": v}
                              for v in ("off", "auto", "on")]),
        dcc.Dropdown(id="opt-deflation", value="off", clearable=False,
                     options=[{"label": v, "value": v}
                              for v in ("off", "auto", "full")]),
        dbc.Input(id="input-inverse-params", type="text", value="",
                  placeholder="unknown coefficients, e.g. lam=0.5",
                  size="sm"),
        dcc.Dropdown(id="opt-oracle", value="", clearable=True,
                     placeholder="observation oracle (inverse mode)",
                     options=[{"label": n, "value": n}
                              for n in _oracle_names()]),
        dbc.Button("Start Training", id="btn-start-training", color="primary",
                   disabled=False),
        dcc.Tabs(id="result-tabs-1", value="loss_1", children=[
            dcc.Tab(label=lbl, value=key) for key, lbl in TAB_ROW_1
        ]),
        dcc.Tabs(id="result-tabs-2", value=None, children=[
            dcc.Tab(label=lbl, value=key) for key, lbl in TAB_ROW_2
        ]),
        html.Div(id="graph-subtitle"),
        dcc.Graph(id="result-graph"),
        html.Pre(id="training-log"),
        dcc.Interval(id="log-interval", interval=1000),
        dcc.Interval(id="fig-interval", interval=1000),
    ])

    # clientside autoscroll of the log box (the reference embeds the same
    # JS snippet, layout.py:570-582)
    app.clientside_callback(
        """
        function(children) {
            var el = document.getElementById('training-log');
            if (el) { el.scrollTop = el.scrollHeight; }
            return window.dash_clientside.no_update;
        }
        """,
        Output("training-log", "title"),
        Input("training-log", "children"),
    )

    @app.callback(Output("session-id", "data"), Input("session-id", "data"))
    def assign_session(data):
        return data or uuid.uuid4().hex

    @app.callback(Output("input-equation", "invalid"),
                  Input("input-equation", "value"),
                  Input("input-inverse-params", "value"),
                  prevent_initial_call=True)
    def on_equation_change(expr: str, inverse_params: str) -> bool:
        if not expr:
            return False
        return not pde.validate_equation(
            expr, coords=("r", "t", "x", "y"),
            params=_declared_params(inverse_params))

    @app.callback(Output("bd-groups", "children"),
                  Input("btn-add-bd", "n_clicks"),
                  Input("btn-del-bd", "n_clicks"),
                  State("bd-groups", "children"),
                  prevent_initial_call=True)
    def update_bd_groups(n_add, n_del, children):
        trig = dash.callback_context.triggered_id
        if trig == "btn-add-bd":
            children = children + [make_bd_group(len(children) + 1)]
        elif trig == "btn-del-bd" and len(children) > 1:
            children = children[:-1]
        return children

    @app.callback(
        Output("training-log", "children"),
        Input("btn-start-training", "n_clicks"),
        Input("log-interval", "n_intervals"),
        State("session-id", "data"),
        State("input-equation", "value"),
        State({"type": "bd-x-min", "index": ALL}, "value"),
        State({"type": "bd-x-max", "index": ALL}, "value"),
        State({"type": "bd-y-min", "index": ALL}, "value"),
        State({"type": "bd-y-max", "index": ALL}, "value"),
        State({"type": "bd-u", "index": ALL}, "value"),
        *[State(f"input-{k}", "value") for k in
          ("x-min", "x-max", "y-min", "y-max", "scl", "epsil", "n-col",
           "n-bd", "n-add", "depth", "width", "test-x", "test-y", "adam",
           "lbfgs", "wf", "wdf")],
        State("opt-lsq-polish", "value"),
        State("opt-deflation", "value"),
        State("input-inverse-params", "value"),
        State("opt-oracle", "value"),
        prevent_initial_call=True,
    )
    def start_training(n_clicks, n_int, session, equation,
                       bxmin, bxmax, bymin, bymax, bu,
                       x_min, x_max, y_min, y_max, scl, epsil, n_col, n_bd,
                       n_add, depth, width, tx, ty, adam, lbfgs, wf, wdf,
                       lsq_polish, deflation, inverse_params, oracle):
        trig = dash.callback_context.triggered_id
        session = session or "default"
        if trig == "btn-start-training":
            boundary = {}
            for i in range(len(bxmin)):
                boundary[f"bd_x{i+1}_min"] = bxmin[i]
                boundary[f"bd_x{i+1}_max"] = bxmax[i]
                boundary[f"bd_y{i+1}_min"] = bymin[i]
                boundary[f"bd_y{i+1}_max"] = bymax[i]
                boundary[f"bd_u{i+1}"] = bu[i]
            req = TrainingRequest(
                equation=equation, boundary=boundary,
                domain={"x_min": x_min, "x_max": x_max,
                        "y_min": y_min, "y_max": y_max},
                scl=scl, epsil=epsil,
                sample_points={"n_col": n_col, "n_bd": n_bd, "n_add": n_add},
                network_size={"depth": depth, "width": width},
                testing_size={"x": tx, "y": ty},
                epochs={"adam": adam, "lbfgs": lbfgs},
                equation_weight={"f": wf, "df": wdf},
                options=_build_options(lsq_polish, deflation,
                                       inverse_params, oracle),
            )
            err = manager.start(session, req)
            if err:
                return f"ERROR: {err}"
        return manager.status(session)["log"]

    @app.callback(
        [Output(i, "disabled") for i in GATED_IDS]
        + [Output({"type": t, "index": ALL}, "disabled") for t in
           ("bd-x-min", "bd-x-max", "bd-y-min", "bd-y-max", "bd-u")]
        + [Output("btn-start-training", "disabled")],
        Input("log-interval", "n_intervals"),
        Input("input-equation", "value"),
        State("session-id", "data"),
        State({"type": "bd-x-min", "index": ALL}, "value"),
        State({"type": "bd-x-max", "index": ALL}, "value"),
        State({"type": "bd-y-min", "index": ALL}, "value"),
        State({"type": "bd-y-max", "index": ALL}, "value"),
        State({"type": "bd-u", "index": ALL}, "value"),
        *[State(f"input-{k}", "value") for k in FIELD_KEYS],
        State("input-inverse-params", "value"),
    )
    def toggle_all(n_int, equation, session, bxmin, bxmax, bymin, bymax, bu,
                   *fields):
        """Input gating (the reference's toggle_all, training.py:121-267):
        every input disabled while training runs; Start enabled only when
        all fields are non-empty and the equation is valid."""
        fields, inverse_params = fields[:-1], fields[-1]
        running = manager.status(session or "default")["status"] == "running"
        bd_lists = [bxmin, bxmax, bymin, bymax, bu]
        empty = lambda v: v is None or v == ""
        filled = (
            not empty(equation)
            and all(not empty(v) for v in fields)
            and all(vs and not any(empty(v) for v in vs) for vs in bd_lists)
        )
        eq_ok = bool(equation) and pde.validate_equation(
            equation, coords=("r", "t", "x", "y"),
            params=_declared_params(inverse_params),
        )
        start_disabled = running or not (filled and eq_ok)
        gated = [running] * len(GATED_IDS)
        bd_gated = [[running] * len(vs) for vs in bd_lists]
        return gated + bd_gated + [start_disabled]

    @app.callback(Output("result-graph", "figure"),
                  Output("graph-subtitle", "children"),
                  Output("result-tabs-1", "value"),
                  Output("result-tabs-2", "value"),
                  Input("result-tabs-1", "value"),
                  Input("result-tabs-2", "value"),
                  Input("fig-interval", "n_intervals"),
                  State("session-id", "data"))
    def update_result_graph(tab1, tab2, n, session):
        """Two-row tab exclusivity (result_graph.py:102-118): selecting a
        tab in one row clears the other row's selection."""
        trig = dash.callback_context.triggered_id
        if trig == "result-tabs-1" and tab1:
            tab2 = None
        elif trig == "result-tabs-2" and tab2:
            tab1 = None
        active = tab1 or tab2 or "loss_1"
        payload = figure_payload(
            manager.session_dir(session or "default"), active
        )
        subtitle = dict(TAB_LABELS).get(active, active)
        return payload_to_figure(payload), subtitle, tab1, tab2

    return app


def main(argv=None):  # pragma: no cover
    import argparse

    ap = argparse.ArgumentParser(description="tpinn_torch's Dash frontend")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--port", type=int, default=8050)
    args = ap.parse_args(argv)
    app = create_app(device=args.device)
    app.run(host="0.0.0.0", port=args.port, debug=False)


if __name__ == "__main__":  # pragma: no cover
    main()
