"""Session/training controller — the L3 layer, UI-framework-agnostic
(the port of ``tpinn.app.controller``).

Reference counterpart: callbacks/training.py (assembles the boundary dict,
spawns a daemon thread running run_pinn_training, polls LOG_BUFFER) and
callbacks/set_session_id.py (uuid per browser session).  Differences, all
deliberate:

- per-session log buffers and figure caches (the reference's are process
  globals, so concurrent sessions interleave, SURVEY §2b.14),
- training exceptions are caught and surfaced into the session log
  (the reference's thread swallows them, training.py:82-107),
- a session can run again after finishing (the reference permanently
  disables Start per page load),
- the PDE string is validated by actually parsing it — and then USED.

One difference from tpinn's controller: training runs take turns
(``train.one_run_at_a_time``: the Adam phase sets torch's process-wide
TF32 flag).  A session that finds another run training logs that it
waits for the device and stays ``running`` until its turn.
"""

from __future__ import annotations

import shutil
import threading
import traceback
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

from tpinn_torch.core import pde
from tpinn_torch.core.train import resolve_device, run_pinn_training
from tpinn_torch.utils.logging import LogBuffer


@dataclass
class TrainingRequest:
    """The UI input schema (training.py:93-105 dict shapes, typed)."""

    equation: str
    boundary: dict                   # bd_{x,y}{i}_{min,max}, bd_u{i}
    domain: dict                     # x_min/x_max/y_min/y_max
    scl: float = 1.0
    epsil: float = 1.0
    sample_points: dict = field(default_factory=lambda: {
        "n_col": 3000, "n_bd": 1000, "n_add": 1000})
    network_size: dict = field(default_factory=lambda: {
        "depth": 60, "width": 6})
    testing_size: dict = field(default_factory=lambda: {"x": 111, "y": 111})
    epochs: dict = field(default_factory=lambda: {"adam": 1000, "lbfgs": 1000})
    equation_weight: dict = field(default_factory=lambda: {"f": 0.05, "df": 0})
    # round-3 extension beyond the reference schema: whitelisted advanced
    # knobs (train.run_pinn_training options passthrough; the key/value
    # rules live in ONE place — train.UI_OPTION_SPEC/coerce_ui_option)
    options: dict = field(default_factory=dict)

    def validate(self) -> Optional[str]:
        """Return an error message, or None if the request is well-formed."""
        # declared unknown coefficients (UI inverse mode) are admitted by
        # the grammar check — same registry the training entry uses
        inv_params: tuple = ()
        if isinstance(self.options, dict) and self.options.get("inverse_params"):
            from tpinn_torch.core.train import parse_coef_list

            try:
                inv_params, _ = parse_coef_list(self.options["inverse_params"])
            except (TypeError, ValueError) as e:
                return str(e)
        if not pde.validate_equation(self.equation,
                                     coords=("r", "t", "x", "y"),
                                     params=inv_params):
            return f"equation does not parse: {self.equation!r}"
        try:
            n_groups = len(self.boundary) // 5
            if n_groups < 1:
                return "at least one boundary-condition group is required"
            for i in range(1, n_groups + 1):
                for k in (f"bd_x{i}_min", f"bd_x{i}_max", f"bd_y{i}_min",
                          f"bd_y{i}_max"):
                    float(self.boundary[k])
                u_val = self.boundary[f"bd_u{i}"]
                try:
                    float(u_val)
                except (TypeError, ValueError):
                    # boundary value may be a coordinate expression
                    try:
                        ast = pde.parse(str(u_val), coords=("r", "t", "x", "y"))
                        if pde.collect_indices(ast):
                            return (f"bd_u{i} expression must not reference "
                                    f"u: {u_val!r}")
                    except pde.PDESyntaxError:
                        return (f"bd_u{i} is neither a number nor a valid "
                                f"expression: {u_val!r}")
            for k in ("x_min", "x_max", "y_min", "y_max"):
                float(self.domain[k])
            if float(self.domain["x_max"]) <= float(self.domain["x_min"]):
                return "x_max must exceed x_min"
            if float(self.domain["y_max"]) <= float(self.domain["y_min"]):
                return "y_max must exceed y_min"
        except (KeyError, TypeError, ValueError) as e:
            return f"bad request field: {e}"
        if self.options and not isinstance(self.options, dict):
            return "options must be an object"
        from tpinn_torch.core.train import coerce_ui_option

        for k, v in (self.options or {}).items():
            try:
                coerce_ui_option(k, v)
            except KeyError:
                return f"unknown option: {k}"
            except (TypeError, ValueError) as e:
                return str(e) if str(e) else f"bad option {k}: {v!r}"
        return None


@dataclass
class SessionState:
    session_id: str
    log: LogBuffer = field(default_factory=lambda: LogBuffer(1000))
    thread: Optional[threading.Thread] = None
    status: str = "idle"            # idle | running | done | error
    error: Optional[str] = None


class SessionManager:
    """Owns per-session state and launches training threads on ``device``
    ("cuda" fails here, at construction, without a card)."""

    def __init__(self, data_root: str = "data", device="cuda"):
        self.data_root = Path(data_root)
        self.device = resolve_device(device)
        self._sessions: Dict[str, SessionState] = {}
        self._lock = threading.Lock()

    def new_session_id(self) -> str:
        return uuid.uuid4().hex

    def get(self, session_id: str) -> SessionState:
        with self._lock:
            if session_id not in self._sessions:
                self._sessions[session_id] = SessionState(session_id)
            return self._sessions[session_id]

    def session_dir(self, session_id: str) -> Path:
        return self.data_root / session_id

    def wipe_all(self) -> None:
        """Boot-time cleanup of stale session dirs (app.py:11-18 behavior)."""
        if self.data_root.exists():
            for child in self.data_root.iterdir():
                if child.is_dir():
                    shutil.rmtree(child, ignore_errors=True)

    def start(self, session_id: str, request: TrainingRequest) -> Optional[str]:
        """Launch training in a daemon thread.  Returns an error message if
        the request is invalid or the session is already running."""
        err = request.validate()
        if err:
            return err
        state = self.get(session_id)
        with self._lock:
            if state.status == "running":
                return "training already running for this session"
            state.status = "running"
            state.error = None
        state.log.clear()
        out_dir = self.session_dir(session_id)
        out_dir.mkdir(parents=True, exist_ok=True)

        def _run():
            try:
                state.log.append(f"session {session_id}: training started")
                run_pinn_training(
                    equation=request.equation,
                    boundary=request.boundary,
                    domain=request.domain,
                    scl=request.scl,
                    epsil=request.epsil,
                    sample_points=request.sample_points,
                    network_size=request.network_size,
                    testing_size=request.testing_size,
                    epochs=request.epochs,
                    equation_weight=request.equation_weight,
                    options=request.options,
                    output_dir=str(out_dir),
                    log_fn=state.log.append,
                    device=self.device,
                )
                with self._lock:
                    state.status = "done"
                state.log.append("training finished")
            except Exception as e:  # surfaced, not swallowed
                with self._lock:
                    state.status = "error"
                    state.error = str(e)
                state.log.append("TRAINING FAILED: " + str(e))
                for line in traceback.format_exc().splitlines()[-12:]:
                    state.log.append("  " + line)

        t = threading.Thread(target=_run, daemon=True,
                             name=f"tpinn-torch-train-{session_id[:8]}")
        state.thread = t
        t.start()
        return None

    def status(self, session_id: str) -> dict:
        state = self.get(session_id)
        return {
            "session": session_id,
            "status": state.status,
            "error": state.error,
            "log": state.log.text(),
        }
