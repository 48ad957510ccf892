"""tpinn_torch.app — the web application layer and serving.

- ``tpinn_torch.app.lite``: the online PDE calculator, a stdlib
  ``http.server`` app with canvas rendering, over the session controller
  (``app.controller``), figure payloads (``app.figure_data``) and preset
  autofill (``app.presets``);
- ``tpinn_torch.app.serve``: serving of trained checkpoints.
"""

from tpinn_torch.app.controller import SessionManager, TrainingRequest  # noqa: F401
