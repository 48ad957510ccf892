"""WSGI entry point for production serving of the Dash frontend.

The reference exposes ``server = app.server`` for gunicorn (wsgi.py:19-21).
Same here, the port of ``tpinn.app.wsgi``: it needs dash+plotly (see
tpinn_torch.app.dash_app), wipes the session directories under ./data
when imported, and trains on the device named by ``TPINN_TORCH_DEVICE``
(default "cuda", which raises without a card):

    gunicorn tpinn_torch.app.wsgi:server                  # on the card
    TPINN_TORCH_DEVICE=cpu gunicorn tpinn_torch.app.wsgi:server
    python -m tpinn_torch.app.lite     # stdlib HTTP server, no dash
"""

import os

from tpinn_torch.app.dash_app import create_app

app = create_app(device=os.environ.get("TPINN_TORCH_DEVICE", "cuda"))
server = app.server
