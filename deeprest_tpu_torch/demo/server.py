"""The demo web server: stdlib http.server + a vanilla-JS/SVG page
(``deeprest_tpu/demo/server.py``; host-only, the same routes and JSON).

Serves the reference demo's four-panel capability (reference:
web-demo/app.py:51-122 — controls, traffic, scaling-factor bars,
utilization series) without the Dash/Plotly dependency stack: one static
HTML page (assets/index.html) calling two JSON endpoints:

    GET /api/meta                              → options for the controls
    GET /api/panel?shape=&multiplier=&group=&index=  → one render's data
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from deeprest_tpu_torch.demo.results import ResultsStore

_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def make_handler(store: ResultsStore):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, payload, code: int = 200) -> None:
            self._send(code, json.dumps(payload).encode(), "application/json")

        def do_GET(self):  # noqa: N802 (stdlib API)
            url = urlparse(self.path)
            try:
                if url.path in ("/", "/index.html"):
                    with open(os.path.join(_ASSETS, "index.html"), "rb") as f:
                        self._send(200, f.read(), "text/html; charset=utf-8")
                elif url.path == "/api/meta":
                    self._json({
                        "shapes": store.options_shape(),
                        "multipliers": {
                            s["value"]: store.options_multiplier(s["value"])
                            for s in store.options_shape()
                        },
                        "compositions": {
                            s["value"]: store.options_composition(s["value"])
                            for s in store.options_shape()
                        },
                        "apis": store.meta["apis"],
                        "components": store.meta["components"],
                        "resources": store.meta["resources"],
                        "methods": store.meta["methods"],
                    })
                elif url.path == "/api/panel":
                    q = parse_qs(url.query)
                    panel = store.panel(
                        q["shape"][0], int(q["multiplier"][0]),
                        q["group"][0], int(q["index"][0]),
                    )
                    self._json(panel)
                else:
                    self._json({"error": f"no route {url.path}"}, 404)
            except (KeyError, IndexError, ValueError) as exc:
                self._json({"error": str(exc)}, 400)

    return Handler


class DemoServer:
    """Threaded server wrapper usable both as a CLI and from tests."""

    def __init__(self, store: ResultsStore, host: str = "127.0.0.1",
                 port: int = 2021):
        self.httpd = ThreadingHTTPServer((host, port), make_handler(store))
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    def start_background(self) -> "DemoServer":
        # graftlint: disable=TH001 -- lifecycle handle: start_background/stop run on the owning driver thread only, never in a request handler
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
