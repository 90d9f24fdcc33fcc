"""Prometheus scrape endpoint over stdlib ``http.server``.

One daemon-threaded ``ThreadingHTTPServer`` per :class:`MetricsServer`:

  * ``GET /metrics``       — Prometheus text exposition (0.0.4) of a
    :class:`repro_torch.obs.metrics.Registry`
  * ``GET /metrics.json``  — the registry's JSON snapshot (quantiles
    pre-computed per histogram)
  * ``GET /trace.json``    — the attached tracer's current ring buffer as a
    Perfetto ``trace_event`` document (when a tracer was attached)
  * ``GET /healthz``       — liveness

``port=0`` binds an ephemeral port (``start()`` returns the real one) so
tests and parallel CI lanes never collide.  The handler reads the registry
under its own locks — scrapes are safe while the serving drain is writing.

A copy of the reference's ``repro.obs.http`` (stdlib only) over the port's
registry.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.obs.metrics import Registry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Serve a registry (and optionally a tracer) over HTTP."""

    def __init__(self, registry: Registry, *, port: int = 0,
                 host: str = "127.0.0.1", tracer=None):
        self.registry = registry
        self.tracer = tracer
        self._host = host
        self._port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return None if self._httpd is None else self._httpd.server_address[1]

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port."""
        assert self._httpd is None, "server already started"
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # keep launcher stdout clean
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = server.registry.prometheus_text().encode()
                    self._reply(200, body, PROMETHEUS_CONTENT_TYPE)
                elif path == "/metrics.json":
                    body = json.dumps(server.registry.snapshot()).encode()
                    self._reply(200, body, "application/json")
                elif path == "/trace.json" and server.tracer is not None:
                    body = json.dumps(server.tracer.export()).encode()
                    self._reply(200, body, "application/json")
                elif path == "/healthz":
                    self._reply(200, b"ok\n", "text/plain")
                else:
                    self._reply(404, b"not found\n", "text/plain")

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-http",
            daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
