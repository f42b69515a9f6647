"""OpenMetrics (Prometheus) exposition over the ``snapshot()`` protocol.

Everything in the serving plane that keeps metrics already exposes one flat
``{dotted.name: float}`` dict — :meth:`Tracker.snapshot`,
:meth:`OracleService.snapshot`, the index/label stores.  This module turns
any number of such sources into an OpenMetrics text exposition and serves
it on a stdlib HTTP endpoint, so a Prometheus scraper can point at a
running service with zero new dependencies:

>>> exp = MetricsExporter([svc.snapshot], port=9464)   # doctest: +SKIP
>>> exp.start()                                         # doctest: +SKIP
... # curl http://localhost:9464/metrics
>>> exp.stop()                                          # doctest: +SKIP

``repro_torch.launch.serve --metrics-port N`` wires this up for the
service, server and worker modes.

Rendering contract (:func:`render_openmetrics`):

- dotted snapshot names mangle to metric names (``service.window.fill_ratio``
  -> ``repro_service_window_fill_ratio``): every char outside
  ``[a-zA-Z0-9_:]`` becomes ``_``, and a leading digit is prefixed;
- every sample is exported as an untyped ``gauge`` (snapshots are
  point-in-time floats; counters are monotone gauges to a scraper);
- name clashes after mangling merge (last source wins, exactly like
  :func:`repro_torch.obs.merge_snapshots`), non-finite values are dropped,
  and the body ends with the mandatory ``# EOF`` terminator;
- the default prefix is ``repro``, the reference's, so one scrape
  configuration reads either package's service.
"""
from __future__ import annotations

import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, Optional

__all__ = ["CONTENT_TYPE", "MetricsExporter", "render_openmetrics"]

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

_MANGLE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str, prefix: str) -> str:
    out = _MANGLE.sub("_", f"{prefix}_{name}" if prefix else name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def render_openmetrics(snapshot: dict, prefix: str = "repro") -> str:
    """Render one flat snapshot dict as an OpenMetrics text exposition."""
    lines: list[str] = []
    seen: dict[str, float] = {}
    for name, value in snapshot.items():
        try:
            val = float(value)
        except (TypeError, ValueError):
            continue
        if val != val or val in (float("inf"), float("-inf")):
            continue
        seen[_metric_name(str(name), prefix)] = val
    for name in sorted(seen):
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {seen[name]!r}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """A daemon-threaded ``/metrics`` endpoint over snapshot sources.

    ``sources`` is a list of zero-arg callables each returning a flat
    ``{name: float}`` dict (e.g. ``tracker.snapshot`` or
    ``service.snapshot``); they are called fresh on every scrape and merged
    left-to-right.  A source that raises is skipped for that scrape — a
    wedged store must not take down the metrics endpoint."""

    def __init__(self, sources: Iterable[Callable[[], dict]],
                 host: str = "127.0.0.1", port: int = 0,
                 prefix: str = "repro"):
        self.sources = list(sources)
        self.prefix = prefix
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    def render(self) -> str:
        """One merged exposition across all sources (scrape body)."""
        merged: dict = {}
        for src in self.sources:
            try:
                merged.update(src())
            except BaseException:  # noqa: BLE001 — skip a failing source
                continue
        return render_openmetrics(merged, prefix=self.prefix)

    def _handler(self):
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = exporter.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-scrape stderr noise
                pass

        return Handler

    def start(self) -> "MetricsExporter":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
