"""HTTP metrics endpoint — the JMX MBean surface, reachable the modern way.

The reference exposes its MIX server metrics over JMX
(ref: mixserv/.../metrics/MetricsRegistry.java). A JVM-less runtime exposes
the same registry as an HTTP scrape endpoint instead; the routes and the
exposition are the JAX package's (`hivemall_tpu/runtime/metrics_http.py`):

- `GET /metrics`  — Prometheus text exposition of the process-wide
  `runtime.metrics.REGISTRY` (counters, gauges, meters, histograms);
  `?exemplars=1` appends OpenMetrics-style exemplars to histogram bucket
  lines (`# {trace_id="..."} value ts`) linking buckets to traces;
- `GET /healthz`  — liveness (200 + json with process/device info, read
  from torch);
- `GET /trace?n=` — the last n committed traces from the process tracer
  (runtime/tracing.py) as Chrome trace_event JSON (ui.perfetto.dev);
- `GET /slo`      — every registered objective's multi-window burn rates,
  ok/warn/page state and recent transitions (runtime/slo.py);
- `GET /debug/bundle?n=` — the flight-recorder snapshot in one strictly
  JSON document (runtime/debug_bundle.py); on the serving port it
  includes every deployed model's describe().

serving/server.py's handler extends this one on the serving port;
`serve_metrics(port)` starts the bare endpoint on a daemon thread.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .metrics import REGISTRY
from .tracing import TRACER

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")

def _prom_name(key: str) -> str:
    """Metric keys like "train.rows_processed" -> prometheus-legal names."""
    return _NAME_OK.sub("_", key.replace(".", "_"))


def _fmt_le(ub: float) -> str:
    if ub == float("inf"):
        return "+Inf"
    return repr(ub)


def render_prometheus(exemplars: bool = False) -> str:
    """Prometheus text exposition of the process registry with `# HELP` /
    `# TYPE` metadata and true metric kinds (counter / gauge / histogram;
    meters surface as gauges).

    ``exemplars=True`` appends OpenMetrics-style exemplars to histogram
    bucket lines for buckets that carry one. Off by default: the 0.0.4 text
    format predates exemplars and strict scrapers may reject the suffix.
    """
    lines = []

    def head(name: str, kind: str, help_text: str) -> None:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")

    snap = REGISTRY.typed_snapshot()
    for key in sorted(snap["counters"]):
        name = f"hivemall_tpu_{_prom_name(key)}"
        head(name, "counter", f"monotonic counter {key}")
        lines.append(f"{name} {snap['counters'][key]}")
    for key in sorted(snap["gauges"]):
        name = f"hivemall_tpu_{_prom_name(key)}"
        head(name, "gauge", f"gauge {key}")
        lines.append(f"{name} {float(snap['gauges'][key])}")
    for key in sorted(snap["meters"]):
        name = f"hivemall_tpu_{_prom_name(key)}"
        head(name, "gauge", f"sliding-window throughput {key}")
        lines.append(f"{name} {float(snap['meters'][key])}")
    for key in sorted(snap["histograms"]):
        h = snap["histograms"][key]
        name = f"hivemall_tpu_{_prom_name(key)}"
        head(name, "histogram", f"fixed-bucket histogram {key}")
        ex = h.get("exemplars", {}) if exemplars else {}
        for ub, cum in h["buckets"]:
            line = f'{name}_bucket{{le="{_fmt_le(ub)}"}} {cum}'
            e = ex.get(ub)
            if e is not None:
                line += (f' # {{trace_id="{e["trace_id"]}"}} '
                         f'{e["value"]} {e["unix"]}')
            lines.append(line)
        lines.append(f"{name}_sum {float(h['sum'])}")
        lines.append(f"{name}_count {h['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def device_info() -> dict:
    """The process's place in a job and its devices, from torch:
    ``process_index`` / ``process_count`` from an initialised
    torch.distributed group (0 / 1 without one) and ``local_devices``, the
    CUDA devices this process sees."""
    import torch
    import torch.distributed as dist

    group = dist.is_available() and dist.is_initialized()
    return {
        "process_index": dist.get_rank() if group else 0,
        "process_count": dist.get_world_size() if group else 1,
        "local_devices": torch.cuda.device_count(),
    }


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - http.server API
        path = self.path.split("?")[0]
        if path == "/metrics":
            qs = parse_qs(urlparse(self.path).query)
            with_ex = qs.get("exemplars", ["0"])[0] not in ("0", "")
            body = render_prometheus(exemplars=with_ex).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
        elif path == "/trace":
            qs = parse_qs(urlparse(self.path).query)
            try:
                n = int(qs.get("n", ["20"])[0])
            except ValueError:
                n = 20
            body = json.dumps(TRACER.chrome_trace(n=n)).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif path == "/slo":
            from .slo import ENGINE

            body = json.dumps(ENGINE.status()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif path == "/debug/bundle":
            from .debug_bundle import build_bundle

            qs = parse_qs(urlparse(self.path).query)
            try:
                n = int(qs.get("n", ["50"])[0])
            except ValueError:
                n = 50
            # a serving server carries its registry (serving/server.serve);
            # the bare metrics endpoint has none and the models section
            # stays empty
            body = json.dumps(build_bundle(
                registry=getattr(self.server, "registry", None),
                n_traces=n)).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif path == "/healthz":
            body = json.dumps({"status": "ok", **device_info()}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        else:
            body = b"not found\n"
            self.send_response(404)
            self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-request stderr noise
        pass


def serve_metrics(port: int = 0, host: str = "127.0.0.1"
                  ) -> ThreadingHTTPServer:
    """Start the scrape endpoint on a daemon thread; returns the server
    (``server.server_address[1]`` is the bound port — pass port=0 for an
    ephemeral one). Call ``server.shutdown()`` to stop."""
    server = ThreadingHTTPServer((host, port), _Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="hivemall-tpu-metrics")
    t.start()
    return server
