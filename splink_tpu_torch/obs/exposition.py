"""The port's copy of splink_tpu/obs/exposition.py.

Prometheus text-exposition endpoint, pure stdlib (``http.server``).

The serving tier's metrics live in process memory (latency reservoirs,
phase summaries, SLO windows, health snapshots). Production monitoring
wants them scrapeable; this module serves them in the Prometheus text
format (version 0.0.4) without adding a dependency: a
:class:`ThreadingHTTPServer` on the opt-in ``obs_exposition_port`` settings
key (0 — the default — disables; the server binds 127.0.0.1, a deliberate
scrape-via-sidecar / port-forward posture rather than an open listener).

Sources are pull-based: a component registers a zero-argument callable
returning :class:`Sample` rows, and the handler renders them at scrape
time — no background collection thread, no staleness, and a source that
raises is skipped with a warning rather than failing the scrape.

``GET /metrics`` returns the exposition; ``GET /healthz`` returns 200 with
a one-line JSON of each source's name (a liveness probe that does not pay
for a full render).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger("splink_tpu_torch")

#: uptime fallback anchor where /proc is unavailable (first obs import)
_PROCESS_T0 = time.time()

_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


@dataclass
class Sample:
    """One exposition row: ``name{labels} value``."""

    name: str
    value: float
    labels: dict = field(default_factory=dict)
    type: str = "gauge"
    help: str = ""


@dataclass
class HistogramSample:
    """One native Prometheus histogram family instance: renders as the
    conventional ``<name>_bucket{le="..."}`` cumulative series (an
    explicit ``+Inf`` bucket included), ``<name>_sum`` and
    ``<name>_count``, under a single ``# TYPE <name> histogram`` header.

    ``buckets`` is a list of ``(upper_bound, cumulative_count)`` pairs in
    ascending bound order WITHOUT the +Inf bucket — the renderer appends
    ``+Inf`` carrying ``count``. ``sum`` may be an approximation (e.g.
    bin midpoints when only a binned histogram exists); say so in
    ``help``."""

    name: str
    buckets: list
    sum: float
    count: float
    labels: dict = field(default_factory=dict)
    help: str = ""


def histogram_from_counts(
    name: str,
    counts,
    edges,
    labels: dict | None = None,
    help: str = "",
) -> HistogramSample:
    """Build a :class:`HistogramSample` from per-bin counts and the bins'
    upper edges (len(edges) == len(counts)). The ``sum`` uses bin
    midpoints (lower edge = previous upper edge, 0 before the first) —
    an approximation inherent to pre-binned data."""
    counts = [float(c) for c in counts]
    edges = [float(e) for e in edges]
    cum = 0.0
    buckets = []
    total_sum = 0.0
    prev = 0.0
    for c, e in zip(counts, edges):
        cum += c
        buckets.append((e, cum))
        total_sum += c * (prev + e) / 2.0
        prev = e
    return HistogramSample(
        name=name,
        buckets=buckets,
        sum=total_sum,
        count=cum,
        labels=dict(labels or {}),
        help=help,
    )


def _process_start_time() -> float:
    """Unix timestamp of process start: /proc starttime + boot time on
    Linux, the first-obs-import anchor elsewhere."""
    try:
        with open("/proc/self/stat", "rb") as fh:
            # field 22 (1-based) counts clock ticks since boot; the comm
            # field may contain spaces, so split after the closing paren
            fields = fh.read().rsplit(b")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/stat", "rb") as fh:
            btime = next(
                int(line.split()[1])
                for line in fh
                if line.startswith(b"btime")
            )
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except Exception:  # noqa: BLE001 - non-Linux / exotic procfs
        return _PROCESS_T0


def process_samples() -> list:
    """Process-level health gauges in the conventional Prometheus names:
    resident memory, cumulative user/system CPU seconds, open file
    descriptors, start time and uptime. Pure stdlib (procfs + resource);
    a metric the platform cannot answer is omitted rather than faked —
    scrapers see the series they can trust. Served alongside the
    per-replica serve series by ``LinkageService.prometheus_samples``."""
    out: list[Sample] = []
    rss = None
    try:
        with open("/proc/self/statm", "rb") as fh:
            rss = int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # noqa: BLE001 - non-Linux
        rss = None
    if rss is not None:
        out.append(Sample(
            "process_resident_memory_bytes", float(rss), {}, "gauge",
            "Resident set size in bytes",
        ))
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        out.append(Sample(
            "process_cpu_seconds_total", ru.ru_utime + ru.ru_stime, {},
            "counter", "Total user+system CPU seconds",
        ))
        out.append(Sample(
            "process_cpu_user_seconds_total", ru.ru_utime, {}, "counter",
            "User-mode CPU seconds",
        ))
        out.append(Sample(
            "process_cpu_system_seconds_total", ru.ru_stime, {}, "counter",
            "Kernel-mode CPU seconds",
        ))
        if rss is None and ru.ru_maxrss:
            # no procfs: report the rusage high-water mark, labelled so
            out.append(Sample(
                "process_resident_memory_bytes", float(ru.ru_maxrss * 1024),
                {"kind": "peak"}, "gauge",
                "Peak resident set size in bytes (ru_maxrss; live RSS "
                "unavailable on this platform)",
            ))
    except Exception:  # noqa: BLE001 - resource module may be absent (windows)
        pass
    try:
        out.append(Sample(
            "process_open_fds", float(len(os.listdir("/proc/self/fd"))),
            {}, "gauge", "Open file descriptors",
        ))
    except Exception:  # noqa: BLE001 - non-Linux
        pass
    start = _process_start_time()
    out.append(Sample(
        "process_start_time_seconds", start, {}, "gauge",
        "Process start time (unix seconds)",
    ))
    out.append(Sample(
        "process_uptime_seconds", max(time.time() - start, 0.0), {},
        "gauge", "Seconds since process start",
    ))
    return out


def _escape_label(value) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_value(value: float) -> str:
    value = float(value)
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render_samples(samples: list) -> str:
    """Render samples (:class:`Sample` / :class:`HistogramSample`, freely
    mixed) as Prometheus text format, grouping rows into families (one
    ``# HELP`` / ``# TYPE`` header per metric name, first sample's
    metadata wins). Histogram families emit the conventional
    ``_bucket``/``_sum``/``_count`` series with cumulative ``le`` bounds
    ending at ``+Inf``."""
    families: dict[str, list] = {}
    for s in samples:
        families.setdefault(s.name, []).append(s)
    lines: list[str] = []
    for name, rows in families.items():
        head = rows[0]
        if head.help:
            lines.append(f"# HELP {name} {head.help}")
        if isinstance(head, HistogramSample):
            lines.append(f"# TYPE {name} histogram")
            for s in rows:
                for bound, cum in s.buckets:
                    labels = {**s.labels, "le": _fmt_value(bound)}
                    lines.append(
                        f"{name}_bucket{_fmt_labels(labels)} {_fmt_value(cum)}"
                    )
                labels = {**s.labels, "le": "+Inf"}
                lines.append(
                    f"{name}_bucket{_fmt_labels(labels)} "
                    f"{_fmt_value(s.count)}"
                )
                lines.append(
                    f"{name}_sum{_fmt_labels(s.labels)} {_fmt_value(s.sum)}"
                )
                lines.append(
                    f"{name}_count{_fmt_labels(s.labels)} "
                    f"{_fmt_value(s.count)}"
                )
            continue
        mtype = head.type if head.type in _TYPES else "untyped"
        lines.append(f"# TYPE {name} {mtype}")
        for s in rows:
            if s.value is None:
                continue
            lines.append(
                f"{name}{_fmt_labels(s.labels)} {_fmt_value(s.value)}"
            )
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "splink-tpu-obs"

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0].rstrip("/") or "/metrics"
        if path == "/metrics":
            body = self.server.exposition.render().encode("utf-8")
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/healthz":
            body = (
                json.dumps({"sources": self.server.exposition.source_names()})
                + "\n"
            ).encode("utf-8")
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # noqa: D102 - scrapes must not spam stderr
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class ExpositionServer:
    """The opt-in metrics endpoint (module docstring). ``port=0`` binds an
    ephemeral port (tests); read the bound port back from :attr:`port`
    after :meth:`start`."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._host = host
        self._port = int(port)
        self._sources: dict[str, object] = {}
        self._lock = threading.Lock()
        self._server: _Server | None = None
        self._thread: threading.Thread | None = None

    # -- sources --------------------------------------------------------

    def add_source(self, name: str, fn) -> None:
        """Register ``fn() -> list[Sample]`` under ``name`` (replacing any
        previous source of that name)."""
        with self._lock:
            self._sources[name] = fn

    def remove_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def source_names(self) -> list[str]:
        with self._lock:
            return sorted(self._sources)

    def render(self) -> str:
        samples: list[Sample] = []
        with self._lock:
            sources = list(self._sources.items())
        for name, fn in sources:
            try:
                samples.extend(fn())
            except Exception as e:  # noqa: BLE001 - one bad source must not 500 the scrape
                logger.warning("exposition source %s failed: %s", name, e)
        return render_samples(samples)

    # -- lifecycle ------------------------------------------------------

    @property
    def port(self) -> int | None:
        return self._server.server_address[1] if self._server else None

    @property
    def url(self) -> str | None:
        return (
            f"http://{self._host}:{self.port}/metrics"
            if self._server
            else None
        )

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port."""
        if self._server is not None:
            return self.port
        server = _Server((self._host, self._port), _Handler)
        server.exposition = self
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever,
            name="splink-obs-exposition",
            daemon=True,
        )
        self._thread.start()
        return self.port

    def close(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
