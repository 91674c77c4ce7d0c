"""The port's copy of splink_tpu/obs/fleet.py.

Fleet observability: metric federation + correlated incident bundles.

The wire tier (serve/wire.py) makes N hosts serve as one system; this module makes
them *observable* as one system. Three pieces, all host-side stdlib and
all off the serve hot path:

**Metric federation** — :class:`FleetAggregator` pulls every host's
:meth:`~..serve.service.LinkageService.fleet_stats` export (locally by
direct call, remotely over the wire's ``stats`` envelope) and merges them
into one snapshot. Every series in the export is mergeable *by
construction*: counters add, the kernel watch's log2-bucket latency
histograms add element-wise with an exact ``sum``, the SLO tracker's
time-bucketed ring adds per absolute bucket index
(:func:`~.slo.merge_exports`), and the drift aggregates are integer count
tensors. The merged histogram's ``_count``/``_sum`` therefore equal the
union of the per-host observations bit-exactly (tests/test_torch_fleet.py
and chip_smoke.py's ``fleet`` phase check exactly that), so the federation ``/metrics`` endpoint
(:meth:`FleetAggregator.prometheus_samples` as an
:class:`~.exposition.ExpositionServer` source) serves real fleet-wide
quantiles, not an average of averages.

**Correlated incident bundles** — :class:`FleetIncidentReporter` sits on
the ambient event bus on the *router* host and watches for fleet-level
incidents: a replica's breaker opening, a burst of link-loss sheds (the
partition signature), or a hedge storm (every primary slow at once —
reported by the router via :meth:`note_hedge`). On a trigger it writes
ONE bundle directory — the router's own flight ring, every reachable
remote's ring (pulled over the wire's ``flight_pull`` envelope) and the
stitched request traces of the triggering window — so the post-mortem for
"the fleet fell over at 03:12" is one directory instead of an N-host
log-ssh crawl. (The reference's bundles also carry the lock-order graph of
its watched locks; the port's locks are plain, so its bundles have none.) Bundles are
rate-limited (one per ``fleet_incident_interval_s``, a storm produces one
artifact) and built on a background thread: the trigger path publishes
and returns.

Cross-host **trace stitching** itself lives in the wire layer
(:mod:`..serve.wire` piggybacks the server's span tree on the result
envelope; :mod:`..serve.remote` grafts it under the client attempt with a
clock-offset correction) — this module consumes the stitched events.

docs/observability.md#fleet holds the operator story.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

from ..analysis import lockwatch

from .events import _sanitise, publish, register_ambient, unregister_ambient

logger = logging.getLogger("splink_tpu_torch")

#: link-loss shed reasons whose burst reads as a partition (the far host
#: vanished mid-conversation vs. was never reachable)
_PARTITION_REASONS = ("connection_lost", "remote_unreachable")


# -- merge helpers (pure functions, unit-testable without sockets) -------


def merge_histograms(hists: list[dict]) -> dict | None:
    """Merge N ``{"counts": [int], "sum": float, "n": int}`` log-bucket
    histograms (the :meth:`~.kernelwatch.KernelWatch.histogram` export
    shape) element-wise. Counts and ``n`` are integer additions and
    ``sum`` adds in the deterministic host order the caller supplies, so
    the merged histogram equals the one a single watch folding the union
    of observations would hold — bit-exactly for counts/n, and exactly
    for ``sum`` given the fixed summation order."""
    hists = [h for h in hists if h and h.get("n")]
    if not hists:
        return None
    width = max(len(h.get("counts") or []) for h in hists)
    counts = [0] * width
    total = 0.0
    n = 0
    for h in hists:
        for i, c in enumerate(h.get("counts") or []):
            counts[i] += int(c)
        total += float(h.get("sum") or 0.0)
        n += int(h.get("n") or 0)
    return {"counts": counts, "sum": total, "n": n}


def merge_drift(exports: list[dict]) -> dict | None:
    """Merge N drift-monitor ``export_aggregate`` payloads (the reference's
    format; the port has no drift monitor yet, so only such payloads from
    elsewhere reach this):
    the gamma histograms and counters are integer counts and add
    element-wise; the per-comparison scores are *recomputable* from the
    merged gamma downstream but are NOT averaged here (an average of
    per-host divergences is not the divergence of the union)."""
    exports = [e for e in exports if e]
    if not exports:
        return None
    gamma = None
    counters: dict = {}
    nulls = None
    for e in exports:
        g = e.get("gamma")
        if g:
            if gamma is None:
                gamma = [[int(v) for v in row] for row in g]
            else:
                for row, srow in zip(gamma, g):
                    for i, v in enumerate(srow):
                        row[i] += int(v)
        c = e.get("counters") or {}
        for k, v in c.items():
            if k == "nulls":
                if nulls is None:
                    nulls = [int(x) for x in v]
                else:
                    for i, x in enumerate(v):
                        nulls[i] += int(x)
            else:
                counters[k] = counters.get(k, 0) + int(v)
    if nulls is not None:
        counters["nulls"] = nulls
    return {
        "window_s": exports[0].get("window_s"),
        "hosts": len(exports),
        "gamma": gamma,
        "counters": counters,
    }


def merge_fleet_stats(snapshots: list[dict]) -> dict | None:
    """Merge N :meth:`~..serve.service.LinkageService.fleet_stats`
    snapshots (deterministic input order) into the fleet view: counters
    add, SLO rings merge per bucket (:func:`~.slo.merge_exports`),
    per-phase histograms merge element-wise, drift tensors add. Per-host
    identity (health, breaker, index generation) survives under
    ``hosts`` — an aggregate that hides which replica is broken is not
    an observability tool."""
    snapshots = [s for s in snapshots if s]
    if not snapshots:
        return None
    from .slo import merge_exports

    counters: dict[str, int] = {}
    hosts = []
    edges = None
    phase_hists: dict[str, list] = {}
    for s in snapshots:
        hosts.append(
            {
                "replica": s.get("replica"),
                "health": s.get("health"),
                "breaker_state": s.get("breaker_state"),
                "index_generation": s.get("index_generation"),
            }
        )
        for k, v in (s.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + int(v)
        perf = s.get("perf") or {}
        if perf.get("edges") and edges is None:
            edges = list(perf["edges"])
        for phase, h in (perf.get("phases") or {}).items():
            phase_hists.setdefault(phase, []).append(h)
    out = {
        "hosts": hosts,
        "counters": counters,
        "slo": merge_exports([s.get("slo") for s in snapshots]),
    }
    phases = {
        phase: merged
        for phase, hs in sorted(phase_hists.items())
        if (merged := merge_histograms(hs)) is not None
    }
    if phases:
        out["perf"] = {"edges": edges, "phases": phases}
    drift = merge_drift([s.get("drift") for s in snapshots])
    if drift is not None:
        out["drift"] = drift
    return out


# -- the aggregator ------------------------------------------------------


class FleetAggregator:
    """Pull-based metric federation over one local service and N remote
    replicas (module docstring).

    ``local`` is anything with a ``fleet_stats()`` method (a
    :class:`~..serve.service.LinkageService`, or None on a pure-router
    host); ``remotes`` is an iterable of
    :class:`~..serve.remote.RemoteReplica` (anything with
    ``fetch_stats()``). Scrapes run on the caller's thread — wire the
    aggregator into an :class:`~.exposition.ExpositionServer` source and
    the endpoint's request thread pays for the pull, rate-limited by
    ``min_scrape_interval_s`` so a dashboard refresh storm costs one
    fleet sweep."""

    def __init__(
        self,
        local=None,
        remotes=(),
        *,
        min_scrape_interval_s: float = 1.0,
        clock=time.monotonic,
    ):
        self.local = local
        self.remotes = list(remotes)
        self.min_scrape_interval_s = float(min_scrape_interval_s)
        self._clock = clock
        self._lock = lockwatch.new_lock("FleetAggregator._lock")
        self._last_scrape = float("-inf")
        self._last_merged: dict | None = None
        self._last_raw: list[dict] = []
        self.scrapes = 0

    def scrape(self, force: bool = False) -> dict | None:
        """One federation sweep: pull every host's export, merge, cache.
        Returns the merged snapshot (the cached one inside the rate-limit
        window). Unreachable remotes and v1 peers are skipped and counted
        in the ``fleet_scrape`` event — partial truth beats no truth."""
        now = self._clock()
        with self._lock:
            if not force and now - self._last_scrape < self.min_scrape_interval_s:
                return self._last_merged
            self._last_scrape = now
        snapshots: list[dict] = []
        unreachable = []
        if self.local is not None:
            try:
                snapshots.append(self.local.fleet_stats())
            except Exception as e:  # noqa: BLE001 - federation must not raise into the endpoint
                logger.warning("fleet: local stats failed: %s", e)
        for remote in self.remotes:
            try:
                snap = remote.fetch_stats()
            except Exception as e:  # noqa: BLE001 - one dead host must not kill the sweep
                logger.warning(
                    "fleet: stats pull from %s failed: %s",
                    getattr(remote, "name", remote), e,
                )
                snap = None
            if snap is None:
                unreachable.append(getattr(remote, "name", str(remote)))
            else:
                snapshots.append(snap)
        merged = merge_fleet_stats(snapshots)
        with self._lock:
            self._last_merged = merged
            self._last_raw = snapshots
            self.scrapes += 1
        publish(
            "fleet_scrape",
            hosts=len(snapshots),
            unreachable=unreachable,
            served=(merged or {}).get("counters", {}).get("served", 0),
        )
        return merged

    def snapshot(self) -> dict | None:
        """The last merged view without forcing a sweep (None before the
        first scrape)."""
        with self._lock:
            return self._last_merged

    def raw_snapshots(self) -> list[dict]:
        """The per-host exports behind the last merge (the federation
        bit-exactness check compares the merged series against these)."""
        with self._lock:
            return list(self._last_raw)

    def prometheus_samples(self) -> list:
        """The federation ``/metrics`` source: fleet-total counters, SLO
        burn, per-host health, and the merged per-phase latency
        histograms as native Prometheus histogram families."""
        from .exposition import HistogramSample, Sample

        merged = self.scrape()
        if merged is None:
            return [
                Sample("splink_fleet_hosts", 0, {}, "gauge",
                       "Hosts contributing to the federated view"),
            ]
        out = [
            Sample("splink_fleet_hosts", len(merged["hosts"]), {}, "gauge",
                   "Hosts contributing to the federated view"),
        ]
        for k, v in sorted(merged.get("counters", {}).items()):
            out.append(
                Sample(f"splink_fleet_{k}_total", v, {}, "counter",
                       f"Fleet-wide {k} (sum over hosts)")
            )
        slo = merged.get("slo") or {}
        if slo:
            out.append(
                Sample("splink_fleet_slo_good_total",
                       slo.get("total_good", 0), {}, "counter",
                       "Fleet-wide requests inside the SLO")
            )
            out.append(
                Sample("splink_fleet_slo_bad_total",
                       slo.get("total_bad", 0), {}, "counter",
                       "Fleet-wide requests outside the SLO")
            )
            for w, stats in sorted((slo.get("windows") or {}).items()):
                out.append(
                    Sample("splink_fleet_slo_burn_rate",
                           stats.get("burn_rate") or 0.0,
                           {"window_s": w}, "gauge",
                           "Fleet error-budget burn rate per window")
                )
        from ..serve.health import health_rank

        for host in merged.get("hosts", []):
            out.append(
                Sample("splink_fleet_host_health_rank",
                       health_rank(host.get("health") or "healthy"),
                       {"replica": str(host.get("replica"))}, "gauge",
                       "0 healthy / 1 degraded / 2 broken, per host")
            )
        perf = merged.get("perf") or {}
        edges = perf.get("edges") or []
        for phase, h in sorted((perf.get("phases") or {}).items()):
            cum = 0
            buckets = []
            for c, e in zip(h["counts"], edges):
                cum += c
                buckets.append((float(e), float(cum)))
            out.append(
                HistogramSample(
                    name="splink_fleet_phase_seconds",
                    buckets=buckets,
                    sum=float(h["sum"]),
                    count=float(h["n"]),
                    labels={"phase": phase},
                    help="Fleet-merged per-phase latency histogram "
                         "(exact sum/count over the union of hosts)",
                )
            )
        return out


# -- correlated incident bundles -----------------------------------------


class FleetIncidentReporter:
    """Router-side incident watcher + bundle writer (module docstring).

    Registers itself as an ambient event sink; triggers:

    * ``degradation`` with ``to == "breaker_open"`` — a replica's breaker
      opened (the :class:`~.flight.FlightRecorder`'s own trigger,
      promoted to fleet scope),
    * >= ``partition_burst`` link-loss sheds (``wire_shed`` with a
      :data:`_PARTITION_REASONS` reason) inside ``burst_window_s``,
    * >= ``hedge_storm`` router hedges (:meth:`note_hedge`) inside
      ``burst_window_s`` — every primary slow at once is a fleet
      incident even when no single replica trips anything.

    One bundle per ``interval_s`` whatever the trigger rate; the bundle
    thread is a daemon and every failure inside it logs-and-continues —
    a broken bundle writer must never take down routing.
    """

    def __init__(
        self,
        *,
        local_flight=None,
        remotes=(),
        bundle_dir: str | None = None,
        interval_s: float | None = None,
        partition_burst: int = 3,
        hedge_storm: int = 10,
        burst_window_s: float = 10.0,
        trace_capacity: int = 128,
        settings: dict | None = None,
        clock=time.monotonic,
    ):
        from .flight import default_dump_dir

        settings = settings or {}
        self.local_flight = local_flight
        self.remotes = list(remotes)
        self.bundle_dir = (
            bundle_dir
            or settings.get("fleet_bundle_dir")
            or os.path.join(default_dump_dir(), "incidents")
        )
        if interval_s is None:
            interval_s = settings.get("fleet_incident_interval_s", 30.0)
        self.interval_s = float(interval_s)
        self.partition_burst = int(partition_burst)
        self.hedge_storm = int(hedge_storm)
        self.burst_window_s = float(burst_window_s)
        self._clock = clock
        self._lock = lockwatch.new_lock("FleetIncidentReporter._lock")
        self._traces: deque = deque(maxlen=max(int(trace_capacity), 1))
        self._shed_times: deque = deque(maxlen=1024)
        self._hedge_times: deque = deque(maxlen=1024)
        self._last_bundle = float("-inf")
        self._seq = 0
        self.bundles: list[str] = []
        register_ambient(self)

    # -- ambient-sink interface ------------------------------------------

    def emit(self, type: str, **fields) -> None:
        """Watch the process-wide event stream for fleet incidents.
        Never raises; the bundle itself is built off-thread."""
        try:
            if type == "request_trace":
                # keep the stitched window: the traces around a trigger
                # are the "what was in flight" half of the post-mortem
                with self._lock:
                    self._traces.append(_sanitise(fields))
                return
            if type == "degradation" and fields.get("to") == "breaker_open":
                self._trigger(
                    "breaker_open", replica=fields.get("replica")
                )
            elif type == "wire_shed" and fields.get("reason") in _PARTITION_REASONS:
                now = self._clock()
                with self._lock:
                    self._shed_times.append(now)
                    horizon = now - self.burst_window_s
                    burst = sum(1 for t in self._shed_times if t >= horizon)
                if burst >= self.partition_burst:
                    self._trigger(
                        "partition",
                        replica=fields.get("replica"),
                        sheds_in_window=burst,
                    )
        except Exception as e:  # noqa: BLE001 - the reporter must never break serving
            logger.warning("fleet incident emit failed: %s", e)

    def note_hedge(self) -> None:
        """Called by the router after dispatching a hedge (outside its
        locks). A storm of hedges inside the burst window triggers a
        bundle: everything slow at once has a common cause worth a
        correlated artifact."""
        try:
            now = self._clock()
            with self._lock:
                self._hedge_times.append(now)
                horizon = now - self.burst_window_s
                storm = sum(1 for t in self._hedge_times if t >= horizon)
            if storm >= self.hedge_storm:
                self._trigger("hedge_storm", hedges_in_window=storm)
        except Exception as e:  # noqa: BLE001 - the hedge path must never pay for observability
            logger.warning("fleet hedge note failed: %s", e)

    # -- bundle construction ---------------------------------------------

    def _trigger(self, trigger: str, **context) -> None:
        now = self._clock()
        with self._lock:
            if now - self._last_bundle < self.interval_s:
                return
            self._last_bundle = now
            self._seq += 1
            seq = self._seq
        threading.Thread(
            target=self._build_bundle,
            args=(trigger, seq, dict(context)),
            name=f"fleet-incident-{trigger}",
            daemon=True,
        ).start()

    def build_now(self, trigger: str = "manual", **context) -> str | None:
        """Synchronous bundle build, bypassing the rate limit (operator /
        test entry point). Returns the bundle directory or None."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        return self._build_bundle(trigger, seq, dict(context))

    def _build_bundle(self, trigger: str, seq: int, context: dict):
        """Write one bundle directory. Every constituent is best-effort:
        an unreachable remote contributes an entry in the manifest's
        ``unreachable`` list, not a failure."""
        try:
            path = os.path.join(
                self.bundle_dir,
                f"incident_{trigger}_{os.getpid()}_{seq:04d}",
            )
            os.makedirs(path, exist_ok=True)
            manifest = {
                "trigger": trigger,
                "context": context,
                "ts": time.time(),
                "mono": time.monotonic(),
                "files": [],
                "unreachable": [],
            }
            if self.local_flight is not None:
                local = self.local_flight.dump(
                    f"fleet_{trigger}",
                    path=os.path.join(path, "flight_local.jsonl"),
                )
                if local:
                    manifest["files"].append("flight_local.jsonl")
            for remote in self.remotes:
                name = getattr(remote, "name", str(remote))
                fname = "flight_%s.jsonl" % _safe_name(name)
                try:
                    pulled = remote.pull_flight()
                except Exception as e:  # noqa: BLE001 - a dead remote is a manifest entry
                    logger.warning(
                        "fleet: flight pull from %s failed: %s", name, e
                    )
                    pulled = None
                if not pulled or not pulled.get("records"):
                    manifest["unreachable"].append(name)
                    continue
                self._write_jsonl(
                    os.path.join(path, fname),
                    [
                        {
                            "type": "flight_header",
                            "trigger": f"fleet_{trigger}",
                            "service": pulled.get("replica") or name,
                            "records": len(pulled["records"]),
                        }
                    ]
                    + list(pulled["records"]),
                )
                manifest["files"].append(fname)
            with self._lock:
                traces = list(self._traces)
            if traces:
                self._write_jsonl(
                    os.path.join(path, "stitched_traces.jsonl"),
                    [dict(t, type="request_trace") for t in traces],
                )
                manifest["files"].append("stitched_traces.jsonl")
            self._write_json(
                os.path.join(path, "manifest.json"), manifest
            )
            with self._lock:
                self.bundles.append(path)
            publish(
                "incident_bundle",
                trigger=trigger,
                path=path,
                files=manifest["files"],
                unreachable=manifest["unreachable"],
                **{k: v for k, v in context.items() if v is not None},
            )
            logger.warning(
                "fleet incident bundle written: %s (trigger: %s, %d files)",
                path, trigger, len(manifest["files"]),
            )
            return path
        except Exception as e:  # noqa: BLE001 - a failed bundle must not break anything
            logger.warning("fleet incident bundle failed: %s", e)
            return None

    @staticmethod
    def _write_jsonl(path: str, entries: list) -> None:
        from ..resilience.checkpoint import atomic_write_bytes

        lines = [json.dumps(_sanitise(e)) for e in entries]
        atomic_write_bytes(path, ("\n".join(lines) + "\n").encode("utf-8"))

    @staticmethod
    def _write_json(path: str, obj: dict) -> None:
        from ..resilience.checkpoint import atomic_write_bytes

        atomic_write_bytes(
            path,
            json.dumps(_sanitise(obj), indent=2).encode("utf-8"),
        )

    def close(self) -> None:
        """Unregister from the ambient publisher. Idempotent."""
        unregister_ambient(self)


def _safe_name(name: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in name)
