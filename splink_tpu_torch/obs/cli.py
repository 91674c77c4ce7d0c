"""CLI: ``python -m splink_tpu_torch.obs
summarize|export-trace|attribute|drift|bench-report|serve-dash|fleet-dash``.

The port's copy of splink_tpu/obs/cli.py: the same commands over the same
JSONL record, so each package's CLI reads the other's record.

``summarize`` renders a per-stage / per-iteration report of one run's
telemetry record; ``export-trace`` converts it to Chrome trace-event JSON
(load at ui.perfetto.dev); ``attribute`` decomposes serve tail latency
into the request-trace phases; ``drift`` reports the drift observatory
(the PSI trajectory of the served distribution against the
training-reference profile, plus the alert timeline); ``serve-dash`` and
``fleet-dash`` render a live terminal dashboard by polling Prometheus
exposition endpoints. This module's logic is pure stdlib and touches no
device, but ``python -m splink_tpu_torch.obs`` imports the
``splink_tpu_torch`` package, and with it torch (a record copied to a
machine without them is plain JSON lines).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .events import read_events
from .reqtrace import PHASES, _quantile
from .tracer import chrome_trace_from_events


def _fmt_s(v) -> str:
    return f"{v:.3f}s" if isinstance(v, (int, float)) else "-"


def _or0(v):
    """Torn-record tolerance for fields where 0.0 is a REAL value (a
    collapsed match yield): substitute only on missing, never on falsy."""
    return 0 if v is None else v


def summarize_events(events: list[dict]) -> str:
    """Human-readable report of one run's telemetry events."""
    if not events:
        return "(empty telemetry record)"
    lines: list[str] = []
    run_id = events[0].get("run_id", "?")
    monos = [e["mono"] for e in events if isinstance(e.get("mono"), (int, float))]
    wall = (max(monos) - min(monos)) if monos else 0.0
    hosts = sorted({e.get("process_index", 0) for e in events})
    lines.append(f"run {run_id}  ({len(events)} events, {wall:.3f}s, "
                 f"host(s) {', '.join(str(h) for h in hosts)})")

    # a flight-recorder dump (obs/flight.py) opens with its header line
    flight = [e for e in events if e.get("type") == "flight_header"]
    for ev in flight:
        lines.append(
            f"flight dump: trigger={ev.get('trigger')} "
            f"service={ev.get('service')} records={ev.get('records')}"
        )

    # ---- stages ----------------------------------------------------------
    stages: dict[str, dict] = {}
    for ev in events:
        if ev.get("type") == "span" and ev.get("kind") == "stage":
            s = stages.setdefault(
                ev["name"],
                {"count": 0, "total": 0.0, "compile": 0.0, "execute": 0.0,
                 "compiles": 0},
            )
            attrs = ev.get("attrs") or {}
            s["count"] += 1
            s["total"] += float(ev.get("dur_s") or 0.0)
            s["compile"] += float(attrs.get("compile_s") or 0.0)
            s["execute"] += float(attrs.get("execute_s") or 0.0)
            s["compiles"] += int(attrs.get("compile_count") or 0)
    if stages:
        lines.append("")
        lines.append(f"{'stage':<24}{'n':>4}{'total':>10}{'compile':>10}"
                     f"{'execute':>10}{'jits':>6}")
        for name, s in sorted(stages.items(), key=lambda kv: -kv[1]["total"]):
            lines.append(
                f"{name:<24}{s['count']:>4}{s['total']:>9.3f}s"
                f"{s['compile']:>9.3f}s{s['execute']:>9.3f}s{s['compiles']:>6}"
            )

    # ---- EM convergence --------------------------------------------------
    iters = [e for e in events if e.get("type") == "em_iteration"]
    if iters:
        lines.append("")
        lines.append(f"EM: {len(iters)} update(s)")
        lines.append(f"{'iter':>5}{'lambda':>12}{'log_lik':>14}{'delta':>12}"
                     f"{'conv':>6}")
        shown = iters if len(iters) <= 12 else iters[:6] + iters[-6:]
        prev_it = None
        for ev in shown:
            it = ev.get("iteration")
            if prev_it is not None and it is not None and it > prev_it + 1:
                lines.append(f"{'...':>5}")
            prev_it = it
            # any numeric field can be null: the sink sanitises non-finite
            # floats (a diverged EM emits lam=NaN -> null), and a torn
            # record may miss fields entirely
            lam = ev.get("lam")
            ll = ev.get("ll")
            delta = ev.get("delta")
            lines.append(
                f"{(it if it is not None else '?'):>5}"
                f"{(f'{lam:.6f}' if isinstance(lam, (int, float)) else '-'):>12}"
                f"{(f'{ll:.4f}' if isinstance(ll, (int, float)) else '-'):>14}"
                f"{(f'{delta:.2e}' if isinstance(delta, (int, float)) else '-'):>12}"
                f"{('yes' if ev.get('converged') else ''):>6}"
            )

    # ---- numerics (analysis layer 6 + EM trajectory guard) ---------------
    num_audits = [e for e in events if e.get("type") == "num_audit"]
    em_halts = [e for e in events if e.get("type") == "em_numerics"]
    if num_audits or em_halts:
        lines.append("")
        lines.append(
            f"numerics: {len(num_audits)} audit(s), "
            f"{len(em_halts)} EM halt(s)"
        )
        for ev in num_audits:
            lines.append(
                f"  audit: {_or0(ev.get('kernels'))} kernel(s) on tier "
                f"{ev.get('tier') or '?'}, "
                f"{_or0(ev.get('findings'))} finding(s), "
                f"worst ulp {_or0(ev.get('worst_ulp'))}"
            )
        for ev in em_halts:
            fields = ev.get("fields") or []
            ckpt = ev.get("checkpoint_dir")
            ref = (
                f", checkpoint @{_or0(ev.get('last_checkpoint_iteration'))} "
                f"in {ckpt}"
                if ckpt
                else ""
            )
            lines.append(
                f"  EM HALT at iteration {_or0(ev.get('iteration'))} "
                f"(non-finite: {', '.join(str(f) for f in fields) or '?'}); "
                f"last finite iteration "
                f"{_or0(ev.get('last_good_iteration'))}{ref}"
            )

    # ---- request traces (serve tier, obs v2) -----------------------------
    traces = [e for e in events if e.get("type") == "request_trace"]
    if traces:
        by_outcome: dict[str, int] = {}
        reasons: dict[str, int] = {}
        for ev in traces:
            oc = ev.get("outcome") or "?"
            by_outcome[oc] = by_outcome.get(oc, 0) + 1
            if oc == "shed":
                rs = ev.get("reason") or "?"
                reasons[rs] = reasons.get(rs, 0) + 1
        lines.append("")
        lines.append(
            f"request traces: {len(traces)} ("
            + ", ".join(f"{k} {v}" for k, v in sorted(by_outcome.items()))
            + ")"
        )
        if reasons:
            lines.append(
                "  shed reasons: "
                + ", ".join(f"{k}={v}"
                            for k, v in sorted(reasons.items()))
            )
        delivered = [e for e in traces if e.get("outcome") == "delivered"]
        if delivered:
            walls = sorted(
                float(e.get("wall_ms") or 0.0) for e in delivered
            )
            lines.append(
                f"  delivered wall ms: p50={_quantile(walls, 0.5):.2f} "
                f"p95={_quantile(walls, 0.95):.2f} "
                f"p99={_quantile(walls, 0.99):.2f}"
            )
            lines.append(f"  {'phase':<12}{'p50 ms':>10}{'p99 ms':>10}")
            for phase in PHASES:
                vals = sorted(
                    float((e.get("phases_ms") or {}).get(phase) or 0.0)
                    for e in delivered
                )
                lines.append(
                    f"  {phase:<12}{_quantile(vals, 0.5):>10.3f}"
                    f"{_quantile(vals, 0.99):>10.3f}"
                )

    # ---- device-blocking emission telemetry ------------------------------
    blocking = [e for e in events if e.get("type") == "blocking_device"]
    if blocking:
        lines.append("")
        lines.append(f"device blocking: {len(blocking)} emission run(s)")
        for ev in blocking:
            lines.append(
                f"  pairs={ev.get('pairs'):,} chunks={ev.get('chunks')} "
                f"pairs/s={ev.get('pairs_per_sec'):,} "
                f"budget={ev.get('chunk_budget'):,} "
                f"fill={ev.get('mean_chunk_fill')} "
                f"d2h_occupancy={ev.get('d2h_occupancy_mean')}"
                f"/{ev.get('d2h_occupancy_max')}"
                + ("" if ev.get("completed") else "  [abandoned]")
            )
            for rr in ev.get("per_rule") or []:
                lines.append(
                    f"    rule {rr.get('rule')!r}: {rr.get('pairs'):,} "
                    f"pairs in {rr.get('chunks')} chunk(s)"
                )

    # ---- sharded spill-emission telemetry --------------------------------
    spill = [e for e in events if e.get("type") == "blocking_spill"]
    if spill:
        lines.append("")
        lines.append(f"spill emission: {len(spill)} run(s)")
        for ev in spill:
            # torn/old records may miss fields: render 0, never crash
            lines.append(
                f"  pairs={ev.get('pairs') or 0:,} "
                f"segments={ev.get('segments') or 0} "
                f"shards={ev.get('shards') or 0} "
                f"resumed={ev.get('skipped') or 0} "
                f"pairs/s={ev.get('pairs_per_sec') or 0:,}"
                + (" [budget exhausted]" if ev.get("exhausted") else "")
            )

    # ---- approximate-blocking telemetry ----------------------------------
    approx = [e for e in events if e.get("type") == "blocking_approx"]
    if approx:
        lines.append("")
        lines.append(f"approx blocking: {len(approx)} run(s)")
        for ev in approx:
            # torn/old records may miss fields: render 0, never crash
            lines.append(
                f"  bands={ev.get('bands') or 0}x{ev.get('rows_per_band') or 0} "
                f"q={ev.get('q') or 0} candidates={ev.get('candidates') or 0:,} "
                f"survivors={ev.get('survivors') or 0:,}"
                + (" (verified)" if ev.get("verified") else "")
                + f" emitted={ev.get('emitted') or 0:,}"
                f" budget={ev.get('budget') or 0:,}"
                f" fill={ev.get('budget_fill') or 0}"
            )
            extra = []
            if ev.get("exact_overlap_removed"):
                extra.append(
                    f"exact-tier overlap removed "
                    f"{ev.get('exact_overlap_removed'):,}"
                )
            if ev.get("oversize_buckets_dropped"):
                extra.append(
                    f"oversize buckets dropped "
                    f"{ev.get('oversize_buckets_dropped')}"
                )
            if ev.get("cols"):
                extra.append("cols " + ",".join(ev["cols"]))
            if extra:
                lines.append("    " + "; ".join(extra))

    # ---- EM diagnostics (obs/quality.em_diagnostics) ---------------------
    diags = [e for e in events if e.get("type") == "em_diagnostics"]
    if diags:
        ev = diags[-1]  # one per EM run; latest wins
        lines.append("")
        lines.append(
            f"EM diagnostics: lambda={ev.get('lam') or 0} "
            f"({ev.get('n_iterations') or 0} archived state(s))"
        )
        lines.append(f"  {'column':<18}{'level':>6}{'m':>10}{'u':>10}"
                     f"{'log2 bf':>9}{'support':>10}")
        for col in ev.get("columns") or []:
            name = col.get("name") or "?"
            ms = col.get("m") or []
            us = col.get("u") or []
            bfs = col.get("log2_bf") or []
            sup = col.get("support")
            for lv in range(col.get("num_levels") or 0):
                m_v = ms[lv] if lv < len(ms) else None
                u_v = us[lv] if lv < len(us) else None
                bf = bfs[lv] if lv < len(bfs) else None
                s_v = sup[lv] if sup and lv < len(sup) else None
                lines.append(
                    f"  {(name if lv == 0 else ''):<18}{lv:>6}"
                    f"{(f'{m_v:.4f}' if isinstance(m_v, (int, float)) else '-'):>10}"
                    f"{(f'{u_v:.4f}' if isinstance(u_v, (int, float)) else '-'):>10}"
                    f"{(f'{bf:+.2f}' if isinstance(bf, (int, float)) else '-'):>9}"
                    f"{(f'{s_v:,}' if isinstance(s_v, int) else '-'):>10}"
                )
        warns = ev.get("warnings") or []
        for w in warns:
            lines.append(f"  ! {w}")
        if not warns:
            lines.append("  (no identifiability warnings)")

    # ---- quality profile + serve-time drift ------------------------------
    profiles = [e for e in events if e.get("type") == "quality_profile"]
    for ev in profiles:
        # torn/old records may miss fields: render 0/empty, never crash
        lines.append("")
        lines.append(
            f"quality profile: {len(ev.get('columns') or [])} column(s), "
            f"{ev.get('n_pairs') or 0:,} training pair(s) over "
            f"{ev.get('n_rows') or 0:,} row(s), "
            f"{ev.get('bins') or 0} score bins"
        )
        nulls = ev.get("null_rates") or {}
        if nulls:
            lines.append(
                "  null rates: "
                + ", ".join(f"{k}={v or 0:.4f}" for k, v in sorted(nulls.items()))
            )
    drift_windows = [e for e in events if e.get("type") == "drift_window"]
    drift_alerts = [e for e in events
                    if e.get("type") in ("drift_alert", "drift_clear")]
    if drift_windows or drift_alerts:
        lines.append("")
        lines.append(
            f"drift: {len(drift_windows)} window report(s), "
            f"{sum(1 for e in drift_alerts if e['type'] == 'drift_alert')} "
            "alert(s)"
        )
        if drift_windows:
            last = drift_windows[-1]
            lines.append(
                f"  last window ({last.get('window_s') or 0}s): "
                f"queries={last.get('queries') or 0:,} "
                f"pairs={last.get('pairs') or 0:,} "
                f"max_psi={last.get('max_psi') or 0}"
            )
            channels = last.get("channels") or {}
            if channels:
                lines.append(
                    "  psi: " + ", ".join(
                        f"{ch}={v if v is not None else '-'}"
                        for ch, v in sorted(channels.items())
                    )
                )
        for ev in drift_alerts:
            if ev["type"] == "drift_alert":
                for a in ev.get("alerts") or []:
                    if "short_yield" in a:
                        # a yield of exactly 0.0 is the headline value of
                        # a collapse alert: or-0 only the MISSING fields
                        lines.append(
                            f"  ALERT {a.get('channel') or '?'}: "
                            f"yield {_or0(a.get('short_yield'))}/"
                            f"{_or0(a.get('long_yield'))} over "
                            f"{a.get('window_s') or 0}s/"
                            f"{a.get('long_window_s') or 0}s "
                            f"(collapse factor {a.get('threshold') or 0})"
                        )
                        continue
                    lines.append(
                        f"  ALERT {a.get('channel') or '?'}: "
                        f"psi {a.get('short_psi') or 0}/"
                        f"{a.get('long_psi') or 0} over "
                        f"{a.get('window_s') or 0}s/"
                        f"{a.get('long_window_s') or 0}s "
                        f"(threshold {a.get('threshold') or 0})"
                    )
            else:
                lines.append("  alert cleared")

    # ---- kernel performance watch (obs/kernelwatch.py) -------------------
    perf_windows = [e for e in events if e.get("type") == "perf_window"]
    perf_alerts = [e for e in events
                   if e.get("type") in ("perf_alert", "perf_clear")]
    if perf_windows or perf_alerts:
        lines.append("")
        lines.append(
            f"kernel perf: {len(perf_windows)} window report(s), "
            f"{sum(1 for e in perf_alerts if e['type'] == 'perf_alert')} "
            "alert(s)"
        )
        if perf_windows:
            last = perf_windows[-1]
            lines.append(
                f"  last window ({last.get('window_s') or 0}s), "
                f"per phase:"
            )
            lines.append(f"  {'phase':<12}{'anchor ms':>11}{'p95 ms':>10}"
                         f"{'ewma ms':>10}{'n':>6}")
            for name, st in sorted((last.get("phases") or {}).items()):
                st = st or {}
                lines.append(
                    f"  {name:<12}{_or0(st.get('anchor_ms')):>11}"
                    f"{_or0(st.get('p95_ms')):>10}"
                    f"{_or0(st.get('ewma_ms')):>10}"
                    f"{st.get('n') or 0:>6}"
                )
        for ev in perf_alerts:
            if ev["type"] == "perf_clear":
                lines.append("  alert cleared")
                continue
            for a in ev.get("alerts") or []:
                # a p95 of exactly 0.0 cannot fire the ratio rule, so
                # or-0 here only papers over MISSING fields (torn record)
                lines.append(
                    f"  ALERT {a.get('phase') or '?'}: "
                    f"p95 {_or0(a.get('short_p95_ms'))}/"
                    f"{_or0(a.get('long_p95_ms'))}ms vs anchor "
                    f"{_or0(a.get('anchor_ms'))}ms "
                    f"({_or0(a.get('ratio'))}x >= "
                    f"{a.get('threshold') or 0}x) over "
                    f"{a.get('window_s') or 0}s/"
                    f"{a.get('long_window_s') or 0}s"
                )

    # ---- wire tier (serve/wire.py + serve/remote.py) ---------------------
    wire_types = ("wire_connect", "wire_disconnect", "wire_reconnect",
                  "wire_shed", "wire_partition_heal")
    wire = [e for e in events if e.get("type") in wire_types]
    if wire:
        counts = {t: sum(1 for e in wire if e["type"] == t)
                  for t in wire_types}
        lines.append("")
        lines.append(
            f"wire tier: {counts['wire_connect']} connect(s), "
            f"{counts['wire_disconnect']} disconnect(s), "
            f"{counts['wire_reconnect']} reconnect(s), "
            f"{counts['wire_shed']} shed burst(s), "
            f"{counts['wire_partition_heal']} partition heal(s)"
        )
        # sheds aggregate per (replica, reason); n is or-0 against torn
        # records (a shed burst with n genuinely 0 is never emitted)
        shed_by: dict = {}
        for ev in wire:
            if ev["type"] == "wire_shed":
                key = (ev.get("replica") or "?", ev.get("reason") or "?")
                shed_by[key] = shed_by.get(key, 0) + (_or0(ev.get("n")) or 0)
        for (replica, reason), n in sorted(shed_by.items()):
            lines.append(f"  shed {replica}: {n} x {reason}")
        for ev in wire:
            if ev["type"] == "wire_reconnect":
                lines.append(
                    f"  reconnect {ev.get('replica') or '?'}: "
                    f"{_or0(ev.get('attempts'))} attempt(s), "
                    f"{_or0(ev.get('downtime_s'))}s down"
                )
            elif ev["type"] == "wire_partition_heal":
                lines.append(
                    f"  partition heal {ev.get('server') or '?'}: "
                    f"{_or0(ev.get('duration_s'))}s, "
                    f"{_or0(ev.get('dropped'))} connection(s) dropped"
                )

    # ---- fleet observability (obs/fleet.py) ------------------------------
    fleet_types = ("fleet_scrape", "fleet_net_alert", "fleet_net_clear",
                   "incident_bundle")
    fleet = [e for e in events if e.get("type") in fleet_types]
    stitched = [e for e in events
                if e.get("type") == "request_trace"
                and e.get("remote_span") is not None]
    if fleet or stitched:
        counts = {t: sum(1 for e in fleet if e["type"] == t)
                  for t in fleet_types}
        lines.append("")
        lines.append(
            f"fleet: {counts['fleet_scrape']} federation scrape(s), "
            f"{counts['fleet_net_alert']} network alert(s), "
            f"{counts['incident_bundle']} incident bundle(s), "
            f"{len(stitched)} stitched trace(s)"
        )
        scrapes = [e for e in fleet if e["type"] == "fleet_scrape"]
        if scrapes:
            last = scrapes[-1]
            # torn-record or-0: hosts/served genuinely 0 only on an
            # unreachable fleet, which IS what the line should say
            lines.append(
                f"  last scrape: {_or0(last.get('hosts'))} host(s), "
                f"served={_or0(last.get('served'))}"
                + (f", unreachable: {', '.join(last['unreachable'])}"
                   if last.get("unreachable") else "")
            )
        for ev in fleet:
            if ev["type"] == "fleet_net_alert":
                for a in ev.get("alerts") or []:
                    lines.append(
                        f"  NET ALERT {ev.get('replica') or '?'}: "
                        f"p95 {_or0(a.get('short_p95_ms'))}/"
                        f"{_or0(a.get('long_p95_ms'))}ms vs anchor "
                        f"{_or0(a.get('anchor_ms'))}ms "
                        f"({_or0(a.get('ratio'))}x)"
                    )
            elif ev["type"] == "fleet_net_clear":
                lines.append(
                    f"  net alert cleared ({ev.get('replica') or '?'})"
                )
            elif ev["type"] == "incident_bundle":
                lines.append(
                    f"  BUNDLE [{ev.get('trigger') or '?'}] "
                    f"{ev.get('path') or '?'}: "
                    f"{len(ev.get('files') or [])} file(s)"
                    + (f", unreachable: {', '.join(ev['unreachable'])}"
                       if ev.get("unreachable") else "")
                )
        if stitched:
            offsets = [
                e.get("clock_offset_s") for e in stitched
                if isinstance(e.get("clock_offset_s"), (int, float))
            ]
            wires = [e.get("wire_ms") or {} for e in stitched]
            nets = sorted(
                float(w.get("network") or 0.0) for w in wires
            )
            lines.append(
                f"  stitched wire overhead: network p50="
                f"{_quantile(nets, 0.5):.3f}ms "
                f"p99={_quantile(nets, 0.99):.3f}ms"
                + (f", clock offset ~{offsets[-1]:+.4f}s"
                   if offsets else "")
            )

    # ---- concurrency audit (analysis/lockwatch.py + thread-smoke) --------
    inversions = [e for e in events if e.get("type") == "lock_inversion"]
    audits = [e for e in events if e.get("type") == "thread_audit"]
    if inversions or audits:
        lines.append("")
        lines.append(
            f"concurrency: {len(inversions)} lock inversion(s), "
            f"{len(audits)} thread audit(s)"
        )
        for ev in inversions:
            cycle = ev.get("cycle") or []
            lines.append(
                f"  INVERSION {' -> '.join(str(c) for c in cycle) or '?'} "
                f"at {ev.get('site') or '?'} "
                f"(thread {ev.get('thread') or '?'})"
            )
        for ev in audits:
            lines.append(
                f"  audit: {_or0(ev.get('classes'))} class(es), "
                f"{_or0(ev.get('findings'))} finding(s), "
                f"{_or0(ev.get('observed_edges'))} observed edge(s), "
                f"{_or0(ev.get('inversions'))} inversion(s), "
                f"{_or0(ev.get('cycles'))} union cycle(s)"
            )

    # ---- resilience events ----------------------------------------------
    # serve-tier events (health transitions, breaker state changes, index
    # hot-swaps, worker restarts, brown-out boundaries, drift alerts)
    # belong in the same chronological incident timeline as the
    # training-side ones
    res = [e for e in events
           if e.get("type") in ("retry", "fault", "checkpoint", "degradation",
                                "health", "breaker", "index_swap",
                                "serve_worker_restart", "brownout_end",
                                "drift_alert", "drift_clear")]
    if res:
        lines.append("")
        lines.append(f"resilience events: {len(res)}")
        for ev in res[:20]:
            detail = {k: v for k, v in ev.items()
                      if k not in ("v", "type", "ts", "mono", "run_id",
                                   "process_index", "process_count")}
            lines.append(f"  [{ev['type']}] "
                         + ", ".join(f"{k}={v}" for k, v in detail.items()))
        if len(res) > 20:
            lines.append(f"  ... {len(res) - 20} more")

    # ---- metrics (last snapshot wins) ------------------------------------
    metrics = [e for e in events if e.get("type") == "metrics"]
    if metrics:
        snap = metrics[-1]
        lines.append("")
        lines.append("metrics (final snapshot):")
        for kind in ("counters", "gauges"):
            for name, value in sorted((snap.get(kind) or {}).items()):
                if isinstance(value, float):
                    value = round(value, 6)
                lines.append(f"  {name} = {value}")
        for name, h in sorted((snap.get("histograms") or {}).items()):
            lines.append(
                f"  {name}: n={h.get('count')} sum={_fmt_s(h.get('sum'))} "
                f"min={_fmt_s(h.get('min'))} max={_fmt_s(h.get('max'))}"
            )
        for name in sorted(snap.get("records") or {}):
            lines.append(f"  record: {name}")

    # ---- memory ----------------------------------------------------------
    mem = [e for e in events if e.get("type") == "memory"]
    if mem:
        lines.append("")
        lines.append("device memory (peak bytes_in_use per stage):")
        for ev in mem:
            peaks = [d.get("peak_bytes_in_use") or d.get("bytes_in_use") or 0
                     for d in ev.get("devices") or []]
            if peaks:
                lines.append(f"  {ev.get('stage')}: {max(peaks):,}")
    return "\n".join(lines)


def attribute_events(events: list[dict]) -> str:
    """Tail-latency attribution over a record's ``request_trace`` events:
    decompose the delivered p99 into the phase partition — for the
    requests at and above the p99 wall, where did the time actually go.

    The report's invariant: per request,
    the phases sum to the measured wall latency within 5%."""
    delivered = [
        e for e in events
        if e.get("type") == "request_trace"
        and e.get("outcome") == "delivered"
    ]
    if not delivered:
        return "(no delivered request traces in this record)"
    walls = sorted(float(e.get("wall_ms") or 0.0) for e in delivered)
    p50 = _quantile(walls, 0.50)
    p95 = _quantile(walls, 0.95)
    p99 = _quantile(walls, 0.99)
    tail = [
        e for e in delivered if float(e.get("wall_ms") or 0.0) >= p99
    ] or delivered
    lines = [
        f"tail-latency attribution over {len(delivered)} delivered "
        f"request trace(s)",
        f"wall ms: p50={p50:.2f}  p95={p95:.2f}  p99={p99:.2f}  "
        f"(tail set: {len(tail)} request(s) at/above p99)",
        "",
        f"{'phase':<12}{'p50 ms':>10}{'p99 ms':>10}{'tail mean':>12}"
        f"{'tail share':>12}",
    ]
    tail_wall = sum(float(e.get("wall_ms") or 0.0) for e in tail) / len(tail)
    covered = 0.0
    for phase in PHASES:
        vals = sorted(
            float((e.get("phases_ms") or {}).get(phase) or 0.0)
            for e in delivered
        )
        tail_mean = sum(
            float((e.get("phases_ms") or {}).get(phase) or 0.0)
            for e in tail
        ) / len(tail)
        share = (tail_mean / tail_wall) if tail_wall else 0.0
        covered += share
        lines.append(
            f"{phase:<12}{_quantile(vals, 0.5):>10.3f}"
            f"{_quantile(vals, 0.99):>10.3f}{tail_mean:>12.3f}"
            f"{share:>11.1%}"
        )
    lines.append(
        f"{'(sum)':<12}{'':>10}{'':>10}{'':>12}{covered:>11.1%}"
    )
    # stitched remote attempts (obs/fleet.py): the wire-overhead
    # decomposition of every delivered trace that carries a grafted
    # remote span — where a remote round trip actually went
    remote = [e for e in delivered if e.get("wire_ms")]
    if remote:
        lines.append("")
        lines.append(
            f"wire decomposition over {len(remote)} stitched remote "
            "attempt(s), mean ms per hop:"
        )
        hops = ("serialize", "network", "server_queue",
                "server_execute", "deserialize")
        for hop in hops:
            vals = [
                float((e.get("wire_ms") or {}).get(hop) or 0.0)
                for e in remote
            ]
            lines.append(
                f"  {hop:<16}{sum(vals) / len(vals):>10.3f}"
            )
    shed = [
        e for e in events
        if e.get("type") == "request_trace" and e.get("outcome") == "shed"
    ]
    if shed:
        reasons: dict[str, int] = {}
        for e in shed:
            rs = e.get("reason") or "?"
            reasons[rs] = reasons.get(rs, 0) + 1
        lines.append("")
        lines.append(
            "shed (excluded from attribution): "
            + ", ".join(f"{k}={v}" for k, v in sorted(reasons.items()))
        )
    return "\n".join(lines)


def drift_events_report(events: list[dict]) -> str:
    """``obs drift``: the drift observatory's report over one telemetry
    record — per replica, the rolling-window PSI trajectory (first/last
    per channel), serve-side OOV/approx rates and the alert timeline.
    Torn records render 0/-, never crash (the summarize contract)."""
    profiles = [e for e in events if e.get("type") == "quality_profile"]
    windows = [e for e in events if e.get("type") == "drift_window"]
    alerts = [e for e in events
              if e.get("type") in ("drift_alert", "drift_clear")]
    if not (profiles or windows or alerts):
        return "(no drift events in this record — quality_profile off, " \
               "or the index carries no reference profile)"
    lines: list[str] = []
    for ev in profiles:
        lines.append(
            f"reference profile: {len(ev.get('columns') or [])} column(s), "
            f"{ev.get('n_pairs') or 0:,} training pair(s), "
            f"{ev.get('bins') or 0} score bins"
        )
    replicas = sorted({e.get("replica") or "?" for e in windows})
    for rep in replicas:
        wins = [e for e in windows if (e.get("replica") or "?") == rep]
        lines.append("")
        lines.append(f"replica {rep}: {len(wins)} window report(s)")
        channels = sorted({
            ch for e in wins for ch in (e.get("channels") or {})
        })
        lines.append(f"  {'channel':<24}{'first psi':>12}{'last psi':>12}")
        for ch in channels:
            series = [
                (e.get("channels") or {}).get(ch)
                for e in wins
                if (e.get("channels") or {}).get(ch) is not None
            ]
            first = series[0] if series else None
            last = series[-1] if series else None
            lines.append(
                f"  {ch:<24}"
                f"{(f'{first:.4f}' if isinstance(first, (int, float)) else '-'):>12}"
                f"{(f'{last:.4f}' if isinstance(last, (int, float)) else '-'):>12}"
            )
        last = wins[-1]
        lines.append(
            f"  last window: queries={last.get('queries') or 0:,} "
            f"pairs={last.get('pairs') or 0:,} "
            f"oov_rate={last.get('oov_rate') if last.get('oov_rate') is not None else '-'} "
            f"approx_rate={last.get('approx_rate') if last.get('approx_rate') is not None else '-'}"
        )
    if alerts:
        lines.append("")
        lines.append(f"alert timeline ({len(alerts)} transition(s)):")
        for ev in alerts:
            rep = ev.get("replica") or "?"
            if ev.get("type") == "drift_clear":
                lines.append(f"  [{rep}] cleared")
                continue
            for a in ev.get("alerts") or []:
                if "short_yield" in a:
                    lines.append(
                        f"  [{rep}] ALERT {a.get('channel') or '?'}: "
                        f"yield {_or0(a.get('short_yield'))}/"
                        f"{_or0(a.get('long_yield'))} "
                        f"(collapse factor {a.get('threshold') or 0}) over "
                        f"{a.get('window_s') or 0}s/"
                        f"{a.get('long_window_s') or 0}s"
                    )
                    continue
                lines.append(
                    f"  [{rep}] ALERT {a.get('channel') or '?'}: "
                    f"psi {a.get('short_psi') or 0}/{a.get('long_psi') or 0} "
                    f">= {a.get('threshold') or 0} over "
                    f"{a.get('window_s') or 0}s/{a.get('long_window_s') or 0}s"
                )
    elif windows:
        lines.append("")
        lines.append("no drift alerts fired")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# bench-report: normalise the heterogeneous BENCH_r*.json history into one
# per-metric, per-tier trajectory table and flag cross-round deltas
# ---------------------------------------------------------------------------

#: metric-name fragments whose direction is known (regression = value went
#: the wrong way); anything else flags as a neutral CHANGE
_LOWER_IS_BETTER = (
    "seconds", "_ms", "latency", "overhead", "warmup", "cold",
    "p50", "p95", "p99", "compiles", "recompile", "shed",
)
_HIGHER_IS_BETTER = (
    # "recall" also covers the recall-per-budget family (rounds 11/14:
    # recall_at_budget, recall_at_budget_tf) — pinned by the direction
    # test beside the bench-report tests
    "per_sec", "qps", "recall", "hit_rate", "throughput", "speedup",
    "pairs_per",
)


def _metric_direction(name: str) -> str | None:
    low = name.lower()
    if any(f in low for f in _HIGHER_IS_BETTER):
        return "higher"
    if any(f in low for f in _LOWER_IS_BETTER):
        return "lower"
    return None


def _bench_round(path: str, payload: dict) -> int | None:
    import re

    n = payload.get("n")
    if isinstance(n, int):
        return n
    m = re.search(r"BENCH_r(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else None


def _numeric_items(d: dict):
    for k, v in d.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        yield k, float(v)


def normalise_bench_files(paths: list) -> tuple[list, list]:
    """Flatten heterogeneous BENCH json artifacts into
    ``(rows, failures)``. Every artifact shape in the history is handled:
    the command-run wrapper (``{"n", "cmd", "rc", "tail", "parsed"}`` — rounds
    whose ``parsed`` is null land in ``failures`` so the trajectory still
    shows them) and the raw one-line result objects. Each row is
    ``{"metric", "round", "tier", "value", "file"}``; the headline
    ``value`` key is renamed to its declared ``metric``, and nested
    ``tiers_detail`` blocks (the cold-start bench's per-tier sweep) emit
    rows labelled with the sub-tier name."""
    rows: list[dict] = []
    failures: list[dict] = []
    for path in paths:
        try:
            with open(path, encoding="utf-8") as fh:
                text = fh.read()
            # two shapes on disk: one (pretty-printed) JSON document, or
            # one JSON object per line — there the LAST line wins (bench
            # prints a partial headline first, then the full result)
            try:
                payload = json.loads(text)
            except ValueError:
                payload = None
                for line in text.splitlines():
                    line = line.strip()
                    if line.startswith("{"):
                        try:
                            payload = json.loads(line)
                        except ValueError:
                            continue
        except OSError as e:
            failures.append({"file": os.path.basename(path),
                             "reason": str(e)})
            continue
        if not isinstance(payload, dict):
            failures.append({"file": os.path.basename(path),
                             "reason": "no JSON object found"})
            continue
        rnd = _bench_round(path, payload)
        if "cmd" in payload and "rc" in payload:  # command-run wrapper
            parsed = payload.get("parsed")
            if not isinstance(parsed, dict):
                failures.append({
                    "file": os.path.basename(path),
                    "round": rnd,
                    "reason": f"no parsed result (rc {payload.get('rc')})",
                })
                continue
            payload = parsed
        base = os.path.basename(path)
        tier = str(payload.get("tier") or "?")
        headline = payload.get("metric")

        def emit(name: str, value: float, tier_label: str) -> None:
            rows.append({
                "metric": name, "round": rnd, "tier": tier_label,
                "value": value, "file": base,
            })

        for key, value in _numeric_items(payload):
            if key in ("n", "rc"):
                continue
            name = headline if key == "value" and headline else key
            emit(str(name), value, tier)
        detail = payload.get("tiers_detail")
        if isinstance(detail, dict):
            for sub, block in detail.items():
                if isinstance(block, dict):
                    for key, value in _numeric_items(block):
                        emit(key, value, str(sub))
    return rows, failures


def bench_report_text(paths: list, threshold: float = 0.3) -> str:
    """The trajectory report: one line per metric with its (round, tier)
    point series, plus a flag section listing every consecutive delta
    past ``threshold`` — compared across rounds within one tier, and
    across tiers within one round (a tier sweep like the cold-start
    bench's nocache->cache_warm->aot IS a trajectory) — labelled
    REGRESSION / IMPROVEMENT where the metric name's direction is known,
    CHANGE otherwise."""
    rows, failures = normalise_bench_files(paths)
    series: dict[str, list] = {}
    for row in rows:
        series.setdefault(row["metric"], []).append(row)
    for pts in series.values():
        pts.sort(key=lambda r: (r["round"] if r["round"] is not None else 0))
    lines = [
        f"bench trajectory: {len(paths)} artifact(s), "
        f"{len(series)} metric(s)"
    ]
    for f in failures:
        rnd = f.get("round")
        lines.append(
            f"  r{rnd:02d}: no result ({f['reason']}) [{f['file']}]"
            if rnd is not None
            else f"  {f.get('file')}: {f['reason']}"
        )
    lines.append("")
    width = max((len(m) for m in series), default=10)
    for metric in sorted(series):
        pts = series[metric]
        shown = pts if len(pts) <= 6 else pts[:3] + [None] + pts[-2:]
        parts = []
        for p in shown:
            if p is None:
                parts.append("..")
                continue
            tier = f"[{p['tier']}]" if p["tier"] != "?" else ""
            parts.append(f"{_fmt_round(p['round'])}{tier}={_fmt_num(p['value'])}")
        lines.append(f"{metric:<{width}}  " + " -> ".join(parts))
    flags = []
    for metric in sorted(series):
        pts = series[metric]
        direction = _metric_direction(metric)
        for a, b in zip(pts, pts[1:]):
            # round-less artifacts (no "n", filename without r<digits>)
            # only compare within one tier — "same unknown round" is not
            # a regime match
            same_round = (
                a["round"] is not None and a["round"] == b["round"]
            )
            same_tier = a["tier"] == b["tier"]
            if not (same_round or same_tier):
                continue  # different benchmark regimes: not comparable
            if a["value"] == 0:
                continue
            rel = (b["value"] - a["value"]) / abs(a["value"])
            if abs(rel) < threshold:
                continue
            if direction is None:
                label = "CHANGE"
            elif (rel > 0) == (direction == "higher"):
                label = "IMPROVEMENT"
            else:
                label = "REGRESSION"
            flags.append(
                f"  {label:<12}{metric}: {_fmt_num(a['value'])} "
                f"({_fmt_round(a['round'])}, {a['tier']}) -> "
                f"{_fmt_num(b['value'])} ({_fmt_round(b['round'])}, "
                f"{b['tier']}) [{rel:+.1%}]"
            )
    lines.append("")
    if flags:
        lines.append(f"flags (|delta| >= {threshold:.0%}):")
        lines.extend(flags)
    else:
        lines.append(f"no deltas past {threshold:.0%}")
    return "\n".join(lines)


def _fmt_round(rnd) -> str:
    return f"r{rnd:02d}" if rnd is not None else "r?"


def _fmt_num(v: float) -> str:
    if v == int(v) and abs(v) < 1e12:
        return str(int(v))
    return f"{v:.3f}" if abs(v) < 1000 else f"{v:.1f}"


def _default_bench_paths(directory: str) -> list:
    import glob as _glob

    return sorted(_glob.glob(os.path.join(directory, "BENCH_*.json")))


# ---------------------------------------------------------------------------
# serve-dash: poll the Prometheus exposition endpoint, render a terminal view
# ---------------------------------------------------------------------------


def parse_prometheus_text(text: str) -> list[tuple[str, dict, float]]:
    """Parse Prometheus text exposition into (name, labels, value) rows
    (enough for the dashboard; not a full openmetrics parser)."""
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            series, value = line.rsplit(" ", 1)
            labels: dict = {}
            name = series
            if "{" in series:
                name, rest = series.split("{", 1)
                for part in rest.rstrip("}").split(","):
                    if not part:
                        continue
                    k, v = part.split("=", 1)
                    labels[k] = v.strip('"')
            rows.append((name, labels, float(value)))
        except ValueError:
            continue
    return rows


def render_dash(rows: list[tuple[str, dict, float]]) -> str:
    """One terminal frame of the serve dashboard from parsed samples."""

    def get(name, **labels):
        for n, ls, v in rows:
            if n == name and all(ls.get(k) == str(v2)
                                 for k, v2 in labels.items()):
                return v
        return None

    def fmt(v, spec="{:.0f}", missing="-"):
        return spec.format(v) if v is not None else missing

    replicas = sorted(
        {ls.get("replica") for n, ls, _ in rows
         if n == "splink_serve_served_total" and ls.get("replica")}
    )
    lines = [f"splink_tpu serve dashboard  ({time.strftime('%H:%M:%S')})"]
    for rep in replicas:
        health = get("splink_serve_health_rank", replica=rep)
        state = {0: "healthy", 1: "degraded", 2: "broken"}.get(
            int(health) if health is not None else -1, "?"
        )
        breaker = get("splink_serve_breaker_open", replica=rep)
        lines.append("")
        lines.append(
            f"replica {rep}: {state}"
            + ("  [BREAKER OPEN]" if breaker else "")
        )
        lines.append(
            f"  served={fmt(get('splink_serve_served_total', replica=rep))}"
            f"  shed={fmt(get('splink_serve_shed_total', replica=rep))}"
            f"  q/s={fmt(get('splink_serve_queries_per_sec', replica=rep), '{:.1f}')}"
            f"  queue={fmt(get('splink_serve_queue_fill', replica=rep), '{:.0%}')}"
            f"  gen={fmt(get('splink_serve_index_generation', replica=rep))}"
        )
        lines.append(
            "  latency ms: "
            + "  ".join(
                f"p{q}={fmt(get('splink_serve_latency_ms', replica=rep, quantile=f'p{q}'), '{:.2f}')}"
                for q in (50, 95, 99)
            )
        )
        phases = sorted({
            ls.get("phase") for n, ls, _ in rows
            if n == "splink_serve_phase_ms" and ls.get("replica") == rep
        })
        if phases:
            lines.append("  phase p99 ms: " + "  ".join(
                f"{p}={fmt(get('splink_serve_phase_ms', replica=rep, phase=p, quantile='p99'), '{:.2f}')}"
                for p in PHASES if p in phases
            ))
        windows = sorted(
            {ls.get("window_s") for n, ls, _ in rows
             if n == "splink_serve_slo_burn_rate"
             and ls.get("replica") == rep},
            key=lambda w: int(w) if w and w.isdigit() else 0,
        )
        if windows:
            lines.append("  slo burn: " + "  ".join(
                f"{w}s={fmt(get('splink_serve_slo_burn_rate', replica=rep, window_s=w), '{:.2f}')}"
                for w in windows
            ))
        has_ref = get("splink_serve_drift_reference", replica=rep)
        if has_ref:
            drift_channels = sorted({
                ls.get("channel") for n, ls, _ in rows
                if n == "splink_serve_drift_psi"
                and ls.get("replica") == rep
            })
            alert = get("splink_serve_drift_alert", replica=rep)
            lines.append(
                "  drift psi: "
                + ("  ".join(
                    f"{ch}={fmt(get('splink_serve_drift_psi', replica=rep, channel=ch), '{:.3f}')}"
                    for ch in drift_channels
                ) if drift_channels else "(no traffic in window)")
                + ("  [DRIFT ALERT]" if alert else "")
            )
    if not replicas:
        lines.append("(no splink_serve_* series at this endpoint)")
    return "\n".join(lines)


def render_fleet_dash(rows: list[tuple[str, dict, float]]) -> str:
    """One terminal frame of the fleet dashboard from the federation
    endpoint's merged ``splink_fleet_*`` samples (obs/fleet.py)."""

    def get(name, **labels):
        for n, ls, v in rows:
            if n == name and all(ls.get(k) == str(v2)
                                 for k, v2 in labels.items()):
                return v
        return None

    def fmt(v, spec="{:.0f}", missing="-"):
        return spec.format(v) if v is not None else missing

    hosts = get("splink_fleet_hosts")
    lines = [
        f"splink_tpu fleet dashboard  ({time.strftime('%H:%M:%S')})",
        "",
        f"federated hosts: {fmt(hosts)}",
    ]
    counters = sorted({
        n for n, _ls, _v in rows
        if n.startswith("splink_fleet_") and n.endswith("_total")
        and not n.startswith("splink_fleet_slo_")
    })
    if counters:
        lines.append("  " + "  ".join(
            f"{n[len('splink_fleet_'):-len('_total')]}={fmt(get(n))}"
            for n in counters
        ))
    good, bad = get("splink_fleet_slo_good_total"), get("splink_fleet_slo_bad_total")
    if good is not None or bad is not None:
        windows = sorted(
            {ls.get("window_s") for n, ls, _ in rows
             if n == "splink_fleet_slo_burn_rate"},
            key=lambda w: int(w) if w and w.isdigit() else 0,
        )
        lines.append(
            f"  slo: good={fmt(good)} bad={fmt(bad)}"
            + ("  burn: " + "  ".join(
                f"{w}s={fmt(get('splink_fleet_slo_burn_rate', window_s=w), '{:.2f}')}"
                for w in windows
            ) if windows else "")
        )
    replicas = sorted({
        ls.get("replica") for n, ls, _ in rows
        if n == "splink_fleet_host_health_rank" and ls.get("replica")
    })
    for rep in replicas:
        rank = get("splink_fleet_host_health_rank", replica=rep)
        state = {0: "healthy", 1: "degraded", 2: "broken"}.get(
            int(rank) if rank is not None else -1, "?"
        )
        lines.append(f"  host {rep}: {state}")
    phases = sorted({
        ls.get("phase") for n, ls, _ in rows
        if n == "splink_fleet_phase_seconds_count" and ls.get("phase")
    })
    if phases:
        lines.append("")
        lines.append(f"  {'phase':<16}{'count':>10}{'mean ms':>10}")
        for p in phases:
            n = get("splink_fleet_phase_seconds_count", phase=p)
            s = get("splink_fleet_phase_seconds_sum", phase=p)
            mean = (s / n * 1e3) if n else None
            lines.append(
                f"  {p:<16}{fmt(n):>10}{fmt(mean, '{:.3f}'):>10}"
            )
    if hosts is None:
        lines.append("(no splink_fleet_* series at this endpoint)")
    return "\n".join(lines)


def serve_dash(url: str, interval: float, count: int | None,
               renderer=render_dash) -> int:
    """Poll ``url`` and render frames until interrupted (or ``count``
    frames, for scripting/tests). ``renderer`` picks the view —
    :func:`render_dash` (one host) or :func:`render_fleet_dash` (the
    federation endpoint)."""
    import urllib.request

    frames = 0
    while True:
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                text = resp.read().decode("utf-8", "replace")
            frame = renderer(parse_prometheus_text(text))
        except Exception as e:  # noqa: BLE001 - a dead endpoint is a frame, not a crash
            frame = f"splink_tpu serve dashboard\n\n(endpoint {url}: {e})"
        print("\x1b[2J\x1b[H" + frame if count is None else frame,
              flush=True)
        frames += 1
        if count is not None and frames >= count:
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:  # pragma: no cover - interactive exit
            return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m splink_tpu_torch.obs",
        description="Inspect splink_tpu_torch telemetry records (JSONL)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p_sum = sub.add_parser("summarize", help="per-stage/per-iteration report")
    p_sum.add_argument("path", help="telemetry JSONL file")
    p_exp = sub.add_parser(
        "export-trace",
        help="convert to Chrome trace-event JSON (ui.perfetto.dev)",
    )
    p_exp.add_argument("path", help="telemetry JSONL file")
    p_exp.add_argument(
        "-o", "--output", default=None,
        help="output path (default: <path>.trace.json; '-' for stdout)",
    )
    p_att = sub.add_parser(
        "attribute",
        help="decompose serve tail latency into request-trace phases",
    )
    p_att.add_argument("path", help="telemetry JSONL file")
    p_drift = sub.add_parser(
        "drift",
        help="drift-observatory report: PSI trajectory vs the training "
             "reference + alert timeline",
    )
    p_drift.add_argument("path", help="telemetry JSONL file")
    p_bench = sub.add_parser(
        "bench-report",
        help="normalise the BENCH_r*.json history into one per-metric, "
             "per-tier trajectory table and flag cross-round deltas",
    )
    p_bench.add_argument(
        "paths", nargs="*",
        help="BENCH json files (default: BENCH_*.json in --dir)",
    )
    p_bench.add_argument(
        "--dir", default=".",
        help="directory scanned for BENCH_*.json when no paths are given",
    )
    p_bench.add_argument(
        "--threshold", type=float, default=0.3,
        help="relative delta that flags a cross-round change (default 0.3)",
    )
    p_dash = sub.add_parser(
        "serve-dash",
        help="live terminal dashboard over a service's Prometheus endpoint",
    )
    p_dash.add_argument(
        "--url", default="http://127.0.0.1:9464/metrics",
        help="exposition endpoint (obs_exposition_port setting)",
    )
    p_dash.add_argument("--interval", type=float, default=1.0)
    p_dash.add_argument(
        "--count", type=int, default=None,
        help="render N frames then exit (default: until interrupted)",
    )
    p_fleet = sub.add_parser(
        "fleet-dash",
        help="multi-host dashboard over the federation /metrics endpoint "
             "(obs/fleet.py FleetAggregator)",
    )
    p_fleet.add_argument(
        "--url", default="http://127.0.0.1:9464/metrics",
        help="federation exposition endpoint",
    )
    p_fleet.add_argument("--interval", type=float, default=1.0)
    p_fleet.add_argument(
        "--count", type=int, default=None,
        help="render N frames then exit (default: until interrupted)",
    )
    args = parser.parse_args(argv)

    if args.command == "serve-dash":
        return serve_dash(args.url, args.interval, args.count)
    if args.command == "fleet-dash":
        return serve_dash(args.url, args.interval, args.count,
                          renderer=render_fleet_dash)

    if args.command == "bench-report":
        paths = args.paths or _default_bench_paths(args.dir)
        if not paths:
            print(f"error: no BENCH_*.json under {args.dir}",
                  file=sys.stderr)
            return 2
        print(bench_report_text(paths, args.threshold))
        return 0

    try:
        events = read_events(args.path)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.command == "summarize":
        print(summarize_events(events))
        return 0
    if args.command == "attribute":
        print(attribute_events(events))
        return 0
    if args.command == "drift":
        print(drift_events_report(events))
        return 0

    trace = chrome_trace_from_events(events)
    out = args.output or (args.path + ".trace.json")
    if out == "-":
        json.dump(trace, sys.stdout)
        print()
    else:
        with open(out, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        print(f"wrote {len(trace['traceEvents'])} trace events to {out}")
    return 0
