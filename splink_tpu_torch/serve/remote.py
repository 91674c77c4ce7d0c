"""The port's copy of splink_tpu/serve/remote.py.

RemoteReplica: a wire-protocol client in the replica duck-type.

The router half of the multi-host story (:mod:`.wire` is the server
half): :class:`RemoteReplica` speaks the length-prefixed envelope
protocol to a :class:`~.wire.WireServer` on another host and exposes the
exact ``submit / health_state / latency_summary`` shape the
:class:`~.router.ReplicaRouter` routes, hedges and fails over across —
pinned by the :class:`~.router.Replica` Protocol, so a local
:class:`~.service.LinkageService` and a remote host are interchangeable
list entries in one router.

The robustness contract, in the same never-raise style as the service:

* ``submit`` NEVER raises and its future ALWAYS resolves — with a match
  result, or a shed carrying a machine-readable reason (``closed`` /
  ``breaker_open`` / ``remote_unreachable`` / ``connection_lost`` /
  ``deadline`` / ``timeout`` / any server-side shed reason verbatim).
* **Connection loss** resolves every in-flight future as a
  ``connection_lost`` shed immediately (one ``wire_shed`` event counts
  them) — a dead socket must cost the router one failover, never a hang.
* **Reconnect** runs in the background with the bounded exponential
  backoff of :class:`~..resilience.retry.RetryPolicy` and a liveness
  handshake (a ``health`` exchange) before a socket counts as connected —
  a partitioned host that accepts-then-drops keeps failing the handshake
  until the partition heals, at which point ``wire_reconnect`` reports
  the attempts and downtime.
* **Per-remote circuit breaker** (:class:`~.admission.CircuitBreaker`,
  the service's own breaker, unchanged): consecutive link failures open it and
  submits fail fast as ``breaker_open`` sheds; after the cooldown one
  probe request tests the link and its outcome closes or re-opens the
  breaker — composing with, not duplicating, the server-side engine
  breaker (whose trips arrive as ordinary shed results).
* **Deadlines** ride the envelope so the server sheds lapsed work, AND a
  local sweeper resolves an expired in-flight future client-side
  (``deadline``; ``timeout`` after ``request_timeout_ms`` without a
  deadline) — the guarantee holds even when the far side is wedged.
* **Health** is the piggybacked server state from the last response,
  demoted by link state (breaker open / no live connection -> broken), so
  the router ranks a sick or unreachable host down at request cadence.

Everything is stdlib: sockets + threads + the repo's own resilience
primitives. docs/serving.md#multi-host holds the deployment sketch.
"""

from __future__ import annotations

import itertools
import logging
import socket
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

from ..analysis import lockwatch

from ..obs.events import publish
from ..resilience.retry import RetryPolicy
from .admission import CircuitBreaker
from .health import BROKEN, HEALTHY, health_rank, worse
from .service import QueryResult
from .wire import (
    DEFAULT_MAX_FRAME_BYTES,
    WIRE_VERSION,
    WireError,
    encode_frame,
    read_frame,
)

logger = logging.getLogger("splink_tpu_torch")

_SWEEP_INTERVAL_S = 0.02  # deadline/timeout sweeper cadence
_LATENCY_RESERVOIR = 4096


class _Pending:
    """One in-flight request: its future (or, for a batched frame, the
    LIST of futures resolving from one reply), trace context and
    deadlines. ``t_sent`` is stamped after the frame hits the socket —
    ``t_sent - t0`` is the serialize phase of the wire decomposition."""

    __slots__ = ("fut", "trace", "t0", "deadline", "timeout_at", "t_sent")

    def __init__(self, fut, trace, deadline, timeout_at):
        self.fut = fut
        self.trace = trace
        self.t0 = time.monotonic()
        self.deadline = deadline
        self.timeout_at = timeout_at
        self.t_sent: float | None = None


class _RemoteConn:
    """One pooled connection: socket, write lock, pending map, reader,
    the handshake-negotiated peer protocol version and this connection's
    clock-offset estimate (fleet stitching).

    ``offset_s`` estimates ``t_server - t_client`` for the same instant:
    the client brackets a server timestamp between its send (``t0``) and
    receive (``t1``) stamps and assumes the stamp sits at the midpoint of
    the network round trip — error bounded by rtt/2, refined over the
    connection's lifetime by keeping the sample with the smallest
    server-time-excluded round trip."""

    __slots__ = ("sock", "wlock", "plock", "pending", "alive", "lost",
                 "reader", "peer_version", "offset_s", "offset_rtt_s")

    def __init__(self, sock: socket.socket, peer_version: int = WIRE_VERSION):
        self.sock = sock
        self.wlock = lockwatch.new_lock("_RemoteConn.wlock")
        self.plock = lockwatch.new_lock("_RemoteConn.plock")
        self.pending: dict[int, _Pending] = {}
        self.alive = True
        self.lost = False  # _conn_lost ran (exactly-once accounting)
        self.reader: threading.Thread | None = None
        self.peer_version = int(peer_version)
        self.offset_s: float | None = None
        self.offset_rtt_s = float("inf")

    def note_offset(self, t_server, t0: float, t1: float,
                    server_s: float = 0.0) -> None:
        """Fold one clock-offset sample (NTP-style midpoint estimate,
        lowest-residual-RTT sample wins). Single-writer: only this
        connection's reader thread (and the dialing thread, before the
        reader exists) calls it."""
        if t_server is None:
            return
        try:
            rtt_net = max((t1 - t0) - max(float(server_s), 0.0), 0.0)
            if rtt_net < self.offset_rtt_s:
                self.offset_rtt_s = rtt_net
                # the server stamps t_server just before sending the
                # reply: the client-clock instant it corresponds to is
                # t1 minus half the network round trip
                self.offset_s = float(t_server) - (t1 - rtt_net / 2.0)
        except (TypeError, ValueError):
            pass

    def mark_lost(self) -> bool:
        """True for the first caller only: the reader exit and a failed
        send can both observe the same death, but the sheds, the breaker
        failure and the event must count once."""
        with self.plock:
            if self.lost:
                return False
            self.lost = True
            return True

    def send(self, frame: bytes) -> None:
        with self.wlock:
            if not self.alive:
                raise BrokenPipeError("connection already closed")
            # Serializing whole-frame writes is wlock's entire job: two
            # threads interleaving partial sendall()s would corrupt the
            # stream. wlock is a leaf (never wraps another acquisition),
            # so blocking under it cannot deadlock — only queue writers.
            self.sock.sendall(frame)  # threadlint: disable=TL002 (leaf write lock; see comment)

    def register(self, req_id: int, p: _Pending) -> None:
        with self.plock:
            self.pending[req_id] = p

    def pop(self, req_id) -> _Pending | None:
        with self.plock:
            return self.pending.pop(req_id, None)

    def drain(self) -> list[_Pending]:
        with self.plock:
            out = list(self.pending.values())
            self.pending.clear()
        return out

    def abort(self) -> None:
        with self.wlock:
            if not self.alive:
                return
            self.alive = False
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class RemoteReplica:
    """A remote :class:`~.wire.WireServer` wrapped into the replica
    duck-type (module docstring).

    ``address`` is ``"host:port"`` or a ``(host, port)`` tuple;
    ``settings`` supplies the ``wire_*`` defaults when given. The
    constructor attempts one eager connection (non-fatal — an unreachable
    host starts broken and the reconnector takes over on first use).
    """

    #: the router forwards its minted trace context; it rides the
    #: envelope and the far server reconstructs it (obs v2 contract)
    accepts_trace = True

    def __init__(
        self,
        address,
        *,
        settings: dict | None = None,
        name: str | None = None,
        pool_size: int = 2,
        connect_timeout_ms: float | None = None,
        request_timeout_ms: float = 10_000.0,
        max_frame_bytes: int | None = None,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 1.0,
        retry_policy: RetryPolicy | None = None,
        eager_connect: bool = True,
    ):
        settings = settings or {}
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            self.host, self.port = host or "127.0.0.1", int(port)
        else:
            self.host, self.port = str(address[0]), int(address[1])
        self.name = name or f"remote:{self.host}:{self.port}"
        self.connect_timeout_s = (
            float(
                connect_timeout_ms
                if connect_timeout_ms is not None
                else settings.get("wire_connect_timeout_ms", 500.0) or 500.0
            )
            / 1000.0
        )
        self.request_timeout_ms = float(request_timeout_ms)
        self.max_frame_bytes = int(
            max_frame_bytes
            if max_frame_bytes is not None
            else settings.get("wire_max_frame_bytes", DEFAULT_MAX_FRAME_BYTES)
            or DEFAULT_MAX_FRAME_BYTES
        )
        self.pool_size = max(int(pool_size), 1)
        self.breaker = CircuitBreaker(
            threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_s,
            name=self.name,
        )
        self.retry_policy = retry_policy or RetryPolicy(
            base_delay=0.05, max_delay=2.0
        )
        self._lock = lockwatch.new_lock("RemoteReplica._lock")
        self._conns: list[_RemoteConn] = []
        self._rr = 0
        self._req_ids = itertools.count(1)
        self._latencies: deque = deque(maxlen=_LATENCY_RESERVOIR)
        self._remote_health: str | None = None
        self._closed = False
        self._reconnecting = False
        self._growing = False
        self._down_since: float | None = None
        self._sweeper: threading.Thread | None = None
        self.served = 0
        self.sheds = 0
        self.reconnects = 0
        self._t_start = time.monotonic()
        # closes router-minted traces on this side of the wire (the far
        # server emits the span tree; this records the attempt outcome —
        # with stitching on, the remote span tree grafts into the close)
        from ..obs.reqtrace import ServeTracer

        self._tracer = ServeTracer(0.0, service=self.name)
        # -- fleet observability -----------------------------------------
        # wire-overhead decomposition per response: serialize / network /
        # server-queue / server-execute / deserialize, fed into a
        # KernelWatch so the NETWORK phase gets the same two-window
        # regression alerting the serve kernels get. Host-side arithmetic
        # on stamps already taken; the wire hot path gains no sync.
        self._stitching = bool(settings.get("fleet_stitching", True))
        self._net_alert_ratio = float(
            settings.get("fleet_net_alert_ratio", 0.0) or 0.0
        )
        from ..obs.kernelwatch import KernelWatch

        self._netwatch = KernelWatch(
            window_s=30.0,
            alert_ratio=self._net_alert_ratio or 3.0,
        )
        self._net_alert_active = False
        self._last_net_eval = float("-inf")
        self._server_lat: deque = deque(maxlen=_LATENCY_RESERVOIR)
        self._network_lat: deque = deque(maxlen=_LATENCY_RESERVOIR)
        if eager_connect:
            try:
                self._add_conn(self._connect())
            except Exception as e:  # noqa: BLE001 - an unreachable host starts broken
                logger.warning(
                    "%s: eager connect failed (%s); starting broken",
                    self.name, e,
                )
                self.breaker.on_failure()
                self._note_down()
                self._kick_reconnector()

    # -- connection management ------------------------------------------

    def _handshake(self, sock: socket.socket, version: int) -> tuple:
        """One ``health`` exchange at ``version``; returns the reply
        envelope bracketed by monotonic send/receive stamps (the first
        clock-offset sample rides the handshake for free)."""
        t0 = time.monotonic()
        sock.sendall(
            encode_frame(
                {"v": version, "kind": "health", "id": 0},
                self.max_frame_bytes,
            )
        )
        env = read_frame(sock, self.max_frame_bytes)
        return env, t0, time.monotonic()

    def _connect(self) -> _RemoteConn:
        """Dial + liveness handshake: a socket only counts as connected
        after a ``health`` exchange round-trips — a partitioned host that
        accepts-then-drops fails here, not on the first real request.

        The handshake doubles as version negotiation: dial at v2; a v1
        server answers ``version_mismatch``, and the client re-handshakes
        at v1 on the same socket (the connection then carries no fleet
        fields — stitching and federation degrade to the flat v1 behaviour)."""
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout_s
        )
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            env, t0, t1 = self._handshake(sock, WIRE_VERSION)
            peer_version = WIRE_VERSION
            if (
                env is not None
                and env.get("kind") == "error"
                and env.get("reason") == "version_mismatch"
            ):
                # a v1-only peer: downgrade on the same socket
                env, t0, t1 = self._handshake(sock, 1)
                peer_version = 1
            if env is None or env.get("v") not in (1, WIRE_VERSION):
                raise ConnectionError(
                    f"liveness handshake failed: {env!r}"
                )
            if env.get("kind") == "error":
                # the server answered the dial itself with a shed (e.g.
                # `server_overloaded` past wire_max_connections): the
                # socket is already dead, surface the reason verbatim
                raise ConnectionError(
                    "remote refused connection: "
                    f"{env.get('reason') or 'error'}"
                )
            peer_version = min(peer_version, int(env.get("v") or 1))
            self._remote_health = env.get("health") or self._remote_health
            sock.settimeout(None)
        except Exception:
            try:
                sock.close()
            except OSError:
                pass
            raise
        conn = _RemoteConn(sock, peer_version=peer_version)
        conn.note_offset(env.get("t_server"), t0, t1)
        conn.reader = threading.Thread(
            target=self._reader_loop,
            args=(conn,),
            name=f"{self.name}-reader",
            daemon=True,
        )
        conn.reader.start()
        return conn

    def _add_conn(self, conn: _RemoteConn) -> None:
        with self._lock:
            self._conns.append(conn)
            self._down_since = None

    def _live_conn(self) -> _RemoteConn | None:
        """Round-robin over the live pool. An empty pool dials ONE inline
        connection (bounded by the connect timeout — the cost of the first
        request after a cold start); a pool merely below ``pool_size``
        grows in the background so steady-state submits never block on a
        dial."""
        with self._lock:
            conns = [c for c in self._conns if c.alive]
            self._conns = conns
            self._rr += 1
            pick = conns[self._rr % len(conns)] if conns else None
            need_grow = bool(conns) and len(conns) < self.pool_size
        if pick is None:
            with self._lock:
                down_since = self._down_since
            try:
                fresh = self._connect()
            except Exception:  # noqa: BLE001 - dial failure -> caller sheds
                return None
            self._add_conn(fresh)
            if down_since is not None:
                # the inline dial raced ahead of the background
                # reconnector and re-admitted the host: that IS the
                # reconnect, record it as one
                self._note_reconnected(down_since, attempts=1)
            return fresh
        if need_grow:
            self._kick_pool_grow()
        return pick

    def _kick_pool_grow(self) -> None:
        with self._lock:
            if self._growing or self._closed:
                return
            self._growing = True

        def grow():
            try:
                conn = self._connect()
            except Exception:  # noqa: BLE001 - the pool stays small, submits still work
                return
            else:
                self._add_conn(conn)
            finally:
                with self._lock:
                    self._growing = False

        threading.Thread(
            target=grow, name=f"{self.name}-pool", daemon=True
        ).start()

    def _note_down(self) -> None:
        with self._lock:
            if self._down_since is None:
                self._down_since = time.monotonic()

    def _note_reconnected(
        self, down_since: float | None, attempts: int
    ) -> None:
        """Re-admission bookkeeping, whichever dial path got there first
        (the background reconnector or a submit's inline dial)."""
        with self._lock:
            self.reconnects += 1
        downtime = (
            time.monotonic() - down_since if down_since is not None else 0.0
        )
        # a completed handshake is a served request: it counts as the
        # breaker's recovery probe succeeding
        self.breaker.on_success()
        publish(
            "wire_reconnect",
            replica=self.name,
            address=f"{self.host}:{self.port}",
            attempts=attempts,
            downtime_s=round(downtime, 3),
        )
        logger.info(
            "%s: reconnected after %d attempt(s), %.0fms down",
            self.name, attempts, downtime * 1e3,
        )

    def _kick_reconnector(self) -> None:
        with self._lock:
            if self._reconnecting or self._closed:
                return
            self._reconnecting = True
        t = threading.Thread(
            target=self._reconnect_loop,
            name=f"{self.name}-reconnect",
            daemon=True,
        )
        t.start()

    def _reconnect_loop(self) -> None:
        """Background redial with RetryPolicy's bounded exponential
        backoff — unbounded attempts (a healed host must be re-admitted
        whenever it heals) but delays cap at ``max_delay``."""
        attempt = 0
        try:
            while True:
                with self._lock:
                    if self._closed or any(c.alive for c in self._conns):
                        return
                time.sleep(
                    self.retry_policy.delay(min(attempt, 16))
                )
                with self._lock:
                    if self._closed:
                        return
                    down_since = self._down_since
                try:
                    conn = self._connect()
                except Exception:  # noqa: BLE001 - keep backing off
                    attempt += 1
                    continue
                self._add_conn(conn)
                self._note_reconnected(down_since, attempts=attempt + 1)
                return
        finally:
            with self._lock:
                self._reconnecting = False

    def _conn_lost(self, conn: _RemoteConn, why: str) -> None:
        """A dead socket: shed every in-flight request on it (machine-
        readable, immediate — never a hung future), count the link
        failure, start reconnecting."""
        conn.abort()
        if not conn.mark_lost():
            return  # the other observer of this death already accounted it
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)
            closed = self._closed
            any_alive = any(c.alive for c in self._conns)
        pend = conn.drain()
        reason = "closed" if closed else "connection_lost"
        for p in pend:
            self._resolve_shed(p, reason)
        if closed:
            return
        if pend:
            publish(
                "wire_shed",
                replica=self.name,
                reason=reason,
                n=len(pend),
                why=why,
            )
        self.breaker.on_failure()
        if not any_alive:
            self._note_down()
            self._kick_reconnector()

    # -- reader ---------------------------------------------------------

    def _reader_loop(self, conn: _RemoteConn) -> None:
        why = "eof"
        try:
            while conn.alive:
                env = read_frame(conn.sock, self.max_frame_bytes)
                if env is None:
                    break
                self._on_frame(conn, env)
        except (WireError, ConnectionError, OSError) as e:
            why = f"{type(e).__name__}"
        self._conn_lost(conn, why)

    def _on_frame(self, conn: _RemoteConn, env: dict) -> None:
        self._remote_health = env.get("health") or self._remote_health
        req_id = env.get("id")
        p = conn.pop(req_id) if req_id is not None else None
        kind = env.get("kind")
        if env.get("v") not in (1, WIRE_VERSION):
            if p is not None:
                self._resolve_shed(p, "version_mismatch")
            return
        if kind == "result" and p is not None:
            t1 = time.monotonic()
            server_ms = env.get("server_ms")
            conn.note_offset(
                env.get("t_server"), p.t0, t1,
                server_s=(server_ms or 0.0) / 1e3,
            )
            if isinstance(p.fut, list):
                self._on_batch_result(conn, p, env, t1)
                return
            t_des = time.monotonic()
            res = QueryResult.from_payload(env.get("result") or {})
            deserialize_ms = (time.monotonic() - t_des) * 1e3
            rtt_ms = (t1 - p.t0) * 1e3
            wire_ms = self._decompose(
                p, rtt_ms, server_ms, deserialize_ms, res
            )
            with self._lock:
                self._latencies.append(rtt_ms)
                if server_ms is not None:
                    self._server_lat.append(float(server_ms))
                    self._network_lat.append(wire_ms["network"])
                if res.shed:
                    self.sheds += 1
                else:
                    self.served += 1
            # the LINK worked; a server-side shed is the far replica's
            # admission/breaker talking, not this link's failure
            self.breaker.on_success()
            self._net_tick()
            if res.shed:
                self._tracer.close(p.trace, "shed", reason=res.reason)
            else:
                span = env.get("span") if self._stitching else None
                if span is not None:
                    self._tracer.close(
                        p.trace, "delivered",
                        remote_span=self._graft(span, conn),
                        wire_ms=wire_ms,
                        clock_offset_s=conn.offset_s,
                    )
                else:
                    self._tracer.close(p.trace, "delivered")
            self._set_result(p.fut, res)
        elif kind in ("health", "latency", "stats", "flight") and p is not None:
            if kind == "flight":
                self._set_result(p.fut, {
                    "replica": env.get("replica"),
                    "records": env.get("records") or [],
                })
            else:
                self._set_result(p.fut, env.get("snapshot") or {})
        elif kind == "error":
            if p is not None:
                self._resolve_shed(
                    p, str(env.get("reason") or "remote_error")
                )
        # responses for ids already swept (deadline/timeout) are dropped

    def _on_batch_result(
        self, conn: _RemoteConn, p: _Pending, env: dict, t1: float
    ) -> None:
        """Resolve one batched reply frame: ``results`` is positional
        against the futures list registered by :meth:`submit_many`; a
        short or missing list sheds the tail (``remote_error``) so every
        future still resolves."""
        payloads = env.get("results") or []
        rtt_ms = (t1 - p.t0) * 1e3
        served = shed = 0
        for i, fut in enumerate(p.fut):
            if i < len(payloads):
                res = QueryResult.from_payload(payloads[i] or {})
            else:
                res = QueryResult(shed=True, reason="remote_error")
            if res.shed:
                shed += 1
            else:
                served += 1
            self._set_result(fut, res)
        with self._lock:
            self._latencies.append(rtt_ms)
            self.served += served
            self.sheds += shed
        self.breaker.on_success()

    # -- wire-overhead decomposition (fleet observability) --------------

    def _decompose(
        self, p: _Pending, rtt_ms: float, server_ms,
        deserialize_ms: float, res: QueryResult,
    ) -> dict:
        """Split one round trip into serialize / network / server-queue /
        server-execute / deserialize (ms) and feed the netwatch. With a
        v1 peer (no ``server_ms``) everything between serialize and
        deserialize is attributed to ``network`` — the honest answer when
        the far side declines to decompose itself."""
        serialize_ms = (
            (p.t_sent - p.t0) * 1e3 if p.t_sent is not None else 0.0
        )
        srv = float(server_ms) if server_ms is not None else 0.0
        network_ms = max(rtt_ms - serialize_ms - srv - deserialize_ms, 0.0)
        out = {
            "serialize": round(serialize_ms, 4),
            "network": round(network_ms, 4),
            "server": round(srv, 4),
            "deserialize": round(deserialize_ms, 4),
        }
        if res.queue_ms is not None:
            out["server_queue"] = round(float(res.queue_ms), 4)
        if res.execute_ms is not None:
            out["server_execute"] = round(float(res.execute_ms), 4)
        w = self._netwatch
        w.observe("serialize", serialize_ms / 1e3)
        w.observe("network", network_ms / 1e3)
        w.observe("deserialize", deserialize_ms / 1e3)
        if server_ms is not None:
            if res.queue_ms is not None:
                w.observe("server_queue", float(res.queue_ms) / 1e3)
            if res.execute_ms is not None:
                w.observe("server_execute", float(res.execute_ms) / 1e3)
        return out

    def _graft(self, span: dict, conn: _RemoteConn) -> dict:
        """Rebase the remote span tree onto this host's clock using the
        connection's midpoint offset estimate, so the stitched waterfall
        renders on one time axis. The raw remote ``t0`` survives as
        ``t0_remote`` for audit."""
        out = dict(span)
        offset = conn.offset_s
        if offset is not None and span.get("t0") is not None:
            try:
                out["t0_remote"] = float(span["t0"])
                out["t0"] = float(span["t0"]) - offset
            except (TypeError, ValueError):
                pass
        return out

    def _net_tick(self) -> None:
        """Edge-triggered two-window alerting on the NETWORK phase of the
        wire decomposition (same shape as the service's ``perf_alert``):
        rate-limited evaluation, level-triggered state, events only on
        the edges. Off unless ``fleet_net_alert_ratio`` > 0."""
        if self._net_alert_ratio <= 0:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_net_eval < 1.0:
                return
            self._last_net_eval = now
            was_active = self._net_alert_active
        fired = [
            a for a in self._netwatch.alerts() if a["phase"] == "network"
        ]
        if fired and not was_active:
            with self._lock:
                self._net_alert_active = True
            publish(
                "fleet_net_alert",
                replica=self.name,
                address=f"{self.host}:{self.port}",
                alerts=fired,
            )
            logger.warning(
                "%s: network-phase latency regression: %s",
                self.name, fired,
            )
        elif not fired and was_active:
            with self._lock:
                self._net_alert_active = False
            publish("fleet_net_clear", replica=self.name)

    # -- shed plumbing --------------------------------------------------

    def _resolve_shed(self, p: _Pending, reason: str) -> None:
        futs = p.fut if isinstance(p.fut, list) else [p.fut]
        with self._lock:
            self.sheds += len(futs)
        self._tracer.close(p.trace, "shed", reason=reason)
        res = QueryResult(shed=True, reason=reason)
        for fut in futs:
            self._set_result(fut, res)

    @staticmethod
    def _set_result(fut: Future, value) -> None:
        try:
            fut.set_result(value)
        except InvalidStateError:  # lost a sweep/response race
            pass

    def _shed_now(self, reason: str, trace=None) -> Future:
        fut: Future = Future()
        with self._lock:
            self.sheds += 1
        self._tracer.close(trace, "shed", reason=reason)
        fut.set_result(QueryResult(shed=True, reason=reason))
        return fut

    # -- sweeper --------------------------------------------------------

    def _ensure_sweeper(self) -> None:
        with self._lock:
            if self._closed or (
                self._sweeper is not None and self._sweeper.is_alive()
            ):
                return
            self._sweeper = threading.Thread(
                target=self._sweep_loop,
                name=f"{self.name}-sweeper",
                daemon=True,
            )
            self._sweeper.start()

    def _sweep_loop(self) -> None:
        """Client-side guarantee that no future outlives its budget: an
        expired deadline sheds as ``deadline`` (the caller already
        abandoned it — a late server answer is dropped on arrival), and
        ``request_timeout_ms`` bounds deadline-less requests (``timeout``)
        so a wedged-but-connected server cannot hang the router."""
        while True:
            time.sleep(_SWEEP_INTERVAL_S)
            with self._lock:
                if self._closed:
                    return
                conns = list(self._conns)
            now = time.monotonic()
            for conn in conns:
                expired = []
                with conn.plock:
                    for rid, p in list(conn.pending.items()):
                        if p.deadline is not None and now > p.deadline:
                            expired.append((rid, p, "deadline"))
                        elif p.timeout_at is not None and now > p.timeout_at:
                            expired.append((rid, p, "timeout"))
                    for rid, _, _ in expired:
                        conn.pending.pop(rid, None)
                for _, p, reason in expired:
                    self._resolve_shed(p, reason)

    # -- the replica duck-type ------------------------------------------

    def submit(
        self,
        record: dict,
        deadline_ms: float | None = None,
        trace=None,
    ) -> Future:
        """Enqueue one query on the remote host; never raises, always
        resolves (module docstring for the shed taxonomy)."""
        with self._lock:
            closed = self._closed
        if closed:
            return self._shed_now("closed", trace)
        if deadline_ms is not None and deadline_ms <= 0:
            return self._shed_now("deadline", trace)
        if self.breaker.should_fail_fast():
            return self._shed_now("breaker_open", trace)
        conn = self._live_conn()
        if conn is None:
            self.breaker.on_failure()
            self._note_down()
            self._kick_reconnector()
            return self._shed_now("remote_unreachable", trace)
        self._ensure_sweeper()
        fut: Future = Future()
        req_id = next(self._req_ids)
        now = time.monotonic()
        p = _Pending(
            fut,
            trace,
            deadline=(
                None if deadline_ms is None else now + deadline_ms / 1000.0
            ),
            timeout_at=(
                now + self.request_timeout_ms / 1000.0
                if self.request_timeout_ms
                else None
            ),
        )
        env = {
            "v": conn.peer_version,
            "kind": "query",
            "id": req_id,
            "record": record,
            "deadline_ms": deadline_ms,
        }
        if trace is not None:
            env["trace"] = {
                "trace_id": trace.trace_id,
                "attempt": trace.attempt,
                "hedge": trace.hedge,
            }
        conn.register(req_id, p)
        try:
            conn.send(encode_frame(env, self.max_frame_bytes))
            p.t_sent = time.monotonic()
        except (WireError, OSError) as e:
            logger.warning("%s: send failed: %s", self.name, e)
            self._conn_lost(conn, f"send:{type(e).__name__}")
            # _conn_lost drains and sheds what was registered at drain
            # time; if this request registered after that drain (send vs
            # reader-death race) it must still resolve — pop is the
            # idempotence guard, a double resolve is impossible
            if conn.pop(req_id) is not None:
                self._resolve_shed(p, "connection_lost")
        return fut

    def submit_many(
        self,
        records: list,
        deadline_ms: float | None = None,
    ) -> list[Future]:
        """Enqueue N queries as ONE wire frame (v2 batched envelope): one
        serialize, one network round trip, one reply carrying positional
        results. Returns one future per record, each with the full
        never-raises / always-resolves contract of :meth:`submit`. A v1
        peer gets a per-record :meth:`submit` loop — same futures, no
        frame savings."""
        records = list(records)
        if not records:
            return []
        with self._lock:
            closed = self._closed
        if closed:
            return [self._shed_now("closed") for _ in records]
        if deadline_ms is not None and deadline_ms <= 0:
            return [self._shed_now("deadline") for _ in records]
        if self.breaker.should_fail_fast():
            return [self._shed_now("breaker_open") for _ in records]
        conn = self._live_conn()
        if conn is None:
            self.breaker.on_failure()
            self._note_down()
            self._kick_reconnector()
            return [self._shed_now("remote_unreachable") for _ in records]
        if conn.peer_version < 2:
            return [
                self.submit(r, deadline_ms=deadline_ms) for r in records
            ]
        self._ensure_sweeper()
        futs: list[Future] = [Future() for _ in records]
        req_id = next(self._req_ids)
        now = time.monotonic()
        p = _Pending(
            futs,
            None,
            deadline=(
                None if deadline_ms is None else now + deadline_ms / 1000.0
            ),
            timeout_at=(
                now + self.request_timeout_ms / 1000.0
                if self.request_timeout_ms
                else None
            ),
        )
        env = {
            "v": conn.peer_version,
            "kind": "query",
            "id": req_id,
            "records": records,
            "deadline_ms": deadline_ms,
        }
        conn.register(req_id, p)
        try:
            conn.send(encode_frame(env, self.max_frame_bytes))
            p.t_sent = time.monotonic()
        except (WireError, OSError) as e:
            logger.warning("%s: batched send failed: %s", self.name, e)
            self._conn_lost(conn, f"send:{type(e).__name__}")
            if conn.pop(req_id) is not None:
                self._resolve_shed(p, "connection_lost")
        return futs

    # -- fleet RPC helpers ----------------------------------------------

    def _rpc(self, kind: str, timeout_s: float = 1.5):
        """One v2 request/response exchange off the hot path (stats /
        flight_pull). None when unreachable or when the peer negotiated
        v1 (a v1 server answers these kinds with ``bad_kind``)."""
        with self._lock:
            conns = [c for c in self._conns if c.alive]
        conn = conns[0] if conns else self._live_conn()
        if conn is None or conn.peer_version < 2:
            return None
        fut: Future = Future()
        req_id = next(self._req_ids)
        conn.register(
            req_id,
            _Pending(fut, None, deadline=None,
                     timeout_at=time.monotonic() + timeout_s),
        )
        self._ensure_sweeper()
        try:
            conn.send(
                encode_frame(
                    {"v": conn.peer_version, "kind": kind, "id": req_id},
                    self.max_frame_bytes,
                )
            )
            out = fut.result(timeout=timeout_s + 0.5)
        except Exception as e:  # noqa: BLE001 - fleet pulls must not raise into the aggregator
            logger.warning("%s: %s pull failed: %s", self.name, kind, e)
            return None
        if isinstance(out, QueryResult):  # swept into a shed
            return None
        return out

    def fetch_stats(self) -> dict | None:
        """Pull the remote's federated-metrics snapshot
        (:meth:`~.service.LinkageService.fleet_stats` over the wire).
        None when the peer is v1 or unreachable."""
        return self._rpc("stats")

    def pull_flight(self) -> dict | None:
        """Pull the remote's flight-recorder ring for an incident bundle:
        ``{"replica": name, "records": [...]}`` or None (v1 peer /
        unreachable / no recorder on the far side)."""
        return self._rpc("flight_pull", timeout_s=3.0)

    @property
    def peer_version(self) -> int | None:
        """The negotiated wire version of the first live connection, or
        None while disconnected."""
        with self._lock:
            for c in self._conns:
                if c.alive:
                    return c.peer_version
        return None

    @property
    def health_state(self) -> str:
        """The worse of the remote's piggybacked self-assessment and the
        local link view: an open breaker or an empty pool means the host
        is unreachable from here, which is what broken means to a router
        (:func:`~.health.worse`)."""
        with self._lock:
            any_alive = any(c.alive for c in self._conns)
            closed = self._closed
        link = (
            BROKEN
            if closed or self.breaker.state == "open" or not any_alive
            else HEALTHY
        )
        return worse(self._remote_health or HEALTHY, link)

    def health(self) -> dict:
        """A live round-trip health snapshot from the remote (falls back
        to the local link view when the wire is down)."""
        with self._lock:
            n_conns = len(self._conns)
            reconnects = self.reconnects
            conns = [c for c in self._conns if c.alive]
        local = {
            "replica": self.name,
            "state": self.health_state,
            "link": {
                "breaker": self.breaker.snapshot(),
                "connections": n_conns,
                "reconnects": reconnects,
            },
        }
        if not conns:
            return local
        fut: Future = Future()
        req_id = next(self._req_ids)
        conn = conns[0]
        conn.register(
            req_id,
            _Pending(fut, None, deadline=None,
                     timeout_at=time.monotonic() + 1.0),
        )
        self._ensure_sweeper()
        try:
            conn.send(
                encode_frame(
                    {"v": WIRE_VERSION, "kind": "health", "id": req_id},
                    self.max_frame_bytes,
                )
            )
            snap = fut.result(timeout=1.5)
        except Exception as e:  # noqa: BLE001 - health must answer even when the wire cannot
            local["error"] = str(e)[:200]
            return local
        if isinstance(snap, QueryResult):  # swept into a shed
            local["error"] = snap.reason
            return local
        snap = dict(snap)
        snap["link"] = local["link"]
        return snap

    def latency_summary(self) -> dict:
        """Round-trip latency percentiles measured from THIS side of the
        wire (what the router's p95 hedging should key on — it includes
        the network), plus the link counters. With a v2 peer the round
        trip also splits into network-vs-server time (``server_ms``
        rides every result envelope), so "the remote is slow" and "the
        path to the remote is slow" stop being the same symptom."""
        with self._lock:
            lats = sorted(self._latencies)
            srv = sorted(self._server_lat)
            net = sorted(self._network_lat)
            served, sheds = self.served, self.sheds
            reconnects = self.reconnects
        elapsed = max(time.monotonic() - self._t_start, 1e-9)
        out = {
            "replica": self.name,
            "served": served,
            "shed": sheds,
            "queries_per_sec": served / elapsed,
            "reconnects": reconnects,
            "breaker_state": self.breaker.state,
            "health": self.health_state,
        }

        def _q(vals, p):
            return vals[min(int(p * len(vals)), len(vals) - 1)]

        if lats:
            out.update(
                p50_ms=_q(lats, 0.50), p95_ms=_q(lats, 0.95),
                p99_ms=_q(lats, 0.99), mean_ms=sum(lats) / len(lats),
            )
        if srv:
            out["server"] = {
                "p50_ms": _q(srv, 0.50), "p95_ms": _q(srv, 0.95),
                "mean_ms": sum(srv) / len(srv), "n": len(srv),
            }
        if net:
            out["network"] = {
                "p50_ms": _q(net, 0.50), "p95_ms": _q(net, 0.95),
                "mean_ms": sum(net) / len(net), "n": len(net),
            }
        return out

    def wire_phases(self) -> dict:
        """Rolling stats for the wire-overhead phases (serialize /
        network / server_queue / server_execute / deserialize) the
        netwatch accumulates — the per-remote per-hop attribution the
        fleet dashboard renders."""
        return {
            p: self._netwatch.phase_stats(p)
            for p in self._netwatch.phases()
        }

    def prometheus_samples(self) -> list:
        from ..obs.exposition import Sample

        labels = {"replica": self.name}
        s = self.latency_summary()
        out = [
            Sample("splink_remote_served_total", s["served"], labels,
                   "counter", "Remote requests delivered over the wire"),
            Sample("splink_remote_shed_total", s["shed"], labels,
                   "counter", "Remote requests shed (link + server)"),
            Sample("splink_remote_reconnects_total", s["reconnects"],
                   labels, "counter", "Background reconnects completed"),
            Sample("splink_remote_health_rank",
                   health_rank(self.health_state), labels, "gauge",
                   "0 healthy / 1 degraded / 2 broken"),
        ]
        for side in ("server", "network"):
            split = s.get(side)
            if split:
                out.append(
                    Sample(
                        f"splink_remote_{side}_p95_ms",
                        round(split["p95_ms"], 4), labels, "gauge",
                        f"p95 {side}-attributed ms of the remote round trip",
                    )
                )
        return out

    def close(self) -> None:
        """Stop threads, close the pool, resolve anything in flight as a
        ``closed`` shed. Idempotent; never touches the remote server."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns)
            self._conns = []
        for conn in conns:
            pend = conn.drain()
            conn.abort()
            for p in pend:
                self._resolve_shed(p, "closed")
