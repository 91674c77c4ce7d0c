"""The port's copy of splink_tpu/serve/wire.py.

The serving wire tier: a length-prefixed JSON protocol + WireServer.

`ReplicaRouter` is deliberately duck-typed over ``submit / health_state /
latency_summary`` so that "a replica" never had to mean "a thread in this
process". This module is the other half of that bet: a stdlib-only TCP
protocol that puts a :class:`~.service.LinkageService` behind a socket,
and (in :mod:`.remote`) a client that wraps the socket back into the
replica shape — so the router routes, hedges and fails over across HOSTS
with zero router changes (docs/serving.md#multi-host).

Frame format — 4-byte big-endian unsigned length prefix, then exactly
that many bytes of UTF-8 JSON (the envelope)::

    +----------+----------------------------+
    | len: u32 | envelope: JSON, len bytes  |
    +----------+----------------------------+

Envelope — versioned (``"v"``), one dict per frame::

    {"v": 2, "kind": "query",  "id": 7, "record": {...},
     "deadline_ms": 1.8, "trace": {"trace_id": "...", "attempt": 1}}
    {"v": 2, "kind": "query",  "id": 7, "records": [{...}, ...]}  (batched)
    {"v": 2, "kind": "result", "id": 7, "result": {...}, "health": "healthy",
     "server_ms": 1.2, "t_server": 812.44, "span": {...}}
    {"v": 2, "kind": "result", "id": 7, "results": [{...}, ...]}  (batched)
    {"v": 2, "kind": "health" | "latency" | "stats", "id": 8}     (request)
    {"v": 2, "kind": "health" | "latency" | "stats", "id": 8,
     "snapshot": {...}, "health": "healthy"}                      (response)
    {"v": 2, "kind": "flight_pull", "id": 9}                      (request)
    {"v": 2, "kind": "flight", "id": 9, "records": [...]}         (response)
    {"v": 2, "kind": "error", "id": 7 | null, "reason": "...",
     "health": "healthy"}

Version negotiation (wire v2, fleet observability): the server accepts
BOTH v1 and v2 request envelopes and every reply echoes the REQUEST's
version, so a v1 client talking to a v2 server sees pure v1 traffic. The
v2-only fields — ``server_ms`` + the queue/execute split inside the
result payload, the ``t_server`` monotonic timestamp (the client's
RTT-midpoint clock-offset estimate), the piggybacked ``span`` tree
(cross-host trace stitching), the ``stats`` / ``flight_pull`` kinds and
batched ``records`` frames — ride only on v2 envelopes. A v2 client
dialing a v1 server gets ``version_mismatch`` on its handshake and
re-handshakes at v1 on the same socket (serve/remote.py), degrading to
the flat v1 behaviour.

Contract decisions that carry the robustness weight:

* **Hostile length prefix** — a declared length over the
  ``wire_max_frame_bytes`` cap is rejected BEFORE any payload byte is
  read (one 4-byte header read, zero allocation), answered with an
  ``error`` envelope (reason ``frame_too_large``) and the connection is
  closed: past the header there is no way to resynchronise a stream whose
  framing cannot be trusted.
* **Torn frame** — EOF mid-frame raises :class:`TornFrame`; the side that
  observes it treats the CONNECTION as dead but never a request as lost:
  the client resolves every in-flight future as a machine-readable shed.
* **Corrupt payload** — a frame whose length is honest but whose JSON is
  not gets an ``error`` reply (reason ``bad_frame``) and the connection
  KEEPS SERVING: framing is intact, so one bad payload must not poison
  the requests interleaved behind it. Same for an unsupported envelope
  version (reason ``version_mismatch``).
* **Deadline propagation** — ``deadline_ms`` rides the query envelope as
  the client's REMAINING budget; the service's admission control and
  batcher then shed a lapsed request server-side, so a remote never
  scores work the caller already abandoned.
* **Health piggybacking** — every response carries the replica's
  ``health_state`` (one lock-free property read), so the client's view of
  a sickening host advances at request cadence, ahead of any watchdog.
* **Trace propagation** — the router-minted ``(trace_id, attempt)`` rides
  the envelope; the server reconstructs a :class:`~..obs.reqtrace.
  RequestTrace` around it so the replica that did the work emits the span
  tree, exactly like the in-process path (obs v2 contract).

Fault injection (``resilience/faults.py`` WIRE_SITES): ``wire_accept``,
``wire_request`` and ``wire_response`` fire the ``net_*`` kinds —
``net_drop`` (abrupt close), ``net_delay`` (stall, fired inside the
plan), ``net_torn_frame`` (cut a reply mid-frame) and ``net_partition``
(drop every connection and refuse new ones for ``delay_ms``).
tests/test_torch_wire.py and chip_smoke.py's ``fleet`` phase drive them.
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time

from ..analysis import lockwatch

from ..obs.events import _sanitise, publish
from ..resilience.faults import InjectedFault, active_plan

logger = logging.getLogger("splink_tpu_torch")

#: Envelope schema version this build speaks natively; a frame carrying a
#: version outside :data:`SUPPORTED_VERSIONS` is rejected per-request
#: (reason ``version_mismatch``), not per-connection.
WIRE_VERSION = 2

#: Inbound request versions a v2 server answers (each reply echoes the
#: request's version — module docstring, version negotiation).
SUPPORTED_VERSIONS = (1, 2)

#: Default cap on one frame's payload (settings key ``wire_max_frame_bytes``).
DEFAULT_MAX_FRAME_BYTES = 4 * 1024 * 1024

#: Default cap on simultaneously open connections (settings key
#: ``wire_max_connections``). Past the cap a connection is accepted,
#: answered with ONE ``server_overloaded`` error envelope and closed — a
#: machine-readable shed, not a silent drop.
DEFAULT_MAX_CONNECTIONS = 64

_HEADER = struct.Struct(">I")
_RECV_CHUNK = 1 << 16  # bounded per-recv read; never trust the prefix


class WireError(RuntimeError):
    """Base class for wire-protocol failures."""


class FrameTooLarge(WireError):
    """A frame (outbound or declared by a length prefix) over the cap."""


class TornFrame(WireError):
    """EOF mid-frame: the peer died (or a fault cut the link) between the
    length prefix and the promised payload bytes."""


class CorruptFrame(WireError):
    """An intact frame whose payload is not valid JSON (or not a dict)."""


# -- frame layer --------------------------------------------------------


def encode_frame(
    envelope: dict, max_bytes: int = DEFAULT_MAX_FRAME_BYTES
) -> bytes:
    """Length-prefixed bytes for one envelope. ``_sanitise`` makes the
    payload JSON-safe (numpy scalars -> Python, non-finite -> null) so
    query records and results serialise without caller ceremony."""
    payload = json.dumps(
        _sanitise(envelope), separators=(",", ":")
    ).encode("utf-8")
    if len(payload) > max_bytes:
        raise FrameTooLarge(
            f"frame payload {len(payload)}B exceeds the {max_bytes}B cap"
        )
    return _HEADER.pack(len(payload)) + payload


def _recv_exact(sock: socket.socket, n: int, allow_eof: bool = False):
    """Exactly ``n`` bytes from ``sock`` in bounded chunks. A clean EOF at
    a frame boundary returns None (when ``allow_eof``); EOF anywhere else
    is a :class:`TornFrame`."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), _RECV_CHUNK))
        if not chunk:
            if allow_eof and not buf:
                return None
            raise TornFrame(
                f"connection closed {len(buf)}/{n} bytes into a frame"
            )
        buf.extend(chunk)
    return bytes(buf)


def read_frame(
    sock: socket.socket, max_bytes: int = DEFAULT_MAX_FRAME_BYTES
):
    """One envelope off the socket, or None on clean EOF.

    Raises :class:`FrameTooLarge` (hostile prefix — nothing past the
    4-byte header has been read), :class:`TornFrame` (EOF mid-frame) or
    :class:`CorruptFrame` (honest length, broken payload)."""
    hdr = _recv_exact(sock, _HEADER.size, allow_eof=True)
    if hdr is None:
        return None
    (length,) = _HEADER.unpack(hdr)
    if length == 0 or length > max_bytes:
        raise FrameTooLarge(
            f"declared frame length {length}B outside (0, {max_bytes}B]"
        )
    payload = _recv_exact(sock, length)
    try:
        env = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise CorruptFrame(f"undecodable frame payload: {e}") from e
    if not isinstance(env, dict):
        raise CorruptFrame(f"envelope must be a JSON object, got {type(env)}")
    return env


# -- server -------------------------------------------------------------


class _ServerConn:
    """One accepted connection: the socket, a write lock (responses for
    interleaved requests resolve from worker threads) and liveness."""

    __slots__ = ("sock", "peer", "wlock", "alive")

    def __init__(self, sock: socket.socket, peer):
        self.sock = sock
        self.peer = f"{peer[0]}:{peer[1]}" if isinstance(peer, tuple) else str(peer)
        self.wlock = lockwatch.new_lock("_ServerConn.wlock")
        self.alive = True

    def send(self, frame: bytes) -> None:
        with self.wlock:
            if not self.alive:
                raise BrokenPipeError("connection already closed")
            # Serializing whole-frame writes is wlock's entire job: two
            # threads interleaving partial sendall()s would corrupt the
            # stream. wlock is a leaf (never wraps another acquisition),
            # so blocking under it cannot deadlock — only queue writers.
            self.sock.sendall(frame)  # threadlint: disable=TL002 (leaf write lock; see comment)

    def abort(self) -> None:
        """Hard-close from any thread; unblocks a reader mid-recv."""
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


def _shed_result(reason: str):
    from .service import QueryResult  # lazy: wire stays import-light

    return QueryResult(shed=True, reason=reason)


class _SpanJoin:
    """Joins a traced request's two completion signals — the future's
    done-callback (the result payload) and the trace's ``on_close`` hook
    (the span tree) — and sends ONE combined ``result`` envelope when
    both have landed (wire v2 stitching).

    The service resolves the future before closing the trace on the same
    worker thread, so in practice ``note_result`` always arrives first
    and ``note_span`` sends microseconds later; the tiny lock makes
    either order (and a foreign service that never closes its traces,
    via ``cancel``) safe. Sending goes through ``WireServer._reply``,
    which never raises."""

    __slots__ = ("server", "wc", "req_id", "version", "_lock", "_body",
                 "_span", "_done")

    def __init__(self, server, wc, req_id, version: int):
        self.server = server
        self.wc = wc
        self.req_id = req_id
        self.version = version
        self._lock = threading.Lock()
        self._body: dict | None = None
        self._span: dict | None = None
        self._done = False

    def note_result(self, body: dict) -> None:
        with self._lock:
            if self._done:
                return
            self._body = body
            if self._span is None:
                return  # the span closes next; it sends
            self._done = True
            body = dict(self._body, span=self._span)
        self.server._reply(self.wc, body, version=self.version)

    def note_span(self, event: dict) -> None:
        with self._lock:
            if self._done:
                return
            self._span = event
            if self._body is None:
                return  # future not resolved yet; note_result sends
            self._done = True
            body = dict(self._body, span=self._span)
        self.server._reply(self.wc, body, version=self.version)

    def cancel(self) -> None:
        """An error reply already went out; drop whatever arrives."""
        with self._lock:
            self._done = True


class WireServer:
    """Serves one replica (anything in the :class:`~.router.Replica`
    shape, normally a :class:`~.service.LinkageService`) over the wire
    protocol (module docstring).

    Thread-per-connection with response demultiplexing: requests on one
    connection are submitted as they arrive and each response is written
    when ITS future resolves, under the connection write lock — so a slow
    query never convoys the fast ones interleaved behind it.

    ``partition(duration_s)`` models a network partition: every live
    connection drops abruptly and new connections are refused until the
    heal, which publishes ``wire_partition_heal``. ``kill()`` models host
    death: everything closes abruptly, nothing drains, no events.
    """

    def __init__(
        self,
        service,
        *,
        host: str = "127.0.0.1",
        port: int | None = None,
        max_frame_bytes: int | None = None,
        max_connections: int | None = None,
        name: str | None = None,
        protocol_version: int | None = None,
    ):
        settings = getattr(
            getattr(getattr(service, "engine", None), "index", None),
            "settings",
            {},
        ) or {}
        self.service = service
        self.host = host
        self._port_requested = int(
            port if port is not None else settings.get("wire_port", 0) or 0
        )
        self.max_frame_bytes = int(
            max_frame_bytes
            if max_frame_bytes is not None
            else settings.get("wire_max_frame_bytes", DEFAULT_MAX_FRAME_BYTES)
            or DEFAULT_MAX_FRAME_BYTES
        )
        self.max_connections = int(
            max_connections
            if max_connections is not None
            else settings.get("wire_max_connections", DEFAULT_MAX_CONNECTIONS)
            or DEFAULT_MAX_CONNECTIONS
        )
        if self.max_connections < 1:
            raise ValueError(
                f"wire_max_connections must be >= 1, got {self.max_connections}"
            )
        self.name = name or f"wire:{getattr(service, 'name', 'serve')}"
        # ``protocol_version=1`` makes this server behave as a legacy v1
        # peer (accepts only v1 envelopes, emits none of the v2 fields) —
        # the degradation tests' stand-in for a pre-fleet build.
        self.protocol_version = int(protocol_version or WIRE_VERSION)
        if self.protocol_version not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"protocol_version must be one of {SUPPORTED_VERSIONS}, "
                f"got {self.protocol_version}"
            )
        self._stitching = bool(settings.get("fleet_stitching", True))
        self._settings = settings
        self._lock = lockwatch.new_lock("WireServer._lock")
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._conns: list[_ServerConn] = []
        self._threads: list[threading.Thread] = []
        self._stop = False
        self._partition_until = 0.0
        self._partition_timer: threading.Timer | None = None
        self.port: int | None = None
        self.connections_total = 0
        self.requests_total = 0
        self.errors_total = 0
        self.partitions_total = 0
        self.overloaded_total = 0

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "WireServer":
        with self._lock:
            if self._listener is not None:
                return self
            lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lst.bind((self.host, self._port_requested))
            lst.listen(128)
            self._listener = lst
            self._stop = False
            self.port = lst.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"{self.name}-accept", daemon=True
        )
        self._accept_thread.start()
        logger.info("wire server %s listening on %s", self.name, self.address)
        return self

    @property
    def address(self) -> str:
        # port is assigned exactly once, inside start()'s lock, before the
        # accept thread or any client exists; every later read sees the
        # final value. stats() also reads this while holding _lock, so
        # taking the (non-reentrant) lock here would self-deadlock.
        return f"{self.host}:{self.port}"  # threadlint: disable=TL001 (write-once at startup)

    def close(self) -> None:
        """Graceful stop: no new connections, live ones close, threads
        join. Idempotent."""
        self._shutdown(abrupt=False)

    def kill(self) -> None:
        """Host death: everything closes abruptly mid-whatever — clients
        must recover via their shed/reconnect paths, not via any goodbye
        this server never sends."""
        self._shutdown(abrupt=True)

    def _shutdown(self, abrupt: bool) -> None:
        with self._lock:
            if self._stop and self._listener is None:
                return
            self._stop = True
            listener, self._listener = self._listener, None
            conns = list(self._conns)
            timer, self._partition_timer = self._partition_timer, None
        if timer is not None:
            timer.cancel()
        if listener is not None:
            try:
                listener.close()
            except OSError:
                pass
        for wc in conns:
            wc.abort()
        if not abrupt:
            for t in list(self._threads):
                if t is not threading.current_thread():
                    t.join(timeout=2.0)
            if self._accept_thread is not None:
                self._accept_thread.join(timeout=2.0)

    # -- partition ------------------------------------------------------

    def partition(self, duration_s: float) -> None:
        """Drop every connection and refuse new ones for ``duration_s``;
        the heal publishes ``wire_partition_heal``."""
        with self._lock:
            self._partition_until = time.monotonic() + duration_s
            conns = list(self._conns)
            self.partitions_total += 1
            if self._partition_timer is not None:
                self._partition_timer.cancel()
            self._partition_timer = threading.Timer(
                duration_s, self._heal, args=(duration_s, len(conns))
            )
            self._partition_timer.daemon = True
            self._partition_timer.start()
        logger.warning(
            "wire server %s partitioned for %.0fms (%d connections dropped)",
            self.name, duration_s * 1e3, len(conns),
        )
        for wc in conns:
            wc.abort()

    def _heal(self, duration_s: float, dropped: int) -> None:
        with self._lock:
            self._partition_until = 0.0
            self._partition_timer = None
        publish(
            "wire_partition_heal",
            server=self.name,
            duration_s=round(duration_s, 3),
            dropped=dropped,
        )
        logger.info("wire server %s partition healed", self.name)

    def _partitioned(self) -> bool:
        with self._lock:
            until = self._partition_until
        return time.monotonic() < until

    # -- accept / connection loops --------------------------------------

    def _accept_loop(self) -> None:
        while True:
            with self._lock:
                listener = self._listener
                stop = self._stop
            if listener is None or stop:
                return
            try:
                sock, peer = listener.accept()
            except OSError:
                return  # listener closed
            with self._lock:
                stop = self._stop
            if stop or self._partitioned():
                # a partitioned host is unreachable: the accepted socket
                # dies before a single byte, so the client's liveness
                # handshake reads EOF and treats the connect as failed
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            with self._lock:
                overloaded = len(self._conns) >= self.max_connections
                if overloaded:
                    self.overloaded_total += 1
            if overloaded:
                # Explicit shed, not a silent drop: the client reads ONE
                # machine-readable error envelope (reason
                # `server_overloaded`) before EOF, so it can tell "this
                # host is full, fail over" apart from a partition or a
                # crash — and must not burn its reconnect backoff on it.
                self._refuse_overloaded(sock, peer)
                continue
            wc = _ServerConn(sock, peer)
            with self._lock:
                self.connections_total += 1
                n = self.connections_total
                self._conns.append(wc)
            try:
                active_plan(self._settings).fire("wire_accept", conn=n)
            except InjectedFault as f:
                self._net_fault(wc, f)
                continue
            publish(
                "wire_connect", server=self.name, peer=wc.peer, conn=n
            )
            t = threading.Thread(
                target=self._serve_conn,
                args=(wc,),
                name=f"{self.name}-conn{n}",
                daemon=True,
            )
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
            t.start()

    def _refuse_overloaded(self, sock: socket.socket, peer) -> None:
        """Answer an over-cap connection with one ``server_overloaded``
        error envelope and close it (module cap docstring)."""
        peer_s = f"{peer[0]}:{peer[1]}" if isinstance(peer, tuple) else str(peer)
        try:
            sock.sendall(
                encode_frame(
                    {
                        "v": self.protocol_version,
                        "kind": "error",
                        "id": None,
                        "reason": "server_overloaded",
                        "health": getattr(
                            self.service, "health_state", "degraded"
                        ),
                    },
                    self.max_frame_bytes,
                )
            )
        except OSError:
            pass  # the peer already gave up; the close below still counts
        try:
            sock.close()
        except OSError:
            pass
        publish(
            "wire_overload",
            server=self.name,
            peer=peer_s,
            max_connections=self.max_connections,
        )
        logger.warning(
            "wire server %s refused %s: %d connections open (cap %d)",
            self.name, peer_s, self.max_connections, self.max_connections,
        )

    def _net_fault(self, wc: _ServerConn, fault: InjectedFault) -> None:
        """Apply an injected network fault to a connection: every net kind
        (and any other injected raise at a wire site) ends in an abrupt
        close; ``net_partition`` additionally opens the partition window,
        and ``net_torn_frame`` is handled at the response site where there
        is a frame to tear."""
        if fault.kind == "net_partition":
            self.partition(fault.delay_ms / 1000.0)
            return  # partition() aborts every connection, including wc
        self._drop_conn(wc, reason=fault.kind)

    def _drop_conn(self, wc: _ServerConn, reason: str) -> None:
        wc.abort()
        with self._lock:
            if wc in self._conns:
                self._conns.remove(wc)
            stop = self._stop
        if not stop:
            publish(
                "wire_disconnect",
                server=self.name,
                peer=wc.peer,
                reason=reason,
            )

    def _serve_conn(self, wc: _ServerConn) -> None:
        reason = "eof"
        try:
            while wc.alive:
                try:
                    env = read_frame(wc.sock, self.max_frame_bytes)
                except FrameTooLarge as e:
                    # reject without reading the payload; the stream's
                    # framing is untrustworthy past this point, so close
                    with self._lock:
                        self.errors_total += 1
                    self._reply_error(wc, None, "frame_too_large", str(e))
                    reason = "frame_too_large"
                    break
                except CorruptFrame as e:
                    # honest length, broken payload: reject the request,
                    # keep the connection (framing is intact)
                    with self._lock:
                        self.errors_total += 1
                    self._reply_error(wc, None, "bad_frame", str(e))
                    continue
                if env is None:
                    break  # clean EOF
                self._dispatch(wc, env)
        except (TornFrame, ConnectionError, OSError):
            reason = "torn"
        finally:
            self._drop_conn(wc, reason=reason)

    # -- request dispatch -----------------------------------------------

    def _dispatch(self, wc: _ServerConn, env: dict) -> None:
        req_id = env.get("id")
        pv = env.get("v")
        accepted = (
            SUPPORTED_VERSIONS if self.protocol_version >= 2 else (1,)
        )
        if pv not in accepted:
            with self._lock:
                self.errors_total += 1
            self._reply_error(
                wc, req_id, "version_mismatch",
                f"envelope v={pv!r}, this server speaks "
                f"v={self.protocol_version}",
                version=self.protocol_version,
            )
            return
        kind = env.get("kind")
        if kind == "query":
            if isinstance(env.get("records"), list) and pv >= 2:
                self._handle_batch_query(wc, req_id, env, pv)
            else:
                self._handle_query(wc, req_id, env, pv)
        elif kind == "health":
            snap = self._safe_call(self.service.health, {})
            body = {"kind": "health", "id": req_id, "snapshot": snap}
            if pv >= 2:
                # the clock-offset sample: the client brackets this reply
                # between its send/receive stamps (RTT midpoint)
                body["t_server"] = time.monotonic()
            self._reply(wc, body, version=pv)
        elif kind == "latency":
            snap = self._safe_call(self.service.latency_summary, {})
            self._reply(
                wc, {"kind": "latency", "id": req_id, "snapshot": snap},
                version=pv,
            )
        elif kind == "stats" and pv >= 2:
            fn = getattr(self.service, "fleet_stats", None)
            snap = self._safe_call(fn, {}) if fn is not None else {}
            self._reply(
                wc, {"kind": "stats", "id": req_id, "snapshot": snap},
                version=pv,
            )
        elif kind == "flight_pull" and pv >= 2:
            fr = getattr(self.service, "flight_recorder", None)
            records = (
                self._safe_call(fr.snapshot, []) if fr is not None else []
            )
            self._reply(
                wc,
                {"kind": "flight", "id": req_id, "records": records,
                 "replica": getattr(self.service, "name", self.name)},
                version=pv,
            )
        else:
            with self._lock:
                self.errors_total += 1
            self._reply_error(
                wc, req_id, "bad_kind", f"unsupported kind {kind!r}",
                version=pv,
            )

    @staticmethod
    def _safe_call(fn, default):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - introspection must not kill the conn
            logger.warning("wire introspection call failed: %s", e)
            return default

    def _handle_query(
        self, wc: _ServerConn, req_id, env: dict, pv: int = 1
    ) -> None:
        t_recv = time.monotonic()
        with self._lock:
            self.requests_total += 1
            n = self.requests_total
        try:
            active_plan(self._settings).fire("wire_request", request=n)
        except InjectedFault as f:
            self._net_fault(wc, f)
            return
        record = env.get("record") or {}
        deadline_ms = env.get("deadline_ms")
        trace = self._inbound_trace(env.get("trace"))
        # span piggyback (v2 stitching): the service resolves the future
        # FIRST, then closes the trace on the same worker thread — so the
        # result send waits for the span via the trace's on_close hook
        # instead of racing it (obs/reqtrace.py). Both callbacks feed the
        # join; whichever lands second sends the combined envelope.
        join = None
        if (
            pv >= 2
            and trace is not None
            and self._stitching
            and getattr(self.service, "closes_traces", False)
        ):
            # only a service that closes every attempt it resolves
            # (LinkageService's contract) may gate the reply on the span;
            # plain duck-typed replicas keep the flat v1-style result
            join = _SpanJoin(self, wc, req_id, pv)
            trace.on_close = join.note_span
        try:
            if trace is not None:
                fut = self.service.submit(
                    record, deadline_ms=deadline_ms, trace=trace
                )
            else:
                fut = self.service.submit(record, deadline_ms=deadline_ms)
        except Exception as e:  # noqa: BLE001 - a throwing replica is a shed
            logger.warning("wire submit raised (replied as shed): %s", e)
            if join is not None:
                join.cancel()
            self._reply_error(
                wc, req_id, "replica_error", str(e)[:300], version=pv
            )
            return
        fut.add_done_callback(
            lambda f, wc=wc, rid=req_id, pv=pv, t0=t_recv, j=join:
            self._send_result(wc, rid, f, pv=pv, t_recv=t0, join=j)
        )

    def _handle_batch_query(
        self, wc: _ServerConn, req_id, env: dict, pv: int
    ) -> None:
        """A batched ``records`` frame (client-side envelope batching):
        every record is submitted individually — the service's own
        coalescer amortises dispatch — and ONE ``results`` reply carries
        the payloads in request order once the last future resolves.
        Batched frames carry no per-request traces (the amortisation is
        the point; per-record spans would undo it)."""
        t_recv = time.monotonic()
        records = env.get("records") or []
        with self._lock:
            self.requests_total += len(records)
            n = self.requests_total
        try:
            active_plan(self._settings).fire("wire_request", request=n)
        except InjectedFault as f:
            self._net_fault(wc, f)
            return
        deadline_ms = env.get("deadline_ms")
        count = len(records)
        if count == 0:
            self._reply(
                wc,
                {"kind": "result", "id": req_id, "results": [],
                 "server_ms": 0.0, "t_server": time.monotonic()},
                version=pv,
            )
            return
        payloads: list = [None] * count
        remaining = [count]
        rlock = threading.Lock()

        def on_done(i: int, fut) -> None:
            try:
                payloads[i] = fut.result().to_payload()
            except Exception as e:  # noqa: BLE001 - replica futures should not raise
                logger.warning("wire batched future raised: %s", e)
                payloads[i] = {"shed": True, "reason": "remote_error"}
            with rlock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last:
                now = time.monotonic()
                self._reply(
                    wc,
                    {"kind": "result", "id": req_id, "results": payloads,
                     "server_ms": (now - t_recv) * 1e3, "t_server": now},
                    version=pv,
                )

        for i, record in enumerate(records):
            try:
                fut = self.service.submit(
                    record or {}, deadline_ms=deadline_ms
                )
            except Exception as e:  # noqa: BLE001 - a throwing replica is a shed
                logger.warning("wire batched submit raised: %s", e)
                from concurrent.futures import Future

                fut = Future()
                fut.set_result(
                    _shed_result("replica_error")
                )
            fut.add_done_callback(
                lambda f, i=i: on_done(i, f)
            )

    def _inbound_trace(self, t):
        """Reconstruct the router-minted trace context so the replica that
        does the work emits the span tree (obs v2 contract) — only when
        the backing replica accepts one."""
        if not t or not getattr(self.service, "accepts_trace", False):
            return None
        try:
            from ..obs.reqtrace import RequestTrace, TraceRoot

            return RequestTrace(
                root=TraceRoot(trace_id=str(t.get("trace_id"))),
                attempt=int(t.get("attempt") or 0),
                hedge=bool(t.get("hedge")),
            )
        except Exception:  # noqa: BLE001 - tracing must never break serving
            return None

    # -- responses ------------------------------------------------------

    def _send_result(
        self, wc: _ServerConn, req_id, fut, pv: int = 1,
        t_recv: float | None = None, join=None,
    ) -> None:
        try:
            res = fut.result()
            payload = res.to_payload()
        except Exception as e:  # noqa: BLE001 - replica futures should not raise
            logger.warning("wire replica future raised: %s", e)
            if join is not None:
                join.cancel()
            self._reply_error(
                wc, req_id, "replica_error", str(e)[:300], version=pv
            )
            return
        body = {"kind": "result", "id": req_id, "result": payload}
        if pv >= 2:
            now = time.monotonic()
            body["t_server"] = now
            if t_recv is not None:
                body["server_ms"] = (now - t_recv) * 1e3
        if join is not None:
            join.note_result(body)
            return
        self._reply(wc, body, version=pv)

    def _reply_error(
        self, wc, req_id, reason: str, detail: str,
        version: int | None = None,
    ) -> None:
        self._reply(
            wc,
            {"kind": "error", "id": req_id, "reason": reason,
             "detail": detail},
            version=version,
        )

    def _reply(
        self, wc: _ServerConn, body: dict, version: int | None = None
    ) -> None:
        env = {
            # echo the request's version (negotiation contract); server-
            # initiated frames carry this build's native version
            "v": version if version is not None else self.protocol_version,
            # piggybacked health: one lock-free property read per response
            "health": getattr(self.service, "health_state", None),
            **body,
        }
        try:
            active_plan(self._settings).fire(
                "wire_response", request=body.get("id")
            )
        except InjectedFault as f:
            if f.kind == "net_torn_frame":
                self._send_torn(wc, env)
                return
            self._net_fault(wc, f)
            return
        try:
            wc.send(encode_frame(env, self.max_frame_bytes))
        except (WireError, OSError) as e:
            # a result landing on an already-dead connection (peer gone,
            # server killed mid-flight) is routine churn, not an incident
            log = logger.debug if not wc.alive else logger.warning
            log("wire response to %s failed: %s", wc.peer, e)
            self._drop_conn(wc, reason="send_failed")

    def _send_torn(self, wc: _ServerConn, env: dict) -> None:
        """Write a frame whose prefix promises more bytes than arrive,
        then die — the torn-frame failure the client reader must turn
        into sheds, never hangs."""
        frame = encode_frame(env, self.max_frame_bytes)
        cut = max(len(frame) // 2, _HEADER.size + 1)
        try:
            wc.send(frame[:cut])
        except OSError:
            pass
        self._drop_conn(wc, reason="net_torn_frame")

    # -- introspection --------------------------------------------------

    def stats(self) -> dict:
        # _partitioned() takes _lock itself — resolve it before entering
        partitioned = self._partitioned()
        with self._lock:
            return {
                "server": self.name,
                "address": self.address,
                "connections_total": self.connections_total,
                "connections_active": len(self._conns),
                "requests_total": self.requests_total,
                "errors_total": self.errors_total,
                "partitions_total": self.partitions_total,
                "overloaded_total": self.overloaded_total,
                "max_connections": self.max_connections,
                "partitioned": partitioned,
            }

    def prometheus_samples(self) -> list:
        from ..obs.exposition import Sample

        labels = {"server": self.name}
        s = self.stats()
        return [
            Sample("splink_wire_connections_total",
                   s["connections_total"], labels, "counter",
                   "Wire connections accepted"),
            Sample("splink_wire_connections_active",
                   s["connections_active"], labels, "gauge",
                   "Wire connections currently open"),
            Sample("splink_wire_requests_total", s["requests_total"],
                   labels, "counter", "Wire query requests received"),
            Sample("splink_wire_errors_total", s["errors_total"], labels,
                   "counter",
                   "Wire protocol errors (bad frame/version/kind)"),
            Sample("splink_wire_partitions_total", s["partitions_total"],
                   labels, "counter", "Injected/observed partitions"),
            Sample("splink_wire_overloaded_total", s["overloaded_total"],
                   labels, "counter",
                   "Connections refused past the wire_max_connections cap"),
        ]
