"""Multi-host oracle dispatch: a TCP transport in front of the oracle service.

:class:`~repro_torch.serve.oracle_service.OracleService` window-batches
flushes across any number of in-process queries; this module exposes the
same window/plan/commit machinery over TCP so one serving fleet feeds many
*client processes*, and a server can additionally shard its super-batches
over *remote worker hosts* (each running its own scorer). Everything is
stdlib ``socket``/``socketserver``; no new dependencies. The frames and
payloads are the reference package's (``repro.serve.transport``) byte for
byte, so a client of either package talks to a server of the other;
docs/serving.md carries the full protocol spec and deployment topology.

Wire protocol (v1)
------------------
Every message is one length-prefixed binary frame::

    +----------------+----------+---------------------------+
    | length: u32 BE | type: u8 | payload (length - 1 bytes)|
    +----------------+----------+---------------------------+

Message types:

====  ==========  =======================================================
code  name        payload
====  ==========  =======================================================
0x01  EXEC        :class:`repro_torch.core.oracle.LabelRequest` bytes
0x02  RESULT      :class:`repro_torch.core.oracle.LabelResult` bytes (labels)
0x03  ERROR       :class:`LabelResult` bytes (``error`` set, no rows)
0x04  PING        empty
0x05  PONG        empty
0x06  GROUPS      empty (request the server's registered group names)
0x07  GROUPS_OK   ``\\n``-joined utf-8 group names
0x08  HELLO       empty (one-way: announce a query client; no reply)
====  ==========  =======================================================

HELLO is how window assembly knows who to wait for: a query client
(:class:`RemoteOracle`) announces itself on every (re)connect and the
server's service then counts the connection toward window close, exactly
like an attached in-process oracle.  Un-announced connections — monitors,
registration handshakes, or sockets that never send a frame — are never
waited for (a connection's first EXEC also counts as an announcement).

EXEC frames are **pipelined**: a client may keep any number of EXECs in
flight on one connection, each carrying a unique ``request_id``, and the
server answers every EXEC with exactly one RESULT or ERROR — possibly out
of order — on the same connection.  A background reader thread demuxes
replies by id (control replies — PONG, GROUPS_OK — are unnumbered and
matched FIFO, which is safe because the server handles control frames
inline in receive order).  Pipelining is what lets several worker threads
shard one super-batch over a single host connection concurrently, and lets
two in-flight flushes from one client fuse into one server window.  An
ERROR whose ``request_id`` is 0 (the server could not decode the request
far enough to know its id) fails every in-flight request on the connection
— attribution is ambiguous, and an undecodable frame means version skew
anyway.

Semantics and failure model
---------------------------
* **Planning and commit never leave the client.**  A :class:`RemoteOracle`
  is an ordinary :class:`~repro_torch.core.oracle.Oracle` whose ``_label``
  executes on the server, so ``OracleBatch.flush_async()`` gives a remote query
  exactly the local-flush semantics for free: dedup against its *own* cache,
  atomic budget charge on its *own* ledger, retryable atomic failure.  The
  server is a pure labelling fleet — it holds scorers, not ledgers.
* **Reconnect + retry.**  Labelling is pure, and the ledger is charged only
  after a successful round trip, so re-sending an EXEC after a transport
  drop is always safe (no double charge, bit-identical labels).
  :class:`ServiceConnection` retries transport failures (connection refused /
  reset / truncated frame) with backoff; application ERRORs raise
  :class:`RemoteExecutionError` immediately — they are the server telling the
  client something retries won't fix (e.g. an unregistered group).
* **Per-client isolation.**  Each connection gets its own handler thread and
  its own segments in the service queue; one client's failure or disconnect
  completes only that client's futures.
* **Remote workers.**  A worker host runs the same :class:`OracleServiceServer`
  (a server with no downstream is a worker); the front server registers it via
  :meth:`OracleServiceServer.register_worker`, and the service then shards
  each super-batch across local worker threads *and* worker hosts, falling
  back to local execution for any shard whose worker host fails mid-batch.
"""
from __future__ import annotations

import random
import socket
import socketserver
import struct
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable, Optional

import numpy as np

from ..core.oracle import LabelRequest, LabelResult, ModelOracle, Oracle

MSG_EXEC = 0x01
MSG_RESULT = 0x02
MSG_ERROR = 0x03
MSG_PING = 0x04
MSG_PONG = 0x05
MSG_GROUPS = 0x06
MSG_GROUPS_OK = 0x07
MSG_HELLO = 0x08

_LEN = struct.Struct("!I")
# One EXEC of n pairs is ~16n bytes; 256 MiB of frame is ~16M rows — far
# beyond any sane super-batch, so anything larger is a corrupt length prefix.
MAX_FRAME = 1 << 28


class TransportError(ConnectionError):
    """A transport-level failure (drop, truncation, corrupt frame) — the
    retryable class of failure."""


class RemoteExecutionError(RuntimeError):
    """The server executed the request and reports an application error
    (unknown group, backend failure).  Not retried by the transport: the
    flush fails atomically client-side and the *flush* can be retried once
    the cause is fixed, exactly like a local backend error."""


def send_frame(sock: socket.socket, mtype: int, payload: bytes = b"") -> None:
    sock.sendall(_LEN.pack(1 + len(payload)) + bytes([mtype]) + payload)


def recv_frame(sock: socket.socket) -> tuple[int, bytes]:
    """Read one frame; raises :class:`TransportError` on EOF/truncation."""
    hdr = _recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(hdr)
    if not 1 <= length <= MAX_FRAME:
        raise TransportError(f"corrupt frame length {length}")
    body = _recv_exact(sock, length)
    return body[0], body[1:]


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise TransportError("connection closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


# ---- client side -----------------------------------------------------------


class ServiceConnection:
    """One pipelined client connection with reconnect-and-retry.

    ``execute`` frames an EXEC, registers a per-request future keyed by
    ``request_id``, and awaits it; a background reader thread demuxes every
    reply on the connection to its future, so any number of caller threads
    keep requests in flight concurrently on the one socket.  On a transport
    failure (drop, truncation, reply timeout) every in-flight request on
    that connection epoch fails with :class:`TransportError` and each caller
    independently reconnects and re-sends with capped, jittered exponential
    backoff — safe because the server's labelling is pure and commit happens
    on the caller's side only after success.

    Epochs make reconnects race-free: each physical connect bumps an epoch
    counter, futures are registered under the epoch they were sent on, and
    a dying reader fails only its own epoch's futures — never requests that
    already moved to the replacement connection.
    """

    def __init__(self, address: tuple[str, int], retries: int = 5,
                 backoff_s: float = 0.05, max_backoff_s: float = 2.0,
                 timeout_s: float = 120.0, announce: bool = False,
                 tracker=None):
        from ..obs import NULL_TRACKER, NoopTracker

        self.address = (str(address[0]), int(address[1]))
        # observability (repro_torch.obs): RTT per round trip,
        # reconnect/backoff events, in-flight depth; a NoopTracker keeps the
        # hooks free
        self.tracker = tracker if tracker is not None else NULL_TRACKER
        self._tracking = not isinstance(self.tracker, NoopTracker)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.timeout_s = float(timeout_s)
        # announce=True sends HELLO on every (re)connect: query clients do,
        # so the server's windows wait for them from the moment they connect;
        # control-plane connections (worker registration, monitors) don't
        self.announce = bool(announce)
        self.reconnects = 0           # observability: transport drops survived
        self._sock: Optional[socket.socket] = None
        self._epoch = 0               # bumped per physical connect
        self._lock = threading.Lock()       # connection + routing-table state
        self._send_lock = threading.Lock()  # frame writes are atomic
        self._seq = 0                       # globally monotonic request ids
        self._pending: dict[int, tuple[int, Future]] = {}
        self._ctrl: deque = deque()         # FIFO (epoch, Future) for PONG/…
        # control replies carry no request id, so they match their futures
        # by wire order; serializing control round trips (they are rare —
        # health checks and the worker handshake) keeps that trivial while
        # EXECs pipeline freely
        self._ctrl_lock = threading.Lock()

    # -- lifecycle --

    def connect(self) -> bool:
        """Open the connection now instead of at the first round trip, so the
        server counts this client toward window assembly immediately (a
        late-connecting client fragments the windows its peers are already
        filling).  Returns False if the server is not reachable yet — the
        next round trip will retry."""
        try:
            with self._lock:
                self._ensure()
            return True
        except OSError:
            return False

    def _ensure(self) -> tuple[socket.socket, int]:
        """(lock held) Current socket + its epoch, connecting if needed."""
        if self._sock is None:
            sock = socket.create_connection(self.address,
                                            timeout=self.timeout_s)
            # no read timeout after connect: the reader blocks on recv for
            # the connection's whole life (an announced client may idle far
            # longer than timeout_s between flushes); per-request deadlines
            # are enforced caller-side on the future instead
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.announce:
                send_frame(sock, MSG_HELLO)     # one-way, no reply expected
            self._sock = sock
            if self._epoch:         # any connect after the first survived a
                self.reconnects += 1  # drop — count it even when the reader
                self.tracker.count("transport.reconnects")
                self.tracker.event("transport.reconnect",
                                   address=f"{self.address[0]}:"
                                           f"{self.address[1]}")
            self._epoch += 1          # noticed before a caller had to retry
            threading.Thread(target=self._read_loop,
                             args=(sock, self._epoch),
                             name="oracle-conn-reader", daemon=True).start()
        return self._sock, self._epoch

    def _drop(self) -> None:
        if self._sock is not None:
            # shut down before closing: a bare close() does not wake the
            # reader thread blocked in recv() on this socket (nor send the
            # peer a FIN), so the reader would outlive its connection
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        self._fail_epoch(self._sock, None,
                         TransportError("connection closed"), drop=True)

    def __enter__(self) -> "ServiceConnection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reply demux --

    def _read_loop(self, sock: socket.socket, epoch: int) -> None:
        """Reader thread: one per connection epoch.  Routes numbered replies
        to their futures, control replies FIFO, and on any read failure fails
        every future of this epoch (callers then reconnect-retry)."""
        try:
            while True:
                mtype, payload = recv_frame(sock)
                if mtype in (MSG_RESULT, MSG_ERROR):
                    res = LabelResult.from_bytes(payload)
                    if mtype == MSG_ERROR and not res.request_id:
                        # the server could not decode a request far enough to
                        # know its id — attribution over a pipelined stream is
                        # ambiguous, so every in-flight request fails (the
                        # connection itself is still good: keep it)
                        self._fail_epoch(sock, epoch,
                                         RemoteExecutionError(res.error),
                                         drop=False)
                        continue
                    with self._lock:
                        entry = self._pending.pop(res.request_id, None)
                    if entry is None:       # reply raced a caller's timeout
                        continue
                    _, fut = entry
                    if mtype == MSG_ERROR:
                        fut.set_exception(RemoteExecutionError(res.error))
                    else:
                        fut.set_result(res)
                else:                       # PONG / GROUPS_OK / unknown
                    with self._lock:
                        fut = None
                        while self._ctrl:
                            e, f = self._ctrl.popleft()
                            if e == epoch:
                                fut = f
                                break
                    if fut is not None:
                        fut.set_result((mtype, payload))
        except Exception as e:  # noqa: BLE001 — any read failure kills epoch
            exc = e if isinstance(e, TransportError) else TransportError(
                f"{type(e).__name__}: {e}")
            self._fail_epoch(sock, epoch, exc, drop=True)

    def _fail_epoch(self, sock: Optional[socket.socket],
                    epoch: Optional[int], exc: Exception,
                    drop: bool) -> None:
        """Fail every in-flight future of ``epoch`` (all epochs if None) and,
        if ``drop``, retire the socket so the next attempt reconnects."""
        with self._lock:
            if drop and self._sock is sock:
                self._drop()
            doomed = [rid for rid, (e, _) in self._pending.items()
                      if epoch is None or e == epoch]
            victims = [self._pending.pop(rid)[1] for rid in doomed]
            keep = deque((e, f) for e, f in self._ctrl
                         if epoch is not None and e != epoch)
            victims += [f for e, f in self._ctrl
                        if epoch is None or e == epoch]
            self._ctrl = keep
        for fut in victims:
            if not fut.done():
                fut.set_exception(exc)

    # -- round trips --

    def _backoff(self, attempt: int) -> float:
        """Capped exponential backoff with full jitter: the cap keeps a long
        outage from stretching sleeps unboundedly, the jitter keeps a fleet
        of clients from reconnecting to a restarted server in lockstep."""
        base = min(self.backoff_s * (2 ** attempt), self.max_backoff_s)
        return base * (0.5 + random.random())

    def _submit(self, register, send) -> Future:
        """One attempt: connect if needed, register the reply future under
        the connection's epoch, write the frame.  A failed write fails the
        whole epoch (frame boundaries are lost once a sendall splits)."""
        with self._lock:
            sock, epoch = self._ensure()
            fut: Future = Future()
            register(epoch, fut)
        try:
            with self._send_lock:
                send(sock)
        except (TransportError, OSError) as e:
            self._fail_epoch(sock, epoch, TransportError(str(e)), drop=True)
        return fut

    def _await(self, fut: Future):
        """Block on a reply future with the per-request deadline; a timeout
        is a transport failure (kill the connection so in-flight peers retry
        too, rather than queueing behind a wedged server)."""
        try:
            return fut.result(timeout=self.timeout_s)
        except _FutureTimeout:
            with self._lock:
                sock, epoch = self._sock, self._epoch
            exc = TransportError(f"no reply within {self.timeout_s}s")
            self._fail_epoch(sock, epoch, exc, drop=True)
            raise exc from None

    def execute(self, group: str, idx: np.ndarray) -> np.ndarray:
        """Label ``idx`` through the server-side ``group``; returns (n,)
        float64 labels.  Raises :class:`RemoteExecutionError` on application
        errors, :class:`TransportError` when the server stays unreachable.
        Concurrent calls pipeline over the one connection."""
        idx = np.asarray(idx)
        if idx.ndim == 1:
            idx = idx[:, None]
        with self._lock:
            self._seq += 1
            rid = self._seq
        payload = LabelRequest(group=group, idx=idx,
                               request_id=rid).to_bytes()
        last: Exception = TransportError("no attempt made")
        for attempt in range(self.retries + 1):
            try:
                t0 = time.perf_counter()
                fut = self._submit(
                    lambda epoch, f: self._pending.__setitem__(
                        rid, (epoch, f)),
                    lambda sock: send_frame(sock, MSG_EXEC, payload),
                )
                if self._tracking:
                    self.tracker.gauge("transport.inflight",
                                       len(self._pending))
                res = self._await(fut)
            except (TransportError, OSError) as e:
                last = e
                if attempt < self.retries:
                    delay = self._backoff(attempt)
                    if self._tracking:
                        self.tracker.count("transport.retries")
                        self.tracker.event("transport.backoff",
                                           attempt=attempt, delay_s=delay)
                    time.sleep(delay)
                continue
            if len(res.labels) != len(idx):
                raise TransportError(
                    f"reply carries {len(res.labels)} labels for "
                    f"{len(idx)} rows"
                )
            if self._tracking:
                self.tracker.observe("transport.rtt_ms",
                                     (time.perf_counter() - t0) * 1e3)
                self.tracker.gauge("transport.inflight", len(self._pending))
            return res.labels
        raise TransportError(
            f"{self.address[0]}:{self.address[1]} unreachable after "
            f"{self.retries + 1} attempts: {last}"
        ) from last

    def _control(self, mtype: int, expect: int) -> bytes:
        """Unnumbered request/reply (GROUPS, PING) with the same
        reconnect-retry loop as ``execute``.  At most one control request is
        in flight per connection (``_ctrl_lock``) so wire-order matching of
        the unnumbered replies stays unambiguous."""
        last: Exception = TransportError("no attempt made")
        with self._ctrl_lock:
            for attempt in range(self.retries + 1):
                try:
                    fut = self._submit(
                        lambda epoch, f: self._ctrl.append((epoch, f)),
                        lambda sock: send_frame(sock, mtype),
                    )
                    rtype, payload = self._await(fut)
                except (TransportError, OSError) as e:
                    last = e
                    if attempt < self.retries:
                        time.sleep(self._backoff(attempt))
                    continue
                if rtype != expect:
                    raise TransportError(
                        f"unexpected reply type 0x{rtype:02x}")
                return payload
        raise TransportError(
            f"{self.address[0]}:{self.address[1]} unreachable after "
            f"{self.retries + 1} attempts: {last}"
        ) from last

    def groups(self) -> tuple[str, ...]:
        """The server's registered group names (the worker handshake)."""
        text = self._control(MSG_GROUPS, MSG_GROUPS_OK).decode("utf-8")
        return tuple(g for g in text.split("\n") if g)

    def ping(self) -> bool:
        try:
            self._control(MSG_PING, MSG_PONG)
            return True
        except (TransportError, RemoteExecutionError):
            return False


class RemoteOracle(Oracle):
    """An Oracle whose ``_label`` executes on a remote
    :class:`OracleServiceServer` — the client half of multi-host dispatch.

    Because this is an ordinary :class:`~repro_torch.core.oracle.Oracle`, the
    whole batching stack composes unchanged: ``OracleBatch`` plans/commits
    against the local cache and ledger, ``flush_async()`` keeps the submit-then-await
    protocol, and attaching a *local* ``OracleService`` on the client side
    additionally overlaps the network round trip with the query's cheap work
    and coalesces multiple local queries before they ever hit the wire
    (RemoteOracles sharing a server address + group share a service group).
    """

    def __init__(self, address: tuple[str, int], group: str = "default",
                 retries: int = 5, backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0, timeout_s: float = 120.0,
                 tracker=None):
        super().__init__()
        self.group = str(group)
        self.conn = ServiceConnection(address, retries=retries,
                                      backoff_s=backoff_s,
                                      max_backoff_s=max_backoff_s,
                                      timeout_s=timeout_s, announce=True,
                                      tracker=tracker)
        self.conn.connect()     # best-effort: count toward windows early

    def _label(self, idx: np.ndarray) -> np.ndarray:
        return self.conn.execute(self.group, idx)

    def service_group(self):
        # flat str/int parts so a shared LabelStore can persist segments for
        # this group (label_io only stores JSON-scalar key components)
        host, port = self.conn.address
        return ("remote", host, int(port), self.group)

    def close(self) -> None:
        """Drop the connection (the server sees a disconnect and stops
        counting this client toward window assembly)."""
        self.conn.close()

    def __enter__(self) -> "RemoteOracle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ThroughputEWMA:
    """Thread-safe rows/s exponentially-weighted moving average for one
    shard executor (the local pool or one worker host).

    ``OracleService._execute`` sizes super-batch shards in proportion to
    these rates, so a host that labels half as fast gets roughly half the
    rows — uniform splits make every super-batch as slow as the slowest
    host.  The first sample seeds the average (no zero-warmup bias);
    later samples blend in with weight ``alpha``, so a host that speeds
    up or slows down re-converges within a few windows."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._rate = 0.0
        self._samples = 0

    def update(self, rows: int, seconds: float) -> float:
        """Fold one measured shard into the average; degenerate samples
        (no rows, or a timer resolution of zero) are dropped."""
        if rows <= 0 or seconds <= 0.0:
            return self.rate
        sample = rows / seconds
        with self._lock:
            if self._samples == 0:
                self._rate = sample
            else:
                self._rate += self.alpha * (sample - self._rate)
            self._samples += 1
            return self._rate

    @property
    def rate(self) -> float:
        """Current rows/s estimate; 0.0 until the first sample lands."""
        with self._lock:
            return self._rate

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples


class RemoteWorkerClient:
    """The front server's handle on one worker host: a
    :class:`ServiceConnection` plus the group names the worker advertised at
    registration.  ``OracleService._execute`` routes super-batch shards here.
    """

    def __init__(self, address: tuple[str, int], retries: int = 2,
                 backoff_s: float = 0.05, max_backoff_s: float = 2.0,
                 timeout_s: float = 120.0, tracker=None):
        self.conn = ServiceConnection(address, retries=retries,
                                      backoff_s=backoff_s,
                                      max_backoff_s=max_backoff_s,
                                      timeout_s=timeout_s, tracker=tracker)
        self.groups: frozenset = frozenset(self.conn.groups())

    @property
    def address(self) -> tuple[str, int]:
        return self.conn.address

    def execute(self, group: str, idx: np.ndarray) -> np.ndarray:
        return self.conn.execute(group, idx)

    def ping(self) -> bool:
        """One health probe; the service's checker drives re-registration."""
        return self.conn.ping()

    def refresh_groups(self) -> frozenset:
        """Re-fetch the worker's advertised groups (a restarted host may
        serve a different set); called on health-check rejoin."""
        self.groups = frozenset(self.conn.groups())
        return self.groups

    def close(self) -> None:
        self.conn.close()


# ---- server side -----------------------------------------------------------


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True      # restart-in-place (tests, rolling deploys)
    daemon_threads = True
    owner: "OracleServiceServer"


class _Handler(socketserver.BaseRequestHandler):
    """One connected client: count it toward window assembly, answer frames
    until EOF.  One thread per connection (ThreadingTCPServer) keeps reading
    while EXECs execute asynchronously — replies are written from service
    callbacks when each future resolves, which is what makes client-side
    pipelining (several EXECs in flight on one connection) actually overlap
    server-side instead of queueing behind the first future."""

    def handle(self) -> None:
        owner = self.server.owner
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # interleaved replies from concurrent futures must not split frames
        self._wlock = threading.Lock()
        owner._track(self.request, add=True)
        # window assembly waits only for ANNOUNCED connections: a query
        # client HELLOs at connect (and its first EXEC counts as an implicit
        # announcement), while control-plane traffic — PING health checks,
        # the GROUPS handshake of a front registering this host as a worker,
        # or a socket that never sends a frame at all — is never waited for.
        # An announced client that then only sends control frames is demoted
        # again, so a stray HELLO can't make every window run to the deadline.
        client_id = None
        counted, seen_exec = False, False
        try:
            while True:
                try:
                    mtype, payload = recv_frame(self.request)
                except (TransportError, OSError):
                    return                      # client went away
                if mtype == MSG_HELLO:
                    if not counted:
                        client_id = owner.service.client_connected()
                        counted = True
                    continue
                if mtype == MSG_EXEC:
                    if not counted:
                        client_id = owner.service.client_connected()
                        counted = True
                    seen_exec = True
                    self._exec(owner, client_id, payload)
                    continue
                if not seen_exec and counted:   # control-plane connection
                    owner.service.client_disconnected(client_id)
                    counted = False
                if mtype == MSG_PING:
                    with self._wlock:
                        send_frame(self.request, MSG_PONG)
                elif mtype == MSG_GROUPS:
                    names = "\n".join(sorted(owner.groups))
                    with self._wlock:
                        send_frame(self.request, MSG_GROUPS_OK,
                                   names.encode("utf-8"))
                else:
                    res = LabelResult(error=f"ProtocolError: unknown message "
                                            f"type 0x{mtype:02x}")
                    with self._wlock:
                        send_frame(self.request, MSG_ERROR, res.to_bytes())
        finally:
            if counted:
                owner.service.client_disconnected(client_id)
            owner._track(self.request, add=False)

    def _reply(self, mtype: int, res: LabelResult) -> None:
        """Write one reply frame; a failing send means the client is gone —
        swallow it (the reader loop will notice EOF and clean up) rather
        than crash whichever service thread delivered the result."""
        try:
            with self._wlock:
                send_frame(self.request, mtype, res.to_bytes())
        except OSError:
            pass

    def _exec(self, owner: "OracleServiceServer", client_id: int,
              payload: bytes) -> None:
        try:
            req = LabelRequest.from_bytes(payload)
        except Exception as e:
            # a deterministic protocol error (version skew, corrupt segment)
            # must be an ERROR reply, not a dropped connection the client
            # would misread as "server unreachable" and retry-loop against
            self._reply(MSG_ERROR, LabelResult(
                error=f"ProtocolError: undecodable EXEC "
                      f"payload ({type(e).__name__}: {e})"))
            return
        fn = owner.groups.get(req.group)
        if fn is None:
            self._reply(MSG_ERROR, LabelResult(
                request_id=req.request_id,
                error=f"RemoteExecutionError: unknown group "
                      f"{req.group!r} (registered: "
                      f"{sorted(owner.groups)})"))
            return

        def _deliver(fut) -> None:
            try:
                labels = fut.result()
                mtype = MSG_RESULT
                res = LabelResult(request_id=req.request_id, labels=labels)
            except BaseException as e:  # noqa: BLE001 — isolate per client
                # ANY execution failure — including a backend raising
                # OSError — is an application error the client must see as
                # ERROR (no transport retry)
                mtype = MSG_ERROR
                res = LabelResult(request_id=req.request_id,
                                  error=f"{type(e).__name__}: {e}")
            self._reply(mtype, res)

        try:
            fut = owner.service.submit_raw(req.group, fn, req.idx,
                                           client_id=client_id)
        except BaseException as e:  # noqa: BLE001
            self._reply(MSG_ERROR, LabelResult(
                request_id=req.request_id,
                error=f"{type(e).__name__}: {e}"))
            return
        # reply when the window resolves — NOT inline — so this thread goes
        # straight back to recv and further pipelined EXECs from the same
        # client can join the window this one is still waiting on
        fut.add_done_callback(_deliver)


class OracleServiceServer:
    """TCP front-end over an
    :class:`~repro_torch.serve.oracle_service.OracleService`.

    ``groups`` maps wire group names to vectorised label functions
    ``fn(idx: (n, k) int array) -> (n,) float labels`` — e.g. a thresholded
    :class:`~repro_torch.serve.serve_loop.PairScorer` (see
    :func:`scorer_group`).
    Segments arriving on different connections coalesce into the service's
    windows exactly like in-process flushes, fuse into per-group super-batches,
    and shard over the service's worker threads and any registered worker
    hosts.

    A server with no registered downstream workers *is* a worker host: run the
    same class on each host and point the front server at the others via
    :meth:`register_worker`.
    """

    def __init__(self, groups: dict[str, Callable], host: str = "127.0.0.1",
                 port: int = 0, service=None, **service_kwargs):
        from .oracle_service import OracleService

        self.groups = dict(groups)
        self.service = service if service is not None else OracleService(
            **service_kwargs
        )
        self._owns_service = service is None
        self._workers: list[RemoteWorkerClient] = []
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._tcp = _Server((host, int(port)), _Handler)
        self._tcp.owner = self
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, name="oracle-server", daemon=True
        )
        self._thread.start()

    @property
    def address(self) -> tuple[str, int]:
        """The bound (host, port) — resolves ``port=0`` to the real port."""
        return self._tcp.server_address[:2]

    def register_worker(self, address: tuple[str, int]) -> RemoteWorkerClient:
        """Connect a worker host and hand it to the service: super-batches
        for any group the worker advertises now shard across hosts.  The
        worker's connection reports into the service's tracker, and the
        service health-checks the host (re-registering it after an outage)."""
        worker = RemoteWorkerClient(address,
                                    tracker=self.service.tracker)
        self._workers.append(worker)
        self.service.register_remote_worker(worker)
        return worker

    def _track(self, sock: socket.socket, add: bool) -> None:
        with self._conns_lock:
            (self._conns.add if add else self._conns.discard)(sock)

    def close(self) -> None:
        """Stop accepting, drop live connections (clients observe a transport
        drop and reconnect-retry elsewhere — or to a restarted server on the
        same port), close worker handles, and shut the service if owned."""
        self._tcp.shutdown()
        self._tcp.server_close()
        self._thread.join()
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        for w in self._workers:
            w.close()
        if self._owns_service:
            self.service.close()

    def __enter__(self) -> "OracleServiceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def scorer_group(scorer, threshold: float = 0.5) -> Callable:
    """Adapt a pair scorer (``PairScorer`` instance or any vectorised
    probability callable) into a wire group's label function.  Literally
    :class:`~repro_torch.core.oracle.ModelOracle`'s own ``_label`` (the
    throwaway oracle's cache/ledger are never touched), so remote and
    in-process execution are bit-identical by construction."""
    return ModelOracle(scorer, threshold=threshold)._label


def parse_address(spec: str, default_port: int = 7431) -> tuple[str, int]:
    """``"host[:port]"`` -> (host, port) for CLI flags."""
    host, _, port = spec.partition(":")
    return (host or "127.0.0.1", int(port) if port else default_port)


__all__ = [
    "MSG_EXEC", "MSG_RESULT", "MSG_ERROR", "MSG_PING", "MSG_PONG",
    "MSG_GROUPS", "MSG_GROUPS_OK", "MSG_HELLO",
    "TransportError", "RemoteExecutionError",
    "send_frame", "recv_frame",
    "ServiceConnection", "RemoteOracle", "RemoteWorkerClient",
    "OracleServiceServer", "scorer_group", "parse_address",
]
