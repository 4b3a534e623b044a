"""The socket message plane: framing, auth, channels, reconnect (the port's
copy of kubedl_tpu/transport/plane.py, byte for byte the same wire).

One ``TransportPlane`` per process endpoint: it LISTENS on one TCP port
(``KUBEDL_TRANSPORT_BIND``) and DIALS any number of peers, multiplexing
named logical channels over per-peer connections. The wire carries the
consumers' payloads (RL records, serialized KV npz) OPAQUELY: the plane
moves bytes, the consumers keep their own encodings. A JAX plane and a
port plane talk to each other in both directions.

Frame format (all integers big-endian):

    magic(4)=KDTP | type(1) | header_len(4) | header JSON | payload_len(8) | payload

Types: HELLO (token + boot id, first frame of every connection), WELCOME
(the accept side echoes ITS boot id), MSG ({channel, tag, boot, seq}),
ACK (per-MSG, the exactly-once commit point), REJECT (auth refusal),
PING/PONG (heartbeats). A frame that stops mid-payload is a torn frame:
the reader drops the connection and nothing is committed: a message is
either fully in the inbox or absent.

Auth: every connection's HELLO carries the shared per-job token
(``KUBEDL_TRANSPORT_TOKEN``), compared in constant time at accept
(hmac.compare_digest); a bad token gets REJECT + close and a counter,
and no frame from an unauthenticated connection is ever committed.

Exactly-once: the dialer holds a per-peer lock (one in-flight MSG per
connection), waits for the ACK, and on a dropped connection reconnects
with bounded exponential backoff and RESENDS the frame; the accept side
dedups by (channel, tag) before committing, so a resend of a message
whose ACK was lost is dropped, not delivered twice.

Boot ids: each plane stamps a random incarnation id into HELLO/WELCOME
and every MSG. With ``latch=True`` (the default) a peer's id is latched on
first contact and a CHANGE is refused loudly on both sides: the dialer
refuses to reconnect to a restarted listener, and a restarted sender's
message is REJECTed (its send raises; never ACKed, nothing committed)
while the receiving channel poisons itself so pending recvs fail too.
Planes whose peers legitimately restart between messages pass
``latch=False``.
"""
from __future__ import annotations

import hmac
import json
import os
import socket
import struct
import threading
import time
import uuid
from typing import Callable, Dict, Optional, Tuple

from kubedl_tpu_torch.transport.metrics import transport_metrics

ENV_TRANSPORT = "KUBEDL_TRANSPORT"  # socket | dir
ENV_TOKEN = "KUBEDL_TRANSPORT_TOKEN"
ENV_BIND = "KUBEDL_TRANSPORT_BIND"

_MAGIC = b"KDTP"
_HELLO, _WELCOME, _MSG, _ACK, _REJECT, _PING, _PONG = range(1, 8)
# sanity bounds: a corrupt length prefix must fail the frame, not
# allocate gigabytes
_MAX_HEADER = 1 << 20
_MAX_PAYLOAD = 1 << 34


class TransportError(RuntimeError):
    """Loud transport failure — auth refused, peer incarnation changed,
    reconnect budget exhausted. Never swallowed into silent data loss."""


class _ConnClosed(ConnectionError):
    """Peer closed cleanly BETWEEN frames — not a torn frame."""


def _recv_exact(sock: socket.socket, n: int, eof_ok: bool = False) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            if eof_ok and not buf:
                raise _ConnClosed("peer closed")
            raise ConnectionError(
                f"connection closed {len(buf)}/{n} bytes into a frame")
        buf.extend(chunk)
    return bytes(buf)


def _send_frame(sock: socket.socket, ftype: int, header: Dict,
                payload: bytes = b"") -> None:
    hbytes = json.dumps(header).encode("utf-8")
    sock.sendall(
        _MAGIC + bytes([ftype]) + struct.pack(">I", len(hbytes)) + hbytes
        + struct.pack(">Q", len(payload)) + payload)


def _recv_frame(sock: socket.socket) -> Tuple[int, Dict, bytes]:
    head = _recv_exact(sock, 9, eof_ok=True)
    if head[:4] != _MAGIC:
        raise ConnectionError("bad frame magic")
    ftype = head[4]
    hlen = struct.unpack(">I", head[5:9])[0]
    if hlen > _MAX_HEADER:
        raise ConnectionError(f"frame header length {hlen} out of bounds")
    header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    plen = struct.unpack(">Q", _recv_exact(sock, 8))[0]
    if plen > _MAX_PAYLOAD:
        raise ConnectionError(f"frame payload length {plen} out of bounds")
    return ftype, header, _recv_exact(sock, plen)


class _Inbox:
    """One logical channel's receive side: tag -> payload (insertion
    ordered), exactly-once dedup, and the sender-boot latch."""

    def __init__(self, latch: bool) -> None:
        self._cond = threading.Condition()
        self._msgs: Dict[str, bytes] = {}
        self._delivered: Dict[str, None] = {}  # bounded tag memory
        self._boot: Optional[str] = None
        self._err: Optional[TransportError] = None
        self._latch = latch

    def commit(self, tag: str, data: bytes, boot: str) -> str:
        """Deliver one message; returns "ok", "dup" (an already-committed
        resend — the caller ACKs, first copy won), or "stale" (a changed
        sender incarnation — the caller must REJECT, never ACK)."""
        with self._cond:
            if self._latch and boot:
                if self._boot is None:
                    self._boot = boot
                elif boot != self._boot:
                    # a restarted sender: poison the channel so every
                    # pending and future recv fails loud (the consumer's
                    # gang restart drains it), and refuse the stale data
                    self._err = TransportError(
                        f"message {tag!r} carries peer incarnation "
                        f"{boot!r} != latched {self._boot!r} — the peer "
                        f"restarted; refusing its messages")
                    transport_metrics.on_stale_boot()
                    self._cond.notify_all()
                    return "stale"
            if tag in self._delivered:
                return "dup"
            self._delivered[tag] = None
            if len(self._delivered) > 8192:
                self._delivered.pop(next(iter(self._delivered)))
            self._msgs[tag] = data
            self._cond.notify_all()
            return "ok"

    def recv(self, tag: str, timeout: float) -> bytes:
        deadline = time.monotonic() + timeout
        with self._cond:
            while tag not in self._msgs:
                if self._err is not None:
                    raise self._err
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"transport recv timed out waiting for {tag!r}")
                self._cond.wait(left)
            return self._msgs.pop(tag)

    def pop_any(self) -> Optional[Tuple[str, bytes]]:
        with self._cond:
            if self._err is not None:
                raise self._err
            if not self._msgs:
                return None
            tag = next(iter(self._msgs))
            return tag, self._msgs.pop(tag)

    def take(self, tag: str) -> Optional[bytes]:
        with self._cond:
            return self._msgs.pop(tag, None)

    def purge(self) -> int:
        with self._cond:
            n = len(self._msgs)
            self._msgs.clear()
            return n


class _Peer:
    """One cached outbound connection: dial + HELLO/WELCOME handshake,
    synchronous MSG->ACK sends under a lock, reconnect with bounded
    exponential backoff and resend on failure."""

    def __init__(self, plane: "TransportPlane", addr: str) -> None:
        self.plane = plane
        self.addr = addr
        self.lock = threading.Lock()
        self.sock: Optional[socket.socket] = None
        self.boot: Optional[str] = None  # latched listener incarnation
        self._seq = 0

    # -- connection management (caller holds self.lock) -----------------

    def _dial_once(self) -> socket.socket:
        host, _, port = self.addr.rpartition(":")
        sock = socket.create_connection(
            (host or "127.0.0.1", int(port)), timeout=self.plane.io_timeout)
        sock.settimeout(self.plane.io_timeout)
        try:
            _send_frame(sock, _HELLO, {
                "token": self.plane.token, "boot": self.plane.boot_id,
                "peer": self.plane.service})
            ftype, header, _ = _recv_frame(sock)
        except BaseException:
            sock.close()
            raise
        if ftype == _REJECT:
            sock.close()
            raise TransportError(
                f"peer {self.addr} rejected the connection: "
                f"{header.get('error', 'auth')}")
        if ftype != _WELCOME:
            sock.close()
            raise ConnectionError(f"expected WELCOME, got frame {ftype}")
        boot = str(header.get("boot", ""))
        if self.plane.latch and self.boot is not None and boot != self.boot:
            sock.close()
            transport_metrics.on_stale_boot()
            raise TransportError(
                f"peer {self.addr} came back as incarnation {boot!r} != "
                f"latched {self.boot!r} — it restarted; refusing to "
                f"resume (restart this side for a clean rendezvous)")
        self.boot = boot
        return sock

    def _connect(self, budget_s: float, reconnect: bool) -> None:
        """Dial with exponential backoff until `budget_s` is spent; an
        auth/incarnation refusal is permanent and raises immediately."""
        deadline = time.monotonic() + budget_s
        backoff = self.plane.retry_backoff
        attempt = 0
        t0 = time.perf_counter()
        while True:
            attempt += 1
            try:
                self.sock = self._dial_once()
                transport_metrics.on_connect(reconnect=reconnect)
                self.plane._trace(
                    "transport.reconnect" if reconnect else "transport.connect",
                    duration_s=time.perf_counter() - t0,
                    peer=self.addr, attempts=attempt)
                return
            except TransportError:
                raise  # auth / incarnation: retrying cannot fix it
            except OSError as e:
                if time.monotonic() + backoff > deadline:
                    raise TransportError(
                        f"could not {'re' if reconnect else ''}connect to "
                        f"{self.addr} after {attempt} attempts over "
                        f"{budget_s:.1f}s: {e}") from e
                time.sleep(backoff)
                backoff = min(backoff * 2, 2.0)

    def _drop(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    # -- requests --------------------------------------------------------

    def send_msg(self, channel: str, tag: str, data: bytes,
                 timeout: Optional[float] = None) -> None:
        """Send one message and wait for its ACK; on a dropped
        connection, reconnect and RESEND (the accept side dedups)."""
        timeout = self.plane.io_timeout if timeout is None else timeout
        with self.lock:
            self._seq += 1
            seq = self._seq
            header = {"channel": channel, "tag": tag,
                      "boot": self.plane.boot_id, "seq": seq}
            for resend in range(self.plane.max_resends + 1):
                try:
                    if self.sock is None:
                        self._connect(
                            self.plane.dial_budget_s if not resend
                            else self.plane.reconnect_budget_s,
                            reconnect=bool(resend))
                    self.sock.settimeout(timeout)
                    _send_frame(self.sock, _MSG, header, data)
                    while True:
                        ftype, h, _ = _recv_frame(self.sock)
                        if ftype == _ACK and int(h.get("seq", -1)) == seq:
                            break
                        if ftype == _PONG:
                            continue  # a late heartbeat reply
                        if ftype == _REJECT:
                            # permanent refusal (stale incarnation):
                            # resending cannot fix it — fail loud NOW
                            self._drop()
                            raise TransportError(
                                f"peer {self.addr} refused "
                                f"{channel}/{tag}: "
                                f"{h.get('error', 'rejected')}")
                        raise ConnectionError(
                            f"expected ACK {seq}, got frame {ftype}")
                    transport_metrics.on_message(channel, "send", len(data))
                    return
                except (OSError, ConnectionError, socket.timeout):
                    self._drop()
                    if resend >= self.plane.max_resends:
                        raise TransportError(
                            f"send of {channel}/{tag} to {self.addr} failed "
                            f"after {resend + 1} attempts") from None

    def ping(self) -> None:
        with self.lock:
            if self.sock is None:
                return  # nothing to keep alive
            try:
                self.sock.settimeout(self.plane.io_timeout)
                _send_frame(self.sock, _PING, {})
                ftype, _, _ = _recv_frame(self.sock)
                if ftype != _PONG:
                    raise ConnectionError(f"expected PONG, got {ftype}")
                transport_metrics.on_heartbeat()
            except (OSError, ConnectionError, socket.timeout):
                self._drop()  # next send reconnects (and resends)

    def close(self) -> None:
        with self.lock:
            self._drop()


class SocketChannel:
    """One named logical channel on a plane — the socket peer of
    ``QueueChannel``/``DirChannel``: ``send(tag, data)`` dials the fixed
    peer address, ``recv(tag, timeout)`` reads the LOCAL plane's inbox.
    The payload bytes are carried opaquely (byte-identical boundary
    encoding is the consumer's contract, pinned in tests)."""

    def __init__(self, plane: "TransportPlane", name: str,
                 peer_addr: str = "") -> None:
        self.plane = plane
        self.name = name
        self.peer_addr = peer_addr

    def send(self, tag: str, data: bytes) -> None:
        if not self.peer_addr:
            raise TransportError(
                f"channel {self.name!r} has no peer address to send to")
        self.plane.send(self.peer_addr, self.name, tag, data)

    def recv(self, tag: str, timeout: float = 60.0) -> bytes:
        return self.plane.recv(self.name, tag, timeout)

    def poll(self) -> Optional[Tuple[str, bytes]]:
        """Earliest pending (tag, payload), or None — the control
        channel's non-blocking step-boundary check."""
        return self.plane._inbox(self.name).pop_any()

    def purge(self) -> int:
        return self.plane._inbox(self.name).purge()


class TransportPlane:
    """One process endpoint of the message plane: a listener plus cached
    outbound peer connections, multiplexing named channels."""

    def __init__(
        self,
        token: str = "",
        service: str = "",
        latch: bool = True,
        io_timeout: float = 60.0,
        dial_budget_s: float = 60.0,
        reconnect_budget_s: float = 10.0,
        retry_backoff: float = 0.05,
        max_resends: int = 4,
        heartbeat_s: float = 0.0,
        tracer=None,
    ) -> None:
        self.token = token
        self.service = service or f"pid-{os.getpid()}"
        self.latch = latch
        self.io_timeout = io_timeout
        self.dial_budget_s = dial_budget_s
        self.reconnect_budget_s = reconnect_budget_s
        self.retry_backoff = retry_backoff
        self.max_resends = max_resends
        self.heartbeat_s = heartbeat_s
        self.boot_id = uuid.uuid4().hex[:12]
        self.bound_addr = ""
        self._tracer = tracer
        self._server: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._conns: list = []
        self._peers: Dict[str, _Peer] = {}
        self._inboxes: Dict[str, _Inbox] = {}
        self._subs: Dict[str, Callable[[str, bytes], None]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()

    def _trace(self, name: str, duration_s: float = 0.0, **attrs) -> None:
        """transport.connect / transport.reconnect spans on the job's
        flight-recorder timeline (lazy tracer_from_env: exports only when
        the executor injected KUBEDL_TRACE_DIR, ring-only otherwise)."""
        if self._tracer is None:
            try:
                from kubedl_tpu_torch.obs.trace import tracer_from_env

                self._tracer = tracer_from_env(self.service)
            except Exception:  # noqa: BLE001 — tracing must never block I/O
                self._tracer = False
        if self._tracer:
            try:
                self._tracer.record(name, duration_s=duration_s, **attrs)
            except Exception:  # noqa: BLE001 — tracing must never block I/O
                pass

    # -- listen side -----------------------------------------------------

    def listen(self, addr: str = "0.0.0.0:0") -> str:
        """Bind + start the accept loop; returns the bound host:port
        (the port resolved when `addr` asked for :0)."""
        host, _, port = addr.rpartition(":")
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host or "0.0.0.0", int(port or 0)))
        srv.listen(64)
        # timeout-based accept so close() can stop the loop and the
        # port frees promptly (a blocked accept pins the fd open)
        srv.settimeout(0.2)
        self._server = srv
        self.bound_addr = f"{host or '127.0.0.1'}:{srv.getsockname()[1]}"
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"transport-{self.service}",
            daemon=True)
        self._accept_thread.start()
        if self.heartbeat_s > 0:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, daemon=True,
                name=f"transport-hb-{self.service}")
            self._hb_thread.start()
        return self.bound_addr

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # closed
            conn.settimeout(None)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True).start()
        try:
            self._server.close()
        except OSError:
            pass

    def _serve_conn(self, conn: socket.socket) -> None:
        """One accepted connection: HELLO (constant-time token check)
        then MSG/PING frames until close. A frame that stops partway is
        a TORN frame: the connection drops with nothing committed."""
        authed = False
        try:
            conn.settimeout(self.io_timeout)
            ftype, header, _ = _recv_frame(conn)
            if ftype != _HELLO or not hmac.compare_digest(
                    str(header.get("token", "")), self.token):
                # unauthenticated frames are dropped with a counter; the
                # REJECT lets the dialer fail loud instead of hanging
                transport_metrics.on_auth_failure()
                try:
                    _send_frame(conn, _REJECT, {"error": "auth"})
                except OSError:
                    pass
                return
            _send_frame(conn, _WELCOME, {"boot": self.boot_id})
            conn.settimeout(None)  # idle connections are fine
            authed = True
            while not self._stop.is_set():
                ftype, header, payload = _recv_frame(conn)
                if ftype == _PING:
                    _send_frame(conn, _PONG, {})
                    continue
                if ftype != _MSG:
                    continue  # unknown frame type: ignore, stay connected
                channel = str(header.get("channel", ""))
                tag = str(header.get("tag", ""))
                boot = str(header.get("boot", ""))
                inbox = self._inbox(channel)
                sub = self._subs.get(channel)
                status = inbox.commit(tag, payload, boot)
                if status == "stale":
                    # a restarted sender: REJECT (never ACK — the ACK is
                    # the commit point, and nothing was committed) so
                    # its send fails loud IMMEDIATELY instead of
                    # computing against a poisoned receiver
                    _send_frame(conn, _REJECT,
                                {"error": "stale-incarnation"})
                    return
                if status == "ok":
                    transport_metrics.on_message(channel, "recv", len(payload))
                    if sub is not None:
                        inbox.take(tag)  # the callback consumes it
                        try:
                            sub(tag, payload)
                        except Exception:  # noqa: BLE001 — a subscriber
                            pass  # bug must not kill the connection
                # ACK dedup'd resends too: the first copy WAS committed
                _send_frame(conn, _ACK, {"seq": header.get("seq")})
        except _ConnClosed:
            pass  # clean close between frames
        except (ConnectionError, OSError, ValueError):
            if authed:
                transport_metrics.on_torn_frame()
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _hb_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            with self._lock:
                peers = list(self._peers.values())
            for p in peers:
                p.ping()

    # -- dial side -------------------------------------------------------

    def _peer(self, addr: str) -> _Peer:
        with self._lock:
            p = self._peers.get(addr)
            if p is None:
                p = self._peers[addr] = _Peer(self, addr)
            return p

    def send(self, addr: str, channel: str, tag: str, data: bytes,
             timeout: Optional[float] = None) -> None:
        self._peer(addr).send_msg(channel, tag, data, timeout)

    def recv(self, channel: str, tag: str, timeout: float = 60.0) -> bytes:
        return self._inbox(channel).recv(tag, timeout)

    def _inbox(self, channel: str) -> _Inbox:
        with self._lock:
            box = self._inboxes.get(channel)
            if box is None:
                box = self._inboxes[channel] = _Inbox(self.latch)
            return box

    def channel(self, name: str, peer_addr: str = "") -> SocketChannel:
        return SocketChannel(self, name, peer_addr)

    def subscribe(self, channel: str,
                  fn: Callable[[str, bytes], None]) -> None:
        """Route a channel's messages to a callback (run on the
        connection thread) instead of leaving them for recv()."""
        self._subs[channel] = fn

    def close(self) -> None:
        self._stop.set()
        # the accept loop owns the final server close (its blocked
        # accept() otherwise pins the fd — and the port — open)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2)
        elif self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        with self._lock:
            conns, self._conns = self._conns, []
            peers = list(self._peers.values())
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for p in peers:
            p.close()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)


def plane_from_env(
    service: str = "",
    latch: bool = True,
    env: Optional[Dict[str, str]] = None,
) -> Optional[TransportPlane]:
    """Build + start this pod's plane from the executor-injected env
    (the way KUBEDL_CONTROL_DIR travels): None unless
    ``KUBEDL_TRANSPORT=socket``. Listens on ``KUBEDL_TRANSPORT_BIND``
    (default any-interface ephemeral) with ``KUBEDL_TRANSPORT_TOKEN``."""
    env = os.environ if env is None else env
    if env.get(ENV_TRANSPORT, "") != "socket":
        return None
    token = env.get(ENV_TOKEN, "")
    if not token:
        # an empty token would make hmac.compare_digest("", "") pass at
        # accept — i.e. an UNAUTHENTICATED plane. Refuse to listen: the
        # per-job isolation the plane advertises must not silently not
        # exist (the executor/controller always injects one)
        raise ValueError(
            "KUBEDL_TRANSPORT=socket requires a non-empty "
            "KUBEDL_TRANSPORT_TOKEN (the shared per-job auth secret)")
    plane = TransportPlane(
        token=token,
        service=service or env.get("POD_NAME", ""),
        latch=latch,
    )
    plane.listen(env.get(ENV_BIND, "0.0.0.0:0"))
    return plane
