"""Socket transport for threshold-encoded gradient sharing — the process-
boundary half of the reference's gradient-sharing regime. Port of
``deeplearning4j_tpu/parallel/transport.py``: every wire format is the
reference's, byte for byte, so a worker or hub of either package talks to
the other's. Plain host Python and numpy: a caller on the card crosses to
the host explicitly (``.cpu()``) before a frame is packed.

Reference parity: ``org.deeplearning4j.optimize.solvers.accumulation.
EncodedGradientsAccumulator`` + Aeron UDP transport (deeplearning4j-
scaleout ``gradientsharing``): workers exchange ±threshold sparse token
streams over the wire, every worker applies the same decoded aggregate,
residual error feedback keeps the compression lossless over time. (Here
``DistributedGradientWorker.step`` returns the decoded MEAN — divide-by-
workers — so the learning rate keeps its single-worker meaning; the
upstream accumulator applies the raw sum and expects lr scaled
accordingly.)

Within one host's ranks the dense all-reduce of ``ParallelWrapper`` is the
path; this transport is for the slow-interconnect regime the reference
built Aeron for. Design:
a tiny hub (``GradientExchangeServer``) stands in for Aeron multicast —
each round it gathers one length-prefixed frame per worker and broadcasts
the full set back. Frames carry the SENDER's threshold so adaptive
thresholds may drift per worker without corrupting decode. TCP and Unix
domain sockets supported (``address=("127.0.0.1", port)`` or a filesystem
path).

Wire format per frame:
  uint32  payload byte length (tokens only)
  float32 sender threshold
  int64[] tokens (threshold_encode output)
Broadcast reply: uint32 worker count, then the workers' frames in order.

This module also owns the SCALEOUT frame protocol (kind-tagged frames
used by ``parallel/scaleout.py``'s parameter-averaging hub) — both wire
formats live here so every socket-facing byte layout is in one file.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import List, Optional, Tuple, Union

import numpy as np

from ..obs import get_registry
from ..utils.native import threshold_decode, threshold_encode
from .grad_sharing import AdaptiveThreshold

Address = Union[str, Tuple[str, int]]

_HDR = struct.Struct("<If")  # payload bytes, sender threshold


# ---------------------------------------------------------------------------
# Scaleout frame protocol (parameter-averaging hub <-> worker).
# One frame per message, little-endian:
#   uint8   kind
#   uint32  payload byte length
#   bytes   payload (kind-specific, see below)
# ---------------------------------------------------------------------------

FRAME_HEADER = struct.Struct("<BI")      # kind, payload bytes

KIND_PARAMS = 0     # worker -> hub: float32[] flat params contributing
#                     to the round; hub -> worker reply: uint32 round
#                     index + float32[] round mean (the round header
#                     keys a worker's round by the hub's own counter —
#                     elastic membership can't skew it)
KIND_DONE = 1       # worker -> hub: partition finished, leaving the job
KIND_HELLO = 2      # uint32 worker id — first frame on every connect, so
#                     the hub's worker labels are the CALLER's ids (a
#                     known id on a fresh connection is a REJOIN)
KIND_SPANCTX = 3    # hub -> worker right after HELLO: the master's span
#                     context header (empty payload = tracing off)
KIND_REJOIN = 4     # hub -> worker after SPANCTX: uint32 current round,
#                     uint32 registered worker id (echoed so a
#                     uniquified duplicate dialer learns its hub-side
#                     identity),
#                     then float32[] current mean params (absent = no
#                     round completed yet) — a (re)joiner starts from the
#                     job's live state instead of its stale local params
KIND_LEASE_REQ = 5  # worker -> hub: request a partition lease (empty)
KIND_LEASE = 6      # hub -> worker: uint8 grant status (leases.GRANT_*),
#                     then uint32 item id when status == GRANT_OK
KIND_LEASE_DONE = 7  # worker -> hub: uint32 item id completed (no ack —
#                     a completion lost with the connection is re-run,
#                     the at-least-once half of the lease contract)
KIND_FLEET_SUBMIT = 8   # router -> replica: one leased generation request
#                     (see pack_fleet_submit for the payload layout)
KIND_FLEET_RESULT = 9   # replica -> router: the finished request — lease
#                     item id + generated tokens + finish reason; the
#                     router's RequestLeaseTable.complete() decides
#                     whether this result wins (exactly-once) or is a
#                     ghost from a presumed-dead replica (dropped)


# ---------------------------------------------------------------------------
# Fleet frame payloads. The FleetRouter's in-process replica
# handles round-trip every submit/result through these packers, so the
# byte layout is exercised by every request and a socket-backed replica
# host can slot in behind the same boundary. Little-endian:
#
#   FLEET_SUBMIT: uint32 item, uint32 max_new_tokens, float32 temperature,
#                 int32 top_k (0 = off), int32 eos_id (-1 = none),
#                 uint8 kind (RequestKind wire byte),
#                 uint8 beam_width (0 = default, BEAM only),
#                 uint8 pooling (EMBED only: 0 = mean, 1 = last),
#                 uint32 allowlist length, int32[] allowed token ids
#                 (CONSTRAINED only; 0 = no mask),
#                 uint16 session byte length, session bytes (utf-8),
#                 uint32 prompt length, int32[] prompt token ids
#   FLEET_RESULT: uint32 item, uint8 reason byte length, reason (utf-8),
#                 uint8 kind (RequestKind wire byte),
#                 uint32 token count, int32[] generated token ids,
#                 uint32 float count, float32[] kind payload (SCORE:
#                 per-token logprobs; EMBED: the pooled embedding;
#                 BEAM: [best total logprob]; else empty)
# ---------------------------------------------------------------------------

_FLEET_SUBMIT_HDR = struct.Struct("<IIfiiBBB")
_FLEET_RESULT_HDR = struct.Struct("<IB")


def pack_fleet_submit(item: int, prompt_ids, max_new_tokens: int,
                      temperature: float = 0.0, top_k: int = 0,
                      eos_id: Optional[int] = None,
                      session_id: Optional[str] = None,
                      kind: int = 0, beam_width: int = 0,
                      pooling: int = 0, allowed_ids=None) -> bytes:
    sess = (session_id or "").encode()
    if len(sess) > 0xFFFF:
        raise ValueError("session_id too long for wire format")
    ids = np.ascontiguousarray(np.asarray(prompt_ids, np.int32))
    allow = np.ascontiguousarray(np.asarray(
        [] if allowed_ids is None else allowed_ids, np.int32))
    return (_FLEET_SUBMIT_HDR.pack(item, max_new_tokens, float(temperature),
                                   int(top_k or 0),
                                   -1 if eos_id is None else int(eos_id),
                                   int(kind), int(beam_width),
                                   int(pooling))
            + struct.pack("<I", allow.size) + allow.tobytes()
            + struct.pack("<H", len(sess)) + sess
            + struct.pack("<I", ids.size) + ids.tobytes())


def unpack_fleet_submit(payload: bytes) -> dict:
    (item, max_new, temp, top_k, eos, kind, beam_width,
     pooling) = _FLEET_SUBMIT_HDR.unpack_from(payload)
    off = _FLEET_SUBMIT_HDR.size
    (na,) = struct.unpack_from("<I", payload, off)
    off += 4
    allow = np.frombuffer(payload, np.int32, count=na, offset=off).copy()
    off += 4 * na
    (slen,) = struct.unpack_from("<H", payload, off)
    off += 2
    sess = payload[off:off + slen].decode()
    off += slen
    (n,) = struct.unpack_from("<I", payload, off)
    off += 4
    ids = np.frombuffer(payload, np.int32, count=n, offset=off).copy()
    return {"item": item, "prompt_ids": ids, "max_new_tokens": max_new,
            "temperature": temp, "top_k": top_k or None,
            "eos_id": None if eos == -1 else eos,
            "session_id": sess or None,
            "kind": kind, "beam_width": beam_width, "pooling": pooling,
            "allowed_ids": allow if na else None}


def pack_fleet_result(item: int, token_ids, reason: str,
                      kind: int = 0, floats=None) -> bytes:
    rb = reason.encode()
    if len(rb) > 0xFF:
        raise ValueError("finish reason too long for wire format")
    ids = np.ascontiguousarray(np.asarray(token_ids, np.int32))
    fl = np.ascontiguousarray(np.asarray(
        [] if floats is None else floats, np.float32))
    return (_FLEET_RESULT_HDR.pack(item, len(rb)) + rb
            + struct.pack("<B", int(kind))
            + struct.pack("<I", ids.size) + ids.tobytes()
            + struct.pack("<I", fl.size) + fl.tobytes())


def unpack_fleet_result(payload: bytes) -> dict:
    item, rlen = _FLEET_RESULT_HDR.unpack_from(payload)
    off = _FLEET_RESULT_HDR.size
    reason = payload[off:off + rlen].decode()
    off += rlen
    (kind,) = struct.unpack_from("<B", payload, off)
    off += 1
    (n,) = struct.unpack_from("<I", payload, off)
    off += 4
    ids = np.frombuffer(payload, np.int32, count=n, offset=off).copy()
    off += 4 * n
    (nf,) = struct.unpack_from("<I", payload, off)
    off += 4
    floats = np.frombuffer(payload, np.float32, count=nf,
                           offset=off).copy()
    return {"item": item, "token_ids": ids, "reason": reason,
            "kind": kind, "floats": floats}


def send_frame(conn: socket.socket, kind: int, payload: bytes = b""):
    conn.sendall(FRAME_HEADER.pack(kind, len(payload)) + payload)


def recv_frame(conn: socket.socket) -> Tuple[int, bytes]:
    kind, nbytes = FRAME_HEADER.unpack(_recv_exact(conn, FRAME_HEADER.size))
    payload = _recv_exact(conn, nbytes) if nbytes else b""
    return kind, bytes(payload)


def backoff_delays(base: float, cap: float, n: int) -> List[float]:
    """The bounded exponential-backoff schedule used by scaleout's
    ``WorkerClient``: delay before retry i is ``min(cap, base * 2**i)``.
    Pure so the fast suite can pin the schedule."""
    return [min(cap, base * (2 ** i)) for i in range(max(0, n))]


# ---------------------------------------------------------------------------
# Span-context wire encoding — the cross-transport half of obs.spans.
# A SpanContext serializes to its JSON header (empty payload = no trace);
# scaleout's hub sends one frame of this to every worker on connect, so a
# master round and its worker fits share one trace tree.
# ---------------------------------------------------------------------------

def pack_span_context(ctx) -> bytes:
    """``SpanContext | None`` -> wire payload bytes."""
    return b"" if ctx is None else ctx.to_header().encode()


def unpack_span_context(payload: bytes):
    """Wire payload -> ``SpanContext | None`` (tolerates garbage: a trace
    header must never take down a training job)."""
    from ..obs.spans import SpanContext
    if not payload:
        return None
    try:
        return SpanContext.from_header(payload.decode())
    except UnicodeDecodeError:
        return None


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = conn.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("gradient peer closed the connection")
        got += r
    return buf   # bytearray: both consumers (struct.unpack, np.frombuffer)
                 # take buffer objects — bytes(buf) would re-copy the frame


def _recv_frame(conn: socket.socket) -> Tuple[np.ndarray, float]:
    nbytes, threshold = _HDR.unpack(_recv_exact(conn, _HDR.size))
    payload = _recv_exact(conn, nbytes) if nbytes else b""
    return np.frombuffer(payload, np.int64).copy(), threshold


def _send_frame(conn: socket.socket, tokens: np.ndarray, threshold: float):
    payload = np.ascontiguousarray(tokens, np.int64).tobytes()
    conn.sendall(_HDR.pack(len(payload), threshold) + payload)


def _make_socket(address: Address) -> socket.socket:
    if isinstance(address, str):
        return socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    return socket.socket(socket.AF_INET, socket.SOCK_STREAM)


class GradientExchangeServer:
    """All-gather hub: waits for ``n_workers`` connections, then per round
    collects one frame from each worker and broadcasts the full set back.
    Runs in a daemon thread; ``stop()`` (or any worker disconnect after
    training) shuts it down."""

    def __init__(self, n_workers: int, address: Address = ("127.0.0.1", 0)):
        self.n_workers = n_workers
        self._sock = _make_socket(address)
        if not isinstance(address, str):
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(address)
        self._sock.listen(n_workers)
        # short accept timeout: close() from another thread does not
        # interrupt a blocked accept() on Linux, so the serve loop polls
        # the stop flag
        self._sock.settimeout(0.25)
        self.address = self._sock.getsockname()
        self._conns: List[socket.socket] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.rounds = 0

    def start(self) -> "GradientExchangeServer":
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        return self

    def _serve(self):
        try:
            while len(self._conns) < self.n_workers:
                if self._stop.is_set():
                    return
                try:
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    continue
                conn.settimeout(None)
                if conn.family == socket.AF_INET:
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._conns.append(conn)
            while not self._stop.is_set():
                frames = [_recv_frame(c) for c in self._conns]
                count = struct.pack("<I", len(frames))
                for c in self._conns:
                    c.sendall(count)
                    for tokens, thr in frames:
                        _send_frame(c, tokens, thr)
                self.rounds += 1
                get_registry().counter(
                    "dl4j_gradex_rounds_total",
                    "Gradient-exchange all-gather rounds served").inc()
        except OSError:
            pass  # workers done / stop() closed the socket
        finally:
            for c in self._conns:
                try:
                    c.close()
                except OSError:
                    pass

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        # unblock a serve thread parked in _recv_frame on a live worker
        for c in self._conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if isinstance(self.address, (str, bytes)):
            import os
            try:
                os.unlink(self.address)
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)


class SocketGradientTransport:
    """Worker-side connection to a GradientExchangeServer."""

    def __init__(self, address: Address, timeout: Optional[float] = None):
        """``timeout=None`` (default) blocks indefinitely in the all-gather
        — stragglers (per-worker XLA compile, checkpoint pauses) routinely
        exceed any fixed budget in the slow-interconnect regime this
        transport targets; pass a timeout only for fail-fast tests."""
        self._sock = _make_socket(address)
        self._sock.settimeout(timeout)
        self._sock.connect(tuple(address) if not isinstance(address, str)
                           else address)
        if self._sock.family == socket.AF_INET:
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def exchange(self, tokens: np.ndarray,
                 threshold: float) -> List[Tuple[np.ndarray, float]]:
        """Send this worker's frame; block until every worker's frame
        arrives (the all-gather round)."""
        _send_frame(self._sock, tokens, threshold)
        (count,) = struct.unpack("<I", _recv_exact(self._sock, 4))
        return [_recv_frame(self._sock) for _ in range(count)]

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class DistributedGradientWorker:
    """Per-PROCESS gradient-sharing worker (reference: one
    EncodedGradientsAccumulator per machine on the Aeron bus).

    ``step`` takes the POST-UPDATER update (e.g. lr·grad or the Adam step)
    — the same contract as upstream, which encodes updates after the
    updater, NOT raw gradients: the threshold lives in update space, so
    the adaptive controller can track the training phase (large quanta
    early, fine quanta near convergence — this is what makes encoded-
    sparse training converge equivalently to dense; a gradient-space
    threshold cannot, because the lr rescaling hides the movement scale).
    Residual error feedback keeps the stream lossless over time.

    The returned mean update is identical on every worker, so identically-
    initialized replicas stay bit-identical — the property the 2-process
    convergence test asserts."""

    def __init__(self, n_params: int, transport: SocketGradientTransport,
                 threshold: float = 1e-3, adaptive: bool = True,
                 target_sparsity: float = 0.1):
        self.n_params = n_params
        self.transport = transport
        self.residual = np.zeros(n_params, np.float32)
        self.adaptive = AdaptiveThreshold(
            threshold, target_sparsity=target_sparsity, decay=1.5,
            max_threshold=10.0) if adaptive else None
        self.threshold = threshold
        self.last_encoded = 0

    def step(self, update: np.ndarray) -> np.ndarray:
        """Encode + exchange this worker's local update; returns the mean
        decoded update across all workers (apply as ``w -= result``)."""
        tokens = threshold_encode(
            np.asarray(update, np.float32).ravel(), self.residual,
            self.threshold)
        self.last_encoded = int(tokens.size)
        frames = self.transport.exchange(tokens, self.threshold)
        out = np.zeros(self.n_params, np.float32)
        for peer_tokens, peer_thr in frames:
            out += threshold_decode(peer_tokens, peer_thr, self.n_params)
        if self.adaptive is not None:
            self.threshold = self.adaptive.update(self.last_encoded,
                                                  self.n_params)
        return out / len(frames)

    def residual_norm(self) -> float:
        return float(np.linalg.norm(self.residual))
