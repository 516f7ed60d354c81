"""Cluster-level training orchestration — the Spark-scaleout analogue,
elastic and fault-tolerant. Port of
``deeplearning4j_tpu/parallel/scaleout.py``: the same hub, worker client,
job runner, wire frames, checkpoint stamp, metrics and spans.

Reference parity: ``deeplearning4j-scaleout/spark``'s
``SparkDl4jMultiLayer`` / ``SparkComputationGraph`` +
``ParameterAveragingTrainingMaster``, including the executor
re-provisioning contract: a JOB master that provisions workers, leases
the data partitions out, runs averaging-frequency-paced
parameter-averaging rounds over a master hub, survives worker AND
master failure mid-job, and checkpoints the averaged model (atomically)
between rounds for resume.

Within one host's ranks, ``ParallelWrapper`` /
``ParameterAveragingTrainer`` average over ``torch.distributed`` — use
those. This job is the layer above: separate worker threads,
processes or hosts with no shared runtime (the regime Spark executors
occupy), coordinated over TCP/Unix sockets.

Everything on the wire and in the hub is host numpy. A worker's params
cross the host boundary explicitly: :func:`host_params` reads
``net.params_flat()`` to the host once a round (a card-to-host copy on
the card), and ``net.set_params_flat(mean)`` copies the round mean into
the net's existing tensors in place, so the compiled train step's
captured graphs stay valid across rounds. Workers provisioned as threads
on the card each fit their own ``net.clone()`` with its own compiled
step; captures from several threads are safe (see ``nn/_compiled.py``).

The elasticity contract:

- **Worker rejoin.** The hub's accept thread stays alive for the whole
  job (not just the first ``n_workers`` connections). A HELLO carrying
  a known-or-new worker id mid-job is answered with the master's span
  context AND a REJOIN ack (current round + current mean params), so a
  restarted worker enters the next averaging round from the job's live
  state. ``dl4j_scaleout_rejoins_total`` counts re-attachments.
- **Master restart.** ``SparkDl4jMultiLayer.fit`` resumes from
  ``checkpoint_dir`` when an interrupted job's stamp is present
  (``latest.zip`` + ``round.txt`` + ``leases.json``; a completed job
  deletes the lease stamp): params reload, round numbering continues,
  and only unfinished lease items re-run. ``WorkerClient`` retries
  connect/recv with bounded exponential backoff, so workers survive the
  hub's death and re-attach to the restarted hub instead of hanging
  forever. ``dl4j_scaleout_master_restarts_total`` counts resumes.
- **Partition leasing.** Data is no longer statically partitioned at
  spawn: the hub holds a ``LeaseTable`` of ``(epoch, shard)`` work
  items and workers lease them one at a time (affinity reproduces the
  old round-robin split while everyone is alive). A dead worker's
  unfinished leases return to the pool and are re-granted to a survivor
  or rejoiner (``dl4j_scaleout_leases_reassigned_total``) — job output
  covers every partition regardless of the failure schedule.
- **Concurrent gather.** Each worker connection gets its own hub-side
  handler thread; a round closes as soon as every live worker's frame
  has landed, or at a deadline (``worker_timeout`` after the first
  frame) — one hung straggler times out alone instead of stalling the
  healthy workers' recv loop head-of-line.

Wire protocol: kind-tagged frames, one per message — layouts live in
``parallel/transport.py`` (``KIND_PARAMS/DONE/HELLO/SPANCTX`` plus the
elastic ``KIND_REJOIN/LEASE_REQ/LEASE/LEASE_DONE``).

Telemetry (the port's ``obs``): rounds / drops / rejoins /
reassignments / restarts under ``dl4j_scaleout_*``, and span context
propagates master -> worker over the wire so a master round and its
worker fits stitch into ONE trace tree (round ids derived
deterministically via ``derived_span_id(trace, "round", k)``).

Not ported: the reference's per-round replica drift audit (it rides the
reference's numerics plane, which the port does not have).
"""

from __future__ import annotations

import contextlib
import os
import socket
import struct
import threading
import time
import uuid
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..obs import SpanContext, derived_span_id, get_registry, get_tracer
from ..obs.spans import Span
from .leases import GRANT_NONE, GRANT_OK, GRANT_RETRY, LeaseTable
from .transport import (Address, KIND_DONE, KIND_HELLO, KIND_LEASE,
                        KIND_LEASE_DONE, KIND_LEASE_REQ, KIND_PARAMS,
                        KIND_REJOIN, KIND_SPANCTX, _make_socket,
                        backoff_delays, pack_span_context, recv_frame,
                        send_frame, unpack_span_context)

_SOCK_ERRORS = (ConnectionError, socket.timeout, OSError)


def host_params(net) -> np.ndarray:
    """``net.params_flat()`` as host float32 numpy: one explicit
    card-to-host copy for a net on the card (``np.asarray`` of a CUDA
    tensor raises), a no-op view for a host array."""
    flat = net.params_flat()
    if isinstance(flat, torch.Tensor):
        flat = flat.detach().to("cpu", torch.float32).numpy()
    return np.asarray(flat, np.float32)


class MasterDiedError(RuntimeError):
    """The master hub died mid-job (fault injection or crash); the job
    is resumable from ``checkpoint_dir``."""


class TrainingMaster:
    """Configuration interface (reference ``TrainingMaster``)."""

    def __init__(self, *, batch_size_per_worker: int = 32,
                 averaging_frequency: int = 5, n_workers: int = 2,
                 epochs_per_fit: int = 1,
                 worker_timeout: float = 120.0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every_rounds: int = 1,
                 worker_retries: int = 3,
                 worker_backoff: float = 0.5):
        if averaging_frequency < 1:
            raise ValueError("averaging_frequency must be >= 1")
        self.batch_size_per_worker = batch_size_per_worker
        self.averaging_frequency = averaging_frequency
        self.n_workers = n_workers
        self.epochs_per_fit = epochs_per_fit
        self.worker_timeout = worker_timeout
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_rounds = max(1, checkpoint_every_rounds)
        # bounded reconnect-with-backoff budget handed to every worker's
        # WorkerClient — how long a worker survives a master outage
        self.worker_retries = max(0, worker_retries)
        self.worker_backoff = worker_backoff


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Reference ``ParameterAveragingTrainingMaster``: sync param
    averaging every ``averaging_frequency`` worker iterations."""


def atomic_write_text(path, text: str):
    """Write ``text`` to ``path`` via a temp file + ``os.replace`` so a
    crash mid-write can never leave a torn artifact (the between-round
    checkpoint the master-restart path depends on)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def read_resume_state(ckdir) -> Optional[Tuple[int, str]]:
    """``(round, lease-snapshot-json)`` from a between-round checkpoint,
    or None when there is no interrupted job to resume: a COMPLETED job
    deletes ``leases.json``, and a missing/corrupt stamp means fresh.
    Because ``round.txt`` is written LAST (after ``latest.zip`` and
    ``leases.json``), its presence implies the others are whole."""
    ckdir = Path(ckdir)
    rt, lj = ckdir / "round.txt", ckdir / "leases.json"
    if not (rt.exists() and lj.exists()):
        return None
    try:
        return int(rt.read_text().strip()), lj.read_text()
    except (ValueError, OSError):
        return None


# ---------------------------------------------------------------------------
# Master-side hub
# ---------------------------------------------------------------------------

class ParamAveragingHub:
    """Master-side hub for parameter-averaging rounds with elasticity.

    One accept thread (alive for the whole job — rejoiners welcome) plus
    one handler thread per worker connection. A round gathers
    concurrently: it closes when every live worker's params frame has
    landed, or ``worker_timeout`` after the first frame (stragglers time
    out alone). ``result()`` waits for the job to drain and returns the
    final averaged flat params (None if no round ever completed).
    """

    def __init__(self, n_workers: int, address: Address = ("127.0.0.1", 0),
                 worker_timeout: float = 120.0,
                 on_round: Optional[Callable[[np.ndarray, int], None]] = None,
                 span_ctx=None, lease_table: Optional[LeaseTable] = None,
                 start_round: int = 0,
                 initial_params: Optional[np.ndarray] = None,
                 fail_after_rounds: Optional[int] = None):
        self.n_workers = n_workers
        self.worker_timeout = worker_timeout
        self.on_round = on_round
        self.span_ctx = span_ctx  # master trace context, sent to workers
        self._table = lease_table
        self.start_round = int(start_round)
        self.rounds = int(start_round)      # absolute round counter
        self.fail_after_rounds = fail_after_rounds
        self.fail_injected = False
        self._initial_params = None if initial_params is None else \
            np.asarray(initial_params, np.float32)
        self._sock = _make_socket(address)
        if not isinstance(address, str):
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        else:
            # AF_UNIX restart-same-path: clear a stale socket file here,
            # and NEVER unlink on stop — a dying hub must not tear down
            # the path its restarted successor may have already bound
            with contextlib.suppress(OSError):
                os.unlink(address)
        self._sock.bind(address)
        self._sock.listen(max(n_workers, 8))
        self.address = self._sock.getsockname()
        self.dropped: List[int] = []
        self.rejoins = 0
        self._final: Optional[np.ndarray] = None
        self._last_mean: Optional[np.ndarray] = None
        # --- round barrier state (all guarded by _cv) ---
        self._cv = threading.Condition()
        self._live: Dict[int, socket.socket] = {}
        self._ever: Set[int] = set()
        self._frames: Dict[int, np.ndarray] = {}
        self._means: Dict[int, Tuple[np.ndarray, int]] = {}  # wid ->
        # (round mean, hub round index) — the index rides the PARAMS
        # reply so workers key their rounds by the hub's counter
        self._deadline: Optional[float] = None
        self._round_t0: Optional[Tuple[float, float]] = None
        self._after_q: List[tuple] = []
        self._draining = False
        self._stopped = False
        self._provisioned = False        # first n_workers all said HELLO
        self._t0 = time.monotonic()
        self._reassigned_seen = 0
        self._threads: List[threading.Thread] = []
        self._accept_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ParamAveragingHub":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="dl4j-param-hub")
        self._accept_thread.start()
        return self

    @property
    def stopped(self) -> bool:
        return self._stopped

    def result(self, timeout: Optional[float] = None) -> Optional[np.ndarray]:
        """Wait for the job to drain (every registered worker done or
        dropped) and return the final averaged params; shuts the hub
        down on the way out."""
        with self._cv:
            self._cv.wait_for(
                lambda: self._stopped or (self._ever and not self._live),
                timeout)
        self.stop()
        return self._final

    def stop(self, join: bool = True):
        with self._cv:
            already = self._stopped
            self._stopped = True
            conns = list(self._live.values())
            self._live.clear()
            self._cv.notify_all()
        if already and not join:
            return
        get_registry().gauge("dl4j_scaleout_live_workers",
                             "Workers currently in the averaging round").set(0)
        try:
            self._sock.close()
        except OSError:
            pass
        for c in conns:
            with contextlib.suppress(OSError):
                c.shutdown(socket.SHUT_RDWR)
            with contextlib.suppress(OSError):
                c.close()
        if join:
            cur = threading.current_thread()
            with self._cv:
                threads = list(self._threads)
                if self._accept_thread is not None:
                    threads.append(self._accept_thread)
            for t in threads:
                if t is not cur and t.is_alive():
                    t.join(timeout=5)

    def wait_dropped(self, wid: int, timeout: Optional[float] = None) -> bool:
        """Block until ``wid`` is no longer live (the hub has processed
        its death) — lets a supervisor respawn the worker under the SAME
        id so the fresh HELLO reads as a rejoin, not a live duplicate."""
        with self._cv:
            return self._cv.wait_for(
                lambda: wid not in self._live or self._stopped, timeout)

    # ------------------------------------------------------------ accept
    def _accept_loop(self):
        # short accept timeout: close() from another thread does NOT
        # interrupt a blocked accept() on Linux, so poll the stop flag
        self._sock.settimeout(0.25)
        while not self._stopped:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return                      # stop() closed the socket
            try:
                conn.settimeout(min(self.worker_timeout, 10.0))
                kind, payload = recv_frame(conn)
                wid = struct.unpack("<I", payload)[0] \
                    if kind == KIND_HELLO and len(payload) == 4 \
                    else len(self._ever)
                conn.settimeout(self.worker_timeout)
            except (*_SOCK_ERRORS, struct.error):
                with contextlib.suppress(OSError):
                    conn.close()
                continue
            wid = self._register(wid, conn)
            try:
                # reply with the master's trace context (empty = off) and
                # the REJOIN ack: current round + current mean (empty
                # params = no round yet) — the (re)joiner starts from the
                # job's live state
                send_frame(conn, KIND_SPANCTX,
                           pack_span_context(self.span_ctx))
                with self._cv:
                    rnd = self.rounds
                    mean = self._last_mean if self._last_mean is not None \
                        else self._initial_params
                # the ack echoes the REGISTERED wid: a live-duplicate
                # dialer was uniquified by _register and learns its
                # hub-side identity
                ack = struct.pack("<II", rnd, wid) + \
                    (mean.astype(np.float32).tobytes()
                     if mean is not None else b"")
                send_frame(conn, KIND_REJOIN, ack)
            except _SOCK_ERRORS:
                # ALREADY registered: route through _leave so the wid is
                # not leaked in _live (which would hold its lease slot
                # hostage and stall every round to the deadline)
                self._leave(wid, conn, done=False)
                with contextlib.suppress(OSError):
                    conn.close()
                continue
            t = threading.Thread(target=self._handle, args=(wid, conn),
                                 daemon=True, name=f"dl4j-hub-w{wid}")
            with self._cv:
                self._threads.append(t)
            t.start()

    def _register(self, wid: int, conn: socket.socket) -> int:
        reg = get_registry()
        with self._cv:
            if wid in self._live:        # live duplicate id — uniquify
                step = max(1, self.n_workers)
                while wid in self._live or wid in self._ever:
                    wid += step
            rejoin = wid in self._ever
            self._live[wid] = conn
            self._ever.add(wid)
            if len(self._ever) >= self.n_workers:
                self._provisioned = True
            if rejoin:
                self.rejoins += 1
                reg.counter("dl4j_scaleout_rejoins_total",
                            "Workers that re-attached to a live scaleout "
                            "job").inc()
            reg.gauge("dl4j_scaleout_live_workers",
                      "Workers currently in the averaging round"
                      ).set(len(self._live))
            self._cv.notify_all()
        return wid

    # ------------------------------------------------------------ handlers
    def _handle(self, wid: int, conn: socket.socket):
        try:
            while not self._stopped:
                kind, payload = recv_frame(conn)
                if kind == KIND_DONE:
                    self._leave(wid, conn, done=True)
                    return
                if kind == KIND_PARAMS:
                    res = self._contribute(
                        wid, np.frombuffer(payload, np.float32))
                    if res is None:         # hub stopped mid-round
                        return
                    mean, rnd = res
                    # reply = 4-byte round index + f32 mean: the worker
                    # keys its round by the hub's OWN counter, so
                    # elastic membership (stragglers, rejoins) can never
                    # skew it
                    send_frame(conn, KIND_PARAMS,
                               struct.pack("<I", rnd)
                               + mean.astype(np.float32).tobytes())
                elif kind == KIND_LEASE_REQ:
                    status, item = self._grant(wid)
                    pl = bytes([status]) + (struct.pack("<I", item)
                                            if status == GRANT_OK else b"")
                    send_frame(conn, KIND_LEASE, pl)
                elif kind == KIND_LEASE_DONE and len(payload) == 4:
                    if self._table is not None:
                        self._table.complete(
                            wid, struct.unpack("<I", payload)[0])
                # unknown kinds: ignored (forward compatibility)
        except _SOCK_ERRORS:
            self._leave(wid, conn, done=False)
        finally:
            with contextlib.suppress(OSError):
                conn.close()

    def _leave(self, wid: int, conn: socket.socket, done: bool):
        released: List[int] = []
        with self._cv:
            if self._live.get(wid) is not conn:
                return                      # superseded by a rejoin
            del self._live[wid]
            self._frames.pop(wid, None)
            self._means.pop(wid, None)
            if not done:
                self.dropped.append(wid)
                get_registry().counter("dl4j_scaleout_workers_dropped_total",
                                       "Workers dropped mid-job").inc()
                if self._table is not None:
                    released = self._table.release_worker(wid)
            get_registry().gauge("dl4j_scaleout_live_workers",
                                 "Workers currently in the averaging round"
                                 ).set(len(self._live))
            self._maybe_close_locked()
            self._cv.notify_all()
        if not done:
            extra = (f" ({len(released)} lease(s) returned to the pool)"
                     if released else "")
            warnings.warn(f"scaleout: worker {wid} failed mid-job — "
                          f"continuing with the survivors{extra}")
        self._drain_after()

    # ------------------------------------------------------------ rounds
    def _contribute(self, wid: int,
                    vec: np.ndarray) -> Optional[Tuple[np.ndarray, int]]:
        """Deposit ``wid``'s params frame into the current round; block
        until the round containing it closes; return (round mean, round
        index) — None = hub stopped. Rounds close when every live
        worker has contributed, or at the deadline — whichever comes
        first."""
        vec = np.asarray(vec, np.float32)
        with self._cv:
            if self._stopped or self._live.get(wid) is None:
                return None
            self._frames[wid] = vec
            if self._round_t0 is None:
                self._round_t0 = (time.time(), time.perf_counter())
                self._deadline = time.monotonic() + self.worker_timeout
            self._maybe_close_locked()
            while wid not in self._means and not self._stopped:
                rem = (self._deadline - time.monotonic()) \
                    if self._deadline is not None else 0.25
                if rem <= 0:
                    self._close_round_locked()
                    continue
                self._cv.wait(min(rem, 0.25))
            mean = self._means.pop(wid, None)
        self._drain_after()
        return mean

    def _maybe_close_locked(self):
        if not self._frames:
            return
        if not self._provisioned:
            if time.monotonic() - self._t0 < self.worker_timeout:
                return      # provisioning window: wait for the full crew
            self._provisioned = True
        if set(self._frames) >= set(self._live):
            self._close_round_locked()

    def _close_round_locked(self):
        if not self._frames:
            return
        contributors = dict(self._frames)
        self._frames.clear()
        mean = np.mean(list(contributors.values()), axis=0).astype(np.float32)
        self._last_mean = mean
        self._final = mean
        self.rounds += 1
        for w in contributors:
            self._means[w] = (mean, self.rounds)
        self._provisioned = True    # whoever averaged IS the working set
        t0 = self._round_t0
        self._round_t0 = None
        self._deadline = None
        get_registry().counter("dl4j_scaleout_rounds_total",
                               "Parameter-averaging rounds completed").inc()
        self._after_q.append((mean, self.rounds, len(contributors), t0))
        self._cv.notify_all()

    def _drain_after(self):
        """Run queued post-round work (round span, on_round checkpoint)
        OUTSIDE the barrier lock, single-threaded and in round order."""
        while True:
            with self._cv:
                if self._draining or not self._after_q:
                    return
                self._draining = True
                item = self._after_q.pop(0)
            try:
                self._after_round(*item)
            finally:
                with self._cv:
                    self._draining = False

    def _after_round(self, mean: np.ndarray, rnd: int, n_contrib: int,
                     t0: Optional[Tuple[float, float]]):
        # the round span was timed across handler threads (first frame ->
        # close), so it is assembled by hand with the DETERMINISTIC id
        # both wire ends compute — workers parent their fit spans to it
        # without a round-trip
        if self.span_ctx is not None:
            trace, parent = self.span_ctx.trace_id, self.span_ctx.span_id
            sid = derived_span_id(trace, "round", rnd)
        else:
            trace, parent = uuid.uuid4().hex[:16], None
            sid = derived_span_id(trace, "round", rnd)
        start_ts, t0p = t0 if t0 is not None else (time.time(),
                                                  time.perf_counter())
        get_tracer().add_span(Span(
            name="scaleout_round", trace_id=trace, span_id=sid,
            parent_id=parent, start_ts=start_ts,
            time_s=time.perf_counter() - t0p,
            attrs={"round": rnd, "workers": n_contrib}))
        if self.on_round is not None:
            try:
                self.on_round(mean, rnd)
            except Exception as e:  # noqa: BLE001 — checkpointing must
                # never take down the averaging plane
                warnings.warn(f"scaleout: on_round callback failed: {e}")
        if self.fail_after_rounds is not None and \
                rnd - self.start_round >= self.fail_after_rounds:
            # fault injection: the master dies between rounds — workers
            # see dead sockets and retry-reattach; fit raises
            # MasterDiedError and a new fit resumes from the checkpoint
            self.fail_injected = True
            self.stop(join=False)

    # ------------------------------------------------------------ leases
    def _grant(self, wid: int) -> Tuple[int, int]:
        if self._table is None:
            return GRANT_NONE, -1
        nw = self._table.n_workers
        with self._cv:
            live_slots = {w % nw for w in self._live}
            if not self._provisioned and \
                    time.monotonic() - self._t0 >= self.worker_timeout:
                self._provisioned = True
            unsettled = set() if self._provisioned else \
                set(range(nw)) - {w % nw for w in self._ever}
            stealable = set(range(nw)) - live_slots - unsettled
        status, item = self._table.acquire(wid, stealable_slots=stealable,
                                           unsettled_slots=unsettled)
        with self._cv:
            newly = self._table.reassigned - self._reassigned_seen
            if newly > 0:
                get_registry().counter(
                    "dl4j_scaleout_leases_reassigned_total",
                    "Partition leases re-granted after their worker died "
                    "or left").inc(newly)
                self._reassigned_seen = self._table.reassigned
        return status, item


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------

class WorkerClient:
    """Worker-side connection with bounded reconnect-with-backoff.

    ``average(flat)`` every averaging_frequency steps, ``lease()`` /
    ``lease_done(item)`` in lease mode, ``done()`` when finished. With
    ``max_retries > 0``, a dead hub (master restart, network flap) is
    survived transparently: the client re-dials with exponential backoff
    (``backoff_delays``), re-HELLOs under the same worker id (the hub
    counts it as a rejoin), and resends the in-flight frame. Retries
    exhausted -> a clean ``ConnectionError``, never an indefinite hang
    (``timeout`` bounds every socket op; None preserves the legacy
    block-forever behavior for hand-managed deployments)."""

    def __init__(self, address: Address, worker_id: int = 0,
                 timeout: Optional[float] = None, max_retries: int = 0,
                 backoff_base: float = 0.5, backoff_max: float = 8.0):
        self.address = address
        self.worker_id = int(worker_id)
        self.timeout = timeout
        self.max_retries = max(0, int(max_retries))
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.rejoins = 0          # successful re-attaches after a failure
        self.span_ctx: Optional[SpanContext] = None
        self.rejoin_params: Optional[np.ndarray] = None
        self.round_offset = 0     # hub's round counter when we joined
        self.last_round = 0       # hub round of the last average() reply
        self.assigned_id = self.worker_id
        self._sock: Optional[socket.socket] = None
        self._connect()

    # ------------------------------------------------------------ dialing
    def _dial(self):
        sock = _make_socket(self.address)
        sock.settimeout(self.timeout)
        try:
            sock.connect(tuple(self.address)
                         if not isinstance(self.address, str)
                         else self.address)
            send_frame(sock, KIND_HELLO, struct.pack("<I", self.worker_id))
            kind, payload = recv_frame(sock)
            span_ctx = unpack_span_context(payload) \
                if kind == KIND_SPANCTX else None
            kind, payload = recv_frame(sock)
            round_offset, rejoin, assigned = 0, None, self.worker_id
            if kind == KIND_REJOIN and len(payload) >= 8:
                round_offset, assigned = struct.unpack("<II", payload[:8])
                if len(payload) > 8:
                    rejoin = np.frombuffer(payload[8:], np.float32).copy()
        except BaseException:
            with contextlib.suppress(OSError):
                sock.close()
            raise
        self._sock = sock
        self.span_ctx = span_ctx
        self.round_offset = int(round_offset)
        # hub-side identity: differs from worker_id when a live
        # duplicate dialer was uniquified at _register
        self.assigned_id = int(assigned)
        self.rejoin_params = rejoin

    def _connect(self):
        delays = backoff_delays(self.backoff_base, self.backoff_max,
                                self.max_retries)
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                self._dial()
                return
            except _SOCK_ERRORS as e:
                last = e
                if attempt < self.max_retries:
                    time.sleep(delays[attempt])
        raise ConnectionError(
            f"scaleout hub at {self.address!r} unreachable after "
            f"{self.max_retries + 1} attempt(s): {last}")

    def _close_sock(self):
        if self._sock is not None:
            with contextlib.suppress(OSError):
                self._sock.close()
            self._sock = None

    def _ensure(self):
        if self._sock is None:
            raise ConnectionError("not connected")

    def _retrying(self, op, what: str):
        delays = backoff_delays(self.backoff_base, self.backoff_max,
                                self.max_retries)
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                return op()
            except _SOCK_ERRORS as e:
                last = e
                if attempt == self.max_retries:
                    break
                self._close_sock()
                time.sleep(delays[attempt])
                try:
                    self._dial()
                    self.rejoins += 1
                except _SOCK_ERRORS as e2:
                    last = e2       # next loop iteration backs off longer
        self._close_sock()
        raise ConnectionError(
            f"scaleout hub lost during {what} and not recovered after "
            f"{self.max_retries + 1} attempt(s): {last}")

    # ------------------------------------------------------------ ops
    def average(self, flat: np.ndarray) -> np.ndarray:
        """Contribute ``flat`` (host float32) and return the round mean.
        The reply's 4-byte header is the hub's round index — kept on
        ``self.last_round``, immune to membership skew."""
        blob = np.ascontiguousarray(flat, np.float32).tobytes()

        def op():
            self._ensure()
            send_frame(self._sock, KIND_PARAMS, blob)
            kind, payload = recv_frame(self._sock)
            if kind != KIND_PARAMS or len(payload) < 4:
                raise ConnectionError("hub closed mid-round")
            self.last_round = struct.unpack("<I", payload[:4])[0]
            return np.frombuffer(payload[4:], np.float32).copy()

        return self._retrying(op, "average")

    def lease(self, max_wait: Optional[float] = None) -> Optional[int]:
        """Lease the next work item; None when the pool has nothing
        (now or ever) for this worker. GRANT_RETRY (the provisioning
        window) polls until ``max_wait`` elapses — defaulting to the
        client's socket ``timeout``, which the job sizes to outlast
        the hub's provisioning grace (``worker_timeout``), so a worker
        never abandons items that are merely held back for an owner the
        hub has not yet given up on."""
        if max_wait is None:
            max_wait = self.timeout if self.timeout else 30.0

        def op():
            self._ensure()
            send_frame(self._sock, KIND_LEASE_REQ)
            kind, payload = recv_frame(self._sock)
            if kind != KIND_LEASE or not payload:
                raise ConnectionError("hub closed during lease grant")
            status = payload[0]
            item = struct.unpack("<I", payload[1:5])[0] \
                if status == GRANT_OK and len(payload) >= 5 else -1
            return status, item

        deadline = time.monotonic() + max_wait
        while True:
            status, item = self._retrying(op, "lease")
            if status == GRANT_OK:
                return item
            if status == GRANT_NONE or time.monotonic() > deadline:
                return None
            time.sleep(0.05)

    def lease_done(self, item: int) -> bool:
        """Best-effort completion report. If the connection died since
        the grant, the hub has already released the lease — do NOT
        resend on a fresh connection (the item may be re-leased); the
        re-run is the at-least-once half of the lease contract."""
        try:
            self._ensure()
            send_frame(self._sock, KIND_LEASE_DONE,
                       struct.pack("<I", int(item)))
            return True
        except _SOCK_ERRORS:
            return False

    def done(self):
        try:
            if self._sock is not None:
                send_frame(self._sock, KIND_DONE)
        finally:
            self._close_sock()

    def abort(self):
        """Crash path: close without DONE so the hub drops us (and
        releases our leases) instead of hanging."""
        self._close_sock()


def worker_main(address: Address, net, datasets: Sequence,
                averaging_frequency: int, epochs: int = 1,
                fail_after_steps: Optional[int] = None,
                worker_id: int = 0, *,
                worker_timeout: Optional[float] = None,
                lease: bool = False, max_retries: int = 0,
                backoff_base: float = 0.5, backoff_max: float = 8.0) -> None:
    """The worker body (reference: the Spark executor's FitWorker). Same
    code for thread, subprocess, or remote-host execution — only
    ``address`` changes.

    Two data modes: ``lease=False`` fits ``datasets`` as this worker's
    static partition (legacy contract); ``lease=True`` treats
    ``datasets`` as the FULL shard list and leases ``(epoch, shard)``
    items from the hub one at a time, so a dead peer's shards flow to
    this worker and this worker's shards outlive it. Either way the
    averaging round joins every ``averaging_frequency`` local steps.

    ``worker_timeout`` bounds every socket wait (None = legacy
    block-forever); ``max_retries``/``backoff_*`` let the worker survive
    a master restart by re-attaching. ``fail_after_steps`` is a
    fault-injection hook for tests."""
    client = WorkerClient(address, worker_id=worker_id,
                          timeout=worker_timeout, max_retries=max_retries,
                          backoff_base=backoff_base, backoff_max=backoff_max)
    if client.rejoin_params is not None and client.rejoin_params.size:
        # enter the job from its live state, not our stale init
        net.set_params_flat(client.rejoin_params)
    tracer = get_tracer()
    state = {"step": 0, "base_step": 0,
             "base_round": client.round_offset, "rejoins": client.rejoins}

    def fit_span():
        """Span for the fit feeding the next averaging round: parented
        to the ROUND's deterministic id, so the exported tree reads
        master job -> round k -> this worker's fits."""
        ctx = client.span_ctx
        if ctx is None:
            return contextlib.nullcontext()
        if client.rejoins != state["rejoins"]:
            # reconnected mid-job: rebase the round arithmetic on the
            # hub's current round so already-fed rounds aren't counted
            # twice (which would orphan the spans on phantom round ids)
            state["rejoins"] = client.rejoins
            state["base_step"] = state["step"]
            state["base_round"] = client.round_offset
        rnd = state["base_round"] + \
            (state["step"] - state["base_step"]) // averaging_frequency + 1
        parent = SpanContext(ctx.trace_id,
                             derived_span_id(ctx.trace_id, "round", rnd))
        return tracer.span("scaleout_worker_fit", parent=parent,
                           attrs={"worker": worker_id, "round": rnd,
                                  "step": state["step"] + 1})

    def fit_one(ds):
        with fit_span():
            net.fit(ds)
        state["step"] += 1
        get_registry().counter(
            "dl4j_scaleout_worker_steps_total",
            "Fit steps taken by scaleout workers").inc()
        if fail_after_steps is not None and state["step"] >= fail_after_steps:
            raise RuntimeError("injected worker failure")
        if state["step"] % averaging_frequency == 0:
            net.set_params_flat(client.average(host_params(net)))

    try:
        if lease:
            n_shards = max(1, len(datasets))
            while True:
                item = client.lease()
                if item is None:
                    break
                fit_one(datasets[item % n_shards])
                client.lease_done(item)
        else:
            for _ in range(epochs):
                for ds in datasets:
                    fit_one(ds)
        # one final sync so the master sees this worker's tail steps
        if state["step"] % averaging_frequency:
            net.set_params_flat(client.average(host_params(net)))
        client.done()
    except BaseException:
        # crash without done(): the hub must drop us (releasing our
        # leases), not hang — this is the fault-tolerance failure path
        client.abort()
        raise


# ---------------------------------------------------------------------------
# The job
# ---------------------------------------------------------------------------

class SparkDl4jMultiLayer:
    """Reference ``SparkDl4jMultiLayer``: net + TrainingMaster → job-level
    ``fit``. Workers are provisioned as threads by default (each runs its
    own compiled fit on its leased shards — the single-host multi-executor
    regime); point remote processes at ``hub.address`` + ``worker_main``
    for true multi-host operation. ``fit`` resumes an interrupted job
    from ``checkpoint_dir`` automatically (see ``read_resume_state``)."""

    def __init__(self, net, training_master: TrainingMaster):
        self.net = net
        self.tm = training_master
        self.rounds = 0
        self.dropped_workers: List[int] = []
        self.lease_table: Optional[LeaseTable] = None
        self.resumed = False
        self.rejoins = 0

    # ---------------------------------------------------------- checkpoint
    def _checkpoint(self, template_net, table: LeaseTable):
        tm = self.tm
        if tm.checkpoint_dir is None:
            return None
        ckdir = Path(tm.checkpoint_dir)
        ckdir.mkdir(parents=True, exist_ok=True)

        def on_round(mean: np.ndarray, round_idx: int):
            if round_idx % tm.checkpoint_every_rounds:
                return
            template_net.set_params_flat(mean)
            from ..serde.model_serializer import save_model
            # every artifact lands atomically; the round STAMP is written
            # last, so a stamp present implies the others are whole
            save_model(template_net, ckdir / "latest.zip")
            atomic_write_text(ckdir / "leases.json", table.snapshot())
            atomic_write_text(ckdir / "round.txt", str(round_idx))

        return on_round

    def _load_resume_state(self, n_shards: int,
                           n_workers: int) -> Tuple[int, tuple, bool]:
        """(start_round, completed item ids, resumed?) — reads the
        interrupted-job stamp left by ``_checkpoint`` and reloads the
        averaged params into ``self.net``."""
        tm = self.tm
        if tm.checkpoint_dir is None:
            return 0, (), False
        stamp = read_resume_state(tm.checkpoint_dir)
        if stamp is None:
            return 0, (), False
        rnd, snap = stamp
        table = LeaseTable.restore(snap, n_shards, tm.epochs_per_fit,
                                   n_workers)
        if table is None:        # different job geometry — start fresh
            return 0, (), False
        model_path = Path(tm.checkpoint_dir) / "latest.zip"
        if model_path.exists():
            from ..serde.model_serializer import load_model
            restored = load_model(model_path, device=self.net.device)
            self.net.set_params_flat(restored.params_flat())
        return rnd, table.completed, True

    def _clear_lease_stamp(self):
        """A completed job deletes ``leases.json`` so the next ``fit``
        against the same checkpoint_dir starts a FRESH job (the stamp
        marks interruption, not history)."""
        if self.tm.checkpoint_dir is not None:
            with contextlib.suppress(OSError):
                (Path(self.tm.checkpoint_dir) / "leases.json").unlink()

    # ---------------------------------------------------------- fit
    def fit(self, datasets: Sequence, *,
            fail_worker: Optional[int] = None,
            fail_after_steps: int = 1,
            respawn_failed: bool = False,
            fail_master_after_rounds: Optional[int] = None):
        """Run the job: lease table over (epoch, shard) items → provision
        workers → averaging rounds → final averaged params land in
        ``self.net``. ``fail_worker`` / ``fail_after_steps`` inject a
        worker crash; ``respawn_failed`` re-provisions a crashed worker
        once (the Spark executor-re-provisioning contract — it rejoins
        under the same id); ``fail_master_after_rounds`` injects a
        master death (resume by calling ``fit`` again with the same
        ``checkpoint_dir``)."""
        tm = self.tm
        datasets = list(datasets)
        if not datasets:
            raise ValueError("no datasets to fit")
        n_shards = len(datasets)
        n = max(1, min(tm.n_workers, n_shards))
        start_round, completed, resumed = self._load_resume_state(n_shards, n)
        table = LeaseTable(n_shards, tm.epochs_per_fit, n,
                           completed=completed)
        self.lease_table = table
        self.resumed = resumed
        if resumed:
            get_registry().counter(
                "dl4j_scaleout_master_restarts_total",
                "Scaleout jobs resumed from the between-round "
                "checkpoint").inc()
        if table.all_done():
            # the interrupted job was already fully covered — the
            # checkpoint params (just reloaded) ARE the job's output
            self._clear_lease_stamp()
            self.rounds = start_round
            self.dropped_workers = []
            return self.net
        tracer = get_tracer()
        # the hub closes a round worker_timeout after its first frame;
        # give clients headroom past that so a straggler round cannot be
        # misread as a dead hub
        client_timeout = tm.worker_timeout * 1.25 + 2.0
        with tracer.span("scaleout_job",
                         attrs={"workers": n, "resumed": resumed}) as job_span:
            # the job root span's context rides the hub's KIND_SPANCTX
            # frames to every worker — thread, process, or remote host
            hub = ParamAveragingHub(
                n_workers=n, worker_timeout=tm.worker_timeout,
                on_round=self._checkpoint(self.net.clone(), table),
                span_ctx=job_span.context, lease_table=table,
                start_round=start_round,
                initial_params=(host_params(self.net) if resumed else None),
                fail_after_rounds=fail_master_after_rounds).start()

            threads: List[threading.Thread] = []
            tlock = threading.Lock()
            errors: List[BaseException] = []
            respawns: Dict[int, int] = {}

            def spawn(wid: int, inject: Optional[int]):
                replica = self.net.clone()

                def run():
                    try:
                        worker_main(hub.address, replica, datasets,
                                    tm.averaging_frequency, tm.epochs_per_fit,
                                    inject, worker_id=wid, lease=True,
                                    worker_timeout=client_timeout,
                                    max_retries=tm.worker_retries,
                                    backoff_base=tm.worker_backoff)
                    except BaseException as e:  # noqa: BLE001 — collected
                        errors.append(e)
                        if respawn_failed and respawns.get(wid, 0) < 1 \
                                and not hub.stopped:
                            respawns[wid] = respawns.get(wid, 0) + 1
                            # wait for the hub to notice the death so the
                            # fresh HELLO reads as a REJOIN, not a live
                            # duplicate id
                            hub.wait_dropped(wid, timeout=tm.worker_timeout)
                            spawn(wid, None)

                t = threading.Thread(target=run, daemon=True,
                                     name=f"dl4j-worker-{wid}")
                with tlock:
                    threads.append(t)
                t.start()

            for wid in range(n):
                spawn(wid, fail_after_steps if wid == fail_worker else None)
            # join ALL workers, including respawns registered while we join
            joined = 0
            while True:
                with tlock:
                    batch = threads[joined:]
                if not batch:
                    break
                for t in batch:
                    t.join()
                joined += len(batch)
            final = hub.result(timeout=tm.worker_timeout)
            job_span.set_attr("rounds", hub.rounds)
            job_span.set_attr("dropped", list(hub.dropped))
        self.rounds = hub.rounds
        self.dropped_workers = hub.dropped
        self.rejoins = hub.rejoins
        if hub.fail_injected:
            raise MasterDiedError(
                f"scaleout master died (injected) after round {hub.rounds}; "
                "call fit again with the same checkpoint_dir to resume")
        if final is None:
            if not resumed:
                raise RuntimeError(
                    "scaleout job produced no averaged parameters (every "
                    f"worker failed before the first round; errors: {errors})")
            # resumed job needed no further rounds: checkpoint params stand
            final = host_params(self.net)
        self.net.set_params_flat(final)
        if table.all_done():
            self._clear_lease_stamp()
        else:
            # never report clean success on partial coverage: the stamp
            # (when checkpointing) stays behind so a later fit resumes
            miss = table.n_items - len(table.completed)
            warnings.warn(
                f"scaleout: job drained with {miss} of {table.n_items} "
                "partition item(s) unconsumed" +
                (" — call fit again with the same checkpoint_dir to "
                 "resume" if tm.checkpoint_dir else
                 " and no checkpoint_dir to resume from"))
        return self.net


SparkComputationGraph = SparkDl4jMultiLayer   # CG has the same flat-params
# contract (params_flat/set_params_flat/clone/fit) — one job class serves both
