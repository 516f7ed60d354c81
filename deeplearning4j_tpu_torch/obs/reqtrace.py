"""Per-request trace timelines + the serving flight recorder. Port of
``deeplearning4j_tpu/obs/reqtrace.py``: the same events, derivations,
span ids and JSONL dump format, so that each package loads the other's
dumps.

The aggregate histograms (``dl4j_serving_ttft_seconds``, ...) say *that*
p99 moved; a :class:`RequestTrace` says *why* — every lifecycle event of
one request (submit → queue → admit → prefill → each decode token →
preempt / requeue → finish / cancel / fail) with timestamps.

Three pieces:

- :class:`RequestTrace` — the append-only event timeline. Derives
  per-request TTFT, inter-token-latency samples (a preempted request's
  requeue gap IS an ITL sample — invisible to per-sweep timing), and a
  JSONL-able record. ``assemble_spans`` stitches the timeline into the
  process :class:`~.spans.Tracer` as a deterministic span tree
  (request root → one ``serving.prefill`` span per admission → token
  events), using ``derived_span_id``.
- :class:`FlightRecorder` — a bounded ring of the last N completed
  traces plus per-step scheduler snapshots (slot map, queue depth,
  occupancy, KV residency). Dumped as JSONL on demand and automatically
  when the serve loop crashes (``ContinuousBatchingScheduler._fail_all``):
  a dying pool leaves a black box, not just failed futures. Live
  recorders self-register (:func:`live_flight_recorders`).
- :func:`load_flight_records` — torn-line-tolerant JSONL reader for
  postmortem tooling.

Clocks: events are timestamped with ``time.perf_counter()`` (monotonic —
ITL math must never see a wall-clock step), anchored once per trace to
epoch time so exported spans carry the same ``start_ts`` semantics as
every other span.
"""

from __future__ import annotations

import json
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from .spans import Span, derived_span_id, get_tracer

# terminal event names — exactly one ends a trace
TERMINAL_EVENTS = ("finish", "cancel", "fail")


@dataclass
class RequestTrace:
    """Every lifecycle event of one serving request, timestamped.

    ``events`` is an append-only list of ``(name, ts, attrs)`` with
    monotonic ``ts``; ``t0_epoch``/``t0_perf`` anchor the monotonic
    clock to epoch time for span export.
    """

    request_id: int
    replica: str = "0"
    kind: str = "generate"       # RequestKind value
    events: List[Tuple[str, float, Dict[str, Any]]] = field(
        default_factory=list)
    t0_epoch: float = field(default_factory=time.time)
    t0_perf: float = field(default_factory=time.perf_counter)

    # ------------------------------------------------------ recording
    def event(self, name: str, ts: Optional[float] = None,
              **attrs) -> float:
        """Append one lifecycle event; returns the timestamp used."""
        if ts is None:
            ts = time.perf_counter()
        self.events.append((name, ts, attrs))
        return ts

    def to_epoch(self, ts: float) -> float:
        return self.t0_epoch + (ts - self.t0_perf)

    # ----------------------------------------------------- accessors
    def first(self, name: str):
        for ev in self.events:
            if ev[0] == name:
                return ev
        return None

    def all(self, name: str):
        return [ev for ev in self.events if ev[0] == name]

    def terminal(self):
        for ev in reversed(self.events):
            if ev[0] in TERMINAL_EVENTS:
                return ev
        return None

    # ------------------------------------------------------- derived
    def token_timestamps(self) -> List[float]:
        return [ts for name, ts, _ in self.events if name == "token"]

    def itl_samples(self) -> List[float]:
        """Inter-token-latency samples: gaps between consecutive token
        events. Derived per REQUEST, not per sweep — the gap spanning a
        preempt → requeue → re-prefill interval is one (large) sample,
        exactly the stall the request's caller experienced."""
        ts = self.token_timestamps()
        return [b - a for a, b in zip(ts, ts[1:])]

    def ttft_s(self) -> Optional[float]:
        sub, tok = self.first("submit"), self.first("token")
        if sub is None or tok is None:
            return None
        return tok[1] - sub[1]

    def latency_s(self) -> Optional[float]:
        sub, end = self.first("submit"), self.terminal()
        if sub is None or end is None:
            return None
        return end[1] - sub[1]

    def finish_reason(self) -> Optional[str]:
        end = self.terminal()
        if end is None:
            return None
        if end[0] == "finish":
            return end[2].get("reason", "finish")
        return end[0]

    def n_tokens(self) -> int:
        return sum(1 for name, _, _ in self.events if name == "token")

    def preemptions(self) -> int:
        return sum(1 for name, _, _ in self.events if name == "preempt")

    def summary(self) -> Dict[str, Any]:
        """Compact per-request record — what the SLO engine consumes."""
        end = self.terminal()
        return {
            "request_id": self.request_id,
            "replica": self.replica,
            "kind": self.kind,
            "status": end[0] if end else "inflight",
            "reason": self.finish_reason(),
            "tokens": self.n_tokens(),
            "preemptions": self.preemptions(),
            "ttft_s": self.ttft_s(),
            "latency_s": self.latency_s(),
            "itl_s": [round(s, 6) for s in self.itl_samples()],
        }

    def to_record(self) -> Dict[str, Any]:
        return {"kind": "reqtrace", "request_id": self.request_id,
                "replica": self.replica, "request_kind": self.kind,
                "t0_epoch": self.t0_epoch,
                "summary": self.summary(),
                "events": [[name, round(ts - self.t0_perf, 6), attrs]
                           for name, ts, attrs in self.events]}

    # ---------------------------------------------------------- spans
    def trace_id(self) -> str:
        """Deterministic trace id for this request — re-assembling the
        same trace always rebuilds the same tree. The epoch anchor is part of the derivation:
        request ids restart at 0 for every scheduler instance, and two
        schedulers in one process must not mint
        colliding trees in the shared tracer."""
        return derived_span_id("dl4j_serving", self.replica,
                               self.request_id,
                               "%.6f" % self.t0_epoch)

    def assemble_spans(self, tracer=None) -> List[Span]:
        """Stitch the timeline into the tracer as one span tree:

            serving.request (root, submit → terminal)
              └─ serving.prefill (one per admission, k = 0, 1, ...)
                   └─ serving.token (zero-duration event per token)

        Built by hand and deposited via ``Tracer.add_spans`` (no single
        thread holds these spans open). Returns the spans it added
        (tests walk them)."""
        tracer = tracer or get_tracer()
        tid = self.trace_id()
        root_id = derived_span_id(tid, "request")
        sub = self.first("submit")
        end = self.terminal()
        t0 = sub[1] if sub else self.t0_perf
        t_end = end[1] if end else (self.events[-1][1] if self.events
                                    else t0)
        out: List[Span] = []
        prefill_k, cur_prefill = -1, root_id
        for name, ts, attrs in self.events:
            if name == "prefill":
                prefill_k += 1
                cur_prefill = derived_span_id(tid, "prefill", prefill_k)
                sp = Span(name="serving.prefill", trace_id=tid,
                          span_id=cur_prefill, parent_id=root_id,
                          start_ts=self.to_epoch(
                              ts - attrs.get("time_s", 0.0)),
                          time_s=attrs.get("time_s", 0.0),
                          attrs={"request": self.request_id,
                                 "admission": prefill_k, **attrs})
                out.append(sp)
            elif name == "token":
                # deterministic WITHOUT a hash: token events never cross
                # a process boundary, and a trace's close-out must stay
                # inside the <2% serving trace budget — an md5 per token
                # would be its single biggest cost
                i = attrs.get("i", 0)
                sp = Span(name="serving.token", trace_id=tid,
                          span_id="%st%04x" % (tid[:11], i),
                          parent_id=cur_prefill,
                          start_ts=self.to_epoch(ts), time_s=0.0,
                          attrs={"request": self.request_id, **attrs})
                out.append(sp)
        root = Span(name="serving.request", trace_id=tid, span_id=root_id,
                    start_ts=self.to_epoch(t0), time_s=t_end - t0,
                    attrs={"request": self.request_id,
                           "replica": self.replica,
                           "reason": self.finish_reason(),
                           "tokens": self.n_tokens(),
                           "preemptions": self.preemptions()})
        out.append(root)   # root last: children-before-parents, like
        tracer.add_spans(out)   # any post-order trace dump
        return out


# ---------------------------------------------------------------- recorder

_RECORDERS: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()


def live_flight_recorders() -> List["FlightRecorder"]:
    """Every FlightRecorder still alive in this process, stable order."""
    return sorted(_RECORDERS, key=lambda fr: (fr.replica, fr.created_ts))


class FlightRecorder:
    """Bounded black box for one scheduler: the last N completed
    :class:`RequestTrace` records + per-step snapshots. All methods are
    thread-safe; everything is host-side deque appends (the <2% serving
    trace budget is tested, not aspirational)."""

    def __init__(self, capacity_requests: int = 256,
                 capacity_snapshots: int = 512, replica: str = "0",
                 crash_dump_path: Optional[str] = None):
        self.replica = str(replica)
        self.crash_dump_path = crash_dump_path
        self.created_ts = time.time()
        self.dumps = 0
        # the scheduler wires a live-state callback in here so that
        # debug_state() shows current occupancy/queue/SLO, not only the
        # recorded past
        self.extra_state: Optional[Callable[[], Dict[str, Any]]] = None
        self._requests: "deque[RequestTrace]" = deque(
            maxlen=capacity_requests)
        self._snapshots: "deque[Dict[str, Any]]" = deque(
            maxlen=capacity_snapshots)
        self._lock = threading.Lock()
        _RECORDERS.add(self)

    # ------------------------------------------------------ recording
    def record_request(self, trace: RequestTrace):
        with self._lock:
            self._requests.append(trace)

    def record_snapshot(self, **snap):
        snap.setdefault("kind", "snapshot")
        snap.setdefault("ts", time.time())
        snap.setdefault("replica", self.replica)
        with self._lock:
            self._snapshots.append(snap)

    # ----------------------------------------------------- inspection
    def requests(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._requests)

    def snapshots(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._snapshots)

    def debug_state(self) -> Dict[str, Any]:
        """This recorder's state: what it holds, and the live state of
        its scheduler (``extra_state``)."""
        with self._lock:
            last = self._snapshots[-1] if self._snapshots else None
            n_req, n_snap = len(self._requests), len(self._snapshots)
        state = {"replica": self.replica, "requests_recorded": n_req,
                 "snapshots_recorded": n_snap, "dumps": self.dumps,
                 "crash_dump_path": self.crash_dump_path,
                 "last_snapshot": last}
        if self.extra_state is not None:
            try:
                state.update(self.extra_state())
            except Exception as e:  # noqa: BLE001 — debug must not raise
                state["extra_state_error"] = repr(e)
        return state

    # ----------------------------------------------------------- dump
    def dump(self, path=None, reason: str = "on-demand") -> str:
        """Append the whole black box to ``path`` as JSONL (header,
        snapshots, request traces) and return the path written. Default
        path is the recorder's ``crash_dump_path`` or
        ``runs/serving_blackbox.jsonl``."""
        path = Path(path or self.crash_dump_path
                    or "runs/serving_blackbox.jsonl")
        path.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            snaps = list(self._snapshots)
            traces = list(self._requests)
        header = {"kind": "flightrec", "replica": self.replica,
                  "reason": reason, "dumped_at": time.time(),
                  "n_snapshots": len(snaps), "n_requests": len(traces)}
        # memory plane: this replica's latest censuses ride the dump, so
        # a crash postmortem answers "whose bytes" from one file
        censuses = []
        try:
            from .memory import latest_censuses
            censuses = [c for c in latest_censuses()
                        if c.get("replica") == self.replica]
        except Exception:  # noqa: BLE001 — census is decoration
            pass
        with open(path, "a") as f:
            f.write(json.dumps(header) + "\n")
            for c in censuses:
                f.write(json.dumps(c) + "\n")
            for snap in snaps:
                f.write(json.dumps(snap) + "\n")
            for tr in traces:
                f.write(json.dumps(tr.to_record()) + "\n")
        self.dumps += 1
        return str(path)


def load_flight_records(path) -> List[dict]:
    """Read a flight-recorder JSONL back: torn trailing line skipped
    (a crash dump is by definition written by a dying process), unknown
    kinds ignored."""
    out: List[dict] = []
    try:
        text = Path(path).read_text()
    except OSError:
        return out
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and rec.get("kind") in (
                "flightrec", "snapshot", "reqtrace", "memcensus",
                "numerics", "fidelity"):
            out.append(rec)
    return out
