"""Span tracer — nested wall-clock (optionally device-synced) timing
regions that stitch across thread boundaries. Port of
``deeplearning4j_tpu/obs/spans.py``: the same records, ids and header.

A span records name, trace/span/parent ids, start timestamp, duration,
and free-form attrs. The current span rides a ``contextvars.ContextVar``
so nesting is automatic within a thread; across threads or processes the
parent travels as a serialized ``SpanContext`` header (``to_header`` /
``from_header``).

Timing levels: the default is host wall-clock; pass/set a ``sync`` value
(a tensor, or nested dicts, lists and tuples of them) and the span waits
for it before taking the end timestamp, so the span covers device work
too. On CUDA the wait is on an event recorded on the current stream of
each tensor's device (only that stream's work up to the record, never
the whole device); while a stream is capturing a graph nothing waits and
the span stays unsynced — the wait is best-effort, as in the reference.
Export is JSONL, one record per span:

    {"kind": "span", "name": ..., "trace_id": ..., "span_id": ...,
     "parent_id": ..., "start_ts": <epoch s>, "time_s": <duration s>,
     "synced": bool, "attrs": {...}}
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


def _leaves(value):
    if isinstance(value, dict):
        for v in value.values():
            yield from _leaves(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _leaves(v)
    else:
        yield value


def block_until_ready(value) -> bool:
    """Wait until every CUDA tensor of ``value`` is computed: one event a
    device, recorded on that device's current stream, then waited on.
    Returns False without waiting while the current stream captures a
    graph (a wait there would break the capture), True otherwise."""
    import torch
    devices = {x.device for x in _leaves(value)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    if not devices:
        return True
    if torch.cuda.is_current_stream_capturing():
        return False
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
    return True


# span ids come from a generator of their own, seeded once from the OS:
# no system call a span (a span opens on every serving sweep), and the
# caller's ``random.seed`` cannot make two runs mint the same ids
_IDS = random.Random(os.urandom(16))


def _new_id() -> str:
    """A random 16-hex-digit id (the reference's format)."""
    return "%016x" % _IDS.getrandbits(64)


def derived_span_id(trace_id: str, *parts: Any) -> str:
    """Deterministic span id from (trace, parts) — lets two sides agree
    on a span's identity WITHOUT a round-trip; byte-identical to the
    reference's ids (md5 of the joined parts)."""
    h = hashlib.md5(":".join([trace_id, *map(str, parts)]).encode())
    return h.hexdigest()[:16]


@dataclass(frozen=True, slots=True)
class SpanContext:
    trace_id: str
    span_id: str

    def to_header(self) -> str:
        return json.dumps({"trace_id": self.trace_id,
                           "span_id": self.span_id})

    @staticmethod
    def from_header(header: Optional[str]) -> Optional["SpanContext"]:
        if not header:
            return None
        try:
            d = json.loads(header)
            return SpanContext(str(d["trace_id"]), str(d["span_id"]))
        except (ValueError, KeyError, TypeError):
            return None


@dataclass(slots=True)
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    start_ts: float = 0.0
    time_s: float = 0.0
    synced: bool = False
    attrs: Dict[str, Any] = field(default_factory=dict)
    _sync: Any = None

    def set_attr(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def set_sync(self, value: Any) -> "Span":
        """Register a tensor (or a nested structure of tensors) to wait
        for before the end timestamp."""
        self._sync = value
        return self

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def record(self) -> dict:
        return {"kind": "span", "name": self.name,
                "trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "start_ts": self.start_ts,
                "time_s": self.time_s, "synced": self.synced,
                "attrs": self.attrs}


class Tracer:
    """Collects finished spans (bounded ring — never OOMs a long run;
    drops are counted, not silent) and owns the current-span context.
    The ring evicts the OLDEST spans: late spans are the enclosing ones
    (a job root closes last), and an exported tree must keep its root
    for the orphan-free stitching walk the tests perform."""

    def __init__(self, max_spans: int = 20000):
        self.max_spans = max_spans
        self.dropped = 0
        self._finished: "deque[Span]" = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._current: "contextvars.ContextVar[Optional[SpanContext]]" = \
            contextvars.ContextVar("dl4j_current_span", default=None)

    # ------------------------------------------------------ context
    def current_context(self) -> Optional[SpanContext]:
        return self._current.get()

    @contextlib.contextmanager
    def use_context(self, ctx: Optional[SpanContext]):
        """Adopt a remote parent (deserialized from a header) for the
        duration of the block — the receiving half of cross-thread or
        cross-process propagation."""
        token = self._current.set(ctx)
        try:
            yield ctx
        finally:
            self._current.reset(token)

    # ------------------------------------------------------ spans
    def span(self, name: str, attrs: Optional[Dict[str, Any]] = None,
             sync: Any = None, parent: Optional[SpanContext] = None,
             span_id: Optional[str] = None) -> "_SpanScope":
        """A context manager that opens a span (the current span, or
        ``parent``, its parent) and yields it; at exit it waits for its
        ``sync`` value, if any, takes the end timestamp and records it.
        A class, not a generator: it is on the serving sweep's path."""
        return _SpanScope(self, name, attrs, sync, parent, span_id)

    def new_span(self, name: str, attrs: Optional[Dict[str, Any]] = None,
                 sync: Any = None, parent: Optional[SpanContext] = None,
                 span_id: Optional[str] = None) -> Span:
        """A span as :meth:`span` opens it (ids; the current span, or
        ``parent``, its parent), not entered and not recorded: the
        caller sets its times and hands it to :meth:`add_span`."""
        parent_ctx = parent if parent is not None else self._current.get()
        return Span(name=name,
                    trace_id=parent_ctx.trace_id if parent_ctx
                    else _new_id(),
                    span_id=span_id or _new_id(),
                    parent_id=parent_ctx.span_id if parent_ctx else None,
                    attrs=dict(attrs or {}), _sync=sync)

    def _finish(self, sp: Span):
        with self._lock:
            if len(self._finished) == self.max_spans:
                self.dropped += 1   # deque(maxlen) evicts the oldest
            self._finished.append(sp)

    def add_span(self, sp: Span):
        """Record an externally-assembled span (one no single thread can
        hold the ``span()`` context manager open for, such as a compile
        the sentinel times after the fact)."""
        with self._lock:
            if len(self._finished) == self.max_spans:
                self.dropped += 1
            self._finished.append(sp)

    def add_spans(self, spans):
        """Deposit a batch of externally-assembled spans under ONE lock
        acquisition — what a request-trace assembly (root + prefills +
        per-token events, ``obs.reqtrace``) uses so a long generation's
        close-out doesn't pay the lock per token."""
        with self._lock:
            for sp in spans:
                if len(self._finished) == self.max_spans:
                    self.dropped += 1
                self._finished.append(sp)

    # ------------------------------------------------------ export
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def clear(self):
        with self._lock:
            self._finished.clear()
            self.dropped = 0

    def export_jsonl(self, path, clear: bool = False) -> int:
        """Append every finished span to ``path`` as JSONL; returns the
        number written. Ordered by completion time (children before
        parents, as in any post-order trace dump)."""
        with self._lock:
            spans = list(self._finished)
            if clear:
                self._finished.clear()
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "a") as f:
            for sp in spans:
                f.write(json.dumps(sp.record()) + "\n")
        return len(spans)


class _SpanScope:
    """The context manager of :meth:`Tracer.span`."""
    __slots__ = ("tracer", "sp", "token", "t0")

    def __init__(self, tracer, name, attrs, sync, parent, span_id):
        self.tracer = tracer
        self.sp = tracer.new_span(name, attrs, sync, parent, span_id)

    def __enter__(self) -> Span:
        sp = self.sp
        self.token = self.tracer._current.set(
            SpanContext(sp.trace_id, sp.span_id))
        sp.start_ts = time.time()
        self.t0 = time.perf_counter()
        return sp

    def __exit__(self, *exc) -> bool:
        sp = self.sp
        self.tracer._current.reset(self.token)
        if sp._sync is not None:
            try:
                sp.synced = block_until_ready(sp._sync)
            except Exception:  # noqa: BLE001 — sync is best-effort
                pass
        sp.time_s = time.perf_counter() - self.t0
        self.tracer._finish(sp)
        return False


def load_spans(path) -> List[dict]:
    """Read a span JSONL file back (torn trailing line skipped)."""
    out = []
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
        if isinstance(rec, dict) and rec.get("kind") == "span":
            out.append(rec)
    return out


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def span(name: str, **kw):
    """Module-level shorthand: ``with obs.span("round"): ...``"""
    return _tracer.span(name, **kw)
