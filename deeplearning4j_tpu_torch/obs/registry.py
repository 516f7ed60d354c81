"""Process-wide metrics registry — the observability plane's state. Port
of ``deeplearning4j_tpu/obs/registry.py``: the same instruments, names,
exposition text and refusals, so that one sequence of operations renders
byte-identical Prometheus text in both packages.

Three instrument kinds, Prometheus-shaped (counter / gauge / histogram
with exponential buckets and streaming quantiles), one process-wide
registry, and text exposition (``to_prometheus``).

Design constraints, in order:

1. **Hot-path cheap.** Every observation is a dict update + a bisect
   under one lock — a few microseconds, paid on the host between
   compiled steps (never inside a captured graph). The budget is <2% of
   a step, self-timed by the scheduler and ``MetricsListener``.
2. **Namespace discipline.** Every metric name must live under the
   registry namespace (``dl4j_`` by default) and counters must end in
   ``_total`` — ``scripts/check_metric_names.py`` lints the
   instrumentation sites against the same rules.
3. **Get-or-create registration.** Instrument constructors are
   idempotent per (name, kind, labelnames); re-registering the same
   name as a different kind or label set raises.

No torch import here: the registry is plain Python.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")

# exponential (powers-of-2) upper bounds, 0.1 ms .. ~105 s — covers a
# sub-ms LeNet step and a multi-second step in one layout
DEFAULT_BUCKETS = tuple(1e-4 * (2.0 ** i) for i in range(21))


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt(v: float) -> str:
    """Prometheus float rendering: integers without the trailing .0."""
    if v != v:  # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Instrument:
    """Shared label plumbing: values keyed by the label-value tuple (the
    empty tuple for an unlabeled instrument)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._sorted_names = tuple(sorted(self.labelnames))
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        # fast path: unlabeled instrument, no labels passed — the shape
        # every per-iteration listener metric takes (hot-path budget)
        if not labels and not self.labelnames:
            return ()
        # second fast path: labels passed in declared order (every
        # scheduler hot-path write) — a tuple identity check instead of
        # two sorts per write keeps labeled gauges inside the <2%
        # serving bookkeeping budget
        if tuple(labels) != self.labelnames \
                and tuple(sorted(labels)) != self._sorted_names:
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} do not match "
                f"declared labelnames {sorted(self.labelnames)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def labels(self, **labels) -> "_Child":
        """This instrument at one label set, resolved once: the child's
        writes skip the label lookup (a hot path holds its children, as
        the scheduler's sweep does). Nothing is exposed until a write."""
        return _Child(self, self._key(labels))

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        pairs = [f'{n}="{_escape_label(v)}"'
                 for n, v in zip(self.labelnames, key)]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter(_Instrument):
    """Monotonic counter. ``inc(v, **labels)``; names end in ``_total``."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, v: float = 1.0, **labels):
        self._inc(self._key(labels), v)

    def _inc(self, key, v):
        if v < 0:
            raise ValueError(f"{self.name}: counters only go up (got {v})")
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + v

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def expose(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        out = [f"{self.name}{self._label_str(k)} {_fmt(v)}"
               for k, v in items]
        if not out and not self.labelnames:
            out = [f"{self.name} 0"]
        return out


class Gauge(_Instrument):
    """Point-in-time value: ``set`` / ``inc`` / ``dec``."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, v: float, **labels):
        self._set(self._key(labels), v)

    def _set(self, key, v):
        with self._lock:
            self._values[key] = float(v)

    def inc(self, v: float = 1.0, **labels):
        self._inc(self._key(labels), v)

    def _inc(self, key, v):
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + v

    def dec(self, v: float = 1.0, **labels):
        self.inc(-v, **labels)

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def expose(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            return [f"{self.name} 0"]
        return [f"{self.name}{self._label_str(k)} {_fmt(v)}"
                for k, v in items]


class _HistState:
    __slots__ = ("counts", "total", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1: the +Inf overflow bucket
        self.total = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Instrument):
    """Cumulative-bucket histogram with streaming quantile estimates.

    Buckets are UPPER bounds (exponential by default); ``quantile(q)``
    interpolates linearly inside the bucket the q-th observation landed
    in, clamped to the observed min/max so the estimate never exceeds
    reality on a sparse tail.
    """

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Optional[Iterable[float]] = None):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(buckets)) if buckets is not None else DEFAULT_BUCKETS
        if not bs or any(b <= 0 for b in bs):
            raise ValueError(f"{self.name}: buckets must be positive bounds")
        self.buckets = bs
        self._states: Dict[Tuple[str, ...], _HistState] = {}

    def _state(self, key) -> _HistState:
        st = self._states.get(key)
        if st is None:
            st = self._states.setdefault(key, _HistState(len(self.buckets)))
        return st

    def observe(self, v: float, **labels):
        self._observe(self._key(labels), v)

    def _observe(self, key, v):
        i = bisect_left(self.buckets, v)
        with self._lock:
            st = self._state(key)
            st.counts[i] += 1
            st.total += 1
            st.sum += v
            st.min = min(st.min, v)
            st.max = max(st.max, v)

    def observe_many(self, values: Sequence[float], **labels):
        """Batch ``observe``: one key resolution + lock round for the
        whole sequence. The serving close-out path records every
        request's per-token ITL samples at once — per-sample locking
        measurably ate into the <2% bookkeeping budget."""
        if not values:
            return
        key = self._key(labels)
        buckets = self.buckets
        with self._lock:
            st = self._state(key)
            counts = st.counts
            for v in values:
                counts[bisect_left(buckets, v)] += 1
                st.sum += v
                if v < st.min:
                    st.min = v
                if v > st.max:
                    st.max = v
            st.total += len(values)

    def count(self, **labels) -> int:
        st = self._states.get(self._key(labels))
        return 0 if st is None else st.total

    def sum(self, **labels) -> float:
        st = self._states.get(self._key(labels))
        return 0.0 if st is None else st.sum

    def quantile(self, q: float, **labels) -> Optional[float]:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        st = self._states.get(self._key(labels))
        if st is None or st.total == 0:
            return None
        target = q * st.total
        cum = 0.0
        for i, c in enumerate(st.counts):
            if c == 0:
                continue
            lo = self.buckets[i - 1] if i > 0 else 0.0
            hi = self.buckets[i] if i < len(self.buckets) else st.max
            if cum + c >= target:
                frac = (target - cum) / c
                est = lo + frac * (hi - lo)
                return min(max(est, st.min), st.max)
            cum += c
        return st.max

    def expose(self) -> List[str]:
        with self._lock:
            items = sorted((k, (list(st.counts), st.total, st.sum))
                           for k, st in self._states.items())
        out: List[str] = []
        for key, (counts, total, s) in items:
            cum = 0
            for bound, c in zip(self.buckets, counts):
                cum += c
                le = 'le="%s"' % _fmt(bound)
                out.append(f"{self.name}_bucket"
                           f"{self._label_str(key, le)} {cum}")
            inf = 'le="+Inf"'
            out.append(f"{self.name}_bucket"
                       f"{self._label_str(key, inf)} {total}")
            out.append(f"{self.name}_sum{self._label_str(key)} {_fmt(s)}")
            out.append(f"{self.name}_count{self._label_str(key)} {total}")
        return out


class _Child:
    """One label set of an instrument (``_Instrument.labels``)."""
    __slots__ = ("_m", "_k")

    def __init__(self, m, key):
        self._m, self._k = m, key

    def inc(self, v: float = 1.0):
        self._m._inc(self._k, v)

    def dec(self, v: float = 1.0):
        self._m._inc(self._k, -v)

    def set(self, v: float):
        self._m._set(self._k, v)

    def observe(self, v: float):
        self._m._observe(self._k, v)


class MetricsRegistry:
    """Name -> instrument map with namespace enforcement and idempotent
    get-or-create registration. One process-wide instance lives in
    ``deeplearning4j_tpu_torch.obs`` (``get_registry()``); tests construct
    their own."""

    def __init__(self, namespace: str = "dl4j"):
        self.namespace = namespace
        self._metrics: Dict[str, _Instrument] = {}
        self._lock = threading.Lock()

    # -------------------------------------------------- registration
    def _get_or_create(self, cls, name, help, labelnames, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if not name.startswith(self.namespace + "_"):
            raise ValueError(
                f"metric {name!r} outside the registered "
                f"{self.namespace}_ namespace")
        if cls is Counter and not name.endswith("_total"):
            raise ValueError(f"counter {name!r} must end in '_total'")
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or \
                        m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"duplicate registration of {name!r}: existing "
                        f"{m.kind}{m.labelnames} vs requested "
                        f"{cls.kind}{tuple(labelnames)}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    # -------------------------------------------------- introspection
    def get(self, name: str) -> Optional[_Instrument]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def reset(self):
        """Drop every registered instrument (tests). Instrument objects
        created before the reset keep working but stop being exposed —
        long-lived holders (listeners, wrappers) should be constructed
        after the reset, and call-site instrumentation re-fetches via
        ``get_registry()`` each time precisely so a reset can't orphan
        it."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> Dict[str, dict]:
        """Name -> plain-data summary (counters/gauges: label->value;
        histograms: count/sum/p50/p95/p99 per label set). Takes each
        instrument's lock: a daemon thread (the scheduler's serve loop)
        may be minting a new label set mid-snapshot."""
        out: Dict[str, dict] = {}
        for name in self.names():
            m = self._metrics[name]
            if isinstance(m, Histogram):
                with m._lock:
                    keys = list(m._states)
                out[name] = {
                    ",".join(k) or "": {
                        "count": m._states[k].total,
                        "sum": m._states[k].sum,
                        "p50": self.quantile_of(m, 0.50, k),
                        "p95": self.quantile_of(m, 0.95, k),
                        "p99": self.quantile_of(m, 0.99, k)}
                    for k in keys}
            else:
                with m._lock:
                    items = list(m._values.items())
                out[name] = {",".join(k) or "": v for k, v in items}
        return out

    @staticmethod
    def quantile_of(h: Histogram, q: float, key: Tuple[str, ...]):
        return h.quantile(q, **dict(zip(h.labelnames, key)))

    # -------------------------------------------------- exposition
    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4 (what a scrape of
        ``/metrics`` reads)."""
        lines: List[str] = []
        for name in self.names():
            m = self._metrics[name]
            if m.help:
                esc = m.help.replace("\\", r"\\").replace("\n", r"\n")
                lines.append(f"# HELP {name} {esc}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.expose())
        return "\n".join(lines) + "\n" if lines else ""
