"""Serving SLO engine: declarative targets, rolling-window attainment,
burn rate, and goodput accounting over request lifecycles. Port of
``deeplearning4j_tpu/obs/slo.py``: the same semantics, report and gauges.

:class:`SLOConfig` declares the targets; :class:`SLOTracker` consumes
per-request lifecycle records (:class:`~.reqtrace.RequestTrace`
summaries), keeps a rolling window, and exports:

- ``dl4j_slo_goodput_ratio{replica=}`` — in-SLO completions / all
  SLO-eligible requests in the window,
- ``dl4j_slo_ttft_attainment{replica=}`` / ``dl4j_slo_itl_attainment``
  — fraction of requests meeting each latency target,
- ``dl4j_slo_error_rate{replica=}`` — failed / eligible,
- ``dl4j_slo_burn_rate{replica=}`` — error-budget consumption rate
  (1.0 = exactly spending the budget the quantile objective allows;
  >1 = burning toward violation),
- ``dl4j_slo_window_requests{replica=}`` — window population.

Semantics:

- A request meets the **TTFT target** iff ``ttft_s <= cfg.ttft_s``.
- A request meets the **ITL target** iff EVERY inter-token gap is
  ``<= cfg.itl_s`` — worst-gap, not average: one 2 s stall mid-stream
  is exactly what a streaming caller notices, and it is how a
  preemption requeue gap shows up. Requests with <2 tokens have no
  gaps and meet the target vacuously.
- **Good** = finished (not failed) AND both targets met. **Cancelled**
  requests are excluded from the window entirely (the client walked
  away; serving latency verdicts don't apply). **Failed** requests
  count against goodput and error rate.
- The window prunes by the LATEST observed timestamp (not wall clock),
  so offline replay of a flight-recorder dump and a live tracker share
  one code path.

``replica`` labels every gauge (default "0").
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional


@dataclass(frozen=True)
class SLOConfig:
    """Declarative serving targets. ``quantile`` is the attainment
    objective (0.99 → "p99 within target", error budget 1%)."""

    ttft_s: float = 1.0          # submit → first token
    itl_s: float = 0.25          # worst inter-token gap
    quantile: float = 0.99       # attainment objective
    max_error_rate: float = 0.01  # failed / eligible ceiling
    window_s: float = 300.0      # rolling window span
    window_max: int = 4096       # hard cap on window population

    def __post_init__(self):
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"quantile {self.quantile} outside (0, 1)")
        if self.ttft_s <= 0 or self.itl_s <= 0:
            raise ValueError("ttft_s / itl_s targets must be positive")


def _quantile(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


class SLOTracker:
    """Rolling-window SLO accounting over request lifecycle records.

    Feed it completed :class:`~.reqtrace.RequestTrace` objects
    (``observe``) or plain summary dicts (``observe_summary`` — the
    offline-replay path). ``report()`` returns the verdict dict."""

    def __init__(self, config: Optional[SLOConfig] = None,
                 replica: str = "0", registry=None):
        """``registry`` — None: export gauges to the process registry;
        False: no gauge export (offline replay); else: that registry."""
        self.config = config or SLOConfig()
        self.replica = str(replica)
        self._registry = registry
        # (ts, summary, good, ttft_ok, itl_ok, failed); pruned manually
        # (horizon + window_max) so the running counters below stay in
        # lockstep — gauge export is O(1), not a window re-scan
        self._window: deque = deque()
        self._counts = {"good": 0, "ttft_ok": 0, "itl_ok": 0,
                        "failed": 0}
        self._lock = threading.Lock()
        self._latest_ts = 0.0
        self._total_seen = 0
        self._gauges = None   # instrument handles, cached on first export

    # ------------------------------------------------------- ingest
    def observe(self, trace, ts: Optional[float] = None):
        """Account one completed request (RequestTrace or summary)."""
        summary = trace.summary() if hasattr(trace, "summary") else dict(
            trace)
        return self.observe_summary(summary, ts=ts)

    def observe_summary(self, summary: Dict[str, Any],
                        ts: Optional[float] = None):
        status = summary.get("status", "finish")
        if status == "cancel":
            return None          # client walked away: SLO-ineligible
        cfg = self.config
        failed = status == "fail"
        ttft = summary.get("ttft_s")
        itl = summary.get("itl_s") or []
        ttft_ok = ttft is not None and ttft <= cfg.ttft_s
        itl_ok = all(s <= cfg.itl_s for s in itl)
        good = (not failed) and ttft_ok and itl_ok
        if ts is None:
            ts = time.time()
        with self._lock:
            self._window.append((ts, summary, good, ttft_ok, itl_ok,
                                 failed))
            self._counts["good"] += good
            self._counts["ttft_ok"] += ttft_ok
            self._counts["itl_ok"] += itl_ok
            self._counts["failed"] += failed
            self._latest_ts = max(self._latest_ts, ts)
            self._total_seen += 1
            self._prune_locked()
            counts = dict(self._counts, n=len(self._window))
        self._export_gauges(counts)
        return good

    def _prune_locked(self):
        horizon = self._latest_ts - self.config.window_s
        while self._window and (
                self._window[0][0] < horizon
                or len(self._window) > self.config.window_max):
            _, _, good, ttft_ok, itl_ok, failed = self._window.popleft()
            self._counts["good"] -= good
            self._counts["ttft_ok"] -= ttft_ok
            self._counts["itl_ok"] -= itl_ok
            self._counts["failed"] -= failed

    # ------------------------------------------------------ verdicts
    def _stats(self):
        with self._lock:
            rows = list(self._window)
        n = len(rows)
        if n == 0:
            return None
        ttfts = sorted(s.get("ttft_s") for _, s, *_ in rows
                       if s.get("ttft_s") is not None)
        itls = sorted(x for _, s, *_ in rows
                      for x in (s.get("itl_s") or []))
        # per-kind census: every summary carries its RequestKind; a
        # summary without one (an older dump) counts as "generate"
        by_kind: Dict[str, Dict[str, int]] = {}
        for _, s, good, _, _, failed in rows:
            k = by_kind.setdefault(str(s.get("kind", "generate")),
                                   {"requests": 0, "good": 0,
                                    "failed": 0})
            k["requests"] += 1
            k["good"] += good
            k["failed"] += failed
        return {
            "n": n,
            "good": sum(1 for r in rows if r[2]),
            "ttft_ok": sum(1 for r in rows if r[3]),
            "itl_ok": sum(1 for r in rows if r[4]),
            "failed": sum(1 for r in rows if r[5]),
            "ttfts": ttfts, "itls": itls,
            "by_kind": by_kind,
            "span_s": rows[-1][0] - rows[0][0],
        }

    @property
    def latest_ts(self) -> float:
        """Timestamp of the newest observation (0.0 before any). The
        window prunes by THIS, not wall clock — a consumer comparing
        against wall time (the fleet router's staleness guard) can tell
        a fresh verdict from one frozen since traffic moved away."""
        with self._lock:
            return self._latest_ts

    def goodput(self) -> Optional[float]:
        st = self._stats()
        return None if st is None else st["good"] / st["n"]

    def error_rate(self) -> Optional[float]:
        st = self._stats()
        return None if st is None else st["failed"] / st["n"]

    def _burn(self, good: int, n: int) -> float:
        """Error-budget consumption: violating fraction over the budget
        the quantile objective allows (0.99 → 1% budget). 1.0 = spending
        the budget exactly; sustained >1 = the SLO will be missed. ONE
        definition — report(), the gauge export and the accessor must
        never drift apart."""
        return (1.0 - good / n) / (1.0 - self.config.quantile)

    def burn_rate(self) -> Optional[float]:
        st = self._stats()
        return None if st is None else self._burn(st["good"], st["n"])

    def report(self) -> Dict[str, Any]:
        """The verdict dict: targets, window stats, per-dimension
        attainment + observed quantiles, goodput, burn rate, and a
        single ``met`` bool."""
        cfg = self.config
        out: Dict[str, Any] = {"targets": asdict(cfg),
                               "replica": self.replica}
        st = self._stats()
        if st is None:
            out.update({"window": {"requests": 0}, "goodput": None,
                        "met": None})
            return out
        n = st["n"]
        q = cfg.quantile
        goodput = st["good"] / n
        error_rate = st["failed"] / n
        out["window"] = {"requests": n, "failed": st["failed"],
                         "span_s": round(st["span_s"], 3),
                         "total_seen": self._total_seen}
        out["ttft"] = {
            "p50_s": _quantile(st["ttfts"], 0.50),
            "p99_s": _quantile(st["ttfts"], 0.99),
            "attainment": st["ttft_ok"] / n}
        out["itl"] = {
            "p50_s": _quantile(st["itls"], 0.50),
            "p99_s": _quantile(st["itls"], 0.99),
            "samples": len(st["itls"]),
            "attainment": st["itl_ok"] / n}
        out["goodput"] = goodput
        out["error_rate"] = error_rate
        out["burn_rate"] = self._burn(st["good"], n)
        out["met"] = bool(goodput >= q
                          and error_rate <= cfg.max_error_rate)
        # per-kind goodput breakdown
        out["by_kind"] = {
            kind: {"requests": c["requests"], "good": c["good"],
                   "failed": c["failed"],
                   "goodput": c["good"] / c["requests"]}
            for kind, c in sorted(st["by_kind"].items())}
        return out

    # ------------------------------------------------------- gauges
    def _reg(self):
        if self._registry is not None:
            return self._registry
        from . import get_registry   # lazy: obs package init order
        return get_registry()

    def _make_gauges(self, reg):
        """Instrument handles, registered once and held (the
        MetricsListener precedent for long-lived holders — per-observe
        re-registration would dominate the close-out budget)."""
        return {
            "goodput": reg.gauge(
                "dl4j_slo_goodput_ratio",
                "In-SLO completions / eligible requests "
                "(rolling window)", labelnames=("replica",)),
            "ttft": reg.gauge(
                "dl4j_slo_ttft_attainment",
                "Fraction of windowed requests meeting the TTFT target",
                labelnames=("replica",)),
            "itl": reg.gauge(
                "dl4j_slo_itl_attainment",
                "Fraction of windowed requests whose every inter-token "
                "gap meets the ITL target", labelnames=("replica",)),
            "errors": reg.gauge(
                "dl4j_slo_error_rate",
                "Failed / eligible requests in the window",
                labelnames=("replica",)),
            "burn": reg.gauge(
                "dl4j_slo_burn_rate",
                "Error-budget consumption rate (1.0 = spending the "
                "quantile objective's budget exactly)",
                labelnames=("replica",)),
            "window": reg.gauge(
                "dl4j_slo_window_requests",
                "Requests in the rolling SLO window",
                labelnames=("replica",)),
        }

    def _export_gauges(self, st=None):
        """Mirror the rolling verdict onto the telemetry plane from the
        O(1) running counters (no window re-scan — the serving trace
        budget pays for this on every request close-out). Never fatal —
        the tracker's dict report is the source of truth."""
        if self._registry is False:
            return                      # offline replay: dicts only
        if st is None:
            with self._lock:
                st = dict(self._counts, n=len(self._window))
        if not st["n"]:
            return
        try:
            if self._gauges is None:
                self._gauges = self._make_gauges(self._reg())
            g = self._gauges
            n = st["n"]
            r = self.replica
            g["goodput"].set(st["good"] / n, replica=r)
            g["ttft"].set(st["ttft_ok"] / n, replica=r)
            g["itl"].set(st["itl_ok"] / n, replica=r)
            g["errors"].set(st["failed"] / n, replica=r)
            g["burn"].set(self._burn(st["good"], n), replica=r)
            g["window"].set(n, replica=r)
        except Exception:  # noqa: BLE001 — telemetry mirror only
            pass
