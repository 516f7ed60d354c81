"""Compile sentinel — retrace detection on the compiled entry points. Port
of ``deeplearning4j_tpu/obs/compiles.py``.

A silent retrace storm erases the compiled-once contract: a shape that
drifts per call turns every call into a compile, and nothing in the
metrics plane would say so. The sentinel makes compilation observable:

- each compiled entry point that matters (the engine's ``decode_step``,
  ``prefill_chunk``, …, the nets' train steps ``mln_train_step`` and
  ``cg_train_step``) is wrapped in a :class:`CompileSentinel`;
- each compile is counted per input signature
  (``dl4j_compile_total{component=}``), timed
  (``dl4j_compile_seconds{component=}``) and deposited as a
  ``compile.<name>`` span on the process tracer;
- after :meth:`CompileSentinel.mark_warm` any further compile is a
  RETRACE: it increments ``dl4j_compile_retraces_total{component=}``
  and raises a ``RuntimeWarning``.

What counts as a compile. The wrapped callable is a
:class:`~deeplearning4j_tpu_torch.nn._compiled.CompiledStep`, which
reports every call to its ``hooks`` as ``(kind, signature)``:

- on CUDA with graphs enabled, a compile is one graph capture (kind
  ``"capture"``) — the counterpart of the reference's jit-cache growth;
- on the CPU and under ``disable_graphs()`` (kind ``"direct"``) nothing
  is captured, and a compile is a new signature: the reference's own
  rule for a callable without cache introspection.

Timing: a compile's observation spans the whole call that compiled (a
capture includes its first replay), as the reference's spans the first
call at a signature. The sentinel's own bookkeeping self-times into
``overhead_seconds`` (the wrapped call excluded): two clock reads a
call, plus the hook's work.
"""

from __future__ import annotations

import time
import warnings
import weakref
from typing import Any, Dict, Optional, Tuple


class CompileSentinel:
    """Wrapper around one :class:`CompiledStep` that observes its
    compiles. Invoke it like the step it wraps; other attributes delegate
    to the step. ``registry`` None means the process-wide registry."""

    def __init__(self, name: str, fn, *, registry=None):
        self.name = str(name)
        self._fn = fn
        self._registry = registry
        self.compiles = 0
        self.retraces_after_warm = 0
        self.warm = False
        self.signatures: Dict[Tuple, int] = {}
        self._overhead = 0.0
        self._t_call: Optional[float] = None
        # the step holds its hook weakly: a sentinel and its step form no
        # cycle, so a net that makes a new step frees the old one (and its
        # graphs) at once, never in a later collection
        me = weakref.ref(self)

        def hook(kind, sig):
            sentinel = me()
            if sentinel is not None:
                sentinel._observe(kind, sig)
        fn.hooks.append(hook)

    def __getattr__(self, item):
        if item == "_fn":        # nothing may recurse before __init__
            raise AttributeError(item)   # binds the target
        return getattr(self._fn, item)

    def _m(self):
        reg = self._registry
        if reg is None:
            from . import get_registry
            reg = get_registry()
        return (
            reg.counter(
                "dl4j_compile_total",
                "Compilations observed per jitted entry point",
                labelnames=("component",)),
            reg.histogram(
                "dl4j_compile_seconds",
                "Wall time of the call that compiled (trace + compile + "
                "first execution at that signature)",
                labelnames=("component",)),
            reg.counter(
                "dl4j_compile_retraces_total",
                "Compilations AFTER mark_warm() — each one is a retrace "
                "storm warning",
                labelnames=("component",)),
        )

    # ------------------------------------------------------ lifecycle
    def mark_warm(self) -> "CompileSentinel":
        """Declare warmup over: every compile from here on is a retrace
        (warned and counted). Arming is explicit: only the caller knows
        when its working set of shapes is complete."""
        self.warm = True
        return self

    @property
    def overhead_seconds(self) -> float:
        """Cumulative sentinel bookkeeping cost, the wrapped call's own
        time excluded."""
        return self._overhead

    def report(self) -> Dict[str, Any]:
        return {"name": self.name, "compiles": self.compiles,
                "signatures": len(self.signatures), "warm": self.warm,
                "retraces_after_warm": self.retraces_after_warm}

    # ----------------------------------------------------------- call
    def __call__(self, *args):
        t0 = time.perf_counter()
        self._t_call = t_call = time.perf_counter()
        try:
            return self._fn(*args)
        finally:
            self._t_call = None
            self._overhead += t_call - t0

    def _observe(self, kind: str, sig) -> None:
        """The step's hook: runs after the call's body, inside it."""
        t_done = time.perf_counter()
        if kind == "capture" or (kind == "direct"
                                 and sig not in self.signatures):
            dt = 0.0 if self._t_call is None else t_done - self._t_call
            self._record_compile(sig, dt)
        self._overhead += time.perf_counter() - t_done

    def _record_compile(self, sig, dt: float) -> None:
        self.compiles += 1
        self.signatures[sig] = self.signatures.get(sig, 0) + 1
        c_total, c_secs, c_retr = self._m()
        c_total.inc(component=self.name)
        c_secs.observe(dt, component=self.name)
        try:
            from .spans import Span, derived_span_id, get_tracer
            tracer = get_tracer()
            trace_id = derived_span_id("dl4j_compile", self.name)
            tracer.add_span(Span(
                name=f"compile.{self.name}", trace_id=trace_id,
                span_id=derived_span_id(trace_id, self.compiles),
                start_ts=time.time() - dt, time_s=dt,
                attrs={"component": self.name,
                       "compile_index": self.compiles,
                       "retrace": self.warm}))
        except Exception:  # noqa: BLE001 — span export is decoration
            pass
        if self.warm:
            self.retraces_after_warm += 1
            c_retr.inc(component=self.name)
            warnings.warn(
                f"post-warmup retrace #{self.retraces_after_warm} of "
                f"{self.name!r} (compile {self.compiles}, "
                f"{dt * 1e3:.1f} ms): a shape, dtype, static argument or "
                "bound cache drifted — a retrace storm erases the "
                "compiled-once contract", RuntimeWarning, stacklevel=6)
