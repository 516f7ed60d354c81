"""Compile sentinel — retrace detection on the compiled entry points. Port
of the counting part of ``deeplearning4j_tpu/obs/compiles.py``.

A silent retrace storm erases the compiled-once contract: a shape that
drifts per call turns every call into a compile. The sentinel counts
them:

- each compiled entry point that matters (the engine's ``decode_step``,
  ``prefill_chunk``, …) is wrapped in a :class:`CompileSentinel`;
- each compile is counted per input signature;
- after :meth:`CompileSentinel.mark_warm` any further compile is a
  RETRACE: it increments ``retraces_after_warm`` and raises a
  ``RuntimeWarning``.

What counts as a compile. The wrapped callable is a
:class:`~deeplearning4j_tpu_torch.nn._compiled.CompiledStep`, which
reports every call to its ``hooks`` as ``(kind, signature)``:

- on CUDA with graphs enabled, a compile is one graph capture (kind
  ``"capture"``) — the counterpart of the reference's jit-cache growth;
- on the CPU and under ``disable_graphs()`` (kind ``"direct"``) nothing
  is captured, and a compile is a new signature: the reference's own
  rule for a callable without cache introspection.

Not ported yet: the metrics registry (``dl4j_compile_total`` …), the
compile spans and the self-timed overhead — they belong to the
observability plane.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Tuple


class CompileSentinel:
    """Wrapper around one :class:`CompiledStep` that counts its compiles.
    Invoke it like the step it wraps; other attributes delegate to the
    step."""

    def __init__(self, name: str, fn):
        self.name = str(name)
        self._fn = fn
        self.compiles = 0
        self.retraces_after_warm = 0
        self.warm = False
        self.signatures: Dict[Tuple, int] = {}
        fn.hooks.append(self._observe)

    def __getattr__(self, item):
        if item == "_fn":        # nothing may recurse before __init__
            raise AttributeError(item)   # binds the target
        return getattr(self._fn, item)

    # ------------------------------------------------------ lifecycle
    def mark_warm(self) -> "CompileSentinel":
        """Declare warmup over: every compile from here on is a retrace
        (warned and counted). Arming is explicit: only the caller knows
        when its working set of shapes is complete."""
        self.warm = True
        return self

    def report(self) -> Dict[str, Any]:
        return {"name": self.name, "compiles": self.compiles,
                "signatures": len(self.signatures), "warm": self.warm,
                "retraces_after_warm": self.retraces_after_warm}

    # ----------------------------------------------------------- call
    def __call__(self, *args):
        return self._fn(*args)

    def _observe(self, kind: str, sig) -> None:
        if kind == "capture" or (kind == "direct"
                                 and sig not in self.signatures):
            self._record_compile(sig)

    def _record_compile(self, sig) -> None:
        self.compiles += 1
        self.signatures[sig] = self.signatures.get(sig, 0) + 1
        if self.warm:
            self.retraces_after_warm += 1
            warnings.warn(
                f"post-warmup retrace #{self.retraces_after_warm} of "
                f"{self.name!r} (compile {self.compiles}): a shape, dtype, "
                "static argument or bound cache drifted — a retrace storm "
                "erases the compiled-once contract", RuntimeWarning,
                stacklevel=6)
