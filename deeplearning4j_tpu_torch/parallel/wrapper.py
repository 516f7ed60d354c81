"""ParallelInference on one device — port of the single-device half of
``deeplearning4j_tpu/parallel/wrapper.py`` (``org.deeplearning4j
.parallelism.ParallelInference``): DL4J's serving front end for a net.

Dynamic batching in front of the net's inference forward: ``submit``
queues a request and returns a ``Future`` for its rows; the queued rows
are swept through the device as one batch when they reach
``max_batch``, when the oldest request has waited ``max_wait_ms`` (a
deadline timer), or at an explicit ``flush()``. ``output`` runs a batch
directly. Results are tensors on the serving device, as the nets'
``output()`` gives them.

**The served weights are a snapshot.** The net's params and states are
cloned onto ``device`` at construction: the port's updaters train in
place, so a net trained afterwards serves its old weights until
``refresh()``, which copies the net's current values into the same
storage (the captured graphs stay valid).

**Where graphs are captured.** The forward is a
:class:`~deeplearning4j_tpu_torch.nn._compiled.CompiledStep` under
``no_grad``: on the card one CUDA graph per input signature (after an
eager first call), on the CPU a direct call. A capture in PyTorch's
default (global) mode fails when another thread touches CUDA meanwhile,
so only a caller's thread captures, under the lock: ``output``,
``flush`` and a ``submit`` that fills a batch. The deadline timer's
flush never captures: at a signature that no caller's thread has
captured yet it runs the step's eager stage (the same kernels on the
same device), and the next caller-thread call at that signature
captures it.

Metrics (the reference's names, in the port's ``obs`` registry):
``dl4j_inference_requests_total``, ``_deadline_flushes_total``,
``_queue_wait_seconds``, ``_batch_occupancy`` and ``_batches_total``.

Not ported: the mesh (dp-sharded batches, tp shardings) and
``ParallelWrapper`` (ROADMAP.md queue 1 item 6); ``mesh=`` raises.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Optional

import torch

from .._device import resolve_device
from ..nn._compiled import CompiledStep, copy_into, tensors
from ..obs import get_registry


def _snapshot(tree, device):
    """A copy of every tensor of nested dicts on ``device``."""
    if isinstance(tree, dict):
        return {k: _snapshot(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    return tree


def _rows(out, lo, hi):
    if isinstance(out, list):            # multi-output ComputationGraph
        return [o[lo:hi] for o in out]
    return out[lo:hi]


class ParallelInference:
    """Batched inference of ``net`` (a ``MultiLayerNetwork``,
    ``ComputationGraph`` or ``FunctionalInferenceModel``) on one device
    (see the module docstring). ``device=None`` means the CUDA card."""

    def __init__(self, net, mesh=None, max_batch: int = 64,
                 max_wait_ms: Optional[float] = None, *, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "ParallelInference over a mesh (dp-sharded batches, tp "
                "shardings) is not ported yet (ROADMAP.md queue 1 item "
                "6): pass mesh=None to serve on one device")
        self.net = net
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._params = _snapshot(net.params, self.device)
        self._states = _snapshot(net.states, self.device)
        self._infer: Optional[CompiledStep] = None
        self._pending = []
        self._pending_ts = []  # enqueue time per request (queue-wait metric)
        self._pending_futures = []   # one Future per submitted request
        self._lock = threading.RLock()
        self._timer: Optional[threading.Timer] = None
        if max_wait_ms is not None:
            # a deadline timer firing during interpreter shutdown would
            # dispatch into a runtime that is being torn down: cancel or
            # drain it from atexit, which runs first
            import atexit
            import weakref
            ref = weakref.ref(self)
            atexit.register(lambda: (lambda s: s and s._drain_timer())(
                ref()))

    def _drain_timer(self):
        """Cancel a pending deadline timer; if its callback is already
        mid-flush, wait for it to finish (process-exit path)."""
        with self._lock:
            t, self._timer = self._timer, None
        if t is not None:
            t.cancel()
            if t.is_alive():
                t.join(timeout=30)

    def refresh(self):
        """Copy the net's current params and states (e.g. after more
        training) into the served snapshot, in place."""
        with self._lock, torch.no_grad():
            copy_into(self._params, self.net.params)
            copy_into(self._states, self.net.states)
        return self

    def _build(self):
        net = self.net
        from ..nn.computation_graph import ComputationGraph

        if isinstance(net, ComputationGraph):
            def infer(*xs):
                with torch.no_grad():
                    acts, _, _ = net._forward(self._params, self._states, xs,
                                              train=False, rng=None)
                outs = tuple(acts[o] for o in net.conf.outputs)
                return outs[0] if len(outs) == 1 else outs
        else:
            def infer(*xs):
                with torch.no_grad():
                    y, _ = net._forward(self._params, self._states,
                                        xs[0] if len(xs) == 1 else xs,
                                        train=False, rng=None)
                return y

        self._infer = CompiledStep(
            infer, lambda: tensors((self._params, self._states)),
            "ParallelInference")
        return self._infer

    def _run(self, x, capture):
        fn = self._infer or self._build()
        multi = isinstance(x, (list, tuple))   # multi-input ComputationGraph
        xs = [torch.as_tensor(a, device=self.device)
              for a in (x if multi else [x])]
        out = fn(*xs, capture=capture)
        return list(out) if isinstance(out, tuple) else out

    def output(self, x):
        """Inference of one batch (an array, or a list of arrays for a
        multi-input graph) → a tensor (a list for a multi-output graph).
        Runs on the calling thread, under the lock."""
        with self._lock:
            return self._run(x, capture=True)

    def submit(self, x):
        """Dynamic batching: queue a request. Flushes inline (and returns
        the whole batch's parts, legacy contract) when the size threshold
        is met; otherwise returns this request's Future, which resolves
        at the flush that carries it — the deadline timer's flush when
        ``max_wait_ms`` is set, or an explicit ``flush()``."""
        x = torch.as_tensor(x)
        with self._lock:
            if self._pending and x.shape[1:] != self._pending[0].shape[1:]:
                raise ValueError(
                    f"mixed-shape submission: request rows have shape "
                    f"{tuple(x.shape[1:])} but the pending dynamic batch "
                    f"holds {tuple(self._pending[0].shape[1:])} — flush() "
                    "concatenates on axis 0, so per-request trailing dims "
                    "must match (flush or use a separate ParallelInference "
                    "per shape)")
            fut: Future = Future()
            self._pending.append(x)
            self._pending_ts.append(time.perf_counter())
            self._pending_futures.append(fut)
            get_registry().counter(
                "dl4j_inference_requests_total",
                "Requests submitted to dynamic batching").inc()
            if sum(p.shape[0] for p in self._pending) >= self.max_batch:
                return self._flush_locked(capture=True)
            if self.max_wait_ms is not None and self._timer is None:
                t = threading.Timer(self.max_wait_ms / 1e3,
                                    lambda: self._deadline_flush(t))
                t.daemon = True
                t.start()
                self._timer = t
        return fut

    def _deadline_flush(self, timer):
        """Timer callback: the oldest pending request hit max_wait_ms —
        sweep whatever is queued, never capturing a graph. Results reach
        callers via the Futures submit returned. ``timer`` identity-guards
        the race where a fired-but-lock-blocked timer outlives the flush
        that retired it: a stale callback must neither flush the next
        batch early nor orphan that batch's live timer handle."""
        with self._lock:
            if self._timer is not timer:
                return
            self._timer = None
            if self._pending:
                get_registry().counter(
                    "dl4j_inference_deadline_flushes_total",
                    "Dynamic batches flushed by the max_wait_ms deadline "
                    "rather than the size threshold").inc()
                self._flush_locked(capture=False)

    def flush(self):
        """Sweep the queued requests now; returns their parts."""
        with self._lock:
            return self._flush_locked(capture=True)

    def _flush_locked(self, capture):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not self._pending:
            return []
        sizes = [p.shape[0] for p in self._pending]
        batch = torch.cat([p.to(self.device) for p in self._pending])
        # how full each device sweep runs under the offered traffic, and
        # how long requests waited to board it
        reg = get_registry()
        now = time.perf_counter()
        wait_h = reg.histogram(
            "dl4j_inference_queue_wait_seconds",
            "Time a request waited in the dynamic-batching queue")
        for ts in self._pending_ts:
            wait_h.observe(now - ts)
        reg.gauge(
            "dl4j_inference_batch_occupancy",
            "Rows in the last dynamic batch / max_batch").set(
            batch.shape[0] / max(self.max_batch, 1))
        reg.counter("dl4j_inference_batches_total",
                    "Dynamic batches swept through the device").inc()
        futures = self._pending_futures
        self._pending = []
        self._pending_ts = []
        self._pending_futures = []
        try:
            out = self._run(batch, capture)
        except Exception as e:
            for f in futures:       # a deadline-flush caller only has the
                try:                # Future to learn of the failure from
                    f.set_exception(e)
                except InvalidStateError:
                    pass            # caller cancelled while queued
            raise
        parts, off = [], 0
        for s, f in zip(sizes, futures):
            part = _rows(out, off, off + s)
            parts.append(part)
            try:
                f.set_result(part)
            except InvalidStateError:
                pass   # this caller cancelled; its rows still ship in
                       # the parts list, the other futures must resolve
            off += s
        return parts
