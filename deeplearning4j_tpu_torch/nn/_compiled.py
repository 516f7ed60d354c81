"""Compiled train steps: the port's counterpart of ``jax.jit`` with
``donate_argnums`` (the reference compiles every step that way:
``nn/computation_graph.py:542``, ``nn/multi_layer_network.py:397``,
``zoo/transformer.py``'s ``make_train_step``).

A *static step* is a callable ``step(*batch) -> loss`` that reads one
batch (a tuple of tensors, ``None`` for an absent mask) and writes
everything it trains back in place: the params, the optimizer state, the
running states. What it allocates for itself may come from a graph's
pool; nothing the next step reads may.

:class:`CompiledStep` runs one:

- on the CPU, and on CUDA under :func:`disable_graphs`, it calls the step
  directly (the eager path; the CPU tests thus run the very code that CUDA
  captures);
- on CUDA, per input signature (each batch tensor's shape, dtype and
  device, and which are ``None``): the first call runs the step eagerly
  on the step's own side stream, as a real training step. That builds the
  kernels, sets their attributes and allocates per-stream state (K3's
  arrival counters) before any capture. The second call copies the batch
  into static input buffers, captures the step into a
  ``torch.cuda.CUDAGraph`` on the side stream and replays it. Every later
  call copies the batch in and replays. All graphs of one
  ``CompiledStep`` share one memory pool, and a call returns a fresh copy
  of the loss.

A replay runs the kernels the capture recorded on the same buffers, so
the trajectory is the eager one, step for step. A ``torch.Generator``
among the bindings (the net's, which dropout and weight noise draw from)
is registered with every graph: a replay draws from the generator's
current state, as the eager step would, and advances it. Before each replay the
step's bindings (the tensors it updates in place, and the host values it
bakes in) are checked by identity: after a rebinding (``net.params = ...``,
a new optimizer, a changed learning rate) every graph is dropped and the
next call of each signature starts again with an eager step.

Several threads may run compiled steps at once (the scale-out job's
worker threads each fit their own ``net.clone()``). A capture runs in
CUDA's thread-local capture mode, so that another thread's eager step,
host read or replay is neither refused nor recorded into it, and captures
are serialized by one process-wide lock, under which the cyclic
collector stays off (``gc`` is process-wide: a collection during a
capture could free another step's graph). What CUDA forbids while any
stream captures stays forbidden in every thread: a whole-device
``torch.cuda.synchronize()`` (or ``empty_cache()``) from another thread
invalidates the capture. Such code holds :data:`CAPTURE_LOCK`; a
stream's or an event's own synchronize is safe.

A failed capture raises :class:`CaptureError` chained to the error of the
op that failed (a host sync, a pageable copy, an allocation the capture
forbids). Nothing falls back to eager on its own: the eager path on CUDA
is only ever :func:`disable_graphs`, or a step made with ``eager=True``
(a network whose SameDiff layer needs the host while it runs, known
before the first call, as ``SameDiff.eval`` knows it of a graph).

The Python launch counters of the kernel wrappers do not move during a
replay (the wrappers do not run): a capture counts one replay's launches.

Serving steps (``serving/engine.py``) add three things:

- **bound arguments.** A :class:`Bound` argument (the KV cache the step
  updates in place, the generator a sampler draws from) is passed
  through by identity, never copied into a static input. A graph bakes
  its addresses, so the identity of each of its leaves is part of the
  signature: a graph captured on one cache never replays on another, a
  second cache of the same shapes gets its own graphs, and the graphs of
  a cache are dropped when it is freed. A generator leaf is registered
  with the graph, so a replay draws what the eager call would have drawn
  from the generator's state; it is held as long as its graphs (it
  cannot be weakly referenced). Any other non-tensor argument is static
  (part of the signature by ``repr``) and passed as it is;
- **tree outputs.** A call returns fresh copies of a tensor or a tuple of
  tensors, never a graph's static output;
- **hooks.** Each ``hooks`` entry is called after every call as
  ``hook(kind, signature)`` — the compile sentinel counts captures (and
  new signatures of direct calls) through it.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import weakref

import torch

_DISABLED = 0
# one capture at a time in the process (see CompiledStep._capture)
CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def disable_graphs():
    """Run every compiled step eagerly inside the block (the counterpart
    of ``jax.disable_jit()``). Graphs already captured are kept, and used
    again after the block."""
    global _DISABLED
    _DISABLED += 1
    try:
        yield
    finally:
        _DISABLED -= 1


def graphs_enabled() -> bool:
    return _DISABLED == 0


class CaptureError(RuntimeError):
    """Capturing a step as a CUDA graph failed; ``__cause__`` is the
    error of the op that failed."""


def tensors(tree):
    """The tensors of nested dicts (sorted keys), tuples and lists, in
    order; other leaves are left out."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def copy_into(dst, src):
    """``dst.copy_(src)`` over two trees of one structure, skipping the
    leaves that are already the same tensor."""
    if isinstance(dst, dict):
        for k in dst:
            copy_into(dst[k], src[k])
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            copy_into(d, s)
    elif src is not dst:
        dst.copy_(src)


def _same(a, b):
    """Two binding lists hold the same objects, in order."""
    return b is not None and len(a) == len(b) and all(
        x is y for x, y in zip(a, b))


class Bound:
    """A step argument passed through by identity (see the module
    docstring): a tensor, a ``torch.Generator`` or nested dicts, tuples
    and lists of them."""
    __slots__ = ("tree",)

    def __init__(self, tree):
        self.tree = tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _bound_leaves(batch):
    return [x for b in batch if isinstance(b, Bound) for x in _leaves(b.tree)]


def signature(batch):
    """A call's input signature: each tensor's shape, dtype and device,
    ``None`` for an absent one, a :class:`Bound` argument's leaves by
    identity, any other value by ``repr``."""
    def one(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.dtype, x.device)
        if isinstance(x, Bound):
            return ("bound",) + tuple(
                (id(o), tuple(o.shape), o.dtype)
                if isinstance(o, torch.Tensor) else (id(o), type(o).__name__)
                for o in _leaves(x.tree))
        return ("static", repr(x))
    return tuple(one(x) for x in batch)


def _unbind(batch):
    return [b.tree if isinstance(b, Bound) else b for b in batch]


def _device(batch):
    for x in list(batch) + _bound_leaves(batch):
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("a compiled step needs at least one tensor argument")


def _clone(out):
    if isinstance(out, tuple):
        return tuple(_clone(o) for o in out)
    return None if out is None else out.clone()


class _Graph:
    __slots__ = ("graph", "inputs", "out")


class CompiledStep:
    """One static step's graph cache (see the module docstring).

    ``bindings()`` returns the objects the step updates in place or bakes
    into a capture; ``name`` goes into error messages. ``last`` says how
    the latest call ran ("direct", "eager", "capture" or "replay"; a
    "capture" call also replays once) and ``calls`` counts each kind.
    ``hooks`` are called after every call with ``(kind, signature)``."""

    def __init__(self, step, bindings, name, eager=False):
        self.step, self.bindings, self.name = step, bindings, name
        self.eager = eager
        self.last = None
        self.calls = dict.fromkeys(("direct", "eager", "capture", "replay"),
                                   0)
        self.hooks = []
        self._graphs = {}
        self._watch = {}
        self._bound = None
        self._stream = None
        self._pool = None

    def reset(self):
        """Drop every graph: each signature's next call is eager again."""
        self._graphs = {}
        self._watch = {}
        self._bound = None

    def drop_bound(self, obj):
        """Drop every graph whose bound arguments include ``obj`` (a
        generator is held by its graphs, so a caller that retires one
        drops them here)."""
        for key, watch in list(self._watch.items()):
            if any((w if isinstance(w, torch.Generator) else w()) is obj
                   for w in watch):
                self._graphs.pop(key, None)
                self._watch.pop(key, None)

    def _note(self, kind, key):
        self.last = kind
        self.calls[kind] += 1
        for hook in self.hooks:
            hook(kind, key)

    def _forget(self, key, leaves):
        """Drop ``key``'s graph as soon as one of its bound tensors is
        freed (its id may then name another object). A generator cannot
        be weakly referenced: it is held while its graph lives, so that
        its id names it."""
        me = weakref.ref(self)

        def gone(_):
            s = me()
            if s is not None:
                s._graphs.pop(key, None)
                s._watch.pop(key, None)
        self._watch[key] = [x if isinstance(x, torch.Generator)
                            else weakref.ref(x, gone) for x in leaves]

    def __call__(self, *batch, capture=True):
        """Run the step on ``batch``. With ``capture=False`` the call
        never captures: where this signature's next call would capture,
        it runs the eager stage again, and a later call that allows it
        captures (a thread that must not capture, as a deadline timer's,
        calls so)."""
        dev = _device(batch)
        key = signature(batch)
        if dev.type != "cuda" or not graphs_enabled() or self.eager:
            out = self.step(*_unbind(batch))
            self._note("direct", key)
            return out
        bound = list(self.bindings())
        if not _same(bound, self._bound):
            self.reset()
            self._bound = bound
        g = self._graphs.get(key)
        if g is None or (g is False and not capture):
            out = self._eager(dev, batch)
            # the step may have allocated state lazily (torch.optim's):
            # graphs captured before it would not see that state
            after = list(self.bindings())
            if not _same(after, bound):
                self.reset()
            self._bound = after
            self._graphs[key] = False
            self._forget(key, _bound_leaves(batch))
            self._note("eager", key)
            return out
        if g is False:
            g = self._graphs[key] = self._capture(dev, batch)
            kind = "capture"
        else:
            for s, t in zip(g.inputs, batch):
                if isinstance(s, torch.Tensor):
                    s.copy_(t)
            kind = "replay"
        g.graph.replay()
        self._note(kind, key)
        return _clone(g.out)

    def _side_stream(self, dev):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        return self._stream

    def _eager(self, dev, batch):
        """One real step on the side stream, ordered after and before the
        caller's stream."""
        cur = torch.cuda.current_stream(dev)
        side = self._side_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.step(*_unbind(batch))
        cur.wait_stream(side)
        return out

    def _capture(self, dev, batch):
        g = _Graph()
        inputs = [t.clone() if isinstance(t, torch.Tensor) else t
                  for t in batch]
        # the graph keeps its static tensors, never a bound object: a
        # freed cache must be able to take its graphs with it
        g.inputs = [t if isinstance(t, torch.Tensor) else None
                    for t in inputs]
        g.graph = torch.cuda.CUDAGraph()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        failed = None
        prev = torch.cuda.current_stream(dev)
        # no cyclic collection during the capture: one could free another
        # step's graph, which a capturing stream does not permit, and so
        # invalidate this capture. Captures take turns, so that one
        # thread's capture never re-enables the collector under another's
        CAPTURE_LOCK.acquire()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for gen in _bound_leaves(batch) + list(self._bound):
                if isinstance(gen, torch.Generator):
                    g.graph.register_generator_state(gen)
            with torch.cuda.graph(g.graph, pool=self._pool,
                                  stream=self._side_stream(dev),
                                  capture_error_mode="thread_local"):
                try:
                    g.out = self.step(*_unbind(inputs))
                except Exception as e:      # noqa: BLE001 — re-raised below
                    failed = e
                    raise
        except Exception as e:              # noqa: BLE001 — re-raised
            # a failed capture_end leaves the capture stream current
            torch.cuda.set_stream(prev)
            cause = failed if failed is not None else e
            raise CaptureError(
                f"{self.name}: capturing the step as a CUDA graph failed "
                f"({type(cause).__name__}: {cause}). The step does not fall "
                "back to eager; run it under deeplearning4j_tpu_torch."
                "disable_graphs() to run it eagerly") from cause
        finally:
            if collecting:
                gc.enable()
            CAPTURE_LOCK.release()
        return g
