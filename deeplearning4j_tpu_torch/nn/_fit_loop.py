"""The epoch loop of ``fit`` shared by MultiLayerNetwork and
ComputationGraph (reference: ``MultiLayerNetwork.fit``,
``deeplearning4j_tpu/nn/multi_layer_network.py:456-533``).

An iterator that opts in (``async_supported()``, every
``BaseDatasetIterator``) is wrapped in ``data/async_iter.py``'s
:class:`AsyncDataSetIterator` for the loop, as the reference's ``fit``
wraps it (``multi_layer_network.py:455-457``,
``computation_graph.py:582-585``): the next batches are made on a
producer thread while the card runs the step. The wrapper is reset
between epochs only: after the last one it is closed (no producer starts
for an epoch that never comes) and the source is reset.

Per batch the loop queues one compiled step, then reports it:

- **listeners.** When every listener takes deferred scores
  (``deferred_score_ok``), step k's (iteration, epoch, score) is delivered
  after step k+1 is queued: its loss is copied to pinned host memory
  behind the step (:class:`HostRead`) and read only then, so the read
  never stalls the card. The pending step is delivered before
  ``on_epoch_end`` and, in a ``finally`` that never masks the original
  error, when the loop raises. Any other listener gets each step
  synchronously (it may read the model at the reported step);
- **anomaly detection.** With a detector attached the step returns
  ``(loss, stats)`` and the stats are checked one step late
  (:class:`DelayedAnomalyCheck`), then once more after the loop.
"""

from __future__ import annotations

from .._device import HostRead
from ..data.async_iter import maybe_wrap_async
from ..train.anomaly import DelayedAnomalyCheck, stat_groups


def fit_epochs(net, iterator, epochs, step_batch):
    """Run ``epochs`` passes of ``step_batch(ds)`` (one queued train step:
    its loss, or ``(loss, stats)`` with a detector) over ``iterator``;
    returns the last loss tensor (None without batches)."""
    detector = getattr(net, "_anomaly_detector", None)
    check = None if detector is None else \
        DelayedAnomalyCheck(detector, stat_groups(net.params))
    defer = all(getattr(ls, "deferred_score_ok", False)
                for ls in net.listeners)
    pending = None

    def deliver():
        nonlocal pending
        if pending is not None:
            read, it, ep = pending
            pending = None
            score = read.get()
            for listener in net.listeners:
                listener.iteration_done(net, it, ep, score)

    last = None
    iterator, wrapper = maybe_wrap_async(iterator)
    net._prefetch = wrapper
    try:
        for epoch in range(epochs):
            for ds in iterator:
                out = step_batch(ds)
                net._step_count += 1
                loss = out
                if check is not None:
                    loss, stats = out
                    check.push(stats, net._step_count)
                last = loss
                if not net.listeners:
                    continue
                if defer:
                    staged = (HostRead(loss), net._step_count,
                              net.epoch_count)
                    deliver()
                    pending = staged
                else:
                    score = float(loss)
                    for listener in net.listeners:
                        listener.iteration_done(net, net._step_count,
                                                net.epoch_count, score)
            net.epoch_count += 1
            if wrapper is not None and epoch + 1 == epochs:
                wrapper.close()
                if hasattr(wrapper.inner, "reset"):
                    wrapper.inner.reset()
            elif hasattr(iterator, "reset"):
                iterator.reset()
            deliver()               # every iteration_done before epoch end
            for listener in net.listeners:
                if hasattr(listener, "on_epoch_end"):
                    listener.on_epoch_end(net)
    finally:
        # a raise mid-epoch still delivers the completed step, but never
        # masks the original error
        try:
            deliver()
        except Exception:           # noqa: BLE001 — the original wins
            pass
        if wrapper is not None:
            wrapper.close()
    if check is not None:
        check.flush()
    return last
