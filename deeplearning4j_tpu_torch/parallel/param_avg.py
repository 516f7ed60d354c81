"""Parameter-averaging distributed training — port of
``deeplearning4j_tpu/parallel/param_avg.py``
(``org.deeplearning4j.spark.impl.paramavg.ParameterAveragingTrainingMaster``
and ParallelWrapper's ``averagingFrequency`` mode).

Each dp rank trains its own replica for ``averaging_frequency`` local
steps on its own microbatches of the stream, then the params (and,
with ``average_updater_state``, the updater's float state; the float
running states always) are averaged over the dp group. The reference
runs the round as one ``shard_map`` program with a ``psum``; here every
rank runs the round (SPMD) and the average is one all-reduce a dtype.
A round takes ``n_workers × averaging_frequency`` microbatches of the
iterator (the same iterator on every rank): worker i trains on
microbatches ``[i·freq, (i+1)·freq)``. A tail shorter than a round is
trained with plain synchronous steps (one ``net.fit`` on every rank,
which keeps the replicas equal).

The local steps are the net's own compiled train step (its updater,
constraints and dropout; on the card a replayed CUDA graph), so
``averaging_frequency=1`` with plain SGD equals stepping on the averaged
gradient, as in the reference.
"""

from __future__ import annotations

import torch

from .. import _dist
from ..nn._compiled import tensors
from .mesh import data_parallel_mesh

_NOT_MULTI = ("ParameterAveragingTrainer stacks single-arm DataSet "
              "batches; for MultiDataSet (multi-input/multi-output) "
              "training use ParallelWrapper instead")


def _average_(ts, g):
    """Each float tensor of ``ts`` replaced by its mean over ``g``."""
    ts = [t for t in ts if t.is_floating_point()]
    for t in _dist.sum_(ts, g):
        t.div_(g.size)


class ParameterAveragingTrainer:
    """Train ``net`` with periodic parameter averaging over the mesh's dp
    axis (see the module docstring)."""

    def __init__(self, net, mesh=None, averaging_frequency: int = 5,
                 average_updater_state: bool = True):
        if not net.initialized:
            raise ValueError("initialize the network first (net.init(...))")
        if averaging_frequency < 1:
            raise ValueError("averaging_frequency must be >= 1")
        self.net = net
        self.mesh = mesh if mesh is not None else \
            data_parallel_mesh(device=net.device)
        if "dp" not in self.mesh.axis_names:
            raise ValueError("mesh needs a 'dp' axis")
        self.freq = int(averaging_frequency)
        self.average_updater_state = average_updater_state
        self._dp = self.mesh.group("dp")
        self.n = self._dp.size
        self.rounds = 0
        with torch.no_grad():          # the replicas start equal
            for t in tensors((net.params, net.states)):
                self.mesh.group(*self.mesh.axis_names).broadcast_(t)

    def fit(self, iterator, *, epochs: int = 1):
        """Rounds of ``n_workers × averaging_frequency`` microbatches; a
        shorter tail is trained synchronously (one ``net.fit``; the epoch
        count advances once an epoch either way). Returns the last loss
        as a float."""
        from ..data.dataset import MultiDataSet
        from ..data.iterators import ListDataSetIterator
        net = self.net
        if isinstance(iterator, (list, tuple)) and iterator and \
                isinstance(iterator[0], MultiDataSet):
            raise NotImplementedError(_NOT_MULTI)
        if net._optimizer is None:
            net._build_optimizer(1)
        last = None
        need = self.n * self.freq
        for _ in range(epochs):
            buf = []
            tail_handled = False
            for ds in iterator:
                if isinstance(ds, MultiDataSet) or \
                        isinstance(ds.features, (list, tuple)):
                    raise NotImplementedError(_NOT_MULTI)
                buf.append(ds)
                if len(buf) == need:
                    last = self._run_round(buf)
                    buf = []
            if buf:
                last = net.fit(ListDataSetIterator(
                    buf, batch_size=buf[0].num_examples()))
                tail_handled = True
            if hasattr(iterator, "reset"):
                iterator.reset()
            if not tail_handled:
                net.epoch_count += 1
                for listener in net.listeners:
                    if hasattr(listener, "on_epoch_end"):
                        listener.on_epoch_end(net)
        return None if last is None else float(last)

    def _run_round(self, buf):
        net = self.net
        sizes = {int(ds.features.shape[0]) for ds in buf}
        if len(sizes) > 1:
            raise ValueError("all microbatches in a round must share a "
                             "batch size (got mixed sizes)")
        step = net._train_sentinel()
        mine = buf[self._dp.index * self.freq:
                   (self._dp.index + 1) * self.freq]
        losses = []
        for ds in mine:
            dev = net._to_device
            masks = (None if ds.features_mask is None
                     else dev(ds.features_mask),
                     None if ds.labels_mask is None
                     else dev(ds.labels_mask))
            net._last_batch_size = int(ds.features.shape[0])
            out = step(dev(ds.features), dev(ds.labels), *masks)
            losses.append(out[0] if isinstance(out, tuple) else out)
        with torch.no_grad():
            _average_(tensors(net.params), self._dp)
            if self.average_updater_state:
                _average_(tensors(net._opt_state), self._dp)
            _average_(tensors(net.states), self._dp)
            loss = self._dp.all_reduce_(
                torch.stack(losses).float().mean().reshape(1)) / self.n
        self.rounds += 1
        net._step_count += self.n * self.freq
        if net.listeners:
            lv = float(loss)
            for listener in net.listeners:
                listener.iteration_done(net, net._step_count,
                                        net.epoch_count, lv)
        return loss[0]
