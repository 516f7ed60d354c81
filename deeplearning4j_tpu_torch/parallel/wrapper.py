"""ParallelWrapper and ParallelInference — port of
``deeplearning4j_tpu/parallel/wrapper.py``
(``org.deeplearning4j.parallelism.ParallelWrapper`` and
``ParallelInference``).

**ParallelWrapper** trains a ``MultiLayerNetwork`` or
``ComputationGraph`` over a :class:`~.mesh.Mesh`'s batch axes (dp, and
fsdp with ``use_fsdp``), with the tp layers of ``parallel/tp.py`` split
over its tp axis. The reference runs one jitted step over the mesh and
GSPMD inserts the collectives; here every rank runs the wrapper (SPMD),
is handed the same global iterator, and takes its own rows of each batch
(a final partial batch is padded to the batch axes only, the padded
rows' masks zero). The step is the global batch's step, as under GSPMD:

- under the step's groups (``_dist.Groups``, handed to the net's loss)
  each rank's loss is its rows' share of the
  global batch's loss (the global count in every mean, masks included;
  the L1/L2 terms a ``1/size`` share), and BatchNormalization takes the
  global batch's statistics (K3's sums or the plain path's, summed over
  the batch group);
- the gradients are summed over the batch group, one all-reduce a dtype
  (a tp-split leaf's first assembled from the tp ranks' slices), then
  every rank runs the same update — the net's own updater, constraints
  and anomaly gate;
- with fsdp the updater's state and the update are split: each rank
  updates its slice of every leaf :func:`~.mesh.shard_params_fsdp`
  splits, then the slices are gathered over fsdp.

At rest every rank holds the whole params and states (the net's own
``output``, ``score`` and serde read them): tp splits the products,
fsdp the updater state and the update; neither splits the params'
memory. The construction broadcasts rank 0's params and states to the
mesh, so the replicas start equal; ``audit_drift`` checks that they
stay so (per-rank checksums gathered over the mesh,
``dl4j_replica_checksum``, ``dl4j_replica_drift_max``).

The step is a :class:`~..nn._compiled.CompiledStep`: on a CUDA mesh over
NCCL each batch signature's second step is captured as a CUDA graph,
collectives included, and replayed after; a gloo group syncs the host in
its collectives, which a capture refuses, so over gloo the steps run
eagerly (``graphs`` says which, and nothing switches between the two on
its own). On the CPU the step is called directly.

**ParallelInference** batches requests in front of the net's inference
forward (dynamic batching, the deadline flush, futures). With a mesh its
batches are split over dp (padded to the dp extent) and the tp layers
split their products; each rank serves its rows and the outputs are
gathered, so every rank gets the whole batch's. Over a mesh of several
ranks every rank calls ``output``/``flush`` with the same batch, so the
deadline timer (which fires on each rank's own clock) is refused there.

**The served weights are a snapshot.** The net's params and states are
cloned onto the serving device at construction: the port's updaters
train in place, so a net trained afterwards serves its old weights until
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
``dl4j_parallel_fit_batches_total``, ``dl4j_inference_requests_total``,
``_deadline_flushes_total``, ``_queue_wait_seconds``,
``_batch_occupancy`` and ``_batches_total``.
"""

from __future__ import annotations

import threading
import time
import zlib
from concurrent.futures import Future, InvalidStateError
from typing import Optional

import torch
import torch.distributed as dist

from .. import _dist
from .._device import resolve_device
from ..nn._compiled import CompiledStep, copy_into, tensors
from ..nn.multi_layer_network import _unflatten
from ..obs import get_registry
from .mesh import data_parallel_mesh, shard_params_fsdp, Sharding, tree_map


def _unpack_batch(ds):
    """DataSet or MultiDataSet -> (features list, labels list, fmask,
    lmask); a MultiDataSet's masks collapse to the single mask the
    network applies, or raise if there are several."""
    feats, labs = ds.features, ds.labels
    if isinstance(feats, (list, tuple)) or isinstance(labs, (list, tuple)):
        def one(ms, what):
            if ms is None:
                return None
            ms = [m for m in ms if m is not None]
            if len(ms) > 1:
                raise NotImplementedError(
                    f"ParallelWrapper supports at most one {what} mask per "
                    "MultiDataSet (the network applies a single mask)")
            return ms[0] if ms else None
        return (list(feats) if isinstance(feats, (list, tuple)) else [feats],
                list(labs) if isinstance(labs, (list, tuple)) else [labs],
                one(getattr(ds, "features_masks", None), "features"),
                one(getattr(ds, "labels_masks", None), "labels"))
    return [feats], [labs], getattr(ds, "features_mask", None), \
        getattr(ds, "labels_mask", None)


def _shard_rows(a, n, index, device, zero=False):
    """Rows ``index`` of ``a`` split into ``n`` equal parts, after padding
    ``a`` to a multiple of ``n``: the last row repeated (batch arrays) or
    zeros (masks, so the padded rows drop out of the loss)."""
    if a is None:
        return None
    a = torch.as_tensor(a)
    pad = (-a.shape[0]) % n
    if pad:
        tail = torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                           device=a.device) if zero else \
            a[-1:].expand((pad,) + tuple(a.shape[1:]))
        a = torch.cat([a, tail])
    b = a.shape[0] // n
    return a[index * b:(index + 1) * b].to(device)


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


def _split_dim(spec, axis):
    """The tensor axis ``spec`` splits over mesh ``axis`` (or None)."""
    for d, a in enumerate(spec):
        if a == axis or (isinstance(a, tuple) and axis in a):
            return d
    return None


class ParallelWrapper:
    """Data-parallel trainer over a mesh's 'dp' (and optional 'fsdp') axis
    (see the module docstring)."""

    def __init__(self, net, mesh=None, use_fsdp: bool = False,
                 drift_audit: bool = True):
        if not net.initialized:
            raise ValueError("initialize the network first (net.init(...))")
        self.net = net
        self.mesh = mesh if mesh is not None else \
            data_parallel_mesh(device=net.device)
        if not self.mesh.member:
            raise ValueError(f"rank {dist.get_rank()} is not in "
                             f"{self.mesh}")
        if self.mesh.device.type != net.device.type:
            raise ValueError(f"the net lives on {net.device}, the mesh "
                             f"computes on {self.mesh.device}")
        self.use_fsdp = use_fsdp and "fsdp" in self.mesh.axis_names
        self.drift_audit = bool(drift_audit)
        m = self.mesh
        self._batch = m.group(*m.batch_axes())
        # batches divide only the axes they are split over: padding to
        # mesh.size on a dp×tp mesh would add unmasked duplicate rows
        self._batch_div = m.batch_size()
        self._shard = m.batch_index()
        self._tp = m.group("tp") if m.shape.get("tp", 1) > 1 else None
        self._groups = _dist.Groups(batch=self._batch, tp=self._tp)
        self._fsdp = m.group("fsdp") if self.use_fsdp else None
        self._all = m.group(*m.axis_names)
        if "tp" in m.axis_names:
            from .tp import network_param_shardings
            self.placements = network_param_shardings(m, net)
            if self.use_fsdp:
                fsdp = shard_params_fsdp(m, net.params)
                self.placements = _merge(self.placements, fsdp)
        elif self.use_fsdp:
            self.placements = shard_params_fsdp(m, net.params)
        else:
            self.placements = tree_map(lambda _: Sharding(m, ()),
                                       net.params)
        from ..train.updaters import tree_leaves
        specs = [s.spec for s in tree_leaves(self.placements)]
        self._tp_leaves = [(i, d) for i, sp in enumerate(specs)
                           if (d := _split_dim(sp, "tp")) is not None
                           and self._tp is not None]
        self._fsdp_leaves = [(i, d) for i, sp in enumerate(specs)
                             if (d := _split_dim(sp, "fsdp")) is not None]
        if self._fsdp_leaves and net._optimizer is not None:
            raise NotImplementedError(
                "fsdp splits the updater state from the start: wrap a net "
                "whose updater is not built yet")
        # one copy of the weights on every rank: rank 0's
        with torch.no_grad():
            for t in tensors((net.params, net.states)):
                self._all.broadcast_(t)
        if self._shard:
            # each batch shard draws its own dropout masks
            net._gen.manual_seed(net._gen.initial_seed() + self._shard)
        cuda = m.device.type == "cuda"
        self.graphs = ("captured (NCCL)" if cuda and dist.get_backend()
                       == "nccl" else "eager (gloo cannot be captured)"
                       if cuda else "direct (CPU)")
        self._step = None
        self._built = None
        self._audit_round = 0

    @property
    def workers(self) -> int:
        return self.mesh.size

    # ------------------------------------------------------------ the step
    def _loss(self, flat):
        net = self.net
        from ..nn.computation_graph import ComputationGraph
        fm, lm = flat[-2], flat[-1]
        if isinstance(net, ComputationGraph):
            ni = len(net.conf.inputs)
            return net._loss(net.params, net.states,
                             dict(zip(net.conf.inputs, flat[:ni])),
                             dict(zip(net.conf.outputs, flat[ni:-2])),
                             net._gen, fm, lm, self._groups)
        return net._loss(net.params, net.states, flat[0], flat[1],
                         net._gen, fm, lm, self._groups)

    def _reduced_grads(self, flat):
        """(global loss, new states, the global batch's gradient tree) of
        this rank's rows ``flat`` (features, labels, fmask, lmask)."""
        net = self.net
        from ..train.updaters import tree_leaves
        leaves = tree_leaves(net.params)
        loss, new_states = self._loss(flat)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, gs)]
        for i, d in self._tp_leaves:
            # the loss is the same on every tp rank: a split leaf's
            # gradient is its owner's slice
            lo, hi = self._tp.slice_of(gs[i].shape[d])
            gs[i] = self._tp.all_gather(gs[i].narrow(d, lo, hi - lo), dim=d)
        _dist.sum_(gs + [loss := loss.detach().reshape(1).clone()],
                   self._batch)
        return loss.reshape(()), new_states, \
            _unflatten(net.params, iter(gs))

    def _shards(self, tree):
        """``tree`` (shaped like the params) with each fsdp leaf narrowed
        to this rank's slice (views)."""
        from ..train.updaters import tree_leaves
        leaves = list(tree_leaves(tree))
        for i, d in self._fsdp_leaves:
            lo, hi = self._fsdp.slice_of(leaves[i].shape[d])
            leaves[i] = leaves[i].narrow(d, lo, hi - lo)
        return _unflatten(tree, iter(leaves))

    def _static_step(self, *flat):
        from ..nn.multi_layer_network import _update_in_place
        net = self.net
        loss, new_states, grads = self._reduced_grads(flat)
        if not self._fsdp_leaves:
            return _update_in_place(net, loss, new_states, grads)
        from ..train.updaters import apply_updates, tree_leaves
        with torch.no_grad():
            shards = self._shards(net.params)
            updates, _ = net._optimizer.update(self._shards(grads),
                                               net._opt_state, shards)
            apply_updates(tree_leaves(shards), tree_leaves(updates))
            leaves = tree_leaves(net.params)
            for i, d in self._fsdp_leaves:
                lo, hi = self._fsdp.slice_of(leaves[i].shape[d])
                leaves[i].copy_(self._fsdp.all_gather(
                    leaves[i].narrow(d, lo, hi - lo), dim=d))
            net._apply_constraints()
            copy_into(net.states, new_states)
        return loss

    def _ensure_optimizer(self, iters_per_epoch=1):
        net = self.net
        if net._optimizer is not None:
            return
        net._build_optimizer(iters_per_epoch)
        if self._fsdp_leaves:
            if net._g.grad_norm not in (None, "none", "None"):
                raise NotImplementedError(
                    "gradient normalization over fsdp slices is not ported")
            with torch.no_grad():
                net._opt_state = net._optimizer.init(self._shards(net.params))

    def _compiled(self):
        net = self.net
        det = getattr(net, "_anomaly_detector", None)
        want = (getattr(net, "remat_segments", None), det is not None,
                det is not None and det.gate_updates)
        if self._step is not None and self._built != want:
            self._step = None       # remat or the detector changed
        if self._step is None:
            if det is not None and self._fsdp_leaves:
                raise NotImplementedError(
                    "the anomaly gate over fsdp slices is not ported")
            host = net._compiled_step().eager
            gloo_cuda = self.mesh.device.type == "cuda" and \
                dist.get_backend() != "nccl"
            self._step = CompiledStep(
                self._static_step,
                lambda: tensors((net.params, net.states, net._opt_state))
                + [net._gen], "ParallelWrapper", eager=host or gloo_cuda)
            self._built = want
        return self._step

    def _local(self, ds):
        """This rank's rows of a global batch, on the mesh's device, in
        the step's order; and the global batch's row count."""
        feats, labs, fm, lm = _unpack_batch(ds)
        n, i, dev = self._batch_div, self._shard, self.mesh.device
        flat = [_shard_rows(a, n, i, dev) for a in (*feats, *labs)]
        flat += [_shard_rows(fm, n, i, dev, zero=True),
                 _shard_rows(lm, n, i, dev, zero=True)]
        return flat, int(feats[0].shape[0])

    # ------------------------------------------------------------------ fit
    def fit(self, iterator, *, epochs: int = 1):
        """One step of the global batch per batch of ``iterator`` (the
        same iterator on every rank); returns the last loss as a float."""
        from ..nn._fit_loop import fit_epochs
        from ..data.dataset import DataSet, MultiDataSet
        net = self.net
        if isinstance(iterator, (DataSet, MultiDataSet)):
            iterator = [iterator]
        try:
            ipe = len(iterator)
        except TypeError:
            ipe = 1
        self._ensure_optimizer(max(int(ipe), 1))
        step = self._compiled()
        m_batches = get_registry().counter(
            "dl4j_parallel_fit_batches_total",
            "Batches stepped through ParallelWrapper.fit")
        self._census()

        def step_batch(ds):
            flat, rows = self._local(ds)
            net._last_batch_size = rows      # telemetry: pre-pad rows
            out = step(*flat)
            m_batches.inc()
            return out

        last = fit_epochs(net, iterator, epochs, step_batch)
        if self.drift_audit and self.workers > 1:
            self.audit_drift()
        return None if last is None else float(last)

    def gradient_and_score(self, ds):
        """(the global batch's gradient tree, its loss) at the current
        params, with no update: every rank passes the same ``ds``."""
        flat, _ = self._local(ds)
        loss, _, grads = self._reduced_grads(flat)
        return grads, float(loss)

    def _census(self):
        # per replica, once a fit call: what each rank holds
        try:
            from ..obs import memory as obs_memory
            net = self.net
            components = {"params": net.params, "states": net.states}
            if net._opt_state is not None:
                components["optimizer"] = net._opt_state
            obs_memory.emit_census(components, source="parallel_fit",
                                   replica=str(dist.get_rank()),
                                   per_replica=True)
        except Exception:  # noqa: BLE001 — the census is decoration
            pass

    def audit_drift(self):
        """Checksum every rank's copy of the replicated params now and
        compare them over the mesh: ``{round, replicas, max_drift,
        bit_identical}``. tp- and fsdp-split leaves count as whole (at
        rest every rank holds them whole)."""
        from ..train.updaters import tree_leaves
        total, crc = 0.0, 0
        for t in tree_leaves(self.net.params):
            a = t.detach().cpu().contiguous()
            total += float(a.double().sum())
            crc = zlib.crc32(a.view(torch.uint8).numpy().tobytes(), crc)
        dev = self.mesh.device if dist.get_backend() == "nccl" else "cpu"
        mine = torch.tensor([[total, float(crc)]], dtype=torch.float64,
                            device=dev)
        every = self._all.all_gather(mine).cpu()
        sums, crcs = every[:, 0].tolist(), every[:, 1].tolist()
        self._audit_round += 1
        reg = get_registry()
        reg.gauge("dl4j_replica_checksum", "Sum of every param of a "
                  "replica at the last drift audit",
                  labelnames=("replica",)).labels(
            replica=str(dist.get_rank())).set(total)
        drift = max(sums) - min(sums)
        reg.gauge("dl4j_replica_drift_max", "Largest checksum difference "
                  "between replicas at the last drift audit").set(drift)
        return {"round": self._audit_round,
                "replicas": list(self._all.ranks), "max_drift": drift,
                "bit_identical": len(set(crcs)) == 1}

    def fit_scanned(self, data, *, epochs: int = 1):
        """The epoch's equally-shaped batches stacked once on the device
        (this rank's rows of each) and stepped by the compiled step, one
        replay a batch — the same trajectory as ``fit``. Same
        restrictions as ``net.fit_scanned``: no masks, no anomaly gating,
        deferred-score listeners only; single-arm DataSet batches
        (MultiDataSet: use ``fit()``); the batch must divide the mesh's
        batch axes."""
        from ..nn._scan_common import check_scan_listeners, \
            replay_scan_listeners
        net = self.net
        batches = [data] if not isinstance(data, (list, tuple)) \
            else list(data)
        if not batches:
            return None
        if any(isinstance(b.features, (list, tuple)) for b in batches):
            raise ValueError("fit_scanned supports single-arm DataSet "
                             "batches; use fit() for MultiDataSet")
        if any(getattr(b, "features_mask", None) is not None
               or getattr(b, "labels_mask", None) is not None
               for b in batches):
            raise ValueError("fit_scanned does not support masked batches; "
                             "use fit()")
        shapes = {(tuple(b.features.shape), tuple(b.labels.shape))
                  for b in batches}
        if len(shapes) > 1:
            raise ValueError(f"fit_scanned needs equally-shaped batches, "
                             f"got {sorted(shapes)}; use fit()")
        if batches[0].features.shape[0] % self._batch_div:
            raise ValueError(
                f"batch size {batches[0].features.shape[0]} must divide "
                f"the mesh batch axes ({self._batch_div}) — fit_scanned "
                "does not pad")
        check_scan_listeners(net)
        if epochs <= 0:
            return None
        self._ensure_optimizer(len(batches))
        step = self._compiled()
        local = [self._local(b)[0] for b in batches]
        xs = torch.stack([f[0] for f in local])
        ys = torch.stack([f[1] for f in local])
        net._last_batch_size = int(batches[0].features.shape[0])
        losses = None
        for _ in range(epochs):
            losses = torch.stack([step(xs[i], ys[i], None, None)
                                  for i in range(len(batches))])
            net._step_count += len(batches)
            net.epoch_count += 1
            replay_scan_listeners(net, losses, len(batches))
        return float(losses[-1])


def _merge(tp, fsdp):
    """tp's placements, with fsdp's where tp left a leaf replicated (the
    two compose, as in the reference)."""
    if isinstance(tp, dict):
        return {k: _merge(tp[k], fsdp[k]) for k in tp}
    if isinstance(tp, list):
        return [_merge(a, b) for a, b in zip(tp, fsdp)]
    return fsdp if tp.spec == () else tp


class ParallelInference:
    """Batched inference of ``net`` (a ``MultiLayerNetwork``,
    ``ComputationGraph`` or ``FunctionalInferenceModel``) on one device,
    or over a mesh's dp and tp axes (see the module docstring).
    ``device=None`` means the CUDA card (a mesh's device with a mesh)."""

    def __init__(self, net, mesh=None, max_batch: int = 64,
                 max_wait_ms: Optional[float] = None, *, device=None):
        self.net = net
        self.mesh = mesh
        self._dp = self._tp = None
        if mesh is not None:
            if device is not None and \
                    resolve_device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            if mesh.size > 1 and max_wait_ms is not None:
                raise ValueError(
                    "a deadline flush fires on each rank's own clock, so a "
                    "mesh of several ranks cannot take max_wait_ms: every "
                    "rank flushes the same batch with flush()")
            self.device = mesh.device
            self._dp = mesh.group("dp")
            if mesh.shape.get("tp", 1) > 1:
                from .tp import network_param_shardings
                network_param_shardings(mesh, net)   # validates the split
                self._tp = mesh.group("tp")
        else:
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
        # the tp layers' group, for a net over a mesh with a tp axis
        kw = {} if self._tp is None else {
            "groups": _dist.Groups(tp=self._tp)}

        if isinstance(net, ComputationGraph):
            def forward(*xs):
                acts, _, _ = net._forward(self._params, self._states, xs,
                                          train=False, rng=None, **kw)
                outs = tuple(acts[o] for o in net.conf.outputs)
                return outs[0] if len(outs) == 1 else outs
        else:
            def forward(*xs):
                y, _ = net._forward(self._params, self._states,
                                    xs[0] if len(xs) == 1 else xs,
                                    train=False, rng=None, **kw)
                return y

        def infer(*xs):
            with torch.no_grad():
                out = forward(*xs)
                if self._dp is None:
                    return out
                # each dp rank served its rows: every rank gets them all
                if isinstance(out, tuple):
                    return tuple(self._dp.all_gather(o) for o in out)
                return self._dp.all_gather(out)

        self._infer = CompiledStep(
            infer, lambda: tensors((self._params, self._states)),
            "ParallelInference")
        return self._infer

    def _run(self, x, capture):
        fn = self._infer or self._build()
        multi = isinstance(x, (list, tuple))   # multi-input ComputationGraph
        xs = list(x) if multi else [x]
        if self._dp is None:
            xs = [torch.as_tensor(a, device=self.device) for a in xs]
            out = fn(*xs, capture=capture)
            return list(out) if isinstance(out, tuple) else out
        rows = int(xs[0].shape[0])
        xs = [_shard_rows(a, self._dp.size, self._dp.index, self.device)
              for a in xs]
        out = fn(*xs, capture=capture)
        if isinstance(out, tuple):
            return [o[:rows] for o in out]
        return out[:rows]

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
