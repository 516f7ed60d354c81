"""AsyncDataSetIterator — port of ``deeplearning4j_tpu/data/async_iter.py``
(``org.deeplearning4j.datasets.iterator.AsyncDataSetIterator``: a worker
thread and a bounded buffer, so host ETL overlaps device compute).

A producer thread runs the source iterator up to ``queue_size`` batches
ahead of the consumer. Batches are host arrays (numpy, CPU tensors):

- each is packed into one byte frame (:func:`_pack`) and pushed through
  the native SPSC ring (``utils/native.py``); every copy of a batch (into
  the frame, into and out of the ring) runs without the GIL, and the
  consumer reads the arrays as views of the popped frame. A Python queue
  carries one entry a batch, in the source's order (the frame's size, or
  the batch itself), so both sides block on it and on a count of free
  slots instead of polling the ring;
- a batch whose frame would not fit a ring slot (``slot_size``), and
  every batch where the native library does not load (as in the
  reference), goes through the queue by reference.

``buffer`` says which buffer ran ("ring" or "queue") and ``counts`` how
many batches came each way ("ring", "queue").

The producer never touches the card: a CUDA call from another thread
while a train step is being captured would fail the capture. An iterator
whose batches already live on the card has nothing to prefetch and says
so (``async_supported()`` is False, so ``fit`` iterates it directly); a
source that yields a batch on the card anyway fails the producer, and the
consumer re-raises the error.

``reset()`` swaps in a fresh ring/queue generation before restarting the
producer: an old producer blocked on a full buffer keeps writing (and
sentinel-ing) only its own abandoned generation, so a stale sentinel can
never truncate the next epoch. A source error is re-raised on the
consumer's side.
"""

from __future__ import annotations

import json
import queue
import sys
import threading
from typing import Optional

import numpy as np
import torch

from .dataset import DataSet, MultiDataSet

_SENTINEL = b"__END__"
_WAIT_S = 0.1           # how often a blocked producer looks at its stop flag


def _arrays(ds):
    if isinstance(ds, MultiDataSet):
        return [*ds.features, *ds.labels, *(ds.features_masks or []),
                *(ds.labels_masks or [])]
    return [ds.features, ds.labels, ds.features_mask, ds.labels_mask]


def on_device(ds) -> bool:
    """Does a batch hold a tensor on the card?"""
    return any(isinstance(a, torch.Tensor) and a.device.type != "cpu"
               for a in _arrays(ds))


def _host(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else a


def _parts(ds):
    """A batch's arrays by the reference's npz names (absent masks left
    out)."""
    if isinstance(ds, MultiDataSet):
        parts = {}
        for i, f in enumerate(ds.features):
            parts[f"mf{i}"] = f
        for i, l in enumerate(ds.labels):
            parts[f"ml{i}"] = l
        for i, m in enumerate(ds.features_masks or []):
            if m is not None:
                parts[f"mfm{i}"] = m
        for i, m in enumerate(ds.labels_masks or []):
            if m is not None:
                parts[f"mlm{i}"] = m
        return parts
    parts = {"features": ds.features, "labels": ds.labels}
    if ds.features_mask is not None:
        parts["features_mask"] = ds.features_mask
    if ds.labels_mask is not None:
        parts["labels_mask"] = ds.labels_mask
    return parts


class _Layout:
    """Where :func:`_pack` puts a batch's arrays: a length-prefixed JSON
    header (each array's name, dtype, shape and offset), then the arrays,
    each at a 64-byte aligned offset. ``nbytes`` is the frame's size."""

    def __init__(self, ds):
        self.arrays = [(k, np.ascontiguousarray(_host(v)))
                       for k, v in _parts(ds).items()]
        self.head, off = [], 0
        for k, a in self.arrays:
            self.head.append([k, a.dtype.str, a.shape, off])
            off += -(-a.nbytes // 64) * 64
        self.text = json.dumps(self.head).encode()
        self.start = -(-(8 + len(self.text)) // 64) * 64
        self.nbytes = self.start + off


def _pack(ds, layout: Optional[_Layout] = None,
          out: Optional[np.ndarray] = None) -> np.ndarray:
    """One ring slot: the batch's arrays in :class:`_Layout`'s frame, one
    uint8 array (the first bytes of ``out`` where it is given). The
    reference packs an npz; this frame is filled by numpy copies that
    release the GIL, and read back as views (unpacking the npz of a 1.6 MB
    LeNet batch took 1.7 ms of the consumer's host time)."""
    lay = layout or _Layout(ds)
    frame = np.empty(lay.nbytes, np.uint8) if out is None \
        else out[:lay.nbytes]
    frame[:8] = np.frombuffer(len(lay.text).to_bytes(8, "little"), np.uint8)
    frame[8:8 + len(lay.text)] = np.frombuffer(lay.text, np.uint8)
    for (_, a), (_, _, _, at) in zip(lay.arrays, lay.head):
        np.copyto(frame[lay.start + at:lay.start + at + a.nbytes]
                  .view(a.dtype).reshape(a.shape), a)
    return frame


def _unpack(raw):
    """A batch from :func:`_pack`'s frame: numpy views of ``raw``."""
    raw = np.frombuffer(raw, np.uint8) if not isinstance(raw, np.ndarray) \
        else raw
    n = int.from_bytes(raw[:8].tobytes(), "little")
    start = -(-(8 + n) // 64) * 64
    z = {}
    for name, dtype, shape, at in json.loads(raw[8:8 + n].tobytes()):
        dt = np.dtype(dtype)
        count = int(np.prod(shape)) if shape else 1
        z[name] = raw[start + at:start + at + count * dt.itemsize] \
            .view(dt).reshape(shape)
    if "features" in z:
        return DataSet(z["features"], z["labels"], z.get("features_mask"),
                       z.get("labels_mask"))

    def series(prefix):
        out = []
        while f"{prefix}{len(out)}" in z:
            out.append(z[f"{prefix}{len(out)}"])
        return out
    feats, labs = series("mf"), series("ml")
    fmasks = [z.get(f"mfm{i}") for i in range(len(feats))]
    lmasks = [z.get(f"mlm{i}") for i in range(len(labs))]
    return MultiDataSet(
        feats, labs,
        fmasks if any(m is not None for m in fmasks) else None,
        lmasks if any(m is not None for m in lmasks) else None)


def maybe_wrap_async(iterator, queue_size: int = 2):
    """(possibly-wrapped iterator, wrapper-or-None): wrap when the source
    opts in via async_supported() and isn't already async — the shared
    policy for MultiLayerNetwork.fit and ComputationGraph.fit."""
    if getattr(iterator, "async_supported", lambda: False)() \
            and not isinstance(iterator, AsyncDataSetIterator):
        wrapped = AsyncDataSetIterator(iterator, queue_size=queue_size)
        return wrapped, wrapped
    return iterator, None


class _Generation:
    """One producer's buffers: the ring (or None), the queue of entries,
    the count of free ring slots, its stop flag and the error it hit, and
    the host buffer it packs each frame in before the ring copies it."""

    def __init__(self, ring, queue_size: int):
        self.ring = ring
        self.q = queue.Queue(maxsize=queue_size)
        self.free = threading.Semaphore(queue_size)
        self.stop = threading.Event()
        self.error = []
        self.pack_buf = np.empty(0, np.uint8)


class _FramePool:
    """The consumer's frames, reused once nothing holds them: a popped
    frame's arrays are views of it, so while a batch (or a CPU tensor made
    from one) is alive the frame has more references than the pool's and
    is left alone. Reused frames are resident, so a pop does not fault
    their pages in again."""

    def __init__(self, size: int):
        self.size = size
        self.frames = []

    def take(self, n: int) -> np.ndarray:
        for buf in self.frames:
            # the list's reference, ``buf`` and getrefcount's argument
            if buf.nbytes >= n and sys.getrefcount(buf) == 3:
                return buf[:n]
        buf = np.empty(n, np.uint8)
        if len(self.frames) >= self.size:
            self.frames.pop(0)
        self.frames.append(buf)
        return buf


class AsyncDataSetIterator:
    def __init__(self, inner, queue_size: int = 4, use_native: bool = True,
                 slot_size: int = 64 << 20):
        self.inner = inner
        self.queue_size = queue_size
        self.use_native = use_native
        self.slot_size = slot_size
        self.batch_size = getattr(inner, "batch_size", None)
        self.counts = {"ring": 0, "queue": 0}
        self._frames = _FramePool(queue_size + 2)
        self._gen: Optional[_Generation] = None
        self._thread: Optional[threading.Thread] = None
        self._start()

    @property
    def buffer(self) -> str:
        """The buffer host batches go through: "ring" or "queue"."""
        return self._buffer

    def __repr__(self):
        return (f"AsyncDataSetIterator(buffer={self.buffer}, "
                f"counts={self.counts}, inner={type(self.inner).__name__})")

    def _new_ring(self):
        if not self.use_native:
            return None
        try:
            from ..utils.native import NativeRing
            return NativeRing(self.slot_size, self.queue_size)
        except Exception:  # noqa: BLE001 — fall back to the queue
            return None

    # ------------------------------------------------------------- producer
    def _start(self):
        self._gen = _Generation(self._new_ring(), self.queue_size)
        self._buffer = "ring" if self._gen.ring is not None else "queue"
        self._thread = threading.Thread(target=self._produce,
                                        args=(self._gen,), daemon=True)
        self._thread.start()

    @staticmethod
    def _put(gen, item) -> bool:
        """Queue one entry; False when the generation was stopped."""
        while not gen.stop.is_set():
            try:
                gen.q.put(item, timeout=_WAIT_S)
                return True
            except queue.Full:
                continue
        return False

    def _send(self, gen, ds) -> bool:
        """Hand one batch over: its frame through the ring when it fits a
        slot, else the batch itself through the queue."""
        if gen.ring is not None:
            lay = _Layout(ds)
            if lay.nbytes <= self.slot_size:
                while not gen.free.acquire(timeout=_WAIT_S):
                    if gen.stop.is_set():
                        return False
                if gen.pack_buf.nbytes < lay.nbytes:
                    gen.pack_buf = np.empty(lay.nbytes, np.uint8)
                if not gen.ring.push(_pack(ds, lay, gen.pack_buf)):
                    raise RuntimeError("ring full with a slot counted free")
                return self._put(gen, lay.nbytes)
        return self._put(gen, ds)

    def _produce(self, gen):
        """Writes ONLY to its own generation: after reset() it is
        abandoned and nothing here touches the live one. A source
        exception is captured into ``gen.error`` and re-raised on the
        consumer's side at the sentinel."""
        try:
            for ds in self.inner:
                if on_device(ds):
                    raise ValueError(
                        "a batch on the card reached the prefetch; an "
                        "iterator whose batches live on the card must "
                        "return False from async_supported() (fit then "
                        "iterates it directly)")
                if not self._send(gen, ds):
                    return
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            gen.error.append(e)
        finally:
            self._put(gen, _SENTINEL)

    # ------------------------------------------------------------- consumer
    def __iter__(self):
        return self

    def __next__(self):
        gen = self._gen
        item = gen.q.get()
        if isinstance(item, bytes) and item == _SENTINEL:
            self._raise_producer_error()
            raise StopIteration
        if isinstance(item, int):
            frame = self._frames.take(item)
            if gen.ring.pop_into(frame) != item:
                raise RuntimeError("the ring lost a queued frame")
            gen.free.release()
            self.counts["ring"] += 1
            return _unpack(frame)
        self.counts["queue"] += 1
        return item

    def _raise_producer_error(self):
        if self._gen.error:
            raise RuntimeError(
                "async data producer failed mid-epoch (source iterator "
                "raised) — training would silently truncate"
            ) from self._gen.error[0]

    def __len__(self):
        return len(self.inner)

    def _stop_producer(self):
        """Stop the live generation; True when its producer exited."""
        self._gen.stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        return self._thread is None or not self._thread.is_alive()

    def reset(self):
        old = self._gen
        exited = self._stop_producer()
        if hasattr(self.inner, "reset"):
            self.inner.reset()
        self._start()  # fresh generation: new ring/queue/stop event
        # free the old ring ONLY if its producer actually exited (a live
        # producer pushing into freed memory would be use-after-free)
        if old.ring is not None and exited:
            old.ring.close()

    def total_outcomes(self):
        return getattr(self.inner, "total_outcomes", lambda: -1)()

    def close(self):
        if self._stop_producer() and self._gen.ring is not None:
            self._gen.ring.close()
