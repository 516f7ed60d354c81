"""The port's native runtime bindings (``utils/native.py``) and async
prefetch (``data/async_iter.py``) against the JAX package's, on the CPU.

- the reference's ``test_native_ring``, ``test_async_iterator_delivers_
  everything``, ``_multidataset_roundtrip`` and ``_propagates_source_
  errors`` (``tests/test_native_and_imports.py``), run on the port, with
  the delivered arrays equal to the reference iterator's;
- a reset mid-epoch restarts the epoch from its first batch;
- the threshold codec, the csv/npy parsers, the staging arena and
  ``f32_to_bf16`` give the reference's results exactly;
- ``fit`` wraps a ``BaseDatasetIterator`` in the prefetch (the native
  ring when it builds) and trains exactly as direct iteration does.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import MnistDataSetIterator as JMnist
from deeplearning4j_tpu.data.async_iter import \
    AsyncDataSetIterator as JAsync
from deeplearning4j_tpu.utils import native as jnative
from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator,
                                           MnistDataSetIterator,
                                           MultiDataSet,
                                           MultipleEpochsIterator)
from deeplearning4j_tpu_torch.data.async_iter import (AsyncDataSetIterator,
                                                      _pack, _unpack,
                                                      maybe_wrap_async)
from deeplearning4j_tpu_torch.utils import native


def test_native_ring():
    if not native.has_native():
        pytest.skip("g++ cannot build the native library here")
    ring = native.NativeRing(slot_size=1024, n_slots=4)
    assert ring.push(b"hello")
    assert ring.push(b"world")
    assert len(ring) == 2
    assert ring.pop() == b"hello"
    assert ring.pop() == b"world"
    assert ring.pop() is None
    for i in range(4):
        assert ring.push(bytes([i]))
    assert not ring.push(b"overflow")  # full
    with pytest.raises(ValueError, match="slot"):
        ring.push(b"x" * 2048)
    ring.close()


def test_async_iterator_delivers_everything():
    base = MnistDataSetIterator(64, train=True, num_examples=256, seed=5)
    ref = JAsync(JMnist(64, train=True, num_examples=256, seed=5),
                 queue_size=2)
    async_it = AsyncDataSetIterator(base, queue_size=2)
    try:
        want = [(np.asarray(d.features), np.asarray(d.labels)) for d in ref]
        got = [(d.features, d.labels) for d in async_it]
        assert sum(len(f) for f, _ in got) == 256
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        async_it.reset()
        seen2 = sum(ds.num_examples() for ds in async_it)
        assert seen2 == 256
        assert async_it.buffer == ("ring" if native.has_native()
                                   else "queue")
        assert async_it.counts[async_it.buffer] == 8
    finally:
        async_it.close()
        ref.close()


def test_async_iterator_multidataset_roundtrip():
    rng = np.random.default_rng(0)
    mds = MultiDataSet(
        [rng.random((4, 3)).astype(np.float32),
         rng.random((4, 2)).astype(np.float32)],
        [rng.random((4, 5)).astype(np.float32)],
        features_masks=[None, rng.random((4, 2)).astype(np.float32)],
        labels_masks=None)
    back = _unpack(_pack(mds))
    assert isinstance(back, MultiDataSet)
    assert len(back.features) == 2 and len(back.labels) == 1
    np.testing.assert_array_equal(back.features[1], mds.features[1])
    np.testing.assert_array_equal(back.labels[0], mds.labels[0])
    assert back.features_masks[0] is None
    np.testing.assert_array_equal(back.features_masks[1],
                                  mds.features_masks[1])
    # a frame from the ring is writable (torch takes it without a copy)
    frame = bytearray(_pack(DataSet(mds.features[0], mds.labels[0])))
    assert _unpack(frame).features.flags.writeable

    class MdsIter:
        batch_size = 4

        def __iter__(self):
            yield mds
            yield mds

    it = AsyncDataSetIterator(MdsIter(), queue_size=2)
    try:
        got = list(it)
        assert len(got) == 2 and isinstance(got[0], MultiDataSet)
    finally:
        it.close()


def test_async_iterator_propagates_source_errors():
    class Poisoned:
        batch_size = 4

        def __iter__(self):
            yield DataSet(np.zeros((4, 2), np.float32),
                          np.zeros((4, 2), np.float32))
            raise OSError("corrupt record")

    async_it = AsyncDataSetIterator(Poisoned(), queue_size=2)
    try:
        with pytest.raises(RuntimeError, match="async data producer failed"):
            for _ in async_it:
                pass
    finally:
        async_it.close()


@pytest.mark.parametrize("use_native", [True, False])
def test_reset_mid_epoch_restarts_the_epoch(use_native):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    y = rng.standard_normal((40, 2)).astype(np.float32)
    it = AsyncDataSetIterator(ListDataSetIterator(DataSet(x, y), 8),
                              queue_size=2, use_native=use_native)
    try:
        first = next(it)
        next(it)
        it.reset()                          # mid-epoch
        again = list(it)
        assert len(again) == 5
        np.testing.assert_array_equal(again[0].features, first.features)
        np.testing.assert_array_equal(
            np.concatenate([d.features for d in again]), x)
        if not use_native:
            assert it.buffer == "queue" and it.counts["ring"] == 0
    finally:
        it.close()


def test_tensor_batches_on_the_host_and_on_a_card():
    """A batch of CPU tensors is packed like numpy (its arrays equal); a
    ListDataSetIterator over tensors on another device (``meta`` stands
    in for the card here) opts out of the prefetch, so ``fit`` iterates it
    directly; a source that yields such a batch anyway fails the producer
    (it must never touch the card), and the consumer re-raises."""
    x = torch.arange(12.0).reshape(6, 2)
    it = AsyncDataSetIterator(ListDataSetIterator(DataSet(x, x), 3),
                              queue_size=2)
    try:
        got = list(it)
        assert torch.equal(torch.as_tensor(np.concatenate(
            [np.asarray(d.features) for d in got])), x)
        assert it.counts == ({"ring": 2, "queue": 0} if it.buffer == "ring"
                             else {"ring": 0, "queue": 2})
        assert "counts=" in repr(it)
    finally:
        it.close()
    wrapped, w = maybe_wrap_async(ListDataSetIterator(DataSet(x, x), 3))
    assert isinstance(wrapped, AsyncDataSetIterator) and w is wrapped
    w.close()
    same, none = maybe_wrap_async([DataSet(x, x)])
    assert none is None and isinstance(same, list)
    m = torch.empty(6, 2, device="meta")
    on_card = ListDataSetIterator(DataSet(m, m), 3)
    assert not on_card.async_supported()
    assert maybe_wrap_async(on_card) == (on_card, None)
    assert not MultipleEpochsIterator(2, on_card).async_supported()

    class OnCard:
        batch_size = 3

        def __iter__(self):
            yield DataSet(m[:3], m[:3])

    it = AsyncDataSetIterator(OnCard(), queue_size=2)
    try:
        with pytest.raises(RuntimeError, match="async data producer") as e:
            list(it)
        assert "async_supported" in str(e.value.__cause__)
    finally:
        it.close()


@pytest.mark.parametrize("use_native", [True, False])
def test_batches_larger_than_a_slot_go_by_reference(use_native):
    """A batch whose frame exceeds ``slot_size`` goes through the queue by
    reference, in order with the framed ones; ``fit`` over it lands bit
    for bit where fit over the same batches in a list lands."""
    from deeplearning4j_tpu_torch import nn, train
    rng = np.random.default_rng(6)
    x = rng.standard_normal((40, 30)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 40)]

    def net():
        conf = (nn.NeuralNetConfiguration.builder().seed(3)
                .updater(train.Adam(1e-2)).list()
                .layer(nn.DenseLayer(n_in=30, n_out=8, activation="tanh"))
                .layer(nn.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                      loss="mcxent")).build())
        return nn.MultiLayerNetwork(conf).init(device="cpu")
    # 16 rows frame to ~2.2 KB, the last 8 rows to ~1.2 KB: one fits
    it = AsyncDataSetIterator(ListDataSetIterator(DataSet(x, y), 16),
                              queue_size=2, use_native=use_native,
                              slot_size=2048)
    a, b = net(), net()
    try:
        la = a.fit(it, epochs=2)
        if it.buffer == "ring":
            assert it.counts == {"ring": 2, "queue": 4}
        else:
            assert it.counts == {"ring": 0, "queue": 6}
    finally:
        it.close()
    lb = b.fit([DataSet(x[i:i + 16], y[i:i + 16]) for i in (0, 16, 32)],
               epochs=2)
    assert la == lb
    for p, q in zip(a.params_flat(), b.params_flat()):
        assert torch.equal(p, q)


def test_codec_parsers_arena_bf16_match_the_reference():
    rng = np.random.default_rng(0)
    g = rng.standard_normal(1000).astype(np.float32) * 0.01
    r1, r2 = np.zeros(1000, np.float32), np.zeros(1000, np.float32)
    t1 = native.threshold_encode(g, r1, 0.02)
    t2 = jnative.threshold_encode(g, r2, 0.02)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(native.threshold_decode(t1, 0.02, 1000),
                                  jnative.threshold_decode(t2, 0.02, 1000))
    dense = native.threshold_decode(t1, 0.02, 1000)
    np.testing.assert_allclose(dense + r1, g, atol=1e-6)
    # error feedback: 5 × 0.004 crosses 0.01 twice
    res, total = np.zeros(10, np.float32), np.zeros(10, np.float32)
    for _ in range(5):
        total += native.threshold_decode(
            native.threshold_encode(np.full(10, 0.004, np.float32), res,
                                    0.01), 0.01, 10)
    np.testing.assert_allclose(total, 0.02, atol=1e-6)
    text = b"1.5, 2.5\n3.0;4.0"
    np.testing.assert_array_equal(native.parse_csv_floats(text, 10),
                                  jnative.parse_csv_floats(text, 10))
    csv = b"a,b,c\n1,2,3\n4,5\n6;7;8\n"
    np.testing.assert_array_equal(native.parse_csv_matrix(csv, 3),
                                  jnative.parse_csv_matrix(csv, 3))
    import io
    buf = io.BytesIO()
    arr = rng.standard_normal((3, 4)).astype(np.float32)
    np.save(buf, arr)
    assert native.npy_header(buf.getvalue()) == \
        jnative.npy_header(buf.getvalue())
    np.testing.assert_array_equal(native.load_npy(buf.getvalue()), arr)
    a = np.asarray([1.0, 3.14159, -2.5e7, 1e-40], np.float32)
    got = native.f32_to_bf16(a)
    assert got.dtype == torch.bfloat16 and got.shape == (4,)
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(jnative.f32_to_bf16(a), np.float32))
    assert torch.equal(got, torch.as_tensor(a).to(torch.bfloat16))
    arena = native.StagingArena(4096, 2)
    b1, b2 = arena.borrow(), arena.borrow()
    assert arena.borrow() is None and arena.in_use == 2
    arena.release(b1)
    with pytest.raises(ValueError):
        arena.release(b1)
    with pytest.raises(RuntimeError, match="still borrowed"):
        arena.close()
    arena.release(b2)
    assert arena.peak == 2
    arena.close()


def test_fit_prefetches_and_trains_as_direct_iteration():
    """MultiLayerNetwork.fit over a ListDataSetIterator goes through the
    prefetch (closed after the loop) and lands bit for bit where fit over
    the same batches in a plain list lands."""
    from deeplearning4j_tpu_torch import nn, train
    rng = np.random.default_rng(5)
    x = rng.standard_normal((48, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 48)]

    def net():
        conf = (nn.NeuralNetConfiguration.builder().seed(3)
                .updater(train.Adam(1e-2)).list()
                .layer(nn.DenseLayer(n_in=4, n_out=8, activation="tanh"))
                .layer(nn.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                      loss="mcxent")).build())
        return nn.MultiLayerNetwork(conf).init(device="cpu")
    a, b = net(), net()
    it = ListDataSetIterator(DataSet(x, y), 16)
    la = a.fit(it, epochs=2)
    assert isinstance(a._prefetch, AsyncDataSetIterator)
    assert a._prefetch.counts[a._prefetch.buffer] == 6
    assert not a._prefetch._thread.is_alive()
    lb = b.fit([DataSet(x[i:i + 16], y[i:i + 16]) for i in (0, 16, 32)],
               epochs=2)
    assert b._prefetch is None
    assert la == lb
    for p, q in zip(a.params_flat(), b.params_flat()):
        assert torch.equal(p, q)


def test_frames_are_reused_only_when_nothing_holds_them():
    """The consumer pops into a pooled frame once no batch (or CPU tensor
    made from one) still views it: batches held by the caller keep their
    values, and a loop that drops each batch reuses one frame or two."""
    if not native.has_native():
        pytest.skip("g++ cannot build the native library here")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((96, 5)).astype(np.float32)
    y = rng.standard_normal((96, 2)).astype(np.float32)
    it = AsyncDataSetIterator(ListDataSetIterator(DataSet(x, y), 8),
                              queue_size=2)
    try:
        held = list(it)                        # every batch kept
        np.testing.assert_array_equal(
            np.concatenate([d.features for d in held]), x)
        kept = torch.as_tensor(held[0].features)   # shares the frame
        del held
        it.reset()
        seen = set()
        for d in it:
            seen.add(d.features.base.__array_interface__["data"][0])
            del d
        assert len(seen) <= 2
        assert torch.equal(kept, torch.as_tensor(x[:8]))
        assert len(it._frames.frames) <= it._frames.size
    finally:
        it.close()
