"""The port's ``ParallelInference`` (one device) and
``FunctionalInferenceModel`` against the JAX package's.

The cases of ``tests/test_serving.py:572-638`` and
``tests/test_parallel.py:679, :812`` run through both packages on nets
with shared weights (the JAX net's params carried across as numpy): the
served outputs agree to f32 rounding (atol 1e-5), and the serving
metrics the two registries gained in each case (requests, deadline
flushes, batches, the occupancy gauge, queue-wait observations) are
equal. Then the port's own contracts: the served snapshot and
``refresh``, the capture rule (only a caller's thread may capture; the
deadline timer's flush calls its step with ``capture=False``), and a
clean interpreter exit with an armed timer and a live scheduler.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nn as jnn
from deeplearning4j_tpu import train as jtrain
from deeplearning4j_tpu.obs import get_registry as jreg
from deeplearning4j_tpu.parallel import ParallelInference as JPI
from deeplearning4j_tpu.serving import FunctionalInferenceModel as JFIM
from deeplearning4j_tpu.zoo import transformer as jtfm
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch import train as ttrain
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.obs import get_registry as treg
from deeplearning4j_tpu_torch.parallel import ParallelInference as TPI
from deeplearning4j_tpu_torch.serving import FunctionalInferenceModel as TFIM
from deeplearning4j_tpu_torch.zoo import transformer as ttfm

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
METRICS = ("dl4j_inference_requests_total",
           "dl4j_inference_deadline_flushes_total",
           "dl4j_inference_batches_total")


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _metrics(reg):
    out = {}
    for name in METRICS:
        m = reg.get(name)
        out[name] = 0.0 if m is None else m.value()
    h = reg.get("dl4j_inference_queue_wait_seconds")
    out["queue_wait_count"] = 0 if h is None else h.count()
    g = reg.get("dl4j_inference_batch_occupancy")
    out["occupancy"] = None if g is None else g.value()
    return out


def _delta(before, after):
    return {k: (after[k] if k == "occupancy" else after[k] - before[k])
            for k in after}


class _Both:
    """Run one case through both packages; compare the metric deltas."""

    def __enter__(self):
        self.before = (_metrics(jreg()), _metrics(treg()))
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            jd = _delta(self.before[0], _metrics(jreg()))
            td = _delta(self.before[1], _metrics(treg()))
            assert td == jd, (td, jd)


def _np(x):
    if isinstance(x, list):
        return [_np(a) for a in x]
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _mlp_conf(nn, train):
    return (nn.NeuralNetConfiguration.builder().seed(1)
            .updater(train.Adam(1e-3))
            .list()
            .layer(nn.DenseLayer(n_in=6, n_out=8, activation="relu"))
            .layer(nn.OutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .build())


@pytest.fixture
def mlp():
    jnet = jnn.MultiLayerNetwork(_mlp_conf(jnn, jtrain)).init((6,))
    tnet = tnn.MultiLayerNetwork(_mlp_conf(tnn, ttrain)).init(
        (6,), device="cpu")
    tnet.params, tnet.states = tnn.params_from_numpy(
        _np_tree(jnet.params), _np_tree(jnet.states), "cpu")
    return jnet, tnet


def _small_cg(nn, train, seed=7):
    """tests/test_parallel.py:740's residual conv graph."""
    b = nn.NeuralNetConfiguration.builder().seed(seed).updater(
        train.Sgd(0.1))
    g = b.graph_builder().add_inputs("in")
    g.add_layer("c1", nn.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                          convolution_mode="same",
                                          activation="identity"), "in")
    g.add_layer("bn1", nn.BatchNormalization(activation="relu"), "c1")
    g.add_layer("c2", nn.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                          convolution_mode="same",
                                          activation="identity"), "bn1")
    g.add_layer("bn2", nn.BatchNormalization(activation="identity"), "c2")
    g.add_vertex("add", nn.ElementWiseVertex(op="add"), "bn2", "bn1")
    g.add_layer("act", nn.ActivationLayer(activation="relu"), "add")
    g.add_layer("out", nn.OutputLayer(n_out=5, activation="softmax",
                                      loss="mcxent"), "act")
    g.set_outputs("out")
    g.set_input_types(nn.InputType.convolutional(8, 8, 3))
    return g.build()


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------- tests/test_serving.py:572-638

def test_deadline_flush(mlp):
    """A trickle below max_batch flushes at the max_wait_ms deadline —
    the future resolves without anyone calling flush()."""
    jnet, tnet = mlp
    x = _x((4, 6))
    with _Both():
        jpi = JPI(jnet, max_batch=64, max_wait_ms=30)
        want = jpi.submit(x).result(timeout=30)
        tpi = TPI(tnet, max_batch=64, max_wait_ms=30, device="cpu")
        fut = tpi.submit(x)
        got = fut.result(timeout=30)
    assert got.shape == (4, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    assert tpi._pending == [] and tpi._timer is None
    assert treg().get("dl4j_inference_deadline_flushes_total").value() >= 1


def test_threshold_flush_keeps_legacy_contract(mlp):
    jnet, tnet = mlp
    outs = {}
    with _Both():
        for name, pi in (("jax", JPI(jnet, max_batch=8, max_wait_ms=10_000)),
                         ("port", TPI(tnet, max_batch=8, max_wait_ms=10_000,
                                      device="cpu"))):
            f1 = pi.submit(np.zeros((4, 6), np.float32))
            parts = pi.submit(np.ones((4, 6), np.float32))
            assert isinstance(parts, list) and len(parts) == 2  # inline
            assert f1.done() and f1.result().shape == (4, 3)
            assert pi._timer is None            # deadline timer cancelled
            outs[name] = parts
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)


def test_cancelled_future_doesnt_starve_batch(mlp):
    """One caller cancelling its queued request must not stop the other
    futures in the same dynamic batch from resolving."""
    jnet, tnet = mlp
    outs = {}
    with _Both():
        for name, pi in (("jax", JPI(jnet, max_batch=64)),
                         ("port", TPI(tnet, max_batch=64, device="cpu"))):
            f1 = pi.submit(np.zeros((2, 6), np.float32))
            f2 = pi.submit(np.ones((3, 6), np.float32))
            assert f1.cancel()
            parts = pi.flush()
            assert len(parts) == 2          # rows still computed, returned
            assert f2.result(timeout=5).shape == (3, 3)
            assert f1.cancelled()
            outs[name] = parts
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)


def test_mixed_shape_raises(mlp):
    jnet, tnet = mlp
    with _Both():
        for pi in (JPI(jnet, max_batch=64),
                   TPI(tnet, max_batch=64, device="cpu")):
            pi.submit(np.zeros((2, 6), np.float32))
            with pytest.raises(ValueError, match="mixed-shape"):
                pi.submit(np.zeros((2, 7), np.float32))
            assert len(pi.flush()) == 1     # the well-shaped one serves
            assert pi.flush() == []


@pytest.mark.parametrize("with_mask", [False, True])
def test_functional_adapter_serves_bert(with_mask):
    """FunctionalInferenceModel: the functional BERT encoder runs through
    the dynamic-batching front end like any net, in both packages."""
    kw = dict(vocab_size=40, d_model=16, n_heads=2, n_layers=1, d_ff=32,
              max_seq=8)
    jc = jtfm.BertConfig(dtype=jnp.float32, **kw)
    tc = ttfm.BertConfig(dtype=torch.float32, **kw)
    jp = jtfm.bert_init(jax.random.PRNGKey(0), jc)
    jp["cls"] = 0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                        jp["cls"].shape)
    tp = ttfm.bert_params_from_numpy(_np_tree(jp), tc, device="cpu")
    rng = np.random.default_rng(61)
    ids = rng.integers(0, 40, (2, 8)).astype(np.int32)
    if with_mask:
        jfwd = (lambda p, x: jtfm.bert_forward(p, jc, x[0],
                                               attn_mask=x[1])[0])
        tfwd = (lambda p, x: ttfm.bert_forward(p, tc, x[0],
                                               attn_mask=x[1])[0])
        mask = np.ones((2, 8), np.int32)
        mask[1, 5:] = 0
        arg = [ids, mask]
    else:
        jfwd = lambda p, x: jtfm.bert_forward(p, jc, x)[0]   # noqa: E731
        tfwd = lambda p, x: ttfm.bert_forward(p, tc, x)[0]   # noqa: E731
        arg = ids
    with _Both():
        want = JPI(JFIM(jp, jfwd), max_batch=4).output(arg)
        got = TPI(TFIM(tp, tfwd), max_batch=4, device="cpu").output(arg)
    direct = ttfm.bert_forward(tp, tc, torch.as_tensor(ids),
                               attn_mask=(torch.as_tensor(arg[1])
                                          if with_mask else None))[0]
    assert torch.equal(got, direct)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_functional_adapter_shape():
    params = {"w": torch.ones((3, 2))}
    m = TFIM(params, lambda p, x: x @ p["w"])
    assert m.params == {"model": params} and m.states == {}
    assert m.conf.nodes == {} and m.initialized
    y, st = m._forward(m.params, m.states, torch.ones((4, 3)))
    assert torch.equal(y, torch.full((4, 2), 3.0)) and st == {}


# ------------------------------------ tests/test_parallel.py:679, :812

def test_does_not_mutate_net_and_serves_a_snapshot(mlp):
    """Serving never touches the trainer's tensors, and the port's
    in-place updaters do not move what is served: training the net after
    the ParallelInference is built changes nothing served until
    ``refresh()``, which copies the new values into the same storage."""
    jnet, tnet = mlp
    rng = np.random.default_rng(0)
    X = rng.random((16, 6), np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    with _Both():
        jpi = JPI(jnet, max_batch=64)
        tpi = TPI(tnet, max_batch=64, device="cpu")
        before = tpi.output(X[:5]).clone()
        np.testing.assert_allclose(_np(before), np.asarray(jpi.output(X[:5])),
                                   atol=ATOL)
        trained = [p for p in tnet.params["layer_0"].values()]
        ptrs = [t.data_ptr() for t in ttfm.param_leaves(tpi._params)]
        jnet.fit(jnn_dataset(X, Y))
        tnet.fit(DataSet(X, Y))
        assert tnet.params["layer_0"]["W"] is trained[0]   # in place
        assert torch.equal(tpi.output(X[:5]), before)      # snapshot
        after = tpi.refresh().output(X[:5])
        want = jpi.refresh().output(X[:5])
    assert not torch.equal(after, before)
    assert torch.equal(after, tnet.output(X[:5]))
    assert [t.data_ptr() for t in ttfm.param_leaves(tpi._params)] == ptrs
    np.testing.assert_allclose(_np(after), np.asarray(want), atol=ATOL)


def jnn_dataset(X, Y):
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    return JDataSet(jnp.asarray(X), jnp.asarray(Y))


def test_computation_graph():
    """ParallelInference serves a ComputationGraph (3-tuple _forward)."""
    jnet = jnn.ComputationGraph(_small_cg(jnn, jtrain)).init()
    tnet = tnn.ComputationGraph(_small_cg(tnn, ttrain)).init(device="cpu")
    tnet.params, tnet.states = tnn.params_from_numpy(
        _np_tree(jnet.params), _np_tree(jnet.states), "cpu")
    X = _x((24, 8, 8, 3), seed=5)
    with _Both():
        want = JPI(jnet).output(X)
        got = TPI(tnet, device="cpu").output(X)
    assert got.shape == (24, 5)
    assert torch.equal(got, tnet.output(X))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def _two_arm_cg(nn, train):
    b = nn.NeuralNetConfiguration.builder().seed(11).updater(train.Sgd(0.1))
    g = b.graph_builder().add_inputs("a", "b")
    g.add_layer("da", nn.DenseLayer(n_in=6, n_out=8, activation="tanh"), "a")
    g.add_layer("db", nn.DenseLayer(n_in=4, n_out=8, activation="tanh"), "b")
    g.add_vertex("m", nn.MergeVertex(), "da", "db")
    g.add_layer("o1", nn.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                     loss="mcxent"), "m")
    g.add_layer("o2", nn.OutputLayer(n_in=16, n_out=2, activation="softmax",
                                     loss="mcxent"), "m")
    g.set_outputs("o1", "o2")
    return g.build()


def test_multi_input_multi_output_graph():
    """A two-input, two-output graph: ``output([a, b])`` returns one
    array per output (tests/test_parallel.py:832-868)."""
    jnet = jnn.ComputationGraph(_two_arm_cg(jnn, jtrain)).init(
        [(6,), (4,)])
    tnet = tnn.ComputationGraph(_two_arm_cg(tnn, ttrain)).init(
        [(6,), (4,)], device="cpu")
    tnet.params, tnet.states = tnn.params_from_numpy(
        _np_tree(jnet.params), _np_tree(jnet.states), "cpu")
    xa, xb = _x((8, 6), 1), _x((8, 4), 2)
    with _Both():
        want = JPI(jnet).output([xa, xb])
        got = TPI(tnet, device="cpu").output([xa, xb])
    assert isinstance(got, list) and [o.shape for o in got] == [(8, 3),
                                                                (8, 2)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)


# ------------------------------------------------- the port's contracts

def test_mesh_and_missing_card_raise(mlp):
    _, tnet = mlp
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        TPI(tnet, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TPI(tnet)


def test_a_failed_flush_fails_every_future():
    def boom(p, x):
        raise FloatingPointError("forward failed")
    pi = TPI(TFIM({"w": torch.ones(1)}, boom), device="cpu")
    f1 = pi.submit(np.zeros((1, 2), np.float32))
    f2 = pi.submit(np.zeros((2, 2), np.float32))
    with pytest.raises(FloatingPointError):
        pi.flush()
    for f in (f1, f2):
        with pytest.raises(FloatingPointError):
            f.result(timeout=5)


class _Recorder:
    """Stands in for the compiled forward: records the thread and the
    ``capture`` flag of each call, then runs it."""

    def __init__(self, step):
        self.step, self.calls = step, []
        self._lock = threading.Lock()

    def __call__(self, *xs, capture=True):
        with self._lock:
            self.calls.append((threading.current_thread(), capture))
        return self.step(*xs, capture=capture)


def test_only_caller_threads_capture(mlp):
    """Two threads: one trickles requests that the deadline timer
    flushes, the other calls ``output`` meanwhile. Every result is the
    net's own; the timer's flushes call the step with ``capture=False``,
    the callers' with ``capture=True``."""
    _, tnet = mlp
    pi = TPI(tnet, max_batch=64, max_wait_ms=5, device="cpu")
    rec = pi._infer = _Recorder(pi._build())
    xs = [_x((1 + i % 3, 6), seed=i) for i in range(12)]
    want = [tnet.output(x) for x in xs]
    futs, outs, errors = [], [], []

    def trickle():
        try:
            for x in xs:
                futs.append(pi.submit(x))
                time.sleep(0.01)
        except Exception as e:      # noqa: BLE001 — asserted below
            errors.append(e)

    def caller():
        try:
            for x in xs:
                outs.append(pi.output(x))
        except Exception as e:      # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=trickle),
               threading.Thread(target=caller)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    got = [f.result(timeout=30) for f in futs]
    for a, b in zip(got + outs, want + want):
        assert torch.equal(a, b)
    timer = [c for th, c in rec.calls if isinstance(th, threading.Timer)]
    other = [c for th, c in rec.calls
             if not isinstance(th, threading.Timer)]
    assert timer and not any(timer)
    assert len(other) >= len(xs) and all(other)


def test_clean_interpreter_exit_with_live_serving_threads():
    """tests/test_serving.py:640 on the port: an armed deadline timer and
    a live scheduler thread at interpreter exit; the atexit drains make
    the process exit 0."""
    code = """
import numpy as np, torch
from deeplearning4j_tpu_torch.zoo import transformer as tfm
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.serving import (FunctionalInferenceModel,
    GenerationEngine, ContinuousBatchingScheduler)
bcfg = tfm.BertConfig(vocab_size=32, d_model=16, n_heads=2, n_layers=1,
                      d_ff=32, max_seq=8, dtype=torch.float32)
bp = tfm.bert_init(bcfg, torch.Generator().manual_seed(1), device="cpu")
pi = ParallelInference(FunctionalInferenceModel(
    bp, lambda p, ids: tfm.bert_forward(p, bcfg, ids)[0]),
    max_batch=64, max_wait_ms=40, device="cpu")
pi.submit(np.zeros((2, 8), np.int32))          # timer armed
cfg = tfm.TransformerConfig(vocab_size=32, d_model=16, n_heads=2,
                            n_layers=1, d_ff=32, max_seq=16,
                            dtype=torch.float32, attn_scores_bf16=False)
sp = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
sched = ContinuousBatchingScheduler(GenerationEngine(cfg, sp, device="cpu"),
                                    n_slots=2).start()
sched.submit([1, 2], max_new_tokens=4)         # serve thread live
print("exiting hot")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-500:])
    assert "exiting hot" in proc.stdout
