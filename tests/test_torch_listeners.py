"""The port's listeners (``nn/listeners.py``), the deferred score read of
``fit`` (``nn/_fit_loop.py``) and the compiled ``output()``, against the
JAX package, on the CPU.

- the same (iteration, epoch, score) sequence as the JAX net's, within
  1e-5, with only deferred listeners (``fit`` reports step k after step
  k+1 is queued) and with a synchronous one among them, on both nets;
- the deferred report comes one step late, every report of an epoch
  before ``on_epoch_end``, and an exception mid-epoch still delivers the
  finished step without masking the error;
- each listener's behaviour (score printing, checkpoints with retention,
  evaluation, the NaN watchdog); ``MetricsListener`` against the
  reference's (counts, loss, census); the three that need unported parts
  of the observability plane raise and name it;
- ``output()`` runs its compiled step (a direct call on the CPU).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.listeners as jls
import deeplearning4j_tpu.train as jtrain
import deeplearning4j_tpu_torch.nn as tnn
import deeplearning4j_tpu_torch.nn.listeners as tls
import deeplearning4j_tpu_torch.train as ttrain
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator

ATOL = 1e-5


def _mln(m, t):
    return m.MultiLayerNetwork(
        m.NeuralNetConfiguration.builder().seed(9).updater(t.Adam(1e-2))
        .list().layer(m.DenseLayer(n_in=5, n_out=8, activation="tanh"))
        .layer(m.OutputLayer(n_in=8, n_out=3, activation="softmax",
                             loss="mcxent")).build())


def _cg(m, t):
    return m.ComputationGraph(
        m.NeuralNetConfiguration.builder().seed(9).updater(t.Adam(1e-2))
        .graph_builder().add_inputs("in")
        .add_layer("h", m.DenseLayer(n_in=5, n_out=8, activation="tanh"),
                   "in")
        .add_layer("out", m.OutputLayer(n_in=8, n_out=3), "h")
        .set_outputs("out").build())


def _pair(kind):
    if kind == "mln":
        jnet, tnet = _mln(jnn, jtrain).init((5,)), \
            _mln(tnn, ttrain).init((5,), device="cpu")
    else:
        jnet, tnet = _cg(jnn, jtrain).init([(5,)]), \
            _cg(tnn, ttrain).init([(5,)], device="cpu")
    tnet.params, tnet.states = tnn.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), "cpu")
    return jnet, tnet


def _data(n=4, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, 5)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)])
            for _ in range(n)]


class _Log:
    """Records each call with the net's step count at the time."""

    def __init__(self, deferred=True):
        self.deferred_score_ok = deferred
        self.calls = []

    def iteration_done(self, net, it, ep, score):
        self.calls.append(("it", it, ep, score, net._step_count))

    def on_epoch_end(self, net):
        self.calls.append(("epoch", net.epoch_count))


@pytest.mark.parametrize("deferred", [True, False],
                         ids=["deferred", "synchronous"])
@pytest.mark.parametrize("kind", ["mln", "cg"])
def test_score_sequence_matches_jax_net(kind, deferred):
    jnet, tnet = _pair(kind)
    jc, tc = jls.CollectScoresListener(), tls.CollectScoresListener()
    jnet.set_listeners(jc)
    log = _Log(deferred)
    tnet.set_listeners(tc, log)
    data = _data()
    jnet.fit([JDataSet(x, y) for x, y in data], epochs=2)
    tnet.fit([DataSet(x, y) for x, y in data], epochs=2)
    assert tc.iterations == jc.iterations == list(range(1, 9))
    np.testing.assert_allclose(tc.scores, jc.scores, atol=ATOL)
    its = [c for c in log.calls if c[0] == "it"]
    assert [(c[1], c[2]) for c in its] == \
        [(i, 0) for i in range(1, 5)] + [(i, 1) for i in range(5, 9)]
    # deferred: step k is reported once step k+1 is queued, except the
    # epoch's last (delivered before on_epoch_end)
    lag = [c[4] - c[1] for c in its]
    assert lag == ([1, 1, 1, 0] * 2 if deferred else [0] * 8)
    assert [c[0] for c in log.calls] == ["it"] * 4 + ["epoch"] + \
        ["it"] * 4 + ["epoch"]


class _Boom(ListDataSetIterator):
    """Raises when asked for its third batch."""

    def next(self):
        if self._cursor >= 2 * self.batch_size:
            raise RuntimeError("source failed")
        return super().next()


def test_exception_mid_epoch_delivers_the_finished_step():
    _, tnet = _pair("mln")
    log = _Log(True)
    tnet.set_listeners(log)
    x = np.concatenate([a for a, _ in _data()])
    y = np.concatenate([b for _, b in _data()])
    # fit prefetches the iterator: the source's error reaches the loop
    # as the prefetch's, chained to it
    with pytest.raises(RuntimeError, match="async data producer") as err:
        tnet.fit(_Boom(DataSet(x, y), 8))
    assert "source failed" in str(err.value.__cause__)
    assert [c[1] for c in log.calls] == [1, 2]


class _Bad:
    deferred_score_ok = True

    def iteration_done(self, net, it, ep, score):
        if it == 2:
            raise ValueError("listener failed")


def test_a_failing_deferred_listener_does_not_mask_the_error():
    _, tnet = _pair("mln")
    tnet.set_listeners(_Bad())
    with pytest.raises(ValueError, match="listener failed"):
        tnet.fit([DataSet(x, y) for x, y in _data()])


def test_logging_listeners(tmp_path):
    _, tnet = _pair("mln")
    lines = []
    tnet.set_listeners(tls.ScoreIterationListener(2, log_fn=lines.append),
                       tls.PerformanceListener(1, log_fn=lines.append),
                       tls.TimeIterationListener(4, 2, log_fn=lines.append))
    tnet.fit([DataSet(x, y) for x, y in _data()])
    assert sum(s.startswith("Score at iteration") for s in lines) == 2
    assert any("iterations/sec" in s for s in lines)
    assert any("ETA" in s for s in lines)


def test_checkpoint_listener_keeps_the_last(tmp_path):
    _, tnet = _pair("mln")
    ck = tls.CheckpointListener(tmp_path, save_every_n_iterations=1,
                                save_every_n_epochs=1, keep_last=2)
    assert not getattr(ck, "deferred_score_ok", False)
    tnet.set_listeners(ck)
    tnet.fit([DataSet(x, y) for x, y in _data()])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["checkpoint_epoch_1.zip", "checkpoint_iter_4.zip"]
    back = tnn.MultiLayerNetwork.load(tmp_path / "checkpoint_iter_4.zip",
                                      device="cpu")
    assert back._step_count == 4 and back._restored_opt_state is not None


def test_evaluative_listener_and_watchdog():
    _, tnet = _pair("mln")
    held = [DataSet(x, y) for x, y in _data(2, seed=1)]
    lines = []
    ev = tls.EvaluativeListener(held, frequency=2, log_fn=lines.append)
    tnet.set_listeners(ev, tls.NanScoreWatchdog())
    tnet.fit([DataSet(x, y) for x, y in _data()])
    assert ev.last_evaluation.confusion.sum() == 16 and len(lines) == 2
    hit = []
    dog = tls.NanScoreWatchdog(on_failure=lambda n, i, s: hit.append(i))
    dog.iteration_done(tnet, 3, 0, float("nan"))
    assert dog.triggered and hit == [3]
    with pytest.raises(FloatingPointError):
        tls.NanScoreWatchdog().iteration_done(tnet, 1, 0, float("inf"))


@pytest.mark.parametrize("name", ["NumericsListener", "ProfilingListener",
                                  "StatsListener"])
def test_obs_listeners_raise_naming_what_is_missing(name):
    with pytest.raises(NotImplementedError, match="observability plane"):
        getattr(tls, name)()


@pytest.mark.parametrize("kind", ["mln", "cg"])
def test_metrics_listener_matches_the_reference(kind):
    """MetricsListener on both nets, against the JAX net's on the same
    data: the same counts (iterations, examples, epochs, step intervals),
    the last loss within 1e-5, the census's params and states bytes equal
    (the port's optimizer bytes: its own state's), and its self-timing
    moving; the fit stays deferred."""
    from deeplearning4j_tpu.obs import MetricsRegistry as JReg
    from deeplearning4j_tpu.obs import tree_bytes as jtree_bytes
    from deeplearning4j_tpu_torch.obs import MetricsRegistry, tree_bytes
    jnet, tnet = _pair(kind)
    data = _data()
    jreg, treg = JReg(), MetricsRegistry()
    jnet.set_listeners(jls.MetricsListener(registry=jreg,
                                           memory_frequency=1))
    ml = tls.MetricsListener(registry=treg, memory_frequency=1)
    log = _Log()
    tnet.set_listeners(ml, log)
    jnet.fit([JDataSet(x, y) for x, y in data], epochs=2)
    tnet.fit([DataSet(x, y) for x, y in data], epochs=2)
    # deferred: step 1 reported once step 2 is queued
    assert ml.deferred_score_ok and log.calls[0][1] == 1 \
        and log.calls[0][4] == 2
    for name in ("dl4j_train_iterations_total", "dl4j_train_examples_total",
                 "dl4j_train_epochs_total"):
        assert treg.get(name).value() == jreg.get(name).value() > 0, name
    assert treg.get("dl4j_train_step_seconds").count() == \
        jreg.get("dl4j_train_step_seconds").count() == 6
    assert abs(treg.get("dl4j_train_loss").value()
               - jreg.get("dl4j_train_loss").value()) < ATOL
    tg, jg = treg.get("dl4j_mem_component_bytes"), \
        jreg.get("dl4j_mem_component_bytes")
    for comp in ("params", "states"):
        assert tg.value(component=comp, replica="0") == \
            jg.value(component=comp, replica="0")
    assert tg.value(component="params", replica="0") == \
        tree_bytes(tnet.params) == jtree_bytes(jnet.params) > 0
    assert tg.value(component="optimizer", replica="0") == \
        tree_bytes(tnet._opt_state) > 0
    assert ml.overhead_seconds > 0
    # the CPU has no allocator view: nothing under dl4j_device_memory_bytes
    assert treg.get("dl4j_device_memory_bytes").value(
        stat="bytes_in_use") == 0


def test_output_runs_the_compiled_step():
    _, tnet = _pair("mln")
    x = _data(1)[0][0]
    a = tnet.output(x)
    b = tnet.output(x[:3])
    assert tnet._infer_fn.calls["direct"] == 2 and tnet._infer_fn.last == \
        "direct"
    assert a.shape == (8, 3) and b.shape == (3, 3)
