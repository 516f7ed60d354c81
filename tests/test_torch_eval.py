"""The port's evaluation (``deeplearning4j_tpu_torch/eval/``) and the nets'
``evaluate*`` against the JAX package, on the CPU.

- ``Evaluation`` (top-N, per-class, macro/micro, MCC, merge, time-series
  with a label mask), ``EvaluationBinary`` (masked), ``RegressionEvaluation``
  (time-series masked), ``ROC`` (exact and thresholded, masked),
  ``ROCBinary``, ``ROCMultiClass`` and ``EvaluationCalibration`` (masked)
  on the same predictions and labels through both packages: counts exact,
  float stats within 1e-6 — the cases of ``tests/test_losses_eval.py``
  run through both, and seeded random data;
- the accumulators stay on the device of the predictions: no host read
  per batch (the CPU here; ``tests/test_torch_cuda.py`` on the card);
- ``evaluate`` / ``evaluate_regression`` / ``evaluate_roc`` of an MLN and
  ``evaluate`` of a CG (``preds[0]`` of two outputs) on the JAX nets'
  weights give the same confusion matrix and stats as the JAX nets'.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.eval as jev
import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu_torch.eval as tev
import deeplearning4j_tpu_torch.nn as tnn
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.train.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.train import Adam

RTOL = 1e-6
ATOL = 1e-9


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL)


def _probs(rng, shape):
    z = rng.standard_normal(shape).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _onehot(rng, shape, c):
    return np.eye(c, dtype=np.float32)[rng.integers(0, c, shape)]


# ------------------------------------------------------------ Evaluation

def _cases():
    rng = np.random.default_rng(0)
    hand_l = np.array([[1, 0], [1, 0], [0, 1], [0, 1]], np.float32)
    hand_p = np.array([[0.9, 0.1], [0.4, 0.6], [0.2, 0.8], [0.7, 0.3]],
                      np.float32)
    mask = (rng.random((4, 6)) > 0.3).astype(np.float32)
    return {
        "hand": ([(hand_l, hand_p, None)], {}),
        "topn_hand": ([(np.array([[0, 1, 0], [1, 0, 0]], np.float32),
                        np.array([[0.5, 0.4, 0.1], [0.3, 0.5, 0.2]],
                                 np.float32), None)], {"top_n": 2}),
        "random_top3": ([(_onehot(rng, 64, 5), _probs(rng, (64, 5)), None),
                         (_onehot(rng, 40, 5), _probs(rng, (40, 5)), None)],
                        {"top_n": 3}),
        "int_labels": ([(rng.integers(0, 4, 50), _probs(rng, (50, 4)),
                         None)], {}),
        "time_series_masked": ([(_onehot(rng, (4, 6), 5),
                                 _probs(rng, (4, 6, 5)), mask)],
                               {"top_n": 2}),
        "fixed_classes": ([(_onehot(rng, 30, 3), _probs(rng, (30, 3)),
                            None)], {"num_classes": 3,
                                     "labels_list": ["a", "b", "c"]}),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_evaluation_matches_reference(case):
    batches, kw = _cases()[case]
    je, te = jev.Evaluation(**kw), tev.Evaluation(**kw)
    for y, p, m in batches:
        je.eval(y, p, mask=m)
        te.eval(y, torch.as_tensor(p), mask=m)
    assert te._conf.device == torch.device("cpu") and te._host is None
    np.testing.assert_array_equal(te.confusion, je.confusion)
    n = je.confusion.shape[0]
    for avg in ("macro", "micro"):
        _close(te.precision(average=avg), je.precision(average=avg))
        _close(te.recall(average=avg), je.recall(average=avg))
        _close(te.f1(average=avg), je.f1(average=avg))
    for c in range(n):
        for m in ("precision", "recall", "f1", "gmeasure",
                  "false_positive_rate", "false_negative_rate"):
            _close(getattr(te, m)(c), getattr(je, m)(c))
    _close(te.accuracy(), je.accuracy())
    _close(te.top_n_accuracy(), je.top_n_accuracy())
    _close(te.matthews_correlation(), je.matthews_correlation())
    _close(te.gmeasure(), je.gmeasure())
    assert te.stats() == je.stats()


def test_evaluation_merge_matches_reference():
    rng = np.random.default_rng(1)
    y, p = _onehot(rng, 60, 4), _probs(rng, (60, 4))
    parts = []
    for mod in (jev, tev):
        a, b, whole = (mod.Evaluation(top_n=2) for _ in range(3))
        a.eval(y[:25], p[:25])
        b.eval(y[25:], p[25:])
        whole.eval(y, p)
        a.merge(b)
        np.testing.assert_array_equal(a.confusion, whole.confusion)
        parts.append(a)
    np.testing.assert_array_equal(parts[1].confusion, parts[0].confusion)
    _close(parts[1].top_n_accuracy(), parts[0].top_n_accuracy())


@pytest.mark.parametrize("masked", [False, True])
def test_evaluation_binary_matches_reference(masked):
    rng = np.random.default_rng(2)
    y = (rng.random((40, 3)) > 0.5).astype(np.float32)
    p = rng.random((40, 3)).astype(np.float32)
    m = (rng.random(40) > 0.25).astype(np.float32) if masked else None
    je, te = jev.EvaluationBinary(0.4), tev.EvaluationBinary(0.4)
    for sl in (slice(0, 17), slice(17, 40)):
        je.eval(y[sl], p[sl], mask=None if m is None else m[sl])
        te.eval(y[sl], p[sl], mask=None if m is None else m[sl])
    for k in ("tp", "fp", "fn", "tn"):
        np.testing.assert_array_equal(getattr(te, k), getattr(je, k))
    for i in range(3):
        for f in ("accuracy", "precision", "recall", "f1"):
            _close(getattr(te, f)(i), getattr(je, f)(i))
    assert te.stats() == je.stats()


def test_evaluation_binary_hand_case():
    labels = np.array([[1, 0], [1, 1], [0, 1]], np.float32)
    preds = np.array([[0.9, 0.2], [0.3, 0.8], [0.1, 0.6]], np.float32)
    je, te = jev.EvaluationBinary(), tev.EvaluationBinary()
    je.eval(labels, preds)
    te.eval(labels, preds)
    assert te.recall(0) == je.recall(0) == 0.5
    assert te.precision(1) == je.precision(1) == 1.0


# ------------------------------------------------------------ regression

@pytest.mark.parametrize("case", ["hand", "random", "time_series_masked"])
def test_regression_matches_reference(case):
    rng = np.random.default_rng(3)
    if case == "hand":
        batches = [(np.array([[1.0], [2.0], [3.0]]),
                    np.array([[1.1], [1.9], [3.2]]), None)]
    elif case == "random":
        batches = [(rng.standard_normal((30, 3)).astype(np.float32),
                    rng.standard_normal((30, 3)).astype(np.float32), None)
                   for _ in range(2)]
    else:
        y = rng.standard_normal((4, 7, 2)).astype(np.float32)
        p = y + 0.3 * rng.standard_normal((4, 7, 2)).astype(np.float32)
        p[0, -1] = np.nan                     # a masked step holds NaN
        m = np.ones((4, 7), np.float32)
        m[0, -1] = 0
        m[2, 4:] = 0
        batches = [(y, p, m)]
    je, te = jev.RegressionEvaluation(), tev.RegressionEvaluation()
    for y, p, m in batches:
        je.eval(y, p, mask=m)
        te.eval(y, p, mask=m)
    assert te.n == je.n and te.n_columns == je.n_columns
    for c in range(je.n_columns):
        for f in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "relative_squared_error",
                  "pearson_correlation", "r_squared"):
            _close(getattr(te, f)(c), getattr(je, f)(c))
    for f in ("average_mean_squared_error", "average_mean_absolute_error",
              "average_root_mean_squared_error", "average_r_squared"):
        _close(getattr(te, f)(), getattr(je, f)())


# ------------------------------------------------------------------- ROC

@pytest.mark.parametrize("steps", [0, 20])
@pytest.mark.parametrize("case", ["hand", "random_onehot",
                                  "time_series_masked"])
def test_roc_matches_reference(case, steps):
    rng = np.random.default_rng(4)
    if case == "hand":
        batches = [(np.array([0, 0, 1, 1]),
                    np.array([0.1, 0.4, 0.35, 0.8], np.float32)[:, None],
                    None)]
    elif case == "random_onehot":
        batches = [(_onehot(rng, 50, 2), _probs(rng, (50, 2)), None)
                   for _ in range(2)]
    else:
        batches = [(_onehot(rng, (3, 8), 2), _probs(rng, (3, 8, 2)),
                    (rng.random((3, 8)) > 0.3).astype(np.float32))]
    jr, tr = jev.ROC(steps), tev.ROC(steps)
    for y, p, m in batches:
        jr.eval(y, p, mask=m)
        tr.eval(y, p, mask=m)
    _close(tr.calculate_auc(), jr.calculate_auc())
    _close(tr.calculate_auprc(), jr.calculate_auprc())
    for a, b in zip(tr.get_roc_curve(), jr.get_roc_curve()):
        _close(a, b)


@pytest.mark.parametrize("steps", [0, 10])
def test_roc_binary_and_multiclass_match_reference(steps):
    rng = np.random.default_rng(5)
    yb = (rng.random((40, 3)) > 0.5).astype(np.float32)
    pb = rng.random((40, 3)).astype(np.float32)
    jb, tb = jev.ROCBinary(steps), tev.ROCBinary(steps)
    jb.eval(yb, pb)
    tb.eval(yb, pb)
    for i in range(3):
        _close(tb.calculate_auc(i), jb.calculate_auc(i))
    _close(tb.calculate_average_auc(), jb.calculate_average_auc())
    ym, pm = rng.integers(0, 4, 60), _probs(rng, (60, 4))
    jm, tm = jev.ROCMultiClass(steps), tev.ROCMultiClass(steps)
    jm.eval(ym, pm)
    tm.eval(ym, pm)
    for i in range(4):
        _close(tm.calculate_auc(i), jm.calculate_auc(i))
    _close(tm.calculate_average_auc(), jm.calculate_average_auc())


# ------------------------------------------------------------ calibration

@pytest.mark.parametrize("masked", [False, True])
def test_calibration_matches_reference(masked):
    rng = np.random.default_rng(6)
    jc, tc = jev.EvaluationCalibration(8, 20), \
        tev.EvaluationCalibration(8, 20)
    if masked:
        p = _probs(rng, (5, 9, 3))
        y = _onehot(rng, (5, 9), 3)
        m = (rng.random((5, 9)) > 0.3).astype(np.float32)
        p[0, 0] = np.nan
        m[0, 0] = 0
        batches = [(y, p, m)]
    else:
        batches = [(rng.integers(0, 3, 200), _probs(rng, (200, 3)), None),
                   (_onehot(rng, 100, 3), _probs(rng, (100, 3)), None)]
    for y, p, m in batches:
        jc.eval(y, p, mask=m)
        tc.eval(y, p, mask=m)
    for c in range(3):
        for a, b in zip(tc.reliability_info(c), jc.reliability_info(c)):
            _close(a, b)
        for a, b in zip(tc.residual_plot(c), jc.residual_plot(c)):
            _close(a, b)
        for pos in (True, False):
            for a, b in zip(tc.probability_histogram(c, pos),
                            jc.probability_histogram(c, pos)):
                _close(a, b)
        _close(tc.expected_calibration_error(c),
               jc.expected_calibration_error(c))
    _close(tc.expected_calibration_error(), jc.expected_calibration_error())
    assert tc.stats() == jc.stats()
    merged = tev.EvaluationCalibration(8, 20).merge(tc)
    _close(merged.expected_calibration_error(),
           jc.expected_calibration_error())


# ------------------------------------------------------- through the nets

def _mln(m, upd, n_in=6, n_out=4, loss="mcxent", act="softmax"):
    return m.MultiLayerNetwork(
        m.NeuralNetConfiguration.builder().seed(7).updater(upd).list()
        .layer(m.DenseLayer(n_in=n_in, n_out=10, activation="tanh"))
        .layer(m.OutputLayer(n_in=10, n_out=n_out, activation=act,
                             loss=loss)).build())


def _pair(jnet, tnet):
    tnet.params, tnet.states = tnn.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), "cpu")
    return jnet, tnet


def _batches(rng, n=3, b=16, n_in=6, n_out=4):
    return [(rng.standard_normal((b, n_in)).astype(np.float32),
             _onehot(rng, b, n_out)) for _ in range(n)] + [
        (rng.standard_normal((5, n_in)).astype(np.float32),
         _onehot(rng, 5, n_out))]            # a last partial batch


def test_mln_evaluate_matches_jax_net():
    rng = np.random.default_rng(8)
    jnet, tnet = _pair(_mln(jnn, JAdam(1e-2)).init((6,)),
                       _mln(tnn, Adam(1e-2)).init((6,), device="cpu"))
    data = _batches(rng)
    jnet.fit([JDataSet(x, y) for x, y in data])
    tnet.fit([DataSet(x, y) for x, y in data])
    _pair(jnet, tnet)
    jr = jnet.evaluate([JDataSet(x, y) for x, y in data], top_n=2)
    tr = tnet.evaluate([DataSet(x, y) for x, y in data], top_n=2)
    np.testing.assert_array_equal(tr.confusion, jr.confusion)
    _close(tr.top_n_accuracy(), jr.top_n_accuracy())
    assert tr.stats() == jr.stats()
    # output() ran its compiled step once a batch (on the CPU: direct)
    assert tnet._infer_fn.calls["direct"] == len(data)
    jroc = jnet.evaluate_roc([JDataSet(x, y[:, :2]) for x, y in data])
    troc = tnet.evaluate_roc([DataSet(x, y[:, :2]) for x, y in data])
    _close(troc.calculate_auc(), jroc.calculate_auc())


def test_mln_evaluate_regression_matches_jax_net():
    rng = np.random.default_rng(9)
    jnet, tnet = _pair(
        _mln(jnn, JAdam(1e-2), n_out=2, loss="mse",
             act="identity").init((6,)),
        _mln(tnn, Adam(1e-2), n_out=2, loss="mse",
             act="identity").init((6,), device="cpu"))
    data = [(x, rng.standard_normal((x.shape[0], 2)).astype(np.float32))
            for x, _ in _batches(rng)]
    jr = jnet.evaluate_regression([JDataSet(x, y) for x, y in data])
    tr = tnet.evaluate_regression([DataSet(x, y) for x, y in data])
    for c in range(2):
        _close(tr.mean_squared_error(c), jr.mean_squared_error(c))
        _close(tr.pearson_correlation(c), jr.pearson_correlation(c))


def test_mln_evaluate_time_series_masks_labels():
    """An RNN head's (B, T, C) predictions, the labels mask selecting
    steps: the same confusion matrix as the JAX net's."""
    rng = np.random.default_rng(10)

    def conf(m, upd):
        return m.MultiLayerNetwork(
            m.NeuralNetConfiguration.builder().seed(2).updater(upd).list()
            .layer(m.LSTM(n_in=3, n_out=6))
            .layer(m.RnnOutputLayer(n_in=6, n_out=4, activation="softmax",
                                    loss="mcxent")).build())
    jnet, tnet = _pair(conf(jnn, JAdam(1e-2)).init((5, 3)),
                       conf(tnn, Adam(1e-2)).init((5, 3), device="cpu"))
    x = rng.standard_normal((6, 5, 3)).astype(np.float32)
    y = _onehot(rng, (6, 5), 4)
    m = (rng.random((6, 5)) > 0.3).astype(np.float32)
    jr = jnet.evaluate([JDataSet(x, y, labels_mask=m)])
    tr = tnet.evaluate([DataSet(x, y, labels_mask=m)])
    np.testing.assert_array_equal(tr.confusion, jr.confusion)
    assert tr.confusion.sum() == int(m.sum())


def test_cg_evaluate_takes_the_first_output():
    rng = np.random.default_rng(11)

    def conf(m, upd):
        return m.ComputationGraph(
            m.NeuralNetConfiguration.builder().seed(4).updater(upd)
            .graph_builder().add_inputs("in")
            .add_layer("h", m.DenseLayer(n_in=6, n_out=8,
                                         activation="relu"), "in")
            .add_layer("a", m.OutputLayer(n_in=8, n_out=4), "h")
            .add_layer("b", m.OutputLayer(n_in=8, n_out=3), "h")
            .set_outputs("a", "b").build())
    jnet = conf(jnn, JAdam(1e-2)).init([(6,)])
    tnet = conf(tnn, Adam(1e-2)).init([(6,)], device="cpu")
    _pair(jnet, tnet)
    data = [(x, y) for x, y in _batches(rng)]
    jr = jnet.evaluate([JDataSet(x, y) for x, y in data])
    tr = tnet.evaluate([DataSet(x, y) for x, y in data])
    np.testing.assert_array_equal(tr.confusion, jr.confusion)
    assert tr.confusion.sum() == sum(len(x) for x, _ in data)
