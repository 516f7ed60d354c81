"""The port's early stopping (``nn/early_stopping.py``) against the JAX
package's (``tests/test_early_stopping.py``'s first five cases), on the
CPU, from the same initial weights and data: the per-epoch held-out
scores agree at 1e-5 (f32), the termination reason and epoch are the
reference's, and the restored best model holds the best epoch's params
bit for bit and scores the recorded best score. The two parallel cases
(``:101``, ``:115``) run the port's ``EarlyStoppingParallelTrainer``
around ``ParallelWrapper`` over two gloo ranks spawned for the file
(``torch_parallel_ranks.RankPool``).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.nn.early_stopping as jes
import deeplearning4j_tpu.train as jtrain
import deeplearning4j_tpu_torch.nn as tnn
import deeplearning4j_tpu_torch.nn.early_stopping as tes
import deeplearning4j_tpu_torch.train as ttrain
from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import ListDataSetIterator as JList
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.train.updaters import tree_leaves

R = np.random.default_rng(0)
X = R.standard_normal((96, 5)).astype(np.float32)
W = R.standard_normal((5, 3))
Y = np.eye(3, dtype=np.float32)[(X @ W).argmax(1)]
ATOL = 1e-5


def _conf(m, t, seed):
    return (m.NeuralNetConfiguration.builder().seed(seed)
            .updater(t.Adam(2e-2)).list()
            .layer(m.DenseLayer(n_in=5, n_out=24, activation="relu"))
            .layer(m.OutputLayer(n_in=24, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .set_input_type(m.InputType.feed_forward(5)).build())


def _nets(seed=1):
    """(JAX net, port net on its initial weights)."""
    jnet = jnn.MultiLayerNetwork(_conf(jnn, jtrain, seed)).init()
    tnet = tnn.MultiLayerNetwork(_conf(tnn, ttrain, seed)).init(device="cpu")
    tnet.params, tnet.states = tnn.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), "cpu")
    return jnet, tnet


def _iters():
    return (ListDataSetIterator([DataSet(X[i * 24:(i + 1) * 24],
                                         Y[i * 24:(i + 1) * 24])
                                 for i in range(4)], batch_size=None),
            JList([JDataSet(X[i * 24:(i + 1) * 24], Y[i * 24:(i + 1) * 24])
                   for i in range(4)], batch_size=None))


def _run(conds, calc, seed=1):
    """Both packages' trainers under the same conditions."""
    jnet, tnet = _nets(seed)
    tcalc, jcalc = (getattr(tes, calc)(_iters()[0]),
                    getattr(jes, calc)(_iters()[1]))
    t = tes.EarlyStoppingTrainer(tes.EarlyStoppingConfiguration(
        epoch_termination_conditions=[getattr(tes, c)(*a) for c, a in conds],
        score_calculator=tcalc), tnet, _iters()[0]).fit()
    j = jes.EarlyStoppingTrainer(jes.EarlyStoppingConfiguration(
        epoch_termination_conditions=[getattr(jes, c)(*a) for c, a in conds],
        score_calculator=jcalc), jnet, _iters()[1]).fit()
    return t, j, tnet, tcalc


def _same_result(t, j):
    assert t.termination_reason == j.termination_reason
    assert (t.total_epochs, t.best_model_epoch) == \
        (j.total_epochs, j.best_model_epoch)
    assert sorted(t.score_vs_epoch) == sorted(j.score_vs_epoch)
    for e in j.score_vs_epoch:
        np.testing.assert_allclose(t.score_vs_epoch[e], j.score_vs_epoch[e],
                                   atol=ATOL)


def test_max_epochs_termination():
    t, j, tnet, calc = _run([("MaxEpochsTerminationCondition", (5,))],
                            "DataSetLossCalculator")
    assert isinstance(t, tes.EarlyStoppingResult)
    assert t.termination_reason == "MaxEpochsTerminationCondition"
    assert t.total_epochs == 5 and 0 <= t.best_model_epoch < 5
    assert len(t.score_vs_epoch) == 5
    assert t.best_model_score < t.score_vs_epoch[0]
    _same_result(t, j)
    best = t.best_model
    assert best is not tnet
    # the restored best model scores the recorded best score
    assert calc.calculate_score(best) == t.best_model_score


def test_score_improvement_patience_stops_early():
    t, j, _, _ = _run([("MaxEpochsTerminationCondition", (40,)),
                       ("ScoreImprovementEpochTerminationCondition",
                        (2, 5e-2))], "DataSetLossCalculator")
    assert t.termination_reason == \
        "ScoreImprovementEpochTerminationCondition"
    assert t.total_epochs < 40
    _same_result(t, j)
    # the reference test's own settings, on the port alone
    _, tnet = _nets()
    r = tes.EarlyStoppingTrainer(tes.EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            tes.MaxEpochsTerminationCondition(500),
            tes.ScoreImprovementEpochTerminationCondition(
                max_epochs_without_improvement=4, min_improvement=1e-3)],
        score_calculator=tes.DataSetLossCalculator(_iters()[0])),
        tnet, _iters()[0]).fit()
    assert r.termination_reason == \
        "ScoreImprovementEpochTerminationCondition"
    assert r.total_epochs < 500


def test_max_score_termination_divergence_guard():
    t, j, _, _ = _run([("MaxEpochsTerminationCondition", (200,)),
                       ("MaxScoreTerminationCondition", (0.05,))],
                      "DataSetLossCalculator")
    assert t.termination_reason == "MaxScoreTerminationCondition"
    assert t.total_epochs == 1
    _same_result(t, j)


def test_classification_score_calculator_and_best_model():
    t, j, tnet, _ = _run([("MaxEpochsTerminationCondition", (10,))],
                         "ClassificationScoreCalculator")
    _same_result(t, j)
    best = t.best_model
    acc = (best.output(X).numpy().argmax(1) == Y.argmax(1)).mean()
    assert acc >= 1.0 - t.best_model_score - 1e-9
    assert best.params is not tnet.params


def test_invalid_score_condition():
    cond = tes.InvalidScoreTerminationCondition()
    assert cond.terminate(0, float("nan"), [])
    assert cond.terminate(0, float("inf"), [])
    assert not cond.terminate(0, 0.5, [])
    assert tes.MaxTimeTerminationCondition(3600).terminate(0, 0.5, []) is \
        False


def test_best_model_holds_the_best_epochs_params():
    """The snapshot at the best epoch, bit for bit: rerun the trainer's
    epochs by hand up to the best one and compare."""
    _, tnet = _nets(seed=3)
    res = tes.EarlyStoppingTrainer(tes.EarlyStoppingConfiguration(
        epoch_termination_conditions=[tes.MaxEpochsTerminationCondition(4)],
        score_calculator=tes.DataSetLossCalculator(_iters()[0])),
        tnet, _iters()[0]).fit()
    _, again = _nets(seed=3)
    for _ in range(res.best_model_epoch + 1):
        again.fit(_iters()[0], epochs=1)
    for p, q in zip(tree_leaves(res.best_model.params),
                    tree_leaves(again.params)):
        assert torch.equal(p, q) and p.requires_grad


def test_parallel_trainer_waits_for_parallel_wrapper():
    """The parallel trainer takes a trainer with ``.net`` and ``.fit``
    (``ParallelWrapper``, ``ParameterAveragingTrainer``); anything else
    is refused, as in the reference."""
    with pytest.raises(TypeError, match="ParallelWrapper"):
        tes.EarlyStoppingParallelTrainer(tes.EarlyStoppingConfiguration(),
                                         object(), _iters()[0])


@pytest.fixture(scope="module")
def pool():
    from torch_parallel_ranks import RankPool
    p = RankPool(2)
    yield p
    p.close()


def test_early_stopping_parallel_trainer(pool):
    """``tests/test_early_stopping.py:101`` and ``:115``: the parallel
    trainer around ``ParallelWrapper`` over dp2 (gloo, two spawned ranks)
    of an MLN and of a ComputationGraph runs its epochs, and each epoch's
    held-out score is the JAX single-device trainer's (dp equals one
    device) at 1e-5; the MLN's best score beats its first."""
    from torch_parallel_ranks import build
    import deeplearning4j_tpu.parallel as jpar
    pkg = (jnn, jtrain, jpar, False)
    nets = {name: build(pkg, name) for name in ("es_mlp", "es_cg")}
    epochs = {"es_mlp": 6, "es_cg": 5}
    xs = [X[i * 24:(i + 1) * 24] for i in range(4)]
    ys = [Y[i * 24:(i + 1) * 24] for i in range(4)]
    payload = {name: {"params": jax.tree_util.tree_map(np.asarray,
                                                       n.params),
                      "states": jax.tree_util.tree_map(np.asarray,
                                                       n.states)}
               for name, n in nets.items()}
    r = pool.run("early_stopping_parallel",
                 dict(payload, xs=xs, ys=ys, epochs=epochs))
    for name, net in nets.items():
        j = jes.EarlyStoppingTrainer(jes.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                jes.MaxEpochsTerminationCondition(epochs[name])],
            score_calculator=jes.DataSetLossCalculator(_iters()[1])),
            net, _iters()[1]).fit()
        want = [j.score_vs_epoch[k] for k in sorted(j.score_vs_epoch)]
        for x in r:
            assert x[name]["epochs"] == epochs[name] == j.total_epochs
            np.testing.assert_allclose(x[name]["scores"], want, atol=ATOL)
            assert np.isfinite(x[name]["best"])
    assert r[0]["es_mlp"]["best"] < r[0]["es_mlp"]["scores"][0]
    assert all(x["type"] for x in r)
