"""The port's SameDiff against the JAX package's (``tests/test_samediff.py``
mirrored, the StatsListener test aside: StatsListener is not ported).

Graphs are built the same way in both packages from the same seeded numpy
values; outputs agree at f32 atol = rtol = 1e-5 and fit trajectories
(the same updater on the same batches) at 1e-4 relative, unless stated.
A zip the JAX package's ``SameDiff.save`` wrote (training config and
updater state included) loads into the port without JAX.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff import TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.data import IrisDataSetIterator as JIris
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.train import Adam as JAdam
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu_torch.autodiff import (History, SameDiff,
                                               TrainingConfig)
from deeplearning4j_tpu_torch.data import DataSet, IrisDataSetIterator
from deeplearning4j_tpu_torch.train.updaters import Adam, Sgd

RNG = np.random.default_rng(0)
W0 = (RNG.standard_normal((4, 16)) * 0.3).astype(np.float32)
W1 = (RNG.standard_normal((16, 3)) * 0.3).astype(np.float32)


def _mlp(sd, zeros=np.zeros):
    x = sd.placeholder("input", (None, 4))
    y = sd.placeholder("label", (None, 3))
    w0 = sd.var("w0", value=W0)
    b0 = sd.var("b0", value=zeros(16, np.float32))
    w1 = sd.var("w1", value=W1)
    b1 = sd.var("b1", value=zeros(3, np.float32))
    h = sd.nn.relu(sd.nn.linear(x, w0, b0))
    logits = sd.nn.linear(h, w1, b1).rename("logits")
    sd.nn.softmax(logits).rename("out")
    sd.loss.softmax_cross_entropy(y, logits).rename("loss")
    return sd


def _cpu():
    return SameDiff.create(device="cpu")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def test_eval_and_arithmetic():
    sd = _cpu()
    a = sd.var("a", value=np.asarray([1.0, 2.0, 3.0]))
    b = sd.var("b", value=np.asarray([4.0, 5.0, 6.0]))
    c = (a * b + 2.0).rename("c")
    np.testing.assert_allclose(_np(sd.eval(c)), [6.0, 12.0, 20.0])
    d = a.mmul(b.reshape(3, 1))
    assert _np(sd.eval(d))[0] == 32.0
    assert float(sd.eval(a.sum())) == 6.0
    # the same graph in the reference: the same values and dtypes
    sj = JSameDiff.create()
    aj = sj.var("a", value=jnp.asarray([1.0, 2.0, 3.0]))
    bj = sj.var("b", value=jnp.asarray([4.0, 5.0, 6.0]))
    for fn in (lambda x, y: x * y + 2.0, lambda x, y: x / y - y,
               lambda x, y: (x ** 2.0).mean(), lambda x, y: -x @ y,
               lambda x, y: (2.0 - x) / (1.0 + y) ** 0.5,
               lambda x, y: x.max(0), lambda x, y: x.norm2()):
        want = np.asarray(sj.eval(fn(aj, bj)))
        got = _np(sd.eval(fn(a, b)))
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_grad_matches_manual():
    sd = _cpu()
    w = sd.var("w", value=np.asarray([2.0]))
    x = sd.placeholder("x")
    loss = ((w * x) ** 2.0).sum().rename("loss")
    g = sd.grad(loss, feeds={"x": np.asarray([3.0])})
    np.testing.assert_allclose(_np(g["w"]), [36.0], rtol=1e-6)


def test_grad_equals_the_reference():
    sdj = _mlp(JSameDiff.create(), jnp.zeros)
    sdp = _mlp(_cpu())
    feeds = {"input": RNG.standard_normal((6, 4)).astype(np.float32),
             "label": np.eye(3, dtype=np.float32)[RNG.integers(0, 3, 6)]}
    gj = sdj.grad("loss", feeds=feeds)
    gp = sdp.grad("loss", feeds=feeds)
    assert set(gj) == set(gp)
    for k in gj:
        np.testing.assert_allclose(_np(gp[k]), np.asarray(gj[k]),
                                   atol=1e-5, rtol=1e-5)
    gw = sdp.grad("loss", wrt="w0", feeds=feeds)
    assert list(gw) == ["w0"]


def _configure(sd, updater):
    sd.set_loss_variables("loss")
    cfg = TrainingConfig if isinstance(sd, SameDiff) else JTrainingConfig
    sd.set_training_config(cfg(
        updater=updater, data_set_feature_mapping=["input"],
        data_set_label_mapping=["label"]))
    return sd


def test_fit_iris():
    sd = _configure(_mlp(_cpu()), Adam(1e-2))
    it = IrisDataSetIterator(batch_size=50)
    sd.fit(iterator=it, epochs=90)
    feats, labels = it._features, it._labels
    out = _np(sd.eval(sd.get_variable("out"), {"input": feats}))
    acc = (out.argmax(1) == np.asarray(labels).argmax(1)).mean()
    assert acc > 0.9, acc


@pytest.mark.parametrize("updater", ["adam", "sgd"])
def test_fit_trajectory_equals_the_reference(updater):
    """The same graph, values, updater and batches: the loss curve and
    the final variables agree (f32, 1e-4 relative over 12 steps)."""
    upd = {"adam": (Adam(1e-2), JAdam(1e-2)),
           "sgd": (Sgd(0.1), JSgd(0.1))}[updater]
    sdp = _configure(_mlp(_cpu()), upd[0])
    sdj = _configure(_mlp(JSameDiff.create(), jnp.zeros), upd[1])
    hp = sdp.fit(iterator=IrisDataSetIterator(batch_size=50), epochs=4)
    hj = sdj.fit(iterator=JIris(batch_size=50), epochs=4)
    np.testing.assert_allclose(hp.loss_curve, hj.loss_curve, rtol=1e-4)
    np.testing.assert_allclose(hp.epoch_losses, hj.epoch_losses, rtol=1e-4)
    for n in ("w0", "b0", "w1", "b1"):
        np.testing.assert_allclose(_np(sdp._values[n]),
                                   np.asarray(sdj._values[n]),
                                   atol=1e-5, rtol=1e-4)


def test_fit_l1_l2_equal_the_reference():
    sdp = _mlp(_cpu())
    sdj = _mlp(JSameDiff.create(), jnp.zeros)
    for sd, cfg, upd in ((sdp, TrainingConfig, Sgd(0.1)),
                         (sdj, JTrainingConfig, JSgd(0.1))):
        sd.set_loss_variables("loss")
        sd.set_training_config(cfg(
            updater=upd, data_set_feature_mapping=["input"],
            data_set_label_mapping=["label"], l1=1e-3, l2=1e-2))
    hp = sdp.fit(iterator=IrisDataSetIterator(batch_size=75), epochs=2)
    hj = sdj.fit(iterator=JIris(batch_size=75), epochs=2)
    np.testing.assert_allclose(hp.loss_curve, hj.loss_curve, rtol=1e-4)
    np.testing.assert_allclose(_np(sdp._values["w0"]),
                               np.asarray(sdj._values["w0"]), atol=1e-5,
                               rtol=1e-4)


def test_control_flow():
    sd = _cpu()
    x = sd.var("x", value=np.asarray(1.0))
    w = sd.while_loop(lambda v: v < 100.0, lambda v: v * 2.0, x)
    assert float(sd.eval(w)) == 128.0
    c = sd.cond(sd.constant("p", True), lambda v: v + 1, lambda v: v - 1,
                sd.constant("o", 10.0))
    assert float(sd.eval(c)) == 11.0
    # both run eagerly, known from their nodes before any call
    assert sd.needs_host(w) and sd.needs_host(c)
    plain = (x * 3.0).rename("plain")
    assert not sd.needs_host(plain)


def test_scan_lambda_and_stop_gradient():
    sd = _cpu()
    xs = sd.constant("xs", np.arange(5, dtype=np.float32))
    sc = sd.scan(lambda c, x: (c + x, c * x), sd.constant("c0", 1.0), xs)
    carry, ys = sd.eval(sc)
    sj = JSameDiff.create()
    scj = sj.scan(lambda c, x: (c + x, c * x), sj.constant("c0", 1.0),
                  sj.constant("xs", jnp.arange(5, dtype=jnp.float32)))
    cj, yj = sj.eval(scj)
    np.testing.assert_allclose(_np(carry), np.asarray(cj))
    np.testing.assert_allclose(_np(ys), np.asarray(yj))
    v = sd.var("v", value=np.asarray([1.0, 2.0]))
    lam = sd.lambda_op("double", lambda t: t * 2.0, v)
    np.testing.assert_allclose(_np(sd.eval(lam)), [2.0, 4.0])
    loss = (sd.stop_gradient(v) * v).sum()
    g = sd.grad(loss)
    np.testing.assert_allclose(_np(g["v"]), [1.0, 2.0])


def test_export_equals_eval_and_the_jax_lowerings_raise():
    sd = _mlp(_cpu())
    ep = sd.export(sd.get_variable("out"), {"input": (2, 4)})
    assert isinstance(ep, torch.export.ExportedProgram)
    feats = RNG.standard_normal((2, 4)).astype(np.float32)
    got = ep.module()(torch.as_tensor(feats))
    np.testing.assert_allclose(_np(got), _np(sd.eval("out",
                                                     {"input": feats})),
                               atol=1e-6)
    assert "matmul" in ep.graph_module.code
    for fn in (sd.to_stablehlo, sd.to_jaxpr):
        with pytest.raises(NotImplementedError, match="export"):
            fn(sd.get_variable("out"), {"input": (2, 4)})


def test_fit_returns_history_with_listeners_and_validation():
    from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener

    sd = _configure(_mlp(_cpu()), Adam(1e-2))
    it = IrisDataSetIterator(batch_size=50)
    collector = CollectScoresListener(frequency=1)
    hist = sd.fit(iterator=it, epochs=5, listeners=[collector],
                  validation_iterator=IrisDataSetIterator(batch_size=75))
    assert isinstance(hist, History)
    assert len(hist.loss_curve) == 5 * 3
    assert len(hist.epoch_losses) == 5
    assert len(hist.validation) == 5
    assert hist.epoch_losses[-1] < hist.epoch_losses[0]
    assert hist.final_loss() == hist.loss_curve[-1]
    assert len(collector.scores) == 15
    np.testing.assert_allclose(collector.scores, hist.loss_curve)
    assert "iterations=15" in repr(hist)


def test_validation_and_listener_scores_equal_the_reference():
    from deeplearning4j_tpu.nn.listeners import CollectScoresListener as JC
    from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener

    sdp = _configure(_mlp(_cpu()), Adam(1e-2))
    sdj = _configure(_mlp(JSameDiff.create(), jnp.zeros), JAdam(1e-2))
    cp, cj = CollectScoresListener(), JC()
    hp = sdp.fit(iterator=IrisDataSetIterator(batch_size=50), epochs=3,
                 listeners=[cp],
                 validation_iterator=IrisDataSetIterator(batch_size=75))
    hj = sdj.fit(iterator=JIris(batch_size=50), epochs=3, listeners=[cj],
                 validation_iterator=JIris(batch_size=75))
    np.testing.assert_allclose(hp.validation, hj.validation, rtol=1e-4)
    np.testing.assert_allclose(cp.scores, cj.scores, rtol=1e-4)
    vf = sdp.fit(iterator=IrisDataSetIterator(batch_size=150), epochs=2,
                 validation_fn=lambda s: 0.25)
    assert vf.validation == [0.25, 0.25]


def test_samediff_evaluate():
    sd = _configure(_mlp(_cpu()), Adam(1e-2))
    sd.fit(iterator=IrisDataSetIterator(batch_size=50), epochs=60)
    ev = sd.evaluate(IrisDataSetIterator(batch_size=50), "out")
    assert ev.accuracy() > 0.9


def test_evaluate_equals_the_reference():
    sdp = _configure(_mlp(_cpu()), Adam(1e-2))
    sdj = _configure(_mlp(JSameDiff.create(), jnp.zeros), JAdam(1e-2))
    ep = sdp.evaluate(IrisDataSetIterator(batch_size=50), "out")
    ej = sdj.evaluate(JIris(batch_size=50), "out")
    assert ep.accuracy() == pytest.approx(ej.accuracy())
    np.testing.assert_array_equal(np.asarray(ep.confusion),
                                  np.asarray(ej.confusion))


def _remat_graph(factory, **kw):
    sd = factory()
    x = sd.placeholder("x", (8, 4))
    y = sd.placeholder("y", (8, 3))
    w1 = sd.var("w1", value=np.random.default_rng(0).standard_normal(
        (4, 16)).astype(np.float32) * 0.1)
    w2 = sd.var("w2", value=np.random.default_rng(1).standard_normal(
        (16, 3)).astype(np.float32) * 0.1)
    h = sd.nn.tanh(x.mmul(w1))
    logits = h.mmul(w2)
    loss = sd.loss.softmax_cross_entropy(y, logits).rename("loss")
    sd.set_loss_variables(loss)
    return sd


def test_sd_fit_remat_identical_trajectory():
    rng = np.random.default_rng(2)
    ds = DataSet(rng.standard_normal((8, 4)).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
    runs = []
    for remat in (False, True):
        sd = _remat_graph(_cpu)
        sd.set_training_config(TrainingConfig(
            updater=Sgd(0.1), data_set_feature_mapping=["x"],
            data_set_label_mapping=["y"]))
        sd.remat = remat
        runs.append((sd.fit(iterator=[ds] * 3, epochs=2), sd))
    (ha, a), (hb, b) = runs
    np.testing.assert_allclose(ha.loss_curve, hb.loss_curve, rtol=1e-6)
    for n in ("w1", "w2"):
        np.testing.assert_allclose(_np(a._values[n]), _np(b._values[n]),
                                   rtol=1e-6)
    # and the reference's trajectory
    sj = _remat_graph(JSameDiff.create)
    sj.set_training_config(JTrainingConfig(
        updater=JSgd(0.1), data_set_feature_mapping=["x"],
        data_set_label_mapping=["y"]))
    jds = JDataSet(ds.features, ds.labels)
    hj = sj.fit(iterator=[jds] * 3, epochs=2)
    np.testing.assert_allclose(hb.loss_curve, hj.loss_curve, rtol=1e-5)


def _train_jax_and_save(path):
    sdj = _configure(_mlp(JSameDiff.create(), jnp.zeros), JAdam(1e-2))
    sdj.fit(iterator=JIris(batch_size=50), epochs=2)
    sdj.save(path, save_training_config=True, save_updater=True)
    return sdj


def test_jax_saved_zip_loads_without_jax_and_evals_equal(tmp_path):
    path = tmp_path / "jax_sd.zip"
    sdj = _train_jax_and_save(path)
    sdp = SameDiff.load(path, device="cpu")
    feats = RNG.standard_normal((7, 4)).astype(np.float32)
    for out in ("out", "logits"):
        np.testing.assert_allclose(
            _np(sdp.eval(out, {"input": feats})),
            np.asarray(sdj.eval(sdj.get_variable(out), {"input": feats})),
            atol=1e-5, rtol=1e-5)
    cfg = sdp._training_config
    assert isinstance(cfg, TrainingConfig)
    assert isinstance(cfg.updater, Adam)
    assert cfg.updater.learning_rate == 1e-2
    assert cfg.feature_mapping == ["input"]
    assert sdp._loss_vars == ["loss"]
    # the updater state carried across: one more epoch in both packages
    # gives the same trajectory (Adam's moments and step count restored)
    hp = sdp.fit(iterator=IrisDataSetIterator(batch_size=50), epochs=1)
    hj = sdj.fit(iterator=JIris(batch_size=50), epochs=1)
    np.testing.assert_allclose(hp.loss_curve, hj.loss_curve, rtol=1e-4)
    np.testing.assert_allclose(_np(sdp._values["w0"]),
                               np.asarray(sdj._values["w0"]), atol=1e-5,
                               rtol=1e-4)


def test_jax_zip_graph_with_namespace_records(tmp_path):
    """Replay records of several namespaces and a numpy dtype argument,
    written by the JAX package, replayed by the port."""
    sj = JSameDiff.create()
    x = sj.placeholder("x", (3, 4))
    a = sj.math.tanh(x)
    b = sj.base.cast(sj.base.argmax(a, 1), np.float32)
    c = sj.base.concat(sj.nn.softmax(a), sj.base.reshape(b, (3, 1)), axis=1)
    (c * 2.0 - 1.0).rename("out")
    sj.save(tmp_path / "g.zip")
    sp = SameDiff.load(tmp_path / "g.zip", device="cpu")
    xv = RNG.standard_normal((3, 4)).astype(np.float32)
    np.testing.assert_allclose(_np(sp.eval("out", {"x": xv})),
                               np.asarray(sj.eval("out", {"x": xv})),
                               atol=1e-6)


def test_port_save_load_round_trip(tmp_path):
    sd = _configure(_mlp(_cpu()), Adam(1e-2))
    sd.fit(iterator=IrisDataSetIterator(batch_size=50), epochs=2)
    sd.save(tmp_path / "p.zip", save_updater=True)
    back = SameDiff.load(tmp_path / "p.zip", device="cpu")
    feats = RNG.standard_normal((5, 4)).astype(np.float32)
    np.testing.assert_array_equal(_np(back.eval("out", {"input": feats})),
                                  _np(sd.eval("out", {"input": feats})))
    # resuming from the zip continues the trajectory exactly
    h1 = sd.fit(iterator=IrisDataSetIterator(batch_size=50), epochs=1)
    h2 = back.fit(iterator=IrisDataSetIterator(batch_size=50), epochs=1)
    np.testing.assert_allclose(h1.loss_curve, h2.loss_curve, rtol=1e-6)


def test_save_refuses_closure_ops(tmp_path):
    sd = _cpu()
    v = sd.var("v", value=np.ones(3, np.float32))
    sd.lambda_op("f", lambda t: t + 1, v)
    with pytest.raises(ValueError, match="replay records"):
        sd.save(tmp_path / "x.zip")


def test_var_initializers_are_seeded_by_name():
    a, b = _cpu(), _cpu()
    va = a.var("layer/w", (8, 4))
    vb = b.var("layer/w", (8, 4))
    np.testing.assert_array_equal(_np(a._values[va.name]),
                                  _np(b._values[vb.name]))
    other = a.var("layer/u", (8, 4))
    assert not np.array_equal(_np(a._values[other.name]),
                              _np(a._values[va.name]))
    assert _np(a._values[va.name]).std() == pytest.approx(
        np.sqrt(2.0 / 12), rel=0.5)


def test_base_ops_on_samediff_and_feed_dtypes():
    sd = _cpu()
    v = sd.constant("c", np.arange(6, dtype=np.float64).reshape(2, 3))
    assert sd._values["c"].dtype == torch.float32    # x64 off
    out = sd.concat(v, v, axis=0)
    assert tuple(sd.eval(out).shape) == (4, 3)
    i = sd.placeholder("i", (2,))
    g = sd.base.gather(v, i)
    got = sd.eval(g, {"i": np.asarray([1, 0], np.int64)})
    np.testing.assert_array_equal(_np(got), [[3, 4, 5], [0, 1, 2]])
    assert sd.eval(sd.base.shape_of(v)).dtype == torch.int32


def test_device_none_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SameDiff.create()


def test_deep_chain_evaluates_and_saves_without_recursion(tmp_path):
    """A 5000-op chain (deeper than Python's recursion limit): eval,
    grad and save/load walk it iteratively."""
    sd = _cpu()
    v = sd.var("v", value=np.asarray([1.0], np.float32))
    x = v
    for _ in range(5000):
        x = x * 1.0001
    x.rename("deep")
    want = 1.0001 ** 5000
    assert float(sd.eval("deep")) == pytest.approx(want, rel=1e-3)
    assert float(sd.grad("deep")["v"]) == pytest.approx(want, rel=1e-3)
    sd.save(tmp_path / "deep.zip")
    back = SameDiff.load(tmp_path / "deep.zip", device="cpu")
    assert float(back.eval("deep")) == float(sd.eval("deep"))


def test_where_needs_the_host_only_with_one_argument():
    sd = _cpu()
    c = sd.constant("c", np.asarray([True, False, True]))
    a = sd.constant("a", np.arange(3, dtype=np.float32))
    sel = sd.base.where(c, a, sd.constant("z", np.zeros(3, np.float32)))
    pos = sd.base.where(c)
    assert not sd.needs_host(sel) and sd.needs_host(pos)
    np.testing.assert_array_equal(_np(sd.eval(sel)), [0.0, 0.0, 2.0])
    np.testing.assert_array_equal(_np(sd.eval(pos)[0]), [0, 2])
