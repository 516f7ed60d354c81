"""The port's checkpoints, ``clone`` and normalizers
(``serde/model_serializer.py``, ``data/normalizers.py``) against the JAX
package, on the CPU.

- a zip the JAX package writes here (``jnet.save``) loads into a port net
  built from the equivalent port config through ``load_params``:
  ``output()`` within 1e-5 of the JAX net's, MLN and CG, bf16 params
  included; ``load_model`` of it raises and names ``load_params``;
- with ``updater=True`` its pickled optax state maps onto the port's
  updater: a JAX net trained k steps and saved with its updater and a
  normalizer, loaded into the port and trained k more, equals the JAX
  net after 2k steps at 1e-5 (f32), for each of the fourteen updaters,
  under a schedule, behind gradient normalization and L1/L2, and with
  per-layer updaters and a frozen layer (``multi_transform``); the
  normalizer comes back as the port's, transforming as the reference's;
- a port round trip is bit-exact (params, states, ``output()``), and
  resuming after ``save_updater=True`` matches uninterrupted training bit
  for bit — with input dropout, whose generator state the zip keeps —
  on both nets (``tests/test_serialization.py:27-60``);
- ``load_params`` into a net copies in place: its tensors keep their
  identity (a captured graph stays bound to live storage);
- ``clone`` is independent of its source: training the clone leaves the
  source bit-identical;
- every normalizer's fit and transform (and revert) within 1e-6 of the
  reference's, and its round trip through the zip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data.normalizers as jnorm
import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
import deeplearning4j_tpu_torch.data.normalizers as tnorm
import deeplearning4j_tpu_torch.nn as tnn
import deeplearning4j_tpu_torch.train as ttrain
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.data import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn._compiled import tensors

ATOL = 1e-5
NORM_ATOL = 1e-6


def _mln(m, t, dropout=0.0, param_dtype=None):
    b = m.NeuralNetConfiguration.builder().seed(12).updater(t.Adam(1e-2))
    if param_dtype is not None:
        b = b.data_type(param_dtype)
    return m.MultiLayerNetwork(
        b.list()
        .layer(m.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                  activation="relu"))
        .layer(m.BatchNormalization())
        .layer(m.DenseLayer(n_out=10, activation="tanh", dropout=dropout))
        .layer(m.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .set_input_type(m.InputType.convolutional(6, 6, 2)).build())


def _cg(m, t, dropout=0.0):
    return m.ComputationGraph(
        m.NeuralNetConfiguration.builder().seed(5).updater(t.Momentum(0.1))
        .graph_builder().add_inputs("in")
        .add_layer("h", m.DenseLayer(n_in=5, n_out=8, activation="relu",
                                     dropout=dropout), "in")
        .add_layer("bn", m.BatchNormalization(), "h")
        .add_layer("out", m.OutputLayer(n_in=8, n_out=3), "bn")
        .set_outputs("out").build())


def _data(rng, kind, n=3, b=8):
    shape = (6, 6, 2) if kind == "mln" else (5,)
    return [(rng.standard_normal((b, *shape)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)])
            for _ in range(n)]


def _leaves(net):
    return [t.detach().clone() for t in tensors((net.params, net.states))]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------- the JAX's zips

@pytest.mark.parametrize("kind", ["mln", "cg", "mln_bf16"])
def test_jax_written_zip_loads_through_load_params(kind, tmp_path):
    rng = np.random.default_rng(0)
    data = _data(rng, "mln" if kind != "cg" else "cg")
    if kind == "cg":
        jnet = _cg(jnn, jtrain).init([(5,)])
        tnet = _cg(tnn, ttrain).init([(5,)], device="cpu")
    else:
        dt = (jnp.bfloat16, torch.bfloat16) if kind == "mln_bf16" else \
            (None, None)
        jnet = _mln(jnn, jtrain, param_dtype=dt[0]).init()
        tnet = _mln(tnn, ttrain, param_dtype=dt[1]).init(device="cpu")
    jnet.fit([JDataSet(x, y) for x, y in data])    # trained, BN stats moved
    path = tmp_path / "jax.zip"
    jnet.save(path, save_updater=True)
    ids = [id(t) for t in tensors((tnet.params, tnet.states))]
    assert serde.load_params(tnet, path) is tnet
    assert [id(t) for t in tensors((tnet.params, tnet.states))] == ids
    x = data[0][0]
    want = np.asarray(jnet.output(x), np.float32)
    got = tnet.output(x).float().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL if kind != "mln_bf16"
                               else 2e-2)
    for path_, leaf in jax.tree_util.tree_leaves_with_path(jnet.params):
        k = [p.key for p in path_]
        t = tnet.params[k[0]][k[1]]
        assert torch.equal(t.float(), torch.as_tensor(
            np.array(leaf, np.float32)))
    with pytest.raises(ValueError, match="load_params"):
        serde.load_model(path, device="cpu")
    # its optax state maps onto the port's updater: one more step each
    # lands together
    serde.load_params(tnet, path, updater=True)
    jnet.fit([JDataSet(*data[1])])
    tnet.fit([DataSet(*data[1])])
    np.testing.assert_allclose(
        tnet.output(x).float().numpy(), np.asarray(jnet.output(x), np.float32),
        atol=ATOL if kind != "mln_bf16" else 2e-2)


def test_load_params_checks_shapes(tmp_path):
    jnet = _cg(jnn, jtrain).init([(5,)])
    path = tmp_path / "jax.zip"
    jnet.save(path)
    wrong = tnn.ComputationGraph(
        tnn.NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
        .add_layer("h", tnn.DenseLayer(n_in=5, n_out=9), "in")
        .add_layer("bn", tnn.BatchNormalization(), "h")
        .add_layer("out", tnn.OutputLayer(n_in=9, n_out=3), "bn")
        .set_outputs("out").build()).init([(5,)], device="cpu")
    with pytest.raises(ValueError, match="shape"):
        serde.load_params(wrong, path)


# ----------------------------------------------------- the port's zips

@pytest.mark.parametrize("kind", ["mln", "cg"])
def test_round_trip_is_bit_exact(kind, tmp_path):
    rng = np.random.default_rng(1)
    net = (_mln(tnn, ttrain).init(device="cpu") if kind == "mln"
           else _cg(tnn, ttrain).init([(5,)], device="cpu"))
    data = _data(rng, kind)
    net.fit([DataSet(x, y) for x, y in data])
    path = tmp_path / "m.zip"
    net.save(path)
    back = type(net).load(path, device="cpu")
    assert type(back) is type(net)
    assert _equal(_leaves(back), _leaves(net))
    assert torch.equal(back.output(data[0][0]), net.output(data[0][0]))
    assert (back.epoch_count, back._step_count) == \
        (net.epoch_count, net._step_count)
    assert back._restored_opt_state is None


@pytest.mark.parametrize("kind", ["mln", "cg"])
def test_resume_after_save_updater_matches_uninterrupted(kind, tmp_path):
    """Two steps, save with the updater, load, two more: the same params,
    states and losses as four uninterrupted steps, bit for bit (input
    dropout on: the generator state travels in the zip)."""
    rng = np.random.default_rng(2)
    data = [DataSet(x, y) for x, y in _data(rng, kind, n=4)]

    def make():
        return (_mln(tnn, ttrain, dropout=0.3).init(device="cpu")
                if kind == "mln"
                else _cg(tnn, ttrain, dropout=0.3).init([(5,)],
                                                        device="cpu"))
    whole = make()
    losses = [whole.fit(ds) for ds in data]
    part = make()
    first = [part.fit(ds) for ds in data[:2]]
    path = tmp_path / "ckpt.zip"
    part.save(path, save_updater=True)
    resumed = type(part).load(path, device="cpu")
    rest = [resumed.fit(ds) for ds in data[2:]]
    assert first + rest == losses
    assert _equal(_leaves(resumed), _leaves(whole))
    assert _equal([t.clone() for t in tensors(resumed._opt_state)],
                  [t.clone() for t in tensors(whole._opt_state)])


def test_load_params_with_updater_of_a_port_zip(tmp_path):
    rng = np.random.default_rng(3)
    data = [DataSet(x, y) for x, y in _data(rng, "cg", n=3)]
    src = _cg(tnn, ttrain).init([(5,)], device="cpu")
    src.fit(data[:2])
    path = tmp_path / "p.zip"
    src.save(path, save_updater=True)
    dst = _cg(tnn, ttrain).init([(5,)], device="cpu")
    dst.fit(data[2])                       # its updater exists
    ids = [id(t) for t in tensors(dst._opt_state)]
    serde.load_params(dst, path, updater=True)
    assert [id(t) for t in tensors(dst._opt_state)] == ids
    assert _equal([t.clone() for t in tensors(dst._opt_state)],
                  [t.clone() for t in tensors(src._opt_state)])
    assert _equal(_leaves(dst), _leaves(src))


@pytest.mark.parametrize("kind", ["mln", "cg"])
def test_clone_is_independent(kind):
    rng = np.random.default_rng(4)
    net = (_mln(tnn, ttrain, dropout=0.2).init(device="cpu")
           if kind == "mln" else _cg(tnn, ttrain).init([(5,)], device="cpu"))
    data = [DataSet(x, y) for x, y in _data(rng, kind)]
    net.fit(data[0])
    before = _leaves(net)
    twin = net.clone()
    assert _equal(_leaves(twin), before)
    assert twin._step_fn is None and twin._gen is not net._gen
    assert all(a is not b for a, b in zip(
        tensors((twin.params, twin.states)),
        tensors((net.params, net.states))))
    twin.fit(data[1:])
    assert _equal(_leaves(net), before)
    assert not _equal(_leaves(twin), before)
    assert torch.equal(net.clone().output(data[0].features),
                       net.output(data[0].features))


# ------------------------------------------------------------ normalizers

def _norm_cases():
    return {
        "standardize": (lambda m: m.NormalizerStandardize(), True),
        "minmax": (lambda m: m.NormalizerMinMaxScaler(-1.0, 2.0), True),
        "image": (lambda m: m.ImagePreProcessingScaler(0.0, 1.0, 255.0),
                  False),
        "vgg16": (lambda m: m.VGG16ImagePreProcessor(), False),
    }


@pytest.mark.parametrize("name", sorted(_norm_cases()))
def test_normalizer_matches_reference_and_round_trips(name, tmp_path):
    make, fit_labels = _norm_cases()[name]
    rng = np.random.default_rng(5)
    batches = [(rng.uniform(0, 255, (10, 4, 4, 3)).astype(np.float32),
                rng.standard_normal((10, 3)).astype(np.float32))
               for _ in range(3)]
    jn, tn = make(jnorm), make(tnorm)
    if fit_labels:
        jn.fit_label(True)
        tn.fit_label(True)
    jn.fit([JDataSet(x, y) for x, y in batches])
    tn.fit([DataSet(torch.as_tensor(x), y) for x, y in batches])
    x, y = batches[1]
    jt, tt = jn.transform(JDataSet(x, y)), tn.transform(DataSet(x, y))
    np.testing.assert_allclose(tt.features, jt.features, atol=NORM_ATOL,
                               rtol=NORM_ATOL)
    np.testing.assert_allclose(tt.labels, jt.labels, atol=NORM_ATOL,
                               rtol=NORM_ATOL)
    np.testing.assert_allclose(tn.revert(tt).features,
                               jn.revert(jt).features, rtol=NORM_ATOL,
                               atol=1e-3)
    net = _cg(tnn, ttrain).init([(5,)], device="cpu")
    path = tmp_path / "n.zip"
    net.save(path, normalizer=tn)
    back = serde.restore_normalizer(path)
    assert type(back) is type(tn)
    np.testing.assert_array_equal(back.transform(DataSet(x, y)).features,
                                  tt.features)
    assert type(serde.load_model(path, device="cpu").normalizer) is type(tn)


@pytest.mark.parametrize("name", ["standardize", "minmax"])
def test_multi_normalizer_matches_reference(name):
    rng = np.random.default_rng(6)
    jcls = {"standardize": jnorm.MultiNormalizerStandardize,
            "minmax": jnorm.MultiNormalizerMinMaxScaler}[name]
    tcls = {"standardize": tnorm.MultiNormalizerStandardize,
            "minmax": tnorm.MultiNormalizerMinMaxScaler}[name]
    batches = [([rng.standard_normal((8, 3)).astype(np.float32),
                 rng.uniform(-5, 5, (8, 2)).astype(np.float32)],
                [rng.standard_normal((8, 2)).astype(np.float32)])
               for _ in range(2)]
    jn, tn = jcls().fit_label(True), tcls().fit_label(True)
    jn.fit([JMultiDataSet(f, lab) for f, lab in batches])
    tn.fit([MultiDataSet(f, lab) for f, lab in batches])
    f, lab = batches[0]
    jt, tt = jn.transform(JMultiDataSet(f, lab)), \
        tn.transform(MultiDataSet(f, lab))
    for a, b in zip(tt.features + tt.labels, jt.features + jt.labels):
        np.testing.assert_allclose(a, b, atol=NORM_ATOL, rtol=NORM_ATOL)


def test_composite_preprocessor_matches_reference():
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 255, (6, 3)).astype(np.float32)
    y = rng.standard_normal((6, 2)).astype(np.float32)
    jc = jnorm.CompositeDataSetPreProcessor(
        jnorm.ImagePreProcessingScaler(), jnorm.NormalizerStandardize().fit(
            JDataSet(x / 255.0, y)))
    tc = tnorm.CompositeDataSetPreProcessor(
        tnorm.ImagePreProcessingScaler(), tnorm.NormalizerStandardize().fit(
            DataSet(x / 255.0, y)))
    np.testing.assert_allclose(tc.pre_process(DataSet(x, y)).features,
                               jc.pre_process(JDataSet(x, y)).features,
                               atol=NORM_ATOL)


# ------------------------------------------- resuming a JAX net's updater

_UPDATERS = ["Sgd", "Nesterovs", "Momentum", "Adam", "AdamW", "AMSGrad",
             "Nadam", "AdaMax", "AdaDelta", "AdaGrad", "RmsProp", "Lion",
             "Lamb", "NoOp"]
_LR = {"Sgd": 0.1, "Nesterovs": 0.05, "Momentum": 0.05, "AdaDelta": 1.0,
       "AdaGrad": 0.1, "RmsProp": 1e-2, "Lion": 1e-3, "NoOp": None}


def _resume_net(m, t, name, variant):
    up = getattr(t, name)() if _LR.get(name, 1e-2) is None else \
        getattr(t, name)(_LR.get(name, 1e-2))
    if variant == "schedule":
        up = up.with_lr(t.StepSchedule(initial_value=_LR.get(name, 1e-2),
                                       decay_rate=0.5, step=2))
    b = m.NeuralNetConfiguration.builder().seed(21).updater(up)
    if variant == "gradnorm":
        b = b.gradient_normalization("clip_l2_per_layer") \
            .gradient_normalization_threshold(0.5).l2(1e-3).l1(1e-4)
    dense = dict(n_out=6, activation="tanh")
    if variant == "labels":
        dense["updater"] = t.Sgd(0.05)
    return m.MultiLayerNetwork(
        b.list()
        .layer(m.DenseLayer(n_in=4, n_out=8, activation="relu",
                            frozen=(variant == "labels")))
        .layer(m.DenseLayer(**dense))
        .layer(m.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .set_input_type(m.InputType.feed_forward(4)).build())


@pytest.mark.parametrize("name,variant", [
    *((n, "plain") for n in _UPDATERS),
    ("Adam", "schedule"), ("RmsProp", "schedule"), ("Momentum", "gradnorm"),
    ("AdaDelta", "gradnorm"), ("Adam", "labels"), ("Lamb", "labels")])
def test_jax_updater_state_resumes_in_the_port(name, variant, tmp_path):
    from deeplearning4j_tpu.serde.model_serializer import save_model
    rng = np.random.default_rng(4)
    data = [(rng.standard_normal((8, 4)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(4)]
    jnet = _resume_net(jnn, jtrain, name, variant).init()
    tnet = _resume_net(tnn, ttrain, name, variant).init(device="cpu")
    for x, y in data[:2]:
        jnet.fit(JDataSet(x, y))
    norm = jnorm.NormalizerStandardize().fit(JDataSet(data[0][0],
                                                      data[0][1]))
    path = tmp_path / "jax.zip"
    save_model(jnet, path, save_updater=True, normalizer=norm)
    serde.load_params(tnet, path, updater=True)
    assert tnet._opt_state is None           # restored when fit builds it
    for x, y in data[2:]:
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
    for (p, leaf) in jax.tree_util.tree_leaves_with_path(jnet.params):
        k = [q.key for q in p]
        np.testing.assert_allclose(
            tnet.params[k[0]][k[1]].detach().numpy(), np.asarray(leaf),
            atol=ATOL, err_msg=f"{name}/{variant} {k}")
    got = serde.restore_normalizer(path)
    assert type(got) is tnorm.NormalizerStandardize
    x = data[3][0]
    np.testing.assert_allclose(got.transform(DataSet(x, x)).features,
                               norm.transform(JDataSet(x, x)).features,
                               atol=1e-6)


def test_jax_updater_state_into_a_built_updater(tmp_path):
    """``load_params(updater=True)`` into a net whose updater exists copies
    the optax state into its tensors in place."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    jnet = _resume_net(jnn, jtrain, "Adam", "plain").init()
    jnet.fit(JDataSet(x, y))
    path = tmp_path / "jax.zip"
    jnet.save(path, save_updater=True)
    tnet = _resume_net(tnn, ttrain, "Adam", "plain").init(device="cpu")
    tnet.fit(DataSet(x * 2, y))                  # builds its updater
    ids = [id(t) for t in tensors(tnet._opt_state)]
    serde.load_params(tnet, path, updater=True)
    assert [id(t) for t in tensors(tnet._opt_state)] == ids
    adam = jnet._opt_state[1][0]
    assert int(tnet._opt_state[1][0]["count"]) == int(adam.count) == 1
    for (p, leaf) in jax.tree_util.tree_leaves_with_path(adam.mu):
        k = [q.key for q in p]
        np.testing.assert_array_equal(
            tnet._opt_state[1][0]["mu"][k[0]][k[1]].numpy(),
            np.asarray(leaf))
    wrong = _resume_net(tnn, ttrain, "Momentum", "plain").init(device="cpu")
    wrong.fit(DataSet(x, y))
    with pytest.raises((KeyError, ValueError)):
        serde.load_params(wrong, path, updater=True)
