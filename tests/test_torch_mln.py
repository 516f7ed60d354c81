"""The port's MultiLayerNetwork, its builders, iterators and the zoo's
LeNet and TextGenerationLSTM against the JAX package's, on the CPU.

The JAX net's params and states go to the port with
``nn.params_from_numpy``; inputs, labels and masks come from numpy.
Tolerances, f32: outputs, scores and losses atol 1e-5, params after each
``fit`` step atol 1e-5 (Adam from identical params and zero moments;
the two sides sum products in another order), gradients atol 1e-4.

- ``output()``, ``score()`` (with features and labels masks) and
  ``gradient_and_score`` on a small LSTM char-RNN (the net of
  ``tests/test_e2e.py:54-75``) and a narrowed LeNet-shaped conv net with
  the automatic CNN→dense preprocessor.
- 3 ``fit`` steps of Adam on each, the trajectory held at every step, and
  one masked step on the char-RNN.
- ``rnn_time_step`` step by step and chunk by chunk against ``output()``
  on the prefix and against JAX's stream; ``rnn_set_previous_state``.
- The char-RNN loss halves on the synthetic text (the reference's own
  test, through ``ListDataSetIterator``).
- ``TextGenerationLSTM`` (vocab 11, T 6, units 16) with its GravesLSTMs
  ``fused`` True and False against JAX's ``output()``; ``LeNet``.
- The device rule, the builder, the iterator protocol, the params API and
  the knobs not ported yet.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data as jdata
import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.train as jtrain
import deeplearning4j_tpu_torch.data as tdata
import deeplearning4j_tpu_torch.nn as tnn
import deeplearning4j_tpu_torch.train as ttrain
from deeplearning4j_tpu.zoo.cnn_simple import LeNet as JLeNet
from deeplearning4j_tpu.zoo.cnn_simple import \
    TextGenerationLSTM as JTextGenerationLSTM
from deeplearning4j_tpu_torch.nn import params_from_numpy
from deeplearning4j_tpu_torch.train.updaters import tree_leaves
from deeplearning4j_tpu_torch.zoo import LeNet, TextGenerationLSTM

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_ATOL = 1e-4
TEXT = "hello tpu world. " * 40


def _np(t):
    return t.detach().float().numpy()


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _char_data(seq_len=16, n_windows=None):
    chars = sorted(set(TEXT))
    idx = {c: i for i, c in enumerate(chars)}
    xs, ys = [], []
    for i in range(0, len(TEXT) - seq_len - 1, seq_len):
        window = TEXT[i:i + seq_len + 1]
        xs.append([idx[c] for c in window[:-1]])
        ys.append([idx[c] for c in window[1:]])
    eye = np.eye(len(chars), dtype=np.float32)
    x, y = eye[np.array(xs)], eye[np.array(ys)]
    return (x, y) if n_windows is None else (x[:n_windows], y[:n_windows])


def _charnn_conf(nn, train, n, units=32, lr=5e-3, seed=0, cell="LSTM"):
    return (nn.NeuralNetConfiguration.builder().seed(seed)
            .updater(train.Adam(lr))
            .list()
            .layer(getattr(nn, cell)(n_in=n, n_out=units))
            .layer(nn.RnnOutputLayer(n_in=units, n_out=n,
                                     activation="softmax", loss="mcxent"))
            .build())


def _lenet_conf(nn, train, hw=12):
    return (nn.NeuralNetConfiguration.builder().seed(123)
            .updater(train.Adam(1e-3))
            .list()
            .layer(nn.ConvolutionLayer(n_out=4, kernel_size=(5, 5),
                                       convolution_mode="same",
                                       activation="relu"))
            .layer(nn.SubsamplingLayer(kernel_size=(2, 2)))
            .layer(nn.ConvolutionLayer(n_out=8, kernel_size=(5, 5),
                                       convolution_mode="same",
                                       activation="relu"))
            .layer(nn.SubsamplingLayer(kernel_size=(2, 2)))
            .layer(nn.DenseLayer(n_out=16, activation="relu"))
            .layer(nn.OutputLayer(n_out=10, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(nn.InputType.convolutional(hw, hw, 1))
            .build())


def _lenet_data(b=4, hw=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((b, hw, hw, 1), np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, b)]
    return x, y


def _pair(kind):
    """(jax net, port net on the CPU with the JAX net's params), data."""
    if kind == "charnn":
        x, y = _char_data(n_windows=8)
        n = x.shape[-1]
        jnet = jnn.MultiLayerNetwork(_charnn_conf(jnn, jtrain, n)).init(
            (16, n))
        tnet = tnn.MultiLayerNetwork(_charnn_conf(tnn, ttrain, n)).init(
            (16, n), device="cpu")
    else:
        x, y = _lenet_data()
        jnet = jnn.MultiLayerNetwork(_lenet_conf(jnn, jtrain)).init()
        tnet = tnn.MultiLayerNetwork(_lenet_conf(tnn, ttrain)).init(
            device="cpu")
    tnet.params, tnet.states = params_from_numpy(
        _np_tree(jnet.params), _np_tree(jnet.states), "cpu")
    return jnet, tnet, x, y


def _assert_params_close(jnet, tnet, atol):
    jl = jax.tree_util.tree_leaves(jnet.params)
    tl = tree_leaves(tnet.params)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=atol)


# ------------------------------------------------------------ the network

@pytest.mark.parametrize("kind", ["charnn", "lenet"])
def test_output_and_score_match_jax(kind):
    jnet, tnet, x, y = _pair(kind)
    np.testing.assert_allclose(_np(tnet.output(x)),
                               np.asarray(jnet.output(x)), atol=ATOL)
    assert tnet.num_params() == jnet.num_params()
    ds_j, ds_t = jdata.DataSet(x, y), tdata.DataSet(x, y)
    assert abs(tnet.score(ds_t) - jnet.score(ds_j)) <= ATOL
    tg, ts = tnet.gradient_and_score(ds_t)
    jg, js = jnet.gradient_and_score(ds_j)
    assert abs(ts - js) <= ATOL
    for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=GRAD_ATOL)
    acts = tnet.feed_forward(x)
    assert len(acts) == len(tnet.layers) + 1
    np.testing.assert_allclose(_np(acts[-1]), _np(tnet.output(x)), atol=0)


def test_masked_score_and_step_match_jax():
    jnet, tnet, x, y = _pair("charnn")
    fm = np.ones(x.shape[:2], np.float32)
    fm[0, 10:] = 0.0
    fm[3, 4:] = 0.0
    lm = fm.copy()
    lm[5, :2] = 0.0
    ds_j = jdata.DataSet(x, y, fm, lm)
    ds_t = tdata.DataSet(x, y, fm, lm)
    assert abs(tnet.score(ds_t) - jnet.score(ds_j)) <= ATOL
    lt, lj = tnet.fit(ds_t), jnet.fit(ds_j)
    assert abs(lt - lj) <= ATOL
    _assert_params_close(jnet, tnet, ATOL)


@pytest.mark.parametrize("kind", ["charnn", "lenet"])
def test_fit_trajectory_matches_jax(kind):
    jnet, tnet, x, y = _pair(kind)
    for _ in range(3):
        lj = jnet.fit(jdata.DataSet(x, y))
        lt = tnet.fit(tdata.DataSet(x, y))
        assert abs(lt - lj) <= ATOL
        _assert_params_close(jnet, tnet, ATOL)
    assert tnet._step_count == 3 and tnet.epoch_count == 3


def test_fit_accepts_arrays_and_iterators():
    jnet, tnet, x, y = _pair("charnn")
    assert abs(tnet.fit(x, y) - jnet.fit(x, y)) <= ATOL
    lt = tnet.fit(tdata.ListDataSetIterator(tdata.DataSet(x, y), 4))
    lj = jnet.fit(jdata.ListDataSetIterator(jdata.DataSet(x, y), 4))
    assert abs(lt - lj) <= ATOL
    _assert_params_close(jnet, tnet, ATOL)


def test_char_rnn_loss_drops():
    """The reference's own oracle (tests/test_e2e.py:54-75)."""
    x, y = _char_data()
    n = x.shape[-1]
    net = tnn.MultiLayerNetwork(_charnn_conf(tnn, ttrain, n)).init(
        (16, n), device="cpu")
    ds = tdata.DataSet(x, y)
    first = net.score(ds)
    net.fit(tdata.ListDataSetIterator(ds, batch_size=16), epochs=12)
    last = net.score(ds)
    assert last < first * 0.5, (first, last)


# ------------------------------------------------------ streaming inference

@pytest.mark.parametrize("cell", ["SimpleRnn", "LSTM", "GravesLSTM", "GRU"])
def test_rnn_time_step_matches_output(cell):
    rng = np.random.default_rng(7)
    jnet = jnn.MultiLayerNetwork(
        _charnn_conf(jnn, jtrain, 3, units=6, seed=11, cell=cell)).init(
            (5, 3))
    tnet = tnn.MultiLayerNetwork(
        _charnn_conf(tnn, ttrain, 3, units=6, seed=11, cell=cell)).init(
            (5, 3), device="cpu")
    tnet.params, tnet.states = params_from_numpy(
        _np_tree(jnet.params), _np_tree(jnet.states), "cpu")
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    full = _np(tnet.output(x))
    np.testing.assert_allclose(full, np.asarray(jnet.output(x)), atol=ATOL)
    tnet.rnn_clear_previous_state()
    stepped = np.stack([_np(tnet.rnn_time_step(x[:, t]))
                        for t in range(5)], axis=1)
    np.testing.assert_allclose(stepped, full, atol=ATOL)
    tnet.rnn_clear_previous_state()
    first = _np(tnet.rnn_time_step(x[:, :3]))
    rest = _np(tnet.rnn_time_step(x[:, 3:]))
    np.testing.assert_allclose(np.concatenate([first, rest], 1), full,
                               atol=ATOL)
    jnet.rnn_clear_previous_state()
    jnet.rnn_time_step(x[:, :3])
    np.testing.assert_allclose(rest, np.asarray(jnet.rnn_time_step(x[:, 3:])),
                               atol=ATOL)
    tnet.rnn_clear_previous_state()
    np.testing.assert_allclose(_np(tnet.rnn_time_step(x[:, 0])), full[:, 0],
                               atol=ATOL)


def test_rnn_state_injection_and_limits():
    rng = np.random.default_rng(8)
    tnet = tnn.MultiLayerNetwork(
        _charnn_conf(tnn, ttrain, 3, units=6, seed=2)).init((5, 3),
                                                            device="cpu")
    x = rng.standard_normal((2, 5, 3)).astype(np.float32)
    full = _np(tnet.output(x))
    tnet.rnn_clear_previous_state()
    tnet.rnn_time_step(x[:, :3])
    saved = tnet.rnn_get_previous_state(0)
    assert isinstance(saved, tuple) and saved[0].shape == (2, 6)
    tnet.rnn_clear_previous_state()
    assert tnet.rnn_get_previous_state(0) is None
    tnet.rnn_set_previous_state(0, tuple(_np(s) for s in saved))
    np.testing.assert_allclose(_np(tnet.rnn_time_step(x[:, 3:])),
                               full[:, 3:], atol=ATOL)
    # a different batch restarts from zeros
    np.testing.assert_allclose(_np(tnet.rnn_time_step(x[:1, 0])),
                               full[:1, 0], atol=ATOL)
    conf16 = (tnn.NeuralNetConfiguration.builder().seed(2)
              .data_type(torch.float32, torch.bfloat16).list()
              .layer(tnn.LSTM(n_in=3, n_out=6))
              .layer(tnn.RnnOutputLayer(n_in=6, n_out=4))
              .build())
    y16 = tnn.MultiLayerNetwork(conf16).init((5, 3), device="cpu") \
        .rnn_time_step(x[:, 0])
    assert y16.shape == (2, 4) and torch.isfinite(y16.float()).all()
    confbi = (tnn.NeuralNetConfiguration.builder().list()
              .layer(tnn.Bidirectional(fwd=tnn.LSTM(n_in=3, n_out=6)))
              .layer(tnn.RnnOutputLayer(n_in=12, n_out=4)).build())
    netbi = tnn.MultiLayerNetwork(confbi).init((5, 3), device="cpu")
    with pytest.raises(NotImplementedError, match="Bidirectional"):
        netbi.rnn_time_step(x[:, 0])


# ----------------------------------------------------------------- the zoo

@pytest.mark.parametrize("fused", [False, True])
def test_text_generation_lstm_matches_jax(fused):
    jzm = JTextGenerationLSTM(num_classes=11, input_shape=(6, 11), units=16)
    zm = TextGenerationLSTM(num_classes=11, input_shape=(6, 11), units=16)
    jnet, tnet = jzm.init(), zm.init(device="cpu")
    assert [type(l).__name__ for l in tnet.layers] == \
        ["GravesLSTM", "GravesLSTM", "RnnOutputLayer"]
    rng = np.random.default_rng(0)
    # nonzero peepholes, so they are exercised
    jp = _np_tree(jnet.params)
    for k in ("layer_0", "layer_1"):
        for p in ("pI", "pF", "pO"):
            jp[k][p] = (rng.standard_normal(16) * 0.2).astype(np.float32)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, jp)
    tnet.params, tnet.states = params_from_numpy(jp, _np_tree(jnet.states),
                                                 "cpu")
    for layer in tnet.layers[:2]:
        layer.fused = fused
    seed = np.eye(11, dtype=np.float32)[rng.integers(0, 11, (2, 6))]
    np.testing.assert_allclose(_np(tnet.output(seed)),
                               np.asarray(jnet.output(seed)), atol=ATOL)
    toks = zm.generate(tnet, seed[:, :4], n_steps=5, temperature=0.8)
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 11
    tnet.rnn_clear_previous_state()
    np.testing.assert_allclose(_np(tnet.rnn_time_step(seed))[:, -1],
                               _np(tnet.output(seed))[:, -1], atol=ATOL)


def test_lenet_matches_jax():
    jnet, tnet = JLeNet().init(), LeNet().init(device="cpu")
    assert tnet.num_params() == jnet.num_params() == 1256080
    assert list(tnet._preprocessors) == list(jnet._preprocessors) == [4]
    tnet.params, tnet.states = params_from_numpy(
        _np_tree(jnet.params), _np_tree(jnet.states), "cpu")
    x, _ = _lenet_data(b=2, hw=28)
    np.testing.assert_allclose(_np(tnet.output(x)),
                               np.asarray(jnet.output(x)), atol=ATOL)
    assert "Total params: 1256080" in tnet.summary()


def test_bf16_nets_train_on_the_host():
    x, y = _lenet_data(b=4, hw=28)
    net = LeNet(compute_dtype=torch.bfloat16).init(device="cpu")
    losses = [net.fit(tdata.DataSet(x, y)) for _ in range(3)]
    assert losses[-1] < losses[0]
    out = net.output(x)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 10)
    xs, ys = _char_data(seq_len=6, n_windows=4)
    zm = TextGenerationLSTM(num_classes=xs.shape[-1], units=8,
                            input_shape=(6, xs.shape[-1]),
                            compute_dtype=torch.bfloat16)
    cnet = zm.init(device="cpu")
    for layer in cnet.layers[:2]:
        layer.fused = True
    assert np.isfinite(cnet.fit(tdata.DataSet(xs, ys)))


# ------------------------------------------------- builders, API, limits

def test_device_rule_and_unported_knobs(tmp_path):
    conf = _charnn_conf(tnn, ttrain, 5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnn.MultiLayerNetwork(conf).init((4, 5))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnn.MultiLayerNetwork(conf).fit(
                tdata.DataSet(np.zeros((2, 4, 5), np.float32),
                              np.zeros((2, 4, 5), np.float32)))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TextGenerationLSTM(num_classes=5, input_shape=(4, 5)).init()
    net = tnn.MultiLayerNetwork(conf).init((4, 5), device="cpu")
    # the configuration's JSON is ported (tests/test_torch_upstream_serde.py
    # holds it against the JAX package's)
    import json
    assert [l["__class__"] for l in json.loads(conf.to_json())["layers"]] \
        == [type(l).__name__ for l in conf.layers]
    # remat segments are ported (tests/test_torch_remat.py holds them)
    net.remat_segments = 2
    assert net.remat_segments == 2 and net.clone().remat_segments == 2
    # the workflow around fit is ported (tests/test_torch_eval.py,
    # test_torch_serde.py, test_torch_regularize.py hold it)
    assert net.evaluate([]).accuracy() == 0.0
    net.save(tmp_path / "x.zip")
    assert net.clone() is not net
    assert net.enable_gradient_anomaly_detection() is net


def test_list_builder_and_configuration():
    layer = tnn.DenseLayer(n_out=3)
    b = (tnn.NeuralNetConfiguration.builder().weight_init("relu")
         .activation("tanh").l2(1e-4).list()
         .layer(0, layer).layer(tnn.OutputLayer(n_out=2))
         .backprop_type("tbptt").t_bptt_length(10)
         .input_type(tnn.InputType.feed_forward(4)))
    conf = b.build()
    assert isinstance(conf, tnn.MultiLayerConfiguration)
    assert conf.layers[0] is not layer           # build() copies
    assert layer.weight_init is None
    assert (conf.layers[0].weight_init, conf.layers[0].l2) == ("relu", 1e-4)
    assert conf.input_type == ("ff", (4,))
    net = tnn.MultiLayerNetwork(conf).init(device="cpu")
    assert net.output(np.zeros((2, 4), np.float32)).shape == (2, 2)


def test_params_api_matches_jax():
    jnet, tnet, x, _ = _pair("lenet")
    np.testing.assert_allclose(_np(tnet.params_flat()),
                               np.asarray(jnet.params_flat()), atol=0)
    flat = np.arange(tnet.num_params(), dtype=np.float32) * 1e-6
    tnet.set_params_flat(flat)
    jnet.set_params_flat(jnp.asarray(flat))
    np.testing.assert_allclose(_np(tnet.output(x)),
                               np.asarray(jnet.output(x)), atol=ATOL)
    w = np.full(tnet.get_param(4, "W").shape, 0.01, np.float32)
    tnet.set_param(4, "W", w)
    jnet.set_param(4, "W", w)
    assert tnet.get_param(4, "W").requires_grad
    np.testing.assert_allclose(_np(tnet.output(x)),
                               np.asarray(jnet.output(x)), atol=ATOL)


def test_list_iterator_protocol_matches_jax():
    x, y = _char_data(n_windows=10)
    jit = jdata.ListDataSetIterator(jdata.DataSet(x, y), 4)
    tit = tdata.ListDataSetIterator(
        [tdata.DataSet(x[:6], y[:6]), tdata.DataSet(x[6:], y[6:])], 4)
    assert len(tit) == len(jit) == 3
    assert tit.total_outcomes() == jit.total_outcomes() == y.shape[-1]
    assert [d.num_examples() for d in tit] == [4, 4, 2]
    tit.reset()
    assert tit.has_next() and tit.next(3).num_examples() == 3
    np.testing.assert_array_equal(tit.next().features, x[3:7])
    assert tit.batch() == 4 and isinstance(tit, tdata.BaseDatasetIterator)
