"""The port's upstream DL4J serde (``deeplearning4j_tpu_torch/serde/
upstream_dl4j.py``) against the JAX package's: ``tests/
test_upstream_serde.py`` mirrored, and the two held to each other.

- the ND4J wire bytes equal the JAX writer's, and hand-packed bytes
  decode alike;
- the hand-synthesized fixtures (raw json/struct, not a writer) restore
  to the numpy oracles in both;
- a zip the JAX package wrote loads in the port and one the port wrote
  loads in the JAX package, with equal outputs (1e-6); for the same
  params and Adam state the two writers' ``coefficients.bin`` and
  ``updaterState.bin`` are byte-equal;
- training resumed from a JAX-written zip (Adam m/v and count) matches
  the JAX net's next steps at 1e-5;
- ``normalizer.bin`` goes both ways byte-equal, and the config JSON
  (``to_upstream_json`` / ``from_upstream_json``) round-trips.
"""

from __future__ import annotations

import io
import json
import struct
import zipfile

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data as jdata
import deeplearning4j_tpu.nn as jnn
import deeplearning4j_tpu.serde as jserde
import deeplearning4j_tpu.serde.upstream_dl4j as jup
import deeplearning4j_tpu.train as jtrain
import deeplearning4j_tpu_torch.data as tdata
import deeplearning4j_tpu_torch.nn as tnn
import deeplearning4j_tpu_torch.serde as tserde
import deeplearning4j_tpu_torch.serde.upstream_dl4j as tup
import deeplearning4j_tpu_torch.train as ttrain

torch.set_num_threads(2)

_J = "org.deeplearning4j.nn.conf.layers."
_ACT = "org.nd4j.linalg.activations.impl."
_LOSS = "org.nd4j.linalg.lossfunctions.impl."
_GV = "org.deeplearning4j.nn.conf.graph."


def _utf(s):
    raw = s.encode()
    return struct.pack(">H", len(raw)) + raw


def _nd4j_bytes_by_hand(flat_f32):
    """Raw Nd4j.write wire bytes for a (1, N) f-ordered row vector, packed
    with struct only (no serde code)."""
    n = len(flat_f32)
    info = [2, 1, n, 1, 1, 0, 1, ord("f")]
    out = io.BytesIO()
    out.write(_utf("LONG"))
    out.write(struct.pack(">i", len(info)))
    out.write(struct.pack(">%dq" % len(info), *info))
    out.write(_utf("FLOAT"))
    out.write(struct.pack(">i", n))
    out.write(struct.pack(">%df" % n, *flat_f32))
    return out.getvalue()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _both_out(jnet, tnet, *xs):
    return _np(tnet.output(*xs)), _np(jnet.output(*xs))


@pytest.mark.parametrize("shape", [(3,), (2, 5), (4, 3, 2)])
@pytest.mark.parametrize("order", ["c", "f"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
def test_nd4j_wire_bytes_equal_the_reference(shape, order, dtype):
    a = np.random.default_rng(0).normal(size=shape).astype(dtype)
    raw = tup.write_nd4j_array(a, order=order)
    assert raw == jup.write_nd4j_array(a, order=order)
    back = tup.read_nd4j_array(raw)
    np.testing.assert_array_equal(back, a)
    assert back.dtype == jup.read_nd4j_array(raw).dtype


def test_hand_packed_bytes_decode_alike():
    flat = [0.5, -1.25, 3.0, 7.5]
    raw = _nd4j_bytes_by_hand(flat)
    np.testing.assert_array_equal(tup.read_nd4j_array(raw),
                                  np.asarray([flat], np.float32))
    np.testing.assert_array_equal(tup.read_nd4j_array(raw),
                                  jup.read_nd4j_array(raw))


def _dense_fixture_zip(tmp_path):
    w1 = (np.arange(20, dtype=np.float32).reshape(4, 5) - 10.0) / 10.0
    b1 = np.linspace(-0.2, 0.2, 5, dtype=np.float32)
    w2 = (np.arange(15, dtype=np.float32).reshape(5, 3) - 7.0) / 7.0
    b2 = np.asarray([0.1, -0.1, 0.05], np.float32)
    upd = {"@class": "org.nd4j.linalg.learning.config.Adam",
           "learningRate": 0.001}
    conf = {
        "backpropType": "Standard", "iterationCount": 0,
        "inputType": {"@class": "org.deeplearning4j.nn.conf.inputs."
                                "InputType$InputTypeFeedForward", "size": 4},
        "confs": [
            {"seed": 7, "miniBatch": True, "iUpdater": upd,
             "layer": {"@class": _J + "DenseLayer", "nin": 4, "nout": 5,
                       "hasBias": True,
                       "activationFn": {"@class": _ACT + "ActivationReLU"}}},
            {"seed": 7, "miniBatch": True, "iUpdater": upd,
             "layer": {"@class": _J + "OutputLayer", "nin": 5, "nout": 3,
                       "hasBias": True,
                       "activationFn": {"@class": _ACT + "ActivationSoftmax"},
                       "lossFn": {"@class": _LOSS + "LossMCXENT"}}},
        ],
    }
    flat = np.concatenate([w1.ravel(order="f"), b1, w2.ravel(order="f"),
                           b2])
    path = tmp_path / "upstream_dense.zip"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf))
        zf.writestr("coefficients.bin", _nd4j_bytes_by_hand(flat.tolist()))
    return path, (w1, b1, w2, b2)


def test_restore_upstream_dense_fixture_matches_numpy_oracle(tmp_path):
    path, (w1, b1, w2, b2) = _dense_fixture_zip(tmp_path)
    assert tserde.is_upstream_format(path)
    net = tserde.restore_upstream_multi_layer_network(path, device="cpu")
    x = np.random.default_rng(1).normal(size=(6, 4)).astype(np.float32)
    got = _np(net.output(x))
    h = np.maximum(x @ w1 + b1, 0.0)
    logits = h @ w2 + b2
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    np.testing.assert_allclose(got, e / e.sum(axis=1, keepdims=True),
                               rtol=1e-5, atol=1e-6)
    # the facade and load_model auto-detect the upstream layout
    for net2 in (tserde.ModelSerializer.restore_multi_layer_network(
            path, device="cpu"), tserde.load_model(path, device="cpu")):
        np.testing.assert_array_equal(_np(net2.output(x)), got)
    jnet = jup.restore_upstream_multi_layer_network(path)
    np.testing.assert_allclose(got, np.asarray(jnet.output(x)), atol=1e-6)


def test_restore_upstream_conv_fixture_oihw_layout(tmp_path):
    kh = kw = 2
    cin, cout = 2, 3
    w = np.random.default_rng(2).normal(size=(cout, cin, kh, kw)
                                        ).astype(np.float32)
    b = np.asarray([0.05, -0.05, 0.2], np.float32)
    wd = np.random.default_rng(3).normal(size=(12, 4)).astype(np.float32)
    bd = np.zeros(4, np.float32)
    conf = {
        "backpropType": "Standard",
        "inputType": {"@class": "org.deeplearning4j.nn.conf.inputs."
                                "InputType$InputTypeConvolutional",
                      "height": 3, "width": 3, "channels": 2},
        "confs": [
            {"seed": 1, "layer": {
                "@class": _J + "ConvolutionLayer", "nin": 2, "nout": 3,
                "kernelSize": [2, 2], "stride": [1, 1], "padding": [0, 0],
                "dilation": [1, 1], "convolutionMode": "Truncate",
                "hasBias": True,
                "activationFn": {"@class": _ACT + "ActivationIdentity"}}},
            {"seed": 1, "layer": {
                "@class": _J + "OutputLayer", "nin": 12, "nout": 4,
                "hasBias": True,
                "activationFn": {"@class": _ACT + "ActivationSoftmax"},
                "lossFn": {"@class": _LOSS + "LossMCXENT"}}},
        ],
    }
    flat = np.concatenate([w.ravel(order="f"), b, wd.ravel(order="f"), bd])
    path = tmp_path / "upstream_conv.zip"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf))
        zf.writestr("coefficients.bin", _nd4j_bytes_by_hand(flat.tolist()))
    net = tserde.restore_upstream_multi_layer_network(path, device="cpu")
    x = np.random.default_rng(4).normal(size=(2, 3, 3, 2)).astype(np.float32)
    got = _np(net.output(x))
    conv = np.einsum("nijabc,ocab->nijo", np.stack(
        [np.stack([x[:, i:i + kh, j:j + kw] for j in range(2)], 1)
         for i in range(2)], 1), w) + b
    logits = conv.reshape(2, 12) @ wd + bd
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    np.testing.assert_allclose(got, e / e.sum(axis=1, keepdims=True),
                               rtol=1e-4, atol=1e-5)
    jnet = jup.restore_upstream_multi_layer_network(path)
    np.testing.assert_allclose(got, np.asarray(jnet.output(x)), atol=1e-6)


def _jax_trained_net(seed=11, steps=3):
    conf = (jnn.NeuralNetConfiguration.builder().seed(seed)
            .updater(jtrain.Adam(1e-2)).list()
            .layer(jnn.DenseLayer(n_in=6, n_out=8, activation="tanh"))
            .layer(jnn.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                   loss="mcxent"))
            .build())
    net = jnn.MultiLayerNetwork(conf).init()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    for _ in range(steps):
        net.fit(jdata.DataSet(x, y))
    return net, x, y


def _port_trained_net(seed=11, steps=3):
    conf = (tnn.NeuralNetConfiguration.builder().seed(seed)
            .updater(ttrain.Adam(1e-2)).list()
            .layer(tnn.DenseLayer(n_in=6, n_out=8, activation="tanh"))
            .layer(tnn.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                   loss="mcxent"))
            .build())
    net = tnn.MultiLayerNetwork(conf).init(device="cpu")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    for _ in range(steps):
        net.fit(tdata.DataSet(x, y))
    return net, x, y


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_a_jax_written_zip_resumes_in_the_port(tmp_path):
    """The JAX net trained 3 steps and written with its Adam state: the
    port restores it (outputs 1e-6, iteration count), and two more steps
    on both match at 1e-5; the port writes it back byte-equal."""
    jnet, x, y = _jax_trained_net()
    path = tmp_path / "jax.zip"
    jserde.write_model_upstream_format(jnet, path, save_updater=True)
    tnet = tserde.load_model(path, device="cpu")
    assert type(tnet).__name__ == "MultiLayerNetwork"
    assert tnet._step_count == jnet._step_count == 3
    got, want = _both_out(jnet, tnet, x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for _ in range(2):
        jnet.fit(jdata.DataSet(x, y))
        tnet.fit(tdata.DataSet(x, y))
    got, want = _both_out(jnet, tnet, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for i in range(2):
        for k in ("W", "b"):
            np.testing.assert_allclose(
                _np(tnet.params[f"layer_{i}"][k]),
                np.asarray(jnet.params[f"layer_{i}"][k]), atol=1e-5)
    # written again by both from the same params and state: byte-equal
    out_j, out_t = tmp_path / "j2.zip", tmp_path / "t2.zip"
    jserde.write_model_upstream_format(jnet, out_j, save_updater=True)
    tserde.write_model_upstream_format(tnet, out_t, save_updater=True)
    mj, mt = _members(out_j), _members(out_t)
    assert set(mj) == set(mt)
    for name in ("coefficients.bin", "updaterState.bin"):
        a = tup.read_nd4j_array(mt[name])
        b = jup.read_nd4j_array(mj[name])
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_blobs_byte_equal_for_the_same_params_and_state(tmp_path):
    """Restored from one JAX zip, the port's updater built (the graft),
    both writers produce the same coefficients.bin and updaterState.bin
    bytes, and the same configuration.json."""
    jnet, x, y = _jax_trained_net()
    src = tmp_path / "src.zip"
    jserde.write_model_upstream_format(jnet, src, save_updater=True)
    tnet = tserde.load_model(src, device="cpu")
    tnet._build_optimizer()
    out = tmp_path / "port.zip"
    tserde.write_model_upstream_format(tnet, out, save_updater=True)
    mj, mt = _members(src), _members(out)
    assert mt["coefficients.bin"] == mj["coefficients.bin"]
    assert mt["updaterState.bin"] == mj["updaterState.bin"]
    assert json.loads(mt["configuration.json"]) == \
        json.loads(mj["configuration.json"])


def test_a_port_written_zip_loads_in_the_jax_package(tmp_path):
    tnet, x, y = _port_trained_net()
    path = tmp_path / "port.zip"
    tserde.write_model_upstream_format(tnet, path, save_updater=True)
    assert {"configuration.json", "coefficients.bin",
            "updaterState.bin"} <= set(_members(path))
    jnet = jserde.load_model(str(path))
    got, want = _both_out(jnet, tnet, x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    restored = tserde.restore_upstream_multi_layer_network(path,
                                                           device="cpu")
    np.testing.assert_array_equal(_np(restored.output(x)),
                                  _np(tnet.output(x)))
    for _ in range(2):
        tnet.fit(tdata.DataSet(x, y))
        restored.fit(tdata.DataSet(x, y))
        jnet.fit(jdata.DataSet(x, y))
    np.testing.assert_allclose(_np(restored.output(x)), _np(tnet.output(x)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(restored.output(x)),
                               np.asarray(jnet.output(x)), atol=1e-5)


def _lstm_confs():
    j = (jnn.NeuralNetConfiguration.builder().seed(3)
         .updater(jtrain.Adam(1e-2)).list()
         .layer(jnn.GravesLSTM(n_in=5, n_out=7, activation="tanh"))
         .layer(jnn.RnnOutputLayer(n_in=7, n_out=4, activation="softmax",
                                   loss="mcxent")).build())
    t = (tnn.NeuralNetConfiguration.builder().seed(3)
         .updater(ttrain.Adam(1e-2)).list()
         .layer(tnn.GravesLSTM(n_in=5, n_out=7, activation="tanh"))
         .layer(tnn.RnnOutputLayer(n_in=7, n_out=4, activation="softmax",
                                   loss="mcxent")).build())
    return j, t


def test_upstream_roundtrip_lstm_and_batchnorm(tmp_path):
    jconf, tconf = _lstm_confs()
    jnet = jnn.MultiLayerNetwork(jconf).init((None, 5))
    x = np.random.default_rng(6).normal(size=(3, 9, 5)).astype(np.float32)
    path = tmp_path / "lstm.zip"
    jserde.write_model_upstream_format(jnet, path)
    tnet = tserde.restore_upstream_multi_layer_network(path, device="cpu")
    got, want = _both_out(jnet, tnet, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    path2 = tmp_path / "lstm_port.zip"
    tserde.write_model_upstream_format(tnet, path2)
    assert _members(path2)["coefficients.bin"] == \
        _members(path)["coefficients.bin"]
    back = tserde.restore_upstream_multi_layer_network(path2, device="cpu")
    np.testing.assert_array_equal(_np(back.output(x)), got)

    rng = np.random.default_rng(6)
    xb = rng.normal(size=(16, 6)).astype(np.float32)
    yb = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    conf2 = (tnn.NeuralNetConfiguration.builder().seed(3)
             .updater(ttrain.Adam(1e-2)).list()
             .layer(tnn.DenseLayer(n_in=6, n_out=8, activation="relu"))
             .layer(tnn.BatchNormalization())
             .layer(tnn.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                    loss="mcxent")).build())
    net2 = tnn.MultiLayerNetwork(conf2).init(device="cpu")
    net2.fit(tdata.DataSet(xb, yb))   # move BN running stats off init
    path3 = tmp_path / "bn.zip"
    tserde.write_model_upstream_format(net2, path3)
    restored2 = tserde.restore_upstream_multi_layer_network(path3,
                                                            device="cpu")
    np.testing.assert_array_equal(_np(restored2.output(xb)),
                                  _np(net2.output(xb)))
    jnet2 = jup.restore_upstream_multi_layer_network(path3)
    np.testing.assert_allclose(np.asarray(jnet2.output(xb)),
                               _np(net2.output(xb)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mod", ["jax", "port"])
def test_upstream_reader_rejects_unknown_layer(tmp_path, mod):
    conf = {"confs": [{"layer": {
        "@class": _J + "Cropping2D", "nin": 1, "nout": 1}}]}
    path = tmp_path / "bad.zip"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf))
        zf.writestr("coefficients.bin", _nd4j_bytes_by_hand([0.0]))
    restore = jup.restore_upstream_multi_layer_network if mod == "jax" \
        else lambda p: tup.restore_upstream_multi_layer_network(
            p, device="cpu")
    with pytest.raises(ValueError, match="unsupported upstream layer"):
        restore(path)


@pytest.mark.parametrize("mod", ["jax", "port"])
def test_upstream_reader_rejects_length_mismatch(tmp_path, mod):
    path, _ = _dense_fixture_zip(tmp_path)
    with zipfile.ZipFile(path) as zf:
        conf = zf.read("configuration.json")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", conf)
        zf.writestr("coefficients.bin", _nd4j_bytes_by_hand([0.0] * 10))
    restore = jup.restore_upstream_multi_layer_network if mod == "jax" \
        else lambda p: tup.restore_upstream_multi_layer_network(
            p, device="cpu")
    with pytest.raises(ValueError, match="too short"):
        restore(path)


def test_upstream_adam_state_grafts_through_fit_scanned(tmp_path):
    tnet, x, y = _port_trained_net()
    path = tmp_path / "scan.zip"
    tserde.write_model_upstream_format(tnet, path, save_updater=True)
    restored = tserde.restore_upstream_multi_layer_network(path,
                                                           device="cpu")
    ds = tdata.DataSet(x, y)
    tnet.fit_scanned([ds, ds])
    restored.fit_scanned([ds, ds])
    np.testing.assert_allclose(_np(restored.output(x)), _np(tnet.output(x)),
                               rtol=1e-5, atol=1e-6)


def test_upstream_export_schedule_lr_and_callable_activation(tmp_path):
    from deeplearning4j_tpu_torch.train.schedules import StepSchedule
    conf = (tnn.NeuralNetConfiguration.builder()
            .updater(ttrain.Adam(StepSchedule("iteration", 0.01, 0.5, 10)))
            .list()
            .layer(tnn.DenseLayer(n_in=3, n_out=4, activation="relu"))
            .layer(tnn.OutputLayer(n_in=4, n_out=2, activation="softmax",
                                   loss="mcxent"))
            .build())
    net = tnn.MultiLayerNetwork(conf).init(device="cpu")
    path = tmp_path / "sched.zip"
    tserde.write_model_upstream_format(net, path)
    restored = tserde.restore_upstream_multi_layer_network(path,
                                                           device="cpu")
    j = json.loads(_members(path)["configuration.json"])
    assert j["confs"][0]["iUpdater"]["learningRate"] == pytest.approx(0.01)
    x = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(restored.output(x)), _np(net.output(x)),
                               rtol=1e-6)
    conf2 = (tnn.NeuralNetConfiguration.builder().list()
             .layer(tnn.DenseLayer(n_in=3, n_out=4, activation=torch.tanh))
             .layer(tnn.OutputLayer(n_in=4, n_out=2, activation="softmax",
                                    loss="mcxent"))
             .build())
    net2 = tnn.MultiLayerNetwork(conf2).init(device="cpu")
    with pytest.raises(ValueError, match="callable activation"):
        tserde.write_model_upstream_format(net2, tmp_path / "bad_act.zip")


def test_upstream_cg_zip_routed_away_from_mln_reader(tmp_path):
    path = tmp_path / "cg.zip"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(
            {"vertices": {}, "networkInputs": ["in"]}))
        zf.writestr("coefficients.bin", _nd4j_bytes_by_hand([0.0]))
    with pytest.raises(ValueError, match="ComputationGraph"):
        tserde.restore_upstream_multi_layer_network(path, device="cpu")


def _cg_pair():
    def build(nn, tr, **init):
        gb = (nn.NeuralNetConfiguration.builder().seed(5)
              .updater(tr.Adam(1e-3)).graph_builder()
              .add_inputs("in")
              .add_layer("a", nn.DenseLayer(n_in=6, n_out=8,
                                            activation="relu"), "in")
              .add_layer("b", nn.DenseLayer(n_in=6, n_out=8,
                                            activation="tanh"), "in")
              .add_vertex("sum", nn.ElementWiseVertex(op="add"), "a", "b")
              .add_vertex("cat", nn.MergeVertex(), "sum", "a")
              .add_layer("out", nn.OutputLayer(n_in=16, n_out=3,
                                               activation="softmax",
                                               loss="mcxent"), "cat")
              .set_outputs("out"))
        return nn.ComputationGraph(gb.build()).init([(6,)], **init)
    return build(jnn, jtrain), build(tnn, ttrain, device="cpu")


def test_upstream_cg_roundtrip_with_vertices_both_ways(tmp_path):
    jcg, _ = _cg_pair()
    x = np.random.default_rng(8).normal(size=(4, 6)).astype(np.float32)
    pj = tmp_path / "cg_jax.zip"
    jserde.write_computation_graph_upstream_format(jcg, pj)
    tcg = tserde.restore_upstream_computation_graph(pj, device="cpu")
    got, want = _both_out(jcg, tcg, x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    routed = tserde.ModelSerializer.restore_computation_graph(
        str(pj), device="cpu")
    np.testing.assert_array_equal(_np(routed.output(x)), got)
    pt = tmp_path / "cg_port.zip"
    tserde.write_computation_graph_upstream_format(tcg, pt)
    assert _members(pt)["coefficients.bin"] == \
        _members(pj)["coefficients.bin"]
    back = jserde.load_model(str(pt))
    np.testing.assert_allclose(np.asarray(back.output(x)), got, atol=1e-7)


def test_upstream_cg_fixture_matches_numpy_oracle(tmp_path):
    wa = np.random.default_rng(10).normal(size=(4, 5)).astype(np.float32)
    wb = np.random.default_rng(11).normal(size=(4, 5)).astype(np.float32)
    wo = np.random.default_rng(12).normal(size=(5, 2)).astype(np.float32)
    za, zb, zo = (np.zeros(5, np.float32), np.zeros(5, np.float32),
                  np.zeros(2, np.float32))
    conf = {
        "networkInputs": ["in"], "networkOutputs": ["out"],
        "inputTypes": [{"@class": "org.deeplearning4j.nn.conf.inputs."
                                  "InputType$InputTypeFeedForward",
                        "size": 4}],
        "vertices": {
            "a": {"@class": _GV + "LayerVertex", "layerConf": {"layer": {
                "@class": _J + "DenseLayer", "nin": 4, "nout": 5,
                "hasBias": True,
                "activationFn": {"@class": _ACT + "ActivationTanH"}}}},
            "b": {"@class": _GV + "LayerVertex", "layerConf": {"layer": {
                "@class": _J + "DenseLayer", "nin": 4, "nout": 5,
                "hasBias": True,
                "activationFn": {"@class": _ACT + "ActivationReLU"}}}},
            "sum": {"@class": _GV + "ElementWiseVertex", "op": "Add"},
            "out": {"@class": _GV + "LayerVertex", "layerConf": {"layer": {
                "@class": _J + "OutputLayer", "nin": 5, "nout": 2,
                "hasBias": True,
                "activationFn": {"@class": _ACT + "ActivationSoftmax"},
                "lossFn": {"@class": _LOSS + "LossMCXENT"}}}},
        },
        "vertexInputs": {"a": ["in"], "b": ["in"], "sum": ["a", "b"],
                         "out": ["sum"]},
    }
    flat = np.concatenate([wa.ravel(order="f"), za, wb.ravel(order="f"), zb,
                           wo.ravel(order="f"), zo])
    path = tmp_path / "cg_fix.zip"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(conf))
        zf.writestr("coefficients.bin", _nd4j_bytes_by_hand(flat.tolist()))
    cg = tserde.load_model(path, device="cpu")
    x = np.random.default_rng(13).normal(size=(3, 4)).astype(np.float32)
    got = _np(cg.output(x))
    logits = (np.tanh(x @ wa) + np.maximum(x @ wb, 0.0)) @ wo
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    np.testing.assert_allclose(got, e / e.sum(axis=1, keepdims=True),
                               rtol=1e-5, atol=1e-6)
    jcg = jup.restore_upstream_computation_graph(path)
    np.testing.assert_allclose(got, np.asarray(jcg.output(x)), atol=1e-6)


def test_upstream_iteration_count_roundtrip(tmp_path):
    net, x, y = _port_trained_net()
    assert net._step_count == 3
    path = tmp_path / "count.zip"
    tserde.write_model_upstream_format(net, path, save_updater=True)
    assert tserde.restore_upstream_multi_layer_network(
        path, device="cpu")._step_count == 3
    assert jup.restore_upstream_multi_layer_network(path)._step_count == 3


def test_upstream_cg_updater_state_training_resume(tmp_path):
    """A JAX CG trained 3 steps, written with its Adam state: the port
    resumes it and the next 2 steps match the JAX graph's at 1e-5."""
    def build(nn, tr, **init):
        gb = (nn.NeuralNetConfiguration.builder().seed(4)
              .updater(tr.Adam(1e-2)).graph_builder()
              .add_inputs("in")
              .add_layer("d", nn.DenseLayer(n_in=5, n_out=8,
                                            activation="tanh"), "in")
              .add_layer("out", nn.OutputLayer(n_in=8, n_out=3,
                                               activation="softmax",
                                               loss="mcxent"), "d")
              .set_outputs("out"))
        return nn.ComputationGraph(gb.build()).init([(5,)], **init)
    jcg = build(jnn, jtrain)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(24, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 24)]
    for _ in range(3):
        jcg.fit(jdata.DataSet(x, y))
    path = tmp_path / "cg_upd.zip"
    jserde.write_computation_graph_upstream_format(jcg, path,
                                                   save_updater=True)
    assert "updaterState.bin" in _members(path)
    tcg = tserde.restore_upstream_computation_graph(path, device="cpu")
    got, want = _both_out(jcg, tcg, x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for _ in range(2):
        jcg.fit(jdata.DataSet(x, y))
        tcg.fit(tdata.DataSet(x, y))
    got, want = _both_out(jcg, tcg, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the port's own CG round trip resumes on its own trajectory
    pt = tmp_path / "cg_port.zip"
    tserde.write_computation_graph_upstream_format(tcg, pt,
                                                   save_updater=True)
    again = tserde.load_model(pt, device="cpu")
    for _ in range(2):
        tcg.fit(tdata.DataSet(x, y))
        again.fit(tdata.DataSet(x, y))
    np.testing.assert_allclose(_np(again.output(x)), _np(tcg.output(x)),
                               rtol=1e-5, atol=1e-6)


def test_upstream_normalizer_bin_both_ways(tmp_path):
    rng = np.random.default_rng(17)
    x = (rng.normal(size=(64, 6)) * 3.0 + 1.5).astype(np.float32)
    y = rng.normal(size=(64, 3)).astype(np.float32)
    jds, tds = jdata.DataSet(x, y), tdata.DataSet(x, y)
    from deeplearning4j_tpu.data.normalizers import (
        NormalizerMinMaxScaler as JMM, NormalizerStandardize as JStd)
    from deeplearning4j_tpu_torch.data.normalizers import (
        NormalizerMinMaxScaler, NormalizerStandardize)
    jstd = JStd()
    jstd.fit_label(True)
    jstd.fit([jds])
    raw = jup.write_normalizer_upstream_format(jstd)
    back = tup.read_normalizer_upstream_format(raw)
    assert isinstance(back, NormalizerStandardize) and back.fit_labels
    np.testing.assert_allclose(_np(back.transform(tds).features),
                               np.asarray(jstd.transform(jds).features),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(back.transform(tds).labels),
                               np.asarray(jstd.transform(jds).labels),
                               rtol=1e-5, atol=1e-5)
    assert tup.write_normalizer_upstream_format(back) == raw

    mm = NormalizerMinMaxScaler(min_range=-1.0, max_range=1.0)
    mm.fit([tds])
    raw2 = tup.write_normalizer_upstream_format(mm)
    jback = jup.read_normalizer_upstream_format(raw2)
    assert isinstance(jback, JMM)
    np.testing.assert_allclose(np.asarray(jback.transform(jds).features),
                               _np(mm.transform(tds).features),
                               rtol=1e-5, atol=1e-5)
    assert jup.write_normalizer_upstream_format(jback) == raw2
    back2 = tup.read_normalizer_upstream_format(raw2)
    np.testing.assert_allclose(
        _np(back2.revert_features(back2.transform(tds).features)), x,
        rtol=1e-4, atol=1e-4)

    # it rides the model zip; restore attaches it, restore_normalizer
    # reads it
    net, xx, yy = _port_trained_net()
    path = tmp_path / "with_norm.zip"
    tserde.write_model_upstream_format(net, path, normalizer=back)
    restored = tserde.restore_upstream_multi_layer_network(path,
                                                           device="cpu")
    assert restored.normalizer is not None
    np.testing.assert_allclose(
        _np(restored.normalizer.transform(tds).features),
        _np(back.transform(tds).features), rtol=1e-5, atol=1e-5)
    assert tserde.restore_normalizer(str(path)) is not None
    assert jserde.ModelSerializer.restore_normalizer(str(path)) is not None


def test_config_level_upstream_json_roundtrip():
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.graph import \
        ComputationGraphConfiguration
    conf = (tnn.NeuralNetConfiguration.builder().seed(21)
            .updater(ttrain.Adam(2e-3)).list()
            .layer(tnn.DenseLayer(n_in=5, n_out=7, activation="relu"))
            .layer(tnn.OutputLayer(n_in=7, n_out=2, activation="softmax",
                                   loss="mcxent"))
            .build())
    j = conf.to_upstream_json()
    assert "org.deeplearning4j.nn.conf.layers.DenseLayer" in j
    jconf = (jnn.NeuralNetConfiguration.builder().seed(21)
             .updater(jtrain.Adam(2e-3)).list()
             .layer(jnn.DenseLayer(n_in=5, n_out=7, activation="relu"))
             .layer(jnn.OutputLayer(n_in=7, n_out=2, activation="softmax",
                                    loss="mcxent"))
             .build())
    assert json.loads(j) == json.loads(jconf.to_upstream_json())
    conf2 = MultiLayerConfiguration.from_upstream_json(j)
    net = tnn.MultiLayerNetwork(conf2).init(device="cpu")
    assert net.layers[0].n_in == 5 and net.layers[1].n_out == 2
    assert type(conf2.globals_.updater).__name__ == "Adam"
    assert abs(conf2.globals_.updater.learning_rate - 2e-3) < 1e-9
    assert MultiLayerConfiguration.fromJson(j).globals_.seed == 21

    def gconf(nn, tr):
        return (nn.NeuralNetConfiguration.builder().updater(tr.Adam(1e-3))
                .graph_builder()
                .add_inputs("in")
                .add_layer("a", nn.DenseLayer(n_in=4, n_out=6,
                                              activation="tanh"), "in")
                .add_layer("b", nn.DenseLayer(n_in=4, n_out=6,
                                              activation="relu"), "in")
                .add_vertex("m", nn.MergeVertex(), "a", "b")
                .add_layer("out", nn.OutputLayer(n_in=12, n_out=3,
                                                 activation="softmax",
                                                 loss="mcxent"), "m")
                .set_outputs("out").build())
    g = gconf(tnn, ttrain)
    gj = g.to_upstream_json()
    assert json.loads(gj) == json.loads(gconf(jnn, jtrain)
                                        .to_upstream_json())
    g2 = ComputationGraphConfiguration.from_upstream_json(gj)
    cg = tnn.ComputationGraph(g2).init([(4,)], device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 4)).astype(np.float32)
    assert tuple(cg.output(x).shape) == (2, 3)
    assert g2.topo_order == g.topo_order


def test_config_json_input_types_and_seed_roundtrip():
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.graph import \
        ComputationGraphConfiguration
    rnn_conf = (tnn.NeuralNetConfiguration.builder().seed(33).list()
                .layer(tnn.LSTM(n_in=3, n_out=5, activation="tanh"))
                .layer(tnn.RnnOutputLayer(n_in=5, n_out=2,
                                          activation="softmax",
                                          loss="mcxent"))
                .set_input_type(tnn.InputType.recurrent(3, timesteps=7))
                .build())
    back = MultiLayerConfiguration.from_upstream_json(
        rnn_conf.to_upstream_json())
    assert back.input_type == ("rnn", (7, 3))
    assert back.globals_.seed == 33
    c3d = (tnn.NeuralNetConfiguration.builder().list()
           .layer(tnn.DenseLayer(n_in=8, n_out=4, activation="relu"))
           .layer(tnn.OutputLayer(n_in=4, n_out=2, activation="softmax",
                                  loss="mcxent"))
           .set_input_type(tnn.InputType.convolutional_3d(2, 3, 3, 1))
           .build())
    j = c3d.to_upstream_json()
    assert "InputTypeConvolutional3D" in j
    assert MultiLayerConfiguration.from_upstream_json(j).input_type == \
        ("cnn3d", (2, 3, 3, 1))
    gb = (tnn.NeuralNetConfiguration.builder().seed(99).graph_builder()
          .add_inputs("in")
          .add_layer("d", tnn.DenseLayer(n_in=4, n_out=6,
                                         activation="relu"), "in")
          .add_layer("out", tnn.OutputLayer(n_in=6, n_out=2,
                                            activation="softmax",
                                            loss="mcxent"), "d")
          .set_outputs("out")
          .set_input_types(tnn.InputType.feed_forward(4)))
    back_g = ComputationGraphConfiguration.from_upstream_json(
        gb.build().to_upstream_json())
    assert back_g.globals_.seed == 99
    assert back_g.input_types == [("ff", (4,))]
    cg = tnn.ComputationGraph(back_g).init(device="cpu")
    x = np.random.default_rng(1).normal(size=(2, 4)).astype(np.float32)
    assert tuple(cg.output(x).shape) == (2, 2)


def test_mln_to_json_matches_the_reference():
    """``MultiLayerConfiguration.to_json``: the same classes and fields as
    the JAX package's, dtypes by name (the port's extra layer knobs,
    such as ``fused``, are its own)."""
    t = json.loads(_lstm_confs()[1].to_json())
    j = json.loads(_lstm_confs()[0].to_json())
    assert t["globals"]["param_dtype"] == {"__dtype__": "float32"}
    assert [l["__class__"] for l in t["layers"]] == \
        [l["__class__"] for l in j["layers"]]
    for lt, lj in zip(t["layers"], j["layers"]):
        shared = set(lt) & set(lj) - {"dtype", "weight_init", "updater"}
        assert {k: lt[k] for k in shared} == {k: lj[k] for k in shared}
