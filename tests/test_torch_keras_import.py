"""The port's Keras importer (``deeplearning4j_tpu_torch/import_/keras.py``,
on its own HDF5 reader) against the JAX package's (h5py), on one file:
each Keras test of ``tests/test_native_and_imports.py``, run through
both importers, the outputs held to each other and to Keras's ``predict``
at the reference test's own tolerance (1e-5 for dense heads, 1e-4 for
conv, recurrent and 3-D stacks); the guards raise alike (the corpus
families and the ResNet50 file are ``test_torch_keras_corpus.py``).
TensorFlow writes the oracle files."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
pytest.importorskip("h5py")

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.import_ import keras as jk  # noqa: E402
from deeplearning4j_tpu_torch.import_ import keras as tk  # noqa: E402

torch.set_num_threads(2)
# TensorFlow only writes the oracle files: two threads, as torch's (a
# process that already ran TF keeps its own setting)
with contextlib.suppress(RuntimeError):
    tf.config.threading.set_intra_op_parallelism_threads(2)
    tf.config.threading.set_inter_op_parallelism_threads(2)
keras = tf.keras


def _both(path, how="sequential", **kw):
    """(JAX net, port net) imported from ``path``."""
    fn = {"sequential": "import_keras_sequential",
          "model": "import_keras_model"}[how]
    return (getattr(jk, fn)(str(path), **kw),
            getattr(tk, fn)(str(path), device="cpu", **kw))


def _out(net, *xs):
    out = net.output(*xs)
    if isinstance(out, list):
        out = out[0]
    return out.detach().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)


def _check(m, path, x, atol, how="sequential"):
    """Save ``m`` to ``path``, import it with both importers, and hold
    the port to the JAX net and to Keras at ``atol``. Returns the nets."""
    want = m.predict(x, verbose=0)
    m.save(path)
    jnet, tnet = _both(path, how)
    got_j, got_t = _out(jnet, x), _out(tnet, x)
    np.testing.assert_allclose(got_t, got_j, atol=atol)
    np.testing.assert_allclose(got_t, want, atol=atol)
    return jnet, tnet


@pytest.fixture(autouse=True)
def _registries():
    yield
    jk.clear_custom_layers()
    tk.clear_custom_layers()


def test_keras_import_sequential(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((8,)),
        keras.layers.Dense(16, activation="relu"),
        keras.layers.Dense(4, activation="softmax"),
    ])
    x = np.random.default_rng(0).random((3, 8)).astype(np.float32)
    _check(m, tmp_path / "m.h5", x, 1e-5)


def test_keras_lambda_layer_registry(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((8,)),
        keras.layers.Dense(16, activation="relu", name="d0"),
        keras.layers.Lambda(lambda t: t * 2.0 + 1.0, name="scale_shift"),
        keras.layers.Dense(4, activation="softmax", name="d1"),
    ])
    x = np.random.default_rng(1).random((3, 8)).astype(np.float32)
    want = m.predict(x, verbose=0)
    p = tmp_path / "lam.h5"
    m.save(p)
    for mod in (jk, tk):
        with pytest.raises(NotImplementedError, match="register_lambda"):
            mod.import_keras_sequential(str(p), **(
                {"device": "cpu"} if mod is tk else {}))
    jk.register_lambda("scale_shift", lambda t: t * 2.0 + 1.0)
    tk.register_lambda("scale_shift", lambda t: t * 2.0 + 1.0)
    jnet, tnet = _both(p)
    np.testing.assert_allclose(_out(tnet, x), _out(jnet, x), atol=1e-5)
    np.testing.assert_allclose(_out(tnet, x), want, atol=1e-5)


def test_keras_custom_layer_registry(tmp_path):
    """register_custom_layer supplies a mapping for an unmapped keras
    class (the reference test's ThresholdedReLU is gone from Keras 3:
    Rescaling stands in); unregistered, both raise."""
    m = keras.Sequential([
        keras.layers.Input((6,)),
        keras.layers.Dense(8, activation="tanh", name="d0"),
        keras.layers.Rescaling(scale=0.5, offset=0.25, name="resc"),
        keras.layers.Dense(3, name="d1"),
    ])
    x = np.random.default_rng(2).standard_normal((4, 6)).astype(np.float32)
    want = m.predict(x, verbose=0)
    p = tmp_path / "cust.h5"
    m.save(p)
    with pytest.raises(NotImplementedError, match="register_custom_layer"):
        jk.import_keras_sequential(str(p))
    with pytest.raises(NotImplementedError, match="register_custom_layer"):
        tk.import_keras_sequential(str(p), device="cpu")

    def affine(kcfg, mod):
        c = kcfg["config"]
        return mod.KerasLambdaLayer(
            fn=lambda t: t * c["scale"] + c["offset"])
    jk.register_custom_layer("Rescaling", lambda kcfg: affine(kcfg, jk))
    tk.register_custom_layer("Rescaling", lambda kcfg: affine(kcfg, tk))
    jnet, tnet = _both(p)
    np.testing.assert_allclose(_out(tnet, x), _out(jnet, x), atol=1e-5)
    np.testing.assert_allclose(_out(tnet, x), want, atol=1e-5)


def _scale_layer_model(tmp_path):
    @keras.utils.register_keras_serializable("test")
    class ScaleLayer(keras.layers.Layer):
        def build(self, input_shape):
            self.scale = self.add_weight(
                name="scale", shape=(input_shape[-1],),
                initializer="random_normal")

        def call(self, t):
            return t * self.scale

    m = keras.Sequential([
        keras.layers.Input((5,)),
        ScaleLayer(name="sc"),
        keras.layers.Dense(3, name="d0"),
    ])
    x = np.random.default_rng(4).standard_normal((2, 5)).astype(np.float32)
    want = m.predict(x, verbose=0)
    p = tmp_path / "scale.h5"
    m.save(p)
    return p, x, want


def test_keras_custom_layer_with_weights_needs_assign_hook(tmp_path):
    """A weighted custom layer without assign_weights raises in both; with
    the hook (a JAX one, a torch one) the weights flow through alike."""
    p, x, want = _scale_layer_model(tmp_path)

    class ScaleJax(jk.KerasLambdaLayer):
        def init(self, key, input_shape):
            return ({"scale": jnp.ones(input_shape[-1])}, {},
                    tuple(input_shape))

        def apply(self, params, state, t, ctx):
            return t * params["scale"], state

        def has_params(self):
            return True

    class ScaleTorch(tk.KerasLambdaLayer):
        def init(self, gen, input_shape):
            return ({"scale": torch.ones(input_shape[-1])}, {},
                    tuple(input_shape))

        def apply(self, params, state, t, ctx):
            return t * params["scale"], state

        def has_params(self):
            return True

    with pytest.raises(NotImplementedError, match="register_custom_layer"):
        tk.import_keras_sequential(str(p), device="cpu")
    jk.register_custom_layer("test>ScaleLayer", lambda kcfg: ScaleJax())
    tk.register_custom_layer("test>ScaleLayer", lambda kcfg: ScaleTorch())
    for fn in (lambda: jk.import_keras_sequential(str(p)),
               lambda: tk.import_keras_sequential(str(p), device="cpu")):
        with pytest.raises(ValueError, match="assign_weights"):
            fn()
    jk.register_custom_layer(
        "test>ScaleLayer", lambda kcfg: ScaleJax(),
        assign_weights=lambda layer, pd, sd, ws:
            pd.__setitem__("scale", jnp.asarray(ws[0])))
    tk.register_custom_layer(
        "test>ScaleLayer", lambda kcfg: ScaleTorch(),
        assign_weights=lambda layer, pd, sd, ws:
            pd.__setitem__("scale", torch.from_numpy(np.array(ws[0]))))
    jnet, tnet = _both(p)
    np.testing.assert_allclose(_out(tnet, x), _out(jnet, x), atol=1e-5)
    np.testing.assert_allclose(_out(tnet, x), want, atol=1e-5)


def test_keras_import_functional_merges(tmp_path):
    inp = keras.layers.Input((8,), name="in0")
    a = keras.layers.Dense(16, activation="relu", name="da")(inp)
    b = keras.layers.Dense(16, activation="tanh", name="db")(inp)
    cat = keras.layers.Concatenate(name="cat")([a, b])
    add = keras.layers.Add(name="add")([a, b])
    d2 = keras.layers.Dense(16, name="dd")(cat)
    mx = keras.layers.Maximum(name="mx")([d2, add])
    out = keras.layers.Dense(4, activation="softmax", name="out")(mx)
    x = np.random.default_rng(0).random((5, 8)).astype(np.float32)
    _check(keras.Model(inp, out), tmp_path / "fm.h5", x, 1e-5, how="model")


def test_keras_import_cnn_layers(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((16, 16, 3)),
        keras.layers.Conv2D(8, 3, padding="same", activation="relu"),
        keras.layers.DepthwiseConv2D(3, padding="same"),
        keras.layers.SeparableConv2D(8, 3, padding="same"),
        keras.layers.BatchNormalization(),
        keras.layers.MaxPooling2D(2),
        keras.layers.Conv2DTranspose(4, 3, strides=2, padding="same"),
        keras.layers.Flatten(),
        keras.layers.Dense(5, activation="softmax"),
    ])
    x = np.random.default_rng(1).random((2, 16, 16, 3)).astype(np.float32)
    _check(m, tmp_path / "cnn.h5", x, 1e-4)


@pytest.mark.parametrize("name", ["gru_ra", "gru", "srnn", "lstm"])
def test_keras_import_rnn_layers(tmp_path, name):
    make = {"gru_ra": lambda: keras.layers.GRU(6, reset_after=True),
            "gru": lambda: keras.layers.GRU(6, reset_after=False),
            "srnn": lambda: keras.layers.SimpleRNN(6),
            "lstm": lambda: keras.layers.LSTM(6)}[name]
    m = keras.Sequential([
        keras.layers.Input((7, 4)),
        make(),
        keras.layers.Dense(3, activation="softmax"),
    ])
    x = np.random.default_rng(2).random((2, 7, 4)).astype(np.float32)
    _check(m, tmp_path / f"{name}.h5", x, 1e-4)


@pytest.mark.parametrize("i,ret_seq,mode", [
    (0, True, "concat"), (1, False, "concat"), (2, False, "sum"),
    (3, True, "ave")])
def test_keras_import_bidirectional(tmp_path, i, ret_seq, mode):
    x = np.random.default_rng(5).random((2, 6, 4)).astype(np.float32)
    m = keras.Sequential([
        keras.layers.Input((6, 4)),
        keras.layers.Bidirectional(keras.layers.LSTM(
            5, return_sequences=ret_seq), merge_mode=mode),
        keras.layers.Dense(3),
    ])
    _check(m, tmp_path / f"bi{i}.h5", x, 1e-4)


def test_keras_import_reshape_permute_repeat_timedistributed(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((6,)),
        keras.layers.Dense(8, activation="relu"),
        keras.layers.RepeatVector(4),          # (B, 4, 8)
        keras.layers.TimeDistributed(keras.layers.Dense(5,
                                                        activation="tanh")),
        keras.layers.Permute((2, 1)),          # (B, 5, 4)
        keras.layers.Reshape((20,)),
        keras.layers.Dense(3, activation="softmax"),
    ])
    x = np.random.default_rng(0).standard_normal((3, 6)).astype(np.float32)
    _check(m, tmp_path / "structural.h5", x, 1e-5)


def test_keras_import_compiled_model_is_trainable(tmp_path):
    """The compiled loss makes the trailing Dense an OutputLayer in both;
    one fit step from the same weights and data gives the same params;
    uncompiled saves stay inference-only unless loss= is passed."""
    from deeplearning4j_tpu.data import DataSet as JDataSet
    from deeplearning4j_tpu.nn import OutputLayer as JOut
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import OutputLayer
    m = keras.Sequential([
        keras.layers.Input((5,)),
        keras.layers.Dense(8, activation="relu"),
        keras.layers.Dense(3, activation="softmax"),
    ])
    m.compile(loss="categorical_crossentropy", optimizer="adam")
    rng = np.random.default_rng(0)
    X = rng.standard_normal((32, 5)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    jnet, tnet = _check(m, tmp_path / "compiled.h5", X, 1e-5)
    assert isinstance(jnet.layers[-1], JOut)
    assert isinstance(tnet.layers[-1], OutputLayer)
    s0 = tnet.score(DataSet(X, Y))
    np.testing.assert_allclose(s0, jnet.score(JDataSet(X, Y)), atol=1e-5)
    jnet.fit(JDataSet(X, Y))
    tnet.fit(DataSet(X, Y))
    for key in ("W", "b"):
        np.testing.assert_allclose(
            tnet.params["layer_1"][key].detach().numpy(),
            np.asarray(jnet.params["layer_1"][key]), atol=1e-5)
    tnet.fit(DataSet(X, Y), epochs=15)
    assert tnet.score(DataSet(X, Y)) < s0

    m2 = keras.Sequential([keras.layers.Input((5,)),
                           keras.layers.Dense(3, activation="softmax")])
    p2 = str(tmp_path / "uncompiled.h5")
    m2.save(p2)
    net2 = tk.import_keras_sequential(p2, device="cpu")
    assert not isinstance(net2.layers[-1], OutputLayer)   # inference-only
    assert not isinstance(jk.import_keras_sequential(p2).layers[-1], JOut)
    net3 = tk.import_keras_sequential(p2, loss="mcxent", device="cpu")
    assert isinstance(net3.layers[-1], OutputLayer)


def test_keras_import_dense_plus_activation_head_and_guards(tmp_path):
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import OutputLayer
    m = keras.Sequential([
        keras.layers.Input((5,)),
        keras.layers.Dense(8, activation="relu"),
        keras.layers.Dense(3),
        keras.layers.Activation("softmax"),
    ])
    m.compile(loss="categorical_crossentropy", optimizer="adam")
    rng = np.random.default_rng(0)
    X = rng.standard_normal((16, 5)).astype(np.float32)
    jnet, tnet = _check(m, tmp_path / "densact.h5", X, 1e-5)
    assert isinstance(tnet.layers[-1], OutputLayer)
    assert str(tnet.layers[-1].activation) == "softmax"
    assert len(tnet.layers) == len(jnet.layers)
    Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    tnet.fit(DataSet(X, Y), epochs=2)

    # explicit loss on an unconvertible head raises in both
    m2 = keras.Sequential([keras.layers.Input((4,)),
                           keras.layers.Dense(6, activation="relu"),
                           keras.layers.Dropout(0.5)])
    p2 = str(tmp_path / "noend.h5")
    m2.save(p2)
    with pytest.raises(ValueError):
        jk.import_keras_sequential(p2, loss="mse")
    with pytest.raises(ValueError):
        tk.import_keras_sequential(p2, loss="mse", device="cpu")
    # the wrong entry point raises in both
    for fn in (jk.import_keras_model,
               lambda p: tk.import_keras_model(p, device="cpu")):
        with pytest.raises(ValueError, match="import_keras_sequential"):
            fn(p2)

    m3 = keras.Sequential([
        keras.layers.Input((3, 8, 8, 2)),
        keras.layers.TimeDistributed(keras.layers.Conv2D(4, 3)),
    ])
    p3 = str(tmp_path / "tdconv.h5")
    m3.save(p3)
    jnet3, tnet3 = _both(p3)
    z = np.zeros((1, 3, 8, 8, 2), np.float32)
    assert tnet3.output(z).shape[1] == 3
    np.testing.assert_allclose(_out(tnet3, z), _out(jnet3, z), atol=1e-5)


def test_keras_import_conv3d_family(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((6, 6, 6, 2)),
        keras.layers.Conv3D(4, 3, padding="same", activation="relu"),
        keras.layers.MaxPooling3D(2),
        keras.layers.Conv3DTranspose(3, 3, strides=2, padding="same"),
        keras.layers.Flatten(),
        keras.layers.Dense(5, activation="softmax"),
    ])
    x = np.random.default_rng(11).random((2, 6, 6, 6, 2)).astype(np.float32)
    _check(m, tmp_path / "c3d.h5", x, 1e-4)


@pytest.mark.parametrize("ret_seq", [False, True])
def test_keras_import_convlstm2d(tmp_path, ret_seq):
    x = np.random.default_rng(12).random((2, 4, 6, 6, 3)).astype(np.float32)
    m = keras.Sequential([
        keras.layers.Input((4, 6, 6, 3)),
        keras.layers.ConvLSTM2D(4, 3, padding="same",
                                return_sequences=ret_seq),
        keras.layers.Flatten(), keras.layers.Dense(3)])
    _check(m, tmp_path / f"clstm{int(ret_seq)}.h5", x, 1e-4)


def test_keras_import_timedistributed_conv(tmp_path):
    m = keras.Sequential([
        keras.layers.Input((3, 8, 8, 2)),
        keras.layers.TimeDistributed(
            keras.layers.Conv2D(4, 3, padding="same", activation="relu")),
        keras.layers.TimeDistributed(keras.layers.MaxPooling2D(2)),
        keras.layers.Flatten(),
        keras.layers.Dense(5, activation="softmax"),
    ])
    x = np.random.default_rng(3).random((2, 3, 8, 8, 2)).astype(np.float32)
    _check(m, tmp_path / "tdconv.h5", x, 1e-4)
