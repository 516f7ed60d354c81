"""The port stands alone: no module of ``deeplearning4j_tpu_torch`` and
not ``chip_smoke.py`` imports ``jax`` or anything of ``deeplearning4j_tpu``
(importing even a jax-free module of the JAX package runs its
``__init__``, which loads jax), and importing the port leaves ``jax``
out of ``sys.modules``."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deeplearning4j_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_modules_to_check():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"zoo/transformer.py", "kernels/paged_attention.py",
            "kernels/flash_attention.py", "serving/kvcache.py",
            "serving/engine.py", "serving/scheduler.py",
            "kernels/fused_ops.py", "nn/activations.py", "nn/weights.py",
            "nn/layers/base.py", "train/updaters.py", "nn/conf.py",
            "nn/vertices.py", "nn/graph.py", "nn/preprocessors.py",
            "nn/losses.py", "nn/layers/core.py", "nn/layers/conv.py",
            "nn/layers/norm.py", "nn/computation_graph.py",
            "data/dataset.py", "zoo/base.py", "zoo/resnet.py",
            "kernels/fused_lstm.py", "nn/layers/recurrent.py",
            "nn/multi_layer_network.py", "data/iterators.py",
            "zoo/cnn_simple.py", "train/schedules.py",
            "train/constraints.py", "train/anomaly.py", "nn/weightnoise.py",
            "nn/listeners.py", "eval/classification.py",
            "eval/regression.py", "eval/roc.py", "eval/calibration.py",
            "data/normalizers.py", "serde/model_serializer.py",
            "serving/workloads.py", "obs/registry.py", "obs/spans.py",
            "obs/reqtrace.py", "obs/slo.py", "obs/memory.py",
            "obs/fidelity.py", "obs/compiles.py", "kernels/autotune.py",
            "serving/quant.py", "serving/spec.py", "serving/tune.py",
            "nlp/bert_iterator.py", "serving/adapter.py",
            "parallel/wrapper.py", "ndarray/factory.py",
            "ndarray/indexing.py", "ndarray/random.py",
            "ndarray/workspace.py", "utils/native.py",
            "data/async_iter.py", "nn/early_stopping.py", "nn/_remat.py",
            "serde/jax_pickles.py", "nn/layers/attention.py",
            "nn/layers/objdetect.py", "nn/layers/wrappers.py",
            "nn/layers/capsule.py", "nn/layers/variational.py",
            "nn/transfer.py", "zoo/detection.py", "zoo/inception.py",
            "zoo/nasnet.py", "zoo/unet.py",
            "autodiff/onnx_import.py", "import_/__init__.py",
            "import_/_hdf5.py", "import_/keras.py",
            "serde/upstream_dl4j.py", "nn/layers/samediff_layer.py",
            "_dist.py", "parallel/mesh.py", "parallel/tp.py",
            "parallel/param_avg.py", "parallel/ring_attention.py",
            "parallel/pipeline.py", "parallel/pipeline_generic.py"} <= names


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import deeplearning4j_tpu_torch\n"
            "import deeplearning4j_tpu_torch.serving\n"
            "import deeplearning4j_tpu_torch.kernels.flash_attention\n"
            "import deeplearning4j_tpu_torch.kernels.paged_attention\n"
            "import deeplearning4j_tpu_torch.zoo.transformer\n"
            "import deeplearning4j_tpu_torch.kernels.fused_ops\n"
            "import deeplearning4j_tpu_torch.nn\n"
            "import deeplearning4j_tpu_torch.train\n"
            "import deeplearning4j_tpu_torch.data\n"
            "import deeplearning4j_tpu_torch.zoo.resnet\n"
            "import deeplearning4j_tpu_torch.kernels.fused_lstm\n"
            "import deeplearning4j_tpu_torch.nn.multi_layer_network\n"
            "import deeplearning4j_tpu_torch.zoo.cnn_simple\n"
            "import deeplearning4j_tpu_torch.eval\n"
            "import deeplearning4j_tpu_torch.serde\n"
            "import deeplearning4j_tpu_torch.nn.listeners\n"
            "import deeplearning4j_tpu_torch.obs\n"
            "import deeplearning4j_tpu_torch.obs.fidelity\n"
            "import deeplearning4j_tpu_torch.obs.memory\n"
            "import deeplearning4j_tpu_torch.kernels.autotune\n"
            "import deeplearning4j_tpu_torch.serving.quant\n"
            "import deeplearning4j_tpu_torch.serving.spec\n"
            "import deeplearning4j_tpu_torch.serving.tune\n"
            "import deeplearning4j_tpu_torch.nlp\n"
            "import deeplearning4j_tpu_torch.parallel\n"
            "import deeplearning4j_tpu_torch.serving.adapter\n"
            "import deeplearning4j_tpu_torch.ndarray\n"
            "from deeplearning4j_tpu_torch import nd\n"
            "import deeplearning4j_tpu_torch.utils.native\n"
            "import deeplearning4j_tpu_torch.data.async_iter\n"
            "import deeplearning4j_tpu_torch.nn.early_stopping\n"
            "import deeplearning4j_tpu_torch.serde.jax_pickles\n"
            "import deeplearning4j_tpu_torch.nn.transfer\n"
            "import deeplearning4j_tpu_torch.nn.layers.attention\n"
            "import deeplearning4j_tpu_torch.nn.layers.objdetect\n"
            "import deeplearning4j_tpu_torch.nn.layers.wrappers\n"
            "import deeplearning4j_tpu_torch.nn.layers.capsule\n"
            "import deeplearning4j_tpu_torch.nn.layers.variational\n"
            "import deeplearning4j_tpu_torch.zoo.detection\n"
            "import deeplearning4j_tpu_torch.zoo.inception\n"
            "import deeplearning4j_tpu_torch.zoo.nasnet\n"
            "import deeplearning4j_tpu_torch.zoo.unet\n"
            "import deeplearning4j_tpu_torch.autodiff.onnx_import\n"
            "import deeplearning4j_tpu_torch.import_\n"
            "import deeplearning4j_tpu_torch.import_._hdf5\n"
            "import deeplearning4j_tpu_torch.serde.upstream_dl4j\n"
            "import deeplearning4j_tpu_torch.nn.layers.samediff_layer\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu', 'h5py', 'tensorflow')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_loading_a_jax_zip_loads_no_jax(tmp_path):
    """Zips the JAX package wrote (its ``conf.pkl`` pickles the reference
    configuration, importing which loads jax): ``load_model`` raises and
    names ``load_params``; ``load_params`` copies the arrays; a pickled
    updater state or normalizer that names anything but optax's state
    classes, the reference's normalizers, numpy and plain builtins is
    refused; a real one (written here by the JAX package) is read into the
    port's updater and normalizer — all without importing jax."""
    import io
    import pickle
    import zipfile

    import numpy as np
    bad, good = tmp_path / "bad.zip", tmp_path / "good.zip"
    jax_global = (b"\x80\x04\x95\x10\x00\x00\x00\x00\x00"
                  b"\x00\x00\x8c\x03jax\x94\x8c\x05Array\x94\x93\x94.")
    # the JAX package's own pickles, made in this process (which may
    # import it); the subprocess that reads them must not
    code = (
        "import pickle, jax, numpy as np\n"
        "from deeplearning4j_tpu.train import updaters as U\n"
        "from deeplearning4j_tpu.data import normalizers as N, DataSet\n"
        "p = {'layer_0': {'W': np.ones((3, 2), np.float32),\n"
        "                 'b': np.zeros(2, np.float32)}}\n"
        "st = U.build_optimizer(U.Adam(1e-2)).init(p)\n"
        "x = np.arange(12, dtype=np.float32).reshape(4, 3)\n"
        "nz = N.NormalizerStandardize().fit(DataSet(x, x))\n"
        "import sys\n"
        "sys.stdout.buffer.write(pickle.dumps((pickle.dumps(\n"
        "    jax.tree_util.tree_map(np.asarray, st)), pickle.dumps(nz))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, timeout=300,
                         env={**__import__("os").environ,
                              "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr.decode()
    updater_pkl, normalizer_pkl = pickle.loads(res.stdout)
    buf = io.BytesIO()
    np.savez(buf, **{"layer_0|W": np.ones((3, 2), np.float32),
                     "layer_0|b": np.zeros(2, np.float32)})
    params = buf.getvalue()
    buf = io.BytesIO()
    np.savez(buf)
    for path, upd, norm in ((bad, jax_global, jax_global),
                            (good, updater_pkl, normalizer_pkl)):
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("conf.pkl", jax_global)
            zf.writestr("normalizer.pkl", norm)
            zf.writestr("params.npz", params)
            zf.writestr("states.npz", buf.getvalue())
            zf.writestr("updater.pkl", upd)
    code = (
        "import sys, pickle\n"
        "import pytest\n"
        "from deeplearning4j_tpu_torch import nn, serde, train\n"
        "conf = (nn.NeuralNetConfiguration.builder()\n"
        "        .updater(train.Adam(1e-2)).list()\n"
        "        .layer(nn.OutputLayer(n_in=3, n_out=2)).build())\n"
        "net = nn.MultiLayerNetwork(conf).init((3,), device='cpu')\n"
        f"bad, good = {str(bad)!r}, {str(good)!r}\n"
        "for path in (bad, good):\n"
        "    with pytest.raises(ValueError, match='load_params'):\n"
        "        serde.load_model(path, device='cpu')\n"
        "with pytest.raises(pickle.UnpicklingError, match='jax.Array'):\n"
        "    serde.restore_normalizer(bad)\n"
        "with pytest.raises(pickle.UnpicklingError, match='jax.Array'):\n"
        "    serde.load_params(net, bad, updater=True)\n"
        "serde.load_params(net, good, updater=True)\n"
        "assert float(net.params['layer_0']['W'].sum()) == 6.0\n"
        "net._build_optimizer()\n"
        "assert int(net._opt_state[1][0]['count']) == 0\n"
        "nz = serde.restore_normalizer(good)\n"
        "assert type(nz).__name__ == 'NormalizerStandardize'\n"
        "assert type(nz).__module__.startswith('deeplearning4j_tpu_torch')\n"
        "assert abs(float(nz._f.mean[0]) - 4.5) < 1e-9\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu', 'optax')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


AUTODIFF = ("autodiff/__init__.py", "autodiff/samediff.py",
            "autodiff/sd_ops.py", "autodiff/tf_import.py",
            "autodiff/_protowire.py")
# the TF importer reads the wire format itself: no TensorFlow, no protobuf
AUTODIFF_FORBIDDEN = FORBIDDEN + ("tensorflow", "google", "optax", "onnx")
# (the interpreter may load the empty ``google`` namespace at start-up;
# a process is held to ``google.protobuf`` never being loaded)


@pytest.mark.parametrize("rel", AUTODIFF)
def test_autodiff_modules_import_no_jax_tf_or_protobuf(rel):
    path = PORT / rel
    assert path.exists(), rel
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in AUTODIFF_FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_samediff_and_the_importer_load_no_jax_or_tf(tmp_path):
    """Importing the autodiff package, reading a JAX-written SameDiff zip
    and importing a GraphDef's bytes leave jax, tensorflow and protobuf
    out of ``sys.modules``."""
    code = (
        "import numpy as np, jax\n"
        "from deeplearning4j_tpu.autodiff import SameDiff, TrainingConfig\n"
        "from deeplearning4j_tpu.train import Adam\n"
        "sd = SameDiff.create()\n"
        "x = sd.placeholder('x', (2, 3))\n"
        "w = sd.var('w', value=np.ones((3, 2), np.float32))\n"
        "sd.nn.relu(x.mmul(w)).rename('out')\n"
        "sd.set_training_config(TrainingConfig(updater=Adam(1e-2)))\n"
        f"sd.save({str(tmp_path / 'sd.zip')!r})\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**__import__("os").environ,
                              "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr
    # a GraphDef's bytes, written by hand: one Placeholder, one Relu
    def ln(field, data):
        return bytes([field << 3 | 2, len(data)]) + data
    ph = ln(1, b"x") + ln(2, b"Placeholder")
    relu = ln(1, b"y") + ln(2, b"Relu") + ln(3, b"x")
    (tmp_path / "g.pb").write_bytes(ln(1, ph) + ln(1, relu))
    code = (
        "import sys, numpy as np\n"
        "from deeplearning4j_tpu_torch.autodiff import (SameDiff,\n"
        "    import_frozen_graph)\n"
        f"sd = SameDiff.load({str(tmp_path / 'sd.zip')!r}, device='cpu')\n"
        "out = sd.eval('out', {'x': np.ones((2, 3), np.float32)})\n"
        "assert out.tolist() == [[3.0, 3.0], [3.0, 3.0]], out\n"
        "assert type(sd._training_config.updater).__module__.startswith(\n"
        "    'deeplearning4j_tpu_torch')\n"
        f"g, _ = import_frozen_graph({str(tmp_path / 'g.pb')!r},\n"
        "                           device='cpu')\n"
        "assert g.eval('y', {'x': np.asarray([-1.0, 2.0])}).tolist() == \\\n"
        "    [0.0, 2.0]\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu', 'optax', 'tensorflow')\n"
        "       or m.startswith('google.protobuf')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


IMPORTERS = ("import_/__init__.py", "import_/_hdf5.py", "import_/keras.py",
             "serde/upstream_dl4j.py", "serde/model_serializer.py",
             "nn/layers/samediff_layer.py", "zoo/base.py")
# the Keras importer reads HDF5 itself: no h5py, no TensorFlow
IMPORTERS_FORBIDDEN = FORBIDDEN + ("h5py", "tensorflow", "keras")


@pytest.mark.parametrize("path", [PORT / r for r in IMPORTERS]
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: p.name)
def test_importer_modules_import_no_h5py_or_tf(path):
    assert path.exists(), path
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in IMPORTERS_FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_keras_files_and_upstream_zips_import_without_h5py_or_tf(tmp_path):
    """The card's case: with ``h5py`` and ``tensorflow`` blocked in
    ``sys.modules``, a Keras .h5 (Sequential and Functional), a Keras 3
    .keras zip and upstream DL4J zips (MultiLayerNetwork and
    ComputationGraph) import and give the outputs Keras and the writing
    net gave; neither jax nor h5py nor tensorflow is loaded."""
    tf = pytest.importorskip("tensorflow")
    import numpy as np
    keras = tf.keras
    from deeplearning4j_tpu_torch import nn, serde, train
    x8 = np.random.default_rng(0).random((3, 8)).astype(np.float32)
    seq = keras.Sequential([keras.layers.Input((8,)),
                            keras.layers.Dense(6, activation="relu"),
                            keras.layers.Dense(3, activation="softmax")])
    inp = keras.layers.Input((8,))
    func = keras.Model(inp, keras.layers.Dense(3)(keras.layers.Add()(
        [keras.layers.Dense(4)(inp), keras.layers.Dense(4)(inp)])))
    cases = {}
    for name, m, how in (("seq.h5", seq, "sequential"),
                         ("func.h5", func, "model"),
                         ("seq.keras", seq, "sequential")):
        m.save(tmp_path / name)
        cases[name] = (how, m.predict(x8, verbose=0))
    mln = nn.MultiLayerNetwork(
        nn.NeuralNetConfiguration.builder().updater(train.Adam(1e-2)).list()
        .layer(nn.DenseLayer(n_in=8, n_out=5, activation="tanh"))
        .layer(nn.OutputLayer(n_in=5, n_out=3)).build()).init(device="cpu")
    cg = nn.ComputationGraph(
        nn.NeuralNetConfiguration.builder().graph_builder()
        .add_inputs("in")
        .add_layer("d", nn.DenseLayer(n_in=8, n_out=5), "in")
        .add_layer("out", nn.OutputLayer(n_in=5, n_out=3), "d")
        .set_outputs("out").build()).init([(8,)], device="cpu")
    for name, net in (("mln.zip", mln), ("cg.zip", cg)):
        serde.write_model_upstream_format(net, tmp_path / name,
                                          save_updater=True)
        cases[name] = ("zip", net.output(x8).detach().numpy())
    np.save(tmp_path / "x.npy", x8)
    np.save(tmp_path / "want.npy", np.stack([w for _, w in cases.values()]))
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['tensorflow'] = None\n"
        "import numpy as np\n"
        "from deeplearning4j_tpu_torch import serde\n"
        "from deeplearning4j_tpu_torch.import_ import (\n"
        "    import_keras_model, import_keras_sequential)\n"
        f"d = {str(tmp_path)!r}\n"
        "x = np.load(d + '/x.npy')\n"
        "want = np.load(d + '/want.npy')\n"
        f"for i, (name, how) in enumerate({[(n, h) for n, (h, _) in cases.items()]!r}):\n"
        "    p = d + '/' + name\n"
        "    net = {'sequential': import_keras_sequential,\n"
        "           'model': import_keras_model,\n"
        "           'zip': serde.load_model}[how](p, device='cpu')\n"
        "    got = net.output(x).detach().numpy()\n"
        "    assert np.allclose(got, want[i], atol=1e-5), name\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu') or (m.split('.')[0] in "
        "('h5py', 'tensorflow') and sys.modules[m] is not None)]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
