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
            "parallel/wrapper.py"} <= names


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
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_loading_a_jax_zip_loads_no_jax(tmp_path):
    """A zip the JAX package wrote (its ``conf.pkl`` pickles the reference
    configuration, importing which loads jax): ``load_model`` raises and
    names ``load_params``, ``restore_normalizer`` refuses the pickled
    normalizer, and ``load_params`` copies its arrays, all without
    unpickling either or importing jax."""
    import io
    import zipfile

    import numpy as np
    path = tmp_path / "jax.zip"
    buf = io.BytesIO()
    np.savez(buf, **{"layer_0|W": np.ones((3, 2), np.float32),
                     "layer_0|b": np.zeros(2, np.float32)})
    with zipfile.ZipFile(path, "w") as zf:
        # pickles of a jax-only module: loading either would import it
        zf.writestr("conf.pkl", b"\x80\x04\x95\x10\x00\x00\x00\x00\x00"
                    b"\x00\x00\x8c\x03jax\x94\x8c\x05Array\x94\x93\x94.")
        zf.writestr("normalizer.pkl", b"not for the port")
        zf.writestr("params.npz", buf.getvalue())
        buf = io.BytesIO()
        np.savez(buf)
        zf.writestr("states.npz", buf.getvalue())
        zf.writestr("updater.pkl", b"optax state")
    code = (
        "import sys\n"
        "import pytest\n"
        "from deeplearning4j_tpu_torch import nn, serde\n"
        "conf = (nn.NeuralNetConfiguration.builder().list()\n"
        "        .layer(nn.OutputLayer(n_in=3, n_out=2)).build())\n"
        "net = nn.MultiLayerNetwork(conf).init((3,), device='cpu')\n"
        f"path = {str(path)!r}\n"
        "with pytest.raises(ValueError, match='load_params'):\n"
        "    serde.load_model(path, device='cpu')\n"
        "with pytest.raises(ValueError, match='JAX'):\n"
        "    serde.restore_normalizer(path)\n"
        "serde.load_params(net, path)\n"
        "assert float(net.params['layer_0']['W'].sum()) == 6.0\n"
        "with pytest.raises(NotImplementedError, match='optax'):\n"
        "    serde.load_params(net, path, updater=True)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'deeplearning4j_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
