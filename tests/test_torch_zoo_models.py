"""The port's model zoo against the JAX package's, on the CPU, at the
reference tests' reduced input sizes (``tests/test_zoo_models.py``):
UNet (output and a fit step), Xception, InceptionResNetV1, FaceNet
NN4-small2, NASNet, SqueezeNet, Darknet19, SimpleCNN, AlexNet and VGG16/19
(output), each on the JAX net's params (``nn.params_from_numpy``); the
configurations agree node for node and param shape for shape; and
``ZooModel.init_pretrained`` loads a zip written by either package's
model serializer. TinyYOLO and YOLO2 are in ``test_torch_objdetect.py``.

Tolerances, f32: outputs atol 1e-5 (softmax and sigmoid heads); the UNet
fit loss atol 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data as jdata
import deeplearning4j_tpu_torch.data as tdata
from deeplearning4j_tpu import zoo as jzoo
from deeplearning4j_tpu_torch import zoo as tzoo
from deeplearning4j_tpu_torch.nn import (ComputationGraph,
                                         MultiLayerNetwork,
                                         params_from_numpy)
from deeplearning4j_tpu_torch.train.updaters import tree_leaves

torch.set_num_threads(2)

ATOL = 1e-5

CASES = {
    "Xception": (dict(num_classes=7, input_shape=(71, 71, 3)), 7),
    "InceptionResNetV1": (dict(num_classes=5, input_shape=(64, 64, 3),
                               blocks_a=1, blocks_b=1, blocks_c=1), 5),
    "FaceNetNN4Small2": (dict(num_classes=5, input_shape=(64, 64, 3)), 5),
    "NASNet": (dict(num_classes=6, input_shape=(32, 32, 3),
                    penultimate_filters=96, cells_per_stack=1), 6),
    "SqueezeNet": (dict(num_classes=4, input_shape=(67, 67, 3)), 4),
    "Darknet19": (dict(num_classes=4, input_shape=(64, 64, 3)), 4),
    "SimpleCNN": (dict(num_classes=4, input_shape=(32, 32, 3)), 4),
    "AlexNet": (dict(num_classes=4, input_shape=(96, 96, 3)), 4),
    "VGG16": (dict(num_classes=4, input_shape=(32, 32, 3)), 4),
    "VGG19": (dict(num_classes=4, input_shape=(32, 32, 3)), 4),
}


def _np(t):
    return t.detach().float().numpy()


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _pair(name, **kw):
    jm, tm = getattr(jzoo, name)(**kw), getattr(tzoo, name)(**kw)
    jnet, tnet = jm.init(), tm.init(device="cpu")
    if hasattr(jnet, "conf") and hasattr(jnet.conf, "nodes"):
        assert list(tnet.conf.nodes) == list(jnet.conf.nodes)
        assert tnet.conf.topo_order == jnet.conf.topo_order
    else:
        assert [type(lyr).__name__ for lyr in tnet.layers] == \
            [type(lyr).__name__ for lyr in jnet.layers]
    jl = jax.tree_util.tree_leaves(jnet.params)
    tl = tree_leaves(tnet.params)
    assert [tuple(a.shape) for a in jl] == [tuple(b.shape) for b in tl]
    tnet.params, tnet.states = params_from_numpy(
        _np_tree(jnet.params), _np_tree(jnet.states), "cpu")
    return jm, tm, jnet, tnet


@pytest.mark.parametrize("name", sorted(CASES))
def test_zoo_model_output_matches_jax(name):
    kw, n_out = CASES[name]
    _, _, jnet, tnet = _pair(name, **kw)
    x = np.random.default_rng(0).standard_normal(
        (2,) + kw["input_shape"]).astype(np.float32)
    yj = np.asarray(jnet.output(jnp.asarray(x)))
    yt = tnet.output(x)
    assert tuple(yt.shape) == yj.shape == (2, n_out)
    np.testing.assert_allclose(_np(yt), yj, atol=ATOL)
    np.testing.assert_allclose(_np(yt).sum(-1), 1.0, atol=1e-4)


def test_unet_output_and_fit_match_jax():
    _, _, jnet, tnet = _pair("UNet", input_shape=(32, 32, 3))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    yj = np.asarray(jnet.output(jnp.asarray(x)))
    yt = _np(tnet.output(x))
    assert yt.shape == yj.shape == (1, 32, 32, 1)
    assert np.all((yt >= 0) & (yt <= 1))
    np.testing.assert_allclose(yt, yj, atol=ATOL)
    mask = (rng.random((1, 32, 32, 1)) > 0.5).astype(np.float32)
    lj = jnet.fit(jdata.DataSet(x, mask))
    lt = tnet.fit(tdata.DataSet(x, mask))
    assert np.isfinite(lt) and abs(lt - lj) <= ATOL


def test_init_pretrained_from_either_serializer(tmp_path):
    """A zip of the JAX package's serializer loads into the port's model
    (its params copied in); a zip of the port's loads whole."""
    from deeplearning4j_tpu.serde import model_serializer as jser
    kw = dict(num_classes=4, input_shape=(32, 32, 3))
    jnet = jzoo.SimpleCNN(**kw).init()
    jpath = tmp_path / "jax.zip"
    jser.save_model(jnet, jpath)
    net = tzoo.SimpleCNN(**kw).init_pretrained(jpath, device="cpu")
    assert isinstance(net, MultiLayerNetwork)
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    np.testing.assert_allclose(_np(net.output(x)),
                               np.asarray(jnet.output(jnp.asarray(x))),
                               atol=ATOL)
    tpath = tmp_path / "port.zip"
    net.save(tpath)
    again = tzoo.SimpleCNN(**kw).init_pretrained(tpath, device="cpu")
    assert torch.equal(again.output(x), net.output(x))
    graph = tzoo.SqueezeNet(num_classes=4, input_shape=(67, 67, 3))
    gnet = graph.init(device="cpu")
    gpath = tmp_path / "graph.zip"
    gnet.save(gpath)
    assert isinstance(graph.init_pretrained(gpath, device="cpu"),
                      ComputationGraph)
