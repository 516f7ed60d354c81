"""The port's ONNX importer against torch and against the JAX package's
importer, on the CPU: the reference's 17 cases (``tests/
test_onnx_import.py``). Each model is exported by ``torch.onnx.export``
(opset 13, the TorchScript exporter) and imported by both packages; the
outputs are held to the torch module's at the reference's tolerances
(1e-4 for whole models, 1e-5 / 1e-6 for the small op graphs, 2e-4 for
the bilinear resize), and the handler-level cases run the port's and
the reference's handlers on the same numpy inputs."""

from __future__ import annotations

import io
import sys
import types

import numpy as np
import pytest
import torch

# the TorchScript exporter imports `onnx` only to splice in custom
# function protos; with none it returns the bytes unchanged. The image
# has no onnx package: an empty stub satisfies the import (as the
# reference's test does); both importers read the wire format themselves.
if "onnx" not in sys.modules:
    _stub = types.ModuleType("onnx")

    class _StubGraph:
        node = ()

    class _StubModel:
        graph = _StubGraph()

    _stub.load_model_from_string = lambda b: _StubModel()
    sys.modules["onnx"] = _stub

import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.autodiff import onnx_import as jonnx  # noqa: E402
from deeplearning4j_tpu_torch.autodiff import onnx_import as tonnx  # noqa: E402

torch.set_num_threads(2)


def _export(model, args, **kw):
    buf = io.BytesIO()
    model.eval()
    torch.onnx.export(model, args, buf, opset_version=13, dynamo=False, **kw)
    return buf.getvalue()


def _both(data, feeds, index=0):
    """The output ``index`` of the graph, imported by the port (CPU) and
    by the JAX package."""
    _, touts = tonnx.import_onnx(data, device="cpu")
    _, jouts = jonnx.import_onnx(data)
    got = touts[index].eval(feeds).detach().numpy()
    want = np.asarray(jouts[index].eval(feeds))
    return got, want


def test_parse_onnx_structure():
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    data = _export(model, torch.randn(2, 4),
                   input_names=["x"], output_names=["y"])
    g = tonnx.parse_onnx(data)
    jg = jonnx.parse_onnx(data)
    assert g.outputs == jg.outputs == ["y"]
    assert g.inputs == jg.inputs
    assert sorted(g.initializers) == sorted(jg.initializers)
    for k, v in g.initializers.items():
        np.testing.assert_array_equal(v, jg.initializers[k])
    assert [n.op_type for n in g.nodes] == [n.op_type for n in jg.nodes]
    assert {n.op_type for n in g.nodes} <= {"Gemm", "MatMul", "Add"}


def test_mlp_roundtrip():
    torch.manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Linear(8, 16), torch.nn.ReLU(),
        torch.nn.Linear(16, 5), torch.nn.Softmax(dim=-1))
    x = torch.randn(4, 8)
    data = _export(model, x, input_names=["input"], output_names=["out"])
    got, ref = _both(data, {"input": x.numpy()})
    want = model(x).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("mode,align", [("nearest", None),
                                        ("bilinear", False)])
def test_resize_upsample_roundtrip(mode, align):
    torch.manual_seed(0)
    kw = {"mode": mode}
    if align is not None:
        kw["align_corners"] = align
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1),
                                torch.nn.Upsample(scale_factor=2, **kw))
    x = torch.randn(1, 3, 6, 6)
    data = _export(model, x, input_names=["input"], output_names=["out"])
    got, ref = _both(data, {"input": x.numpy()})
    want = model(x).detach().numpy()
    assert got.shape == want.shape == (1, 4, 12, 12)
    np.testing.assert_allclose(got, want, atol=2e-4, err_msg=mode)
    np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=mode)


def test_cnn_roundtrip():
    torch.manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.BatchNorm2d(8),
        torch.nn.ReLU(), torch.nn.MaxPool2d(2),
        torch.nn.Conv2d(8, 4, 3, stride=2), torch.nn.Flatten(),
        torch.nn.Linear(4 * 3 * 3, 10))
    x = torch.randn(2, 3, 16, 16)
    data = _export(model, x, input_names=["input"], output_names=["out"])
    got, ref = _both(data, {"input": x.numpy()})
    np.testing.assert_allclose(got, model(x).detach().numpy(), atol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_attention_block_roundtrip():
    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ln = torch.nn.LayerNorm(16)
            self.q = torch.nn.Linear(16, 16)
            self.k = torch.nn.Linear(16, 16)
            self.v = torch.nn.Linear(16, 16)

        def forward(self, x):
            h = self.ln(x)
            q, k, v = self.q(h), self.k(h), self.v(h)
            att = torch.softmax(q @ k.transpose(-1, -2) / 4.0, dim=-1)
            return x + att @ v

    torch.manual_seed(0)
    x = torch.randn(2, 6, 16)
    model = Block()
    data = _export(model, x, input_names=["input"], output_names=["out"])
    got, ref = _both(data, {"input": x.numpy()})
    np.testing.assert_allclose(got, model(x).detach().numpy(), atol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_elementwise_and_reduce_ops():
    class M(torch.nn.Module):
        def forward(self, x):
            y = torch.exp(x) + torch.sqrt(torch.abs(x)) * 2.0
            y = torch.clamp(y, 0.0, 5.0)
            return y.mean(dim=1)

    x = torch.randn(3, 7, generator=torch.Generator().manual_seed(0))
    data = _export(M(), x, input_names=["x"], output_names=["y"])
    got, ref = _both(data, {"x": x.numpy()})
    np.testing.assert_allclose(got, M()(x).numpy(), atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_clip_max_only_optional_input():
    """``torch.clamp(x, max=...)`` exports Clip('x', '', max): the empty
    min slot must not shift max into min's place."""
    class M(torch.nn.Module):
        def forward(self, x):
            return torch.clamp(x, max=0.5)

    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    data = _export(M(), x, input_names=["x"], output_names=["y"])
    got, ref = _both(data, {"x": x.numpy()})
    np.testing.assert_allclose(got, M()(x).numpy(), atol=1e-6)
    np.testing.assert_array_equal(got, ref)


def test_split_with_constant_sizes():
    class M(torch.nn.Module):
        def forward(self, x):
            a, b = torch.split(x, [2, 3], dim=1)
            return a.sum(dim=1) + b.mean(dim=1)

    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
    data = _export(M(), x, input_names=["x"], output_names=["y"])
    got, ref = _both(data, {"x": x.numpy()})
    np.testing.assert_allclose(got, M()(x).numpy(), atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_unsqueeze_negative_axes_output_rank():
    x = torch.zeros((5, 7))
    for axes, shape in (([0, -1], (1, 5, 7, 1)), ([-1], (5, 7, 1)),
                        ([1], (5, 1, 7))):
        assert tuple(tonnx._unsqueeze(x, axes).shape) == shape
        assert jonnx._unsqueeze(jnp.zeros((5, 7)), axes).shape == shape


def _pb_key(fnum, wtype):
    return bytes([(fnum << 3) | wtype])


def _pb_varint(v):
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        out += bytes([b | (0x80 if v else 0)])
        if not v:
            return out


def _pb_str(fnum, s):
    data = s.encode() if isinstance(s, str) else s
    return _pb_key(fnum, 2) + _pb_varint(len(data)) + data


def test_unknown_op_is_loud():
    # a hand-encoded ModelProto: one node of an unmapped op type
    node = _pb_str(1, "x") + _pb_str(2, "y") + _pb_str(4, "FancyCustomOp")
    graph = _pb_str(1, node) + _pb_str(11, _pb_str(1, "x")) + \
        _pb_str(12, _pb_str(1, "y"))
    model = _pb_str(7, graph)
    with pytest.raises(NotImplementedError, match="FancyCustomOp"):
        tonnx.import_onnx(model, device="cpu")
    with pytest.raises(NotImplementedError, match="FancyCustomOp"):
        jonnx.import_onnx(model)


def test_lstm_roundtrip():
    """The ONNX LSTM op (iofc gates) against torch.nn.LSTM."""
    torch.manual_seed(0)
    model = torch.nn.LSTM(input_size=5, hidden_size=7)
    x = torch.randn(9, 2, 5)
    data = _export(model, (x,), input_names=["x"],
                   output_names=["y", "hn", "cn"])
    got, ref = _both(data, {"x": x.numpy()})
    want = model(x)[0].detach().numpy()
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_lstm_bidirectional_roundtrip():
    torch.manual_seed(0)
    model = torch.nn.LSTM(input_size=4, hidden_size=6, bidirectional=True)
    x = torch.randn(7, 3, 4)
    data = _export(model, (x,), input_names=["x"],
                   output_names=["y", "hn", "cn"])
    got, ref = _both(data, {"x": x.numpy()})
    np.testing.assert_allclose(got, model(x)[0].detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_gru_roundtrip():
    torch.manual_seed(0)
    model = torch.nn.GRU(input_size=5, hidden_size=7)
    x = torch.randn(9, 2, 5)
    data = _export(model, (x,), input_names=["x"], output_names=["y", "hn"])
    got, ref = _both(data, {"x": x.numpy()})
    want = model(x)[0].detach().numpy()
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_topk_einsum_cumsum_roundtrip():
    class M(torch.nn.Module):
        def forward(self, x):
            vals, idx = torch.topk(x, k=3, dim=-1)
            e = torch.einsum("bi,bj->bij", vals, vals)
            return torch.cumsum(e, dim=-1), idx

    x = torch.randn(4, 10, generator=torch.Generator().manual_seed(0))
    data = _export(M(), (x,), input_names=["x"], output_names=["c", "idx"])
    want_c, want_idx = M()(x)
    got_c, ref_c = _both(data, {"x": x.numpy()}, 0)
    got_idx, ref_idx = _both(data, {"x": x.numpy()}, 1)
    np.testing.assert_allclose(got_c, want_c.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_c, ref_c, atol=1e-5)
    np.testing.assert_array_equal(got_idx, want_idx.numpy())
    np.testing.assert_array_equal(got_idx, ref_idx)


def test_scatter_gather_nd_handlers():
    data = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    idx = np.asarray([[0, 1], [2, 3]], np.int32)
    got = tonnx._onnx_gather_nd(torch.as_tensor(data), torch.as_tensor(idx))
    np.testing.assert_allclose(got.numpy(), [1.0, 11.0])
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jonnx._onnx_gather_nd(jnp.asarray(data), jnp.asarray(idx))))
    upd = np.full((1, 4), 9.0, np.float32)
    out = tonnx._onnx_scatter_nd(torch.as_tensor(data),
                                 torch.as_tensor([[1]]), torch.as_tensor(upd))
    ref = jonnx._onnx_scatter_nd(jnp.asarray(data), jnp.asarray([[1]]),
                                 jnp.asarray(upd))
    np.testing.assert_allclose(out.numpy()[1], [9, 9, 9, 9])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


class _StubNode:
    """A minimal OnnxNode stand-in for driving HANDLERS directly."""

    def __init__(self, **attrs):
        self._a = attrs

    def ai(self, name, default=0):
        return self._a.get(name, default)

    def af(self, name, default=0.0):
        return self._a.get(name, default)

    def aints(self, name, default=()):
        return list(self._a.get(name, default))

    def astr(self, name, default=""):
        return self._a.get(name, default)


def _handler(op, arrays, **attrs):
    """(port, reference) results of HANDLERS[op] on the same arrays."""
    node = _StubNode(**attrs)
    got = tonnx.HANDLERS[op]([torch.as_tensor(a) for a in arrays], node)
    want = jonnx.HANDLERS[op]([jnp.asarray(a) for a in arrays], node)
    return got.numpy(), np.asarray(want)


def test_onnx_opset17_handlers_vs_numpy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8)).astype(np.float32)
    # DFT forward: real input with a trailing dim of 1, axis 1
    out, ref = _handler("DFT", [x[..., None]], axis=1)
    want = np.fft.fft(x, axis=1)
    np.testing.assert_allclose(out[..., 0], want.real, atol=1e-4)
    np.testing.assert_allclose(out[..., 1], want.imag, atol=1e-4)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    # inverse round trip through the complex-pair layout
    inv, _ = _handler("DFT", [out], axis=1, inverse=1)
    np.testing.assert_allclose(inv[..., 0], x, atol=1e-4)
    one, one_ref = _handler("DFT", [x[..., None]], axis=1, onesided=1)
    np.testing.assert_allclose(one[..., 0], np.fft.rfft(x, axis=1).real,
                               atol=1e-4)
    np.testing.assert_allclose(one, one_ref, atol=1e-5)

    shr, shr_ref = _handler("Shrink", [x], lambd=0.5, bias=0.1)
    want_shr = np.where(x > 0.5, x - 0.1, np.where(x < -0.5, x + 0.1, 0.0))
    np.testing.assert_allclose(shr, want_shr, atol=1e-6)
    np.testing.assert_allclose(shr, shr_ref, atol=1e-6)

    tr, tr_ref = _handler("ThresholdedRelu", [x], alpha=0.3)
    np.testing.assert_allclose(tr, np.where(x > 0.3, x, 0.0), atol=1e-6)
    np.testing.assert_array_equal(tr, tr_ref)

    img = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    mvn, mvn_ref = _handler("MeanVarianceNormalization", [img])
    want_mvn = (img - img.mean((0, 2, 3), keepdims=True)) / np.sqrt(
        img.var((0, 2, 3), keepdims=True) + 1e-9)
    np.testing.assert_allclose(mvn, want_mvn, atol=1e-5)
    np.testing.assert_allclose(mvn, mvn_ref, atol=1e-5)

    sq = rng.standard_normal((3, 3)).astype(np.float32) + \
        2 * np.eye(3, dtype=np.float32)
    det, det_ref = _handler("Det", [sq])
    np.testing.assert_allclose(det, np.linalg.det(sq), rtol=1e-4)
    np.testing.assert_allclose(det, det_ref, rtol=1e-5)


def test_onnx_dft_negative_axis():
    """The ONNX DFT axis counts the trailing real/imag dim: axis -2 on a
    (B, T, 1) input is the T axis."""
    x = np.random.default_rng(1).standard_normal((2, 8)).astype(np.float32)
    out, ref = _handler("DFT", [x[..., None]], axis=-2)
    want = np.fft.fft(x, axis=1)
    np.testing.assert_allclose(out[..., 0], want.real, atol=1e-4)
    np.testing.assert_allclose(out[..., 1], want.imag, atol=1e-4)
    np.testing.assert_allclose(out, ref, atol=1e-5)
