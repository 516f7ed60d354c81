"""The port's TF GraphDef importer against the JAX package's.

Every graph of the reference's importer tests (``test_tf_import_r4.py``,
``test_native_and_imports.py``'s MLP and CNN, ``test_bert.py``'s
mini-BERT) is serialized to bytes and imported by both: the JAX importer
reads the bytes parsed by TF's ``graph_pb2``, the port reads the raw
bytes with its own wire reader (no TensorFlow). Outputs agree at the
reference's bar, atol = rtol = 2e-4, with equal dtypes. TensorFlow
builds the graphs only.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from deeplearning4j_tpu.autodiff import tf_import as J  # noqa: E402
from deeplearning4j_tpu_torch.autodiff import tf_import as P  # noqa: E402

tf1 = tf.compat.v1
ATOL = RTOL = 2e-4


def _both(gd):
    """(JAX SameDiff, port SameDiff) of one GraphDef, through bytes."""
    from tensorflow.core.framework import graph_pb2
    raw = gd.SerializeToString()
    parsed = graph_pb2.GraphDef()
    parsed.ParseFromString(raw)
    sdj, _ = J.import_frozen_graph(parsed)
    sdp, _ = P.import_frozen_graph(raw, device="cpu")
    return sdj, sdp


def _check(sdj, sdp, out, feeds, atol=ATOL, rtol=RTOL, exact=False):
    want = np.asarray(sdj.eval(sdj.get_variable(out), feeds))
    got = sdp.eval(sdp.get_variable(out), feeds)
    got_np = got.detach().cpu().numpy()
    assert got_np.dtype == want.dtype, (out, got_np.dtype, want.dtype)
    if exact:
        np.testing.assert_array_equal(got_np, want)
    else:
        np.testing.assert_allclose(got_np, want, atol=atol, rtol=rtol)
    return got_np


# ------------------------------------------------------------ the graphs

def g_cond_lowered():
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, (None, 3), name="x")
        pred = tf1.placeholder(tf.bool, (), name="pred")
        out = tf1.cond(pred, lambda: x * 2.0 + 1.0, lambda: x - 5.0)
        tf1.identity(out, name="out")
    f = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
    return g.as_graph_def(), [("out", {"x": f, "pred": np.asarray(p)})
                              for p in (True, False)]


def g_raw_switch_merge():
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, (None, 3), name="x")
        pred = tf1.placeholder(tf.bool, (), name="pred")
        sw_f, sw_t = tf.raw_ops.Switch(data=x, pred=pred, name="sw")
        a = tf1.identity(sw_t * 2.0 + 1.0)
        b = tf1.identity(sw_f - 5.0)
        merged, _ = tf.raw_ops.Merge(inputs=[b, a], name="mrg")
        tf1.identity(merged, name="out")
    f = np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32)
    return g.as_graph_def(), [("out", {"x": f, "pred": np.asarray(p)})
                              for p in (True, False)]


def g_while_lowered():
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, (2,), name="x")
        i0 = tf1.constant(0)
        _, acc = tf1.while_loop(lambda i, a: i < 5,
                                lambda i, a: (i + 1, a + 1.0), [i0, x])
        tf1.identity(acc, name="out")
    return g.as_graph_def(), [("out", {"x": np.asarray([1.0, 2.0],
                                                       np.float32)})]


def _fn_graph(cf, feeds_fn):
    gd = cf.graph.as_graph_def()
    phs = [n.name for n in gd.node if n.op == "Placeholder"]
    out = [n.name for n in gd.node if n.name.startswith("Identity")][-1]
    return gd, [(out, dict(zip(phs, f))) for f in feeds_fn()]


def g_v2_stateless_while():
    @tf.function
    def count_pow(x):
        i = tf.constant(0)
        i, acc = tf.while_loop(lambda i, a: i < 4,
                               lambda i, a: (i + 1, a * 2.0), [i, x])
        return tf.identity(acc, name="out")

    cf = count_pow.get_concrete_function(tf.TensorSpec((2, 2), tf.float32))
    x = np.random.default_rng(1).standard_normal((2, 2)).astype(np.float32)
    return _fn_graph(cf, lambda: [(x,)])


def g_v2_if():
    @tf.function
    def branchy(x, flag):
        out = tf.cond(flag, lambda: tf.nn.relu(x), lambda: tf.nn.sigmoid(x))
        return tf.identity(out, name="out")

    cf = branchy.get_concrete_function(tf.TensorSpec((3,), tf.float32),
                                       tf.TensorSpec((), tf.bool))
    x = np.asarray([-1.0, 0.5, 2.0], np.float32)
    return _fn_graph(cf, lambda: [(x, np.asarray(f)) for f in (True, False)])


def g_detection():
    g = tf1.Graph()
    rng = np.random.default_rng(0)
    with g.as_default():
        x = tf1.placeholder(tf.float32, (1, 8, 8, 3), name="x")
        k = tf1.constant(rng.standard_normal((3, 3, 3, 8)).astype(
            np.float32) * 0.2)
        feat = tf.nn.relu(tf1.nn.conv2d(x, k, strides=[1, 2, 2, 1],
                                        padding="SAME"))
        flat = tf1.reshape(feat, (16, 8))
        wb = tf1.constant(rng.standard_normal((8, 4)).astype(np.float32))
        ws = tf1.constant(rng.standard_normal((8,)).astype(np.float32))
        raw = tf1.matmul(flat, wb)
        y1x1 = tf.nn.sigmoid(raw[:, :2]) * 0.5
        boxes = tf1.concat([y1x1, y1x1 + 0.3 + tf.nn.sigmoid(
            raw[:, 2:]) * 0.2], axis=1, name="boxes")
        scores = tf1.tensordot(flat, ws, 1, name="scores")
        sel = tf1.image.non_max_suppression(boxes, scores, max_output_size=5,
                                            iou_threshold=0.5, name="nms")
        tf1.gather(boxes, sel, name="picked")
    f = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    return g.as_graph_def(), [("nms/NonMaxSuppressionV3", {"x": f}),
                              ("picked", {"x": f}), ("boxes", {"x": f}),
                              ("scores", {"x": f})]


def g_elementwise():
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, (4,), name="x")
        y = tf1.placeholder(tf.float32, (4,), name="y")
        a = tf1.clip_by_value(x, -1.0, 1.0)
        b = tf.math.xlogy(tf.abs(x), tf.abs(y) + 1.0)
        c = tf.math.lgamma(tf.abs(x) + 1.0)
        d = tf.math.erfinv(tf1.clip_by_value(y, -0.9, 0.9))
        tf1.add_n([a, b, c, d], name="out")
    rng = np.random.default_rng(2)
    return g.as_graph_def(), [("out", {
        "x": rng.standard_normal(4).astype(np.float32),
        "y": rng.standard_normal(4).astype(np.float32)})]


def g_segment_topk():
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, (6, 3), name="x")
        ids = tf1.constant(np.asarray([0, 0, 1, 1, 2, 2], np.int32))
        seg = tf1.segment_sum(x, ids)
        useg = tf1.unsorted_segment_max(x, ids, 3)
        tf1.add(seg, useg, name="out")
        tk_vals, tk_idx = tf.math.top_k(tf1.reshape(x, (-1,)), k=4)
        tf1.identity(tk_vals, name="tkv")
        tf1.identity(tf1.cast(tk_idx, tf.int32), name="tki")
    xv = np.random.default_rng(3).standard_normal((6, 3)).astype(np.float32)
    return g.as_graph_def(), [(o, {"x": xv}) for o in ("out", "tkv", "tki")]


def g_partition_stitch():
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, (6, 2), name="x")
        parts = tf1.constant(np.asarray([1, 0, 1, 1, 0, 0], np.int32))
        px = tf1.dynamic_partition(x, parts, 2)
        pi = tf1.dynamic_partition(tf1.range(6), parts, 2)
        tf1.identity(tf1.dynamic_stitch(pi, px), name="out")
    xv = np.random.default_rng(0).standard_normal((6, 2)).astype(np.float32)
    return g.as_graph_def(), [("out", {"x": xv})]


def g_merge_index():
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, (3,), name="x")
        pred = tf1.placeholder(tf.bool, (), name="pred")
        sw_f, sw_t = tf.raw_ops.Switch(data=x, pred=pred, name="sw")
        a = tf1.identity(sw_t * 2.0)
        b = tf1.identity(sw_f - 1.0)
        merged, idx = tf.raw_ops.Merge(inputs=[a, b], name="mrg")
        tf1.identity(merged, name="out")
        tf1.identity(idx, name="idx")
    xv = np.asarray([1.0, 2.0, 3.0], np.float32)
    return g.as_graph_def(), [(o, {"x": xv, "pred": np.asarray(p)})
                              for p in (True, False) for o in ("out", "idx")]


def _bicubic(kwargs):
    def build():
        g = tf1.Graph()
        with g.as_default():
            x = tf1.placeholder(tf.float32, (1, 5, 7, 2), name="x")
            out = tf.raw_ops.ResizeBicubic(images=x, size=(9, 11), **kwargs)
            tf1.identity(out, name="out")
        xv = np.random.default_rng(1).random((1, 5, 7, 2)).astype(np.float32)
        return g.as_graph_def(), [("out", {"x": xv})]
    return build


def g_seq2seq():
    @tf.function
    def greedy_decode(emb, w):
        tok = tf.constant([1], tf.int32)
        acc = tf.zeros((1, 8), tf.float32)
        i = tf.constant(0)

        def body(i, tok, acc):
            h = tf.nn.embedding_lookup(emb, tok)
            logits = tf.matmul(h, w)
            tok2 = tf.cast(tf.argmax(logits, axis=-1), tf.int32)
            return i + 1, tok2, acc + tf.nn.softmax(logits)

        i, tok, acc = tf.while_loop(lambda i, t, a: i < 4, body,
                                    [i, tok, acc])
        return tf.identity(acc, name="decoded")

    rng = np.random.default_rng(5)
    embv = rng.standard_normal((8, 6)).astype(np.float32)
    wv = rng.standard_normal((6, 8)).astype(np.float32)
    cf = greedy_decode.get_concrete_function(
        tf.TensorSpec((8, 6), tf.float32), tf.TensorSpec((6, 8), tf.float32))
    return _fn_graph(cf, lambda: [(embv, wv)])


def g_mlp():
    g = tf1.Graph()
    rng = np.random.default_rng(0)
    with g.as_default():
        x = tf1.placeholder(tf.float32, (None, 4), name="x")
        w = tf1.constant(rng.standard_normal((4, 3)).astype(np.float32))
        tf.nn.softmax(tf.matmul(x, w), name="out")
    return g.as_graph_def(), [("out", {"x": rng.standard_normal(
        (5, 4)).astype(np.float32)})]


def g_cnn():
    g = tf1.Graph()
    rng = np.random.default_rng(0)
    with g.as_default():
        x = tf1.placeholder(tf.float32, (None, 8, 8, 3), name="x")
        k = tf1.constant(rng.standard_normal((3, 3, 3, 4)).astype(
            np.float32) * 0.3)
        conv = tf1.nn.conv2d(x, k, strides=[1, 1, 1, 1], padding="SAME")
        gamma = tf1.constant(rng.uniform(0.5, 1.5, 4).astype(np.float32))
        beta = tf1.constant(rng.standard_normal(4).astype(np.float32))
        mean = tf1.constant(rng.standard_normal(4).astype(np.float32))
        var = tf1.constant(rng.uniform(0.5, 2.0, 4).astype(np.float32))
        bn, _, _ = tf1.nn.fused_batch_norm(conv, gamma, beta, mean, var,
                                           is_training=False)
        act = tf.nn.relu(bn)
        pool = tf1.nn.max_pool2d(act, ksize=2, strides=2, padding="VALID")
        flat = tf1.reshape(pool, (-1, 4 * 4 * 4))
        w = tf1.constant(rng.standard_normal((64, 5)).astype(np.float32) * 0.2)
        tf.nn.softmax(tf1.matmul(flat, w), name="out")
    return g.as_graph_def(), [("out", {"x": rng.standard_normal(
        (2, 8, 8, 3)).astype(np.float32)})]


def g_mini_bert():
    rng = np.random.default_rng(0)
    V, T, D, H = 50, 12, 16, 2
    hd = D // H

    def ln(x):
        mean = tf.reduce_mean(x, axis=-1, keepdims=True)
        var = tf.reduce_mean(tf.square(x - mean), axis=-1, keepdims=True)
        return (x - mean) * tf.math.rsqrt(var + 1e-6)

    def gelu(x):
        return x * 0.5 * (1.0 + tf.math.erf(
            x / np.sqrt(2.0).astype(np.float32)))

    g = tf1.Graph()
    with g.as_default():
        ids = tf1.placeholder(tf.int32, (None, T), name="ids")
        embed = tf1.constant(rng.standard_normal((V, D)).astype(np.float32))
        pos = tf1.constant(rng.standard_normal((T, D)).astype(np.float32))
        x = tf.gather(embed, ids) + pos
        wqkv = tf1.constant(rng.standard_normal((D, 3 * D)).astype(
            np.float32) * 0.2)
        wo = tf1.constant(rng.standard_normal((D, D)).astype(np.float32) * 0.2)
        h = ln(x)
        qkv = tf.einsum("btd,dz->btz", h, wqkv)
        q, k, v = tf.split(qkv, 3, axis=-1)

        def heads(t):
            return tf.transpose(tf.reshape(t, (-1, T, H, hd)), (0, 2, 1, 3))

        q, k, v = heads(q), heads(k), heads(v)
        scores = tf.matmul(q, k, transpose_b=True) / np.sqrt(hd).astype(
            np.float32)
        ctx = tf.matmul(tf.nn.softmax(scores), v)
        ctx = tf.reshape(tf.transpose(ctx, (0, 2, 1, 3)), (-1, T, D))
        x = x + tf.einsum("btd,dz->btz", ctx, wo)
        w_in = tf1.constant(rng.standard_normal((D, 4 * D)).astype(
            np.float32) * 0.2)
        w_out = tf1.constant(rng.standard_normal((4 * D, D)).astype(
            np.float32) * 0.2)
        x = tf.add(x, tf.einsum("btf,fd->btd", gelu(
            tf.einsum("btd,df->btf", ln(x), w_in)), w_out), name="encoded")
    feed = rng.integers(0, V, (3, T)).astype(np.int32)
    return g.as_graph_def(), [("encoded", {"ids": feed})]


GRAPHS = {
    "cond_lowered": g_cond_lowered, "raw_switch_merge": g_raw_switch_merge,
    "while_lowered": g_while_lowered,
    "v2_stateless_while": g_v2_stateless_while, "v2_if": g_v2_if,
    "detection": g_detection, "elementwise": g_elementwise,
    "segment_topk": g_segment_topk, "partition_stitch": g_partition_stitch,
    "merge_index": g_merge_index,
    "bicubic_legacy": _bicubic({"align_corners": False,
                                "half_pixel_centers": False}),
    "bicubic_align": _bicubic({"align_corners": True,
                               "half_pixel_centers": False}),
    "bicubic_half": _bicubic({"align_corners": False,
                              "half_pixel_centers": True}),
    "seq2seq": g_seq2seq, "mlp": g_mlp, "cnn": g_cnn,
    "mini_bert": g_mini_bert,
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_imports_equal(name):
    gd, cases = GRAPHS[name]()
    sdj, sdp = _both(gd)
    for out, feeds in cases:
        _check(sdj, sdp, out, feeds)


def test_seq2seq_from_a_pb_file(tmp_path):
    gd, cases = g_seq2seq()
    pb = tmp_path / "seq2seq.pb"
    pb.write_bytes(gd.SerializeToString())
    sdj, _ = J.import_frozen_graph(str(pb))
    sdp, _ = P.import_frozen_graph(str(pb), device="cpu")
    for out, feeds in cases:
        _check(sdj, sdp, out, feeds)


def test_graphdef_object_and_bytes_agree():
    gd, cases = g_mlp()
    a, _ = P.import_frozen_graph(gd, device="cpu")
    b, _ = P.import_frozen_graph(gd.SerializeToString(), device="cpu")
    out, feeds = cases[0]
    np.testing.assert_array_equal(a.eval(out, feeds).numpy(),
                                  b.eval(out, feeds).numpy())


def test_v1_raw_loop_frames_raise_loud():
    g = tf1.Graph()
    with g.as_default():
        x = tf1.placeholder(tf.float32, (2,), name="x")
        tf.raw_ops.Enter(data=x, frame_name="loop", name="enter")
    with pytest.raises(NotImplementedError, match="v1"):
        P.import_frozen_graph(g.as_graph_def().SerializeToString(),
                              device="cpu")


def test_handler_set_equals_the_reference():
    assert set(P.TFImporter().handlers) == set(J.TFImporter().handlers)
    assert len(P.TFImporter().handlers) + 3 >= 200
    assert set(P.TFImporter().multi_output) == set(J.TFImporter().multi_output)


def test_control_flow_graphs_run_eagerly_by_structure():
    gd, cases = g_v2_stateless_while()
    _, sdp = _both(gd)
    out = cases[0][0]
    assert sdp.needs_host(sdp.get_variable(out))
    gd, cases = g_mini_bert()
    _, sdp = _both(gd)
    assert not sdp.needs_host(sdp.get_variable("encoded"))


def test_random_ops_import_by_shape_and_support():
    g = tf1.Graph()
    with g.as_default():
        tf.random.uniform((64, 32), name="u")
        tf.random.normal((64, 32), name="n")
        tf1.random.uniform((10,), 3, 9, dtype=tf.int32, name="ri")
    sdp, _ = P.import_frozen_graph(g.as_graph_def().SerializeToString(),
                                   device="cpu")
    u = sdp.eval("u/RandomUniform").numpy()
    assert u.shape == (64, 32) and u.dtype == np.float32
    assert 0 <= u.min() and u.max() < 1 and abs(u.mean() - 0.5) < 0.05
    n = sdp.eval("n/RandomStandardNormal").numpy()
    assert abs(n.mean()) < 0.1 and abs(n.std() - 1) < 0.1
    ri = sdp.eval("ri").numpy()
    assert ri.dtype == np.int32 and ri.min() >= 3 and ri.max() < 9
    # a node's draws are the same every run (seeded by its name)
    np.testing.assert_array_equal(u, sdp.eval("u/RandomUniform").numpy())


# -------------------------------------------------------- the decoders

_DTYPE_CASES = [
    np.float32, np.float64, np.int32, np.uint8, np.int16, np.int8,
    np.complex64, np.int64, np.bool_, np.uint16, np.complex128,
    np.float16, np.uint32, np.uint64, "bfloat16", "string",
]


def _sample(dt, shape):
    rng = np.random.default_rng(7)
    if dt == "string":
        return np.array([b"ab", b"", b"xyz"] * 2, dtype=object).reshape(shape)
    if dt == "bfloat16":
        return rng.standard_normal(shape).astype(np.float32)
    dt = np.dtype(dt)
    if dt.kind == "b":
        return rng.random(shape) > 0.5
    if dt.kind == "c":
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dt)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(max(info.min, -100), min(info.max, 100),
                            shape).astype(dt)
    return rng.standard_normal(shape).astype(dt)


def _as_compared(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a


@pytest.mark.parametrize("dt", _DTYPE_CASES, ids=str)
@pytest.mark.parametrize("form", ["content", "values", "scalar_fill"])
def test_tensorproto_decoder_vs_make_ndarray(dt, form):
    from tensorflow.python.framework import tensor_util
    shape = (2, 3)
    arr = _sample(dt, shape)
    tf_dt = {"bfloat16": tf.bfloat16, "string": tf.string}.get(dt)
    if form == "scalar_fill":
        val = arr.reshape(-1)[:1].reshape(())
        proto = tensor_util.make_tensor_proto(
            val, dtype=tf_dt, shape=shape) if tf_dt is not None else \
            tensor_util.make_tensor_proto(val, shape=shape)
    elif form == "content" or dt == "string":
        proto = tensor_util.make_tensor_proto(arr, dtype=tf_dt)
    else:
        # the repeated *_val form: what make_tensor_proto writes for a
        # one-element tensor, widened here by hand to the whole array
        proto = tensor_util.make_tensor_proto(arr, dtype=tf_dt)
        dtype_enum = proto.dtype
        content = tensor_util.MakeNdarray(proto).reshape(-1)
        proto.ClearField("tensor_content")
        field = {1: "float_val", 2: "double_val", 3: "int_val",
                 4: "int_val", 5: "int_val", 6: "int_val", 8: "scomplex_val",
                 9: "int64_val", 10: "bool_val", 14: "half_val",
                 17: "int_val", 18: "dcomplex_val", 19: "half_val",
                 22: "uint32_val", 23: "uint64_val"}[dtype_enum]
        proto.ClearField(field)
        if field == "half_val":
            bits = content.view(np.uint16)
            getattr(proto, field).extend(int(b) for b in bits)
        elif field in ("scomplex_val", "dcomplex_val"):
            for c in content:
                getattr(proto, field).extend([c.real, c.imag])
        else:
            getattr(proto, field).extend(content.tolist())
    want = _as_compared(tensor_util.MakeNdarray(proto))
    from deeplearning4j_tpu_torch.autodiff._protowire import Msg
    got = P.tensor_to_numpy(Msg(proto.SerializeToString()))
    assert got.shape == want.shape
    if dt == "string":
        assert got.tolist() == want.tolist()
        return
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_output_arg_table_matches_the_op_registry():
    from tensorflow.python.framework import op_def_registry
    checked = 0
    for op in P.TFImporter().handlers:
        od = op_def_registry.get(op)
        if od is None:
            assert op not in P.OUTPUT_ARGS, op
            continue
        assert P.OUTPUT_ARGS[op] == tuple(a.name for a in od.output_arg), op
        checked += 1
    assert checked >= 220


def test_attr_reader_matches_tf():
    """Node attributes read by the wire reader equal TF's parse."""
    from tensorflow.core.framework import graph_pb2
    gd, _ = g_cnn()
    raw = gd.SerializeToString()
    ref = graph_pb2.GraphDef()
    ref.ParseFromString(raw)
    mine = P.GraphDef(raw)
    assert [n.name for n in mine.node] == [n.name for n in ref.node]
    for a, b in zip(mine.node, ref.node):
        assert a.op == b.op and list(a.input) == list(b.input)
        for k, v in b.attr.items():
            assert k in a.attr
            assert a.attr[k].s == v.s and a.attr[k].i == v.i
            assert a.attr[k].b == v.b and a.attr[k].type == v.type
            assert list(a.attr[k].list.i) == list(v.list.i)
            assert a.attr[k].f == pytest.approx(v.f)


# ------------------------------------------- chip_smoke's GraphDef encoder

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_mod", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase18_encoder_parses_with_tf_and_imports_equal_to_bert_forward():
    import torch

    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    from tensorflow.core.framework import graph_pb2
    cs = _chip_smoke()
    cfg = tfm.BertConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64, max_seq=16, num_labels=3,
                         dtype=torch.float32)
    params = tfm.bert_init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params["cls"] = 0.1 * torch.randn(cfg.d_model, cfg.num_labels,
                                      generator=torch.Generator()
                                      .manual_seed(1))
    b, t = 3, 8
    raw = cs.bert_graphdef(params, cfg, b, t)
    parsed = graph_pb2.GraphDef()
    parsed.ParseFromString(raw)
    assert {n.op for n in parsed.node} >= {
        "GatherV2", "Mean", "Square", "Rsqrt", "BatchMatMulV2", "Softmax",
        "Tanh", "Pow"}
    sd, _ = P.import_frozen_graph(raw, device="cpu")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, t),
                                            dtype=np.int32)
    logits, hidden = tfm.bert_forward(params, cfg, torch.as_tensor(ids))
    got = sd.eval(["logits", "hidden"], {"ids": ids})
    np.testing.assert_allclose(got[0].numpy(), logits.numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), hidden.numpy(),
                               atol=1e-5, rtol=1e-5)
    # TF itself runs the graph to the same values
    with tf1.Session(graph=tf1.Graph()) as sess:
        tf1.import_graph_def(parsed, name="")
        want = sess.run("logits:0", {"ids:0": ids})
    np.testing.assert_allclose(want, logits.numpy(), atol=1e-4, rtol=1e-4)
