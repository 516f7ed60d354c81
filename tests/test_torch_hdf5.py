"""The port's HDF5 reader (``deeplearning4j_tpu_torch/import_/_hdf5.py``)
against h5py on h5py-written files: every datatype it reads (little- and
big-endian integers, f16/f32/f64, h5py's bool enum, fixed and
variable-length strings), nested groups, scalar and empty datasets, a
compact dataset, an object header long enough for a continuation block,
a group of 200 links whose B-tree splits, the ``libver="latest"`` layout
(superblock 3, version-2 headers, compact links and attributes), and
Keras-written ``.h5`` and ``.keras`` files. What the reader leaves out
raises ``NotImplementedError`` naming the feature. ``chip_smoke.py``'s
HDF5 writer (the card has no h5py) is read back by h5py and by the
reader: equal arrays and attributes. Values are compared exactly."""

from __future__ import annotations

import importlib.util
import mmap
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from deeplearning4j_tpu_torch.import_ import _hdf5  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DTYPES = ["<i1", "<i2", "<i4", "<i8", ">i2", ">i4", ">i8", "<u1", "<u2",
          "<u4", ">u4", "<u8", "<f2", "<f4", "<f8", ">f4", ">f8", "?"]


def _dname(dt):
    return "d_" + dt.replace("<", "le").replace(">", "be").replace(
        "?", "bool")


def _build(path, libver):
    rng = np.random.default_rng(0)
    with h5py.File(path, "w", libver=libver) as f:
        data = f.create_group("data") if libver == "earliest" else f
        for dt in DTYPES if libver == "earliest" else ("<f4", ">i8"):
            data.create_dataset(_dname(dt), data=(
                rng.standard_normal((3, 4)) * 10).astype(dt))
        f["scalar"] = np.float32(1.5)
        f["empty"] = np.zeros((0, 3), np.float32)
        f["vstr"] = np.array(["a", "bcd", "éx"], dtype=h5py.string_dtype())
        if libver != "earliest":
            return
        f["fstr"] = np.array([b"ab", b"cde"])
        f["vstr_scalar"] = "one string"
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT32,
                             h5py.h5s.create_simple((5,)), dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(5, dtype=np.int32))
        g = f.create_group("a/b/c")
        g["x"] = np.arange(3.0)
        g.attrs["vs"] = "hello"
        g.attrs["vsl"] = ["x", "yy", "zzz"]
        g.attrs["fs"] = np.bytes_(b"fixed")
        g.attrs["fsl"] = np.array([b"p", b"qq"])
        g.attrs["i"] = 3
        g.attrs["u8"] = np.uint8(7)
        g.attrs["f"] = 2.5
        g.attrs["f16"] = np.float16(0.5)
        g.attrs["arr"] = np.arange(4.0).reshape(2, 2)
        g.attrs["b"] = True
        many = f.create_group("many")
        for i in range(200):
            many[f"k{i}"] = np.full((2,), i, np.int16)
        long = f.create_group("long")
        for i in range(60):
            long.attrs[f"attr{i:02d}"] = "v" * (i * 7)
        f.attrs["top"] = "root attr"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("h5")
    out = {}
    for libver in ("earliest", "latest"):
        out[libver] = d / f"{libver}.h5"
        _build(out[libver], libver)
    return out


def _same_value(a, b, where):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (
            where, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=str(where))
    else:
        assert type(a) is type(b), (where, type(a), type(b))
        assert a == b, where


def _compare(a, b, path="/"):
    assert sorted(a.attrs.keys()) == sorted(b.attrs.keys()), path
    for k in a.attrs:
        _same_value(a.attrs[k], b.attrs[k], (path, k))
    if isinstance(a, h5py.Dataset):
        assert isinstance(b, _hdf5.Dataset), path
        assert a.shape == b.shape and a.dtype == b.dtype, path
        _same_value(a[()], b[()], path)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return
    assert isinstance(b, _hdf5.Group), path
    assert list(a.keys()) == list(b.keys()), path
    for k in a.keys():
        _compare(a[k], b[k], f"{path}{k}/")


@pytest.mark.parametrize("name", [_dname(d) for d in DTYPES])
def test_every_datatype_reads_as_h5py_does(files, name):
    with h5py.File(files["earliest"]) as a, \
            _hdf5.File(files["earliest"]) as b:
        _compare(a["data"][name], b["data"][name], name)
        assert b["data"][name].dtype == a["data"][name].dtype


@pytest.mark.parametrize("name", ["scalar", "empty", "vstr", "fstr",
                                  "vstr_scalar", "compact", "a/b/c/x"])
def test_special_datasets_read_as_h5py_does(files, name):
    with h5py.File(files["earliest"]) as a, \
            _hdf5.File(files["earliest"]) as b:
        _compare(a[name], b[name], name)
        assert b[name].shape == a[name].shape


def test_attributes_of_every_kind(files):
    with h5py.File(files["earliest"]) as a, \
            _hdf5.File(files["earliest"]) as b:
        _compare(a["a/b/c"], b["a/b/c"], "a/b/c")
        assert b["a/b/c"].attrs["vs"] == "hello"
        assert list(b["a/b/c"].attrs["vsl"]) == ["x", "yy", "zzz"]
        assert b["a/b/c"].attrs["b"] is np.True_
        assert b.attrs["top"] == "root attr"
        assert b["a"].attrs.get("missing", 7) == 7


def test_header_continuation_block(files):
    """60 attributes overflow the first header chunk: the reader follows
    the continuation message (the raw first chunk holds one)."""
    with _hdf5.File(files["earliest"]) as b, \
            h5py.File(files["earliest"]) as a:
        f, addr = b._f, b["long"]._addr
        q, end, types = addr + 16, addr + 16 + f.u(addr + 8, 4), []
        while q + 8 <= end:
            types.append(f.u(q, 2))
            q += 8 + f.u(q + 2, 2)
        assert 0x10 in types
        _compare(a["long"], b["long"], "long")
        assert len(b["long"].attrs) == 60


def test_group_whose_btree_splits(files):
    with _hdf5.File(files["earliest"]) as b, \
            h5py.File(files["earliest"]) as a:
        many = b["many"]
        f = b._f
        (btree,) = [f.addr(p) for t, _, p, _ in f.messages(many._addr)
                    if t == 0x11]
        assert f.view[btree + 5] >= 1             # an internal B-tree node
        assert len(many) == 200
        _compare(a["many"], many, "many")


def test_whole_file_and_visit_order(files):
    with h5py.File(files["earliest"]) as a, \
            _hdf5.File(files["earliest"]) as b:
        _compare(a, b)
        va, vb = [], []
        a.visititems(lambda n, o: va.append(n))
        b.visititems(lambda n, o: vb.append(n))
        assert va == vb
        assert b.visititems(lambda n, o: n if n.endswith("x") else None) \
            == a.visititems(lambda n, o: n if n.endswith("x") else None)


def test_latest_layout_compact_links_and_attributes(files):
    """superblock 3, version-2 object headers, compact link messages."""
    with h5py.File(files["latest"]) as a, _hdf5.File(files["latest"]) as b:
        assert b._f.view[8] in (2, 3)
        assert bytes(b._f.view[b._addr:b._addr + 4]) == b"OHDR"
        _compare(a, b)


def _unsupported(tmp_path, kind):
    path = tmp_path / f"{kind}.h5"
    with h5py.File(path, "w", libver="latest" if kind.startswith("dense")
                   else "earliest") as f:
        if kind == "chunked":
            f.create_dataset("x", data=np.ones((8, 8)), chunks=(4, 4))
        elif kind == "gzip":
            f.create_dataset("x", data=np.ones((8, 8)), compression="gzip")
        elif kind == "dense_links":
            for i in range(20):
                f[f"k{i}"] = np.ones(2)
        elif kind == "dense_attrs":
            f["x"] = np.ones(2)
            for i in range(20):
                f["x"].attrs[f"a{i}"] = i
        elif kind == "soft_link":
            f["x"] = np.ones(2)
            f["y"] = h5py.SoftLink("/x")
        elif kind == "compound":
            f["x"] = np.zeros(3, dtype=[("a", "<f4"), ("b", "<i4")])
    return path


@pytest.mark.parametrize("kind,feature", [
    ("chunked", "chunked"), ("gzip", "filter"),
    ("dense_links", "dense link storage"),
    ("dense_attrs", "dense attribute storage"), ("soft_link", "soft link"),
    ("compound", "compound")])
def test_what_is_left_out_raises_and_names_it(tmp_path, kind, feature):
    with _hdf5.File(_unsupported(tmp_path, kind)) as f:
        with pytest.raises(NotImplementedError, match=feature):
            obj = f["x"] if kind not in ("dense_links", "soft_link") else f
            obj.keys() if kind in ("dense_links", "soft_link") else (
                obj.attrs.keys() if kind == "dense_attrs" else obj[()])


def test_sources_and_views(files):
    """A path is memory-mapped and arrays are views of the map (read-only,
    no copy); bytes read the same."""
    raw = files["earliest"].read_bytes()
    with _hdf5.File(files["earliest"]) as f:
        arr = np.asarray(f["data/d_lef4"])
        assert not arr.flags.writeable and not arr.flags.owndata
        assert isinstance(f._f.buf, mmap.mmap)
        want = arr.copy()
    np.testing.assert_array_equal(arr, want)       # alive past close
    with _hdf5.File(raw) as g:
        np.testing.assert_array_equal(g["data/d_lef4"][()], want)
    with pytest.raises(ValueError, match="not an HDF5"):
        _hdf5.File(b"\0" * 64)


def _keras_models(tmp_path):
    import contextlib
    tf = pytest.importorskip("tensorflow")
    with contextlib.suppress(RuntimeError):       # two threads, as torch's
        tf.config.threading.set_intra_op_parallelism_threads(2)
        tf.config.threading.set_inter_op_parallelism_threads(2)
    keras = tf.keras
    seq = keras.Sequential([
        keras.layers.Input((8, 8, 2)),
        keras.layers.Conv2D(4, 3, padding="same", activation="relu"),
        keras.layers.BatchNormalization(),
        keras.layers.Flatten(),
        keras.layers.Dense(3, activation="softmax")])
    seq.compile(loss="categorical_crossentropy", optimizer="sgd")
    inp = keras.layers.Input((8,))
    a = keras.layers.Dense(8, activation="relu")(inp)
    b = keras.layers.Dense(8, activation="tanh")(inp)
    func = keras.Model(inp, keras.layers.Dense(3)(
        keras.layers.Add()([a, b])))
    paths = []
    for name, m in (("seq", seq), ("func", func)):
        for ext in ("h5", "keras"):
            p = tmp_path / f"{name}.{ext}"
            m.save(p)
            paths.append(p)
    return paths


def test_keras_written_files_read_as_h5py_does(tmp_path):
    import zipfile
    for p in _keras_models(tmp_path):
        if p.suffix == ".keras":
            with zipfile.ZipFile(p) as zf:
                raw = zf.read("model.weights.h5")
            p = p.with_suffix(".weights.h5")
            p.write_bytes(raw)
        with h5py.File(p) as a, _hdf5.File(p) as b:
            _compare(a, b)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_h5", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_writer_reads_back_in_h5py_and_the_reader(tmp_path):
    cs = _chip_smoke()
    rng = np.random.default_rng(1)
    leaves = {f"g{i:03d}": cs.H5Group(
        {"weight_names": [f"g{i:03d}/w"], "note": "é" * i},
        {"w": rng.standard_normal((i % 5 + 1, 3)).astype(np.float32)})
        for i in range(300)}
    root = cs.H5Group(
        {"model_config": '{"a": 1}' * 20000, "backend": "tensorflow",
         "num": np.float64(2.5), "arr": np.arange(6).reshape(2, 3),
         "names": ["x", "yy"], "none": []},
        {"model_weights": cs.H5Group({"layer_names": sorted(leaves)},
                                     leaves),
         "x": np.arange(10, dtype=np.float64), "e": np.zeros(0, np.float32),
         "s": np.float32(3.5), "h": np.ones((2, 2), np.float16),
         "i": np.arange(4, dtype=np.int32)})
    path = tmp_path / "w.h5"
    cs.write_h5(path, root)
    with h5py.File(path) as a, _hdf5.File(path) as b:
        _compare(a, b)
        assert a.attrs["backend"] == "tensorflow"
        assert len(a.attrs["model_config"]) == 160000
        assert list(a["model_weights"].attrs["layer_names"]) == \
            sorted(leaves)
        assert len(a["model_weights"]) == 300
        for name in ("g000", "g123", "g299"):
            np.testing.assert_array_equal(
                a[f"model_weights/{name}/w"][()],
                leaves[name].members["w"])
            assert a[f"model_weights/{name}"].attrs["note"] == \
                leaves[name].attrs["note"]
        assert a["s"][()] == np.float32(3.5) and a["e"].shape == (0,)


def test_chip_smoke_keras_resnet50_file_reads_back(tmp_path):
    """The phase-20 ResNet50 file (here at 64×64): h5py and the reader
    agree on every attribute and array; its layout is Keras's."""
    import json
    cs = _chip_smoke()
    path = tmp_path / "r50.h5"
    cfg = cs.write_keras_resnet50(path, hw=64)
    with h5py.File(path) as a, _hdf5.File(path) as b:
        _compare(a, b)
        assert json.loads(a.attrs["model_config"]) == cfg
        names = list(a["model_weights"].attrs["layer_names"])
        assert len(names) == 177
        assert list(a["model_weights/conv1_bn"].attrs["weight_names"]) == [
            "conv1_bn/gamma", "conv1_bn/beta", "conv1_bn/moving_mean",
            "conv1_bn/moving_variance"]
        assert (a["model_weights/conv1_bn/conv1_bn/moving_variance"][()]
                > 0).all()
        assert a["model_weights/predictions/predictions/kernel"].shape == \
            (2048, 1000)
