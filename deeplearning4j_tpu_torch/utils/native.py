"""ctypes bindings for the repository's native runtime — port of
``deeplearning4j_tpu/utils/native.py`` over the same C++ source,
``native/dl4j_tpu_native.cpp``: the SPSC byte ring under
``AsyncDataSetIterator`` (:class:`NativeRing`), the staging arena
(:class:`StagingArena`), the threshold gradient codec, the csv and npy
parsers and ``f32_to_bf16``.

The library is built from that source on first use with ``g++`` and the
flags of ``native/Makefile`` into ``build/dl4j_torch_native/`` beside the
package (``$DL4J_TORCH_BUILD_DIR`` overrides the ``build/`` part), named
by a hash of the source, the flags and the host CPU (``-march=native``),
so a build is never loaded on a host it was not built for. Nothing
prebuilt is loaded. Where ``g++`` or the build is missing every caller
has the reference's pure-Python fallback (same results, slower);
:func:`has_native` says which ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

_REPO = Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "native" / "dl4j_tpu_native.cpp"
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-march=native", "-Wall", "-shared"]
_lock = threading.Lock()
_lib = None
_tried = False


def _build_dir() -> Path:
    env = os.environ.get("DL4J_TORCH_BUILD_DIR")
    base = Path(env) if env else _REPO / "build"
    return base / "dl4j_torch_native"


def _host_key() -> bytes:
    """The host CPU's feature flags (what ``-march=native`` compiles for)."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return b""
    m = re.search(r"^(flags|Features)\s*:(.*)$", text, re.M)
    return m.group(2).encode() if m else b""


def lib_path() -> Path:
    h = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_FLAGS).encode()
                       + _host_key()).hexdigest()[:16]
    return _build_dir() / f"libdl4j_tpu_native-{h}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SOURCE)],
                   check=True, capture_output=True, timeout=300)
    os.replace(tmp, path)


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on first use (None where it cannot be)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path = lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except Exception:  # noqa: BLE001 — the pure-Python paths take over
            return None
        _bind(lib)
        _lib = lib
        return _lib


def _bind(lib):
    c = ctypes
    lib.ring_create.restype = c.c_void_p
    lib.ring_create.argtypes = [c.c_uint64, c.c_uint64]
    lib.ring_destroy.argtypes = [c.c_void_p]
    lib.ring_push.restype = c.c_int
    lib.ring_push.argtypes = [c.c_void_p, c.c_void_p, c.c_uint64]
    lib.ring_pop.restype = c.c_int64
    lib.ring_pop.argtypes = [c.c_void_p, c.c_void_p, c.c_uint64]
    lib.ring_size.restype = c.c_uint64
    lib.ring_size.argtypes = [c.c_void_p]
    lib.threshold_encode.restype = c.c_int64
    lib.threshold_encode.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                     c.c_float, c.c_void_p, c.c_int64]
    lib.threshold_decode.argtypes = [c.c_void_p, c.c_int64, c.c_float,
                                     c.c_void_p, c.c_int64]
    lib.parse_csv_floats.restype = c.c_int64
    lib.parse_csv_floats.argtypes = [c.c_char_p, c.c_int64, c.c_void_p,
                                     c.c_int64]
    lib.f32_to_bf16.argtypes = [c.c_void_p, c.c_void_p, c.c_int64]
    lib.arena_create.restype = c.c_void_p
    lib.arena_create.argtypes = [c.c_uint64, c.c_uint64]
    lib.arena_destroy.argtypes = [c.c_void_p]
    lib.arena_alloc.restype = c.c_void_p
    lib.arena_alloc.argtypes = [c.c_void_p]
    lib.arena_free.restype = c.c_int
    lib.arena_free.argtypes = [c.c_void_p, c.c_void_p]
    for fn in ("arena_block_size", "arena_in_use", "arena_peak"):
        getattr(lib, fn).restype = c.c_uint64
        getattr(lib, fn).argtypes = [c.c_void_p]
    lib.npy_parse_header.restype = c.c_int
    lib.npy_parse_header.argtypes = [c.c_char_p, c.c_int64] + \
        [c.c_void_p] * 6
    lib.parse_csv_matrix.restype = c.c_int64
    lib.parse_csv_matrix.argtypes = [c.c_char_p, c.c_int64, c.c_int64,
                                     c.c_void_p, c.c_int64]


def has_native() -> bool:
    return load() is not None


class NativeRing:
    """SPSC ring of byte slots (AsyncDataSetIterator's backing store)."""

    def __init__(self, slot_size: int, n_slots: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native lib unavailable")
        self._lib = lib
        self._ptr = lib.ring_create(slot_size, n_slots)
        if not self._ptr:
            raise MemoryError("ring_create failed")
        self.slot_size = slot_size

    def push(self, payload) -> bool:
        """Copy ``payload`` (bytes, or a uint8 numpy array) into a free
        slot, the GIL released; False when the ring is full."""
        buf = payload if isinstance(payload, np.ndarray) else \
            np.frombuffer(payload, np.uint8)
        rc = self._lib.ring_push(self._ptr, buf.ctypes.data, buf.nbytes)
        if rc == -1:
            raise ValueError(f"payload {buf.nbytes} > slot {self.slot_size}")
        return rc == 1

    def pop_into(self, out: np.ndarray) -> int:
        """Copy the oldest payload into the uint8 array ``out`` (the GIL
        released); its size, or 0 when the ring is empty."""
        n = self._lib.ring_pop(self._ptr, out.ctypes.data, out.nbytes)
        if n < 0:
            raise ValueError(f"payload > out ({out.nbytes} bytes)")
        return int(n)

    def pop_array(self) -> Optional[np.ndarray]:
        """The oldest payload as a uint8 array (a view of a fresh
        slot-sized buffer whose untouched pages are never made resident),
        or None when empty."""
        buf = np.empty(self.slot_size, np.uint8)
        n = self.pop_into(buf)
        return buf[:n] if n else None

    def pop(self) -> Optional[bytes]:
        out = self.pop_array()
        return None if out is None else out.tobytes()

    def __len__(self):
        return int(self._lib.ring_size(self._ptr))

    def close(self):
        if self._ptr:
            self._lib.ring_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def threshold_encode(grad: np.ndarray, residual: np.ndarray, threshold: float,
                     max_out: Optional[int] = None):
    """int64 tokens (index << 1 | negative) of the entries of
    ``grad + residual`` at or past ±threshold; ``residual`` keeps the rest,
    updated in place (error feedback)."""
    g = np.ascontiguousarray(grad, np.float32).ravel()
    assert residual.dtype == np.float32 and residual.size == g.size
    cap = max_out or g.size
    lib = load()
    if lib is not None:
        out = np.empty(cap, np.int64)
        n = lib.threshold_encode(
            g.ctypes.data, residual.ctypes.data, g.size,
            ctypes.c_float(threshold), out.ctypes.data, cap)
        return out[:n]
    acc = g + residual
    pos = acc >= threshold
    neg = acc <= -threshold
    idx = np.nonzero(pos | neg)[0][:cap]
    sel_pos = pos[idx]
    residual[:] = acc
    residual[idx[sel_pos]] -= threshold
    residual[idx[~sel_pos]] += threshold
    return (idx.astype(np.int64) << 1) | (~sel_pos).astype(np.int64)


def threshold_decode(tokens: np.ndarray, threshold: float, n: int) -> np.ndarray:
    out = np.zeros(n, np.float32)
    lib = load()
    if lib is not None and tokens.size:
        t = np.ascontiguousarray(tokens, np.int64)
        lib.threshold_decode(t.ctypes.data, t.size,
                             ctypes.c_float(threshold), out.ctypes.data, n)
        return out
    if tokens.size:
        idx = tokens >> 1
        sign = np.where((tokens & 1) == 1, -1.0, 1.0).astype(np.float32)
        np.add.at(out, idx, sign * threshold)
    return out


def parse_csv_floats(text: bytes, max_out: int) -> np.ndarray:
    lib = load()
    if lib is not None:
        out = np.empty(max_out, np.float32)
        n = lib.parse_csv_floats(text, len(text), out.ctypes.data, max_out)
        return out[:n]
    vals = re.split(rb"[,\s;]+", text.strip())
    return np.asarray([float(v) for v in vals if v], np.float32)[:max_out]


class _ArenaBlock(np.ndarray):
    """ndarray view over an arena block; holds a reference to its arena so
    the slab can never be freed (GC or close) while a view is reachable."""
    _arena = None


class StagingArena:
    """Host staging allocator: page-aligned fixed-size blocks, LIFO
    freelist, no malloc churn in a steady input pipeline. ``borrow()``
    yields a uint8 numpy view over a block (None when exhausted);
    ``release()`` returns it (double release and foreign blocks are
    refused). Plain numpy blocks where the native library is absent (same
    API, no reuse guarantee)."""

    def __init__(self, block_size: int, n_blocks: int):
        self._lib = load()
        self._ptr = None
        self._fallback: list = []
        self._fallback_peak = 0
        self.n_blocks = n_blocks
        if self._lib is not None:
            self._ptr = self._lib.arena_create(block_size, n_blocks)
            if not self._ptr:
                raise MemoryError("arena_create failed")
            self.block_size = int(self._lib.arena_block_size(self._ptr))
        else:
            self.block_size = block_size

    def borrow(self) -> Optional[np.ndarray]:
        """A uint8 view over one block, or None if the arena is exhausted.
        Pass the SAME array (not a slice) back to release()."""
        if self._ptr:
            p = self._lib.arena_alloc(self._ptr)
            if not p:
                return None
            raw = np.ctypeslib.as_array(
                ctypes.cast(p, ctypes.POINTER(ctypes.c_uint8)),
                shape=(self.block_size,))
            block = raw.view(_ArenaBlock)
            block._arena = self
            return block
        if len(self._fallback) >= self.n_blocks:
            return None
        buf = np.zeros(self.block_size, np.uint8)
        self._fallback.append(buf)
        self._fallback_peak = max(self._fallback_peak, len(self._fallback))
        return buf

    def release(self, block: np.ndarray) -> None:
        if self._ptr:
            if not self._lib.arena_free(self._ptr, block.ctypes.data):
                raise ValueError(
                    "block does not belong to this arena (or was already "
                    "released, or is a slice rather than the borrowed array)")
        else:
            kept = [b for b in self._fallback if b is not block]
            if len(kept) == len(self._fallback):
                raise ValueError(
                    "block does not belong to this arena (or was already "
                    "released)")
            self._fallback = kept

    @property
    def in_use(self) -> int:
        return int(self._lib.arena_in_use(self._ptr)) if self._ptr \
            else len(self._fallback)

    @property
    def peak(self) -> int:
        return int(self._lib.arena_peak(self._ptr)) if self._ptr \
            else self._fallback_peak

    def close(self, force: bool = False):
        """Free the slab; refused while blocks are out unless ``force``."""
        if self._ptr:
            if not force and int(self._lib.arena_in_use(self._ptr)):
                raise RuntimeError(
                    f"{self.in_use} block(s) still borrowed; release them "
                    f"first or close(force=True)")
            self._lib.arena_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close(force=True)
        except Exception:  # noqa: BLE001
            pass


def npy_header(buf: bytes):
    """(shape, dtype, data_offset, fortran) of a .npy v1/v2 header;
    numpy's own parser where the native one declines."""
    lib = load()
    if lib is not None:
        shape = np.zeros(8, np.int64)
        ndim = ctypes.c_int32()
        dch = ctypes.c_char()
        isz = ctypes.c_int32()
        off = ctypes.c_int64()
        fortran = ctypes.c_int32()
        rc = lib.npy_parse_header(
            buf, len(buf), shape.ctypes.data, ctypes.byref(ndim),
            ctypes.byref(dch), ctypes.byref(isz), ctypes.byref(off),
            ctypes.byref(fortran))
        if rc == 0:
            dtype = np.dtype(f"{dch.value.decode()}{isz.value}")
            return (tuple(int(s) for s in shape[:ndim.value]), dtype,
                    int(off.value), bool(fortran.value))
    import io
    from numpy.lib import format as npf
    f = io.BytesIO(buf)
    version = npf.read_magic(f)
    shape, fortran, dtype = npf._read_array_header(f, version)
    return shape, dtype, f.tell(), fortran


def load_npy(buf: bytes) -> np.ndarray:
    """bytes of a .npy file → ndarray (zero-copy view onto ``buf``)."""
    shape, dtype, off, fortran = npy_header(buf)
    n = int(np.prod(shape)) if shape else 1
    arr = np.frombuffer(buf, dtype=dtype, count=n, offset=off)
    return arr.reshape(shape, order="F" if fortran else "C")


def parse_csv_matrix(text: bytes, n_cols: int,
                     max_rows: Optional[int] = None) -> np.ndarray:
    """CSV text → (rows, n_cols) f32; rows of another width (headers,
    blanks) are skipped."""
    cap = max_rows if max_rows is not None else text.count(b"\n") + 1
    lib = load()
    if lib is not None:
        out = np.empty((cap, n_cols), np.float32)
        n = lib.parse_csv_matrix(text, len(text), n_cols,
                                 out.ctypes.data, cap)
        return out[:n].copy()
    rows = []
    for line in text.splitlines():
        parts = [p for p in re.split(rb"[,;\t ]+", line.strip()) if p]
        if len(parts) != n_cols:
            continue
        try:
            rows.append([float(p) for p in parts])
        except ValueError:
            continue
        if len(rows) >= cap:
            break
    return np.asarray(rows, np.float32).reshape(-1, n_cols)


def f32_to_bf16(arr) -> torch.Tensor:
    """Round-to-nearest-even bf16 of a float32 array, as a host
    ``torch.bfloat16`` tensor of its shape."""
    a = np.ascontiguousarray(arr, np.float32)
    lib = load()
    out = np.empty(a.size, np.uint16)
    if lib is not None:
        lib.f32_to_bf16(a.ctypes.data, out.ctypes.data, a.size)
    else:
        bits = a.view(np.uint32).ravel()
        lsb = (bits >> 16) & 1
        out = ((bits + 0x7FFF + lsb) >> 16).astype(np.uint16)
    return torch.from_numpy(out.view(np.int16).reshape(a.shape)).view(
        torch.bfloat16)
