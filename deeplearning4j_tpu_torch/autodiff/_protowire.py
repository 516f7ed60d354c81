"""A protobuf wire-format reader (the port's own copy of the reader in
``deeplearning4j_tpu/autodiff/onnx_import.py:34-146``).

Neither ``protobuf`` nor TensorFlow is needed: a message is decoded into
its raw fields (field number → list of values), and the typed accessors
read them as the schema says. The TF GraphDef importer reads with it;
wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple


def read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


class Msg:
    """Decoded protobuf message: field number → list of raw values."""

    __slots__ = ("fields",)

    def __init__(self, buf: bytes):
        self.fields: Dict[int, List[Any]] = {}
        buf = memoryview(buf) if not isinstance(buf, memoryview) else buf
        i, n = 0, len(buf)
        while i < n:
            key, i = read_varint(buf, i)
            fnum, wtype = key >> 3, key & 7
            if wtype == 0:
                v, i = read_varint(buf, i)
            elif wtype == 1:
                v = struct.unpack_from("<q", buf, i)[0]
                i += 8
            elif wtype == 2:
                ln, i = read_varint(buf, i)
                v = buf[i:i + ln]
                i += ln
            elif wtype == 5:
                v = struct.unpack_from("<i", buf, i)[0]
                i += 4
            else:
                raise ValueError(f"unsupported wire type {wtype}")
            self.fields.setdefault(fnum, []).append(v)

    # -- typed accessors ----------------------------------------------------
    def ints(self, f) -> List[int]:
        """Repeated (packed or not) varints as signed 64-bit ints."""
        out = []
        for v in self.fields.get(f, []):
            if isinstance(v, memoryview):      # packed repeated varint
                i = 0
                while i < len(v):
                    x, i = read_varint(v, i)
                    out.append(x)
            else:
                out.append(v)
        return [x - (1 << 64) if x >= (1 << 63) else x for x in out]

    def uints(self, f) -> List[int]:
        """Repeated varints as unsigned ints."""
        return [x + (1 << 64) if x < 0 else x for x in self.ints(f)]

    def int(self, f, default=0) -> int:
        vals = self.ints(f)
        return vals[-1] if vals else default

    def floats(self, f) -> List[float]:
        out = []
        for v in self.fields.get(f, []):
            if isinstance(v, memoryview):      # packed repeated fixed32
                out.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:                              # fixed32 read as int
                out.append(struct.unpack("<f", struct.pack("<i", v))[0])
        return out

    def doubles(self, f) -> List[float]:
        out = []
        for v in self.fields.get(f, []):
            if isinstance(v, memoryview):      # packed repeated fixed64
                out.extend(struct.unpack(f"<{len(v) // 8}d", v))
            else:                              # fixed64 read as int (<q)
                out.append(struct.unpack("<d", struct.pack("<q", v))[0])
        return out

    def float(self, f, default=0.0) -> float:
        vals = self.floats(f)
        return vals[-1] if vals else default

    def bytes_(self, f, default=b"") -> bytes:
        vals = self.fields.get(f, [])
        return bytes(vals[-1]) if vals else default

    def raw(self, f):
        """A length-delimited field's bytes without a copy (or None)."""
        vals = self.fields.get(f, [])
        return vals[-1] if vals else None

    def str_(self, f, default="") -> str:
        return self.bytes_(f).decode("utf-8") if f in self.fields else default

    def strs(self, f) -> List[str]:
        return [bytes(v).decode("utf-8") for v in self.fields.get(f, [])]

    def bytes_list(self, f) -> List[bytes]:
        return [bytes(v) for v in self.fields.get(f, [])]

    def msg(self, f) -> Optional["Msg"]:
        vals = self.fields.get(f, [])
        return Msg(vals[-1]) if vals else None

    def msgs(self, f) -> List["Msg"]:
        return [Msg(v) for v in self.fields.get(f, [])]
