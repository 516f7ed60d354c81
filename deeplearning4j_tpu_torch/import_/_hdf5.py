"""A read-only HDF5 reader over numpy and ``mmap`` (the port's counterpart
of the ``h5py`` calls in ``deeplearning4j_tpu/import_/keras.py:527-652``).

The Keras importer needs the file layouts that h5py and Keras write, and
nothing else; neither h5py nor the HDF5 library is used. What is read:

- superblock versions 0, 1, 2 and 3;
- object headers of versions 1 and 2, with their continuation blocks;
- groups: symbol tables (version-1 B-tree group nodes over symbol table
  nodes, names in a local heap) and compact link messages;
- dataspaces (scalar, simple, null); datatypes: little- and big-endian
  integers, IEEE f16/f32/f64, enums (h5py's bool), fixed-length strings
  and variable-length strings (read from the global heap);
- contiguous and compact data layouts;
- attributes stored as messages of the object header.

Arrays come out as ``np.frombuffer`` views of the map, never element by
element. Anything else (chunked or filtered datasets, dense attribute or
link storage in a fractal heap, virtual datasets, external files, shared
or committed datatypes, compound, array, reference or variable-length
sequence types, soft or external links) raises ``NotImplementedError``
naming the feature.

The surface is a small subset of h5py's: :class:`File` / :class:`Group`
(``attrs``, ``keys``, ``__getitem__`` with ``/`` paths, ``__contains__``,
``get``, ``visititems``) and :class:`Dataset` (``shape``, ``dtype``,
``[()]``, ``np.asarray``). Attribute values follow h5py:
a variable-length string is a ``str`` (an array of them an object array
of ``str``), a fixed-length one ``bytes``, a numeric scalar a numpy
scalar; a dataset of variable-length strings reads as ``bytes``.
"""

from __future__ import annotations

import mmap
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x00, 0x01, 0x02, 0x03
_EXTERNAL, _LAYOUT, _FILTERS, _ATTRIBUTE = 0x07, 0x08, 0x0B, 0x0C
_LINK, _CONTINUATION, _SYMBOL_TABLE = 0x06, 0x10, 0x11
_ATTRIBUTE_INFO = 0x15


def _unsupported(feature: str):
    return NotImplementedError(
        f"HDF5 feature not supported by the port's reader: {feature}")


class _Type:
    """A parsed datatype: ``kind`` is "num" (``dtype`` a numpy dtype),
    "bool" (an enum FALSE/TRUE over ``dtype``), "str" (fixed-length,
    ``dtype`` 'S<n>') or "vlen_str" (16 bytes a value in the file: a
    global heap reference)."""

    __slots__ = ("kind", "dtype", "size")

    def __init__(self, kind, dtype, size):
        self.kind, self.dtype, self.size = kind, dtype, size


class _Space:
    __slots__ = ("shape", "null")

    def __init__(self, shape, null=False):
        self.shape, self.null = shape, null


class _File:
    """The open file: the buffer, the address widths, a cache of parsed
    object headers and global heap collections."""

    def __init__(self, buf, closer):
        self.buf = buf
        self.view = memoryview(buf)
        self._closer = closer
        self.headers: Dict[int, List[Tuple[int, int, int, int]]] = {}
        self.heaps: Dict[int, Dict[int, bytes]] = {}
        base = self._find_superblock()
        self._superblock(base)

    # ------------------------------------------------------------- scalars
    def u(self, pos, n):
        return int.from_bytes(self.view[pos:pos + n], "little")

    def addr(self, pos):
        """An address (``size_of_offsets`` bytes) at ``pos``, relative to
        the base address; None for the undefined address."""
        v = self.u(pos, self.so)
        if v == (1 << (8 * self.so)) - 1:
            return None
        return v + self.base

    # ----------------------------------------------------------- superblock
    def _find_superblock(self):
        pos = 0
        while pos + 8 <= len(self.buf):
            if bytes(self.view[pos:pos + 8]) == _SIGNATURE:
                return pos
            pos = 512 if pos == 0 else pos * 2
        raise ValueError("not an HDF5 file (no superblock signature)")

    def _superblock(self, at):
        version = self.view[at + 8]
        self.base = 0
        if version in (0, 1):
            self.so, self.sl = self.view[at + 13], self.view[at + 14]
            p = at + 24 + (4 if version == 1 else 0)
            self.base = self.u(p, self.so)
            # base, free-space info, end of file, driver info, then the
            # root group's symbol table entry
            entry = p + 4 * self.so
            self.root = self.addr(entry + self.so)
        elif version in (2, 3):
            self.so, self.sl = self.view[at + 9], self.view[at + 10]
            p = at + 12
            self.base = self.u(p, self.so)
            self.root = self.addr(p + 3 * self.so)
        else:
            raise _unsupported(f"superblock version {version}")

    # ------------------------------------------------------- object headers
    def messages(self, addr) -> List[Tuple[int, int, int, int]]:
        """[(type, flags, data offset, size)] of the object header at
        ``addr``, continuation blocks followed."""
        got = self.headers.get(addr)
        if got is None:
            got = self.headers[addr] = self._read_header(addr)
        return got

    def _read_header(self, addr):
        v = self.view
        out: List[Tuple[int, int, int, int]] = []
        if bytes(v[addr:addr + 4]) == b"OHDR":
            version, flags = v[addr + 4], v[addr + 5]
            if version != 2:
                raise _unsupported(f"object header version {version}")
            p = addr + 6
            if flags & 0x20:
                p += 16
            if flags & 0x10:
                p += 4
            width = 1 << (flags & 3)
            size = self.u(p, width)
            p += width
            blocks = [(p, p + size)]
            tracked = bool(flags & 0x04)
            while blocks:
                start, end = blocks.pop(0)
                q = start
                hdr = 6 if tracked else 4
                while q + hdr <= end:
                    mtype, msize, mflags = v[q], self.u(q + 1, 2), v[q + 3]
                    q += hdr
                    if mtype == _CONTINUATION:
                        c = self.addr(q)
                        clen = self.u(q + self.so, self.sl)
                        if bytes(v[c:c + 4]) != b"OCHK":
                            raise ValueError("bad object header "
                                             "continuation block")
                        blocks.append((c + 4, c + clen - 4))
                    elif mtype != _NIL:
                        out.append((mtype, mflags, q, msize))
                    q += msize
            return out
        version = v[addr]
        if version != 1:
            raise _unsupported(f"object header version {version}")
        nmsgs = self.u(addr + 2, 2)
        size = self.u(addr + 8, 4)
        blocks = [(addr + 16, addr + 16 + size)]
        seen = 0
        while blocks and seen < nmsgs:
            start, end = blocks.pop(0)
            q = start
            while q + 8 <= end and seen < nmsgs:
                mtype, msize, mflags = self.u(q, 2), self.u(q + 2, 2), v[q + 4]
                q += 8
                seen += 1
                if mtype == _CONTINUATION:
                    c = self.addr(q)
                    clen = self.u(q + self.so, self.sl)
                    blocks.append((c, c + clen))
                elif mtype != _NIL:
                    out.append((mtype, mflags, q, msize))
                q += msize
        return out

    # ------------------------------------------------------------ datatypes
    def datatype(self, p) -> _Type:
        v = self.view
        cls, version = v[p] & 0x0F, v[p] >> 4
        bits = self.u(p + 1, 3)
        size = self.u(p + 4, 4)
        props = p + 8
        if cls == 0:                                   # fixed-point
            if size not in (1, 2, 4, 8):
                raise _unsupported(f"{size}-byte integer")
            order = ">" if bits & 1 else "<"
            return _Type("num", np.dtype(
                f"{order}{'i' if bits & 0x08 else 'u'}{size}"), size)
        if cls == 1:                                   # floating-point
            if bits & 0x40 or size not in (2, 4, 8):
                raise _unsupported(f"{size}-byte or VAX float")
            return _Type("num", np.dtype(
                f"{'>' if bits & 1 else '<'}f{size}"), size)
        if cls == 3:                                   # fixed-length string
            return _Type("str", np.dtype(f"S{size}"), size)
        if cls == 8:                                   # enumeration
            base = self.datatype(props)
            if base.kind != "num" or base.dtype.kind not in "iu":
                raise _unsupported("enum over a non-integer type")
            n = bits & 0xFFFF
            q = props + self._datatype_size(props)
            names = []
            for _ in range(n):
                end = bytes(v[q:q + 256]).index(b"\0")
                names.append(bytes(v[q:q + end]).decode())
                q += end + 1 if version >= 3 else (end + 8) // 8 * 8
            if sorted(names) == ["FALSE", "TRUE"]:
                return _Type("bool", base.dtype, size)
            return _Type("num", base.dtype, size)
        if cls == 9:                                   # variable-length
            if bits & 0x0F != 1:
                raise _unsupported("variable-length sequence datatype")
            return _Type("vlen_str", None, size)
        names = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 10: "array", 11: "complex"}
        raise _unsupported(f"{names.get(cls, cls)} datatype")

    def _datatype_size(self, p) -> int:
        """Bytes of the datatype message at ``p`` (for an enum's base)."""
        cls = self.view[p] & 0x0F
        return 8 + {0: 4, 1: 12}.get(cls, 0)

    def dataspace(self, p) -> _Space:
        v = self.view
        version, rank, flags = v[p], v[p + 1], v[p + 2]
        if version == 1:
            q = p + 8
            null = False
        elif version == 2:
            q = p + 4
            null = v[p + 3] == 2
        else:
            raise _unsupported(f"dataspace version {version}")
        shape = tuple(self.u(q + i * self.sl, self.sl) for i in range(rank))
        return _Space(shape, null)

    # ---------------------------------------------------------- global heap
    def heap_object(self, ref_pos) -> bytes:
        """The global heap object a variable-length value at ``ref_pos``
        (length, collection address, index) names."""
        n = self.u(ref_pos, 4)
        coll = self.addr(ref_pos + 4)
        idx = self.u(ref_pos + 4 + self.so, 4)
        if coll is None or n == 0:
            return b""
        objs = self.heaps.get(coll)
        if objs is None:
            objs = self.heaps[coll] = self._collection(coll)
        return objs[idx][:n]

    def _collection(self, addr):
        v = self.view
        if bytes(v[addr:addr + 4]) != b"GCOL":
            raise ValueError("bad global heap collection")
        size = self.u(addr + 8, self.sl)
        end = addr + size
        q = addr + 8 + self.sl
        objs = {}
        while q + 8 + self.sl <= end:
            idx = self.u(q, 2)
            osize = self.u(q + 8, self.sl)
            if idx == 0:
                break
            data = q + 8 + self.sl
            objs[idx] = bytes(v[data:data + osize])
            q = data + (osize + 7) // 8 * 8
        return objs

    # ---------------------------------------------------------------- values
    def values(self, t: _Type, space: _Space, data_pos, *, attr: bool):
        """The values of ``space`` elements of type ``t`` stored at
        ``data_pos`` (None: never written; zeros, h5py's fill value)."""
        if space.null:
            return None
        count = int(np.prod(space.shape, dtype=np.int64))
        if t.kind == "vlen_str":
            items = [b"" if data_pos is None else
                     self.heap_object(data_pos + i * t.size)
                     for i in range(count)]
            if attr:
                items = [s.decode("utf-8") for s in items]
            arr = np.empty(count, dtype=object)
            arr[:] = items
            out = arr.reshape(space.shape)
        elif data_pos is None:
            out = np.zeros(space.shape, t.dtype)
        else:
            out = np.frombuffer(self.buf, dtype=t.dtype, count=count,
                                offset=data_pos).reshape(space.shape)
        if t.kind == "bool":
            out = out.astype(np.bool_)
        if space.shape == () and attr:
            return out[()]
        return out

    def close(self):
        self.view.release()
        if self._closer is not None:
            try:
                self._closer()
            except BufferError:
                # an array read from the map is still alive: the map is
                # unmapped when the last such view is freed
                pass
            self._closer = None


def _attr_messages(f: _File, addr) -> Dict[str, Tuple[_Type, _Space, int]]:
    out = {}
    v = f.view
    for mtype, mflags, p, size in f.messages(addr):
        if mtype == _ATTRIBUTE_INFO:
            heap = f.addr(p + 2 + (2 if v[p + 1] & 1 else 0))
            if heap is not None:
                raise _unsupported("dense attribute storage (fractal heap)")
        if mtype != _ATTRIBUTE:
            continue
        version = v[p]
        if version in (1, 2) and v[p + 1] & 0x03 or \
                version == 3 and v[p + 1] & 0x03:
            raise _unsupported("shared datatype or dataspace of an attribute")
        nlen, tlen, slen = f.u(p + 2, 2), f.u(p + 4, 2), f.u(p + 6, 2)
        if version == 1:
            pad = lambda n: (n + 7) // 8 * 8          # noqa: E731
            q = p + 8
        elif version in (2, 3):
            pad = lambda n: n                         # noqa: E731
            q = p + 8 + (1 if version == 3 else 0)
        else:
            raise _unsupported(f"attribute message version {version}")
        name = bytes(v[q:q + nlen]).split(b"\0", 1)[0].decode("utf-8")
        q += pad(nlen)
        t = f.datatype(q)
        q += pad(tlen)
        space = f.dataspace(q)
        q += pad(slen)
        out[name] = (t, space, q)
    return dict(sorted(out.items()))


class AttributeManager:
    """``obj.attrs``: attribute name → value (h5py's conventions)."""

    def __init__(self, f: _File, addr):
        self._f = f
        self._msgs = _attr_messages(f, addr)

    def __getitem__(self, name):
        t, space, pos = self._msgs[name]
        return self._f.values(t, space, pos, attr=True)

    def get(self, name, default=None):
        return self[name] if name in self._msgs else default

    def __contains__(self, name):
        return name in self._msgs

    def keys(self):
        return list(self._msgs)

    def __len__(self):
        return len(self._msgs)


class _Object:
    def __init__(self, f: _File, addr, name):
        self._f, self._addr, self.name = f, addr, name
        self._attrs = None

    @property
    def attrs(self) -> AttributeManager:
        if self._attrs is None:
            self._attrs = AttributeManager(self._f, self._addr)
        return self._attrs


class Dataset(_Object):
    """A contiguous or compact dataset; its value is read on indexing
    (``ds[()]``) or ``np.asarray(ds)``."""

    def __init__(self, f, addr, name):
        super().__init__(f, addr, name)
        t = space = None
        self._layout = None
        for mtype, mflags, p, size in f.messages(addr):
            if mtype == _DATATYPE:
                if mflags & 0x02:
                    raise _unsupported("shared (committed) datatype")
                t = f.datatype(p)
            elif mtype == _DATASPACE:
                space = f.dataspace(p)
            elif mtype == _LAYOUT:
                self._layout = self._parse_layout(p)
            elif mtype == _FILTERS:
                raise _unsupported(f"filtered dataset {name!r} (filter "
                                   "pipeline)")
            elif mtype == _EXTERNAL:
                raise _unsupported(f"dataset {name!r} in external files")
        if t is None or space is None or self._layout is None:
            raise ValueError(f"{name!r}: object header is not a dataset's")
        self._type, self._space = t, space

    def _parse_layout(self, p):
        f, v = self._f, self._f.view
        version = v[p]
        if version in (3, 4):
            cls = v[p + 1]
            if cls == 0:
                return ("compact", p + 4)
            if cls == 1:
                return ("contiguous", f.addr(p + 2))
            raise _unsupported(
                {2: "chunked", 3: "virtual"}.get(cls, f"class {cls}")
                + f" data layout ({self.name!r})")
        raise _unsupported(f"data layout version {version}")

    @property
    def shape(self):
        return self._space.shape

    @property
    def dtype(self):
        t = self._type
        if t.kind == "vlen_str":
            return np.dtype(object)
        return np.dtype(np.bool_) if t.kind == "bool" else t.dtype

    def _read(self):
        return self._f.values(self._type, self._space, self._layout[1],
                              attr=False)

    def __getitem__(self, key):
        arr = self._read()
        if key == () and arr is not None and arr.ndim == 0:
            return arr[()]
        return arr if key in ((), Ellipsis) else arr[key]

    def __array__(self, dtype=None, copy=None):
        arr = self._read()
        if dtype is not None:
            arr = arr.astype(dtype)
        return np.array(arr) if copy else arr


class Group(_Object):
    """A group: its links by name (a symbol table or compact links)."""

    def __init__(self, f, addr, name):
        super().__init__(f, addr, name)
        self._links: Optional[Dict[str, int]] = None

    def _members(self) -> Dict[str, int]:
        if self._links is None:
            self._links = self._read_links()
        return self._links

    def _read_links(self):
        f, v = self._f, self._f.view
        links: Dict[str, int] = {}
        for mtype, mflags, p, size in f.messages(self._addr):
            if mtype == _SYMBOL_TABLE:
                self._symbol_table(f.addr(p), f.addr(p + f.so), links)
            elif mtype == _LINK_INFO:
                flags = v[p + 1]
                heap = f.addr(p + 2 + (8 if flags & 1 else 0))
                if heap is not None:
                    raise _unsupported("dense link storage (fractal heap) "
                                       f"of group {self.name!r}")
            elif mtype == _LINK:
                name, target = self._link(p)
                links[name] = target
        return dict(sorted(links.items(), key=lambda kv: kv[0].encode()))

    def _link(self, p):
        f, v = self._f, self._f.view
        flags = v[p + 1]
        q = p + 2
        ltype = 0
        if flags & 0x08:
            ltype = v[q]
            q += 1
        if flags & 0x04:
            q += 8
        if flags & 0x10:
            q += 1
        width = 1 << (flags & 3)
        nlen = f.u(q, width)
        q += width
        name = bytes(v[q:q + nlen]).decode("utf-8")
        q += nlen
        if ltype != 0:
            raise _unsupported(f"{'soft' if ltype == 1 else 'external'} "
                               f"link {name!r}")
        return name, f.addr(q)

    def _symbol_table(self, btree, heap, links):
        f, v = self._f, self._f.view
        if bytes(v[heap:heap + 4]) != b"HEAP":
            raise ValueError("bad local heap")
        data = f.addr(heap + 8 + 2 * f.sl)
        entry = 2 * f.so + 24
        todo = [btree]
        while todo:
            node = todo.pop()
            if bytes(v[node:node + 4]) != b"TREE" or v[node + 4] != 0:
                raise ValueError("bad group B-tree node")
            level, used = v[node + 5], f.u(node + 6, 2)
            q = node + 8 + 2 * f.so
            for i in range(used):
                child = f.addr(q + f.sl + i * (f.sl + f.so))
                if level > 0:
                    todo.append(child)
                    continue
                if bytes(v[child:child + 4]) != b"SNOD":
                    raise ValueError("bad symbol table node")
                for j in range(f.u(child + 6, 2)):
                    e = child + 8 + j * entry
                    off = f.u(e, f.so)
                    end = bytes(v[data + off:data + off + 1024]).index(b"\0")
                    name = bytes(v[data + off:data + off + end]).decode(
                        "utf-8")
                    if f.u(e + 2 * f.so, 4) == 2:
                        raise _unsupported(f"soft link {name!r}")
                    links[name] = f.addr(e + f.so)

    # ------------------------------------------------------------- surface
    def keys(self):
        return list(self._members())

    def __iter__(self) -> Iterator[str]:
        return iter(self._members())

    def __len__(self):
        return len(self._members())

    def __contains__(self, path):
        try:
            self._resolve(path)
        except KeyError:
            return False
        return True

    def _resolve(self, path):
        obj = self
        for part in [s for s in str(path).split("/") if s]:
            if not isinstance(obj, Group) or part not in obj._members():
                raise KeyError(f"{path!r} not in {self.name!r}")
            obj = obj._child(part)
        return obj

    def _child(self, name):
        addr = self._members()[name]
        path = f"{self.name.rstrip('/')}/{name}"
        for mtype, _, _, _ in self._f.messages(addr):
            if mtype in (_SYMBOL_TABLE, _LINK_INFO, _LINK):
                return Group(self._f, addr, path)
            if mtype == _LAYOUT:
                return Dataset(self._f, addr, path)
        # a group with no links and no link info (an empty old-style
        # group always has its symbol table message)
        return Group(self._f, addr, path)

    def __getitem__(self, path):
        return self._resolve(path)

    def get(self, path, default=None):
        try:
            return self._resolve(path)
        except KeyError:
            return default

    def visititems(self, func: Callable[[str, Any], Any]):
        """Call ``func(relative path, object)`` on every object below this
        group, by name at each level (h5py's order); a non-None return
        stops the walk and is returned."""
        seen = set()

        def walk(group, prefix):
            for name in group.keys():
                obj = group._child(name)
                path = f"{prefix}{name}"
                if obj._addr in seen:
                    continue
                seen.add(obj._addr)
                got = func(path, obj)
                if got is not None:
                    return got
                if isinstance(obj, Group):
                    got = walk(obj, path + "/")
                    if got is not None:
                        return got
            return None
        return walk(self, "")


class File(Group):
    """An HDF5 file opened read-only: a path (memory-mapped) or bytes. Use
    as a context manager or call :meth:`close`."""

    def __init__(self, source, mode: str = "r"):
        if mode != "r":
            raise ValueError("the port's HDF5 reader only reads (mode 'r')")
        closer = None
        if isinstance(source, (bytes, bytearray, memoryview)):
            buf = bytes(source)
        else:
            with open(source, "rb") as fh:
                buf = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
            closer = buf.close
        f = _File(buf, closer)
        super().__init__(f, f.root, "/")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["AttributeManager", "Dataset", "File", "Group"]
