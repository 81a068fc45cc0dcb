"""An HDF5 reader and writer in numpy and the standard library, for the LESbrary and netCDF-4 files.

The port's own copy of what ``data/lesbrary.py`` and ``data/netcdf.py`` need
from h5py, so the files are read and written wherever the port runs. The
format is HDF5's published file format specification (version 3.0); each
structure below names its section.

**Read**, the layouts that h5py's defaults and JLD2.jl write:

- superblock versions 0, 1, 2 and 3, found at 0, 512, 1,024, 2,048 … bytes
  (a user block before it, as JLD2.jl's 512-byte header); addresses are
  relative to where the superblock starts, as the HDF5 library takes them;
- version-1 object headers with continuation blocks, and version-2 ones
  (``OHDR`` / ``OCHK``);
- groups as a symbol table (a version-1 B-tree of any depth, symbol nodes and
  a local heap) or as link messages in the header (Link Info with no
  fractal heap, Group Info, hard links; UTF-8 names);
- datasets with a compact or contiguous layout, a scalar or simple dataspace,
  and a little-endian IEEE float, integer or fixed-length string type;
- attributes of those types, variable-length strings and sequences (global
  heap collections), object references and compounds of them
  (``DIMENSION_LIST``, ``REFERENCE_LIST``).

Every checksum the format carries (superblock 2/3, ``OHDR``, ``OCHK``) is
verified with Jenkins' lookup3. Anything else raises :class:`HDF5Error`
naming the file and the feature: dense link or attribute storage (fractal
heap, v2 B-tree), chunked or filtered layouts, big-endian or non-IEEE types,
shared messages, soft and external links, and any message type outside the
set above. Nothing is skipped or read in part.

**Write** one layout, JLD2.jl's: superblock version 2, version-2 object
headers, every link a message in its group's header, contiguous data, and
one global heap collection for variable-length attribute values. h5py (the
HDF5 library) and this reader both read it.

The API follows h5py: ``File(path, "r" | "w")`` as a context manager;
groups with ``keys``, ``items``, ``in`` (paths with ``/``) and ``[path]``;
datasets with ``shape``, ``dtype`` and ``[()]`` (the whole dataset); ``attrs``;
``create_group``, ``create_dataset`` and ``group[path] = data``; and the
dimension scales of netCDF-4: ``make_scale``, ``dims[i].attach_scale`` and,
on read, ``dims[i][0].name``.
"""

from __future__ import annotations

import os
import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address, all bits set (sizes of offsets 8)


class HDF5Error(ValueError):
    """A file this module cannot read or write: names the file and the feature."""


# ---------------------------------------------------------------------------
# Jenkins lookup3 (``hashlittle``, initval 0): the checksum of superblock 2/3 and v2 headers
# ---------------------------------------------------------------------------

_M = 0xFFFFFFFF


def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & _M


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' ``hashlittle`` over ``data``, as HDF5's ``H5_checksum_lookup3``."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M
    if n == 0:
        return c
    tail = n - ((n - 1) // 12) * 12  # 1..12 bytes go to the final mix
    words = struct.unpack_from(f"<{(n - tail) // 4}I", data)
    for i in range(0, len(words), 3):
        a = (a + words[i]) & _M
        b = (b + words[i + 1]) & _M
        c = (c + words[i + 2]) & _M
        a = (a - c) & _M; a ^= _rot(c, 4); c = (c + b) & _M  # noqa: E702
        b = (b - a) & _M; b ^= _rot(a, 6); a = (a + c) & _M  # noqa: E702
        c = (c - b) & _M; c ^= _rot(b, 8); b = (b + a) & _M  # noqa: E702
        a = (a - c) & _M; a ^= _rot(c, 16); c = (c + b) & _M  # noqa: E702
        b = (b - a) & _M; b ^= _rot(a, 19); a = (a + c) & _M  # noqa: E702
        c = (c - b) & _M; c ^= _rot(b, 4); b = (b + a) & _M  # noqa: E702
    ka, kb, kc = struct.unpack("<3I", bytes(data[n - tail:]) + bytes(12 - tail))
    a, b, c = (a + ka) & _M, (b + kb) & _M, (c + kc) & _M
    c ^= b; c = (c - _rot(b, 14)) & _M  # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & _M  # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & _M  # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & _M  # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & _M  # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & _M  # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & _M  # noqa: E702
    return c


# ---------------------------------------------------------------------------
# Datatypes (specification IV.A.2.d) and the values they describe
# ---------------------------------------------------------------------------

# Message types (IV.A.2): the ones read, and the ones that carry nothing a reader needs.
MSG_NIL, MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x00, 0x01, 0x02, 0x03
MSG_FILL_OLD, MSG_FILL, MSG_LINK, MSG_LAYOUT, MSG_GROUP_INFO = 0x04, 0x05, 0x06, 0x08, 0x0A
MSG_FILTERS, MSG_ATTRIBUTE, MSG_MTIME_OLD, MSG_CONTINUATION = 0x0B, 0x0C, 0x0E, 0x10
MSG_SYMBOL_TABLE, MSG_MTIME, MSG_ATTRIBUTE_INFO, MSG_REFCOUNT = 0x11, 0x12, 0x15, 0x16
_KNOWN = {MSG_NIL, MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE, MSG_FILL_OLD, MSG_FILL, MSG_LINK, MSG_LAYOUT,
          MSG_GROUP_INFO, MSG_ATTRIBUTE, MSG_MTIME_OLD, MSG_CONTINUATION, MSG_SYMBOL_TABLE, MSG_MTIME,
          MSG_ATTRIBUTE_INFO, MSG_REFCOUNT}
_MSG_NAMES = {0x07: "external data files", 0x09: "bogus", MSG_FILTERS: "filter pipeline (compressed data)",
              0x0D: "object comment", 0x0F: "shared message table", 0x13: "B-tree 'K' values",
              0x14: "driver info", 0x17: "file space info"}


class Reference:
    """An HDF5 object reference: the address of the object's header (relative to the base)."""

    __slots__ = ("address",)

    def __init__(self, address: int):
        self.address = address

    def __repr__(self):
        return f"Reference({self.address:#x})"


class _Type:
    """A decoded datatype: ``kind`` is ``"numeric"`` or ``"string"`` (fixed length; both read as ``dtype``),
    ``"vlen_string"`` (``utf8`` or ASCII), ``"vlen"`` (a sequence of ``base``), ``"reference"`` or ``"compound"``
    (``members``: ``(name, offset, _Type)``)."""

    def __init__(self, kind, size, dtype=None, base=None, members=(), utf8=False):
        self.kind, self.size, self.dtype, self.base = kind, size, dtype, base
        self.members, self.utf8 = list(members), utf8


_FLOAT_LAYOUT = {4: (31, 23, 8, 0, 23, 127), 8: (63, 52, 11, 0, 52, 1023)}  # sign, exp loc/size, mant loc/size, bias


def _decode_type(buf, pos, fail) -> tuple[_Type, int]:
    """One datatype message at ``buf[pos:]``; returns it and the position after it."""
    cv, b0, b1, _, size = struct.unpack_from("<BBBBI", buf, pos)
    cls, version = cv & 0x0F, cv >> 4
    p = pos + 8
    if cls in (0, 1) and b0 & 0x01:
        fail("big-endian data")
    if cls == 0:  # fixed-point
        offset, precision = struct.unpack_from("<HH", buf, p)
        if offset != 0 or precision != 8 * size or size not in (1, 2, 4, 8) or b0 & 0x06:
            fail(f"a {precision}-bit integer at bit {offset} in {size} bytes")
        return _Type("numeric", size, np.dtype(f"<{'i' if b0 & 0x08 else 'u'}{size}")), p + 4
    if cls == 1:  # IEEE floating point
        fields = struct.unpack_from("<HHBBBBI", buf, p)
        if size not in _FLOAT_LAYOUT or fields[:2] != (0, 8 * size) or b1 != _FLOAT_LAYOUT[size][0] \
                or fields[2:] != _FLOAT_LAYOUT[size][1:] or (b0 >> 4) & 0x03 != 2 or b0 & 0x4E:
            fail(f"a non-IEEE {8 * size}-bit floating-point type")
        return _Type("numeric", size, np.dtype(f"<f{size}")), p + 12
    if cls == 3:  # fixed-length string
        pad, cset = b0 & 0x0F, b0 >> 4
        if pad not in (0, 1) or cset not in (0, 1):
            fail(f"a string with padding {pad} and character set {cset}")
        return _Type("string", size, np.dtype(f"S{size}")), p
    if cls == 6:  # compound
        n = b0 | (b1 << 8)
        members = []
        for _ in range(n):
            end = p
            while buf[end]:
                end += 1
            name = bytes(buf[p:end]).decode()
            if version in (3, 4):
                p = end + 1
                width = max(1, (size.bit_length() + 7) // 8)
                offset = int.from_bytes(buf[p:p + width], "little")
                p += width
            elif version in (1, 2):
                p = end + 1 + (-(end + 1 - p)) % 8  # the name, null-terminated, padded to 8 bytes
                offset = struct.unpack_from("<I", buf, p)[0]
                p += 4
                if version == 1:
                    if buf[p] != 0:
                        fail("a compound member that is an array")
                    p += 28
            else:
                fail(f"compound datatype version {version}")
            mtype, p = _decode_type(buf, p, fail)
            members.append((name, offset, mtype))
        return _Type("compound", size, members=members), p
    if cls == 7:  # reference
        if b0 & 0x0F != 0 or version != 1 or size != 8:
            fail(f"a reference of type {b0 & 0x0F}, version {version} (object references only)")
        return _Type("reference", size), p
    if cls == 9:  # variable length
        base, p = _decode_type(buf, p, fail)
        if b0 & 0x0F == 1:
            return _Type("vlen_string", size, base=base, utf8=(b1 & 0x0F) == 1), p
        return _Type("vlen", size, base=base), p
    fail(f"datatype class {cls}")


def _decode_dataspace(buf, pos, fail) -> tuple[int, ...]:
    version, rank, flags = buf[pos], buf[pos + 1], buf[pos + 2]
    if version == 1:
        p = pos + 8
        if flags & 0x02:
            fail("a dataspace permutation")
    elif version == 2:
        if buf[pos + 3] == 2:
            fail("a null dataspace")
        p = pos + 4
    else:
        fail(f"dataspace version {version}")
    return struct.unpack_from(f"<{rank}Q", buf, p)


# ---------------------------------------------------------------------------
# The reader
# ---------------------------------------------------------------------------


class _Reader:
    """A whole file in memory, its superblock and the decoders that need addresses."""

    def __init__(self, path):
        self.path = os.fspath(path)
        with open(self.path, "rb") as fh:
            self.buf = memoryview(fh.read())
        self.base = self._find_superblock()
        self._heaps: dict = {}
        self._messages: dict = {}  # header address -> its messages, parsed once
        self._links: dict = {}  # group header address -> {name: address}
        self._by_address: dict | None = None
        self.root = Group(self, self.root_address, "/")

    def close(self):
        self.buf = memoryview(b"")
        self._heaps, self._messages, self._links, self._by_address = {}, {}, {}, None

    def fail(self, feature):
        raise HDF5Error(f"{self.path}: {feature} is not supported by the port's HDF5 reader")

    def _find_superblock(self) -> int:
        at = 0
        while at + 8 <= len(self.buf):
            if self.buf[at:at + 8] == SIGNATURE:
                break
            at = 512 if at == 0 else 2 * at
        else:
            raise HDF5Error(f"{self.path}: no HDF5 superblock signature (not an HDF5 file)")
        buf, version = self.buf, self.buf[at + 8]
        if version in (0, 1):
            o_size, l_size = buf[at + 13], buf[at + 14]
            self._check_sizes(o_size, l_size)
            p = at + 24 + (4 if version == 1 else 0)
            p += 4 * 8  # base, free-space info, end of file and driver info addresses
            self.root_address = struct.unpack_from("<Q", buf, p + 8)[0]  # root symbol table entry's header
        elif version in (2, 3):
            o_size, l_size = buf[at + 9], buf[at + 10]
            self._check_sizes(o_size, l_size)
            self._verify(at, at + 44, "superblock")
            ext, _, self.root_address = struct.unpack_from("<QQQ", buf, at + 20)
            if ext != UNDEF:
                self.fail("a superblock extension")
        else:
            self.fail(f"superblock version {version}")
        return at

    def _check_sizes(self, o_size, l_size):
        if (o_size, l_size) != (8, 8):
            self.fail(f"sizes of offsets {o_size} and lengths {l_size} (8 and 8 only)")

    def _verify(self, start, end, what):
        stored = struct.unpack_from("<I", self.buf, end)[0]
        if lookup3(self.buf[start:end]) != stored:
            raise HDF5Error(f"{self.path}: checksum mismatch in the {what} at byte {start}")

    def at(self, address) -> int:
        """The position in the file of an address relative to the base."""
        pos = self.base + address
        if address == UNDEF or pos >= len(self.buf):
            raise HDF5Error(f"{self.path}: address {address:#x} outside the file")
        return pos

    def _expect(self, pos, signature, what):
        if self.buf[pos:pos + 4] != signature:
            raise HDF5Error(f"{self.path}: no {what} signature {signature!r} at byte {pos}")

    # -- object headers (IV.A.1) ---------------------------------------------------------------

    def messages(self, address) -> list[tuple[int, int, memoryview]]:
        """``(type, flags, data)`` of every message of the object header at ``address``."""
        if address not in self._messages:
            self._messages[address] = self._parse_header(address)
        return self._messages[address]

    def _parse_header(self, address) -> list[tuple[int, int, memoryview]]:
        buf, pos = self.buf, self.at(address)
        out: list = []
        if buf[pos:pos + 4] == b"OHDR":
            version, flags = buf[pos + 4], buf[pos + 5]
            if version != 2:
                self.fail(f"object header version {version}")
            p = pos + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 0x03)
            size = int.from_bytes(buf[p:p + width], "little")
            p += width
            self._verify(pos, p + size, "object header")
            chunks = [(p, p + size)]
            order = 2 if flags & 0x04 else 0
            while chunks:
                start, end = chunks.pop(0)
                p = start
                while p + 4 + order <= end:
                    mtype, msize, mflags = struct.unpack_from("<BHB", buf, p)
                    p += 4 + order
                    cont = self._message(out, mtype, mflags, buf[p:p + msize])
                    if cont is not None:
                        cpos = self.at(cont[0])
                        self._expect(cpos, b"OCHK", "object header continuation")
                        self._verify(cpos, cpos + cont[1] - 4, "object header continuation")
                        chunks.append((cpos + 4, cpos + cont[1] - 4))
                    p += msize
            return out
        version = buf[pos]
        if version != 1:
            self.fail(f"object header version {version}")
        size = struct.unpack_from("<I", buf, pos + 8)[0]
        chunks = [(pos + 16, pos + 16 + size)]
        while chunks:
            start, end = chunks.pop(0)
            p = start
            while p + 8 <= end:
                mtype, msize, mflags = struct.unpack_from("<HHB", buf, p)
                p += 8
                cont = self._message(out, mtype, mflags, buf[p:p + msize])
                if cont is not None:
                    cpos = self.at(cont[0])
                    chunks.append((cpos, cpos + cont[1]))
                p += msize
        return out

    def _message(self, out, mtype, mflags, data):
        if mtype not in _KNOWN:
            self.fail(f"header message type {mtype:#x} ({_MSG_NAMES.get(mtype, 'unknown')})")
        if mflags & 0x02:
            self.fail(f"a shared header message (type {mtype:#x}; committed datatypes)")
        if mtype == MSG_CONTINUATION:
            return struct.unpack_from("<QQ", data)
        if mtype != MSG_NIL:
            out.append((mtype, mflags, data))
        return None

    # -- groups (III.A-C, IV.A.2.c, f, g, k) ---------------------------------------------------

    def links(self, address) -> dict[str, int]:
        """``{name: header address}`` of a group, in name order; raises ``KeyError`` if ``address`` is no group."""
        if address not in self._links:
            self._links[address] = self._parse_links(address)
        return self._links[address]

    def _parse_links(self, address) -> dict[str, int]:
        msgs = self.messages(address)
        found: list[tuple[bytes, int]] = []
        kinds = {m[0] for m in msgs}
        if MSG_SYMBOL_TABLE in kinds:
            data = next(d for t, _, d in msgs if t == MSG_SYMBOL_TABLE)
            btree, heap = struct.unpack_from("<QQ", data)
            self._btree_entries(btree, self._local_heap(heap), found)
        elif MSG_LINK_INFO in kinds:
            data = next(d for t, _, d in msgs if t == MSG_LINK_INFO)
            if data[0] != 0:
                self.fail(f"link info version {data[0]}")
            heap_address = struct.unpack_from("<Q", data, 2 + (8 if data[1] & 0x01 else 0))[0]
            if heap_address != UNDEF:
                self.fail("dense link storage (fractal heap and v2 B-tree)")
            for t, _, d in msgs:
                if t == MSG_LINK:
                    found.append(self._link(d))
        else:
            raise KeyError("not a group")
        found.sort()
        return {name.decode("utf-8"): addr for name, addr in found}

    def _link(self, d) -> tuple[bytes, int]:
        if d[0] != 1:
            self.fail(f"link message version {d[0]}")
        flags, p = d[1], 2
        if flags & 0x08:
            if d[p] != 0:
                self.fail(f"a {'soft' if d[p] == 1 else 'external'} link")
            p += 1
        p += 8 if flags & 0x04 else 0
        if flags & 0x10:
            if d[p] not in (0, 1):
                self.fail(f"link name character set {d[p]}")
            p += 1
        width = 1 << (flags & 0x03)
        n = int.from_bytes(d[p:p + width], "little")
        p += width
        return bytes(d[p:p + n]), struct.unpack_from("<Q", d, p + n)[0]

    def _local_heap(self, address) -> bytes:
        pos = self.at(address)
        self._expect(pos, b"HEAP", "local heap")
        size, _, data = struct.unpack_from("<QQQ", self.buf, pos + 8)
        start = self.at(data)
        return bytes(self.buf[start:start + size])

    def _btree_entries(self, address, heap, found, depth=0):
        if depth > 64:
            raise HDF5Error(f"{self.path}: group B-tree deeper than 64 levels")
        buf, pos = self.buf, self.at(address)
        self._expect(pos, b"TREE", "v1 B-tree node")
        kind, level, used = buf[pos + 4], buf[pos + 5], struct.unpack_from("<H", buf, pos + 6)[0]
        if kind != 0:
            self.fail(f"a v1 B-tree of node type {kind} in a group")
        p = pos + 24 + 8  # signature, type, level, entries, siblings; then key 0
        for _ in range(used):
            child = struct.unpack_from("<Q", buf, p)[0]
            p += 16  # the child and the key after it
            if level > 0:
                self._btree_entries(child, heap, found, depth + 1)
                continue
            sp = self.at(child)
            self._expect(sp, b"SNOD", "symbol table node")
            for i in range(struct.unpack_from("<H", buf, sp + 6)[0]):
                name_off, header, cache = struct.unpack_from("<QQI", buf, sp + 8 + 40 * i)
                if cache == 2:
                    self.fail("a soft link")
                found.append((heap[name_off:heap.index(b"\0", name_off)], header))

    # -- values (IV.B, III.E) ------------------------------------------------------------------

    def global_heap_object(self, address, index) -> memoryview:
        if address not in self._heaps:
            pos = self.at(address)
            self._expect(pos, b"GCOL", "global heap collection")
            size = struct.unpack_from("<Q", self.buf, pos + 8)[0]
            objects, p, end = {}, pos + 16, pos + size
            while p + 16 <= end:
                idx, _, _, osize = struct.unpack_from("<HHIQ", self.buf, p)
                if idx == 0:
                    break
                objects[idx] = self.buf[p + 16:p + 16 + osize]
                p += 16 + osize + (-osize) % 8
            self._heaps[address] = objects
        try:
            return self._heaps[address][index]
        except KeyError:
            raise HDF5Error(f"{self.path}: global heap object {index} missing at {address:#x}") from None

    def values(self, t: _Type, shape, raw: memoryview):
        """The elements of ``raw`` as h5py returns them: an array, or a scalar for a scalar dataspace."""
        count = int(np.prod(shape)) if shape else 1
        if len(raw) < count * t.size:
            raise HDF5Error(f"{self.path}: {len(raw)} bytes of data for {count} elements of {t.size}")
        if t.kind in ("numeric", "string"):
            arr = np.frombuffer(raw, t.dtype, count).copy().reshape(shape)
            return arr[()]
        arr = np.empty(count, object)
        for i in range(count):
            arr[i] = self._element(t, raw[i * t.size:(i + 1) * t.size])
        return arr.reshape(shape)[()]

    def _element(self, t: _Type, raw):
        if t.kind in ("numeric", "string"):
            return np.frombuffer(raw, t.dtype, 1)[0]
        if t.kind == "reference":
            return Reference(struct.unpack_from("<Q", raw)[0])
        if t.kind == "compound":
            return tuple(self._element(m, raw[off:off + m.size]) for _, off, m in t.members)
        n, heap, index = struct.unpack_from("<IQI", raw)
        data = self.global_heap_object(heap, index) if n else memoryview(b"")
        if t.kind == "vlen_string":
            return bytes(data[:n]).decode("utf-8" if t.utf8 else "ascii")
        return np.array([self._element(t.base, data[i * t.base.size:(i + 1) * t.base.size]) for i in range(n)],
                        dtype=t.base.dtype if t.base.kind == "numeric" else object)

    def node(self, address, name):
        kinds = {m[0] for m in self.messages(address)}
        if kinds & {MSG_SYMBOL_TABLE, MSG_LINK_INFO}:
            return Group(self, address, name)
        if MSG_LAYOUT in kinds:
            return Dataset(self, address, name)
        self.fail(f"the object at {name!r} (neither a group nor a dataset)")

    def deref(self, ref: Reference):
        """The group or dataset an object reference points to (named by its first path)."""
        if self._by_address is None:
            self._by_address = {self.root_address: "/"}
            todo = [(self.root_address, "")]
            while todo:
                address, prefix = todo.pop()
                for name, child in self.links(address).items():
                    if child in self._by_address:
                        continue
                    self._by_address[child] = f"{prefix}/{name}"
                    if {m[0] for m in self.messages(child)} & {MSG_SYMBOL_TABLE, MSG_LINK_INFO}:
                        todo.append((child, f"{prefix}/{name}"))
        if ref.address not in self._by_address:
            raise HDF5Error(f"{self.path}: reference to {ref.address:#x}, which no link reaches")
        return self.node(ref.address, self._by_address[ref.address])


class _Node:
    def __init__(self, reader: _Reader, address: int, name: str):
        self._r, self._address, self.name = reader, address, name
        self._attrs = None

    @property
    def attrs(self) -> dict:
        """The object's attributes, decoded as h5py returns them."""
        if self._attrs is None:
            self._attrs = {}
            for t, _, d in self._r.messages(self._address):
                if t == MSG_ATTRIBUTE:
                    name, value = self._attribute(d)
                    self._attrs[name] = value
                elif t == MSG_ATTRIBUTE_INFO:
                    heap = struct.unpack_from("<Q", d, 2 + (2 if d[1] & 0x01 else 0))[0]
                    if heap != UNDEF:
                        self._r.fail("dense attribute storage (fractal heap and v2 B-tree)")
        return self._attrs

    def _attribute(self, d):
        fail = self._r.fail
        version, flags = d[0], d[1]
        n_name, n_type, n_space = struct.unpack_from("<HHH", d, 2)
        if flags & 0x03:
            fail("an attribute with a shared datatype or dataspace")
        if version == 1:
            pad = lambda n: n + (-n) % 8  # noqa: E731
            p = 8
            name = bytes(d[p:p + n_name])
            p += pad(n_name)
            t, _ = _decode_type(d, p, fail)
            p += pad(n_type)
            shape = _decode_dataspace(d, p, fail)
            p += pad(n_space)
        elif version in (2, 3):
            p = 8 if version == 2 else 9
            name = bytes(d[p:p + n_name])
            p += n_name
            t, _ = _decode_type(d, p, fail)
            p += n_type
            shape = _decode_dataspace(d, p, fail)
            p += n_space
        else:
            fail(f"attribute message version {version}")
        return name.split(b"\0", 1)[0].decode("utf-8"), self._r.values(t, shape, d[p:])


class Group(_Node):
    """A group of a file open for reading."""

    def _links(self) -> dict[str, int]:
        return self._r.links(self._address)

    def keys(self):
        return list(self._links())

    def __iter__(self):
        return iter(self._links())

    def items(self):
        return [(k, self[k]) for k in self._links()]

    def __contains__(self, path) -> bool:
        try:
            self._resolve(path)
        except KeyError:
            return False
        return True

    def _resolve(self, path: str) -> tuple[int, str]:
        address, name = (self._r.root_address, "") if path.startswith("/") else (self._address, self.name.rstrip("/"))
        for part in (p for p in path.split("/") if p):
            try:
                links = self._r.links(address)
            except KeyError:
                raise KeyError(f"{name!r} is a dataset, not a group") from None
            if part not in links:
                raise KeyError(f"{part!r} not in {name or '/'!r} of {self._r.path}")
            address, name = links[part], f"{name}/{part}"
        return address, name or "/"

    def __getitem__(self, path: str):
        return self._r.node(*self._resolve(path))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Release the file's bytes and what was parsed from them (the reader holds the whole file in memory)."""
        self._r.close()


class Dataset(_Node):
    """A dataset of a file open for reading: ``ds[()]`` reads the whole of it."""

    def _header(self):
        dtype = shape = layout = None
        for t, _, d in self._r.messages(self._address):
            if t == MSG_DATATYPE:
                dtype = _decode_type(d, 0, self._r.fail)[0]
            elif t == MSG_DATASPACE:
                shape = _decode_dataspace(d, 0, self._r.fail)
            elif t == MSG_LAYOUT:
                layout = d
        if dtype is None or shape is None:
            raise HDF5Error(f"{self._r.path}: dataset {self.name!r} lacks a datatype or dataspace")
        return dtype, tuple(shape), layout

    @property
    def shape(self) -> tuple[int, ...]:
        return self._header()[1]

    @property
    def dtype(self) -> np.dtype:
        t = self._header()[0]
        return t.dtype if t.dtype is not None else np.dtype(object)

    def _raw(self, layout, nbytes) -> memoryview:
        version, cls = layout[0], layout[1]
        if version not in (3, 4):
            self._r.fail(f"data layout version {version}")
        if cls == 0:  # compact
            size = struct.unpack_from("<H", layout, 2)[0]
            return layout[4:4 + size]
        if cls == 1:  # contiguous
            address, size = struct.unpack_from("<QQ", layout, 2)
            if address == UNDEF:
                if nbytes:
                    raise HDF5Error(f"{self._r.path}: dataset {self.name!r} has no storage allocated")
                return memoryview(b"")
            start = self._r.at(address)
            return self._r.buf[start:start + size]
        self._r.fail(f"the {'chunked' if cls == 2 else 'virtual'} layout of dataset {self.name!r}")

    def __getitem__(self, key):
        if not (isinstance(key, tuple) and key == ()):
            raise TypeError(f"only ds[()] reads (the whole dataset), not ds[{key!r}]")
        t, shape, layout = self._header()
        count = int(np.prod(shape)) if shape else 1
        return self._r.values(t, shape, self._raw(layout, count * t.size))

    @property
    def dims(self):
        """Per axis, the dimension scales attached to it (``DIMENSION_LIST``), as datasets."""
        refs = self.attrs.get("DIMENSION_LIST")
        if refs is None:
            return tuple(() for _ in self.shape)
        return tuple(tuple(self._r.deref(r) for r in seq) for seq in refs)


# ---------------------------------------------------------------------------
# The writer
# ---------------------------------------------------------------------------


class _FixedString:
    """A fixed-length string attribute, null-terminated as the dimension-scale API writes them."""

    def __init__(self, text: str):
        self.raw = text.encode("utf-8")


def _type_of(value) -> tuple[bytes, int]:
    """The datatype message of a value's elements, and the element size."""
    if isinstance(value, _FixedString):
        n = len(value.raw) + 1
        return struct.pack("<BBBBI", 0x13, 0x00, 0, 0, n), n  # null-terminated, ASCII
    dt = value.dtype
    if dt.kind == "f" and dt.itemsize in _FLOAT_LAYOUT:
        sign, eloc, esize, mloc, msize, bias = _FLOAT_LAYOUT[dt.itemsize]
        return (struct.pack("<BBBBI", 0x11, 0x20, sign, 0, dt.itemsize)
                + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize, eloc, esize, mloc, msize, bias)), dt.itemsize
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        return (struct.pack("<BBBBI", 0x10, 0x08 if dt.kind == "i" else 0, 0, 0, dt.itemsize)
                + struct.pack("<HH", 0, 8 * dt.itemsize)), dt.itemsize
    if dt.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, dt.itemsize), dt.itemsize  # null-padded, ASCII
    raise HDF5Error(f"cannot write data of dtype {dt} (floats, integers and byte strings only)")


def _vlen_string_type() -> bytes:
    base = struct.pack("<BBBBI", 0x10, 0, 0, 0, 1) + struct.pack("<HH", 0, 8)  # unsigned char
    return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + base  # string, null-terminated, UTF-8


_REF_TYPE = struct.pack("<BBBBI", 0x17, 0, 0, 0, 8)  # object reference


def _dataspace(shape) -> bytes:
    return struct.pack("<BBBB", 2, len(shape), 0, 1 if shape else 0) + struct.pack(f"<{len(shape)}Q", *shape)


def _numpy_value(value):
    if isinstance(value, (str, _FixedString, _DimensionList, _ReferenceList)):
        return value
    if isinstance(value, (bytes, np.bytes_)):
        return np.array(value, dtype=f"S{max(len(value), 1)}")
    arr = np.asarray(value)
    if arr.dtype.kind == "f" and arr.dtype.itemsize not in (4, 8) or arr.dtype.kind in "bcOU":
        raise HDF5Error(f"cannot write a value of dtype {arr.dtype}")
    return arr.astype(arr.dtype.newbyteorder("<"), copy=False)


class _Encoder:
    """One pass over the tree: addresses of every object, and the global heap's objects."""

    def __init__(self, addresses, heap_address):
        self.addresses, self.heap_address, self.heap = addresses, heap_address, []

    def heap_id(self, data: bytes, n: int) -> bytes:
        self.heap.append(data)
        return struct.pack("<IQI", n, self.heap_address, len(self.heap))

    def ref(self, node) -> bytes:
        return struct.pack("<Q", self.addresses.get(id(node), 0))

    def attribute(self, name: str, value) -> bytes:
        if isinstance(value, str):
            raw = value.encode("utf-8")
            dtype, space, data = _vlen_string_type(), _dataspace(()), self.heap_id(raw, len(raw))
        elif isinstance(value, _DimensionList):
            dtype = struct.pack("<BBBBI", 0x19, 0, 0, 0, 16) + _REF_TYPE  # a sequence of references
            space = _dataspace((len(value.scales),))
            data = b"".join(self.heap_id(b"".join(self.ref(s) for s in seq), len(seq)) if seq
                            else struct.pack("<IQI", 0, 0, 0) for seq in value.scales)
        elif isinstance(value, _ReferenceList):
            members = b"dataset\0" + bytes([0]) + _REF_TYPE + b"dimension\0" + bytes([8]) + _type_of(
                np.zeros((), "<u4"))[0]
            dtype = struct.pack("<BBBBI", 0x36, 2, 0, 0, 16) + members  # as H5DS: {ref, unsigned} padded to 16
            space = _dataspace((len(value.entries),))
            data = b"".join(self.ref(ds) + struct.pack("<II", i, 0) for ds, i in value.entries)
        elif isinstance(value, _FixedString):
            dtype, space, data = _type_of(value)[0], _dataspace(()), value.raw + b"\0"
        else:
            dtype, space, data = _type_of(value)[0], _dataspace(value.shape), value.tobytes()
        raw_name = name.encode("utf-8")
        body = (struct.pack("<BBHHHB", 3, 0, len(raw_name) + 1, len(dtype), len(space), 1)
                + raw_name + b"\0" + dtype + space + data)
        return _message(MSG_ATTRIBUTE, body)


def _message(mtype: int, body: bytes) -> bytes:
    if len(body) > 0xFFFF:
        raise HDF5Error(f"a header message of {len(body)} bytes (the writer's limit is 65,535)")
    return struct.pack("<BHB", mtype, len(body), 0) + body


def _object_header(messages: bytes) -> bytes:
    width = next(w for w in range(4) if len(messages) < 1 << (8 << w))
    head = b"OHDR" + bytes([2, width]) + len(messages).to_bytes(1 << width, "little") + messages
    return head + struct.pack("<I", lookup3(head))


class _DimensionList:
    def __init__(self, scales):
        self.scales = scales


class _ReferenceList:
    def __init__(self, entries):
        self.entries = entries


class _WNode:
    def __init__(self, name):
        self.name, self.attrs = name, {}

    def _attributes(self, enc: _Encoder) -> bytes:
        return b"".join(enc.attribute(k, _numpy_value(v)) for k, v in self._all_attrs().items())

    def _all_attrs(self):
        return self.attrs


class WGroup(_WNode):
    """A group of a file open for writing."""

    def __init__(self, name):
        super().__init__(name)
        self.children: dict[str, _WNode] = {}

    def _walk(self, path: str):
        """The parent group of ``path`` (intermediate groups created, as h5py does) and the last name."""
        node, parts = self, [p for p in path.split("/") if p]
        for part in parts[:-1]:
            if part not in node.children:
                node.children[part] = WGroup(f"{node.name.rstrip('/')}/{part}")
            node = node.children[part]
            if not isinstance(node, WGroup):
                raise HDF5Error(f"{part!r} in {path!r} is a dataset, not a group")
        return node, parts[-1]

    def create_group(self, path: str) -> WGroup:
        parent, last = self._walk(path)
        if last in parent.children:
            raise HDF5Error(f"{path!r} already exists")
        parent.children[last] = WGroup(f"{parent.name.rstrip('/')}/{last}")
        return parent.children[last]

    def create_dataset(self, path: str, data) -> WDataset:
        parent, last = self._walk(path)
        if last in parent.children:
            raise HDF5Error(f"{path!r} already exists")
        value = _numpy_value(data)
        if not isinstance(value, np.ndarray):
            raise HDF5Error(f"cannot write {type(data).__name__} as the dataset {path!r}")
        _type_of(value)  # refuse an unsupported dtype here, not when the file is closed
        # A copy, as h5py writes the data at once: the caller may change its array before the file closes.
        parent.children[last] = WDataset(f"{parent.name.rstrip('/')}/{last}", np.array(value, order="C"))
        return parent.children[last]

    def __setitem__(self, path: str, data):
        self.create_dataset(path, data)

    def _header(self, enc: _Encoder) -> bytes:
        messages = _message(MSG_LINK_INFO, struct.pack("<BBQQ", 0, 0, UNDEF, UNDEF))
        messages += _message(MSG_GROUP_INFO, bytes(2))
        for name, child in self.children.items():
            raw = name.encode("utf-8")
            if len(raw) > 0xFF:
                raise HDF5Error(f"link name {name!r} longer than 255 bytes")
            charset = raw != name.encode("ascii", "ignore")
            body = bytes([1, 0x10 if charset else 0]) + (b"\x01" if charset else b"") + bytes([len(raw)]) + raw
            messages += _message(MSG_LINK, body + enc.ref(child))
        return _object_header(messages + self._attributes(enc))


class WDataset(_WNode):
    """A dataset of a file open for writing (contiguous, written when the file closes)."""

    def __init__(self, name, data: np.ndarray):
        super().__init__(name)
        self.data, self.shape = data, data.shape
        self._scale_refs: list = []
        self._dims: list[list] | None = None

    def make_scale(self, name: str = ""):
        """Mark the dataset a dimension scale (``CLASS`` and ``NAME``, as ``H5DSset_scale``)."""
        self.attrs["CLASS"] = _FixedString("DIMENSION_SCALE")
        self.attrs["NAME"] = _FixedString(name)

    @property
    def dims(self):
        if self._dims is None:
            self._dims = [[] for _ in self.shape]
        return [_DimWriter(self, i) for i in range(len(self.shape))]

    def _all_attrs(self):
        attrs = dict(self.attrs)
        if self._dims is not None and any(self._dims):
            attrs["DIMENSION_LIST"] = _DimensionList(self._dims)
        if self._scale_refs:
            attrs["REFERENCE_LIST"] = _ReferenceList(self._scale_refs)
        return attrs

    def _header(self, enc: _Encoder, data_address: int) -> bytes:
        messages = _message(MSG_DATASPACE, _dataspace(self.shape))
        messages += _message(MSG_DATATYPE, _type_of(self.data)[0])
        messages += _message(MSG_FILL, bytes([3, 0x0A]))  # the library's default: late allocation, fill if set
        address = data_address if self.data.nbytes else UNDEF  # no storage for no elements, as the library
        messages += _message(MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, address, self.data.nbytes))
        return _object_header(messages + self._attributes(enc))


class _DimWriter:
    def __init__(self, ds: WDataset, axis: int):
        self.ds, self.axis = ds, axis

    def attach_scale(self, scale: WDataset):
        """Attach ``scale`` to this axis (``DIMENSION_LIST`` here, ``REFERENCE_LIST`` on the scale)."""
        self.ds._dims[self.axis].append(scale)
        scale._scale_refs.append((self.ds, self.axis))


class WFile(WGroup):
    """A file open for writing: the tree is built in memory and written when the file closes."""

    def __init__(self, path):
        super().__init__("/")
        self.path = os.fspath(path)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()

    def _nodes(self) -> list[_WNode]:
        out, todo = [], [self]
        while todo:
            node = todo.pop()
            out.append(node)
            if isinstance(node, WGroup):
                todo.extend(reversed(node.children.values()))
        return out

    def _encode(self, nodes, addresses, heap_address, data_addresses):
        enc = _Encoder(addresses, heap_address)
        headers = [node._header(enc, data_addresses.get(id(node), 0)) if isinstance(node, WDataset)
                   else node._header(enc) for node in nodes]
        return headers, enc.heap

    def close(self):
        """Lay the file out (superblock, then each object's header and data, then the global
        heap) and write it: two passes, since references may point either way."""
        nodes = self._nodes()
        headers, heap = self._encode(nodes, {}, 0, {})
        addresses, data_addresses, cursor = {}, {}, 48
        for node, header in zip(nodes, headers):
            addresses[id(node)] = cursor
            cursor += len(header)
            if isinstance(node, WDataset):
                data_addresses[id(node)] = cursor
                cursor += node.data.nbytes
            cursor += (-cursor) % 8
        heap_address = cursor if heap else UNDEF
        headers, heap = self._encode(nodes, addresses, heap_address, data_addresses)
        heap_bytes = b""
        if heap:
            objects = b"".join(struct.pack("<HHIQ", i + 1, 0, 0, len(obj)) + obj + bytes((-len(obj)) % 8)
                               for i, obj in enumerate(heap))
            size = max(4096, 16 + len(objects) + 16)
            free = size - 16 - len(objects)
            heap_bytes = (b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + objects
                          + struct.pack("<HHIQ", 0, 0, 0, free) + bytes(free - 16))
        eof = (heap_address + len(heap_bytes)) if heap else cursor
        superblock = SIGNATURE + bytes([2, 8, 8, 0]) + struct.pack("<QQQQ", 0, UNDEF, eof, addresses[id(self)])
        superblock += struct.pack("<I", lookup3(superblock))
        with open(self.path, "wb") as fh:
            fh.write(superblock)
            for node, header in zip(nodes, headers):
                assert fh.tell() == addresses[id(node)]
                fh.write(header)
                if isinstance(node, WDataset):
                    fh.write(np.ascontiguousarray(node.data).tobytes())
                fh.write(bytes((-fh.tell()) % 8))
            fh.write(heap_bytes)


def File(path, mode: str = "r"):
    """Open an HDF5 file: ``"r"`` reads an existing file, ``"w"`` writes (replaces) one on close."""
    if mode == "r":
        return _Reader(path).root
    if mode == "w":
        return WFile(path)
    raise ValueError(f"mode {mode!r}: 'r' or 'w'")
