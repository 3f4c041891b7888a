"""Native parquet writer and reader (``csrc/parquet.cc`` through ctypes).

Counterpart of ``nvtabular_tpu/io/native_parquet.py`` (:185-488): the C++
side gathers, encodes and compresses pages, Python writes the thrift
compact ``FileMetaData`` footer once at close. Its files equal the JAX
package's native writer's byte for byte, the footer's ``created_by`` of
"nvtabular_tpu" included. The library is built with ``g++`` at first use
(``kernels/build.host_library``), with zstd where ``zstd.h`` is found.

The reader is the port's own (the JAX package reads with pyarrow, which the
card's machine lacks): ``read_footer`` parses the footer with a thrift
compact reader that skips the fields it does not know, and
``read_row_groups`` decodes the chunks in C++, several at once. It covers
flat int32/int64/float32/float64 columns (the 8- and 16-bit integer logical
types widen from int32) in DataPage V1 pages, PLAIN, DELTA_BINARY_PACKED or
BYTE_STREAM_SPLIT, uncompressed or zstd, REQUIRED or OPTIONAL without a
null: the JAX writer's files, the port's, and pyarrow's written with
``use_dictionary=False`` and ``data_page_version="1.0"``. Anything else
raises NotImplementedError naming ROADMAP.md queue 1 item 16.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..unported import message

# parquet.thrift enums
_TYPE = {"int32": 1, "int64": 2, "float32": 4, "float64": 5}
_DTYPE_CODE = {"int32": 0, "int64": 1, "float32": 2, "float64": 3}
_PHYSICAL = {1: np.dtype(np.int32), 2: np.dtype(np.int64), 4: np.dtype(np.float32), 5: np.dtype(np.float64)}
_PHYSICAL_NAMES = {0: "BOOLEAN", 3: "INT96", 6: "BYTE_ARRAY (strings)", 7: "FIXED_LEN_BYTE_ARRAY"}
_CODEC_NAMES = {1: "snappy", 2: "gzip", 3: "lzo", 4: "brotli", 5: "lz4", 7: "lz4_raw"}
# converted types the reader narrows int32 to: INT_8, INT_16, UINT_8
_NARROW = {15: np.dtype(np.int8), 16: np.dtype(np.int16), 11: np.dtype(np.uint8)}
_SIGNED_INTS = {17, 18}  # INT_32, INT_64
_DICT_ENCODINGS = {2, 8}  # PLAIN_DICTIONARY, RLE_DICTIONARY
ENC_PLAIN = 0
ENC_DELTA = 5
ENC_BYTE_STREAM_SPLIT = 9
CODEC_UNCOMPRESSED = 0
CODEC_ZSTD = 6

# return codes of csrc/parquet.cc
_ERRORS = {
    2: "an encoding outside PLAIN, DELTA_BINARY_PACKED and BYTE_STREAM_SPLIT",
    3: "a codec other than zstd",
    10: "dictionary pages",
    11: "DataPage V2 pages",
    12: "nulls in parquet columns",
    14: "index pages",
}
_UNSUPPORTED = {2, 3, 10, 11, 12, 14}
_NO_ZSTD = 6

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_POOL: Optional[ThreadPoolExecutor] = None


def unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(message(f"reading or writing {what}", 16))


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    from ..kernels.build import host_library

    with _LOCK:
        if _LIB is None:
            lib = host_library("parquet")
            P = ctypes.c_void_p
            LL = ctypes.c_longlong
            lib.nvtpq_open.argtypes = [ctypes.c_char_p]
            lib.nvtpq_open.restype = P
            lib.nvtpq_write_column.argtypes = [P, ctypes.POINTER(P), ctypes.c_int, P, LL] + [ctypes.c_int] * 4 + [
                ctypes.POINTER(LL)]
            lib.nvtpq_write_column.restype = ctypes.c_int
            lib.nvtpq_close.argtypes = [P]
            lib.nvtpq_close.restype = ctypes.c_int
            lib.nvtpq_build_window_index.argtypes = [
                ctypes.POINTER(LL), ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_ulonglong, P,
            ]
            lib.nvtpq_build_window_index.restype = LL
            lib.nvtpq_read_chunk.argtypes = [ctypes.c_char_p, LL, LL, LL, ctypes.c_int, ctypes.c_int, ctypes.c_int, P]
            lib.nvtpq_read_chunk.restype = ctypes.c_int
            lib.nvtpq_has_zstd.restype = LL
            _LIB = lib
    return _LIB


def has_zstd() -> bool:
    """Whether the library was built with zstd."""
    return bool(_lib().nvtpq_has_zstd())


def _raise_rc(rc: int, where: str):
    if rc in _UNSUPPORTED:
        raise unsupported(f"{_ERRORS[rc]} ({where})")
    if rc == _NO_ZSTD:
        raise RuntimeError(f"{where}: zstd asked for, and the parquet library was built without zstd.h")
    raise OSError(f"{where}: native parquet failed (rc={rc})")


# --------------------------------------------------------------------------
# Thrift compact-protocol writer — only what FileMetaData needs.
# Types: I32=5, I64=6, BINARY=8, LIST=9, STRUCT=12.
class _Compact:
    __slots__ = ("b", "_last", "_stack")

    def __init__(self):
        self.b = bytearray()
        self._last = 0
        self._stack: List[int] = []

    def _uleb(self, v: int):
        while v >= 0x80:
            self.b.append((v & 0x7F) | 0x80)
            v >>= 7
        self.b.append(v)

    def _zz(self, v: int):
        self._uleb(((v << 1) ^ (v >> 63)) & ((1 << 64) - 1))

    def _header(self, fid: int, ttype: int):
        delta = fid - self._last
        if 1 <= delta <= 15:
            self.b.append((delta << 4) | ttype)
        else:
            self.b.append(ttype)
            self._zz(fid)
        self._last = fid

    def i32(self, fid: int, v: int):
        self._header(fid, 5)
        self._zz(v)

    def i64(self, fid: int, v: int):
        self._header(fid, 6)
        self._zz(v)

    def binary(self, fid: int, v: bytes):
        self._header(fid, 8)
        self._uleb(len(v))
        self.b += v

    def begin_struct(self, fid: int):
        self._header(fid, 12)
        self._stack.append(self._last)
        self._last = 0

    def end_struct(self):
        self.b.append(0)
        self._last = self._stack.pop()

    def list_header(self, fid: int, size: int, elem_type: int):
        self._header(fid, 9)
        if size < 15:
            self.b.append((size << 4) | elem_type)
        else:
            self.b.append(0xF0 | elem_type)
            self._uleb(size)

    def list_i32(self, fid: int, values: Sequence[int]):
        self.list_header(fid, len(values), 5)
        for v in values:
            self._zz(v)

    def list_binary(self, fid: int, values: Sequence[bytes]):
        self.list_header(fid, len(values), 8)
        for v in values:
            self._uleb(len(v))
            self.b += v

    # list elements that are structs reset the field-id context themselves
    def struct_elem(self):
        self._stack.append(self._last)
        self._last = 0


class _ChunkMeta:
    __slots__ = ("page_offset", "comp", "uncomp", "num_values", "encoding", "codec")

    def __init__(self, page_offset, comp, uncomp, num_values, encoding, codec):
        self.page_offset = page_offset
        self.comp = comp
        self.uncomp = uncomp
        self.num_values = num_values
        self.encoding = encoding
        self.codec = codec


def zstd_level() -> int:
    return int(os.environ.get("NVT_PARQUET_ZSTD_LEVEL", 1))


def default_column_plan(name: str, dtype: np.dtype) -> Tuple[int, int, int]:
    """(encoding, codec, level) of one column under the "auto" policy: ints
    DELTA_BINARY_PACKED uncompressed, floats BYTE_STREAM_SPLIT + zstd
    (``NVT_PARQUET_ZSTD_LEVEL``, 1 by default)."""
    if np.dtype(dtype).kind in "iu":
        return ENC_DELTA, CODEC_UNCOMPRESSED, 0
    return ENC_BYTE_STREAM_SPLIT, CODEC_ZSTD, zstd_level()


class NativeParquetFile:
    """One output parquet file: C++ appends pages, Python writes the footer.

    ``write_row_group(columns, gidx, num_rows)`` takes, per column, a list of
    source arrays (window pieces); ``gidx`` packs (piece << 48) | row in
    destination order and is shared by every column, so the shuffle
    permutation is applied once per window inside the encode itself."""

    def __init__(self, path: str, schema: List[Tuple[str, np.dtype]], plan=None):
        self._lib = _lib()
        self.path = path
        self.schema = [(n, np.dtype(d)) for n, d in schema]
        for name, dt in self.schema:
            if dt.name not in _DTYPE_CODE:
                raise unsupported(f"{dt} columns ({name})")
        self._plan = [(plan or default_column_plan)(n, d) for n, d in self.schema]
        self._h = self._lib.nvtpq_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")
        self._row_groups: List[Tuple[int, List[_ChunkMeta]]] = []
        self._num_rows = 0
        self._closed = False

    def write_row_group(self, columns: Sequence[Sequence[np.ndarray]], gidx: Optional[np.ndarray], num_rows: int):
        """columns[i] = list of contiguous source arrays for schema column i."""
        if num_rows == 0:
            return
        gptr = None
        if gidx is not None:
            gidx = np.ascontiguousarray(gidx, dtype=np.int64)
            gptr = gidx.ctypes.data_as(ctypes.c_void_p)
        metas: List[_ChunkMeta] = []
        out = (ctypes.c_longlong * 4)()
        for (name, dt), (enc, codec, level), pieces in zip(self.schema, self._plan, columns):
            pieces = [np.ascontiguousarray(p) for p in pieces]
            for p in pieces:
                if p.dtype != dt:
                    raise ValueError(f"{name}: piece dtype {p.dtype} != {dt}")
            srcs = (ctypes.c_void_p * len(pieces))(*[p.ctypes.data for p in pieces])
            rc = self._lib.nvtpq_write_column(
                self._h, srcs, len(pieces), gptr, num_rows, _DTYPE_CODE[dt.name], enc, codec, level, out
            )
            if rc != 0:
                _raise_rc(rc, f"{self.path}: column {name}")
            metas.append(_ChunkMeta(out[0], out[1], out[2], num_rows, enc, codec))
        self._row_groups.append((num_rows, metas))
        self._num_rows += num_rows

    def close(self):
        if self._closed:
            return
        self._closed = True
        rc = self._lib.nvtpq_close(self._h)
        self._h = None
        if rc != 0:
            raise OSError(f"close failed on {self.path}")
        footer = self._footer()
        with open(self.path, "ab") as f:
            f.write(footer)
            f.write(struct.pack("<I", len(footer)))
            f.write(b"PAR1")

    def __del__(self):
        if getattr(self, "_h", None) is not None and not self._closed:
            self._lib.nvtpq_close(self._h)

    # ------------------------------------------------------------- footer
    def _footer(self) -> bytes:
        t = _Compact()
        t.i32(1, 2)  # version
        # schema: root element + one leaf per column
        t.list_header(2, 1 + len(self.schema), 12)
        t.struct_elem()
        t.binary(4, b"schema")
        t.i32(5, len(self.schema))  # num_children
        t.end_struct()
        for name, dt in self.schema:
            t.struct_elem()
            t.i32(1, _TYPE[dt.name])  # type
            t.i32(3, 0)  # repetition_type = REQUIRED
            t.binary(4, name.encode())
            t.end_struct()
        t.i64(3, self._num_rows)
        t.list_header(4, len(self._row_groups), 12)
        for num_rows, metas in self._row_groups:
            t.struct_elem()
            t.list_header(1, len(metas), 12)  # columns
            for (name, dt), m in zip(self.schema, metas):
                t.struct_elem()  # ColumnChunk
                t.i64(2, m.page_offset)  # file_offset
                t.begin_struct(3)  # meta_data
                t.i32(1, _TYPE[dt.name])
                t.list_i32(2, [m.encoding])
                t.list_binary(3, [name.encode()])
                t.i32(4, m.codec)
                t.i64(5, m.num_values)
                t.i64(6, m.uncomp)
                t.i64(7, m.comp)
                t.i64(9, m.page_offset)  # data_page_offset
                t.end_struct()
                t.end_struct()
            t.i64(2, sum(m.comp for m in metas))  # total_byte_size
            t.i64(3, num_rows)
            t.end_struct()
        t.binary(6, b"nvtabular_tpu")
        t.b.append(0)  # end FileMetaData struct
        return bytes(t.b)


def build_window_index(piece_rows: Sequence[int], piece_seeds: Sequence[int], nfiles: int, file_k: int,
                       shuffle_seed: int) -> np.ndarray:
    """This file's shuffled destination-order gather index for a window of
    whole pieces, built in C++ with the GIL released. Entries pack
    (piece << 48) | row."""
    lib = _lib()
    npieces = len(piece_rows)
    rows = (ctypes.c_longlong * npieces)(*[int(r) for r in piece_rows])
    seeds = (ctypes.c_ulonglong * npieces)(*[int(s) & (2**64 - 1) for s in piece_seeds])
    gidx = np.empty(int(sum(piece_rows)), dtype=np.int64)
    cnt = lib.nvtpq_build_window_index(
        rows, seeds, npieces, int(nfiles), int(file_k), int(shuffle_seed) & (2**64 - 1), gidx.ctypes.data
    )
    return gidx[: int(cnt)]


def hash_split(seed: int, n: int, nfiles: int) -> np.ndarray:
    """File (0..nfiles-1) of each of n rows under the streamed shuffle's hash
    split: the numpy twin of the C++ predicate of
    ``nvtpq_build_window_index``, bit for bit."""
    with np.errstate(over="ignore"):
        h = (np.arange(n, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)) ^ np.uint64(int(seed) & (2**64 - 1))
        return (((h >> np.uint64(32)) * np.uint64(nfiles)) >> np.uint64(32)).astype(np.int64)


def pack_gather_index(piece_indices: Sequence[np.ndarray], perm: np.ndarray) -> np.ndarray:
    """The destination-order gather index of a shuffle window:
    ``piece_indices[k]`` selects this file's rows of piece k, ``perm[i]`` is
    the destination of source element i (pieces concatenated)."""
    gsrc = np.concatenate(
        [(np.int64(k) << np.int64(48)) | np.asarray(idx, dtype=np.int64) for k, idx in enumerate(piece_indices)]
    )
    gidx = np.empty_like(gsrc)
    gidx[perm] = gsrc
    return gidx


# --------------------------------------------------------------------------
# Reader
class _ThriftIn:
    """Thrift compact-protocol reader: a struct reads as {field id: value},
    a list as a Python list; every field is kept, so unknown ones are
    skipped by never being looked at."""

    __slots__ = ("b", "p")

    def __init__(self, b: bytes):
        self.b = b
        self.p = 0

    def _u8(self) -> int:
        v = self.b[self.p]
        self.p += 1
        return v

    def _uleb(self) -> int:
        v = shift = 0
        while True:
            byte = self._u8()
            v |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return v
            shift += 7

    def _zz(self) -> int:
        v = self._uleb()
        return (v >> 1) ^ -(v & 1)

    def value(self, ttype: int, in_list: bool = False):
        if ttype in (1, 2):  # bool: in the field header, or a byte in a list
            return self._u8() == 1 if in_list else ttype == 1
        if ttype == 3:
            return struct.unpack("b", bytes([self._u8()]))[0]
        if ttype in (4, 5, 6):
            return self._zz()
        if ttype == 7:
            self.p += 8
            return struct.unpack("<d", self.b[self.p - 8: self.p])[0]
        if ttype == 8:
            n = self._uleb()
            self.p += n
            return self.b[self.p - n: self.p]
        if ttype in (9, 10):
            head = self._u8()
            n = head >> 4
            if n == 15:
                n = self._uleb()
            return [self.value(head & 0x0F, in_list=True) for _ in range(n)]
        if ttype == 11:
            n = self._uleb()
            if n == 0:
                return {}
            kv = self._u8()
            return dict((self.value(kv >> 4, True), self.value(kv & 0x0F, True)) for _ in range(n))
        if ttype == 12:
            out, last = {}, 0
            while True:
                head = self._u8()
                if head == 0:
                    return out
                delta = head >> 4
                fid = last + delta if delta else self._zz()
                out[fid] = self.value(head & 0x0F)
                last = fid
        raise OSError(f"corrupt parquet footer: thrift type {ttype}")


class ColumnInfo:
    __slots__ = ("name", "physical", "max_def", "dtype")

    def __init__(self, name, physical, max_def, dtype):
        self.name = name
        self.physical = physical  # dtype the pages hold
        self.max_def = max_def
        self.dtype = dtype  # dtype the reader returns


class Footer:
    """What the reader needs of a file's FileMetaData: its columns, and per
    row group its rows, ``total_byte_size`` and chunks
    ``(offset, size, num_values, codec)`` in column order."""

    __slots__ = ("path", "columns", "row_groups")

    def __init__(self, path, columns, row_groups):
        self.path = path
        self.columns: List[ColumnInfo] = columns
        self.row_groups: List[dict] = row_groups

    @property
    def num_rows(self) -> int:
        return sum(rg["num_rows"] for rg in self.row_groups)

    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]


def _leaf(elem: dict) -> ColumnInfo:
    name = elem[4].decode()
    if elem.get(3) == 2:
        raise unsupported(f"list or repeated columns ({name})")
    physical = elem.get(1)
    if physical not in _PHYSICAL:
        raise unsupported(f"{_PHYSICAL_NAMES.get(physical, physical)} columns ({name})")
    dtype = _PHYSICAL[physical]
    converted = elem.get(6)
    logical = elem.get(10)
    if converted in _NARROW and physical == 1:
        dtype = _NARROW[converted]
    elif converted is not None and converted not in _SIGNED_INTS:
        raise unsupported(f"converted type {converted} ({name})")
    elif logical is not None and not (10 in logical and logical[10].get(2, True)):
        # only the signed INTEGER logical type reads as its physical type
        raise unsupported(f"logical type {sorted(logical)} ({name})")
    return ColumnInfo(name, _PHYSICAL[physical], 1 if elem.get(3) == 1 else 0, dtype)


def read_footer(path: str) -> Footer:
    """The file's columns and row groups, from its FileMetaData."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < 12:
            raise OSError(f"{path}: not a parquet file")
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != b"PAR1":
            raise OSError(f"{path}: not a parquet file")
        (flen,) = struct.unpack("<I", tail[:4])
        f.seek(size - 8 - flen)
        meta = _ThriftIn(f.read(flen)).value(12)
    schema = meta.get(2, [])
    leaves = schema[1:]
    if any(5 in e for e in leaves) or schema[0].get(5, len(leaves)) != len(leaves):
        raise unsupported(f"nested or list columns ({path})")
    columns = [_leaf(e) for e in leaves]
    row_groups = []
    for rg in meta.get(4, []):
        chunks = []
        for col, cc in zip(columns, rg[1]):
            if 1 in cc:
                raise unsupported(f"column chunks in other files ({path})")
            md = cc[3]
            if 11 in md or _DICT_ENCODINGS & set(md.get(2, [])):
                raise unsupported(f"dictionary pages ({path}: {col.name})")
            codec = md[4]
            if codec not in (CODEC_UNCOMPRESSED, CODEC_ZSTD):
                raise unsupported(f"the {_CODEC_NAMES.get(codec, codec)} codec ({path}: {col.name})")
            chunks.append((md[9], md[7], md[5], codec))
        row_groups.append({"num_rows": rg[3], "total_byte_size": rg[2], "chunks": chunks})
    return Footer(path, columns, row_groups)


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max(1, min(16, os.cpu_count() or 1)), thread_name_prefix="nvt-parquet-read")
    return _POOL


def read_row_groups(path: str, row_groups: Optional[Sequence[int]] = None, columns: Optional[Sequence[str]] = None,
                    footer: Optional[Footer] = None) -> Dict[str, np.ndarray]:
    """{column: numpy values} of ``row_groups`` (all by default), in file
    order or in the order of ``columns``. Chunks decode in parallel, the
    GIL released."""
    footer = footer or read_footer(path)
    lib = _lib()
    names = footer.column_names
    want = names if columns is None else [c for c in columns if c in names]
    rgs = list(range(len(footer.row_groups))) if row_groups is None else list(row_groups)
    rows = [footer.row_groups[i]["num_rows"] for i in rgs]
    starts = np.concatenate([[0], np.cumsum(rows)]).astype(np.int64)
    out, jobs = {}, []
    for name in want:
        ci = names.index(name)
        info = footer.columns[ci]
        buf = np.empty(int(starts[-1]), dtype=info.physical)
        out[name] = buf
        for k, rg in enumerate(rgs):
            offset, size, num_values, codec = footer.row_groups[rg]["chunks"][ci]
            jobs.append((name, info, buf[starts[k]: starts[k + 1]], offset, size, num_values, codec))

    def run(job):
        name, info, dst, offset, size, num_values, codec = job
        if num_values != len(dst):
            raise OSError(f"{path}: column {name} holds {num_values} values in a row group of {len(dst)} rows")
        rc = lib.nvtpq_read_chunk(path.encode(), offset, size, num_values, _DTYPE_CODE[info.physical.name],
                                  info.max_def, codec, dst.ctypes.data)
        if rc != 0:
            _raise_rc(rc, f"{path}: column {name}")

    if len(jobs) > 1:
        list(_pool().map(run, jobs))
    else:
        for job in jobs:
            run(job)
    return {name: out[name].astype(footer.columns[names.index(name)].dtype, copy=False) for name in want}
