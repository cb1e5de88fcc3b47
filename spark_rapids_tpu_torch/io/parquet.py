"""Parquet files, encoded and decoded in numpy and the standard library.

The reference writes and reads Parquet through pyarrow
(``spark_rapids_tpu/io/writers.py:48 _write_one``,
``io/arrow_convert.py``); this engine has no pyarrow, so this module is
its codec, for the subset of Parquet that the writer needs:

  * the Thrift compact protocol for ``FileMetaData``, ``SchemaElement``,
    ``RowGroup``, ``ColumnChunk``, ``ColumnMetaData``, ``PageHeader``,
    ``DataPageHeader``, ``Statistics`` and the ``LogicalType`` union;
  * flat schemas; row groups of at most ``ROW_GROUP_ROWS`` rows, one
    data page (v1) a column chunk;
  * ``PLAIN`` values, only the non-null ones; definition levels of an
    OPTIONAL (nullable) field in the RLE/bit-packed hybrid at bit width
    1 behind its 4-byte length (an RLE run where the page is all valid
    or all null, else bit-packed groups); booleans bit-packed LSB first;
  * the types of ``io/arrow_convert.py:44 dtype_to_arrow`` and ``:99
    host_batch_to_arrow``, so that pyarrow reads a file of this module
    with the arrow schema of the reference's file: BOOL -> BOOLEAN;
    INT8/INT16 -> INT32 with INTEGER(8/16, signed) and INT_8/INT_16;
    INT32 -> INT32; INT64 -> INT64; FLOAT32 -> FLOAT; FLOAT64 -> DOUBLE;
    DATE32 -> INT32 DATE; TIMESTAMP -> INT64 TIMESTAMP(isAdjustedToUTC,
    MICROS) and TIMESTAMP_MICROS (pyarrow: ``timestamp[us, tz=UTC]``);
    STRING -> BYTE_ARRAY STRING/UTF8;
  * every chunk's ``null_count``, and ``min_value``/``max_value``
    wherever there is a valid value (none for a float chunk that holds
    NaN; a zero minimum written as -0.0, a zero maximum as +0.0); the
    column orders TypeDefinedOrder;
  * codecs: ``"snappy"`` (the reference's default, and this writer's),
    written as valid Snappy framing made of literal elements only: no
    matches, so no size gain over ``"none"``; ``"gzip"`` through zlib;
    ``"none"``/``"uncompressed"``.  Any other codec raises
    ``NotImplementedError``.

``read_file`` reads back at least what ``write_file`` writes, and
pyarrow's files of the same subset (snappy with matches included); it
raises ``NotImplementedError`` naming what it lacks (dictionary pages,
data page v2, other encodings and codecs, nested schemas).  It is not a
scan: the scan (``read_parquet``) is not ported yet.  Not written:
page-level statistics, page indexes, bloom filters, key-value metadata
(no ``ARROW:schema``).
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from .. import types as T
from ..data.column import HostBatch, HostColumn

MAGIC = b"PAR1"
#: rows of a row group at most (one data page a column chunk)
ROW_GROUP_ROWS = 1 << 20
CREATED_BY = "spark_rapids_tpu_torch version 0.13.0"

# ---------------------------------------------------------------------------
# parquet.thrift enums
# ---------------------------------------------------------------------------
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED = range(8)
REQUIRED, OPTIONAL, REPEATED = range(3)
ENC_PLAIN, ENC_RLE = 0, 3
ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE",
                  4: "BIT_PACKED", 5: "DELTA_BINARY_PACKED",
                  6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
                  8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
CODEC_UNCOMPRESSED, CODEC_SNAPPY, CODEC_GZIP = 0, 1, 2
CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO",
               4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
PAGE_DATA, PAGE_INDEX, PAGE_DICTIONARY, PAGE_DATA_V2 = range(4)
# converted types
CT_UTF8, CT_DATE, CT_TIMESTAMP_MICROS = 0, 6, 10
CT_INT_8, CT_INT_16 = 15, 16
# LogicalType union members
LT_STRING, LT_DATE, LT_TIMESTAMP, LT_INTEGER = 1, 6, 8, 10

# ---------------------------------------------------------------------------
# Thrift compact protocol
# ---------------------------------------------------------------------------
# compact type codes
C_TRUE, C_FALSE, C_BYTE, C_I16, C_I32, C_I64, C_DOUBLE, C_BINARY, \
    C_LIST, C_SET, C_MAP, C_STRUCT = range(1, 13)
C_BOOL = C_TRUE  # a boolean field's type before its value picks 1 or 2


def _varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _write_value(out: bytearray, ctype: int, v) -> None:
    if ctype in (C_I16, C_I32, C_I64):
        _varint(out, _zigzag(int(v)))
    elif ctype == C_BYTE:
        out += struct.pack("<b", int(v))
    elif ctype == C_BINARY:
        b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        _varint(out, len(b))
        out += b
    elif ctype == C_DOUBLE:
        out += struct.pack("<d", v)
    elif ctype == C_STRUCT:
        write_struct(out, v)
    elif ctype == C_LIST:
        etype, items = v
        if len(items) < 15:
            out.append((len(items) << 4) | etype)
        else:
            out.append(0xF0 | etype)
            _varint(out, len(items))
        for item in items:
            if etype == C_BOOL:
                out.append(C_TRUE if item else C_FALSE)
            else:
                _write_value(out, etype, item)
    else:
        raise ValueError(f"cannot write compact type {ctype}")


def write_struct(out: bytearray, fields) -> None:
    """``fields``: (field id, compact type, value) in increasing id
    order; None values are left out.  A STRUCT value is such a list, a
    LIST value ``(element type, items)``."""
    last = 0
    for fid, ctype, v in fields:
        if v is None:
            continue
        wire = (C_TRUE if v else C_FALSE) if ctype == C_BOOL else ctype
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | wire)
        else:
            out.append(wire)
            _varint(out, _zigzag(fid))
        last = fid
        if ctype != C_BOOL:
            _write_value(out, ctype, v)
    out.append(0)  # STOP


class _Reader:
    """Compact-protocol decoder over a bytes-like buffer: a struct reads
    as a dict of field id -> value (lists as lists, structs as dicts,
    binaries as bytes)."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def uvarint(self) -> int:
        shift = v = 0
        while True:
            b = self._byte()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7

    def zz(self) -> int:
        v = self.uvarint()
        return (v >> 1) ^ -(v & 1)

    def value(self, ctype: int):
        if ctype in (C_TRUE, C_FALSE):  # a list element
            return self._byte() == C_TRUE
        if ctype == C_BYTE:
            return struct.unpack("<b", bytes([self._byte()]))[0]
        if ctype in (C_I16, C_I32, C_I64):
            return self.zz()
        if ctype == C_DOUBLE:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ctype == C_BINARY:
            n = self.uvarint()
            v = bytes(self.buf[self.pos:self.pos + n])
            self.pos += n
            return v
        if ctype in (C_LIST, C_SET):
            head = self._byte()
            n, etype = head >> 4, head & 0x0F
            if n == 15:
                n = self.uvarint()
            return [self.value(etype) for _ in range(n)]
        if ctype == C_MAP:
            n = self.uvarint()
            if n == 0:
                return {}
            kv = self._byte()
            return {self.value(kv >> 4): self.value(kv & 0x0F)
                    for _ in range(n)}
        if ctype == C_STRUCT:
            return self.struct()
        raise ValueError(f"unknown compact type {ctype}")

    def struct(self) -> dict:
        out = {}
        last = 0
        while True:
            head = self._byte()
            if head == 0:
                return out
            ctype, delta = head & 0x0F, head >> 4
            fid = last + delta if delta else self.zz()
            last = fid
            if ctype in (C_TRUE, C_FALSE):
                out[fid] = ctype == C_TRUE
            else:
                out[fid] = self.value(ctype)


def read_struct(buf, pos: int = 0) -> Tuple[dict, int]:
    r = _Reader(buf, pos)
    return r.struct(), r.pos


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------
_PHYSICAL = {T.TypeId.BOOL: BOOLEAN, T.TypeId.INT8: INT32,
             T.TypeId.INT16: INT32, T.TypeId.INT32: INT32,
             T.TypeId.INT64: INT64, T.TypeId.FLOAT32: FLOAT,
             T.TypeId.FLOAT64: DOUBLE, T.TypeId.DATE32: INT32,
             T.TypeId.TIMESTAMP: INT64, T.TypeId.STRING: BYTE_ARRAY}
#: little-endian storage of each fixed-width physical type
_STORAGE = {INT32: np.dtype("<i4"), INT64: np.dtype("<i8"),
            FLOAT: np.dtype("<f4"), DOUBLE: np.dtype("<f8")}


def _schema_element(f: T.Field) -> list:
    tid = f.dtype.id
    if tid not in _PHYSICAL:
        raise TypeError(f"no Parquet type for {f.dtype}")
    converted = logical = None
    if tid in (T.TypeId.INT8, T.TypeId.INT16):
        bits = 8 if tid is T.TypeId.INT8 else 16
        converted = CT_INT_8 if bits == 8 else CT_INT_16
        logical = [(LT_INTEGER, C_STRUCT, [(1, C_BYTE, bits),
                                           (2, C_BOOL, True)])]
    elif tid is T.TypeId.DATE32:
        converted, logical = CT_DATE, [(LT_DATE, C_STRUCT, [])]
    elif tid is T.TypeId.TIMESTAMP:
        converted = CT_TIMESTAMP_MICROS
        logical = [(LT_TIMESTAMP, C_STRUCT, [
            (1, C_BOOL, True), (2, C_STRUCT, [(2, C_STRUCT, [])])])]
    elif tid is T.TypeId.STRING:
        converted, logical = CT_UTF8, [(LT_STRING, C_STRUCT, [])]
    return [(1, C_I32, _PHYSICAL[tid]),
            (3, C_I32, OPTIONAL if f.nullable else REQUIRED),
            (4, C_BINARY, f.name), (6, C_I32, converted),
            (10, C_STRUCT, logical)]


def _field_of(el: dict) -> T.Field:
    """The engine's field of a leaf SchemaElement."""
    name = el[4].decode("utf-8")
    ptype, conv, logical = el.get(1), el.get(6), el.get(10) or {}
    nullable = el.get(3, REQUIRED) == OPTIONAL
    if el.get(3) == REPEATED or el.get(5):
        raise NotImplementedError(f"nested or repeated field {name}")
    dt = None
    if ptype == BOOLEAN:
        dt = T.BOOL
    elif ptype == INT32:
        bits = logical.get(LT_INTEGER, {}).get(1) or \
            {CT_INT_8: 8, CT_INT_16: 16}.get(conv)
        if LT_DATE in logical or conv == CT_DATE:
            dt = T.DATE32
        elif bits in (8, 16):
            dt = T.INT8 if bits == 8 else T.INT16
        elif conv is None and not logical or bits == 32:
            dt = T.INT32
    elif ptype == INT64:
        ts = logical.get(LT_TIMESTAMP)
        if ts is not None:
            unit = next(iter(ts.get(2) or {0: None}))  # the TimeUnit union
            if unit != 2:
                raise NotImplementedError(
                    f"{name}: timestamp unit "
                    f"{ {1: 'MILLIS', 3: 'NANOS'}.get(unit, unit)} (MICROS "
                    "only)")
            dt = T.TIMESTAMP
        elif conv == CT_TIMESTAMP_MICROS:
            dt = T.TIMESTAMP
        elif conv is None and not logical or \
                logical.get(LT_INTEGER, {}).get(1) == 64:
            dt = T.INT64
    elif ptype == FLOAT:
        dt = T.FLOAT32
    elif ptype == DOUBLE:
        dt = T.FLOAT64
    elif ptype == BYTE_ARRAY and (LT_STRING in logical or conv == CT_UTF8):
        dt = T.STRING
    if dt is None:
        raise TypeError(f"{name}: unsupported Parquet type (physical "
                        f"{ptype}, converted {conv}, logical {logical})")
    return T.Field(name, dt, nullable)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------
def codec_of(name) -> int:
    key = "none" if name is None else str(name).lower()
    if key in ("none", "uncompressed"):
        return CODEC_UNCOMPRESSED
    if key == "snappy":
        return CODEC_SNAPPY
    if key == "gzip":
        return CODEC_GZIP
    raise NotImplementedError(
        f"Parquet compression codec {name!r} is not supported (snappy, "
        "gzip, none)")


def snappy_literal_header(n: int) -> bytes:
    """The Snappy framing of ``n`` bytes as one literal element: the
    preamble (varint of ``n``), then the literal's tag, ``(59 + k) << 2``
    and ``n - 1`` in k little-endian bytes past 60 bytes.  The ``n``
    bytes follow as they are."""
    out = bytearray()
    _varint(out, n)
    if n == 0:
        return bytes(out)
    m = n - 1
    if m < 60:
        out.append(m << 2)
    else:
        k = (m.bit_length() + 7) // 8
        out.append((59 + k) << 2)
        out += m.to_bytes(k, "little")
    return bytes(out)


def _compress(codec: int, pieces: List) -> List:
    """The page body ``pieces`` (bytes-like) compressed, as pieces."""
    if codec == CODEC_UNCOMPRESSED:
        return pieces
    n = sum(memoryview(p).nbytes for p in pieces)
    if codec == CODEC_SNAPPY:
        return [snappy_literal_header(n)] + pieces
    z = zlib.compressobj(6, zlib.DEFLATED, 31)  # gzip framing
    return [b"".join(z.compress(p) for p in pieces) + z.flush()]


def snappy_decompress(buf) -> bytes:
    """Raw Snappy: literals and copies (with 1-, 2- and 4-byte offsets;
    a copy may overlap its own output)."""
    r = _Reader(buf)
    n = r.uvarint()
    out = bytearray(n)
    pos, o, end = r.pos, 0, len(buf)
    while pos < end:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            m = tag >> 2
            if m >= 60:
                k = m - 59
                m = int.from_bytes(buf[pos:pos + k], "little")
                pos += k
            m += 1
            out[o:o + m] = buf[pos:pos + m]
            pos += m
            o += m
            continue
        if kind == 1:
            m = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:
            m = (tag >> 2) + 1
            off = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:
            m = (tag >> 2) + 1
            off = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > o:
            raise ValueError("corrupt Snappy copy offset")
        src = o - off
        if off >= m:
            out[o:o + m] = out[src:src + m]
        else:
            pat = bytes(out[src:o])
            out[o:o + m] = (pat * (m // off + 1))[:m]
        o += m
    if o != n:
        raise ValueError(f"Snappy: {o} bytes decoded, {n} announced")
    return bytes(out)


def _decompress(codec: int, body):
    if codec == CODEC_UNCOMPRESSED:
        return body
    if codec == CODEC_SNAPPY:
        return snappy_decompress(body)
    if codec == CODEC_GZIP:
        return zlib.decompress(bytes(body), 47)
    raise NotImplementedError(
        f"Parquet compression codec {CODEC_NAMES.get(codec, codec)}")


# ---------------------------------------------------------------------------
# encoding a column chunk
# ---------------------------------------------------------------------------
def _def_levels(valid: np.ndarray) -> bytes:
    """Definition levels at bit width 1 in the RLE/bit-packed hybrid,
    behind their 4-byte length: one RLE run for a page all valid or all
    null, else bit-packed groups of 8 (the last one padded)."""
    n = valid.shape[0]
    run = bytearray()
    if n and (valid.all() or not valid.any()):
        _varint(run, n << 1)
        run.append(int(valid[0]))
        body = bytes(run)
    else:
        _varint(run, (((n + 7) // 8) << 1) | 1)
        body = bytes(run) + np.packbits(valid, bitorder="little").tobytes()
    return struct.pack("<I", len(body)) + body


def _all_valid_levels(n: int) -> bytes:
    """``_def_levels`` of ``n`` valid rows: one RLE run of 1s."""
    if n == 0:
        return _def_levels(np.zeros(0, np.bool_))
    run = bytearray()
    _varint(run, n << 1)
    run.append(1)
    return struct.pack("<I", len(run)) + bytes(run)


def _inside(counts: np.ndarray, width: int) -> np.ndarray:
    """bool[n, width]: the first ``counts[i]`` columns of row ``i`` (a row
    of a small table per count, taken by each row's count: cheaper than
    a broadcast compare)."""
    table = np.arange(width)[None, :] < np.arange(width + 1)[:, None]
    return np.take(table, np.clip(counts, 0, width), axis=0)


def _plain_strings(data: np.ndarray, lengths: np.ndarray):
    """PLAIN BYTE_ARRAY: each value's 4-byte length, then its bytes."""
    n, w = data.shape
    rec = np.empty((n, 4 + w), dtype=np.uint8)
    rec[:, :4] = lengths.astype("<u4").view(np.uint8).reshape(n, 4)
    rec[:, 4:] = data
    return rec[_inside(lengths.astype(np.int64) + 4, 4 + w)]


def _prefix_keys(data: np.ndarray, lengths: np.ndarray, j: int, rows=None):
    """Bytes [8j, 8j + 8) of each row (of ``rows``) as a big-endian
    uint64, the bytes past a row's length as 0: the rows' order in that
    window."""
    src = data[:, 8 * j:8 * j + 8]
    lens = lengths
    if rows is not None:
        src, lens = np.take(src, rows, axis=0), lengths[rows]
    blk = np.zeros((src.shape[0], 8), np.uint8)
    blk[:, :src.shape[1]] = src
    np.multiply(blk, _inside(lens.astype(np.int64) - 8 * j, 8), out=blk,
                casting="unsafe")
    return blk.view(">u8")[:, 0]


def _string_bounds(data: np.ndarray, lengths: np.ndarray):
    """The smallest and the largest value in unsigned byte order, found
    8 bytes at a time over the rows still tied: bytes past a value's
    length count as 0, and a tie goes to the shorter (longer) value."""
    first = _prefix_keys(data, lengths, 0)
    out = []
    for largest in (False, True):
        keys, cand = first, None
        for j in range(-(-data.shape[1] // 8)):
            if j:
                keys = _prefix_keys(data, lengths, j, cand)
            hit = np.flatnonzero(keys == (keys.max() if largest
                                          else keys.min()))
            cand = hit if cand is None else cand[hit]
            if cand.shape[0] == 1:
                break
        ln = lengths[cand]
        best = cand[np.argmax(ln) if largest else np.argmin(ln)]
        out.append(data[best, :lengths[best]].tobytes())
    return out


def _statistics(ptype: int, vals, lengths, n_null: int):
    """Statistics fields of a chunk's valid values ``vals``."""
    stats = [(3, C_I64, n_null)]
    if vals.shape[0] == 0:
        return stats
    if ptype == BYTE_ARRAY:
        lo, hi = _string_bounds(vals, lengths)
    elif ptype == BOOLEAN:
        lo, hi = bytes([int(vals.all())]), bytes([int(vals.any())])
    else:
        st = _STORAGE[ptype]
        if ptype in (FLOAT, DOUBLE):
            if np.isnan(vals).any():
                return stats
            lo_v, hi_v = vals.min(), vals.max()
            lo_v = -abs(lo_v) if lo_v == 0 else lo_v  # -0.0
            hi_v = abs(hi_v) if hi_v == 0 else hi_v   # +0.0
        else:
            lo_v, hi_v = vals.min(), vals.max()
        lo = np.asarray(lo_v).astype(st).tobytes()
        hi = np.asarray(hi_v).astype(st).tobytes()
    return stats + [(5, C_BINARY, hi), (6, C_BINARY, lo)]


def _values(f: T.Field, ptype: int, col: HostColumn, lo: int, hi: int):
    """Rows [lo, hi) of ``col``: (PLAIN bytes of the non-null values,
    definition levels or None, statistics fields)."""
    valid = None if col.validity is None else col.validity[lo:hi]
    data = col.data[lo:hi]
    lengths = None if col.lengths is None else col.lengths[lo:hi]
    if valid is not None:
        data = data[valid]
        lengths = None if lengths is None else lengths[valid]
    n_null = 0 if valid is None else int(hi - lo - data.shape[0])
    if n_null and not f.nullable:
        raise ValueError(f"{f.name} is not nullable and holds nulls")
    if ptype == BYTE_ARRAY:
        body = _plain_strings(data, lengths)
    elif ptype == BOOLEAN:
        body = np.packbits(data.astype(np.bool_), bitorder="little")
    else:
        body = np.ascontiguousarray(data.astype(_STORAGE[ptype],
                                                copy=False))
    stats = _statistics(ptype, data, lengths, n_null)
    levels = None
    if f.nullable:
        levels = _def_levels(valid) if valid is not None \
            else _all_valid_levels(hi - lo)
    return body, levels, stats


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------
def _chunk(f: T.Field, ptype: int, col: HostColumn, lo: int, hi: int,
           codec: int):
    """One column chunk of rows [lo, hi): its page header, its
    (compressed) page pieces and its ColumnMetaData fields but the page
    offset (the last element of the list, filled in by the writer)."""
    body, levels, stats = _values(f, ptype, col, lo, hi)
    pieces = ([levels] if levels is not None else []) + [body]
    size = sum(memoryview(p).nbytes for p in pieces)
    comp = _compress(codec, pieces)
    csize = sum(memoryview(p).nbytes for p in comp)
    header = bytearray()
    write_struct(header, [
        (1, C_I32, PAGE_DATA), (2, C_I32, size), (3, C_I32, csize),
        (5, C_STRUCT, [(1, C_I32, hi - lo), (2, C_I32, ENC_PLAIN),
                       (3, C_I32, ENC_RLE), (4, C_I32, ENC_RLE)])])
    meta = [(1, C_I32, ptype), (2, C_LIST, (C_I32, [ENC_PLAIN, ENC_RLE])),
            (3, C_LIST, (C_BINARY, [f.name])), (4, C_I32, codec),
            (5, C_I64, hi - lo), (6, C_I64, len(header) + size),
            (7, C_I64, len(header) + csize), None, (12, C_STRUCT, stats)]
    return header, comp, meta


#: a row group of at least this many rows has its column chunks encoded
#: by threads at once (numpy releases the GIL in its copies and compares)
POOL_ROWS = 1 << 16


def _encode_row_group(pool, schema, ptypes, batch, lo: int, hi: int,
                      codec: int):
    jobs = [(f, ptype, col, lo, hi, codec)
            for f, ptype, col in zip(schema, ptypes, batch.columns)]
    if pool is None or hi - lo < POOL_ROWS or len(jobs) < 2:
        return [_chunk(*job) for job in jobs]
    return list(pool.map(lambda job: _chunk(*job), jobs))


def write_file(path: str, batch: HostBatch, compression="snappy",
               row_group_rows: int = ROW_GROUP_ROWS,
               timings: Optional[dict] = None) -> int:
    """Write ``batch`` as one Parquet file; returns its size in bytes.
    A row group of ``POOL_ROWS`` rows or more has its column chunks
    encoded by threads.  ``timings``, where given, gets the nanoseconds
    spent in ``open``, ``write`` and ``close`` added to its
    ``"io_ns"``."""
    codec = codec_of(compression)
    schema = batch.schema
    ptypes = [_PHYSICAL.get(f.dtype.id) for f in schema]
    elements = [[(3, C_I32, REQUIRED), (4, C_BINARY, "schema"),
                 (5, C_I32, len(schema))]]
    elements += [_schema_element(f) for f in schema]
    n = batch.num_rows
    row_groups = []
    pool = ThreadPoolExecutor(min(8, os.cpu_count() or 1)) \
        if n >= POOL_ROWS and len(schema) > 1 else None
    clock = time.perf_counter_ns
    t0 = clock()
    fh = open(path, "wb")
    io_ns = clock() - t0

    def put(*pieces) -> int:
        nonlocal io_ns
        t = clock()
        for p in pieces:
            fh.write(p)
        io_ns += clock() - t
        return sum(memoryview(p).nbytes for p in pieces)

    try:
        pos = put(MAGIC)
        for lo in range(0, n, max(1, row_group_rows)):
            hi = min(n, lo + row_group_rows)
            chunks, rg_bytes, rg_start, rg_compressed = [], 0, pos, 0
            for header, comp, meta in _encode_row_group(
                    pool, schema, ptypes, batch, lo, hi, codec):
                page_at = pos
                pos += put(header, *comp)
                meta[7] = (9, C_I64, page_at)
                chunks.append([(2, C_I64, page_at), (3, C_STRUCT, meta)])
                rg_bytes += meta[5][2]
                rg_compressed += meta[6][2]
            row_groups.append([(1, C_LIST, (C_STRUCT, chunks)),
                               (2, C_I64, rg_bytes), (3, C_I64, hi - lo),
                               (5, C_I64, rg_start),
                               (6, C_I64, rg_compressed)])
        footer = bytearray()
        write_struct(footer, [
            (1, C_I32, 2), (2, C_LIST, (C_STRUCT, elements)),
            (3, C_I64, n), (4, C_LIST, (C_STRUCT, row_groups)),
            (6, C_BINARY, CREATED_BY),
            (7, C_LIST, (C_STRUCT, [[(1, C_STRUCT, [])]] * len(schema)))])
        pos += put(footer, struct.pack("<I", len(footer)), MAGIC)
    finally:
        if pool is not None:
            pool.shutdown()
        t = clock()
        fh.close()
        io_ns += clock() - t
        if timings is not None:
            timings["io_ns"] = timings.get("io_ns", 0) + io_ns
    return pos


# ---------------------------------------------------------------------------
# read
# ---------------------------------------------------------------------------
def read_metadata(buf) -> dict:
    """The FileMetaData of a whole file's bytes, as field id -> value."""
    if len(buf) < 12 or bytes(buf[:4]) != MAGIC or \
            bytes(buf[-4:]) != MAGIC:
        raise ValueError("not a Parquet file")
    n = struct.unpack_from("<I", buf, len(buf) - 8)[0]
    return read_struct(buf, len(buf) - 8 - n)[0]


def _hybrid(buf, pos: int, end: int, n: int) -> np.ndarray:
    """``n`` levels of bit width 1 in the RLE/bit-packed hybrid."""
    r = _Reader(buf, pos)
    parts, got = [], 0
    while got < n and r.pos < end:
        head = r.uvarint()
        if head & 1:
            groups = head >> 1
            bits = np.unpackbits(np.frombuffer(buf, np.uint8, groups,
                                               r.pos), bitorder="little")
            r.pos += groups
            parts.append(bits.astype(np.bool_))
            got += bits.shape[0]
        else:
            count = head >> 1
            parts.append(np.full(count, bool(r._byte()), np.bool_))
            got += count
    if got < n:
        raise ValueError(f"definition levels: {got} of {n} decoded")
    return np.concatenate(parts)[:n] if parts else np.zeros(0, np.bool_)


def _plain_byte_arrays(buf, pos: int, count: int):
    """(start offsets, lengths) of ``count`` PLAIN BYTE_ARRAY values: a
    value's offset depends on every length before it, so they are read
    one by one (~0.3 us a value on one core)."""
    unpack = struct.Struct("<I").unpack_from
    ends = []
    append = ends.append
    p = pos
    for _ in range(count):
        p += unpack(buf, p)[0] + 4
        append(p)
    ends = np.array(ends, np.int64)
    starts = np.empty(count, np.int64)
    starts[:1] = pos
    starts[1:] = ends[:-1]
    return starts + 4, ends - starts - 4


def _strings_matrix(buf, starts, lens) -> Tuple[np.ndarray, np.ndarray]:
    """The values at ``starts`` (each behind its 4-byte length, one after
    another) as a zero-padded byte matrix and their lengths."""
    n = lens.shape[0]
    out = np.zeros((n, max(1, int(lens.max()) if n else 0)), np.uint8)
    if n:
        lo, hi = int(starts[0]) - 4, int(starts[-1] + lens[-1])
        keep = np.ones(hi - lo, np.bool_)
        for k in range(4):  # drop the length prefixes
            keep[starts - 4 - lo + k] = False
        out[_inside(lens, out.shape[1])] = \
            np.frombuffer(buf, np.uint8, hi - lo, lo)[keep]
    return out, lens.astype(np.int32)


def _read_page(buf, pos: int, codec: int, field: T.Field, ptype: int):
    """One page at ``pos``: (next position, rows, validity, values) with
    the values of the valid rows only (strings as (matrix, lengths));
    rows None for a page that holds no rows."""
    header, pos = read_struct(buf, pos)
    ptype_page = header[1]
    csize = header[3]
    raw = memoryview(buf)[pos:pos + csize]
    nxt = pos + csize
    if ptype_page == PAGE_DICTIONARY:
        enc = header.get(7, {}).get(2)
        raise NotImplementedError(
            f"{field.name}: dictionary page ({ENCODING_NAMES.get(enc, enc)}"
            " encoding); only PLAIN data pages are read")
    if ptype_page == PAGE_DATA_V2:
        raise NotImplementedError(f"{field.name}: data page v2")
    if ptype_page != PAGE_DATA:
        return nxt, None, None, None
    dph = header[5]
    n, enc = dph[1], dph[2]
    body = _decompress(codec, raw)
    at = 0
    if field.nullable:
        if dph[3] != ENC_RLE:
            raise NotImplementedError(
                f"{field.name}: definition levels in "
                f"{ENCODING_NAMES.get(dph[3], dph[3])}")
        m = struct.unpack_from("<I", body, 0)[0]
        valid = _hybrid(body, 4, 4 + m, n)
        at = 4 + m
    else:
        valid = np.ones(n, np.bool_)
    if enc != ENC_PLAIN:
        raise NotImplementedError(
            f"{field.name}: {ENCODING_NAMES.get(enc, enc)} encoding; only "
            "PLAIN is read")
    k = int(valid.sum())
    if ptype == BYTE_ARRAY:
        starts, lens = _plain_byte_arrays(body, at, k)
        vals = _strings_matrix(body, starts, lens)
    elif ptype == BOOLEAN:
        vals = np.unpackbits(np.frombuffer(body, np.uint8, (k + 7) // 8, at),
                             bitorder="little")[:k].astype(np.bool_)
    else:
        vals = np.frombuffer(body, _STORAGE[ptype], k, at)
    return nxt, n, valid, vals


def _assemble(field: T.Field, pages) -> HostColumn:
    """One column from its pages' (validity, valid values): a page with
    no null is copied as a block, others row by row."""
    valid = np.concatenate([v for v, _ in pages]) if pages \
        else np.zeros(0, np.bool_)
    n = valid.shape[0]
    dt = field.dtype
    w = max([1] + [m.shape[1] for _, (m, _l) in pages]) if dt.is_string \
        else 0
    data = np.zeros((n, w) if dt.is_string else n,
                    np.uint8 if dt.is_string else dt.np_dtype)
    lengths = np.zeros(n, np.int32) if dt.is_string else None
    at = 0
    for v, vals in pages:
        rows = slice(at, at + v.shape[0]) if v.all() \
            else at + np.flatnonzero(v)
        if dt.is_string:
            m, ln = vals
            data[rows, :m.shape[1]] = m
            lengths[rows] = ln
        else:
            data[rows] = vals
        at += v.shape[0]
    return HostColumn(dt, data, valid, lengths)


def _chunk_pages(buf, pos: int, total: int, codec: int, field: T.Field,
                 ptype: int) -> list:
    """The (validity, values) of each data page of a column chunk of
    ``total`` values whose first page is at ``pos`` of ``buf``."""
    pages, got = [], 0
    while got < total:
        pos, n, valid, vals = _read_page(buf, pos, codec, field, ptype)
        if n is not None:
            pages.append((valid, vals))
            got += n
    return pages


def read_file(path: str, row_groups=None) -> HostBatch:
    """The rows of a Parquet file of flat columns (of the row groups
    numbered in ``row_groups``, all by default), in file order, as a
    host batch; raises ``NotImplementedError`` on what this codec lacks
    (dictionary pages, data page v2, encodings other than PLAIN and RLE
    levels, codecs other than snappy, gzip and none).  With
    ``row_groups`` only those column chunks' bytes are read."""
    with open(path, "rb") as fh:
        if row_groups is None:
            buf = fh.read()
            meta = read_metadata(buf)
        else:
            fh.seek(0, 2)
            size = fh.tell()
            fh.seek(max(0, size - 8))
            tail = fh.read(8)
            if size < 12 or tail[4:] != MAGIC:
                raise ValueError("not a Parquet file")
            n_footer = struct.unpack("<I", tail[:4])[0]
            fh.seek(size - 8 - n_footer)
            meta = read_struct(fh.read(n_footer))[0]
        elements = meta[2]
        root, leaves = elements[0], elements[1:]
        if root.get(5, 0) != len(leaves):
            raise NotImplementedError("nested Parquet schema")
        fields = [_field_of(el) for el in leaves]
        ptypes = [el.get(1) for el in leaves]
        pages: List[list] = [[] for _ in fields]
        groups = meta.get(4, [])
        for ri in (range(len(groups)) if row_groups is None else row_groups):
            for ci, cc in enumerate(groups[ri][1]):
                cm = cc[3]
                start = cm.get(11, cm[9])
                if row_groups is None:
                    chunk, pos = buf, start
                else:
                    fh.seek(start)
                    chunk, pos = fh.read(cm[7]), 0
                pages[ci] += _chunk_pages(chunk, pos, cm[5], cm[4],
                                          fields[ci], ptypes[ci])
    cols = [_assemble(f, p) for f, p in zip(fields, pages)]
    return HostBatch(T.Schema(fields), cols)
