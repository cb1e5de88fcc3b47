"""Columnar data plane.

Counterpart of ``spark_rapids_tpu/data/column.py`` without pytrees.
An upload to a CUDA device is packed as the reference's is
(``_pack_host``, ``packed_upload``): every array of the batch at an
8-byte-aligned offset of one pinned host buffer, sent with one
non-blocking copy, each column's tensors views of the device buffer
(the reference's ``_unpack_fn`` slices and bitcasts; a torch view needs
no kernel, so no layout cache and no byte-order self-check either).  The
batch's row count rides at the end of the same buffer.  An upload to the
CPU takes each array as it is staged, with no copy.

  * A host column is numpy data + optional validity (True = valid); a
    STRING host column holds a ``uint8[rows, width]`` byte matrix and
    ``int32`` lengths.
  * A device batch is torch tensors on one device: data ``[padded]`` (or
    ``uint8[padded, width]`` + ``int32`` lengths for strings), validity
    ``torch.bool[padded]``, and ``num_rows`` as a 0-d ``int32`` tensor on
    the same device.  Rows are padded to power-of-two buckets; rows past
    ``num_rows`` are invalid padding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..types import DType, Field, Schema
from . import strings as dstrings


# --------------------------------------------------------------------------
# Host side
# --------------------------------------------------------------------------
class HostColumn:
    """numpy data + optional validity; strings as (bytes, lengths)."""

    __slots__ = ("dtype", "data", "validity", "lengths")

    def __init__(self, dtype: DType, data: np.ndarray,
                 validity: Optional[np.ndarray] = None,
                 lengths: Optional[np.ndarray] = None):
        self.dtype = dtype
        self.data = data
        if validity is not None:
            validity = np.asarray(validity, dtype=np.bool_)
            if bool(validity.all()):
                validity = None
        self.validity = validity
        if dtype.is_string and lengths is None:
            raise ValueError("a STRING host column needs lengths")
        self.lengths = lengths

    @staticmethod
    def from_pylist(values: Sequence[Any], dtype: DType) -> "HostColumn":
        n = len(values)
        validity = np.fromiter((v is not None for v in values),
                               dtype=np.bool_, count=n)
        if dtype.is_string:
            bm, ln = dstrings.encode(list(values), validity)
            return HostColumn(dtype, bm, validity, ln)
        data = np.zeros(n, dtype=dtype.np_dtype)
        for i, v in enumerate(values):
            if v is not None:
                data[i] = v
        return HostColumn(dtype, data, validity)

    @staticmethod
    def nulls(n: int, dtype: DType) -> "HostColumn":
        if dtype.is_string:
            return HostColumn(dtype, np.zeros((n, 1), np.uint8),
                              np.zeros(n, np.bool_), np.zeros(n, np.int32))
        return HostColumn(dtype, np.zeros(n, dtype=dtype.np_dtype),
                          np.zeros(n, dtype=np.bool_))

    @property
    def num_rows(self) -> int:
        return int(self.data.shape[0])

    def is_valid(self) -> np.ndarray:
        if self.validity is None:
            return np.ones(self.num_rows, dtype=np.bool_)
        return self.validity

    def __getitem__(self, i: int):
        if self.validity is not None and not self.validity[i]:
            return None
        if self.dtype.is_string:
            return dstrings.decode_one(self.data[i], self.lengths[i])
        v = self.data[i]
        return v.item() if hasattr(v, "item") else v

    def to_pylist(self) -> List[Any]:
        return [self[i] for i in range(self.num_rows)]

    def slice(self, start: int, stop: int) -> "HostColumn":
        v = None if self.validity is None else self.validity[start:stop]
        ln = None if self.lengths is None else self.lengths[start:stop]
        return HostColumn(self.dtype, self.data[start:stop], v, ln)

    @staticmethod
    def concat(cols: Sequence["HostColumn"]) -> "HostColumn":
        if not cols:
            raise ValueError("concat of zero columns")
        dtype = cols[0].dtype
        validity = None
        if any(c.validity is not None for c in cols):
            validity = np.concatenate([c.is_valid() for c in cols])
        if dtype.is_string:
            # a column of type NULL (an Expand's untyped null in a string
            # field) joins as nulls, as the reference's host concat takes
            # it
            cols = [c if c.dtype.is_string else
                    HostColumn.nulls(c.num_rows, dtype) for c in cols]
            w = max(c.data.shape[1] for c in cols)
            data = np.concatenate([dstrings.pad_width(c.data, w)
                                   for c in cols])
            lengths = np.concatenate([c.lengths for c in cols])
            return HostColumn(dtype, data, validity, lengths)
        return HostColumn(dtype, np.concatenate([c.data for c in cols]),
                          validity)

    def __repr__(self):  # pragma: no cover
        return f"HostColumn({self.dtype}, rows={self.num_rows})"


class HostBatch:
    """An ordered set of equal-length host columns."""

    __slots__ = ("schema", "columns")

    def __init__(self, schema: Schema, columns: List[HostColumn]):
        if len(schema) != len(columns):
            raise ValueError("schema and columns differ in length")
        self.schema = schema
        self.columns = columns

    @property
    def num_rows(self) -> int:
        return self.columns[0].num_rows if self.columns else 0

    def column(self, i) -> HostColumn:
        if isinstance(i, str):
            i = self.schema.index_of(i)
        return self.columns[i]

    def slice(self, start: int, stop: int) -> "HostBatch":
        return HostBatch(self.schema,
                         [c.slice(start, stop) for c in self.columns])

    @staticmethod
    def concat(batches: Sequence["HostBatch"]) -> "HostBatch":
        schema = batches[0].schema
        return HostBatch(schema, [
            HostColumn.concat([b.columns[i] for b in batches])
            for i in range(len(schema))])

    @staticmethod
    def from_pydict(d, schema: Optional[Schema] = None) -> "HostBatch":
        if schema is None:
            fields, cols = [], []
            for name, values in d.items():
                values = list(values)
                col = HostColumn.from_pylist(values,
                                             _infer_pylist_dtype(values))
                fields.append(Field(name, col.dtype))
                cols.append(col)
            return HostBatch(Schema(fields), cols)
        return HostBatch(schema, [
            HostColumn.from_pylist(list(d[f.name]), f.dtype)
            for f in schema])

    def to_pydict(self):
        return {f.name: c.to_pylist()
                for f, c in zip(self.schema, self.columns)}

    def to_rows(self) -> List[tuple]:
        cols = [c.to_pylist() for c in self.columns]
        return list(zip(*cols)) if cols else []

    def estimate_bytes(self) -> int:
        """Bytes of the data plus a validity-bitmap estimate, the same
        number as the reference's ``HostBatch.estimate_bytes`` for the
        same columns (the broadcast decision rests on it): a string
        column counts the UTF-8 bytes of ~1,024 strided sample rows
        (nulls count 0), extrapolated, plus 4 bytes a row."""
        total = 0
        for c in self.columns:
            n = c.num_rows
            if c.dtype.is_string:
                if n:
                    step = max(1, n // 1024)
                    sample = np.where(c.is_valid()[::step],
                                      c.lengths[::step], 0)
                    total += int(int(sample.sum()) * (n / len(sample))) \
                        + 4 * n
            else:
                total += c.data.nbytes
            total += (n + 7) // 8
        return total

    def __repr__(self):  # pragma: no cover
        return f"HostBatch(rows={self.num_rows}, schema={self.schema})"


def _infer_pylist_dtype(values) -> DType:
    from ..types import BOOL, FLOAT64, INT64, STRING

    for v in values:
        if v is None:
            continue
        if isinstance(v, (bool, np.bool_)):
            return BOOL
        if isinstance(v, (int, np.integer)):
            return INT64
        if isinstance(v, (float, np.floating)):
            return FLOAT64
        if isinstance(v, str):
            return STRING
        raise TypeError(f"cannot infer dtype from {v!r}")
    return STRING  # all-null column


# --------------------------------------------------------------------------
# Bucketing
# --------------------------------------------------------------------------
def bucket_rows(n: int, min_rows: int = 128) -> int:
    """Pad row counts to power-of-two buckets (>= min_rows)."""
    b = max(min_rows, 1)
    need = max(n, 1)
    while b < need:
        b <<= 1
    return b


# --------------------------------------------------------------------------
# Device side
# --------------------------------------------------------------------------
@dataclass
class DeviceColumn:
    """``data``: [padded] (or uint8[padded, width] for strings);
    ``validity``: torch.bool[padded]; ``lengths``: int32[padded] for
    strings only."""

    dtype: DType
    data: Any
    validity: Any
    lengths: Any = None

    @property
    def padded_rows(self) -> int:
        return int(self.data.shape[0])


class DeviceBatch:
    """Device columns with a logical row count (0-d int32 tensor on the
    batch's device) <= padded rows."""

    __slots__ = ("schema", "columns", "num_rows")

    def __init__(self, schema: Schema, columns: List[DeviceColumn],
                 num_rows: torch.Tensor):
        self.schema = schema
        self.columns = columns
        self.num_rows = num_rows

    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    @property
    def padded_rows(self) -> int:
        return self.columns[0].padded_rows if self.columns else 0

    def row_mask(self) -> torch.Tensor:
        """bool[padded]: True for logical rows, False for padding."""
        return torch.arange(self.padded_rows, dtype=torch.int32,
                            device=self.device) < self.num_rows

    def device_bytes(self) -> int:
        total = 0
        for c in self.columns:
            total += c.data.numel() * c.data.element_size()
            total += c.validity.numel()
            if c.lengths is not None:
                total += c.lengths.numel() * 4
        return total

    def __repr__(self):  # pragma: no cover
        return (f"DeviceBatch(padded={self.padded_rows}, "
                f"schema={self.schema})")


def slice_device_batch(batch: DeviceBatch, start: int, stop: int,
                       min_bucket_rows: int = 128) -> DeviceBatch:
    """Rows [start, stop) of a device batch, re-bucketed to their own
    padded size (a plain data move; cuts sorted runs into tiles)."""
    n = stop - start
    padded = bucket_rows(n, min_bucket_rows)
    dev = batch.device
    cols: List[DeviceColumn] = []
    for c in batch.columns:
        validity = torch.zeros(padded, dtype=torch.bool, device=dev)
        validity[:n] = c.validity[start:stop]
        data = torch.zeros((padded,) + tuple(c.data.shape[1:]),
                           dtype=c.data.dtype, device=dev)
        data[:n] = c.data[start:stop]
        lengths = None
        if c.lengths is not None:
            lengths = torch.zeros(padded, dtype=c.lengths.dtype, device=dev)
            lengths[:n] = c.lengths[start:stop]
        cols.append(DeviceColumn(c.dtype, data, validity, lengths))
    return DeviceBatch(batch.schema, cols,
                       torch.tensor(n, dtype=torch.int32, device=dev))


# --------------------------------------------------------------------------
# Transfers
# --------------------------------------------------------------------------
def _staged(arr: np.ndarray, padded: int, device: torch.device,
            fill_rows: Optional[np.ndarray] = None) -> torch.Tensor:
    """Copy ``arr`` (rows beyond it zero) into one host buffer of
    ``padded`` rows — pinned when the target is a CUDA device — and send
    it with a non-blocking copy."""
    n = arr.shape[0]
    shape = (padded,) + tuple(arr.shape[1:])
    pin = device.type == "cuda"
    host = torch.empty(shape, dtype=_torch_of(arr.dtype), pin_memory=pin)
    view = host.numpy()
    if fill_rows is None:
        view[:n] = arr
    else:  # zero the invalid lanes so kernels stay deterministic
        np.copyto(view[:n], arr, casting="no")
        view[:n][~fill_rows] = 0
    view[n:] = 0
    if device.type == "cpu":
        return host
    return host.to(device, non_blocking=True)


def _torch_of(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=np_dtype)).dtype


def _upload_arrays(batch: HostBatch, padded: int) -> List[tuple]:
    """The arrays of an upload in the reference's order (a string
    column's bytes, validity and lengths; any other column's data and
    validity), each as ``(host array, padded shape, valid rows whose
    complement is zeroed or None)``."""
    out = []
    for c in batch.columns:
        valid = c.is_valid()
        if c.dtype.is_string:
            out += [(c.data, (padded, c.data.shape[1]), None),
                    (valid, (padded,), None),
                    (c.lengths.astype(np.int32, copy=False), (padded,),
                     None)]
        else:
            out += [(c.data.astype(c.dtype.np_dtype, copy=False),
                     (padded,), None if c.validity is None else valid),
                    (valid, (padded,), None)]
    return out


def _pack_host(arrays: Sequence[tuple], pin: bool = False):
    """Every array of ``arrays`` (``_upload_arrays``' triples) written
    into one uint8 host tensor (pinned if ``pin``) at the reference's
    layout: each array at the next 8-byte-aligned offset, zero-padded to
    its padded shape, the gaps zero.  Returns the buffer and the layout,
    ``((offset, shape, dtype.str), ...)``."""
    layout, off = [], 0
    for a, shape, _valid in arrays:
        off = (off + 7) & ~7
        layout.append((off, shape, a.dtype.str))
        off += int(np.prod(shape, dtype=np.int64)) * a.dtype.itemsize
    buf = torch.empty(max(off, 1), dtype=torch.uint8, pin_memory=pin)
    view = buf.numpy()
    end = 0
    for (o, shape, _d), (a, _shape, valid) in zip(layout, arrays):
        view[end:o] = 0
        end = o + int(np.prod(shape, dtype=np.int64)) * a.dtype.itemsize
        dst = view[o:end].view(a.dtype).reshape(shape)
        if a.ndim == 0:  # a scalar (the row count)
            dst[...] = a
            continue
        n = a.shape[0]
        dst[:n] = a
        if valid is not None:  # zero the invalid lanes: kernels stay
            dst[:n][~valid] = 0  # deterministic
        dst[n:] = 0
    view[end:] = 0
    return buf, tuple(layout)


def _unpack(buf: torch.Tensor, layout) -> List[torch.Tensor]:
    """Each array of ``layout`` as a view of ``buf`` (same dtype and
    shape as its host array)."""
    out = []
    for off, shape, dtstr in layout:
        dt = np.dtype(dtstr)
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        out.append(buf[off:off + n].view(_torch_of(dt)).view(shape))
    return out


def packed_upload(arrays: Sequence[tuple],
                  device: torch.device) -> List[torch.Tensor]:
    """Upload ``arrays`` (``_upload_arrays``' triples) as ONE pinned
    buffer and ONE non-blocking copy; returns each array's device view.
    The pinned buffer comes from PyTorch's caching host allocator, which
    keeps it from reuse until the copy has run."""
    host, layout = _pack_host(arrays, pin=True)
    return _unpack(host.to(device, non_blocking=True), layout)


def host_to_device(batch: HostBatch, min_bucket_rows: int = 128,
                   device=None) -> DeviceBatch:
    """Upload a host batch, padded to its row bucket: one packed copy to
    a CUDA device, the staged arrays themselves on the CPU."""
    if device is None:
        raise ValueError("host_to_device needs an explicit device")
    device = torch.device(device)
    n = batch.num_rows
    padded = bucket_rows(n, min_bucket_rows)
    if device.type == "cuda":
        arrays = _upload_arrays(batch, padded)
        dev = packed_upload(
            arrays + [(np.asarray(n, dtype=np.int32), (), None)], device)
        cols, i = [], 0
        for c in batch.columns:
            k = 3 if c.dtype.is_string else 2
            cols.append(DeviceColumn(c.dtype, dev[i], dev[i + 1],
                                     dev[i + 2] if k == 3 else None))
            i += k
        return DeviceBatch(batch.schema, cols, dev[-1])
    cols: List[DeviceColumn] = []
    for c in batch.columns:
        valid_np = c.is_valid()
        validity = _staged(valid_np, padded, device)
        if c.dtype.is_string:
            data = _staged(c.data, padded, device)
            lengths = _staged(c.lengths.astype(np.int32, copy=False),
                              padded, device)
            cols.append(DeviceColumn(c.dtype, data, validity, lengths))
        else:
            data = _staged(c.data.astype(c.dtype.np_dtype, copy=False),
                           padded, device,
                           None if c.validity is None else valid_np)
            cols.append(DeviceColumn(c.dtype, data, validity))
    num_rows = torch.tensor(n, dtype=torch.int32).to(device)
    return DeviceBatch(batch.schema, cols, num_rows)


def device_to_host(batch: DeviceBatch) -> HostBatch:
    return device_to_host_many([batch])[0]


def device_to_host_many(batches: List[DeviceBatch]) -> List[HostBatch]:
    """Download device batches: one readback of every row count, then
    each array trimmed on the device to its row bucket and copied."""
    if not batches:
        return []
    ns = torch.stack([b.num_rows.to(torch.int32) for b in batches]
                     ).cpu().tolist()
    out: List[HostBatch] = []
    for batch, n in zip(batches, ns):
        k = min(bucket_rows(max(n, 1)), batch.padded_rows)
        cols: List[HostColumn] = []
        for c in batch.columns:
            validity = c.validity[:k].cpu().numpy()[:n]
            data = c.data[:k].cpu().numpy()[:n]
            lengths = None
            if c.dtype.is_string:
                lengths = c.lengths[:k].cpu().numpy()[:n]
            else:
                data = data.astype(c.dtype.np_dtype, copy=False)
            cols.append(HostColumn(c.dtype, data, validity, lengths))
        out.append(HostBatch(batch.schema, cols))
    return out
