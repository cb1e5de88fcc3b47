"""K22 — explode, and K23 — expand: the row-multiplying execs' kernels.

Counterpart of ``spark_rapids_tpu/exec/generate.py:47
TpuGenerateExec._compute`` (K22, ``csrc/generate.cu``) and
``spark_rapids_tpu/exec/basic.py:223 TpuExpandExec._mk_kernel`` (K23,
``csrc/expand.cu``), the two ``jit_kernel`` bodies of the reference that
change a batch's row count or number.

``explode``: ``p`` padded input rows and ``k`` evaluated element columns
give ``p * k`` output rows, row ``r`` of the input at ``r * k .. r * k +
k - 1`` (row-major, as the reference's ``jnp.repeat``/``stack``): every
pass-through column repeated ``k`` times (fixed-width data, or a string's
byte row and length) with validity ``validity & row_mask``; the ``pos``
column (``j`` in ``0..k-1``, valid on logical rows); the element column,
element ``j`` of row ``r`` at ``r * k + j``, converted to the output type
as ``Tensor.to`` converts, string elements padded with zeros to the
widest element.  One launch writes every output column
(``blockIdx.y`` picks the column).

``expand``: each output column of each of the ``k`` projections is one
op: a column reference (validity ANDed with the row mask; the data
shared with the input unless a numeric column widens to the field's
type, which the kernel converts), a literal fill (its bits converted to
the field's type; valid on logical rows), or a null of the field's type
(zeros, never valid).  A string reference or string literal shares its
data and lengths and gets only a new validity.  Projection entries that
are neither references nor literals are evaluated first by the engine's
torch ops, as the unfused Project does, and enter as references.  One
launch writes all ``k`` projections (``blockIdx.y`` picks the op).

Both kernels read a table of column descriptors (int64 words: pointers,
dtype codes of ``csrc/common.cuh``, row strides, widths) that the wrapper
copies to the device with the launch, so the argument list does not grow
with the number of columns.  K23's static words are built once per
``ExpandSpec`` and list of source types; a call patches in the
pointers.  The plain versions are the reference's bodies in torch
(``repeat_interleave``/``stack``; ``where``/``to``); the wrappers take
them only for CPU tensors.

Bound on this card: bytes.  K22 reads each input array once and writes
``k`` times its rows; K23 writes a validity per op and the data of
converted references, fills and nulls only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ... import types as T
from ...data.column import DeviceColumn
from . import _build as B

#: CUDA kernels launched by K22 and K23
EXPLODE_LAUNCHES = B.LaunchCounter("explode")
EXPAND_LAUNCHES = B.LaunchCounter("expand")

#: int64 words of one K22 column descriptor (``csrc/generate.cu``)
K22_WORDS = 13
#: int64 words of one K23 op descriptor (``csrc/expand.cu``)
K23_WORDS = 10
#: at most this many ops (grid.y) in one K23 launch
MAX_EXPAND_OPS = 65535
#: at most this many elements in one K22 launch (``csrc/generate.cu``)
MAX_EXPLODE_ELEMENTS = 64

# K22 column kinds
PASS_FIXED, PASS_STRING, POS, ELEM_FIXED, ELEM_STRING = range(5)
# K23 data modes
DATA_NONE, DATA_CONVERT, DATA_FILL = range(3)


def _code(t: torch.Tensor) -> int:
    return B.DTYPE_CODES[t.dtype]


def _row_stride(t: torch.Tensor) -> int:
    """Bytes from one row to the next (0 for a broadcast view)."""
    return t.stride(0) * t.element_size()


def _contig_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with contiguous rows; a broadcast (stride-0) view is kept."""
    if t.stride(0) == 0 and (t.dim() == 1 or t.stride(1) == 1):
        return t
    return t.contiguous()


# ---------------------------------------------------------------------------
# K22: explode
# ---------------------------------------------------------------------------
def explode_plain(columns: List[DeviceColumn], row_mask: torch.Tensor,
                  elements: List[DeviceColumn], out_dtype: T.DType,
                  position: bool) -> List[DeviceColumn]:
    """The reference's ``TpuGenerateExec._compute`` in torch."""
    k = len(elements)
    p = row_mask.shape[0]
    out = []
    for c in columns:
        out.append(DeviceColumn(
            c.dtype, torch.repeat_interleave(c.data, k, dim=0),
            torch.repeat_interleave(c.validity & row_mask, k),
            None if c.lengths is None
            else torch.repeat_interleave(c.lengths.to(torch.int32), k)))
    mask_k = torch.repeat_interleave(row_mask, k)
    if position:
        out.append(DeviceColumn(
            T.INT32, torch.arange(k, dtype=torch.int32,
                                  device=row_mask.device).repeat(p),
            mask_k))
    if out_dtype.is_string:
        w = max(int(c.data.shape[1]) for c in elements)
        data = torch.stack([torch.nn.functional.pad(
            c.data, (0, w - c.data.shape[1])) for c in elements],
            dim=1).reshape(p * k, w)
        lengths = torch.stack([c.lengths.to(torch.int32) for c in elements],
                              dim=1).reshape(p * k)
    else:
        data = torch.stack([c.data.to(out_dtype.torch_dtype)
                            for c in elements], dim=1).reshape(p * k)
        lengths = None
    validity = torch.stack([c.validity for c in elements],
                           dim=1).reshape(p * k) & mask_k
    out.append(DeviceColumn(out_dtype, data, validity, lengths))
    return out


def explode(columns: List[DeviceColumn], num_rows: torch.Tensor,
            elements: List[DeviceColumn], out_dtype: T.DType,
            position: bool, kernels: Optional[B.Kernels] = None
            ) -> List[DeviceColumn]:
    """K22: the ``p * k`` output columns of an explode: the pass-through
    ``columns`` repeated, then ``pos`` (if ``position``), then the
    interleaved ``elements`` (already evaluated, ``p`` rows each)."""
    p = elements[0].validity.shape[0]
    dev = num_rows.device
    kernels = B.kernels_for(num_rows, kernels)
    if kernels is None:
        rm = torch.arange(p, dtype=torch.int32, device=dev) < num_rows
        return explode_plain(columns, rm, elements, out_dtype, position)
    k = len(elements)
    if k > MAX_EXPLODE_ELEMENTS:
        raise ValueError(f"K22 takes at most {MAX_EXPLODE_ELEMENTS} "
                         f"elements, got {k}")
    n = p * k
    keep = []

    def hold(t):
        keep.append(t)
        return t.data_ptr()

    out: List[DeviceColumn] = []
    words: List[int] = []
    for c in columns:
        valid = hold(c.validity.contiguous())
        if c.dtype.is_string:
            data = _contig_rows(c.data)
            w = int(data.shape[1])
            o = DeviceColumn(c.dtype, torch.empty((n, w), dtype=torch.uint8,
                                                  device=dev),
                             torch.empty(n, dtype=torch.bool, device=dev),
                             torch.empty(n, dtype=torch.int32, device=dev))
            ln = _contig_rows(c.lengths.to(torch.int32))
            words += [PASS_STRING, B.DTYPE_CODES[torch.uint8], hold(data),
                      valid, hold(ln), _row_stride(data), w,
                      ln.stride(0), B.DTYPE_CODES[torch.uint8],
                      o.data.data_ptr(), o.validity.data_ptr(),
                      o.lengths.data_ptr(), w]
        else:
            data = _contig_rows(c.data)
            o = DeviceColumn(c.dtype, torch.empty(n, dtype=data.dtype,
                                                  device=dev),
                             torch.empty(n, dtype=torch.bool, device=dev))
            words += [PASS_FIXED, _code(data), hold(data), valid, 0,
                      _row_stride(data), data.element_size(), 0,
                      _code(data), o.data.data_ptr(),
                      o.validity.data_ptr(), 0, data.element_size()]
        out.append(o)
    if position:
        o = DeviceColumn(T.INT32, torch.empty(n, dtype=torch.int32,
                                              device=dev),
                         torch.empty(n, dtype=torch.bool, device=dev))
        words += [POS, 0, 0, 0, 0, 0, 0, 0, B.DTYPE_CODES[torch.int32],
                  o.data.data_ptr(), o.validity.data_ptr(), 0, 4]
        out.append(o)
    elem_words: List[int] = []
    if out_dtype.is_string:
        w = max(int(c.data.shape[1]) for c in elements)
        o = DeviceColumn(out_dtype, torch.empty((n, w), dtype=torch.uint8,
                                                device=dev),
                         torch.empty(n, dtype=torch.bool, device=dev),
                         torch.empty(n, dtype=torch.int32, device=dev))
        words += [ELEM_STRING, 0, 0, 0, 0, 0, 0, 0,
                  B.DTYPE_CODES[torch.uint8], o.data.data_ptr(),
                  o.validity.data_ptr(), o.lengths.data_ptr(), w]
        for c in elements:
            data = _contig_rows(c.data)
            ln = _contig_rows(c.lengths.to(torch.int32))
            elem_words += [0, B.DTYPE_CODES[torch.uint8], hold(data),
                           hold(c.validity.contiguous()), hold(ln),
                           _row_stride(data), int(data.shape[1]),
                           ln.stride(0), 0, 0, 0, 0, 0]
    else:
        tdt = out_dtype.torch_dtype
        o = DeviceColumn(out_dtype, torch.empty(n, dtype=tdt, device=dev),
                         torch.empty(n, dtype=torch.bool, device=dev))
        size = torch.empty(0, dtype=tdt).element_size()
        words += [ELEM_FIXED, 0, 0, 0, 0, 0, 0, 0, B.DTYPE_CODES[tdt],
                  o.data.data_ptr(), o.validity.data_ptr(), 0, size]
        for c in elements:
            data = _contig_rows(c.data)
            elem_words += [0, _code(data), hold(data),
                           hold(c.validity.contiguous()), 0,
                           _row_stride(data), data.element_size(), 0,
                           0, 0, 0, 0, 0]
    out.append(o)
    n_entries = len(words) // K22_WORDS
    table = B.device_table(words + elem_words, dev)
    nr = num_rows.to(torch.int32).contiguous()
    B.launch(EXPLODE_LAUNCHES, kernels.library("generate"), "k22_explode",
             B.ptr(table), n_entries, k, p, B.ptr(nr),
             kernels.stream(num_rows))
    return out


def explode_bytes(columns: List[DeviceColumn], elements: List[DeviceColumn],
                  out: List[DeviceColumn]) -> int:
    """The bytes an explode must move: each input array read once (an
    element that is a pass-through column, as in an unpivot, is the same
    array and counts once), each output array written once (its
    bound)."""
    total = 4
    seen = set()
    for c in list(columns) + list(elements):
        for t in (c.data, c.validity, c.lengths):
            if t is None:
                continue
            view = (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
            if view in seen:
                continue
            seen.add(view)
            total += t.shape[0] * (t[0].numel() if t.dim() > 1 else 1) \
                * t.element_size()
    for c in out:
        for t in (c.data, c.validity, c.lengths):
            if t is not None:
                total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------------------
# K23: expand
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ExpandOp:
    """One output column of one projection: ``kind`` "ref" (column
    ``src`` of the sources), "lit" (``value`` of type ``lit_dtype``) or
    "null"; ``dtype`` is the field's type."""

    kind: str
    dtype: T.DType
    src: int = -1
    value: object = None
    lit_dtype: Optional[T.DType] = None


def _fill_bits(value, src: T.DType, dst: T.DType) -> int:
    """The bits of ``value`` (of type ``src``) converted to ``dst``'s
    storage type, as ``Tensor.to`` converts; 0 for a null."""
    if value is None:
        return 0
    t = torch.tensor([value], dtype=src.torch_dtype).to(dst.torch_dtype)
    raw = t.numpy().tobytes()
    return int.from_bytes(raw.ljust(8, b"\0"), "little", signed=True)


def _out_dtype(op: ExpandOp, src: Optional[T.DType]) -> T.DType:
    """The type an output column keeps: the source's (``src``, the type
    of a reference's column), unless a numeric source converts to a
    numeric field (the reference casts only when neither side is a
    string)."""
    have = src if op.kind == "ref" else (
        op.lit_dtype if op.kind == "lit" else op.dtype)
    if have != op.dtype and not have.is_string and not op.dtype.is_string:
        return op.dtype
    return have


def _literal_column(value, dtype: T.DType, n: int,
                    device) -> DeviceColumn:
    from ..expression import Scalar, as_device_column

    return as_device_column(Scalar(dtype, value), n, device)


class ExpandSpec:
    """The ops of an expand's projections (one list of ``ExpandOp`` a
    projection; iterable as that list of lists), with the part of a K23
    launch that depends only on them and on the sources' types computed
    once for each list of source types: every op's static descriptor
    words (data mode, dtype codes, literal validity and bits), where its
    validity and data sit in the call's allocations, and which words
    take a source's pointers.  A call then allocates, patches the
    pointers into a copy of the words and builds the output columns."""

    def __init__(self, projections: Sequence[Sequence[ExpandOp]]):
        self.projections = [list(ops) for ops in projections]
        self._plans = {}

    def __iter__(self):
        return iter(self.projections)

    def __len__(self):
        return len(self.projections)

    def plan(self, sources: Sequence[DeviceColumn]) -> "_ExpandPlan":
        key = tuple((c.dtype, c.data.dtype) for c in sources)
        got = self._plans.get(key)
        if got is None:
            got = self._plans[key] = _ExpandPlan(self.projections, key)
        return got


class _ExpandPlan:
    """``ExpandSpec``'s static launch for one list of source types."""

    def __init__(self, projections, source_types):
        ops = [op for o in projections for op in o]
        self.n_ops = n = len(ops)
        self.sizes = [len(o) for o in projections]
        self.words = np.zeros((n, K23_WORDS), dtype=np.int64)
        #: per op: (how, output DType, source index or string literal)
        self.layout = []
        self.rows = {}      # torch dtype of written data -> row count
        data_ops = {}       # torch dtype -> (op indices, row slots)
        self.ref_ops, self.ref_srcs = [], []    # validity from a source
        self.conv_ops, self.conv_srcs = [], []  # data from a source
        for i, op in enumerate(ops):
            w = self.words[i]
            if op.kind == "ref":
                have, src_t = source_types[op.src]
                dt = _out_dtype(op, have)
                self.ref_ops.append(i)
                self.ref_srcs.append(op.src)
                if dt == have:  # shared data, a new validity
                    w[0] = DATA_NONE
                    self.layout.append(("shared", dt, op.src))
                    continue
                w[0], w[1] = DATA_CONVERT, B.DTYPE_CODES[src_t]
                self.conv_ops.append(i)
                self.conv_srcs.append(op.src)
                how = "data"
            else:
                value = op.value if op.kind == "lit" else None
                have = op.lit_dtype if op.kind == "lit" else op.dtype
                dt = _out_dtype(op, None)
                w[5] = int(value is not None)
                if dt.is_string:  # the literal's broadcast row, shared
                    w[0] = DATA_NONE
                    self.layout.append(("string", dt, value))
                    continue
                w[0], w[9] = DATA_FILL, _fill_bits(value, have, dt)
                how = "data"
            t = dt.torch_dtype
            w[6] = B.DTYPE_CODES[t]
            slot = self.rows.get(t, 0)
            self.rows[t] = slot + 1
            idx, slots = data_ops.setdefault(t, ([], []))
            idx.append(i)
            slots.append(slot)
            self.layout.append((how, dt, (t, slot)))
        self.data_ops = {t: (np.asarray(i, dtype=np.int64),
                             np.asarray(sl, dtype=np.int64))
                         for t, (i, sl) in data_ops.items()}
        self.ref_ops = np.asarray(self.ref_ops, dtype=np.int64)
        self.ref_srcs = np.asarray(self.ref_srcs, dtype=np.int64)
        self.conv_ops = np.asarray(self.conv_ops, dtype=np.int64)
        self.conv_srcs = np.asarray(self.conv_srcs, dtype=np.int64)
        self._string_rows = {}

    def string_row(self, value, device):
        """A string literal's one encoded row and length on ``device``."""
        key = (value, str(device))
        got = self._string_rows.get(key)
        if got is None:
            from ...data import strings as dstrings

            bm, ln = dstrings.encode([value])
            got = self._string_rows[key] = (
                torch.from_numpy(bm).to(device),
                torch.from_numpy(ln).to(device))
        return got


def expand_plain(sources: List[DeviceColumn], row_mask: torch.Tensor,
                 projections: Sequence[Sequence[ExpandOp]]
                 ) -> List[List[DeviceColumn]]:
    """The reference's ``TpuExpandExec._mk_kernel`` bodies in torch."""
    n, dev = row_mask.shape[0], row_mask.device
    out = []
    for ops in projections:
        cols = []
        for op in ops:
            if op.kind == "ref":
                c = sources[op.src]
            elif op.kind == "lit":
                c = _literal_column(op.value, op.lit_dtype, n, dev)
            else:
                c = _literal_column(None, op.dtype, n, dev)
            dt = _out_dtype(op, c.dtype if op.kind == "ref" else None)
            data = c.data if dt == c.dtype else c.data.to(dt.torch_dtype)
            cols.append(DeviceColumn(dt, data, c.validity & row_mask,
                                     c.lengths))
        out.append(cols)
    return out


def expand(sources: List[DeviceColumn], num_rows: torch.Tensor,
           projections, kernels: Optional[B.Kernels] = None
           ) -> List[List[DeviceColumn]]:
    """K23: every projection's output columns over ``sources`` (the
    input batch's columns and any entries evaluated before), ``p`` rows
    each.  ``projections`` is an ``ExpandSpec`` (its static launch kept
    between calls) or a list of lists of ``ExpandOp``."""
    p = sources[0].validity.shape[0] if sources else None
    dev = num_rows.device
    if p is None:
        raise ValueError("expand needs at least one source column")
    kernels = B.kernels_for(num_rows, kernels)
    if kernels is None:
        rm = torch.arange(p, dtype=torch.int32, device=dev) < num_rows
        return expand_plain(sources, rm, projections)
    spec = projections if isinstance(projections, ExpandSpec) \
        else ExpandSpec(projections)
    plan = spec.plan(sources)
    n_ops = plan.n_ops
    if n_ops > MAX_EXPAND_OPS:
        raise ValueError(f"K23 takes at most {MAX_EXPAND_OPS} ops, got "
                         f"{n_ops}")
    words = plan.words.copy()
    # one allocation for every validity, one per type for the data
    valids = torch.empty((n_ops, p), dtype=torch.bool, device=dev)
    words[:, 8] = valids.data_ptr() + np.arange(n_ops, dtype=np.int64) * p
    datas = {}
    for t, (idx, slots) in plan.data_ops.items():
        d = datas[t] = torch.empty((plan.rows[t], p), dtype=t, device=dev)
        words[idx, 7] = d.data_ptr() + slots * (p * d.element_size())
    # the sources' pointers, each source once
    keep = []
    n_src = len(sources)
    valid_ptr = np.zeros(n_src, dtype=np.int64)
    for s in set(plan.ref_srcs.tolist()):
        v = sources[s].validity.contiguous()
        keep.append(v)
        valid_ptr[s] = v.data_ptr()
    words[plan.ref_ops, 4] = valid_ptr[plan.ref_srcs]
    conv = {}
    for s in set(plan.conv_srcs.tolist()):
        d = _contig_rows(sources[s].data)
        keep.append(d)
        conv[s] = (d.data_ptr(), _row_stride(d))
    for i, s in zip(plan.conv_ops.tolist(), plan.conv_srcs.tolist()):
        words[i, 2], words[i, 3] = conv[s]
    valid_rows = valids.unbind(0)
    data_rows = {t: d.unbind(0) for t, d in datas.items()}
    out: List[List[DeviceColumn]] = []
    cols: List[DeviceColumn] = []
    for i, (how, dt, at) in enumerate(plan.layout):
        valid = valid_rows[i]
        if how == "shared":
            c = sources[at]
            cols.append(DeviceColumn(dt, c.data, valid, c.lengths))
        elif how == "string":
            row, ln = plan.string_row(at, dev)
            cols.append(DeviceColumn(dt, row.expand(p, -1), valid,
                                     ln.expand(p)))
        else:
            cols.append(DeviceColumn(dt, data_rows[at[0]][at[1]], valid))
        if len(cols) == plan.sizes[len(out)]:
            out.append(cols)
            cols = []
    table = torch.from_numpy(words.reshape(-1))
    if dev.type == "cuda":
        table = table.pin_memory().to(dev, non_blocking=True)
    nr = num_rows.to(torch.int32).contiguous()
    B.launch(EXPAND_LAUNCHES, kernels.library("expand"), "k23_expand",
             B.ptr(table), n_ops, p, B.ptr(nr), kernels.stream(num_rows))
    return out


def expand_bytes(sources: List[DeviceColumn],
                 projections: List[List[ExpandOp]],
                 out: List[List[DeviceColumn]]) -> int:
    """The bytes an expand must move: each source array a projection
    reads, once; each validity, converted column and fill written once."""
    total = 4
    read = set()
    for ops, cols in zip(projections, out):
        for op, c in zip(ops, cols):
            total += c.validity.numel()
            if op.kind == "ref":
                s = sources[op.src]
                if ("v", op.src) not in read:
                    read.add(("v", op.src))
                    total += s.validity.numel()
                if c.data is not s.data:
                    total += c.data.numel() * c.data.element_size()
                    if ("d", op.src) not in read:
                        read.add(("d", op.src))
                        total += s.data.numel() * s.data.element_size()
            elif not c.dtype.is_string:
                total += c.data.numel() * c.data.element_size()
    return total
