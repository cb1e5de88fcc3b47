"""K4 — gather and stream compaction.

Counterpart of ``spark_rapids_tpu/ops/kernels/gather.py``: row selection
(filter, sort, aggregate output) as a gather by a permutation, and a
stable compaction that moves kept rows to the front with the new row
count carried as a device scalar.  Each wrapper launches the kernel of
``csrc/gather.cu`` for CUDA tensors and takes the plain PyTorch version
only for CPU tensors, unless its ``kernels=`` argument names the
libraries to launch.

Every array of a call moves in one launch (``TABLE_COLUMNS`` columns a
launch): ``gather_columns`` and ``gather_arrays`` are the wrappers, and
``gather_batch``, ``gather_column``, ``gather_array`` and ``compact`` are
built on them.  The outputs of a call are one block a (dtype, row
shape), one for the validities and one for the lengths, cut into views
(``_outputs``); K7's join gather (``join.gather_pair``) moves its columns
through the same table (``move``).
"""
from __future__ import annotations

import array
from typing import List, Optional, Sequence

import torch

from ...data.column import DeviceBatch, DeviceColumn
from . import _build as B

#: CUDA kernels launched by K4, by wrapper
GATHER_LAUNCHES = B.LaunchCounter("gather")
COMPACT_LAUNCHES = B.LaunchCounter("compact")
#: columns one K4 or K7 launch takes (``MOVE_COLS`` of csrc/gather.cu); a
#: wider call is split into as few launches as it needs
TABLE_COLUMNS = 32


def _row_bytes(t: torch.Tensor) -> int:
    width = t.shape[1] if t.dim() == 2 else 1
    return t.element_size() * width


def _outputs(columns: Sequence[DeviceColumn], n_out: int, dev):
    """The output arrays of ``columns`` moved to ``n_out`` rows: one block
    a (dtype, row shape) for the data, one for every validity and one for
    every lengths array, each cut into its columns' rows by one
    ``unbind`` (a ``torch.empty`` an array costs more host time than the
    launch).  A column whose validity is None (a bare array) gets none.
    A block stays allocated while any of its columns lives."""
    groups = {}
    for k, c in enumerate(columns):
        groups.setdefault((c.data.dtype, c.data.shape[1:]), []).append(k)
    data = [None] * len(columns)
    for (dtype, row), ks in groups.items():
        for k, t in zip(ks, torch.empty((len(ks), n_out) + tuple(row),
                                        dtype=dtype, device=dev).unbind(0)):
            data[k] = t

    def cut(ks, dtype):
        out = [None] * len(columns)
        if ks:
            for k, t in zip(ks, torch.empty((len(ks), n_out), dtype=dtype,
                                            device=dev).unbind(0)):
                out[k] = t
        return out

    validity = cut([k for k, c in enumerate(columns)
                    if c.validity is not None], torch.bool)
    lengths = cut([k for k, c in enumerate(columns)
                   if c.lengths is not None], torch.int32)
    return data, validity, lengths


def move(counter: B.LaunchCounter, lib, fn: str, sides, n_out: int, dev,
         tail) -> List[DeviceColumn]:
    """Move the columns of ``sides`` (a list of column lists; side s is
    read by the kernel's index s) with ``fn`` (``k4_gather``,
    ``k4_compact_move`` or ``k7_gather``): one launch a ``TABLE_COLUMNS``
    columns, each column a row of 8 words in a host table the C function
    copies into the kernel's parameters, the launch's other arguments
    ``tail``; none for no output rows.  A column with validity None is a
    bare array.  Returns the moved columns in order.  The host work is
    most of a small call's time, so the loop stays lean."""
    columns = [c for cols in sides for c in cols]
    data, validity, lengths = _outputs(columns, n_out, dev)
    out, words = [], []
    # the inputs as the kernel reads them, alive until it is enqueued (a
    # converted copy freed earlier could be reused by the next one)
    inputs = []
    k = 0
    for side, cols in enumerate(sides):
        for c in cols:
            src = c.data.contiguous()
            d, v, ln = data[k], validity[k], lengths[k]
            if v is None:
                valid_p = v_p = 0
            else:
                valid = c.validity.contiguous()
                inputs.append(valid)
                valid_p, v_p = valid.data_ptr(), v.data_ptr()
            if ln is None:
                lens_p = ln_p = 0
            else:
                lens = c.lengths.to(torch.int32).contiguous()
                inputs.append(lens)
                lens_p, ln_p = lens.data_ptr(), ln.data_ptr()
            inputs.append(src)
            words += [src.data_ptr(), valid_p, lens_p, d.data_ptr(), v_p,
                      ln_p, src.shape[0], _row_bytes(src) | side << 32]
            out.append(DeviceColumn(c.dtype, d, v, ln))
            k += 1
    per = 8 * TABLE_COLUMNS
    for w in range(0, len(words) if n_out else 0, per):
        table = array.array("q", words[w:w + per])
        B.launch(counter, lib, fn, table.buffer_info()[0], len(table) // 8,
                 *tail)
    return out


# ---------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------
def gather_column_plain(col: DeviceColumn, order: torch.Tensor,
                        valid_mask: Optional[torch.Tensor] = None
                        ) -> DeviceColumn:
    """Plain version of K4's gather: torch indexing."""
    idx = order.to(torch.int64)
    validity = col.validity[idx]
    if valid_mask is not None:
        validity = validity & valid_mask
    lengths = col.lengths[idx] if col.lengths is not None else None
    return DeviceColumn(col.dtype, col.data[idx], validity, lengths)


def _gather_cuda(columns, order, mask, kernels: B.Kernels):
    order = order.to(torch.int32).contiguous()
    mask = None if mask is None else mask.contiguous()
    n_out = order.shape[0]
    return move(GATHER_LAUNCHES, kernels.library("gather"), "k4_gather",
                [columns], n_out, order.device,
                (order.data_ptr(), B.ptr(mask), None, n_out,
                 kernels.stream(order)))


def gather_columns(cols: Sequence[DeviceColumn], order: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   kernels: Optional[B.Kernels] = None
                   ) -> List[DeviceColumn]:
    """K4: every column permuted by ``order`` (int32, clamped into range)
    in one launch (up to ``TABLE_COLUMNS`` columns); with ``mask``
    (already in output order) ANDed into every validity."""
    kernels = B.kernels_for(order, kernels)
    if kernels is None:
        return [gather_column_plain(c, order, mask) for c in cols]
    if not cols:
        return []
    return _gather_cuda(cols, order, mask, kernels)


def gather_arrays(arrays: Sequence[torch.Tensor], order: torch.Tensor,
                  kernels: Optional[B.Kernels] = None) -> List[torch.Tensor]:
    """K4: ``x[order]`` for every 1-D array or byte matrix in one launch
    (up to ``TABLE_COLUMNS`` arrays)."""
    kernels = B.kernels_for(order, kernels)
    if kernels is None:
        idx = order.to(torch.int64)
        return [x[idx] for x in arrays]
    if not arrays:
        return []
    return [c.data for c in _gather_cuda(
        [DeviceColumn(None, x, None) for x in arrays], order, None,
        kernels)]


def gather_array(x: torch.Tensor, order: torch.Tensor,
                 kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K4: ``x[order]`` for a 1-D array or the rows of a byte matrix."""
    return gather_arrays([x], order, kernels)[0]


def gather_column(col: DeviceColumn, order: torch.Tensor,
                  valid_mask: Optional[torch.Tensor] = None,
                  kernels: Optional[B.Kernels] = None) -> DeviceColumn:
    """K4: permute one column by ``order`` (int32); optionally AND the
    permuted validity with ``valid_mask`` (already in output order)."""
    return gather_columns([col], order, valid_mask, kernels)[0]


def gather_batch(batch: DeviceBatch, order: torch.Tensor, num_rows,
                 valid_mask: Optional[torch.Tensor] = None,
                 kernels: Optional[B.Kernels] = None) -> DeviceBatch:
    """K4: every column of ``batch`` permuted by ``order`` in one launch
    (up to ``TABLE_COLUMNS`` columns)."""
    return DeviceBatch(batch.schema, gather_columns(
        batch.columns, order, valid_mask, kernels), num_rows)


def invert_permutation(order: torch.Tensor,
                       kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K4: the int32 ranks of a permutation, ``rank[order[i]] = i``."""
    n = order.shape[0]
    kernels = B.kernels_for(order, kernels)
    if kernels is None:
        rank = torch.empty(n, dtype=torch.int32, device=order.device)
        rank[order.to(torch.int64)] = torch.arange(
            n, dtype=torch.int32, device=order.device)
        return rank
    rank = torch.empty(n, dtype=torch.int32, device=order.device)
    B.launch(GATHER_LAUNCHES, kernels.library("gather"), "k4_invert",
             B.ptr(order.to(torch.int32).contiguous()), n, B.ptr(rank),
             kernels.stream(order))
    return rank


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------
def compact_order_plain(keep: torch.Tensor):
    # stable argsort of (not keep): kept rows first, each side in order
    order = torch.sort((~keep).to(torch.uint8), stable=True
                       ).indices.to(torch.int32)
    return order, keep.sum().to(torch.int32)


def compact_plain(batch: DeviceBatch, keep: torch.Tensor) -> DeviceBatch:
    order, count = compact_order_plain(keep & batch.row_mask())
    kept_mask = torch.arange(batch.padded_rows, dtype=torch.int32,
                             device=keep.device) < count
    return DeviceBatch(batch.schema, [
        gather_column_plain(c, order, kept_mask) for c in batch.columns],
        count)


def _plan_scratch(n: int, dev):
    return (torch.empty(B.tiles(n), dtype=torch.int32, device=dev),
            torch.empty((), dtype=torch.int32, device=dev))


def compact_order(keep: torch.Tensor,
                  kernels: Optional[B.Kernels] = None):
    """K4: the stable argsort of ``~keep`` (int32 row indices, kept rows
    first) and the kept count (int32 device scalar)."""
    kernels = B.kernels_for(keep, kernels)
    if kernels is None:
        return compact_order_plain(keep)
    n = keep.shape[0]
    dev = keep.device
    tile_sums, count = _plan_scratch(n, dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return order, count.zero_()
    num_rows = torch.full((), n, dtype=torch.int32, device=dev)
    B.launch(COMPACT_LAUNCHES, kernels.library("gather"), "k4_compact_order",
             B.ptr(keep.contiguous()), B.ptr(num_rows), n, B.ptr(tile_sums),
             B.ptr(count), B.ptr(order), kernels.stream(keep))
    return order, count


def compact(batch: DeviceBatch, keep: torch.Tensor,
            kernels: Optional[B.Kernels] = None) -> DeviceBatch:
    """Compact rows where ``keep`` (bool[padded]) to the front; the new
    row count is the number of kept logical rows.  Stable.  On the
    kernels: two launches scan the flags, one moves every column (up to
    ``TABLE_COLUMNS``)."""
    kernels = B.kernels_for(keep, kernels)
    if kernels is None:
        return compact_plain(batch, keep)
    lib = kernels.library("gather")
    n = batch.padded_rows
    dev = keep.device
    st = kernels.stream(keep)
    tile_sums, count = _plan_scratch(n, dev)
    if n == 0:
        return DeviceBatch(batch.schema, list(batch.columns), count.zero_())
    keep = keep.contiguous()
    num_rows = batch.num_rows.to(torch.int32).contiguous()
    B.launch(COMPACT_LAUNCHES, lib, "k4_compact_plan", B.ptr(keep),
             B.ptr(num_rows), n, B.ptr(tile_sums), B.ptr(count), st)
    cols = move(COMPACT_LAUNCHES, lib, "k4_compact_move", [batch.columns],
                n, dev, (keep.data_ptr(), num_rows.data_ptr(), n,
                         tile_sums.data_ptr(), count.data_ptr(), st)) \
        if batch.columns else []
    return DeviceBatch(batch.schema, cols, count)
