"""K4 — gather and stream compaction.

Counterpart of ``spark_rapids_tpu/ops/kernels/gather.py``: row selection
(filter, sort, aggregate output) as a gather by a permutation, and a
stable compaction that moves kept rows to the front with the new row
count carried as a device scalar.  Each wrapper launches the kernel of
``csrc/gather.cu`` for CUDA tensors and takes the plain PyTorch version
only for CPU tensors, unless its ``kernels=`` argument names the
libraries to launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...data.column import DeviceBatch, DeviceColumn
from . import _build as B

#: CUDA kernels launched by K4, by wrapper
GATHER_LAUNCHES = B.LaunchCounter("gather")
COMPACT_LAUNCHES = B.LaunchCounter("compact")


def _row_bytes(t: torch.Tensor) -> int:
    width = t.shape[1] if t.dim() == 2 else 1
    return t.element_size() * width


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


def gather_array(x: torch.Tensor, order: torch.Tensor,
                 kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K4: ``x[order]`` for a 1-D array or the rows of a byte matrix."""
    kernels = B.kernels_for(x, kernels)
    if kernels is None:
        return x[order.to(torch.int64)]
    x = x.contiguous()
    order = order.to(torch.int32).contiguous()
    out = torch.empty((order.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    B.launch(GATHER_LAUNCHES, kernels.library("gather"), "k4_gather_rows",
             B.ptr(x), B.ptr(order), order.shape[0], x.shape[0],
             _row_bytes(x), B.ptr(out), kernels.stream(x))
    return out


def invert_permutation(order: torch.Tensor,
                       kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K4: the int32 ranks of a permutation, ``rank[order[i]] = i`` (K4's
    scatter of the row index)."""
    n = order.shape[0]
    lane = torch.arange(n, dtype=torch.int32, device=order.device)
    kernels = B.kernels_for(order, kernels)
    if kernels is None:
        rank = torch.empty_like(lane)
        rank[order.to(torch.int64)] = lane
        return rank
    rank = torch.empty(n, dtype=torch.int32, device=order.device)
    B.launch(GATHER_LAUNCHES, kernels.library("gather"), "k4_scatter_rows",
             B.ptr(lane), B.ptr(order.to(torch.int32).contiguous()), n, 4,
             B.ptr(rank), kernels.stream(order))
    return rank


def gather_column(col: DeviceColumn, order: torch.Tensor,
                  valid_mask: Optional[torch.Tensor] = None,
                  kernels: Optional[B.Kernels] = None) -> DeviceColumn:
    """K4: permute one column by ``order`` (int32); optionally AND the
    permuted validity with ``valid_mask`` (already in output order)."""
    kernels = B.kernels_for(col.validity, kernels)
    if kernels is None:
        return gather_column_plain(col, order, valid_mask)
    order = order.to(torch.int32).contiguous()
    validity = torch.empty(order.shape[0], dtype=torch.bool,
                           device=order.device)
    B.launch(GATHER_LAUNCHES, kernels.library("gather"), "k4_gather_valid",
             B.ptr(col.validity.contiguous()), B.ptr(order),
             B.ptr(None if valid_mask is None else valid_mask.contiguous()),
             order.shape[0], col.validity.shape[0], B.ptr(validity),
             kernels.stream(order))
    data = gather_array(col.data, order, kernels)
    lengths = gather_array(col.lengths, order, kernels) \
        if col.lengths is not None else None
    return DeviceColumn(col.dtype, data, validity, lengths)


def gather_batch(batch: DeviceBatch, order: torch.Tensor, num_rows,
                 valid_mask: Optional[torch.Tensor] = None,
                 kernels: Optional[B.Kernels] = None) -> DeviceBatch:
    cols = [gather_column(c, order, valid_mask, kernels)
            for c in batch.columns]
    return DeviceBatch(batch.schema, cols, num_rows)


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


def compact_order(keep: torch.Tensor,
                  kernels: Optional[B.Kernels] = None):
    """K4: the stable argsort of ``~keep`` (int32 row indices, kept rows
    first) and the kept count (int32 device scalar)."""
    kernels = B.kernels_for(keep, kernels)
    if kernels is None:
        return compact_order_plain(keep)
    n = keep.shape[0]
    dev = keep.device
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    tile_sums = torch.empty(B.tiles(n), dtype=torch.int32, device=dev)
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    num_rows = torch.full((), n, dtype=torch.int32, device=dev)
    B.launch(COMPACT_LAUNCHES, kernels.library("gather"), "k4_compact_order",
             B.ptr(keep.contiguous()), B.ptr(num_rows), n, B.ptr(flags),
             B.ptr(tile_sums), B.ptr(dest), B.ptr(count), B.ptr(order),
             kernels.stream(keep))
    return order, count


def compact(batch: DeviceBatch, keep: torch.Tensor,
            kernels: Optional[B.Kernels] = None) -> DeviceBatch:
    """Compact rows where ``keep`` (bool[padded]) to the front; the new
    row count is the number of kept logical rows.  Stable."""
    kernels = B.kernels_for(keep, kernels)
    if kernels is None:
        return compact_plain(batch, keep)
    lib = kernels.library("gather")
    n = batch.padded_rows
    dev = keep.device
    st = kernels.stream(keep)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    tile_sums = torch.empty(B.tiles(n), dtype=torch.int32, device=dev)
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    num_rows = batch.num_rows.to(torch.int32).contiguous()
    B.launch(COMPACT_LAUNCHES, lib, "k4_compact_plan",
             B.ptr(keep.contiguous()), B.ptr(num_rows), n, B.ptr(flags),
             B.ptr(tile_sums), B.ptr(dest), B.ptr(count), st)

    def scatter(x):
        x = x.contiguous()
        out = torch.empty_like(x)
        B.launch(COMPACT_LAUNCHES, lib, "k4_scatter_rows", B.ptr(x),
                 B.ptr(dest), n, _row_bytes(x), B.ptr(out), st)
        return out

    cols = []
    for c in batch.columns:
        validity = torch.empty(n, dtype=torch.bool, device=dev)
        B.launch(COMPACT_LAUNCHES, lib, "k4_scatter_valid",
                 B.ptr(c.validity.contiguous()), B.ptr(flags), B.ptr(dest),
                 n, B.ptr(validity), st)
        lengths = scatter(c.lengths) if c.lengths is not None else None
        cols.append(DeviceColumn(c.dtype, scatter(c.data), validity,
                                 lengths))
    return DeviceBatch(batch.schema, cols, count)
