"""K26 — the feature matrix of the ML export (``csrc/feature_matrix.cu``).

Counterpart of ``spark_rapids_tpu/ml/columnar_export.py:53
to_feature_matrix``: the named columns of every batch cast to float32
and stacked row-major, each row with a null in any of them dropped, the
batches' rows one after another in order.  ``feature_matrix`` launches
K26 for CUDA tensors: per batch, a count of its kept rows (a tile pass
and a scan), then one read back of every batch's count, one ``[rows,
k]`` output, and per batch a write of its kept rows at its offset in it
(no concatenation).  ``feature_matrix_plain`` is the reference's
composition in torch (``.to(torch.float32)``, ``torch.stack``, a boolean
mask, ``torch.cat``), the CPU path and the kernel's oracle: both round
to nearest even, so they agree bit for bit.

Bound on this card: bytes (``feature_matrix_bytes``): each selected
column's data and validity read once over the real rows, each kept row
written once as ``k`` floats.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ...data.column import DeviceBatch
from . import _build as B

#: CUDA kernels launched by K26
FEATURE_LAUNCHES = B.LaunchCounter("feature_matrix")

#: columns of one matrix at most (the kernel keeps their table in shared
#: memory)
MAX_COLUMNS = 256


def _selected(batch: DeviceBatch, names: Sequence[str]):
    return [batch.columns[batch.schema.index_of(n)] for n in names]


def _check(batches: Sequence[DeviceBatch], names: Sequence[str]) -> None:
    if not batches:
        raise ValueError("no batches to export")
    if not 1 <= len(names) <= MAX_COLUMNS:
        raise ValueError(f"a feature matrix takes 1 to {MAX_COLUMNS} "
                         f"columns, not {len(names)}")
    for name in names:
        dt = batches[0].schema[batches[0].schema.index_of(name)].dtype
        if dt.is_string:
            raise TypeError(f"column {name!r} is a string; a feature "
                            "matrix takes numeric, bool, date and "
                            "timestamp columns")


def feature_matrix_plain(batches: Sequence[DeviceBatch],
                         names: Sequence[str]) -> torch.Tensor:
    """The reference's composition: per batch the first ``num_rows`` rows
    of each column as float32, stacked, the rows with a null dropped;
    the batches concatenated."""
    _check(batches, names)
    mats = []
    for b in batches:
        n = int(b.num_rows)
        cols, valid = [], None
        for c in _selected(b, names):
            cols.append(c.data[:n].to(torch.float32))
            v = c.validity[:n]
            valid = v if valid is None else (valid & v)
        m = torch.stack(cols, dim=1)
        if not bool(valid.all()):
            m = m[valid]
        mats.append(m)
    return torch.cat(mats, dim=0)


def feature_matrix(batches: Sequence[DeviceBatch], names: Sequence[str],
                   kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K26: the float32 ``[rows, len(names)]`` matrix of the batches' kept
    rows (valid in every named column), in batch and row order."""
    _check(batches, names)
    kernels = B.kernels_for(batches[0].num_rows, kernels)
    if kernels is None:
        return feature_matrix_plain(batches, names)
    plans, counts = count_kept(batches, names, kernels)
    # the one read back: every batch's kept rows, to size the output
    return write_kept(plans, counts.cpu().tolist(), kernels)


def count_kept(batches: Sequence[DeviceBatch], names: Sequence[str],
               kernels: B.Kernels):
    """K26's first pass: per batch, its kept rows counted per tile and
    scanned (two kernels).  Returns each batch's launch arguments (its
    tensors kept alive) and an int32 tensor of the batches' kept rows;
    nothing waits for the card."""
    lib = kernels.library("feature_matrix")
    dev = batches[0].device
    plans = []
    counts = torch.zeros(len(batches), dtype=torch.int32, device=dev)
    for i, b in enumerate(batches):
        words, keep = [], []
        for c in _selected(b, names):
            data, valid = c.data.contiguous(), c.validity.contiguous()
            keep += [data, valid]
            words += [B.ptr(data), B.ptr(valid), B.DTYPE_CODES[data.dtype]]
        table = B.device_table(words, dev)
        num_rows = b.num_rows.to(torch.int32).contiguous()
        offsets = torch.empty(B.tiles(b.padded_rows), dtype=torch.int32,
                              device=dev)
        plans.append((table, num_rows, b.padded_rows, offsets, len(names),
                      keep))
        if b.padded_rows:
            B.launch(FEATURE_LAUNCHES, lib, "k26_count", B.ptr(table),
                     len(names), b.padded_rows, B.ptr(num_rows),
                     B.ptr(offsets), counts[i:i + 1].data_ptr(),
                     kernels.stream(num_rows))
    return plans, counts


def write_kept(plans, sizes: Sequence[int], kernels: B.Kernels
               ) -> torch.Tensor:
    """K26's second pass: one ``[sum(sizes), k]`` output, and per batch
    with kept rows one kernel writing them at the batch's offset."""
    lib = kernels.library("feature_matrix")
    table0 = plans[0][0]
    out = torch.empty((sum(sizes), plans[0][4]), dtype=torch.float32,
                      device=table0.device)
    at = 0
    for (table, num_rows, padded, offsets, k, _keep), m in zip(plans,
                                                               sizes):
        if m:
            B.launch(FEATURE_LAUNCHES, lib, "k26_write", B.ptr(table), k,
                     padded, B.ptr(num_rows), B.ptr(offsets),
                     out[at:].data_ptr(), kernels.stream(num_rows))
        at += m
    return out


def feature_matrix_bytes(batches: Sequence[DeviceBatch],
                         names: Sequence[str], kept_rows: int) -> int:
    """Bytes K26 must move: each named column's data and validity over
    each batch's real rows read once, the ``kept_rows`` rows of
    ``len(names)`` floats written once."""
    total = 0
    for b in batches:
        n = int(b.num_rows)
        for c in _selected(b, names):
            total += n * (c.data.element_size() + 1)
    return total + kept_rows * len(names) * 4
