"""K10 — the device exchange's packed partition blocks.

Counterpart of ``spark_rapids_tpu/shuffle/device_shuffle.py``: a shuffle
write groups the rows of each input batch by destination partition into
ONE flat device block (``packed_build``: a stable grouping by partition
id, then K4's gather) and records per-partition ``counts``/``starts``;
readers slice their contiguous range out of the resident block
(``packed_slice``) at the block's padded size.  ``fetch_counts`` is the
write path's one batched host readback per chunk of blocks, and
``resolve_mode`` the ``spark.rapids.tpu.shuffle.mode`` choice.  The
wrappers launch ``csrc/shuffle.cu`` for CUDA tensors and take the plain
PyTorch version only for CPU tensors, unless ``kernels=`` names the
libraries to launch.

``ShuffleStats`` keeps only ``deviceBytes``.  Not ported, for later
slices: the host-staged path and its CRC stamping (``shuffle.mode=host``
needs the spill tier, ROADMAP A6, and raises), the collective timer of
the multi-chip exchange, fallbacks and checkpoint bytes.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..data.column import DeviceBatch, DeviceColumn
from ..ops.kernels import _build as B
from ..ops.kernels import gather as G
from ..ops.kernels import segment as S
from .. import types as T

#: CUDA kernels launched by K10's build and slice
BUILD_LAUNCHES = B.LaunchCounter("packed_build")
SLICE_LAUNCHES = B.LaunchCounter("packed_slice")

#: the widest fan-out of the shared-memory build (one thread per bucket)
MAX_SHARED_FANOUT = 255
#: columns one slice launch copies (csrc/shuffle.cu MAX_SLICE_COLS)
MAX_SLICE_COLS = 32


class ShuffleStats:
    """Process-wide shuffle counters: ``deviceBytes``, the bytes of the
    packed blocks written on the card (the port runs its exchanges on
    one thread, so no lock)."""

    _KEYS = ("deviceBytes",)

    def __init__(self):
        self._values: Dict[str, int] = {k: 0 for k in self._KEYS}

    def reset(self) -> None:
        for k in self._KEYS:
            self._values[k] = 0

    def add(self, name: str, v: int = 1) -> None:
        self._values[name] = self._values.get(name, 0) + v

    def counters(self) -> Dict[str, int]:
        return dict(self._values)


#: THE process-wide instance
GLOBAL = ShuffleStats()


def resolve_mode(conf_mode: str) -> str:
    """The exchange data path for one shuffle write: ``device`` for
    ``device`` and for ``auto`` (the port keeps no arena, so it always
    has headroom); ``host`` needs the spill tier and raises."""
    mode = (conf_mode or "auto").lower()
    if mode not in ("device", "host", "auto"):
        raise ValueError(
            f"shuffle.mode must be device|host|auto, got {conf_mode!r}")
    if mode == "host":
        raise NotImplementedError(
            "spark.rapids.tpu.shuffle.mode=host stages every exchange block "
            "in host memory, which needs the spill tier (ROADMAP A6); it is "
            "not ported yet")
    return "device"


def fetch_counts(handles: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 num_rows: Sequence[torch.Tensor]
                 ) -> List[Tuple[List[int], List[int], int]]:
    """The ONE host readback of a write chunk: every block's ``counts``
    and ``starts`` (int32[n_out] each) and its input batch's row count,
    in one copy; returns ``(counts, starts, rows)`` per block as host
    ints."""
    if not handles:
        return []
    flat = torch.stack([torch.cat([c, s, n.to(torch.int32).reshape(1)])
                        for (c, s), n in zip(handles, num_rows)]).cpu()
    n_out = handles[0][0].shape[0]
    return [(row[:n_out].tolist(), row[n_out:2 * n_out].tolist(),
             int(row[2 * n_out])) for row in flat]


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------
def partition_order_plain(pids: torch.Tensor, num_rows: torch.Tensor,
                          n_out: int):
    """Plain version of K10's build: the stable argsort of
    ``where(row < num_rows, pids, n_out)`` and each partition's count and
    start."""
    lane = torch.arange(pids.shape[0], dtype=torch.int32,
                        device=pids.device)
    b = torch.where(lane < num_rows, pids.to(torch.int64),
                    torch.full((), n_out, dtype=torch.int64,
                               device=pids.device))
    order = torch.sort(b, stable=True).indices.to(torch.int32)
    counts = torch.bincount(b, minlength=n_out + 1)[:n_out]
    starts = torch.cumsum(counts, 0) - counts
    return order, counts.to(torch.int32), starts.to(torch.int32)


def partition_order(pids: torch.Tensor, num_rows: torch.Tensor, n_out: int,
                    kernels: Optional[B.Kernels] = None):
    """K10: rows grouped by partition id, stably, padding rows (at or past
    ``num_rows``) after every real row; returns ``(order int32[n],
    counts int32[n_out], starts int32[n_out])``.  ``pids`` of real rows
    must lie in ``[0, n_out)``."""
    kernels = B.kernels_for(pids, kernels)
    if kernels is None:
        return partition_order_plain(pids, num_rows, n_out)
    lib = kernels.library("shuffle")
    n = pids.shape[0]
    dev = pids.device
    st = kernels.stream(pids)
    pids = pids.to(torch.int32).contiguous()
    num_rows = num_rows.to(torch.int32).contiguous()
    counts = torch.empty(n_out, dtype=torch.int32, device=dev)
    starts = torch.empty(n_out, dtype=torch.int32, device=dev)
    if n_out <= MAX_SHARED_FANOUT:
        scratch = torch.empty((n_out + 1) * B.tiles(n), dtype=torch.int32,
                              device=dev)
        order = torch.empty(n, dtype=torch.int32, device=dev)
        B.launch(BUILD_LAUNCHES, lib, "k10_build", B.ptr(pids),
                 B.ptr(num_rows), n, n_out, B.ptr(scratch), B.ptr(counts),
                 B.ptr(starts), B.ptr(order), st)
        return order, counts, starts
    # a fan-out past the shared histogram: counts and starts from the
    # global histogram, the order from K1's radix sort of the bucket ids
    scratch = torch.zeros(n_out + 1, dtype=torch.int32, device=dev)
    B.launch(BUILD_LAUNCHES, lib, "k10_counts_wide", B.ptr(pids),
             B.ptr(num_rows), n, n_out, B.ptr(scratch), B.ptr(counts),
             B.ptr(starts), st)
    rm = torch.arange(n, dtype=torch.int32, device=dev) < num_rows
    # padding rows are null keys, so they tie and keep their row order
    key = DeviceColumn(T.INT32, pids, rm)
    order = S.lexsort_device([key], pad_valid=rm, kernels=kernels)
    return order, counts, starts


def packed_build(batch: DeviceBatch, pids: torch.Tensor, n_out: int,
                 kernels: Optional[B.Kernels] = None):
    """Group ``batch``'s rows by destination partition inside one flat
    block: ``(block, counts, starts)``, where ``counts[p]``/``starts[p]``
    delimit partition ``p``'s contiguous rows and padding rows come last
    (the reference's ``packed_build``)."""
    order, counts, starts = partition_order(pids, batch.num_rows, n_out,
                                            kernels)
    return G.gather_batch(batch, order, batch.num_rows), counts, starts


# ---------------------------------------------------------------------------
# slice
# ---------------------------------------------------------------------------
def packed_slice_plain(block: DeviceBatch, start: int,
                       count: int) -> DeviceBatch:
    padded = block.padded_rows
    lane = torch.arange(padded, dtype=torch.int64, device=block.device)
    idx = torch.clamp(start + lane, 0, max(padded - 1, 0))
    mask = lane < count
    cols = [G.gather_column_plain(c, idx, mask) for c in block.columns]
    return DeviceBatch(block.schema, cols, torch.full(
        (), count, dtype=torch.int32, device=block.device))


def packed_slice(block: DeviceBatch, start: int, count: int,
                 kernels: Optional[B.Kernels] = None) -> DeviceBatch:
    """K10: partition rows ``[start, start + count)`` of a packed block,
    moved to the front of a batch of the block's padded size (a
    clipped-index gather; validity AND lane < count).  ``start`` and
    ``count`` are host ints from ``fetch_counts``."""
    kernels = B.kernels_for(block.columns[0].validity, kernels)
    if kernels is None:
        return packed_slice_plain(block, start, count)
    lib = kernels.library("shuffle")
    padded = block.padded_rows
    dev = block.device
    st = kernels.stream(block.columns[0].validity)
    cols, desc = [], []
    for c in block.columns:
        data = c.data.contiguous()
        valid = c.validity.contiguous()
        out = DeviceColumn(c.dtype, torch.empty_like(data),
                           torch.empty_like(valid),
                           None if c.lengths is None
                           else torch.empty_like(c.lengths.contiguous()))
        lengths = None if c.lengths is None else c.lengths.contiguous()
        cols.append(out)
        desc.append([B.ptr(data), B.ptr(out.data), B.ptr(valid),
                     B.ptr(out.validity), B.ptr(lengths) or 0,
                     B.ptr(out.lengths) or 0, G._row_bytes(data)])
    for at in range(0, len(desc), MAX_SLICE_COLS):
        part = desc[at:at + MAX_SLICE_COLS]
        flat = [v for d in part for v in d]
        B.launch(SLICE_LAUNCHES, lib, "k10_slice",
                 (ctypes.c_longlong * len(flat))(*flat), len(part), padded,
                 start, count, st)
    return DeviceBatch(block.schema, cols, torch.full(
        (), count, dtype=torch.int32, device=dev))
