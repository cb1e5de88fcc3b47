"""Device shuffle exchange: single, hash, round-robin and range.

Counterpart of ``spark_rapids_tpu/exec/exchange.py:TpuShuffleExchangeExec``
on its default data path (``spark.rapids.tpu.shuffle.mode=auto``, which
on this card is always the device path):

  * hash and round robin (the reference's packed path, ``:312-332``):
    per input batch, in write order (input partition, then batch), the
    partition ids (K9 Murmur3 for hash; ``(row + offset) % n_out`` for
    round robin, the offset advancing on the card by each batch's row
    count), then K10's stable build of the batch's order by partition.
    One readback per chunk of up to 32 batches fetches their counts
    (``shuffle/device_shuffle.py:fetch_counts``); then K10's split
    writes every non-empty partition of each batch straight from it, in
    one launch, at ``bucket_rows(count)`` rows (the reference gathers the
    batch into a block and slices each partition out of it at the
    block's padded size, ``:693-708``).  A reader yields its partition's
    batches in write order, skipping empty ones without touching the
    card.
  * range (the reference's compaction path, ``:418-430,464-481,599-606,
    710-717``): at write time each batch's key passes (K1's encoding,
    strings cut to ``RANGE_PREFIX_BYTES``, nothing after the first
    string key) and 128 samples of them; one readback per chunk of up to
    32 batches fetches the row counts and samples; the bounds are picked
    on the host from every sample in write order; each batch's partition
    ids come from K11; then the same K10 build, counts and split as hash
    (the reference compacts ``pids == p`` out of each batch for each
    partition).  Rows keep their batch order inside a partition: the
    build is stable, as the compaction is.
  * one output partition (single partitioning, or any partitioning to
    one partition) hands the child's batches of every input partition
    through in order: the reference's build and slice return the same
    rows at the same padded size there.

``spark.rapids.tpu.shuffle.mode=host`` raises: it needs the spill tier
(ROADMAP A6).  Not ported, for later slices: the spill framework and the
host-staged blocks, stage checkpoints and recovery, the writer election
across threads, fault injection, the shuffle catalog and the AQE handles
(ROADMAP A10).  Each multi-partition exchange appends its row placement
(rows written, rows each output partition yielded) to the context's
``placements``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import SHUFFLE_MODE
from ..data.column import DeviceBatch, DeviceColumn
from ..ops.expression import as_device_column
from ..ops.kernels import _build as B
from ..ops.kernels import segment as seg
from ..shuffle import device_shuffle as DS
from ..shuffle.partitioning import (HashPartitioning, RangePartitioning,
                                    RoundRobinPartitioning)
from ..utils import hashing
from .base import DevicePartitionedData, TargetRows, TpuExec

#: string keys are cut to this byte prefix for range PLACEMENT (not for
#: the sort itself): 4 passes per string key
RANGE_PREFIX_BYTES = 32

#: device key samples taken per batch for the range bounds
RANGE_SAMPLES_PER_BATCH = 128

#: batches whose counts (or row counts and samples) one host readback
#: fetches
WRITE_CHUNK = 32

#: CUDA kernels launched by K11
RANGE_PID_LAUNCHES = B.LaunchCounter("range_pids")


def range_key_passes(batch: DeviceBatch, bound_keys) -> torch.Tensor:
    """Stacked signed-order int64 passes ``[k, padded]`` of the range sort
    keys, string keys cut to ``RANGE_PREFIX_BYTES`` (a monotone
    coarsening of the order).  No key after the first string key
    contributes passes: rows whose strings agree on the prefix would
    otherwise be placed by the later key against the global order.  The
    cut is unconditional, so the pass layout is the same for every
    batch."""
    cols, used = [], []
    for k in bound_keys:
        c = as_device_column(k.expr.eval_tpu(batch), batch.padded_rows,
                             batch.device)
        if c.dtype.is_string:
            bm, w = c.data, c.data.shape[1]
            if w < RANGE_PREFIX_BYTES:
                bm = torch.nn.functional.pad(bm, (0, RANGE_PREFIX_BYTES - w))
            else:
                bm = bm[:, :RANGE_PREFIX_BYTES]
            pos = torch.arange(RANGE_PREFIX_BYTES, dtype=torch.int32,
                               device=bm.device)[None, :]
            bm = torch.where(pos < c.lengths[:, None], bm,
                             torch.zeros((), dtype=bm.dtype,
                                         device=bm.device))
            c = DeviceColumn(c.dtype, bm, c.validity,
                             torch.clamp(c.lengths, max=RANGE_PREFIX_BYTES))
        cols.append(c)
        used.append(k)
        if c.dtype.is_string:
            break
    return seg.key_passes_device(
        cols, descending=[not k.ascending for k in used],
        nulls_first=[k.nulls_first for k in used])


def range_pids_plain(passes: torch.Tensor,
                     bounds: torch.Tensor) -> torch.Tensor:
    """Plain version of K11 (the reference's lexicographic compare)."""
    n, nb = passes.shape[1], bounds.shape[1]
    eq = torch.ones((n, nb), dtype=torch.bool, device=passes.device)
    gt = torch.zeros((n, nb), dtype=torch.bool, device=passes.device)
    for j in range(passes.shape[0]):
        pj = passes[j][:, None]
        bj = bounds[j][None, :]
        gt = gt | (eq & (pj > bj))
        eq = eq & (pj == bj)
    return gt.sum(dim=1).to(torch.int32)


def range_pids_from_bounds(passes: torch.Tensor, bounds: torch.Tensor,
                           kernels: Optional[B.Kernels] = None
                           ) -> torch.Tensor:
    """K11: pid = the number of bounds (``[k, n_out - 1]``) the row's
    passes (``[k, n]``) exceed lexicographically, passes[0] dominating;
    monotone in the sort order for any bounds (int32[n])."""
    kernels = B.kernels_for(passes, kernels)
    if kernels is None:
        return range_pids_plain(passes, bounds)
    k, n = passes.shape
    if bounds.shape[0] != k or bounds.shape[1] < 1:
        raise ValueError(f"bounds {tuple(bounds.shape)} do not fit passes "
                         f"{tuple(passes.shape)}")
    passes = passes.contiguous()
    bounds = bounds.to(device=passes.device, dtype=torch.int64).contiguous()
    pids = torch.empty(n, dtype=torch.int32, device=passes.device)
    B.launch(RANGE_PID_LAUNCHES, kernels.library("range_partition"),
             "k11_range_pids", B.ptr(passes), k, n, B.ptr(bounds),
             bounds.shape[1], B.ptr(pids), kernels.stream(passes),
             launched=None if n else 0)
    return pids


def range_samples(passes: torch.Tensor,
                  num_rows: torch.Tensor) -> torch.Tensor:
    """``RANGE_SAMPLES_PER_BATCH`` evenly spaced rows of a batch's passes
    (``[k, 128]``), indexed on the card from its row count."""
    lane = torch.arange(RANGE_SAMPLES_PER_BATCH, dtype=torch.int64,
                        device=passes.device)
    idx = lane * torch.clamp(num_rows.to(torch.int64), min=1) \
        // RANGE_SAMPLES_PER_BATCH
    return passes[:, idx]


def pick_bounds_host(samples: np.ndarray, n_out: int) -> np.ndarray:
    """Quantile bounds ``[k, n_out - 1]`` from the gathered sample passes
    ``[k, n_samples]`` (on the host, like the reference's
    bounds).  ``np.lexsort`` orders the signed-order int64 passes as the
    reference's uint64 passes, so it picks the same bounds."""
    order = np.lexsort(samples[::-1])  # passes[0] dominates
    v = samples.shape[1]
    cuts = [min(max((v * (i + 1)) // n_out, 0), v - 1)
            for i in range(n_out - 1)]
    return samples[:, order[cuts]]


class TpuShuffleExchangeExec(TpuExec):
    def __init__(self, child, plan):
        super().__init__([child])
        self.plan = plan  # physical.ShuffleExchangeExec
        self.partitioning = plan.partitioning
        self.n_out = plan.n_out

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def children_coalesce_goal(self):
        # sub-target input batches coalesce to shuffle.targetBatchRows
        # before the partition build
        return [TargetRows(None)]

    # ------------------------------------------------------------------
    def _pids(self, batch: DeviceBatch, rr: torch.Tensor) -> torch.Tensor:
        if isinstance(self.partitioning, RoundRobinPartitioning):
            lane = torch.arange(batch.padded_rows, dtype=torch.int32,
                                device=batch.device)
            return (lane + rr) % self.n_out
        if isinstance(self.partitioning, HashPartitioning):
            cols = [as_device_column(k.eval_tpu(batch), batch.padded_rows,
                                     batch.device)
                    for k in self.partitioning._bound]
            return hashing.hash_pids(cols, self.n_out)
        raise NotImplementedError(
            f"no device placement for {self.partitioning.describe()}")

    def _split(self, batches, placement, count_written: bool) -> list:
        """K10's build of each ``(batch, pids)``, one readback of a
        chunk's counts, then K10's split of each batch; returns the
        non-empty batches as ``(partition batches, counts)`` (a batch or
        None a partition; host ints).  ``count_written`` adds the rows to
        the placement's ``rows_written``."""
        items: list = []
        chunk: list = []

        def flush():
            got = DS.fetch_counts([(c, s) for _b, _o, c, s in chunk],
                                  [b.num_rows for b, _o, _c, _s in chunk])
            # each input batch is let go as soon as it is split
            chunk.reverse()
            for counts, _starts, rows in got:
                b, order, device_counts, _s = chunk.pop()
                if sum(counts) != rows:
                    raise RuntimeError(
                        f"{self.describe()}: the partition build placed "
                        f"{sum(counts)} of {rows} rows")
                if count_written:
                    placement["rows_written"] += rows
                if rows:
                    parts = DS.partition_split(
                        b, order, counts, device_counts=device_counts)
                    DS.GLOBAL.add("deviceBytes", sum(
                        pb.device_bytes() for pb in parts if pb is not None))
                    items.append((parts, counts))

        for b, pids in batches:
            order, counts, starts = DS.partition_order(pids, b.num_rows,
                                                       self.n_out)
            chunk.append((b, order, counts, starts))
            if len(chunk) >= WRITE_CHUNK:
                flush()
        if chunk:
            flush()
        return items

    def _write_packed(self, child, placement) -> list:
        """Every input batch's partition ids (K9 or round robin), then
        ``_split``."""
        def with_pids():
            rr: Optional[torch.Tensor] = None
            for pid in range(child.n_partitions):
                for b in child.iterator(pid):
                    if rr is None:
                        rr = torch.zeros((), dtype=torch.int32,
                                         device=b.device)
                    pids = self._pids(b, rr)
                    if isinstance(self.partitioning,
                                  RoundRobinPartitioning):
                        rr = (rr + b.num_rows) % self.n_out
                    yield b, pids

        return self._split(with_pids(), placement, True)

    def _write_range(self, child, placement):
        """Key passes and samples of every input batch, bounds from all
        samples in write order, then each batch's partition ids (K11);
        yields the non-empty batches as ``(batch, pids)``, for ``_split``,
        dropping each batch's passes as its ids are made."""
        keys = self.partitioning._bound_keys
        kept: list = []   # (batch, passes)
        samples: List[np.ndarray] = []
        chunk: list = []  # (batch, passes, samples on the card)

        def flush():
            nrs = torch.stack([b.num_rows.to(torch.int32)
                               for b, _p, _s in chunk]).cpu().tolist()
            samps = torch.stack([s for _b, _p, s in chunk]).cpu().numpy()
            for (b, passes, _s), n, samp in zip(chunk, nrs, samps):
                placement["rows_written"] += n
                if n:
                    samples.append(samp)
                    kept.append((b, passes))
            chunk.clear()

        for pid in range(child.n_partitions):
            for b in child.iterator(pid):
                passes = range_key_passes(b, keys)
                chunk.append((b, passes, range_samples(passes, b.num_rows)))
                if len(chunk) >= WRITE_CHUNK:
                    flush()
        if chunk:
            flush()
        if not kept:
            return
        bounds = torch.from_numpy(pick_bounds_host(
            np.concatenate(samples, axis=1), self.n_out)).to(
                kept[0][1].device)
        kept.reverse()
        while kept:
            b, passes = kept.pop()
            yield b, range_pids_from_bounds(passes, bounds)

    def execute_columnar(self, ctx):
        DS.resolve_mode(ctx.conf.get(SHUFFLE_MODE))
        child = self.children[0].execute_columnar(ctx)
        if self.n_out == 1:
            def single():
                for pid in range(child.n_partitions):
                    yield from child.iterator(pid)

            return DevicePartitionedData([single])

        is_range = isinstance(self.partitioning, RangePartitioning)
        placement = {"exchange": self.describe(), "rows_written": 0,
                     "partition_rows": [0] * self.n_out}
        ctx.placements.append(placement)
        store: list = []

        def materialized():
            """The shuffle write, run once by the first reader."""
            if not store:
                store.append(
                    self._split(self._write_range(child, placement),
                                placement, False) if is_range
                    else self._write_packed(child, placement))
            return store[0]

        def reader(p):
            for parts, counts in materialized():
                if counts[p] == 0:
                    continue
                placement["partition_rows"][p] += counts[p]
                yield parts[p]

        return DevicePartitionedData(
            [lambda p=p: reader(p) for p in range(self.n_out)])

    def describe(self):
        return f"TpuShuffleExchange[{self.partitioning.describe()}]"


def register(register_exec):
    from ..plan import physical as P

    def exprs_of(plan):
        part = plan.partitioning
        if isinstance(part, RangePartitioning):
            return [k.expr for k in (part._bound_keys or part.sort_keys)]
        return list(getattr(part, "_bound", None)
                    or getattr(part, "keys", []) or [])

    register_exec(
        P.ShuffleExchangeExec,
        convert=lambda meta, ch: TpuShuffleExchangeExec(ch[0], meta.plan),
        desc="device hash/single/round-robin/range exchange",
        exprs_of=exprs_of)
