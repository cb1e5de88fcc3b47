"""Device sort.

Counterpart of ``spark_rapids_tpu/exec/sort.py``: ``TpuSortExec._order``
and ``_compute`` (the permutation of the sort keys from K1, padding rows
last, then a K4 gather of every column) for a partition of one batch,
and the reference's out-of-core path (``_sort_chunked``,
``_merge_tiles``) for a partition of several: each batch is sorted into
a run, the runs are cut into tiles of a quarter of the first run's rows,
and a k-way merge streams the sorted output.  Every unloaded row of a
run orders at or after the last row of its latest loaded tile, so the
carried rows that order at or before the smallest such threshold over
the active runs are final and go out as one batch.  The threshold run
and the split of the carry at the threshold row are found by the same
device sort (K1) over the candidate rows (the reference compares the
thresholds on the host); the split is a K4 gather.  The tiles stay on
the device: spill parking and split-and-retry wait for the memory
manager (ROADMAP A6).  Records ``TpuSortExec.numInputBatches``.
"""
from __future__ import annotations

from collections import deque
from typing import List

import torch

from ..data.column import (DeviceBatch, DeviceColumn, bucket_rows,
                           slice_device_batch)
from ..ops.expression import as_device_column
from ..ops.kernels import gather as G
from ..ops.kernels import segment as seg
from .base import DevicePartitionedData, TargetSize, TpuExec
from .coalesce import concat_device_batches

_BATCHES = "TpuSortExec.numInputBatches"


class _Tile:
    """One tile of a sorted run and its last row (a one-row batch, the
    merge's threshold for the run)."""

    __slots__ = ("batch", "last_row")

    def __init__(self, batch, last_row):
        self.batch = batch
        self.last_row = last_row


class TpuSortExec(TpuExec):
    def __init__(self, child, keys):
        super().__init__([child])
        self.keys = keys  # List[functions.SortKey], exprs already bound

    @property
    def schema(self):
        return self.children[0].schema

    @property
    def children_coalesce_goal(self):
        # multi-batch partitions run the tile merge
        return [TargetSize()]

    def _order(self, batch):
        padded, dev = batch.padded_rows, batch.device
        rm = batch.row_mask()
        key_cols = []
        for k in self.keys:
            c = as_device_column(k.expr.eval_tpu(batch), padded, dev)
            # padding rows must not influence the order
            key_cols.append(DeviceColumn(c.dtype, c.data, c.validity & rm,
                                         c.lengths))
        return seg.lexsort_device(
            key_cols,
            descending=[not k.ascending for k in self.keys],
            nulls_first=[k.nulls_first for k in self.keys],
            pad_valid=rm)

    def _compute(self, batch):
        return G.gather_batch(batch, self._order(batch), batch.num_rows)

    # ------------------------------------------------------------------
    # external merge
    # ------------------------------------------------------------------
    def _make_tiles(self, sorted_run: DeviceBatch, tile_rows: int
                    ) -> List[_Tile]:
        n = int(sorted_run.num_rows)
        tiles = []
        for start in range(0, n, tile_rows):
            stop = min(start + tile_rows, n)
            tiles.append(_Tile(
                slice_device_batch(sorted_run, start, stop),
                slice_device_batch(sorted_run, stop - 1, stop, 1)))
        return tiles

    def _argmin_run(self, heads: List[_Tile]) -> int:
        """Index of the run whose threshold row orders first (the first
        of equal ones)."""
        if len(heads) == 1:
            return 0
        rows = concat_device_batches([h.last_row for h in heads], 1)
        return int(self._order(rows)[0])

    def _split_sorted(self, combined: DeviceBatch, order: List[int],
                      sentinel_idx: int):
        """Split the sorted view of ``combined`` at the sentinel row:
        rows ordering <= sentinel (emitted) vs the rest (carried)."""
        pos = order.index(sentinel_idx)
        n_real = int(combined.num_rows)  # includes the sentinel
        dev = combined.device

        def take(idx: List[int]) -> DeviceBatch:
            cnt = len(idx)
            padded = bucket_rows(cnt)
            full = torch.zeros(padded, dtype=torch.int32)
            full[:cnt] = torch.tensor(idx, dtype=torch.int32)
            full = full.to(dev)
            mask = torch.arange(padded, dtype=torch.int32, device=dev) < cnt
            return G.gather_batch(combined, full,
                                  torch.tensor(cnt, dtype=torch.int32,
                                               device=dev), mask)

        emit = take(order[:pos]) if pos else None
        carry = take(order[pos + 1:n_real])
        return emit, carry

    def _merge_tiles(self, runs: List[deque]):
        """K-way merge of sorted, tiled runs: every unloaded row of run r
        orders >= the last row of r's most recently loaded tile, so carry
        rows ordering <= the smallest active threshold are final."""
        heads = [q.popleft() for q in runs]
        carry = concat_device_batches([h.batch for h in heads])
        active = list(range(len(runs)))
        while active:
            k = self._argmin_run([heads[i] for i in active])
            r = active[k]
            combined = concat_device_batches([carry, heads[r].last_row], 1)
            order = self._order(combined).tolist()
            emit, carry = self._split_sorted(combined, order,
                                             int(carry.num_rows))
            if emit is not None:
                yield emit
            # advance the bottleneck run
            if runs[r]:
                heads[r] = runs[r].popleft()
                carry = concat_device_batches([carry, heads[r].batch])
            else:
                active.remove(r)
        if int(carry.num_rows) > 0:
            yield self._compute(carry)

    def _sort_chunked(self, batches):
        """Sort each batch into a run (the first kept whole until a
        second shows), tile the runs, and stream the merge."""
        runs: List[deque] = []
        tile_rows = None
        pending_first = None
        for b in batches:
            s = self._compute(b)
            if int(s.num_rows) == 0:
                continue
            if pending_first is None and not runs:
                pending_first = s
                continue
            if pending_first is not None:
                tile_rows = bucket_rows(
                    max(1, int(pending_first.num_rows) // 4))
                runs.append(deque(self._make_tiles(pending_first,
                                                   tile_rows)))
                pending_first = None
            runs.append(deque(self._make_tiles(s, tile_rows)))
        if pending_first is not None:
            yield pending_first
            return
        if runs:
            yield from self._merge_tiles(runs)

    def execute_columnar(self, ctx):
        child = self.children[0].execute_columnar(ctx)

        def make(pid):
            def it():
                batches = list(child.iterator(pid))
                ctx.add_metric(_BATCHES, len(batches))
                if len(batches) == 1:
                    yield self._compute(batches[0])
                elif batches:
                    yield from self._sort_chunked(batches)
            return it

        return DevicePartitionedData(
            [make(i) for i in range(child.n_partitions)])

    def describe(self):
        ks = ", ".join(
            f"{k.expr.sql()} {'ASC' if k.ascending else 'DESC'}"
            for k in self.keys)
        return f"TpuSort[{ks}]"


def register(register_exec):
    from ..plan import physical as P

    register_exec(
        P.SortExec,
        convert=lambda meta, ch: TpuSortExec(ch[0], meta.plan.keys),
        desc="device sort (stable LSD radix over key passes)",
        exprs_of=lambda plan: [k.expr for k in plan.keys])
