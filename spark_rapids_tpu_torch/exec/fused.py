"""Whole-stage fused segment exec.

Counterpart of ``spark_rapids_tpu/exec/fused.py:53-144``: a maximal chain
of row-local execs (built by ``plan/fusion.py``) becomes one exec whose
one kernel per batch, K12 (``ops/kernels/fused.py``), composes the
members' expressions.  Project members evaluate theirs; Filter members
do not compact: their keep mask threads through the segment, and the
surviving rows compact once at segment exit (K4), so results are
bit-identical to the unfused plan — same rows, same order, same padded
bucket.  An Expand member branches the segment into one stream per
projection list and a Generate member repeats each row (and its keep
mask) ``k`` times (``_apply_member``, ``:93-112``), so one input batch
gives one output batch per stream, each compacted on its own.  On CPU
tensors the exec runs the plain composition, the members' own torch
bodies with the compaction deferred.

Left out: the kernel cache's shared executables (K12's library is built
once per distinct source and shared by every exec and process that
generates it), and input donation (PyTorch has none).  Each input batch
adds one to ``TpuFusedSegmentExec.numInputBatches`` in the context's
metrics.
"""
from __future__ import annotations

from typing import List

from ..data.column import DeviceBatch
from ..ops.kernels.fused import SegmentProgram, run_segment
from ..ops.kernels.gather import compact
from .base import DevicePartitionedData, TpuExec

_BATCHES = "TpuFusedSegmentExec.numInputBatches"


class TpuFusedSegmentExec(TpuExec):
    """One generated kernel over a bottom-up chain of row-local members.

    ``members`` is in execution order (closest to the source first);
    ``child`` is the segment input (the bottom member's child)."""

    def __init__(self, members: List[TpuExec], child):
        super().__init__([child])
        assert len(members) >= 2, "a segment fuses at least two execs"
        self.members = list(members)
        self._schema = self.members[-1].schema
        self.program = SegmentProgram(child.schema, self.members)

    @property
    def schema(self):
        return self._schema

    @property
    def coalesce_after(self):
        # a filter, expand or generate anywhere in the segment can shrink
        # or fragment output batches exactly like the unfused member
        return any(m.coalesce_after for m in self.members)

    @property
    def children_coalesce_goal(self):
        return self.members[0].children_coalesce_goal

    def _compute(self, batch: DeviceBatch) -> List[DeviceBatch]:
        # ONE compaction per output batch at segment exit — the deferred
        # form of each member filter's compact()
        return [out if keep is None else compact(out, keep)
                for out, keep in run_segment(self.program, batch)]

    def execute_columnar(self, ctx):
        child = self.children[0].execute_columnar(ctx)

        def make(pid):
            def it():
                for db in child.iterator(pid):
                    ctx.add_metric(_BATCHES)
                    yield from self._compute(db)
            return it

        return DevicePartitionedData(
            [make(i) for i in range(child.n_partitions)])

    def describe(self):
        inner = " -> ".join(m.describe() for m in self.members)
        return f"TpuFusedSegment[{len(self.members)}: {inner}]"
