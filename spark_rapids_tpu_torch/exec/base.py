"""Device exec base.

Counterpart of ``spark_rapids_tpu/exec/base.py``: coalesce goals,
``DevicePartitionedData`` and ``TpuExec``, the base of every operator
that runs on device batches.  The reference's kernel twins and jit
caches have no counterpart: PyTorch runs eagerly and the hand-written
kernels are built once per process.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence

from ..data.column import DeviceBatch
from ..plan.physical import ExecContext, PhysicalPlan


class CoalesceGoal:
    def max_with(self, other: "CoalesceGoal") -> "CoalesceGoal":
        if isinstance(self, RequireSingleBatch) or \
                isinstance(other, RequireSingleBatch):
            return RequireSingleBatch()
        if isinstance(self, TargetSize) and isinstance(other, TargetSize):
            if self.target is None:
                return self
            if other.target is None:
                return other
            return self if self.target >= other.target else other
        if isinstance(self, TargetRows) and isinstance(other, TargetRows):
            if self.rows is None:
                return self
            if other.rows is None:
                return other
            return self if self.rows >= other.rows else other
        return self


class TargetSize(CoalesceGoal):
    """``target=None`` means the session's batchSizeBytes."""

    def __init__(self, target: Optional[int] = None):
        self.target = target

    def __repr__(self):
        return f"TargetSize({self.target})"


class TargetRows(CoalesceGoal):
    """``rows=None`` means the session's shuffle.targetBatchRows."""

    def __init__(self, rows: Optional[int] = None):
        self.rows = rows

    def __repr__(self):
        return f"TargetRows({self.rows})"


class RequireSingleBatch(CoalesceGoal):
    """All of a partition's batches concatenated into one (a join's build
    side)."""

    def __repr__(self):
        return "RequireSingleBatch"


class DevicePartitionedData:
    def __init__(self, parts: List[Callable[[], Iterator[DeviceBatch]]]):
        self.parts = parts

    @property
    def n_partitions(self):
        return len(self.parts)

    def iterator(self, pid: int) -> Iterator[DeviceBatch]:
        return self.parts[pid]()


class TpuExec(PhysicalPlan):
    """Base of all device operators."""

    def __init__(self, children: Sequence[PhysicalPlan] = ()):
        super().__init__(children)

    @property
    def children_coalesce_goal(self) -> List[Optional[CoalesceGoal]]:
        return [None] * len(self.children)

    @property
    def coalesce_after(self) -> bool:
        """True if output batches may be small and benefit from
        coalescing above (the reference's ``coalesce_after``)."""
        return False

    def execute_columnar(self, ctx: ExecContext) -> DevicePartitionedData:
        raise NotImplementedError(f"{self.name}.execute_columnar")

    def execute(self, ctx: ExecContext):
        raise RuntimeError(
            f"{self.name} does not run on the host; a DeviceToHostExec "
            "transition should have been inserted")
