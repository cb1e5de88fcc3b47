"""Session — the engine's entry point.

Counterpart of ``spark_rapids_tpu/session.py``:

    logical plan -> planner -> physical plan
      -> TpuOverrides (tag/convert) -> TpuTransitionOverrides -> execute

``Session()`` runs on ``cuda``; a machine without CUDA raises instead of
falling back to the CPU.  On ``cuda``, making a plan also builds the
generated kernels of its fused segments (all at once, in parallel), so
no build lands inside a query's execution.  ``Session(device="cpu")``
runs the same device path on CPU tensors, where every kernel wrapper
takes its plain PyTorch version — the tests' mode.  The reference's optimizer (it prunes file
scans only), scheduler, recovery, serving, streaming and telemetry
layers are not ported; ``prepare_execution`` is the plan-and-context
half of the reference's (no plan cache, exec lock, scheduler admission,
cancel token or recovery).  ``execute_columnar`` is the ML export
(``ml/``), gated by ``spark.rapids.tpu.sql.exportColumnarRdd``.
``execute`` of a write (``DataFrame.write_parquet``) drains every
partition, which writes the files, and keeps the write's stats in
``last_write_stats``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .config import EXPORT_COLUMNAR_RDD, TpuConf
from .data.column import HostBatch
from .plan import logical as L
from .plan.logical import DataFrame
from .plan.physical import ExecContext, PhysicalPlan, collect_batches
from .plan.planner import Planner


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "Session() runs on CUDA and this machine has no CUDA "
                "device; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def _build_fused_segments(plan: PhysicalPlan) -> None:
    """Build every fused segment's kernel of ``plan`` now, in parallel,
    so no build lands inside a query's execution."""
    from .exec.fused import TpuFusedSegmentExec
    from .ops.kernels import _build

    sources = {}

    def walk(p):
        if isinstance(p, TpuFusedSegmentExec):
            sources[p.program.key] = p.program.source
        for c in p.children:
            walk(c)

    walk(plan)
    if sources:
        _build.CUDA.prepare(sources)


class Session:
    def __init__(self, conf: Optional[Dict] = None, device=None):
        self.conf = TpuConf(conf)
        self.device = resolve_device(device)
        #: metrics of the last execution (ExecContext.metrics)
        self.last_metrics: Dict[str, int] = {}
        #: row placement of its exchanges (ExecContext.placements)
        self.last_placements: List[dict] = []
        #: its shuffled joins' records (ExecContext.joins)
        self.last_joins: List[dict] = []
        #: the WriteStatsTracker of the last write (files, rows, bytes)
        self.last_write_stats = None

    def create_dataframe(self, data, schema=None,
                         n_partitions: int = 2) -> DataFrame:
        """From a HostBatch, or a dict of name -> values (with an optional
        Schema), split over ``n_partitions`` (two by default, as in the
        reference's ``create_dataframe``)."""
        if isinstance(data, HostBatch):
            batch = data
        elif isinstance(data, dict):
            batch = HostBatch.from_pydict(data, schema)
        else:
            raise TypeError(f"cannot create a dataframe from {type(data)}")
        return DataFrame(self, L.LocalRelation([batch], batch.schema,
                                               n_partitions))

    def physical_plan(self, plan: L.LogicalPlan) -> PhysicalPlan:
        phys = Planner(self.conf).plan(plan)
        if not self.conf.is_sql_enabled:
            raise NotImplementedError(
                "spark.rapids.tpu.sql.enabled=false selects the host "
                "engine, which is not ported yet")
        from .plan.overrides import TpuOverrides
        from .plan.transitions import TpuTransitionOverrides

        phys = TpuOverrides(self.conf).apply(phys)
        phys = TpuTransitionOverrides(self.conf).apply(phys)
        if self.device.type == "cuda":
            _build_fused_segments(phys)
        return phys

    def prepare_execution(self, plan: L.LogicalPlan):
        """The physical plan of ``plan`` and a new execution context: the
        front half shared by ``execute`` and the ML export."""
        return self.physical_plan(plan), ExecContext(self.conf, self.device)

    def finish_execution(self, ctx: ExecContext) -> None:
        """Keep the finished execution's metrics, placements, joins and
        (of a write) its write stats."""
        self.last_metrics = dict(ctx.metrics)
        self.last_placements = list(ctx.placements)
        self.last_joins = list(ctx.joins)
        if ctx.write_stats is not None:
            self.last_write_stats = ctx.write_stats

    def execute(self, plan: L.LogicalPlan) -> HostBatch:
        phys, ctx = self.prepare_execution(plan)
        out = collect_batches(phys.execute(ctx), phys.schema)
        self.finish_execution(ctx)
        return out

    def execute_columnar(self, plan: L.LogicalPlan):
        """The ML export: the final stage's device batches, in partition
        order, never copied to the host (requires
        ``spark.rapids.tpu.sql.exportColumnarRdd``)."""
        if not self.conf.get(EXPORT_COLUMNAR_RDD):
            raise RuntimeError(
                f"set {EXPORT_COLUMNAR_RDD.key}=true to export device "
                "batches")
        from .ml.columnar_export import export_device_batches

        return export_device_batches(self, plan)

    def explain(self, plan: L.LogicalPlan, mode: str = "ALL") -> str:
        from .plan.overrides import TpuOverrides

        phys = Planner(self.conf).plan(plan)
        return TpuOverrides(self.conf.set(
            "spark.rapids.tpu.sql.explain", mode)).explain(phys)
