"""Whole-stage fusion: the post-planner physical rewrite.

Counterpart of ``spark_rapids_tpu/plan/fusion.py:52-96``: collapses
maximal chains of row-local device execs into one
``TpuFusedSegmentExec`` (``exec/fused.py``) whose one generated kernel
composes the members — one launch per batch per segment instead of one
or more per operator, and no intermediate batch written between members.

Runs inside ``TpuTransitionOverrides.apply`` after transition
cancellation and before coalesce insertion, as the reference does.
Fusion stops at anything not row-local (exchanges, aggregates, sorts,
joins, limits, coalesces, transitions), at nondeterministic expressions,
and at ``fusion.maxSegmentExecs`` members (a longer chain becomes
several segments).  The row-local execs are Project, Filter, Expand
and Generate (``fusion.py:36-49``).  The reference's input donation has
no counterpart.
"""
from __future__ import annotations

from ..config import FUSION_ENABLED, FUSION_MAX_SEGMENT_EXECS, TpuConf
from ..exec.basic import TpuExpandExec, TpuFilterExec, TpuProjectExec
from ..exec.fused import TpuFusedSegmentExec
from ..exec.generate import TpuGenerateExec
from . import physical as P

#: the row-local execs whose compute bodies compose
_ROW_LOCAL = (TpuProjectExec, TpuFilterExec, TpuExpandExec,
              TpuGenerateExec)


def _member_exprs(node):
    if isinstance(node, TpuProjectExec):
        return node.exprs
    if isinstance(node, TpuFilterExec):
        return [node.condition]
    if isinstance(node, TpuExpandExec):
        return [e for ps in node.projections for e in ps]
    if isinstance(node, TpuGenerateExec):
        return node.elements
    return []


class TpuFusionPass:
    def __init__(self, conf: TpuConf):
        self.enabled = bool(conf.get(FUSION_ENABLED))
        self.max_members = max(2, int(conf.get(FUSION_MAX_SEGMENT_EXECS)))

    def apply(self, plan: P.PhysicalPlan) -> P.PhysicalPlan:
        if not self.enabled:
            return plan
        return self._rewrite(plan)

    def _fusable(self, node) -> bool:
        return isinstance(node, _ROW_LOCAL) \
            and len(node.children) == 1 \
            and all(e.deterministic for e in _member_exprs(node))

    def _rewrite(self, plan: P.PhysicalPlan) -> P.PhysicalPlan:
        if self._fusable(plan):
            chain = [plan]  # top-of-segment first
            while len(chain) < self.max_members and \
                    self._fusable(chain[-1].children[0]):
                chain.append(chain[-1].children[0])
            if len(chain) >= 2:
                child = self._rewrite(chain[-1].children[0])
                return TpuFusedSegmentExec(list(reversed(chain)), child)
        children = [self._rewrite(c) for c in plan.children]
        if children != list(plan.children):
            plan = plan.with_new_children(children)
        return plan
