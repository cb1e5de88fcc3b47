"""Post-conversion transition pass.

Counterpart of ``spark_rapids_tpu/plan/transitions.py``: cancel adjacent
host<->device transitions, insert ``TpuCoalesceBatchesExec`` per each
exec's child coalesce goals (RequireSingleBatch dominating in a merge)
and merge adjacent coalesces, put the final ``DeviceToHostExec`` on top,
and in test mode fail when an operator is not converted.  The fusion
pass (``plan/fusion.py``) runs between transition cancellation and
coalesce insertion, as the reference's does (``transitions.py:27-32``).
"""
from __future__ import annotations

from ..config import TpuConf
from ..exec.base import TpuExec
from ..exec.coalesce import TpuCoalesceBatchesExec
from ..exec.transitions import DeviceToHostExec, HostToDeviceExec
from . import physical as P


class TpuTransitionOverrides:
    def __init__(self, conf: TpuConf):
        self.conf = conf

    def apply(self, plan: P.PhysicalPlan) -> P.PhysicalPlan:
        plan = self._optimize_transitions(plan)
        # fusion runs after transition cancellation (a cancelled
        # D2H/H2D pair can join two row-local chains) and before
        # coalesce insertion (goals then apply to whole segments)
        from .fusion import TpuFusionPass

        plan = TpuFusionPass(self.conf).apply(plan)
        plan = self._insert_coalesce(plan, goal=None)
        plan = self._optimize_coalesce(plan)
        if isinstance(plan, TpuExec):
            plan = DeviceToHostExec(plan)
        if self.conf.is_test_enabled:
            self._assert_is_on_device(plan)
        return plan

    def _optimize_transitions(self, plan: P.PhysicalPlan) -> P.PhysicalPlan:
        children = [self._optimize_transitions(c) for c in plan.children]
        if isinstance(plan, DeviceToHostExec) and \
                isinstance(children[0], HostToDeviceExec):
            return children[0].children[0]
        if isinstance(plan, HostToDeviceExec) and \
                isinstance(children[0], DeviceToHostExec):
            return children[0].children[0]
        if children != list(plan.children):
            plan = plan.with_new_children(children)
        return plan

    def _insert_coalesce(self, plan: P.PhysicalPlan, goal) -> P.PhysicalPlan:
        child_goals = plan.children_coalesce_goal \
            if isinstance(plan, TpuExec) else [None] * len(plan.children)
        new_children = [self._insert_coalesce(c, g)
                        for c, g in zip(plan.children, child_goals)]
        if new_children != list(plan.children):
            plan = plan.with_new_children(new_children)
        if goal is not None and isinstance(plan, TpuExec) and \
                not isinstance(plan, TpuCoalesceBatchesExec):
            return TpuCoalesceBatchesExec(plan, goal)
        return plan

    def _optimize_coalesce(self, plan: P.PhysicalPlan) -> P.PhysicalPlan:
        children = [self._optimize_coalesce(c) for c in plan.children]
        if isinstance(plan, TpuCoalesceBatchesExec) and \
                isinstance(children[0], TpuCoalesceBatchesExec):
            inner = children[0]
            return TpuCoalesceBatchesExec(inner.children[0],
                                          plan.goal.max_with(inner.goal))
        if children != list(plan.children):
            plan = plan.with_new_children(children)
        return plan

    def _assert_is_on_device(self, plan: P.PhysicalPlan) -> None:
        allowed = set(self.conf.allowed_non_tpu)
        always_ok = {"LocalScanExec", "HostToDeviceExec",
                     "DeviceToHostExec"}

        def walk(p):
            name = type(p).__name__
            if not isinstance(p, TpuExec) and name not in always_ok \
                    and name not in allowed:
                raise AssertionError(
                    f"operator {name} is not on the device (test mode); "
                    "allow with spark.rapids.tpu.sql.test.allowedNonTpu")
            for c in p.children:
                walk(c)

        walk(plan)
