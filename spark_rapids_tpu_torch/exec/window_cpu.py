"""The physical window node.

Counterpart of ``spark_rapids_tpu/exec/window_cpu.py:180 WindowExec``:
the node the planner emits for a logical ``Window`` — the child's columns
plus one column per window expression, with the expressions bound to
the child's schema.  The rewrite engine converts it to
``exec/window.py:TpuWindowExec``.  The reference's host evaluation
(``compute_window_host``) comes with the host-engine slice, so
``execute`` raises.
"""
from __future__ import annotations

from typing import List

from .. import types as T
from ..ops.windowexprs import WindowExpression
from ..plan.physical import PhysicalPlan


class WindowExec(PhysicalPlan):
    def __init__(self, child: PhysicalPlan,
                 window_exprs: List[WindowExpression], names: List[str]):
        super().__init__([child])
        self.window_exprs = [w.bind(child.schema) for w in window_exprs]
        self.names = names
        fields = list(child.schema.fields)
        for name, w in zip(names, self.window_exprs):
            fields.append(T.Field(name, w.dtype, True))
        self._schema = T.Schema(fields)

    @property
    def schema(self):
        return self._schema

    def execute(self, ctx):
        raise NotImplementedError(
            "WindowExec runs only as TpuWindowExec here: the host engine's "
            "window evaluation (compute_window_host) is not ported yet")

    def describe(self):
        return f"Window[{', '.join(w.sql() for w in self.window_exprs)}]"
