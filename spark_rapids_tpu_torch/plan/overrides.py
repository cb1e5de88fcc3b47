"""The plan-rewrite engine — tag, explain, convert.

Counterpart of ``spark_rapids_tpu/plan/overrides.py``.  Every physical
node is wrapped in a meta that ``tag_for_tpu()`` annotates with the
reasons it cannot run on the device; supported nodes convert to device
execs with a host->device transition above host children, and
``explain`` renders the report (``*`` = runs on the device, ``!`` =
cannot, ``@`` = could but is disabled by conf).

The reference registry is a module global bound to the TPU execs
(``overrides.py:68-74,435``); this engine has its own ``RuleRegistry``
of device execs.  Per-operator enable keys derive from it with the
reference's names (``spark.rapids.tpu.sql.exec.<Name>`` /
``...sql.expr.<Name>``).

The host engine is not ported yet, so a node that cannot run on the
device raises ``NotImplementedError`` naming its tag reasons when the
plan is converted; only the host scan stays on the host.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

from ..config import INCOMPATIBLE_OPS, TpuConf, register_op_enable_key
from ..ops import aggregates as agg
from ..ops.expression import Expression
from . import physical as P

#: host nodes that stay on the host by design (data sources)
HOST_SOURCES = (P.LocalScanExec,)


class ExprRule:
    """``incompat`` names how the device result may differ from the
    host engine's; such a rule's enable key defaults to off and it runs
    on the device only while ``incompatibleOps.enabled`` is on, as in
    the reference (``overrides.py:37-48``)."""

    def __init__(self, cls: Type[Expression],
                 tag: Optional[Callable] = None,
                 incompat: Optional[str] = None):
        self.tag = tag  # (ExprMeta) -> None: conf- or input-based reasons
        self.incompat = incompat
        self.conf_entry = register_op_enable_key(
            "expr", cls.__name__,
            f"enable expression {cls.__name__} on the device",
            default=incompat is None)


class ExecRule:
    def __init__(self, cls: Type[P.PhysicalPlan], convert: Callable,
                 desc: str, tag: Optional[Callable] = None,
                 exprs_of: Optional[Callable] = None,
                 incompat: Optional[str] = None):
        self.convert = convert  # (meta, device_children) -> TpuExec
        self.tag = tag
        self.incompat = incompat
        self.exprs_of = exprs_of or (lambda plan: [])
        self.conf_entry = register_op_enable_key(
            "exec", cls.__name__, desc, default=incompat is None)


class RuleRegistry:
    """Expression and exec rules of the device engine."""

    def __init__(self):
        self.expr_rules: Dict[type, ExprRule] = {}
        self.exec_rules: Dict[type, ExecRule] = {}

    def register_expr(self, cls, tag: Optional[Callable] = None,
                      incompat: Optional[str] = None):
        self.expr_rules[cls] = ExprRule(cls, tag, incompat)

    def register_exec(self, cls, convert, **kw):
        self.exec_rules[cls] = ExecRule(cls, convert, **kw)

    def find(self, rules: Dict[type, object], obj):
        for klass in type(obj).__mro__:
            if klass in rules:
                return rules[klass]
        return None


_DEFAULT: Optional[RuleRegistry] = None


def default_registry() -> RuleRegistry:
    """The engine's rules, built once on first use (the rules are
    immutable after construction)."""
    global _DEFAULT
    if _DEFAULT is None:
        reg = RuleRegistry()
        _register_expression_rules(reg)
        _register_exec_rules(reg)
        _DEFAULT = reg
    return _DEFAULT


# ==========================================================================
# Metas
# ==========================================================================
class BaseMeta:
    def __init__(self, conf: TpuConf):
        self.conf = conf
        self.cannot_replace_reasons: List[str] = []

    def will_not_work_on_tpu(self, reason: str) -> None:
        if reason not in self.cannot_replace_reasons:
            self.cannot_replace_reasons.append(reason)

    @property
    def can_this_be_replaced(self) -> bool:
        return not self.cannot_replace_reasons


class ExprMeta(BaseMeta):
    def __init__(self, expr: Expression, conf: TpuConf,
                 registry: RuleRegistry):
        super().__init__(conf)
        self.expr = expr
        self.registry = registry
        self.children = [ExprMeta(c, conf, registry) for c in expr.children]

    def tag_for_tpu(self) -> None:
        e = self.expr
        rule = self.registry.find(self.registry.expr_rules, e)
        name = type(e).__name__
        if rule is None:
            self.will_not_work_on_tpu(f"no device rule for expression {name}")
        else:
            if not rule.conf_entry.get(dict(self.conf.items())):
                self.will_not_work_on_tpu(
                    f"expression {name} disabled by {rule.conf_entry.key}")
            if rule.incompat and not self.conf.get(INCOMPATIBLE_OPS):
                self.will_not_work_on_tpu(
                    f"{name} is incompatible ({rule.incompat}); enable "
                    f"{INCOMPATIBLE_OPS.key} to allow")
            if rule.tag is not None:
                rule.tag(self)
        if not e.tpu_supported:
            reason = getattr(e, "unsupported_reason", None)
            self.will_not_work_on_tpu(
                reason() if reason is not None else
                f"expression {name} has no device implementation "
                "for these inputs")
        for c in self.children:
            c.tag_for_tpu()

    @property
    def can_expr_tree_be_replaced(self) -> bool:
        return self.can_this_be_replaced and all(
            c.can_expr_tree_be_replaced for c in self.children)

    def all_reasons(self) -> List[str]:
        out = list(self.cannot_replace_reasons)
        for c in self.children:
            out.extend(c.all_reasons())
        return out


class AggMeta(ExprMeta):
    """Meta for an AggregateFunction inside an aggregate exec."""

    def __init__(self, func: agg.AggregateFunction, conf: TpuConf,
                 registry: RuleRegistry):
        BaseMeta.__init__(self, conf)
        self.func = func
        self.registry = registry
        self.children = [ExprMeta(c, conf, registry) for c in func.children]

    def tag_for_tpu(self):
        name = type(self.func).__name__
        if not self.func.tpu_supported:
            self.will_not_work_on_tpu(
                f"{name} has no device implementation for these inputs")
        for c in self.children:
            c.tag_for_tpu()


class ExecMeta(BaseMeta):
    def __init__(self, plan: P.PhysicalPlan, conf: TpuConf,
                 registry: RuleRegistry):
        super().__init__(conf)
        self.plan = plan
        self.registry = registry
        self.rule = registry.find(registry.exec_rules, plan)
        self.children = [ExecMeta(c, conf, registry) for c in plan.children]
        exprs = self.rule.exprs_of(plan) if self.rule else []
        self.expr_metas: List[ExprMeta] = [
            AggMeta(e, conf, registry)
            if isinstance(e, agg.AggregateFunction)
            else ExprMeta(e, conf, registry) for e in exprs]

    def tag_for_tpu(self) -> None:
        name = type(self.plan).__name__
        if self.rule is None:
            self.will_not_work_on_tpu(f"no device rule for operator {name}")
        else:
            if not self.rule.conf_entry.get(dict(self.conf.items())):
                self.will_not_work_on_tpu(
                    f"operator disabled by {self.rule.conf_entry.key}")
            if self.rule.incompat and not self.conf.get(INCOMPATIBLE_OPS):
                self.will_not_work_on_tpu(
                    f"{name} is incompatible ({self.rule.incompat})")
        for em in self.expr_metas:
            em.tag_for_tpu()
            if not em.can_expr_tree_be_replaced:
                kind = em.func.sql() if isinstance(em, AggMeta) \
                    else em.expr.sql()
                self.will_not_work_on_tpu(
                    f"expression not supported: {kind} "
                    f"({'; '.join(em.all_reasons())})")
        if self.rule is not None and self.rule.tag is not None:
            self.rule.tag(self)
        for c in self.children:
            c.tag_for_tpu()

    def convert_if_needed(self) -> P.PhysicalPlan:
        from ..exec.base import TpuExec
        from ..exec.transitions import HostToDeviceExec

        converted = [c.convert_if_needed() for c in self.children]
        if self.can_this_be_replaced and self.rule is not None:
            device_children = [
                c if isinstance(c, TpuExec) else HostToDeviceExec(c)
                for c in converted]
            return self.rule.convert(self, device_children)
        if isinstance(self.plan, HOST_SOURCES):
            return self.plan
        raise NotImplementedError(
            f"{type(self.plan).__name__} cannot run on the device "
            f"({'; '.join(self.cannot_replace_reasons)}) and the host "
            "engine is not ported yet")

    def explain(self, all_mode: bool = True, indent: int = 0) -> str:
        name = type(self.plan).__name__
        if self.can_this_be_replaced:
            mark, note = "*", "will run on the device"
        else:
            disabled = any("disabled by" in r
                           for r in self.cannot_replace_reasons)
            mark = "@" if disabled else "!"
            note = ("could run on the device but is disabled: "
                    if disabled else "cannot run on the device because ")
            note += "; ".join(self.cannot_replace_reasons)
        lines = [f"{'  ' * indent}{mark} {name} -> {note}"] \
            if (all_mode or mark != "*") else []
        for c in self.children:
            sub = c.explain(all_mode, indent + 1)
            if sub:
                lines.append(sub)
        return "\n".join(lines)


class TpuOverrides:
    def __init__(self, conf: TpuConf,
                 registry: Optional[RuleRegistry] = None):
        self.conf = conf
        self.registry = registry or default_registry()

    def wrap(self, plan: P.PhysicalPlan) -> ExecMeta:
        return ExecMeta(plan, self.conf, self.registry)

    def apply(self, plan: P.PhysicalPlan) -> P.PhysicalPlan:
        meta = self.wrap(plan)
        meta.tag_for_tpu()
        return meta.convert_if_needed()

    def explain(self, plan: P.PhysicalPlan) -> str:
        meta = self.wrap(plan)
        meta.tag_for_tpu()
        return meta.explain(all_mode=self.conf.explain != "NOT_ON_TPU")


# ==========================================================================
# Registry population
# ==========================================================================
def tag_cast(meta: ExprMeta) -> None:
    """The reference's conf gates of the string parses, reason for reason
    (``spark_rapids_tpu/plan/overrides.py:369-395``)."""
    from .. import types as T
    from ..config import (CAST_STRING_TO_FLOAT, CAST_STRING_TO_INTEGER,
                          CAST_STRING_TO_TIMESTAMP)

    e = meta.expr
    try:
        src, dst = e.child.dtype, e.to
    except Exception:  # noqa: BLE001 - unresolved child
        return
    if not src.is_string:
        return
    if dst.is_integral and not meta.conf.get(CAST_STRING_TO_INTEGER):
        meta.will_not_work_on_tpu(
            "string->integral cast disabled by "
            f"{CAST_STRING_TO_INTEGER.key}")
    if dst.is_floating and not meta.conf.get(CAST_STRING_TO_FLOAT):
        meta.will_not_work_on_tpu(
            "string->float cast on device can differ by a few ULPs "
            f"from the host parse; enable {CAST_STRING_TO_FLOAT.key}")
    if dst.id in (T.TypeId.DATE32, T.TypeId.TIMESTAMP) \
            and not meta.conf.get(CAST_STRING_TO_TIMESTAMP):
        meta.will_not_work_on_tpu(
            "string->date/timestamp cast disabled by "
            f"{CAST_STRING_TO_TIMESTAMP.key}")


def _register_expression_rules(reg: RuleRegistry) -> None:
    from ..ops import arithmetic as ar
    from ..ops import cast as cst
    from ..ops import conditional as cond
    from ..ops import datetimeexprs as dte
    from ..ops import expression as ex
    from ..ops import nullexprs as ne
    from ..ops import predicates as pr
    from ..ops import stringexprs as st

    for cls in (ex.Literal, ex.BoundReference, ex.Alias,
                ex.UnresolvedAttribute):
        reg.register_expr(cls)
    for cls in (ar.Add, ar.Subtract, ar.Multiply, ar.Divide,
                ar.IntegralDivide, ar.Remainder, ar.Pmod, ar.UnaryMinus,
                ar.UnaryPositive, ar.Abs, ar.Least, ar.Greatest):
        reg.register_expr(cls)
    for cls in (pr.EqualTo, pr.LessThan, pr.LessThanOrEqual,
                pr.GreaterThan, pr.GreaterThanOrEqual, pr.Not, pr.And,
                pr.Or, pr.IsNull, pr.IsNotNull, pr.InSet):
        reg.register_expr(cls)
    for cls in (cond.If, cond.CaseWhen, ne.Coalesce, ne.NaNvl):
        reg.register_expr(cls)
    # the reference's string rules (plan/overrides.py:419-425) that this
    # engine ports: the case maps incompatible, the others plain
    reg.register_expr(st.Upper, incompat="ASCII-only case mapping on device")
    reg.register_expr(st.Lower, incompat="ASCII-only case mapping on device")
    for cls in (st.Length, st.Substring, st.SubstringIndex,
                st.StringReplace, st.StringTrim, st.StringTrimLeft,
                st.StringTrimRight, st.Contains, st.StartsWith, st.EndsWith,
                st.StringLocate, st.ConcatStrings, st.Like):
        reg.register_expr(cls)
    # the string directions conf-gated as in the reference
    # (plan/overrides.py:366-397)
    reg.register_expr(cst.Cast, tag=tag_cast)
    reg.register_expr(cst.NormalizeNaNAndZero)
    reg.register_expr(cst.KnownFloatingPointNormalized)
    # the reference registers both without a tag or an incompat flag
    # (plan/overrides.py:414-426)
    reg.register_expr(dte.Year)


def _register_exec_rules(reg: RuleRegistry) -> None:
    from ..exec import (aggregate, basic, exchange, generate, joins, sort,
                        window, write)

    for mod in (basic, generate, aggregate, exchange, joins, sort, window,
                write):
        mod.register(reg.register_exec)
