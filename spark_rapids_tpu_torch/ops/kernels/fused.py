"""K12 — the fused row-local segment, as CUDA C++ generated per segment.

Counterpart of the ``jit_kernel`` composition of
``spark_rapids_tpu/exec/fused.py:93-121`` (``TpuFusedSegmentExec._compute``
and ``_apply_member``), for Project, Filter, Expand and Generate
members: Project members evaluate their expressions, Filter members do
not compact but AND their keep mask (``data & validity``) into the
segment's mask, and one compaction (K4) at segment exit gives the
unfused plan's rows, order and padded bucket.  An Expand member branches
the segment into one stream per projection list (the members after it
are generated once per stream; each stream writes an output batch of
its own, a number computed before the branch is written once and shared
by the batches), and a Generate member makes the thread of row ``r``
write the output rows ``r * k + j`` of a batch ``k`` times as long, its
keep mask repeated (``SegmentProgram``).

``SegmentProgram`` turns a chain of members into one CUDA C++ kernel:
one thread per row (grid-stride) reads the row's referenced input
columns, evaluates every member in order with values and validity in
registers, and writes the computed output columns and the keep mask.  A
column a segment passes through keeps its input tensors: a projected one
gets only a new validity (ANDed with the row mask, as a Project does), an
unprojected one is the input column itself.  Padding rows get keep =
false and invalid outputs.  The source depends on the members'
expressions and the input's types only (string widths and the row count
are launch arguments), so one fingerprint serves every batch and every
partition.  Doubles and floats appear as their bit patterns and integers
as two's-complement hex, so literals keep their exact bits; string
needles, ``Like`` segments and ``InSet`` members are ``__constant__``
byte arrays; the string functions are ``csrc/strings.cuh``'s, the same
code K8 and K13 run.  The build (``_build.build_generated``, nvcc
``-fmad=false`` for sm_90a, keyed by a hash of source, flags and
headers) happens when a plan is built, for all of its segments at once.

The code generator covers every expression the engine registers
(``plan/overrides.py``): BoundReference, Literal, Alias, Add, Subtract,
Multiply, Divide, IntegralDivide, Remainder, Pmod, UnaryMinus,
UnaryPositive, Abs, Greatest, Least, the five comparisons on numbers,
dates and strings, Not, And, Or, IsNull, IsNotNull, If, CaseWhen (its
``If`` chain), Coalesce, NaNvl, InSet, Contains,
StartsWith, EndsWith, Like, Substring, Year, Cast (every direction the device
takes), ConcatStrings, NormalizeNaNAndZero,
KnownFloatingPointNormalized, Upper, Lower, Length, StringLocate,
StringTrim (both, left, right), SubstringIndex and StringReplace, each
with its torch body's semantics
(integer arithmetic wraps, a zero divisor gives null, Kleene AND/OR, a
null condition takes If's false branch, IEEE comparisons, float to
integer as XLA converts).  A Substring
is a view of its input row: the row pointer plus its first byte, the new
length and the output width ``min(max(len, 1), width)`` computed at
launch (``strings.cuh:str_substring``, K15's row arithmetic); only its
bytes below the new length are read or copied, so the output row is zero
past it, as K15 writes it.  Year is the reference's civil-from-days
integer math in 64-bit, ``strings.cuh:civil_from_days``, which K17
formats dates with, every division flooring (``srt::fdiv``: C++ ``/``
truncates; dates before 1970 are negative day counts).  A Cast from a string trims and
parses the row in place with K16's row functions.  A Cast to a string
formats into a buffer of the thread (20, 5, 10 or 26 bytes, K17's row
functions) and is a view of it.  A ConcatStrings writes its row into a
scratch matrix the wrapper allocates, as wide as the parts' widths
together (known at launch), and is a view of that row; a concatenation
that is an output column is its scratch matrix itself.  Upper and Lower
write their row into a scratch matrix as wide as the input (K19's byte
map), a StringReplace into one ``w * max(k, 1)`` wide (K21's row loop,
``strings.cuh:str_replace``); a trim or a SubstringIndex is a view of its
input row, as a Substring is (the span of ``str_trim_ws`` or
``str_substring_index``, K20's); Length and StringLocate are K19's and
K13's row functions.

``segment_plain`` is the plain composition: the members' own torch
bodies with the compaction deferred, the structure of
``exec/fused.py:113-121``.  The wrapper takes it only for CPU tensors.

Bound on this card: bytes.  A segment reads each referenced input column
once and writes each computed column, each new validity and the keep
mask once (Q12's lineitem segment over a 2,097,152-row batch: three
dates, a 7-byte mode matrix, lengths and validities in, two validities
and the mask out, ~65 MB, ~19 us at 3.35 TB/s; ``chip_smoke.py`` counts
each segment's bytes at its shapes).  Design: one pass over the rows,
every member fused, no intermediate column written; a thread reads its
own string row (strided loads, like K13).
"""
from __future__ import annotations

import ctypes
import re
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import types as T
from ...data import strings as dstrings
from ...data.column import DeviceBatch, DeviceColumn
from .. import arithmetic as ar
from .. import cast as cst
from .. import conditional as cond
from .. import datetimeexprs as dte
from .. import nullexprs as ne
from .. import predicates as pr
from .. import stringexprs as st
from ..expression import (Alias, BoundReference, Expression, Literal,
                          unalias)
from . import _build as B
from . import castkernels

#: CUDA kernels launched by K12
FUSED_LAUNCHES = B.LaunchCounter("fused_segment")

#: blocks of a launch at most (the kernel strides over the rest)
MAX_BLOCKS = 16384

_CTYPE = {
    T.TypeId.BOOL: "bool", T.TypeId.INT8: "int8_t",
    T.TypeId.INT16: "int16_t", T.TypeId.INT32: "int32_t",
    T.TypeId.INT64: "int64_t", T.TypeId.FLOAT32: "float",
    T.TypeId.FLOAT64: "double", T.TypeId.DATE32: "int32_t",
    T.TypeId.TIMESTAMP: "int64_t", T.TypeId.NULL: "bool",
}
_UNSIGNED = {"int8_t": "uint8_t", "int16_t": "uint16_t",
             "int32_t": "uint32_t", "int64_t": "uint64_t"}
# unsigned type the wrapping arithmetic of each integer type runs in
_WRAP = {"int8_t": "unsigned", "int16_t": "unsigned",
         "int32_t": "unsigned", "int64_t": "unsigned long long"}


def ctype(dt: T.DType) -> str:
    if dt.is_string:
        raise TypeError("strings have no scalar C type")
    return _CTYPE[dt.id]


def c_literal(value, dt: T.DType) -> str:
    """A C expression of type ``ctype(dt)`` with ``value``'s exact bits
    (0 for a null)."""
    ct = ctype(dt)
    if value is None:
        value = 0
    if ct == "bool":
        return "true" if value else "false"
    if ct == "double":
        bits = struct.unpack("<Q", struct.pack("<d", float(value)))[0]
        return f"__longlong_as_double((long long)0x{bits:016x}ULL)"
    if ct == "float":
        bits = struct.unpack("<I", struct.pack("<f", float(value)))[0]
        return f"__int_as_float((int)0x{bits:08x}U)"
    v = int(np.asarray(value).astype(dt.np_dtype))
    bits = v & ((1 << (8 * dt.np_dtype.itemsize)) - 1)
    return f"(({ct})({_UNSIGNED[ct]})0x{bits:x}ULL)"


@dataclass
class _Val:
    """A value of the generated code: data (``d``) or a string row
    (``p``, width ``w``, length ``l``), and its validity ``v``; ``wspec``
    gives a string's width at launch: ("in", i), ("const", w), ("max",
    a, b), ("sub", a, length), ("sum", (a, ...)) or ("mul", a, k); ``cw`` bounds the
    bytes an output copy reads (a substring's new length; the width when
    empty); ``scratch`` names the scratch matrix a concatenation's row
    lies in."""

    dtype: T.DType
    v: str
    d: str = ""
    p: str = ""
    w: str = ""
    l: str = ""
    wspec: tuple = ()
    cw: str = ""
    scratch: Optional[int] = None

    @property
    def copy_width(self) -> str:
        return self.cw or self.w


@dataclass
class _Sym:
    """A column of the batch between two members: its value, and the
    input ordinal it passes through (None for a computed column)."""

    val: _Val
    src: Optional[int]
    projected: bool


@dataclass
class Output:
    """One output column: ``kind`` "raw" (the input column as it is),
    "valid" (the input's data, a new validity), "num" or "str"
    (computed), or "scratch" (a computed string's scratch matrix)."""

    kind: str
    dtype: T.DType
    src: Optional[int] = None
    wspec: tuple = ()
    scratch: Optional[int] = None


def _decl_type(line: str) -> str:
    """The type of a ``const <type> <name> = ...;`` line."""
    return line[len("const "):].rsplit(" = ", 1)[0].rsplit(" ", 1)[0]


def _is_filter(m) -> bool:
    return hasattr(m, "condition")


def _int32(v: int) -> int:
    """``v`` clamped into the int range (a start or a length past any
    row's width gives the same substring)."""
    return max(-(2 ** 31 - 1), min(int(v), 2 ** 31 - 1))


class _Codegen:
    def __init__(self, schema: T.Schema):
        self.schema = schema
        self.body: List[str] = []
        self.consts: Dict[bytes, str] = {}
        self.loaded: Dict[int, _Val] = {}
        self.ptr_fields: List[Tuple[str, str, tuple]] = []  # decl, name, bind
        self.int_fields: List[Tuple[str, tuple]] = []       # name, bind
        self.scratch: List[tuple] = []                     # width specs
        self.n = 0

    # ---- helpers ---------------------------------------------------------
    def tmp(self) -> str:
        self.n += 1
        return f"t{self.n}"

    def let(self, ct: str, expr: str) -> str:
        name = self.tmp()
        self.body.append(f"const {ct} {name} = {expr};")
        return name

    def const_bytes(self, b: bytes) -> str:
        name = self.consts.get(b)
        if name is None:
            name = f"K{len(self.consts)}"
            self.consts[b] = name
        return name

    def string_literal(self, value: Optional[str]) -> _Val:
        bm, ln = dstrings.encode([value])
        name = self.const_bytes(bytes(bm[0]))
        return _Val(T.STRING, "false" if value is None else "true",
                    p=name, w=str(bm.shape[1]), l=str(int(ln[0])),
                    wspec=("const", bm.shape[1]))

    def load(self, i: int) -> _Val:
        if i in self.loaded:
            return self.loaded[i]
        dt = self.schema[i].dtype
        v = self.tmp()
        self.ptr_fields.append((f"const bool* v{i}", f"v{i}",
                                ("in_valid", i)))
        if dt.is_string:
            self.ptr_fields.append((f"const uint8_t* d{i}", f"d{i}",
                                    ("in_data", i)))
            self.ptr_fields.append((f"const int* l{i}", f"l{i}",
                                    ("in_len", i)))
            self.int_fields.append((f"w{i}", ("in_width", i)))
            p = self.let("uint8_t*", f"a.d{i} + row * (long long)a.w{i}")
            ln = self.let("int", f"a.l{i}[row]")
            val = _Val(dt, v, p=p, w=f"a.w{i}", l=ln, wspec=("in", i))
        else:
            ct = ctype(dt)
            self.ptr_fields.append((f"const {ct}* d{i}", f"d{i}",
                                    ("in_data", i)))
            d = self.let(ct, f"a.d{i}[row]")
            val = _Val(dt, v, d=d)
        self.body.append(f"const bool {v} = a.v{i}[row];")
        self.loaded[i] = val
        return val

    def prune_loads(self) -> None:
        """Drop the loads of input data and lengths nothing reads (a
        passed-through column needs only its validity), and their
        arguments."""
        text = "\n".join(self.body)
        for i, val in self.loaded.items():
            for var, field, kind in ((val.d, f"d{i}", "in_data"),
                                     (val.l, f"l{i}", "in_len"),
                                     (val.p, f"d{i}", "in_data")):
                if not var or len(re.findall(rf"\b{var}\b", text)) > 1:
                    continue
                self.body = [ln for ln in self.body
                             if not ln.startswith(f"const {_decl_type(ln)} "
                                                  f"{var} =")]
                text = "\n".join(self.body)
                if not re.search(rf"\ba\.{field}\b", text):
                    self.ptr_fields = [f for f in self.ptr_fields
                                       if f[2] != (kind, i)]

    def cast(self, val: _Val, dt: T.DType) -> str:
        if val.dtype == dt:
            return val.d
        return f"(({ctype(dt)}){val.d})"

    def needle_call(self, fn: str, c: _Val, needle: bytes,
                    *extra: str) -> str:
        args = [c.p, c.w, c.l, self.const_bytes(needle), str(len(needle)),
                *extra]
        return f"srt::{fn}({', '.join(args)})"

    # ---- expressions -----------------------------------------------------
    def gen(self, e: Expression, syms: List[_Sym]) -> _Val:
        if isinstance(e, Alias):
            return self.gen(e.child, syms)
        if isinstance(e, BoundReference):
            s = syms[e.ordinal]
            if s.val is None:  # an input column, loaded at first use
                s.val = self.load(s.src)
            return s.val
        if isinstance(e, Literal):
            if e.dtype.is_string:
                return self.string_literal(e.value)
            return _Val(e.dtype, "false" if e.value is None else "true",
                        d=c_literal(e.value, e.dtype))
        if isinstance(e, ar.Divide):
            l, r = self.gen(e.left, syms), self.gen(e.right, syms)
            a = self.cast(l, T.FLOAT64)
            b = self.cast(r, T.FLOAT64)
            z = self.let("bool", f"{b} == 0.0")
            d = self.let("double", f"{a} / ({z} ? 1.0 : {b})")
            return _Val(T.FLOAT64, self.let("bool", f"{l.v} && {r.v} && "
                                            f"!{z}"), d=d)
        if isinstance(e, (ar.IntegralDivide, ar.Remainder, ar.Pmod)):
            return self.division(e, syms)
        if isinstance(e, (ar.UnaryMinus, ar.UnaryPositive, ar.Abs)):
            return self.unary(e, syms)
        if isinstance(e, (ar.Greatest, ar.Least)):
            return self.extremum(e, syms)
        if isinstance(e, cond.CaseWhen):
            return self.gen(e.chain(), syms)
        if isinstance(e, (ar.Add, ar.Subtract, ar.Multiply)):
            op = {ar.Add: "+", ar.Subtract: "-", ar.Multiply: "*"}[type(e)]
            out = e.dtype
            ct = ctype(out)
            l, r = self.gen(e.left, syms), self.gen(e.right, syms)
            a, b = self.cast(l, out), self.cast(r, out)
            if out.is_floating:
                expr = f"{a} {op} {b}"
            else:  # wraps, as torch's integer arithmetic does
                ut = _WRAP[ct]
                expr = f"({ct})(({ut}){a} {op} ({ut}){b})"
            return _Val(out, self.let("bool", f"{l.v} && {r.v}"),
                        d=self.let(ct, expr))
        if isinstance(e, pr._Comparison):
            return self.comparison(e, syms)
        if isinstance(e, pr.Not):
            c = self.gen(e.child, syms)
            return _Val(T.BOOL, c.v, d=self.let("bool", f"!{c.d}"))
        if isinstance(e, (pr.And, pr.Or)):
            l, r = self.gen(e.children[0], syms), self.gen(e.children[1],
                                                           syms)
            ld = self.let("bool", f"{l.d} && {l.v}")
            rd = self.let("bool", f"{r.d} && {r.v}")
            if isinstance(e, pr.And):
                d = self.let("bool", f"{ld} && {rd}")
                v = f"({l.v} && !{ld}) || ({r.v} && !{rd}) || " \
                    f"({l.v} && {r.v})"
            else:
                d = self.let("bool", f"{ld} || {rd}")
                v = f"{ld} || {rd} || ({l.v} && {r.v})"
            return _Val(T.BOOL, self.let("bool", v), d=d)
        if isinstance(e, pr.IsNull):
            c = self.gen(e.children[0], syms)
            return _Val(T.BOOL, "true", d=self.let("bool", f"!{c.v}"))
        if isinstance(e, pr.IsNotNull):
            c = self.gen(e.children[0], syms)
            return _Val(T.BOOL, "true", d=self.let("bool", c.v))
        if isinstance(e, cond.If):
            return self.if_(e, syms)
        if isinstance(e, ne.Coalesce):
            return self.coalesce(e, syms)
        if isinstance(e, ne.NaNvl):
            return self.nanvl(e, syms)
        if isinstance(e, pr.InSet):
            return self.inset(e, syms)
        if isinstance(e, st._NeedlePredicate):
            fn = {st.Contains: "str_contains", st.StartsWith:
                  "str_startswith", st.EndsWith: "str_endswith"}[type(e)]
            c = self.gen(e.children[0], syms)
            return _Val(T.BOOL, c.v, d=self.let(
                "bool", self.needle_call(fn, c, e.needle())))
        if isinstance(e, st.Like):
            return self.like(e, syms)
        if isinstance(e, st.Substring):
            return self.substring(e, syms)
        if isinstance(e, dte.Year):
            return self.year(e, syms)
        if isinstance(e, cst.Cast):
            return self.cast_expr(e, syms)
        if isinstance(e, st.ConcatStrings):
            return self.concat(e, syms)
        if isinstance(e, (st.Upper, st.Lower)):
            return self.case_map(e, syms)
        if isinstance(e, st.Length):
            c = self.gen(e.children[0], syms)
            return _Val(T.INT32, c.v, d=self.let(
                "int32_t", f"srt::str_length({c.p}, {c.w}, {c.l})"))
        if isinstance(e, st.StringLocate):
            c = self.gen(e.children[0], syms)
            return _Val(T.INT32, c.v, d=self.let(
                "int32_t", self.needle_call("str_locate_from", c, e.needle,
                                            str(_int32(e.pos - 1)))))
        if isinstance(e, st.StringTrim):
            return self.span(e, syms, "str_trim_ws",
                             f"{str(e.left).lower()}, "
                             f"{str(e.right).lower()}")
        if isinstance(e, st.SubstringIndex):
            if not e.tpu_supported:
                raise NotImplementedError(e.unsupported_reason())
            return self.span(e, syms, "str_substring_index",
                             f"{e.delim_bytes[0]}, {_int32(e.count)}")
        if isinstance(e, st.StringReplace):
            return self.replace(e, syms)
        if isinstance(e, cst.NormalizeNaNAndZero):
            return self.normalize(e, syms)
        if isinstance(e, cst.KnownFloatingPointNormalized):
            return self.gen(e.children[0], syms)
        raise NotImplementedError(
            f"the fused-segment code generator has no rule for "
            f"{type(e).__name__}")

    def wrap_neg(self, x: str, ct: str) -> str:
        """``-x`` wrapping, as torch negates an integer."""
        return f"(({ct})(0u - ({_WRAP[ct]}){x}))"

    def division(self, e, syms) -> _Val:
        """IntegralDivide, Remainder and Pmod as their torch bodies: a
        zero divisor taken as 1 (the row null), -1 as a negation, C's
        truncating ``/`` and ``%`` (the dividend's sign), ``fmod`` for
        floats with a NaN result as the canonical NaN."""
        out = e.dtype
        ct = ctype(out)
        l, r = self.gen(e.left, syms), self.gen(e.right, syms)
        if isinstance(e, ar.IntegralDivide):
            a = self.let(ct, self.numeric_cast(l.d, l.dtype, out))
            b = self.let(ct, self.numeric_cast(r.d, r.dtype, out))
        else:
            a, b = self.cast(l, out), self.cast(r, out)
        z = self.let("bool", f"{b} == ({ct})0")
        safe = self.let(ct, f"{z} ? ({ct})1 : {b}")
        if out.is_floating:
            fn = "fmodf" if ct == "float" else "fmod"
            m = self.let(ct, f"{fn}({a}, {safe})")
            d = self.let(ct, f"{m} != {m} ? "
                         f"{c_literal(float('nan'), out)} : {m}")
        elif isinstance(e, ar.IntegralDivide):
            d = self.let(ct, f"{safe} == ({ct})-1 ? {self.wrap_neg(a, ct)} "
                         f": ({ct})({a} / {safe})")
        else:
            d = self.let(ct, f"{safe} == ({ct})-1 ? ({ct})0 : "
                         f"({ct})({a} % {safe})")
        if isinstance(e, ar.Pmod):
            fix = self.let("bool", f"{d} != ({ct})0 && (({d} < ({ct})0) != "
                           f"({safe} < ({ct})0))")
            add = f"{d} + {safe}" if out.is_floating else \
                f"({ct})(({_WRAP[ct]}){d} + ({_WRAP[ct]}){safe})"
            d = self.let(ct, f"{fix} ? {add} : {d}")
        return _Val(out, self.let("bool", f"{l.v} && {r.v} && !{z}"), d=d)

    def unary(self, e, syms) -> _Val:
        """UnaryMinus (wrapping), UnaryPositive, Abs (``fabs`` for
        floats; the minimum of an integer type stays negative, as
        torch.abs leaves it)."""
        c = self.gen(e.child, syms)
        if isinstance(e, ar.UnaryPositive):
            return c
        ct = ctype(c.dtype)
        if ct in ("float", "double") and isinstance(e, ar.UnaryMinus):
            d = f"-{c.d}"
        elif ct in ("float", "double"):
            # the math library's fabs, as torch.abs runs it (the card's
            # abs.f32 gives a NaN as the canonical NaN)
            d = f"{'fabsf' if ct == 'float' else 'fabs'}({c.d})"
        elif isinstance(e, ar.UnaryMinus):
            d = self.wrap_neg(c.d, ct)
        else:
            d = f"{c.d} < ({ct})0 ? {self.wrap_neg(c.d, ct)} : {c.d}"
        return _Val(c.dtype, c.v, d=self.let(ct, d))

    def extremum(self, e, syms) -> _Val:
        """Greatest and Least, skipping a null input (null only when both
        are): greatest as XLA's ``maximum`` (a NaN wins, +0.0 beats
        -0.0), least as the reference's ``fmin`` (``a`` where ``b`` is
        NaN or ``a < b``, else ``b``) — ``arithmetic.py``'s
        ``greatest_values`` and ``least_values``."""
        out = e.dtype
        ct = ctype(out)
        l, r = self.gen(e.left, syms), self.gen(e.right, syms)
        a = self.let(ct, self.cast(l, out))
        b = self.let(ct, self.cast(r, out))
        if isinstance(e, ar.Least):
            both = (f"({b} != {b} || {a} < {b}) ? {a} : {b}"
                    if out.is_floating else f"{a} < {b} ? {a} : {b}")
        elif out.is_floating:
            neg = (f"__float_as_int({a}) < 0" if ct == "float" else
                   f"__double_as_longlong({a}) < 0")
            both = (f"{a} != {a} ? {a} : ({b} != {b} ? {b} : ({a} > {b} ? "
                    f"{a} : ({b} > {a} ? {b} : ({neg} ? {b} : {a}))))")
        else:
            both = f"{a} > {b} ? {a} : {b}"
        m = self.let(ct, both)
        d = self.let(ct, f"{l.v} && {r.v} ? {m} : ({l.v} ? {a} : {b})")
        return _Val(out, self.let("bool", f"{l.v} || {r.v}"), d=d)

    def comparison(self, e, syms) -> _Val:
        l, r = self.gen(e.left, syms), self.gen(e.right, syms)
        v = self.let("bool", f"{l.v} && {r.v}")
        if e.left.dtype.is_string or e.right.dtype.is_string:
            args = f"{l.p}, {l.w}, {l.l}, {r.p}, {r.w}, {r.l}"
            if e.op == "==":
                return _Val(T.BOOL, v, d=self.let(
                    "bool", f"srt::str_equals({args})"))
            c = self.let("int", f"srt::str_compare({args})")
            return _Val(T.BOOL, v, d=self.let("bool", f"{c} {e.op} 0"))
        lt, rt = e.left.dtype, e.right.dtype
        if lt.is_numeric and rt.is_numeric and lt != rt:
            p = T.promote(lt, rt)
            a, b = self.cast(l, p), self.cast(r, p)
        else:
            a, b = l.d, r.d
        return _Val(T.BOOL, v, d=self.let("bool", f"{a} {e.op} {b}"))

    def if_(self, e, syms) -> _Val:
        p = self.gen(e.children[0], syms)
        c = self.let("bool", f"{p.d} && {p.v}")
        out = e.dtype
        branches = []
        for b in e.children[1:]:
            if b.dtype.id is T.TypeId.NULL:  # an untyped null: out's null
                branches.append(self.string_literal(None) if out.is_string
                                else _Val(out, "false",
                                          d=c_literal(None, out)))
            else:
                branches.append(self.gen(b, syms))
        t, f = branches
        v = self.let("bool", f"{c} ? {t.v} : {f.v}")
        if out.is_string:
            cw = self.let("int", f"{c} ? {t.copy_width} : "
                          f"{f.copy_width}") if t.cw or f.cw else ""
            return _Val(out, v,
                        p=self.let("uint8_t*", f"{c} ? {t.p} : {f.p}"),
                        w=self.let("int", f"{c} ? {t.w} : {f.w}"),
                        l=self.let("int", f"{c} ? {t.l} : {f.l}"),
                        wspec=("max", t.wspec, f.wspec), cw=cw)
        ct = ctype(out)
        return _Val(out, v, d=self.let(
            ct, f"{c} ? {self.cast(t, out)} : {self.cast(f, out)}"))

    def null_of(self, dt: T.DType) -> _Val:
        return self.string_literal(None) if dt.is_string else \
            _Val(dt, "false", d=c_literal(None, dt))

    def coalesce(self, e, syms) -> _Val:
        """The first valid child, converted to the promoted type, folded
        from a null of that type (zeros where no child is valid, as the
        torch body leaves them); a child of type NULL is never valid."""
        out = e.dtype
        acc = self.null_of(out)
        for ch in reversed(e.children):
            if ch.dtype.id is T.TypeId.NULL:
                continue
            c = self.gen(ch, syms)
            v = self.let("bool", f"{c.v} || {acc.v}")
            if out.is_string:
                cw = self.let("int", f"{c.v} ? {c.copy_width} : "
                              f"{acc.copy_width}") if c.cw or acc.cw else ""
                acc = _Val(out, v,
                           p=self.let("uint8_t*", f"{c.v} ? {c.p} : {acc.p}"),
                           w=self.let("int", f"{c.v} ? {c.w} : {acc.w}"),
                           l=self.let("int", f"{c.v} ? {c.l} : {acc.l}"),
                           wspec=("max", c.wspec, acc.wspec), cw=cw)
            else:
                acc = _Val(out, v, d=self.let(
                    ctype(out), f"{c.v} ? {self.cast(c, out)} : {acc.d}"))
        return acc

    def nanvl(self, e, syms) -> _Val:
        """``b`` where ``a`` is a valid NaN, else ``a`` (both converted to
        the promoted type)."""
        out = e.dtype
        ct = ctype(out)
        a, b = self.gen(e.children[0], syms), self.gen(e.children[1], syms)
        ad = self.let(ct, self.cast(a, out))
        bd = self.let(ct, self.cast(b, out))
        use_b = self.let("bool", f"{a.v} && ({ad} != {ad})")
        return _Val(out, self.let("bool", f"{use_b} ? {b.v} : {a.v}"),
                    d=self.let(ct, f"{use_b} ? {bd} : {ad}"))

    def inset(self, e, syms) -> _Val:
        c = self.gen(e.children[0], syms)
        terms = []
        if c.dtype.is_string:
            for value in e.values:
                m = self.string_literal(value)
                terms.append(f"srt::str_equals({c.p}, {c.w}, {c.l}, "
                             f"{m.p}, {m.w}, {m.l})")
        else:
            for x in e.member_array().tolist():
                terms.append(f"({c.d} == {c_literal(x, c.dtype)})")
        d = self.let("bool", " || ".join(terms) or "false")
        v = self.let("bool", f"{c.v} && {d}") if e.has_null_value else c.v
        return _Val(T.BOOL, v, d=d)

    def substring(self, e, syms) -> _Val:
        """A view of the input row: the pointer plus the first byte, the
        new length, and the output width (K15's ``out_w``) at launch."""
        c = self.gen(e.children[0], syms)
        ln = str(_int32(e.length)) if e.length is not None else c.w
        ow = self.let("int", f"srt::substring_width({ln}, {c.w})")
        s = self.tmp()
        self.body.append(f"int {s};")
        nl = self.let("int", f"srt::str_substring({c.l}, "
                      f"{_int32(e.start)}, {ln}, &{s})")
        return _Val(T.STRING, c.v, p=self.let("uint8_t*", f"{c.p} + {s}"),
                    w=ow, l=nl, wspec=("sub", c.wspec, e.length), cw=nl)

    def year(self, e, syms) -> _Val:
        """The reference's ``_civil_from_days``: ``strings.cuh``'s, every
        division flooring (``srt::fdiv``)."""
        c = self.gen(e.child, syms)
        days = f"(long long){c.d}"
        if e.child.dtype.id is T.TypeId.TIMESTAMP:
            days = f"srt::fdiv({days}, {dte.MICROS_PER_DAY}LL)"
        y, m, d = self.tmp(), self.tmp(), self.tmp()
        self.body.append(f"long long {y}; int {m}, {d}; "
                         f"srt::civil_from_days({days}, &{y}, &{m}, &{d});")
        return _Val(T.INT32, c.v, d=self.let("int32_t", f"(int32_t){y}"))

    # ---- casts -------------------------------------------------------
    def cast_expr(self, e, syms) -> _Val:
        c = self.gen(e.child, syms)
        src, dst = e.child.dtype, e.to
        if src == dst:
            return c
        if src.id is T.TypeId.NULL:
            return self.string_literal(None) if dst.is_string else \
                _Val(dst, "false", d=c_literal(None, dst))
        if src.is_string:
            return self.parse(c, dst)
        if dst.is_string:
            return self.format(c, src)
        return _Val(dst, c.v, d=self.let(ctype(dst),
                                         self.numeric_cast(c.d, src, dst)))

    def parse(self, c: _Val, dst: T.DType) -> _Val:
        """K16's row functions on the row trimmed in place."""
        start = self.tmp()
        self.body.append(f"int {start};")
        ln = self.let("int", f"srt::str_trim({c.p}, {c.w}, {c.l}, &{start})")
        tok = self.let("uint8_t*", f"{c.p} + {start}")
        did = dst.id
        kind, ct = {T.TypeId.BOOL: ("bool", "bool"),
                    T.TypeId.DATE32: ("date", "int"),
                    T.TypeId.TIMESTAMP: ("timestamp", "long long")}.get(
            did, ("float", "double") if dst.is_floating
            else ("int", "long long"))
        out = self.tmp()
        self.body.append(f"{ct} {out};")
        ok = self.let("bool", f"srt::parse_{kind}({tok}, {ln}, &{out})")
        if dst.is_integral and did is not T.TypeId.INT64:
            lo, hi = cst._INT_RANGE[did]
            ok = self.let("bool", f"{ok} && {out} >= {lo}LL && "
                          f"{out} <= {hi}LL")
        d = self.let(ctype(dst), f"({ctype(dst)}){out}")
        return _Val(dst, self.let("bool", f"{c.v} && {ok}"), d=d)

    def format(self, c: _Val, src: T.DType) -> _Val:
        """K17's row functions into a buffer of the thread."""
        sid = src.id
        kind, arg = {T.TypeId.BOOL: ("bool", "bool"),
                     T.TypeId.DATE32: ("date", "int"),
                     T.TypeId.TIMESTAMP: ("timestamp", "long long")}.get(
            sid, ("int", "long long"))
        if kind == "int" and not src.is_integral:
            raise NotImplementedError(
                f"CAST({src.sql_name} AS string) has no device "
                "implementation")
        width = castkernels.FORMAT_WIDTHS[kind]
        buf = self.tmp()
        self.body.append(f"uint8_t {buf}[{width}];")
        ln = self.let("int", f"srt::format_{kind}(({arg}){c.d}, {c.v}, "
                      f"{buf})")
        return _Val(T.STRING, c.v, p=buf, w=str(width), l=ln,
                    wspec=("const", width))

    def f2i(self, expr: str, dst: T.DType) -> str:
        """A double to an integer type as XLA converts (toward zero, NaN
        to 0, saturating)."""
        lo, hi = cst._INT_RANGE[dst.id]
        ct = ctype(dst)
        return (f"srt::f2i_sat<{ct}>({expr}, "
                f"{c_literal(float(lo), T.FLOAT64)}, "
                f"{c_literal(float(hi + 1), T.FLOAT64)}, "
                f"{c_literal(lo, dst)}, {c_literal(hi, dst)})")

    def numeric_cast(self, x: str, src: T.DType, dst: T.DType) -> str:
        """The non-string directions (``ops/cast.py:numeric_cast``)."""
        sid, did = src.id, dst.id
        ct = ctype(dst)
        day, sec = cst.MICROS_PER_DAY, cst.MICROS_PER_SEC
        if sid is T.TypeId.BOOL:
            return f"(({ct}){x})"
        if did is T.TypeId.BOOL:
            return f"({x} != 0)"
        if sid is T.TypeId.DATE32:
            if did is T.TypeId.TIMESTAMP:
                return f"srt::wrap_mul((long long){x}, {day}LL)"
            return f"(({ct}){x})"
        if sid is T.TypeId.TIMESTAMP:
            if did is T.TypeId.DATE32:
                return f"((int32_t)srt::fdiv((long long){x}, {day}LL))"
            if dst.is_floating:
                return f"(({ct})((double){x} / {float(sec)!r}))"
            return f"(({ct})srt::fdiv((long long){x}, {sec}LL))"
        if did is T.TypeId.TIMESTAMP:
            if src.is_floating:
                return self.f2i(f"((double){x} * {float(sec)!r})", T.INT64)
            return f"srt::wrap_mul((long long){x}, {sec}LL)"
        if did is T.TypeId.DATE32:
            if src.is_floating:
                return self.f2i(f"((double){x})", T.INT32)
            return f"((int32_t){x})"
        if src.is_floating and dst.is_integral:
            # NaN -> 0, clipped in the source's type, then converted
            lo_f, hi_f = cst._float_int_bounds(dst)
            sct = ctype(src)
            lo_c, hi_c = c_literal(lo_f, src), c_literal(hi_f, src)
            y = self.let(sct, f"{x} != {x} ? ({sct})0 : {x}")
            z = self.let(sct, f"{y} < {lo_c} ? {lo_c} : ({y} > {hi_c} ? "
                         f"{hi_c} : {y})")
            return self.f2i(f"((double){z})", dst)
        return f"(({ct}){x})"

    def normalize(self, e, syms) -> _Val:
        """-0.0 -> 0.0 and every NaN -> the canonical NaN."""
        c = self.gen(e.child, syms)
        if not c.dtype.is_floating:
            return c
        ct = ctype(c.dtype)
        nan = c_literal(float("nan"), c.dtype)
        zero = c_literal(0.0, c.dtype)
        t = self.let(ct, f"{c.d} == {zero} ? {zero} : {c.d}")
        return _Val(c.dtype, c.v, d=self.let(ct, f"{t} != {t} ? {nan} : {t}"))

    def concat(self, e, syms) -> _Val:
        """The parts at running offsets in a row of a scratch matrix
        (the parts' widths together wide), zeros after: the reference's
        concat, a part byte past its width repeating its last column."""
        parts = [self.gen(ch, syms) for ch in e.children]
        k, dst = self.scratch_row(("sum", tuple(p.wspec for p in parts)))
        pos = self.tmp()
        self.body.append(f"int {pos} = 0;")
        for p in parts:
            self.body.append(
                f"for (int q = 0; q < {p.l}; ++q) {{ const int o = {pos} + q; "
                f"if (o < a.sw{k}) {dst}[o] = {p.p}[q < {p.w} ? q : "
                f"{p.w} - 1]; }}")
            self.body.append(f"{pos} += {p.l};")
        self.body.append(f"for (int q = {pos} > 0 ? {pos} : 0; q < a.sw{k}; "
                         f"++q) {dst}[q] = 0;")
        v = " && ".join(p.v for p in parts) or "true"
        return _Val(T.STRING, self.let("bool", v), p=dst, w=f"a.sw{k}",
                    l=pos, wspec=self.scratch[k], scratch=k)

    def scratch_row(self, wspec: tuple) -> Tuple[int, str]:
        """A row of a new scratch matrix of width ``wspec`` (allocated at
        launch): its index and the pointer to this thread's row."""
        k = len(self.scratch)
        self.scratch.append(wspec)
        self.ptr_fields.append((f"uint8_t* s{k}", f"s{k}", ("scratch", k)))
        self.int_fields.append((f"sw{k}", ("scratch_width", k)))
        dst = self.tmp()
        self.body.append(f"uint8_t* const {dst} = a.s{k} + row * "
                         f"(long long)a.sw{k};")
        return k, dst

    def case_map(self, e, syms) -> _Val:
        """K19's case map of the row below its length, zeros after, into a
        scratch row as wide as the input."""
        c = self.gen(e.children[0], syms)
        mode = "srt::CASE_UPPER" if isinstance(e, st.Upper) \
            else "srt::CASE_LOWER"
        k, dst = self.scratch_row(c.wspec)
        self.body.append(
            f"for (int q = 0; q < a.sw{k}; ++q) {dst}[q] = q < {c.l} && "
            f"q < {c.w} ? srt::case_map({c.p}[q], {mode}) : (uint8_t)0;")
        return _Val(T.STRING, c.v, p=dst, w=f"a.sw{k}", l=c.l,
                    wspec=c.wspec, scratch=k)

    def span(self, e, syms, fn: str, args: str) -> _Val:
        """A trim or a substring_index: a view of its input row (the
        pointer plus the span's first byte, the span's length), as wide
        as the input, K20's row arithmetic."""
        c = self.gen(e.children[0], syms)
        s = self.tmp()
        self.body.append(f"int {s};")
        nl = self.let("int", f"srt::{fn}({c.p}, {c.w}, {c.l}, {args}, "
                      f"&{s})")
        return _Val(T.STRING, c.v, p=self.let("uint8_t*", f"{c.p} + {s}"),
                    w=c.w, l=nl, wspec=c.wspec, cw=nl)

    def replace(self, e, syms) -> _Val:
        """K21's row loop into a scratch row ``w * max(k, 1)`` wide."""
        if not e.tpu_supported:
            raise NotImplementedError(e.unsupported_reason())
        c = self.gen(e.children[0], syms)
        rep = e.replace_bytes
        k, dst = self.scratch_row(("mul", c.wspec, max(len(rep), 1)))
        nl = self.let("int", f"srt::str_replace({c.p}, {c.w}, {c.l}, "
                      f"{e.search_bytes[0]}, {self.const_bytes(rep)}, "
                      f"{len(rep)}, {dst}, a.sw{k})")
        return _Val(T.STRING, c.v, p=dst, w=f"a.sw{k}", l=nl,
                    wspec=self.scratch[k], scratch=k)

    def like(self, e, syms) -> _Val:
        segs = e.segments
        if segs is None:
            raise NotImplementedError(e.unsupported_reason())
        c = self.gen(e.children[0], syms)
        if len(segs) == 1:
            d = self.let("bool", self.needle_call("str_startswith", c,
                                                  segs[0])
                         + f" && {c.l} == {len(segs[0])}")
            return _Val(T.BOOL, c.v, d=d)
        first, last, mids = segs[0], segs[-1], segs[1:-1]
        ok = self.tmp()
        cur = self.tmp()
        self.body.append(f"bool {ok} = " + (self.needle_call(
            "str_startswith", c, first) if first else "true") + ";")
        self.body.append(f"int {cur} = {len(first)};")
        for seg in mids:
            if not seg:
                continue
            pos = self.let("int", self.needle_call("str_locate_from", c,
                                                   seg, cur))
            self.body.append(f"{ok} = {ok} && {pos} > 0;")
            self.body.append(f"{cur} = {pos} > 0 ? {pos} - 1 + {len(seg)} "
                             f": {cur};")
        if last:
            self.body.append(
                f"{ok} = {ok} && "
                + self.needle_call("str_endswith", c, last)
                + f" && {c.l} - {len(last)} >= {cur};")
        else:
            self.body.append(f"{ok} = {ok} && {c.l} >= {cur};")
        return _Val(T.BOOL, c.v, d=self.let("bool", ok))


@dataclass
class _Stream:
    """One stream of rows through the segment: the columns between two
    members, the keep mask so far (a C variable, or None before any
    filter), the output batch it writes and the output row it writes
    (a C expression of ``row``)."""

    syms: List[_Sym]
    keep: Optional[str]
    batch: int
    row: str


def _kind(m) -> str:
    if _is_filter(m):
        return "filter"
    if hasattr(m, "projections"):
        return "expand"
    if hasattr(m, "elements"):
        return "generate"
    return "project"


class SegmentProgram:
    """The generated kernel of one segment and how to bind a batch to
    it.  ``members`` are the segment's Project, Filter, Expand and
    Generate execs in execution order, over an input of
    ``input_schema``.

    An Expand member branches every stream into one stream per
    projection list, each writing an output batch of its own; a Generate
    member turns each stream into ``k`` streams that write the rows
    ``row * k + j`` of one output batch ``k`` times as long.  The members
    after either are generated once per stream, and one launch writes
    every stream's outputs: ``outputs[b]`` and ``mults[b]`` (its rows are
    ``mults[b]`` times the input's) describe output batch ``b``."""

    def __init__(self, input_schema: T.Schema, members: List):
        self.input_schema = input_schema
        self.members = list(members)
        self.schema = members[-1].schema
        self.has_filter = any(_is_filter(m) for m in members)
        g = _Codegen(input_schema)
        # only the input columns a member references are loaded
        streams = [_Stream([_Sym(None, i, False)
                            for i in range(len(input_schema))], None, 0,
                           "row")]
        self.mults = [1]
        for m in self.members:
            kind = _kind(m)
            if kind == "filter":
                for st in streams:
                    c = g.gen(m.condition, st.syms)
                    st.keep = g.let("bool", f"{st.keep or 'rm'} && "
                                    f"({c.d} && {c.v})")
            elif kind == "project":
                for st in streams:
                    st.syms = [self._projected(g, e, e.dtype, st.syms)
                               for e in m.exprs]
            elif kind == "expand":
                streams = self._expand(g, m, streams)
            else:
                streams = self._generate(g, m, streams)
        self.outputs: List[List[Output]] = []
        shared: Dict[str, Tuple[int, int]] = {}
        for b in range(len(self.mults)):
            mine = [st for st in streams if st.batch == b]
            self.outputs.append(self._outputs(g, b, mine, shared))
            if self.has_filter:
                g.ptr_fields.append((f"bool* keep{b}", f"keep{b}",
                                     ("keep", b)))
                for st in mine:
                    g.body.append(f"a.keep{b}[{st.row}] = {st.keep};")
        g.prune_loads()
        self.scratch = list(g.scratch)
        self._ptr_binds = [("num_rows",)] + [b for _d, _n, b in
                                             g.ptr_fields]
        self._int_binds = [("n",)] + [b for _n, b in g.int_fields]
        self.source = _render(g, self.describe())
        self.key = B.generated_key(self.source)

    # ---- members -----------------------------------------------------
    @staticmethod
    def _projected(g: _Codegen, e: Expression, dtype: T.DType,
                   syms: List[_Sym]) -> _Sym:
        """``e`` over ``syms`` as a column of type ``dtype`` (a numeric
        value widened to it), valid on the logical rows only; a column
        reference keeps its input ordinal."""
        val = g.gen(e, syms)
        cast = val.dtype != dtype and not val.dtype.is_string \
            and not dtype.is_string
        if cast:
            val = _Val(dtype, val.v, d=g.let(ctype(dtype),
                                             g.cast(val, dtype)))
        pv = _Val(**{**val.__dict__, "v": g.let("bool", f"{val.v} && rm")})
        inner = unalias(e)
        src = syms[inner.ordinal].src \
            if isinstance(inner, BoundReference) and not cast else None
        return _Sym(pv, src, True)

    def _expand(self, g: _Codegen, m, streams: List[_Stream]
                ) -> List[_Stream]:
        """One stream per (stream, projection list), each writing the
        batch of its (batch, projection), batches numbered in that
        order."""
        ids = {}
        mults = []
        for b, mult in enumerate(self.mults):
            for i in range(len(m.projections)):
                ids[(b, i)] = len(mults)
                mults.append(mult)
        self.mults = mults
        out = []
        for st in streams:
            for i, ps in enumerate(m.projections):
                syms = [self._projected(g, e, f.dtype, st.syms)
                        for f, e in zip(m.schema, ps)]
                out.append(_Stream(syms, st.keep, ids[(st.batch, i)],
                                   st.row))
        return out

    def _generate(self, g: _Codegen, m, streams: List[_Stream]
                  ) -> List[_Stream]:
        """``k`` streams per stream: the pass-through columns (valid on
        the logical rows), ``pos`` = j and element j, at ``row * k + j``
        of a batch ``k`` times as long."""
        k = len(m.elements)
        out_dt = m.schema.fields[-1].dtype
        self.mults = [mult * k for mult in self.mults]
        out = []
        for st in streams:
            passed = []
            for s in st.syms:
                val = s.val if s.val is not None else g.load(s.src)
                passed.append(_Sym(_Val(**{**val.__dict__, "v": g.let(
                    "bool", f"{val.v} && rm")}), s.src, True))
            elems = []
            for e in m.elements:
                if e.dtype.id is T.TypeId.NULL:
                    val = g.string_literal(None) if out_dt.is_string else \
                        _Val(out_dt, "false", d=c_literal(None, out_dt))
                else:
                    val = g.gen(e, st.syms)
                    if not out_dt.is_string and val.dtype != out_dt:
                        val = _Val(out_dt, val.v, d=g.let(
                            ctype(out_dt), g.cast(val, out_dt)))
                elems.append(_Val(**{**val.__dict__, "v": g.let(
                    "bool", f"{val.v} && rm")}))
            for j, val in enumerate(elems):
                syms = list(passed)
                if m.position:
                    syms.append(_Sym(_Val(T.INT32, "rm",
                                          d=f"((int32_t){j})"), None, True))
                syms.append(_Sym(val, None, True))
                out.append(_Stream(syms, st.keep, st.batch,
                                   f"({st.row}) * {k} + {j}"))
        return out

    # ---- outputs -----------------------------------------------------
    def _outputs(self, g: _Codegen, b: int, streams: List[_Stream],
                 shared: Dict[str, Tuple[int, int]]) -> List[Output]:
        """The output columns of batch ``b`` and the code writing them.
        A batch as long as the input (one stream) passes columns through
        and keeps scratch matrices as its columns; a longer one writes
        every column of every stream at the stream's row.  A number
        another batch already writes is shared with it."""
        outs: List[Output] = []
        one = len(streams) == 1
        for j in range(len(self.schema)):
            s0 = streams[0].syms[j]
            dt = self.schema[j].dtype if s0.val is None else s0.val.dtype
            if one and s0.src is not None and not s0.projected:
                outs.append(Output("raw", dt, s0.src))
                continue
            g.ptr_fields.append((f"bool* ov{b}_{j}", f"ov{b}_{j}",
                                 ("out_valid", b, j)))
            for st in streams:
                g.body.append(f"a.ov{b}_{j}[{st.row}] = {st.syms[j].val.v};")
            val = s0.val
            if one and s0.src is not None:
                outs.append(Output("valid", dt, s0.src))
            elif one and val.scratch is not None:  # the scratch itself
                g.ptr_fields.append((f"int* ol{b}_{j}", f"ol{b}_{j}",
                                     ("out_len", b, j)))
                g.body.append(f"a.ol{b}_{j}[row] = {val.l};")
                outs.append(Output("scratch", dt, None, val.wspec,
                                   val.scratch))
            elif dt.is_string:
                wspec = val.wspec
                for st in streams[1:]:
                    wspec = ("max", wspec, st.syms[j].val.wspec)
                g.ptr_fields.append((f"uint8_t* o{b}_{j}", f"o{b}_{j}",
                                     ("out_data", b, j)))
                g.ptr_fields.append((f"int* ol{b}_{j}", f"ol{b}_{j}",
                                     ("out_len", b, j)))
                g.int_fields.append((f"ow{b}_{j}", ("out_width", b, j)))
                for st in streams:
                    v = st.syms[j].val
                    g.body.append(
                        f"{{ uint8_t* dst = a.o{b}_{j} + ({st.row}) * "
                        f"(long long)a.ow{b}_{j}; for (int q = 0; q < "
                        f"a.ow{b}_{j}; ++q) dst[q] = q < {v.copy_width} ? "
                        f"{v.p}[q] : 0; }}")
                    g.body.append(f"a.ol{b}_{j}[{st.row}] = {v.l};")
                outs.append(Output("str", dt, None, wspec))
            elif one and val.d in shared:
                outs.append(Output("shared", dt, shared[val.d]))
            else:
                g.ptr_fields.append((f"{ctype(dt)}* o{b}_{j}", f"o{b}_{j}",
                                     ("out_data", b, j)))
                for st in streams:
                    g.body.append(f"a.o{b}_{j}[{st.row}] = "
                                  f"{st.syms[j].val.d};")
                if one:
                    shared[val.d] = (b, j)
                outs.append(Output("num", dt))
        return outs

    def describe(self) -> str:
        return " -> ".join(m.describe() for m in self.members)

    # ---- launch ----------------------------------------------------------
    def _width(self, spec, batch: DeviceBatch) -> int:
        if spec[0] == "in":
            return int(batch.columns[spec[1]].data.shape[1])
        if spec[0] == "const":
            return spec[1]
        if spec[0] == "sub":
            w = self._width(spec[1], batch)
            return min(max(w if spec[2] is None else spec[2], 1), w)
        if spec[0] == "sum":
            return sum(self._width(p, batch) for p in spec[1])
        if spec[0] == "mul":
            return self._width(spec[1], batch) * spec[2]
        return max(self._width(spec[1], batch), self._width(spec[2], batch))

    def bytes_moved(self, batch: DeviceBatch) -> int:
        """The bytes the segment must move over ``batch``: each input
        array it reads and each array it writes, once (its bound)."""
        n = batch.padded_rows
        total = 4  # the row count
        for b in self._ptr_binds[1:]:
            kind = b[0]
            if kind.startswith("in_"):
                c = batch.columns[b[1]]
                t = {"in_valid": c.validity, "in_data": c.data,
                     "in_len": c.lengths}[kind]
                total += t.numel() * t.element_size()
                continue
            rows = n * self.mults[b[1]] if kind != "scratch" else n
            if kind == "out_data":
                o = self.outputs[b[1]][b[2]]
                total += rows * (
                    self._width(o.wspec, batch) if o.kind == "str"
                    else torch.empty(0, dtype=o.dtype.torch_dtype
                                     ).element_size())
            elif kind == "out_len":
                total += 4 * rows
            elif kind == "scratch":
                total += n * self._width(self.scratch[b[1]], batch)
            else:  # a validity or a keep mask
                total += rows
        return total

    def launch(self, batch: DeviceBatch, kernels: B.Kernels
               ) -> List[Tuple[DeviceBatch, Optional[torch.Tensor]]]:
        n, dev = batch.padded_rows, batch.device
        ins = batch.columns
        scratch = [torch.empty((n, self._width(spec, batch)),
                               dtype=torch.uint8, device=dev)
                   for spec in self.scratch]
        batches: List[List[DeviceColumn]] = []
        for b, outs in enumerate(self.outputs):
            rows = n * self.mults[b]
            # one allocation for the batch's new validities
            valids = iter(torch.empty(
                (sum(o.kind != "raw" for o in outs), rows),
                dtype=torch.bool, device=dev))
            cols: List[DeviceColumn] = []
            for o in outs:
                if o.kind == "raw":
                    cols.append(ins[o.src])
                    continue
                validity = next(valids)
                if o.kind == "scratch":
                    cols.append(DeviceColumn(
                        o.dtype, scratch[o.scratch], validity,
                        torch.empty(rows, dtype=torch.int32, device=dev)))
                elif o.kind == "valid":
                    src = ins[o.src]
                    cols.append(DeviceColumn(o.dtype, src.data, validity,
                                             src.lengths))
                elif o.kind == "shared":
                    ob, oj = o.src
                    cols.append(DeviceColumn(o.dtype, batches[ob][oj].data,
                                             validity))
                elif o.kind == "str":
                    w = self._width(o.wspec, batch)
                    cols.append(DeviceColumn(
                        o.dtype, torch.empty((rows, w), dtype=torch.uint8,
                                             device=dev),
                        validity, torch.empty(rows, dtype=torch.int32,
                                              device=dev)))
                else:
                    cols.append(DeviceColumn(o.dtype, torch.empty(
                        rows, dtype=o.dtype.torch_dtype, device=dev),
                        validity))
            batches.append(cols)
        keeps = [torch.empty(n * mult, dtype=torch.bool, device=dev)
                 if self.has_filter else None for mult in self.mults]
        num_rows = batch.num_rows.to(torch.int32).contiguous()
        keepalive = []

        def arg(t):
            t = t.contiguous()
            keepalive.append(t)
            return t.data_ptr()

        ptrs = []
        for b in self._ptr_binds:
            kind = b[0]
            if kind == "num_rows":
                ptrs.append(num_rows.data_ptr())
            elif kind == "in_valid":
                ptrs.append(arg(ins[b[1]].validity))
            elif kind == "in_data":
                t = ins[b[1]].data
                want = self.input_schema[b[1]].dtype.torch_dtype
                if t.dtype != want or t.shape[0] != n:
                    raise TypeError(f"K12 input {b[1]} is {t.dtype} "
                                    f"{tuple(t.shape)}, the segment was "
                                    f"generated for {want} of {n} rows")
                ptrs.append(arg(t))
            elif kind == "in_len":
                ptrs.append(arg(ins[b[1]].lengths.to(torch.int32)))
            elif kind == "out_valid":
                ptrs.append(batches[b[1]][b[2]].validity.data_ptr())
            elif kind == "out_data":
                ptrs.append(batches[b[1]][b[2]].data.data_ptr())
            elif kind == "out_len":
                ptrs.append(batches[b[1]][b[2]].lengths.data_ptr())
            elif kind == "scratch":
                ptrs.append(scratch[b[1]].data_ptr())
            else:  # keep
                ptrs.append(keeps[b[1]].data_ptr())
        ints = []
        for b in self._int_binds:
            if b[0] == "n":
                ints.append(n)
            elif b[0] == "in_width":
                ints.append(int(ins[b[1]].data.shape[1]))
            elif b[0] == "scratch_width":
                ints.append(int(scratch[b[1]].shape[1]))
            else:  # out_width
                ints.append(int(batches[b[1]][b[2]].data.shape[1]))
        lib = kernels.generated(self.key, self.source)
        B.launch(FUSED_LAUNCHES, lib, "k12_segment",
                 (ctypes.c_void_p * len(ptrs))(*ptrs),
                 (ctypes.c_longlong * len(ints))(*ints),
                 kernels.stream(batch.num_rows), launched=1)
        return [(DeviceBatch(self.schema, cols,
                             batch.num_rows if mult == 1
                             else batch.num_rows * mult), keep)
                for cols, mult, keep in zip(batches, self.mults, keeps)]


def _render(g: _Codegen, what: str) -> str:
    consts = [f"__constant__ uint8_t {name}[{max(1, len(b))}] = "
              f"{{{', '.join(str(x) for x in b) or '0'}}};"
              for b, name in g.consts.items()]
    fields = [decl for decl, _n, _b in g.ptr_fields]
    ptr_sets = [f"  a.num_rows = (const int*)ptrs[0];"] + [
        f"  a.{name} = ({decl.rsplit(' ', 1)[0]})ptrs[{i + 1}];"
        for i, (decl, name, _b) in enumerate(g.ptr_fields)]
    int_sets = ["  a.n = ints[0];"] + [
        f"  a.{name} = (int)ints[{i + 1}];"
        for i, (name, _b) in enumerate(g.int_fields)]
    body = "\n".join(f"    {line}" for line in g.body)
    comment = what.replace("\\", "/")
    return f"""// K12 — a fused row-local segment, generated by
// spark_rapids_tpu_torch/ops/kernels/fused.py:
//   {comment}
#include "strings.cuh"

namespace {{

{chr(10).join(consts)}

struct K12Args {{
  const int* num_rows;
{chr(10).join(f"  {f};" for f in fields)}
  long long n;
{chr(10).join(f"  int {name};" for name, _b in g.int_fields)}
}};

__global__ void __launch_bounds__(srt::BLOCK) k12_kernel(const K12Args a) {{
  const long long nrows = (long long)*a.num_rows;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < a.n; row += stride) {{
    const bool rm = row < nrows;
{body}
  }}
}}

}}  // namespace

SRT_API int k12_segment(void* const* ptrs, const long long* ints,
                        void* stream) {{
  K12Args a;
{chr(10).join(ptr_sets)}
{chr(10).join(int_sets)}
  long long blocks = (a.n + srt::BLOCK - 1) / srt::BLOCK;
  if (blocks < 1) blocks = 1;
  if (blocks > {MAX_BLOCKS}) blocks = {MAX_BLOCKS};
  const unsigned grid = (unsigned)blocks;
  k12_kernel<<<grid, srt::BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}}
"""


# ---------------------------------------------------------------------------
# wrapper and plain composition
# ---------------------------------------------------------------------------
def segment_plain(program: SegmentProgram, batch: DeviceBatch
                  ) -> List[Tuple[DeviceBatch, Optional[torch.Tensor]]]:
    """The members' torch bodies in order over (batch, keep) streams
    (``exec/fused.py:93-121``): each filter's keep mask ANDed into its
    stream's instead of compacting, an expand branching every stream
    into one per projection list, a generate repeating the keep mask
    ``k`` times (both on their plain versions, not K23/K22, on any
    device); each mask is ANDed with its batch's row mask at exit."""
    streams: List[Tuple[DeviceBatch, Optional[torch.Tensor]]] = \
        [(batch, None)]
    for m in program.members:
        kind = _kind(m)
        out = []
        for b, keep in streams:
            if kind == "filter":
                k = m._keep(b)
                out.append((b, k if keep is None else keep & k))
            elif kind == "expand":
                out.extend((nb, keep) for nb in m._compute(b, plain=True))
            elif kind == "generate":
                k = len(m.elements)
                out.append((m._compute(b, plain=True), None if keep is None
                            else torch.repeat_interleave(keep, k)))
            else:
                out.append((m._compute(b), keep))
        streams = out
    return [(DeviceBatch(program.schema, b.columns, b.num_rows),
             None if keep is None else keep & b.row_mask())
            for b, keep in streams]


def run_segment(program: SegmentProgram, batch: DeviceBatch,
                kernels: Optional[B.Kernels] = None
                ) -> List[Tuple[DeviceBatch, Optional[torch.Tensor]]]:
    """K12: each output batch's columns before compaction and its keep
    mask (None when no member filters), one pair per output batch."""
    kernels = B.kernels_for(batch.num_rows, kernels)
    if kernels is None:
        return segment_plain(program, batch)
    return program.launch(batch, kernels)
