"""String predicates with a literal needle or pattern, and the string
transforms.

Counterpart of ``spark_rapids_tpu/ops/stringexprs.py:_NeedlePredicate``,
``Contains``, ``StartsWith``, ``EndsWith`` (272-330) and ``Like``
(396-500), on K13 (``ops/kernels/stringkernels.py``), ``Substring``
(156-197) on K15 and ``ConcatStrings`` (362-393) on K18.  ``Like`` takes
patterns built from literal text and ``%`` and lowers them as the
reference does: an exact pattern is startswith plus a length test;
otherwise the first segment is a prefix, each middle segment the greedy
leftmost match after the previous one (``locate_from``), and the last
segment a suffix that must not overlap them.  A pattern that uses ``_``
is tagged off the device with its reason: the reference evaluates it
with the host regex, and the host engine is not ported yet, so planning
such a query raises ``NotImplementedError``.  A needle longer than K13's
``MAX_NEEDLE_BYTES`` is tagged off the device likewise.  ``Substring``
works on byte positions, as the reference's device path does (exact for
ASCII; a multi-byte UTF-8 row is cut between bytes there too).
``ConcatStrings`` is null where any part is null; its bytes are the
parts' bytes whatever their validity, as in the reference.

The transforms (reference ``ops/stringexprs.py:43-154, 200-270, 332-360``):
``Upper`` and ``Lower`` map ASCII letters only (K19; their rules are
incompatible, ``plan/overrides.py``), ``Length`` counts UTF-8
characters (K19), ``StringTrim``/``StringTrimLeft``/``StringTrimRight``
drop spaces (0x20) and keep the input's width (K20), ``SubstringIndex``
(K20) and ``StringReplace`` (K21) take a one-byte delimiter or search
string on the device and tag a longer one off it (the reference runs
those on its host engine, which is not ported yet, so planning raises),
and ``StringLocate`` is K13's search from one start for every row.
Each passes its input's validity through.  ``InitCap`` and
``RegExpReplace`` are not ported: the reference runs both on its host
engine only.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .. import types as T
from ..data.column import DeviceColumn
from .expression import Expression, Literal, as_device_column
from .kernels import stringkernels as sk


class _NeedlePredicate(Expression):
    """contains/startswith/endswith with a literal needle."""

    kernel = None  # set in subclass

    def __init__(self, child, needle):
        super().__init__([child, needle if isinstance(needle, Expression)
                          else Literal(needle, T.STRING)])

    @property
    def dtype(self):
        return T.BOOL

    def needle(self) -> Optional[bytes]:
        n = self.children[1]
        if isinstance(n, Literal) and n.value is not None:
            return n.value.encode("utf-8")
        return None

    def eval_tpu(self, batch):
        needle = self.needle()
        if needle is None:
            raise NotImplementedError("non-literal needle")
        c = as_device_column(self.children[0].eval_tpu(batch),
                             batch.padded_rows, batch.device)
        data = type(self).kernel(c.data, c.lengths, needle)
        return DeviceColumn(T.BOOL, data, c.validity)

    @property
    def tpu_supported(self):
        needle = self.needle()
        return needle is not None and len(needle) <= sk.MAX_NEEDLE_BYTES

    def unsupported_reason(self) -> str:
        if self.needle() is None:
            return f"{self.name} needs a literal needle"
        return (f"{self.name}'s needle is longer than the "
                f"{sk.MAX_NEEDLE_BYTES} bytes K13 takes")


class Contains(_NeedlePredicate):
    kernel = staticmethod(sk.contains)


class StartsWith(_NeedlePredicate):
    kernel = staticmethod(sk.startswith)


class EndsWith(_NeedlePredicate):
    kernel = staticmethod(sk.endswith)


class Like(Expression):
    """SQL LIKE with a literal pattern of text and ``%``."""

    def __init__(self, child, pattern: str, escape: str = "\\"):
        super().__init__([child])
        self.pattern = pattern
        self.escape = escape
        self.segments = self.parse_segments(pattern, escape)

    @staticmethod
    def parse_segments(pattern: str, escape: str) -> Optional[List[bytes]]:
        """The literal byte segments between unescaped ``%``; None when
        the pattern uses ``_`` (a single character, not a byte)."""
        segs, cur, i = [], [], 0
        while i < len(pattern):
            ch = pattern[i]
            if ch == escape and i + 1 < len(pattern):
                cur.append(pattern[i + 1])
                i += 2
                continue
            if ch == "%":
                segs.append("".join(cur))
                cur = []
            elif ch == "_":
                return None
            else:
                cur.append(ch)
            i += 1
        segs.append("".join(cur))
        return [s.encode("utf-8") for s in segs]

    @property
    def dtype(self):
        return T.BOOL

    def eval_tpu(self, batch):
        segs = self.segments
        if segs is None:
            raise NotImplementedError(self.unsupported_reason())
        c = as_device_column(self.children[0].eval_tpu(batch),
                             batch.padded_rows, batch.device)
        bm, ln = c.data, c.lengths
        if len(segs) == 1:  # no wildcard: exact (length + prefix) equality
            ok = sk.startswith(bm, ln, segs[0]) & (ln == len(segs[0]))
            return DeviceColumn(T.BOOL, ok, c.validity)
        first, last, mids = segs[0], segs[-1], segs[1:-1]
        ok = sk.startswith(bm, ln, first) if first else \
            torch.ones(bm.shape[0], dtype=torch.bool, device=bm.device)
        cursor = torch.full((bm.shape[0],), len(first), dtype=torch.int32,
                            device=bm.device)
        for seg in mids:
            if not seg:
                continue
            pos1 = sk.locate_from(bm, ln, seg, cursor)
            ok = ok & (pos1 > 0)
            cursor = torch.where(pos1 > 0, pos1 - 1 + len(seg), cursor)
        if last:
            ok = ok & sk.endswith(bm, ln, last) & (ln - len(last) >= cursor)
        else:
            ok = ok & (ln >= cursor)
        return DeviceColumn(T.BOOL, ok, c.validity)

    @property
    def tpu_supported(self):
        return self.segments is not None and all(
            len(s) <= sk.MAX_NEEDLE_BYTES for s in self.segments)

    def unsupported_reason(self) -> str:
        if self.segments is None:
            return ("LIKE pattern uses '_' (one character, not one byte): "
                    "the reference runs it with the host regex, and the "
                    "host engine is not ported yet")
        return (f"a LIKE segment is longer than the {sk.MAX_NEEDLE_BYTES} "
                "bytes K13 takes")


class Substring(Expression):
    """substring(str, pos, len): ``pos`` is 1-based, 0 acts as 1 and a
    negative value counts from the end; ``length`` None means to the
    end.  The output is ``min(max(len, 1), width)`` bytes wide (the
    input's width when ``length`` is None); validity passes through."""

    def __init__(self, child, pos: int, length: Optional[int] = None):
        super().__init__([child])
        self.pos = int(pos)
        self.length = int(length) if length is not None else None

    @property
    def dtype(self):
        return T.STRING

    @property
    def start(self) -> int:
        """The 0-based start K15 takes (negative: from the end)."""
        return self.pos - 1 if self.pos > 0 else (0 if self.pos == 0
                                                  else self.pos)

    def out_width(self, width: int) -> int:
        ln = self.length if self.length is not None else width
        return min(max(ln, 1), width)

    def eval_tpu(self, batch):
        c = as_device_column(self.children[0].eval_tpu(batch),
                             batch.padded_rows, batch.device)
        w = c.data.shape[1]
        ln = self.length if self.length is not None else w
        bm, lens = sk.substring(c.data, c.lengths, self.start, ln,
                                self.out_width(w))
        return DeviceColumn(T.STRING, bm, c.validity, lens)


class ConcatStrings(Expression):
    """concat(part, ...): the parts' bytes side by side, the output as
    wide as the parts' widths together; null if any part is null."""

    def __init__(self, exprs):
        super().__init__(list(exprs))

    @property
    def dtype(self):
        return T.STRING

    def eval_tpu(self, batch):
        n, dev = batch.padded_rows, batch.device
        cols = [as_device_column(e.eval_tpu(batch), n, dev)
                for e in self.children]
        bm, ln = sk.concat([(c.data, c.lengths) for c in cols])
        validity = torch.ones(n, dtype=torch.bool, device=dev)
        for c in cols:
            validity = validity & c.validity
        return DeviceColumn(T.STRING, bm, validity, ln)


class _StrUnary(Expression):
    """A string -> string function of one child; validity passes
    through."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return T.STRING

    def device_kernel(self, bm, lengths):
        raise NotImplementedError

    def eval_tpu(self, batch):
        c = as_device_column(self.children[0].eval_tpu(batch),
                             batch.padded_rows, batch.device)
        bm, ln = self.device_kernel(c.data, c.lengths)
        return DeviceColumn(T.STRING, bm, c.validity, ln)


class Upper(_StrUnary):
    """ASCII upper case (K19); other bytes are kept, so a non-ASCII
    letter keeps its case: incompatible with the host engine."""

    def device_kernel(self, bm, lengths):
        return sk.upper(bm, lengths)


class Lower(_StrUnary):
    """ASCII lower case (K19), incompatible as Upper is."""

    def device_kernel(self, bm, lengths):
        return sk.lower(bm, lengths)


class StringTrim(_StrUnary):
    """Spaces (0x20) dropped from both ends (K20); as wide as the input."""

    side = "both"

    @property
    def left(self) -> bool:
        return self.side in ("both", "left")

    @property
    def right(self) -> bool:
        return self.side in ("both", "right")

    def device_kernel(self, bm, lengths):
        return sk.trim_ws(bm, lengths, bm.shape[1], left=self.left,
                          right=self.right)


class StringTrimLeft(StringTrim):
    side = "left"


class StringTrimRight(StringTrim):
    side = "right"


class Length(Expression):
    """The characters of a string (K19): the bytes below the length that
    do not continue a UTF-8 sequence."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return T.INT32

    def eval_tpu(self, batch):
        c = as_device_column(self.children[0].eval_tpu(batch),
                             batch.padded_rows, batch.device)
        return DeviceColumn(T.INT32, sk.length(c.data, c.lengths),
                            c.validity)


class SubstringIndex(Expression):
    """substring_index(str, delim, count) (K20): on the device only for a
    one-byte delimiter, which cannot overlap itself, so its matches are
    ``str.split``'s."""

    def __init__(self, child, delim: str, count: int):
        super().__init__([child])
        self.delim = delim
        self.count = int(count)

    @property
    def dtype(self):
        return T.STRING

    @property
    def delim_bytes(self) -> bytes:
        return self.delim.encode("utf-8")

    def eval_tpu(self, batch):
        c = as_device_column(self.children[0].eval_tpu(batch),
                             batch.padded_rows, batch.device)
        bm, ln = sk.substring_index(c.data, c.lengths, self.delim_bytes,
                                    self.count)
        return DeviceColumn(T.STRING, bm, c.validity, ln)

    @property
    def tpu_supported(self):
        return len(self.delim_bytes) == 1

    def unsupported_reason(self) -> str:
        return (f"substring_index with the {len(self.delim_bytes)}-byte "
                f"delimiter {self.delim!r}: the device takes one byte, the "
                "reference runs the rest on its host engine, which is not "
                "ported yet")


class StringReplace(Expression):
    """replace(str, search, replacement) (K21): on the device only for a
    one-byte search string; the output is ``w * max(k, 1)`` bytes wide
    for a k-byte replacement."""

    def __init__(self, child, search: str, replace: str):
        super().__init__([child])
        self.search = search
        self.replace = replace

    @property
    def dtype(self):
        return T.STRING

    @property
    def search_bytes(self) -> bytes:
        return self.search.encode("utf-8")

    @property
    def replace_bytes(self) -> bytes:
        return self.replace.encode("utf-8")

    def eval_tpu(self, batch):
        c = as_device_column(self.children[0].eval_tpu(batch),
                             batch.padded_rows, batch.device)
        bm, ln = sk.replace_single(c.data, c.lengths, self.search_bytes,
                                   self.replace_bytes)
        return DeviceColumn(T.STRING, bm, c.validity, ln)

    @property
    def tpu_supported(self):
        return len(self.search_bytes) == 1 and \
            len(self.replace_bytes) <= sk.MAX_REPLACE_BYTES

    def unsupported_reason(self) -> str:
        if len(self.search_bytes) != 1:
            return (f"replace of the {len(self.search_bytes)}-byte search "
                    f"string {self.search!r}: the device takes one byte, "
                    "the reference runs the rest on its host engine, which "
                    "is not ported yet")
        return (f"a replacement longer than the {sk.MAX_REPLACE_BYTES} "
                "bytes K21 takes")


class StringLocate(Expression):
    """locate(substr, str, pos): the 1-based byte position of the first
    match at or after ``pos`` (K13, one start for every row), 0 when
    absent; a ``pos`` of 0 or less searches the whole row, as the
    reference's device path does."""

    def __init__(self, substr: str, child, pos: int = 1):
        super().__init__([child])
        self.substr = substr
        self.pos = int(pos)

    @property
    def dtype(self):
        return T.INT32

    @property
    def needle(self) -> bytes:
        return self.substr.encode("utf-8")

    def eval_tpu(self, batch):
        c = as_device_column(self.children[0].eval_tpu(batch),
                             batch.padded_rows, batch.device)
        return DeviceColumn(T.INT32, sk.locate(c.data, c.lengths,
                                               self.needle, self.pos),
                            c.validity)

    @property
    def tpu_supported(self):
        return len(self.needle) <= sk.MAX_NEEDLE_BYTES

    def unsupported_reason(self) -> str:
        return (f"locate's needle is longer than the "
                f"{sk.MAX_NEEDLE_BYTES} bytes K13 takes")
