"""String predicates with a literal needle or pattern, and substring.

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
parts' bytes whatever their validity, as in the reference.  The other
string functions (length, case maps, replace, trim, substring_index,
locate with a scalar start) come with a later slice.
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
