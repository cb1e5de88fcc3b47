"""K8 — string comparison over the fixed-width byte-matrix encoding.

Counterpart of ``spark_rapids_tpu/ops/kernels/stringkernels.py:equals``
(58) and ``compare`` (36), with the padding rule of ``_pad_to`` (18) and
``_masked`` (28).  A string is ``(uint8[n, w] bytes, int32[n] lengths)``;
either side may hold one row (a literal), which is read with a row
stride of 0 instead of being copied ``n`` times.  The wrappers launch
``csrc/strings.cu`` for CUDA tensors and take the plain PyTorch version
only for CPU tensors, unless ``kernels=`` names the libraries to launch.

Left out, for later slices: ``upper``, ``lower``, ``length``,
``substring``, ``concat``, ``contains``/``startswith``/``endswith``,
``locate``, ``substring_index``, ``replace`` and ``trim``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build as B

#: CUDA kernels launched by K8
STRING_COMPARE_LAUNCHES = B.LaunchCounter("string_compare")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def _widened(bm: torch.Tensor, lengths: torch.Tensor, n: int, w: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad to width ``w``, zero bytes at or past the length, and broadcast
    a one-row side to ``n`` rows."""
    if bm.shape[1] < w:
        bm = torch.nn.functional.pad(bm, (0, w - bm.shape[1]))
    pos = torch.arange(w, dtype=torch.int32, device=bm.device)[None, :]
    m = torch.where(pos < lengths[:, None], bm, torch.zeros_like(bm))
    return m.expand(n, w), lengths.expand(n)


def _rows(lbm, rbm) -> int:
    return max(lbm.shape[0], rbm.shape[0])


def equals_plain(lbm, llen, rbm, rlen) -> torch.Tensor:
    n, w = _rows(lbm, rbm), max(lbm.shape[1], rbm.shape[1])
    l, ln = _widened(lbm, llen, n, w)
    r, rn = _widened(rbm, rlen, n, w)
    return (ln == rn) & (l == r).all(dim=1)


def compare_plain(lbm, llen, rbm, rlen) -> torch.Tensor:
    n, w = _rows(lbm, rbm), max(lbm.shape[1], rbm.shape[1])
    l, ln = _widened(lbm, llen, n, w)
    r, rn = _widened(rbm, rlen, n, w)
    pos = torch.arange(w, dtype=torch.int32, device=l.device)[None, :]
    both = (pos < ln[:, None]) & (pos < rn[:, None])
    diff = torch.where(both, l.to(torch.int32) - r.to(torch.int32),
                       torch.zeros((), dtype=torch.int32, device=l.device))
    nz = diff != 0
    first = torch.where(nz.any(dim=1), nz.to(torch.int8).argmax(dim=1),
                        torch.full((n,), w, dtype=torch.int64,
                                   device=l.device))
    d = torch.gather(diff, 1, first.clamp(0, w - 1)[:, None])[:, 0]
    byte_cmp = torch.sign(d)
    len_cmp = torch.sign(ln - rn)
    return torch.where(first < torch.minimum(ln, rn), byte_cmp,
                       len_cmp).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------
def _side(bm: torch.Tensor, lengths: torch.Tensor):
    """(bytes, lengths, width, row stride) of one side; a one-row or
    stride-0 (broadcast) side is read at stride 0."""
    if bm.shape[0] == 1 or bm.stride(0) == 0:
        return bm[:1].contiguous(), \
            lengths[:1].to(torch.int32).contiguous(), bm.shape[1], 0
    return bm.contiguous(), lengths.to(torch.int32).contiguous(), \
        bm.shape[1], 1


def _launch(lbm, llen, rbm, rlen, mode: int,
            kernels: B.Kernels) -> torch.Tensor:
    n = _rows(lbm, rbm)
    out = torch.empty(n, dtype=torch.bool if mode == 0 else torch.int32,
                      device=lbm.device)
    lb, ll, lw, ls = _side(lbm, llen)
    rb, rl, rw, rs = _side(rbm, rlen)
    B.launch(STRING_COMPARE_LAUNCHES, kernels.library("strings"),
             "k8_string_compare", B.ptr(lb), B.ptr(ll), lw, ls, B.ptr(rb),
             B.ptr(rl), rw, rs, n, mode, B.ptr(out), kernels.stream(lbm))
    return out


def equals(lbm, llen, rbm, rlen,
           kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K8: bool[n], row-wise string equality (either side may be one
    row)."""
    kernels = B.kernels_for(lbm, kernels)
    if kernels is None:
        return equals_plain(lbm, llen, rbm, rlen)
    return _launch(lbm, llen, rbm, rlen, 0, kernels)


def compare(lbm, llen, rbm, rlen,
            kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K8: int32[n] in {-1, 0, 1}, lexicographic byte order then length
    (Spark's UTF-8 binary collation; either side may be one row)."""
    kernels = B.kernels_for(lbm, kernels)
    if kernels is None:
        return compare_plain(lbm, llen, rbm, rlen)
    return _launch(lbm, llen, rbm, rlen, 1, kernels)
