"""String columns as byte matrices.

Counterpart of ``spark_rapids_tpu/data/strings.py``.  A string column is

    bytes:   uint8[rows, width]   (UTF-8 payload, zero padded)
    lengths: int32[rows]          (byte length per row)

on the host and on the device alike.  The reference encodes through
pyarrow; this module uses numpy alone.  ``encode`` writes each value's
UTF-8 bytes at their exact length, so NUL bytes (trailing ones too) are
kept: ``"a\x00"`` has length 2 and differs from ``"a"``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def encode(values, validity: Optional[np.ndarray] = None,
           max_len: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a sequence of ``str`` (or None) into (bytes, lengths).
    Null rows (``None`` or ``validity`` False) encode as empty."""
    vals = list(values)
    n = len(vals)
    keep = [isinstance(v, str) for v in vals]
    if validity is not None:
        keep = [k and bool(ok) for k, ok in zip(keep, validity)]
    raw = [v.encode("utf-8") if k else b"" for v, k in zip(vals, keep)]
    lengths = np.fromiter(map(len, raw), dtype=np.int32, count=n)
    ml = int(lengths.max()) if n else 0
    width = max(1, ml) if max_len is None else max_len
    if ml > width:
        raise ValueError(f"string of {ml} bytes exceeds max_len {width}")
    out = np.zeros((n, width), dtype=np.uint8)
    total = int(lengths.sum())
    if total:
        flat = np.frombuffer(b"".join(raw), dtype=np.uint8)
        starts = np.repeat(np.cumsum(lengths, dtype=np.int64) - lengths,
                           lengths)
        rows = np.repeat(np.arange(n), lengths)
        out[rows, np.arange(total) - starts] = flat
    return out, lengths


def decode_one(row: np.ndarray, length: int) -> str:
    k = max(0, min(int(length), row.shape[0]))
    return bytes(row[:k]).decode("utf-8", errors="replace")


def decode(byte_mat: np.ndarray, lengths: np.ndarray,
           validity: Optional[np.ndarray] = None) -> np.ndarray:
    """(bytes, lengths) back to an object array of ``str`` (None = null)."""
    n = byte_mat.shape[0]
    out = np.empty(n, dtype=object)
    for i in range(n):
        if validity is not None and not validity[i]:
            out[i] = None
        else:
            out[i] = decode_one(byte_mat[i], lengths[i])
    return out


def pad_width(byte_mat: np.ndarray, width: int) -> np.ndarray:
    if byte_mat.shape[1] >= width:
        return byte_mat
    out = np.zeros((byte_mat.shape[0], width), dtype=np.uint8)
    out[:, :byte_mat.shape[1]] = byte_mat
    return out
