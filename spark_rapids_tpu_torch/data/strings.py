"""String columns as byte matrices.

Counterpart of ``spark_rapids_tpu/data/strings.py``.  A string column is

    bytes:   uint8[rows, width]   (UTF-8 payload, zero padded)
    lengths: int32[rows]          (byte length per row)

on the host and on the device alike.  The reference encodes through
pyarrow; this module uses numpy alone.  ``encode`` goes through numpy's
fixed-width bytes type, so a string's trailing NUL bytes are not kept.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def encode(values, validity: Optional[np.ndarray] = None,
           max_len: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a sequence of ``str`` (or None) into (bytes, lengths).
    Null rows (``None`` or ``validity`` False) encode as empty."""
    vals = np.asarray(values, dtype=object)
    n = len(vals)
    keep = np.array([isinstance(v, str) for v in vals], dtype=np.bool_)
    if validity is not None:
        keep &= np.asarray(validity, dtype=np.bool_)
    text = np.where(keep, vals, "").astype(str) if n else \
        np.zeros(0, dtype="U1")
    raw = np.char.encode(text, "utf-8") if n else np.zeros(0, dtype="S1")
    lengths = np.char.str_len(raw).astype(np.int32) if n else \
        np.zeros(0, dtype=np.int32)
    ml = int(lengths.max()) if n else 0
    width = max(1, ml) if max_len is None else max_len
    if ml > width:
        raise ValueError(f"string of {ml} bytes exceeds max_len {width}")
    out = np.zeros((n, width), dtype=np.uint8)
    if n and raw.dtype.itemsize:
        mat = np.frombuffer(raw.tobytes(), dtype=np.uint8).reshape(
            n, raw.dtype.itemsize)
        k = min(width, mat.shape[1])
        out[:, :k] = mat[:, :k]
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
