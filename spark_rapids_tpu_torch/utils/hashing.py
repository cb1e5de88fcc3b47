"""K9 — Spark's Murmur3 (x86_32) of a batch's key columns, from a seed.

Counterpart of ``spark_rapids_tpu/utils/hashing.py``: ``hash_int_jnp``
(200), ``hash_long_jnp`` (207), ``hash_bytes_jnp`` (217),
``hash_device_column`` (242), ``hash_device_batch`` (269) and ``pmod``
(280), so hash partitioning places every row where the reference does.
The hash folds over the key columns in order, starting from ``seed``
(42, Spark's, for every exchange; the grace join's buckets take a seed of
their own for each recursion level, as the reference's ``_bucket_side``
does):

  * int8, int16, int32, bool and date32 as hashInt of the value
    sign-extended to 32 bits; int64 and timestamp as hashLong;
  * float32 and float64 with -0.0 made 0.0 (NaN is not canonicalised,
    as in the reference's device version), as hashInt / hashLong of the
    bits;
  * strings (``uint8[n, w]`` bytes, int32 lengths) as Spark's
    hashUnsafeBytes: ``length // 4`` little-endian words, then up to
    three tail bytes, each sign-extended, and the length into fmix;
  * a null row passes the running hash through.

The partition id is ``pmod(hash, n_out)``, never negative.  The wrappers
launch ``csrc/hashing.cu`` for CUDA tensors and take the plain PyTorch
version only for CPU tensors, unless ``kernels=`` names the libraries to
launch.  The plain version works in int64 holding uint32 values, masked
to 32 bits after every step (PyTorch on the CPU has no uint32 add or
shift), with each multiply split in 16-bit halves so that no step
overflows.  The reference's numpy host hash waits for the host engine.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .. import types as T
from ..data.column import DeviceColumn
from ..ops.kernels import _build as B

SEED = 42
M32 = 0xFFFFFFFF
#: key columns one K9 launch takes (csrc/hashing.cu MAX_COLS)
MAX_COLS = 16

#: CUDA kernels launched by K9
HASH_LAUNCHES = B.LaunchCounter("murmur3")

_INT_TYPES = (T.TypeId.INT8, T.TypeId.INT16, T.TypeId.INT32,
              T.TypeId.DATE32, T.TypeId.BOOL)
_LONG_TYPES = (T.TypeId.INT64, T.TypeId.TIMESTAMP)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x < 2**32, in two 16-bit halves of c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def _mix_k1(k1):
    return _mul(_rotl(_mul(k1, 0xCC9E2D51), 15), 0x1B873593)


def _mix_h1(h1, k1):
    return (_mul(_rotl(h1 ^ k1, 13), 5) + 0xE6546B64) & M32


def _fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _hash_int(u32, h):
    return _fmix(_mix_h1(h, _mix_k1(u32)), 4)


def _hash_long(v64, h):
    h = _mix_h1(h, _mix_k1(v64 & M32))
    h = _mix_h1(h, _mix_k1((v64 >> 32) & M32))
    return _fmix(h, 8)


def _hash_bytes(bm: torch.Tensor, lengths: torch.Tensor, h):
    n, w = bm.shape
    pad = (-w) % 4
    if pad:
        bm = torch.nn.functional.pad(bm, (0, pad))
    b = bm.to(torch.int64)
    lengths = lengths.to(torch.int64)
    aligned = lengths // 4
    for k in range(b.shape[1] // 4):
        word = (b[:, 4 * k] | (b[:, 4 * k + 1] << 8)
                | (b[:, 4 * k + 2] << 16) | (b[:, 4 * k + 3] << 24))
        h = torch.where(aligned > k, _mix_h1(h, _mix_k1(word)), h)
    if b.shape[1]:
        for t in range(3):
            idx = aligned * 4 + t
            safe = torch.clamp(idx, 0, b.shape[1] - 1)
            byte = torch.gather(b, 1, safe[:, None])[:, 0]
            signed = ((byte ^ 0x80) - 0x80) & M32
            h = torch.where(idx < lengths, _mix_h1(h, _mix_k1(signed)), h)
    return _fmix(h, lengths & M32)


def _fold_plain(col: DeviceColumn, h: torch.Tensor) -> torch.Tensor:
    tid = col.dtype.id
    data = col.data
    if tid in _INT_TYPES:
        out = _hash_int(data.to(torch.int64) & M32, h)
    elif tid in _LONG_TYPES:
        out = _hash_long(data.to(torch.int64), h)
    elif tid is T.TypeId.FLOAT32:
        v = torch.where(data == 0.0, torch.zeros_like(data), data)
        out = _hash_int(v.view(torch.int32).to(torch.int64) & M32, h)
    elif tid is T.TypeId.FLOAT64:
        v = torch.where(data == 0.0, torch.zeros_like(data), data)
        out = _hash_long(v.view(torch.int64), h)
    elif tid is T.TypeId.STRING:
        out = _hash_bytes(data, col.lengths, h)
    else:
        raise TypeError(f"unhashable dtype {col.dtype}")
    return torch.where(col.validity, out, h)


def hash_batch_plain(cols: Sequence[DeviceColumn],
                     seed: int = SEED) -> torch.Tensor:
    """Plain version of K9's hash: int32[n]."""
    n = cols[0].data.shape[0]
    h = torch.full((n,), seed & M32, dtype=torch.int64,
                   device=cols[0].data.device)
    for c in cols:
        h = _fold_plain(c, h)
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def pmod(hash_values: torch.Tensor, n_out: int) -> torch.Tensor:
    """Spark's non-negative modulo of HashPartitioning: int32[n]."""
    return torch.remainder(hash_values.to(torch.int64), n_out
                           ).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------
def _descriptors(cols: Sequence[DeviceColumn]):
    """The column table K9 reads: per column its data, validity and
    lengths addresses, dtype code and string width; plus the tensors
    that must stay alive through the launch."""
    if not cols or len(cols) > MAX_COLS:
        raise ValueError(f"K9 hashes 1 to {MAX_COLS} key columns, "
                         f"got {len(cols)}")
    keep, desc = [], []
    for c in cols:
        if c.dtype.id not in _INT_TYPES + _LONG_TYPES + (
                T.TypeId.FLOAT32, T.TypeId.FLOAT64, T.TypeId.STRING):
            raise TypeError(f"unhashable dtype {c.dtype}")
        data = c.data.contiguous()
        valid = c.validity.contiguous()
        lengths = c.lengths.to(torch.int32).contiguous() \
            if c.dtype.is_string else None
        keep += [data, valid, lengths]
        desc += [B.ptr(data), B.ptr(valid), B.ptr(lengths) or 0,
                 B.DTYPE_CODES[data.dtype],
                 data.shape[1] if data.dim() == 2 else 1]
    return (ctypes.c_longlong * len(desc))(*desc), keep


def _launch(cols, n_out: int, want_hash: bool, kernels, seed: int):
    n = cols[0].data.shape[0]
    dev = cols[0].data.device
    # ``_keep`` holds the tensors behind the table's addresses through
    # the launch
    table, _keep = _descriptors(cols)
    h = torch.empty(n, dtype=torch.int32, device=dev) if want_hash else None
    pids = torch.empty(n, dtype=torch.int32, device=dev) if n_out else None
    B.launch(HASH_LAUNCHES, kernels.library("hashing"), "k9_murmur3",
             table, len(cols), n, seed & M32, n_out, B.ptr(h), B.ptr(pids),
             kernels.stream(cols[0].data), launched=None if n else 0)
    return h, pids


def hash_device_batch(cols: Sequence[DeviceColumn],
                      kernels: Optional[B.Kernels] = None,
                      seed: int = SEED) -> torch.Tensor:
    """K9: the Murmur3 hash (int32[n]) of every row of ``cols`` from
    ``seed``, bit for bit the reference's ``hash_device_batch``."""
    kernels = B.kernels_for(cols[0].data, kernels)
    if kernels is None:
        return hash_batch_plain(cols, seed)
    return _launch(cols, 0, True, kernels, seed)[0]


def hash_pids(cols: Sequence[DeviceColumn], n_out: int,
              kernels: Optional[B.Kernels] = None,
              seed: int = SEED) -> torch.Tensor:
    """K9: ``pmod(hash, n_out)`` of every row, the partition of each row
    under ``HashPartitioning(cols, n_out)`` (int32[n]); the grace join
    passes its level's ``seed``."""
    if n_out < 1:
        raise ValueError(f"n_out must be positive, got {n_out}")
    kernels = B.kernels_for(cols[0].data, kernels)
    if kernels is None:
        return pmod(hash_batch_plain(cols, seed), n_out)
    return _launch(cols, n_out, False, kernels, seed)[1]
