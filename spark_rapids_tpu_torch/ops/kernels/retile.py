"""K27 — the multi-process runner's retile (``csrc/retile.cu``, B.28).

Counterpart of ``spark_rapids_tpu/parallel/multiprocess.py:342
MultiProcessRunner._retile``: its jit at ``:348`` takes the max of every
shard's row count and replicates it to every controller, its jit at
``:358`` cuts every column of the stacked stage output to
``bucket_rows(max)`` in new arrays.

``retile_max`` launches K27's first kernel for CUDA tensors: the
element-wise max of the owned shards' statistics (``Stat`` entries: a
device array of int32 or int64 words, such as a shard's row count or
K10's counts to every destination, or one host int such as a string
column's width, each at its own slot of a ``k``-word vector) into one
int64 ``[k + 1]`` buffer, word ``k`` holding ``bucket_rows`` of the max
of words ``[0, n_bucket)``.  The caller all-reduces that buffer with MAX
across the processes and reads it back once
(``parallel/multiprocess.py``).  ``retile_trim`` launches the second
kernel: the first ``need`` rows of every buffer of every batch given
(data, validity, a string column's lengths) copied into one new
allocation, each batch returned as views into it; a batch already at
``need`` rows or fewer is returned as it is.

``retile_max_plain`` (``torch.stack(...).amax(0)`` and the bucket
formula) and ``retile_trim_plain`` (``t[:need].clone()``) are the CPU
path and the kernels' oracle.

Bound on this card: ``retile_max`` by launch latency (a few hundred
bytes); ``retile_trim`` by bytes, twice the trimmed bytes
(``retile_trim_bytes``) over the memory rate.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Union

import torch

from ...data.column import DeviceBatch, DeviceColumn
from . import _build as B

#: CUDA kernels launched by K27's two functions
RETILE_MAX_LAUNCHES = B.LaunchCounter("retile_max")
RETILE_TRIM_LAUNCHES = B.LaunchCounter("retile_trim")

#: each buffer's place in the trim's allocation is aligned to this
ALIGN = 256


class Stat(NamedTuple):
    """Statistics words written at ``slot`` onwards: the elements of a
    1-D (or 0-d) int32 / int64 tensor, or one non-negative host int."""

    slot: int
    value: Union[torch.Tensor, int]


def _check(stats: Sequence[Stat], k: int, n_bucket: int) -> None:
    if not stats:
        raise ValueError("retile_max needs at least one statistic")
    if not 1 <= n_bucket <= k:
        raise ValueError(f"n_bucket {n_bucket} outside [1, {k}]")
    for s in stats:
        n = 1 if isinstance(s.value, int) else s.value.numel()
        if s.slot < 0 or s.slot + n > k:
            raise ValueError(f"statistic at slot {s.slot} ({n} words) "
                             f"outside the {k}-word vector")
        if isinstance(s.value, int):
            if s.value < 0:
                raise ValueError("statistics are non-negative")
        elif s.value.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"statistics are int32 or int64, not "
                            f"{s.value.dtype}")


def _bucket_plain(top: torch.Tensor, min_bucket: int) -> torch.Tensor:
    """``data/column.py:bucket_rows`` of an int64 0-d tensor, with no read
    back: the smallest ``b * 2**i >= max(top, 1)``, ``b = max(min_bucket,
    1)``."""
    b = max(min_bucket, 1)
    need = torch.clamp(top, min=1)
    i = torch.clamp(torch.ceil(torch.log2(need.to(torch.float64) / b)),
                    min=0).to(torch.int64)
    out = torch.full_like(need, b) << i
    # a log2 rounded either way
    out = torch.where(out < need, out * 2, out)
    return torch.where((out > b) & (out // 2 >= need), out // 2, out)


def retile_max_plain(stats: Sequence[Stat], k: int, n_bucket: int,
                     min_bucket: int, device: torch.device) -> torch.Tensor:
    """Each statistic scattered into a zero ``k``-word vector, the vectors
    stacked and reduced with ``amax``, then the bucket word."""
    _check(stats, k, n_bucket)
    vecs = []
    for s in stats:
        v = torch.zeros(k, dtype=torch.int64, device=device)
        if isinstance(s.value, int):
            v[s.slot] = s.value
        else:
            w = s.value.reshape(-1).to(device=device, dtype=torch.int64)
            v[s.slot:s.slot + w.numel()] = w
        vecs.append(v)
    mx = torch.stack(vecs).amax(0)
    return torch.cat([mx, _bucket_plain(mx[:n_bucket].amax(), min_bucket)
                      .reshape(1)])


def retile_max(stats: Sequence[Stat], k: int, n_bucket: int,
               min_bucket: int, device: torch.device,
               kernels: Optional[B.Kernels] = None) -> torch.Tensor:
    """K27's max: int64 ``[k + 1]`` on ``device``, the element-wise max of
    ``stats`` and, last, the bucket of the max of the first ``n_bucket``
    words (one launch)."""
    _check(stats, k, n_bucket)
    probe = torch.empty(0, device=device)
    kernels = B.kernels_for(probe, kernels)
    if kernels is None:
        return retile_max_plain(stats, k, n_bucket, min_bucket, device)
    words: List[int] = []
    for s in stats:
        if isinstance(s.value, int):
            words += [0, s.value, 8, s.slot]
        else:
            t = s.value.reshape(-1).contiguous()
            if t.device != probe.device:
                raise ValueError(f"statistic on {t.device}, expected "
                                 f"{probe.device}")
            words += [B.ptr(t), t.numel(), t.element_size(), s.slot]
    table = B.device_table(words, probe.device)
    out = torch.empty(k + 1, dtype=torch.int64, device=probe.device)
    B.launch(RETILE_MAX_LAUNCHES, kernels.library("retile"),
             "k27_retile_max", B.ptr(table), len(stats), k, n_bucket,
             min_bucket, B.ptr(out), kernels.stream(out))
    return out


def _buffers(c: DeviceColumn):
    return [c.data, c.validity] + ([] if c.lengths is None else [c.lengths])


def _rebuilt(c: DeviceColumn, bufs: List[torch.Tensor]) -> DeviceColumn:
    return DeviceColumn(c.dtype, bufs[0], bufs[1],
                        bufs[2] if c.lengths is not None else None)


def retile_trim_plain(batches: Sequence[DeviceBatch],
                      need: int) -> List[DeviceBatch]:
    """Every buffer's first ``need`` rows cloned (``t[:need].clone()``);
    batches at ``need`` rows or fewer as they are."""
    out = []
    for b in batches:
        if b.padded_rows <= need:
            out.append(b)
            continue
        out.append(DeviceBatch(b.schema, [
            _rebuilt(c, [t[:need].clone() for t in _buffers(c)])
            for c in b.columns], b.num_rows))
    return out


def retile_trim(batches: Sequence[DeviceBatch], need: int,
                kernels: Optional[B.Kernels] = None) -> List[DeviceBatch]:
    """K27's trim: the batches over ``need`` padded rows cut to ``need``
    rows, all their buffers copied by one launch into one allocation
    (views into it returned); the others as they are.  The batches lie
    on one device."""
    todo = [i for i, b in enumerate(batches) if b.padded_rows > need]
    if not todo:
        return list(batches)
    dev = batches[todo[0]].device
    kernels = B.kernels_for(batches[todo[0]].num_rows, kernels)
    if kernels is None:
        return retile_trim_plain(batches, need)
    # each buffer's place in the one allocation
    places = []  # (batch, column, buffer, offset, bytes)
    total = 0
    for i in todo:
        for ci, c in enumerate(batches[i].columns):
            for bi, t in enumerate(_buffers(c)):
                if t.device != dev:
                    raise ValueError(f"a batch on {t.device}, another on "
                                     f"{dev}")
                if not t.is_contiguous():
                    raise ValueError("retile_trim needs contiguous buffers")
                nbytes = need * (t[0].numel() * t.element_size())
                places.append((i, ci, bi, total, nbytes))
                total += -(-nbytes // ALIGN) * ALIGN
    alloc = torch.empty(max(total, 1), dtype=torch.uint8, device=dev)
    words: List[int] = []
    for i, ci, bi, off, nbytes in places:
        t = _buffers(batches[i].columns[ci])[bi]
        words += [B.ptr(t), alloc.data_ptr() + off, nbytes]
    table = B.device_table(words, dev)
    B.launch(RETILE_TRIM_LAUNCHES, kernels.library("retile"),
             "k27_retile_trim", B.ptr(table), len(places),
             max(p[4] for p in places), kernels.stream(alloc))
    views = {}
    for i, ci, bi, off, nbytes in places:
        t = _buffers(batches[i].columns[ci])[bi]
        views[(i, ci, bi)] = alloc[off:off + nbytes].view(t.dtype).reshape(
            (need,) + tuple(t.shape[1:]))
    out = list(batches)
    for i in todo:
        b = batches[i]
        out[i] = DeviceBatch(b.schema, [
            _rebuilt(c, [views[(i, ci, bi)]
                         for bi in range(len(_buffers(c)))])
            for ci, c in enumerate(b.columns)], b.num_rows)
    return out


def retile_trim_bytes(batches: Sequence[DeviceBatch], need: int) -> int:
    """The bytes the trim moves: every trimmed buffer's ``need`` rows read
    once and written once."""
    return 2 * sum(need * t[0].numel() * t.element_size()
                   for b in batches if b.padded_rows > need
                   for c in b.columns for t in _buffers(c))
