"""Data exchange with the reference package's host layout.

The reference (``spark_rapids_tpu``) holds host columns as numpy arrays:
object arrays of ``str`` for strings, int32 days for DATE32, int64
microseconds for TIMESTAMP.  These helpers convert between that layout
and this engine's ``HostBatch`` (strings as byte matrices), so the same
numpy data can drive both packages.  Nothing here imports the reference.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from . import types as T
from .data import strings as dstrings
from .data.column import HostBatch, HostColumn


def from_reference_arrays(fields: Sequence[Tuple[str, str]],
                          arrays: Sequence[np.ndarray]) -> HostBatch:
    """``fields``: (name, type name) pairs, e.g. ("l_shipdate", "date");
    ``arrays``: one numpy array per field in the reference's layout
    (None entries of an object array of strings are nulls)."""
    out_fields: List[T.Field] = []
    cols: List[HostColumn] = []
    for (name, type_name), arr in zip(fields, arrays):
        dtype = T.from_name(type_name)
        arr = np.asarray(arr)
        if dtype.is_string:
            present = np.array([v is not None for v in arr], dtype=np.bool_)
            bm, ln = dstrings.encode(arr, present)
            cols.append(HostColumn(dtype, bm, present, ln))
        else:
            cols.append(HostColumn(dtype, arr.astype(dtype.np_dtype)))
        out_fields.append(T.Field(name, dtype))
    return HostBatch(T.Schema(out_fields), cols)


def to_reference_arrays(batch: HostBatch
                        ) -> Tuple[List[Tuple[str, str]],
                                   Dict[str, np.ndarray]]:
    """The inverse: (name, type name) pairs and name -> numpy array in
    the reference's layout (strings decoded to object arrays)."""
    fields = [(f.name, f.dtype.sql_name) for f in batch.schema]
    arrays = {}
    for f, c in zip(batch.schema, batch.columns):
        if f.dtype.is_string:
            arrays[f.name] = dstrings.decode(c.data, c.lengths, c.validity)
        else:
            arrays[f.name] = c.data
    return fields, arrays


def from_reference_tables(
        tables: Mapping[str, Tuple[Sequence[Tuple[str, str]],
                                   Mapping[str, np.ndarray]]]
) -> Dict[str, HostBatch]:
    """Many tables at once: table name -> (fields, name -> array) in the
    reference's layout, as ``to_reference_tables`` gives them."""
    return {t: from_reference_arrays(fields, [arrays[n] for n, _ in fields])
            for t, (fields, arrays) in tables.items()}


def to_reference_tables(batches: Mapping[str, HostBatch]):
    """table name -> (fields, name -> array) in the reference's layout."""
    return {t: to_reference_arrays(b) for t, b in batches.items()}
