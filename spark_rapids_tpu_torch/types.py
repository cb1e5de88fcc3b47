"""Data type system of the PyTorch/CUDA engine.

Counterpart of ``spark_rapids_tpu/types.py``: the same SQL types, fields
and schemas, with a torch dtype map (``DType.torch_dtype``) in place of
the reference's ``jnp_dtype``.

Physical representation:
  * numbers, dates (int32 days since epoch), timestamps (int64 us, UTC)
    and booleans are 1-D tensors;
  * STRING columns are ``uint8[rows, width]`` byte matrices plus ``int32``
    lengths, on the host as well as on the device (the reference keeps
    host strings as object arrays; the port never builds Python string
    objects on its data path).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class TypeId(enum.Enum):
    BOOL = "boolean"
    INT8 = "tinyint"
    INT16 = "smallint"
    INT32 = "int"
    INT64 = "bigint"
    FLOAT32 = "float"
    FLOAT64 = "double"
    DATE32 = "date"          # int32 days since unix epoch
    TIMESTAMP = "timestamp"  # int64 microseconds since unix epoch, UTC
    STRING = "string"
    NULL = "void"            # untyped null literal


@dataclass(frozen=True)
class DType:
    """An engine data type.  Hashable; use the singletons below."""

    id: TypeId

    @property
    def is_numeric(self) -> bool:
        return self.id in _NUMERIC

    @property
    def is_integral(self) -> bool:
        return self.id in _INTEGRAL

    @property
    def is_floating(self) -> bool:
        return self.id in (TypeId.FLOAT32, TypeId.FLOAT64)

    @property
    def is_string(self) -> bool:
        return self.id is TypeId.STRING

    @property
    def is_bool(self) -> bool:
        return self.id is TypeId.BOOL

    @property
    def np_dtype(self) -> np.dtype:
        """numpy dtype of the host data (``uint8`` bytes for STRING)."""
        return _NP[self.id]

    @property
    def torch_dtype(self) -> torch.dtype:
        """torch dtype of the data tensor (``uint8`` bytes for STRING)."""
        return _TORCH[self.id]

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return self.id.value

    @property
    def sql_name(self) -> str:
        return self.id.value


_INTEGRAL = {TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64}
_NUMERIC = _INTEGRAL | {TypeId.FLOAT32, TypeId.FLOAT64}

_NP = {
    TypeId.BOOL: np.dtype(np.bool_),
    TypeId.INT8: np.dtype(np.int8),
    TypeId.INT16: np.dtype(np.int16),
    TypeId.INT32: np.dtype(np.int32),
    TypeId.INT64: np.dtype(np.int64),
    TypeId.FLOAT32: np.dtype(np.float32),
    TypeId.FLOAT64: np.dtype(np.float64),
    TypeId.DATE32: np.dtype(np.int32),
    TypeId.TIMESTAMP: np.dtype(np.int64),
    TypeId.STRING: np.dtype(np.uint8),
    TypeId.NULL: np.dtype(np.bool_),
}

_TORCH = {
    TypeId.BOOL: torch.bool,
    TypeId.INT8: torch.int8,
    TypeId.INT16: torch.int16,
    TypeId.INT32: torch.int32,
    TypeId.INT64: torch.int64,
    TypeId.FLOAT32: torch.float32,
    TypeId.FLOAT64: torch.float64,
    TypeId.DATE32: torch.int32,
    TypeId.TIMESTAMP: torch.int64,
    TypeId.STRING: torch.uint8,
    TypeId.NULL: torch.bool,
}

BOOL = DType(TypeId.BOOL)
INT8 = DType(TypeId.INT8)
INT16 = DType(TypeId.INT16)
INT32 = DType(TypeId.INT32)
INT64 = DType(TypeId.INT64)
FLOAT32 = DType(TypeId.FLOAT32)
FLOAT64 = DType(TypeId.FLOAT64)
DATE32 = DType(TypeId.DATE32)
TIMESTAMP = DType(TypeId.TIMESTAMP)
STRING = DType(TypeId.STRING)
NULL = DType(TypeId.NULL)

ALL_TYPES = (BOOL, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64, DATE32,
             TIMESTAMP, STRING)

_BY_NAME = {t.sql_name: t for t in ALL_TYPES}
_BY_NAME.update({
    "long": INT64, "integer": INT32, "short": INT16, "byte": INT8,
    "bool": BOOL, "real": FLOAT32, "str": STRING, "void": NULL,
})


def from_name(name: str) -> DType:
    return _BY_NAME[name.lower()]


_RANK = {
    TypeId.INT8: 0, TypeId.INT16: 1, TypeId.INT32: 2, TypeId.INT64: 3,
    TypeId.FLOAT32: 4, TypeId.FLOAT64: 5,
}


def promote(a: DType, b: DType) -> DType:
    """Spark numeric promotion: integrals widen, floats win, and a float
    meeting a 64-bit integral becomes double."""
    if not (a.is_numeric and b.is_numeric):
        raise TypeError(f"cannot promote {a} and {b}")
    ra, rb = _RANK[a.id], _RANK[b.id]
    winner = a if ra >= rb else b
    loser = b if ra >= rb else a
    if winner.id is TypeId.FLOAT32 and loser.id is TypeId.INT64:
        return FLOAT64
    return winner


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DType
    nullable: bool = True

    def __repr__(self) -> str:  # pragma: no cover
        n = "" if self.nullable else " not null"
        return f"{self.name}:{self.dtype}{n}"


class Schema:
    """Ordered collection of fields with name lookup."""

    def __init__(self, fields):
        self.fields = list(fields)
        self._index = {}
        for i, f in enumerate(self.fields):
            self._index[f.name] = i  # last wins for duplicate names

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.fields[key]
        return self.fields[self._index[key]]

    def __contains__(self, name):
        return name in self._index

    def index_of(self, name: str) -> int:
        return self._index[name]

    @property
    def names(self):
        return [f.name for f in self.fields]

    @property
    def dtypes(self):
        return [f.dtype for f in self.fields]

    def __eq__(self, other):
        return isinstance(other, Schema) and self.fields == other.fields

    def __repr__(self) -> str:  # pragma: no cover
        return "Schema(" + ", ".join(map(repr, self.fields)) + ")"
