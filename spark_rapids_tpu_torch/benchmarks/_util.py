"""Shared helpers for the benchmark data generators.

Counterpart of ``spark_rapids_tpu/benchmarks/_util.py`` (the port's own
copies of ``schema_of`` and ``pick``)."""
from __future__ import annotations

import numpy as np

from .. import types as T


def schema_of(cols):
    return T.Schema([T.Field(name, dtype) for name, dtype in cols])


def pick(rng, n, choices):
    """n seeded draws from a categorical vocabulary (object ndarray)."""
    return np.array(choices, dtype=object)[rng.integers(0, len(choices), n)]
