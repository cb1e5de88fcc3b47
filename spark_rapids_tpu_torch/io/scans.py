"""Hive-style partition directory names.

The port's copy of the naming half of ``spark_rapids_tpu/io/scans.py``
(``:30-75``): ``HIVE_NULL``, ``_PATH_ESCAPE_CHARS``,
``escape_path_name``, ``partition_dir_name`` and ``unescape_path_name``.
Both writers name a dynamic partition's directory by this one rule.  The
scan itself (``discover_files``, partition pruning, ``read_parquet``) is
not ported yet.
"""
from __future__ import annotations

import numpy as np

#: Spark's directory name for a null partition value
HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"

#: characters escaped in partition directory names (Spark's
#: ExternalCatalogUtils.escapePathName): without this a value holding
#: '/' would nest directories
_PATH_ESCAPE_CHARS = set('"#%\'*/:=?\\{[]^\x7f') | \
    {chr(c) for c in range(0x20)}


def escape_path_name(value: str) -> str:
    return "".join(f"%{ord(ch):02X}" if ch in _PATH_ESCAPE_CHARS else ch
                   for ch in value)


def partition_dir_name(key: str, value) -> str:
    """The ``key=value`` directory segment: nulls take the Hive sentinel,
    -0.0 becomes 0.0 (the two zeros are one group and one directory) and
    special characters are escaped."""
    if value is None:
        return f"{key}={HIVE_NULL}"
    if isinstance(value, (float, np.floating)) and value == 0.0:
        value = type(value)(0.0)
    return f"{key}={escape_path_name(str(value))}"


def unescape_path_name(value: str) -> str:
    out = []
    i = 0
    while i < len(value):
        if value[i] == "%" and i + 3 <= len(value):
            try:
                out.append(chr(int(value[i + 1:i + 3], 16)))
                i += 3
                continue
            except ValueError:
                pass
        out.append(value[i])
        i += 1
    return "".join(out)
