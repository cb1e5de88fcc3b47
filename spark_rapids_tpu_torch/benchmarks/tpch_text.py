"""TPC-H lineitem through text: the ingest and the export of the text path.

The ingest reads ``tpch_datagen.lineitem_text`` (every field a string, as
dbgen's ``lineitem.tbl`` holds it) and casts each field to its TPC-H type
in one ``select`` (``typed_select``), under ``CAST_CONF``, the three
reference confs that keep the string parses on the device; TPC-H's Q1
and Q6 (``benchmarks/tpch.py``) then run on that DataFrame.  The export
formats the typed columns and joins them into dbgen's line, every field
followed by ``|``, in one ``select`` (``export_select``), and again
behind a filter on the ship mode (``filtered_export``), where the two
fuse into one segment.

Each query function takes the functions module ``F`` of the package it
runs in (this package's by default), so the same query runs in the JAX
package for the tests.
"""
from __future__ import annotations

from ..plan import functions as f
from .tpch_datagen import EXPORT_COLUMNS, TEXT_COLUMNS, TEXT_TYPES

CAST_CONF = {"spark.rapids.tpu.sql.castStringToInteger.enabled": True,
             "spark.rapids.tpu.sql.castStringToFloat.enabled": True,
             "spark.rapids.tpu.sql.castStringToTimestamp.enabled": True}

#: the export's fields that are strings already
_STRING_FIELDS = ("l_returnflag", "l_linestatus", "l_shipinstruct",
                  "l_shipmode")


def typed_select(df, F=f):
    """Each text field cast to its TPC-H type, the flags kept."""
    return df.select(*[
        F.col(n).cast(TEXT_TYPES[n]).alias(n) if n in TEXT_TYPES
        else F.col(n) for n in TEXT_COLUMNS])


def export_select(df, F=f):
    """dbgen's line of the typed columns (``EXPORT_COLUMNS``), one string
    column ``line``; the quantity is printed as a whole number."""
    parts = []
    for n in EXPORT_COLUMNS:
        c = F.col(n)
        if n == "l_quantity":
            c = c.cast("bigint")
        if n not in _STRING_FIELDS:
            c = c.cast("string")
        parts += [c, F.lit("|")]
    return df.select(F.concat(*parts).alias("line"))


def filtered_export(df, F=f):
    """The export of the lines not shipped by AIR."""
    return export_select(df.filter(F.col("l_shipmode") != F.lit("AIR")), F)
