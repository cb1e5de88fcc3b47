"""Typed configuration registry.

Counterpart of ``spark_rapids_tpu/config.py``, cut to the keys this
engine reads.  The key names are the reference's, so one conf dict
drives both packages.  Unlike the reference, values come only from the
dict handed to the session (no environment lookup).  The reference's
``kernelCache.donation`` key has no counterpart: PyTorch has no buffer
donation, so a fused segment never consumes its input's buffers.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

_REGISTRY: Dict[str, "ConfEntry"] = {}


class ConfEntry:
    def __init__(self, key: str, converter: Callable[[str], Any],
                 doc: str, default: Any):
        self.key = key
        self.converter = converter
        self.doc = doc
        self.default = default
        if key in _REGISTRY:
            raise ValueError(f"duplicate conf key {key}")
        _REGISTRY[key] = self

    def get(self, conf: Dict[str, Any]) -> Any:
        if self.key not in conf:
            return self.default
        raw = conf[self.key]
        return self.converter(raw) if isinstance(raw, str) else raw


def _to_bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "yes", "on")


class ConfBuilder:
    """``conf("key").doc(...).boolean_conf(default)``."""

    def __init__(self, key: str):
        self.key = key
        self._doc = ""

    def doc(self, text: str) -> "ConfBuilder":
        self._doc = text
        return self

    def boolean_conf(self, default: bool) -> ConfEntry:
        return ConfEntry(self.key, _to_bool, self._doc, default)

    def int_conf(self, default: int) -> ConfEntry:
        return ConfEntry(self.key, int, self._doc, default)

    def string_conf(self, default: Optional[str]) -> ConfEntry:
        return ConfEntry(self.key, str, self._doc, default)


def conf(key: str) -> ConfBuilder:
    return ConfBuilder(key)


def lookup(key: str) -> Optional[ConfEntry]:
    return _REGISTRY.get(key)


def register_op_enable_key(kind: str, name: str, doc: str,
                           default: bool = True) -> ConfEntry:
    """Per-operator enable key, e.g. ``spark.rapids.tpu.sql.exec.SortExec``
    — derived from the rule registry like the reference's.  Idempotent."""
    key = f"spark.rapids.tpu.sql.{kind}.{name}"
    existing = lookup(key)
    if existing is not None:
        return existing
    return conf(key).doc(doc).boolean_conf(default)


# --- batch sizing ---------------------------------------------------------
BATCH_SIZE_BYTES = conf("spark.rapids.tpu.sql.batchSizeBytes").doc(
    "Target byte size for device batches; coalescing aims for this"
).int_conf(512 * 1024 * 1024)
READER_BATCH_SIZE_ROWS = conf("spark.rapids.tpu.sql.reader.batchSizeRows").doc(
    "Soft cap on rows per reader batch").int_conf(1 << 21)
READER_BATCH_SIZE_BYTES = conf(
    "spark.rapids.tpu.sql.reader.batchSizeBytes").doc(
    "Soft cap on bytes per reader batch").int_conf(512 * 1024 * 1024)
BUCKET_MIN_ROWS = conf("spark.rapids.tpu.sql.bucketMinRows").doc(
    "Device batches are padded to power-of-two row buckets >= this"
).int_conf(128)

# --- feature gates --------------------------------------------------------
SQL_ENABLED = conf("spark.rapids.tpu.sql.enabled").doc(
    "Master enable for the plan-rewrite engine").boolean_conf(True)
INCOMPATIBLE_OPS = conf("spark.rapids.tpu.sql.incompatibleOps.enabled").doc(
    "Allow ops whose results may diverge from the host engine in corner "
    "cases (reference: spark.rapids.sql.incompatibleOps.enabled)"
).boolean_conf(False)
ALLOW_FLOAT_AGG = conf("spark.rapids.tpu.sql.variableFloatAgg.enabled").doc(
    "Allow floating-point sums and averages on the device (their order "
    "differs from the host engine's); when false the aggregate is tagged "
    "off the device").boolean_conf(True)

# --- aggregation ----------------------------------------------------------
HASH_AGG_REPLACE_MODE = conf(
    "spark.rapids.tpu.sql.hashAgg.replaceMode").doc(
    "Which aggregation modes to replace: all, partial, final (several "
    "joined by '|'); an excluded mode is tagged off the device"
).string_conf("all")

# --- string cast gates (the reference's keys and defaults) ---------------
CAST_STRING_TO_INTEGER = conf(
    "spark.rapids.tpu.sql.castStringToInteger.enabled").doc(
    "Cast string->integral on the device (K16).  Exact for "
    "[+-]?digits[.digits] (fractions truncate); exponent forms ('1e2') "
    "become NULL on the device.  Off by default, as in the reference"
).boolean_conf(False)
CAST_STRING_TO_FLOAT = conf(
    "spark.rapids.tpu.sql.castStringToFloat.enabled").doc(
    "Cast string->float on the device (K16).  The digits accumulate in "
    "float64 and are scaled by a correctly rounded power of ten, which "
    "can be an ULP off the correctly rounded parse.  Off by default, as "
    "in the reference").boolean_conf(False)
CAST_STRING_TO_TIMESTAMP = conf(
    "spark.rapids.tpu.sql.castStringToTimestamp.enabled").doc(
    "Cast string->date/timestamp on the device (K16): ISO "
    "'YYYY[-MM[-DD]][ T]HH[:MM[:SS[.ffffff]]]' in UTC, malformed -> "
    "NULL.  Off by default, as in the reference").boolean_conf(False)

# --- whole-stage fusion (plan/fusion.py, exec/fused.py) -----------------
FUSION_ENABLED = conf("spark.rapids.tpu.sql.fusion.enabled").doc(
    "Collapse maximal chains of row-local device execs (Project, "
    "Filter) into one fused segment whose one generated CUDA kernel "
    "composes the members' expressions and defers every filter's "
    "compaction to one at segment exit; results are bit-identical to the "
    "unfused plan").boolean_conf(True)
FUSION_MAX_SEGMENT_EXECS = conf(
    "spark.rapids.tpu.sql.fusion.maxSegmentExecs").doc(
    "Upper bound on member execs per fused segment; a longer row-local "
    "chain is split into several segments").int_conf(16)

# --- test hooks -----------------------------------------------------------
TEST_ENABLED = conf("spark.rapids.tpu.sql.test.enabled").doc(
    "Test mode: fail if any operator is not converted to the device"
).boolean_conf(False)
TEST_ALLOWED_NON_TPU = conf("spark.rapids.tpu.sql.test.allowedNonTpu").doc(
    "Comma-separated operator class names permitted to stay off the "
    "device when test mode is on").string_conf("")

# --- debug ----------------------------------------------------------------
EXPLAIN = conf("spark.rapids.tpu.sql.explain").doc(
    "Plan-rewrite explain mode: NONE, ALL, or NOT_ON_TPU").string_conf("NONE")

# --- joins ----------------------------------------------------------------
BROADCAST_THRESHOLD = conf(
    "spark.rapids.tpu.sql.broadcastSizeThreshold").doc(
    "Max estimated build-side bytes for a broadcast hash join; set to 0 "
    "to force shuffled joins").int_conf(10 * 1024 * 1024)

# --- exchange -------------------------------------------------------------
SHUFFLE_PARTITIONS = conf("spark.rapids.tpu.sql.shuffle.partitions").doc(
    "Default number of exchange output partitions").int_conf(8)
SHUFFLE_TARGET_BATCH_ROWS = conf(
    "spark.rapids.tpu.shuffle.targetBatchRows").doc(
    "Exchange inputs coalesce sub-target batches up to this many rows"
).int_conf(32768)
SHUFFLE_MODE = conf("spark.rapids.tpu.shuffle.mode").doc(
    "Exchange data path: device (packed blocks stay on the card), host "
    "(every block staged to host memory; needs the spill tier, not "
    "ported yet) or auto (device while the card has headroom)"
).string_conf("auto")

# --- ML interop (ml/) -----------------------------------------------------
EXPORT_COLUMNAR_RDD = conf("spark.rapids.tpu.sql.exportColumnarRdd").doc(
    "Allow the export of device batches to user code (torch tensors on "
    "the session's device); reference: spark.rapids.sql.exportColumnarRdd"
).boolean_conf(False)


class TpuConf:
    """Immutable view over a key->value dict with typed accessors."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})

    def get(self, entry: ConfEntry):
        return entry.get(self._settings)

    def set(self, key: str, value) -> "TpuConf":
        s = dict(self._settings)
        s[key] = value
        return TpuConf(s)

    @property
    def is_sql_enabled(self) -> bool:
        return self.get(SQL_ENABLED)

    @property
    def is_test_enabled(self) -> bool:
        return self.get(TEST_ENABLED)

    @property
    def allowed_non_tpu(self) -> List[str]:
        raw = self.get(TEST_ALLOWED_NON_TPU)
        return [s.strip() for s in raw.split(",") if s.strip()]

    @property
    def broadcast_threshold(self) -> int:
        return int(self.get(BROADCAST_THRESHOLD))

    @property
    def explain(self) -> str:
        return str(self.get(EXPLAIN)).upper()

    def items(self):
        return self._settings.items()
