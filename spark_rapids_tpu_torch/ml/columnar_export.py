"""The device export behind ``ml``.

Counterpart of ``spark_rapids_tpu/ml/columnar_export.py``: the executed
plan's final device stage is peeled off its ``DeviceToHostExec`` and its
``DeviceBatch``es are handed to the caller on the device
(``export_device_batches``); ``to_feature_matrix`` stacks their numeric
columns into one float32 tensor on K26 (``ops/kernels/export.py``), its
plain PyTorch version only for CPU tensors; ``from_device_batches`` is the
reverse path.  Left out: the reference's telemetry (``finish_query``) and
its exec lock, which the port's session does not have; the metrics,
placements and joins of the export's execution are kept on the session
as ``execute`` keeps them.
"""
from __future__ import annotations

from typing import List

from ..data.column import DeviceBatch, HostBatch, device_to_host_many, \
    host_to_device
from ..exec.transitions import DeviceToHostExec
from ..ops.kernels import export as K
from ..plan import logical as L


def export_device_batches(session, plan: L.LogicalPlan) -> List[DeviceBatch]:
    """Execute ``plan`` and return the final stage's device batches in
    partition order, without downloading them (the reference peels
    GpuColumnarToRowExec off the executed plan the same way)."""
    root, ctx = session.prepare_execution(plan)
    try:
        phys = root
        while isinstance(phys, DeviceToHostExec):
            phys = phys.children[0]
        data = phys.execute_columnar(ctx) \
            if hasattr(phys, "execute_columnar") else phys.execute(ctx)
        out: List[DeviceBatch] = []
        for pid in range(data.n_partitions):
            for b in data.iterator(pid):
                if isinstance(b, HostBatch):  # a plan with no device stage
                    b = host_to_device(b, device=session.device)
                out.append(b)
        return out
    finally:
        session.finish_execution(ctx)


def to_feature_matrix(batches: List[DeviceBatch], columns=None):
    """The exported batches' numeric and bool columns (or ``columns``)
    as one float32 ``[rows, features]`` tensor, the XGBoost/NN hand-off
    shape.  Padding rows and rows with a null in any selected column are
    dropped (device storage zero-fills invalid lanes; exporting them as
    0.0 would fabricate data)."""
    if not batches:
        raise ValueError("no batches to export")
    schema = batches[0].schema
    names = columns or [f.name for f in schema
                        if f.dtype.is_numeric or f.dtype.is_bool]
    return K.feature_matrix(batches, names)


def from_device_batches(session, batches: List[DeviceBatch]):
    """Reverse path: device batches -> DataFrame (reference:
    GpuExternalRowToColumnConverter, the RDD[Row] -> batches
    direction)."""
    if not batches:
        raise ValueError("no batches")
    return session.create_dataframe(
        HostBatch.concat(device_to_host_many(batches)))
