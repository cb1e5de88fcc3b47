"""ML interop: a DataFrame's result handed to a model as device tensors.

Counterpart of ``spark_rapids_tpu/ml/__init__.py`` (the reference's
ColumnarRdd export for XGBoost-style consumers)::

    from spark_rapids_tpu_torch import ml
    batches = ml.columnar_batches(df)       # List[DeviceBatch] on the card
    X = ml.feature_matrix(df)               # float32 torch.Tensor [rows, k]
    df2 = ml.from_device_batches(sess, bs)  # the reverse path

The result is a ``torch.Tensor`` on the session's device where the
reference returns a jax array; a consumer that needs DLPack takes it
through ``torch.utils.dlpack.to_dlpack``.  Requires
``spark.rapids.tpu.sql.exportColumnarRdd=true`` on the session, as the
reference does.
"""
from __future__ import annotations

from typing import List, Optional

from ..data.column import DeviceBatch
from .columnar_export import from_device_batches, to_feature_matrix


def columnar_batches(df) -> List[DeviceBatch]:
    """Execute ``df`` and return its result as device batches, without a
    copy to the host."""
    return df.session.execute_columnar(df.plan)


def feature_matrix(df, columns: Optional[List[str]] = None):
    """Execute ``df`` and stack its numeric and bool columns (or
    ``columns``) into one float32 ``[rows, features]`` tensor on the
    session's device (K26 on CUDA)."""
    return to_feature_matrix(columnar_batches(df), columns)


__all__ = ["columnar_batches", "feature_matrix", "from_device_batches",
           "to_feature_matrix"]
