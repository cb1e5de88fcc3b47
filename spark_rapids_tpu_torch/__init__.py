"""spark_rapids_tpu_torch — the PyTorch/CUDA port of spark_rapids_tpu.

The same DataFrame API and plan shapes as the JAX package, on torch
tensors; the device primitives of the sort-based group-by are
hand-written CUDA kernels for Hopper (``csrc/``).  Entry point::

    from spark_rapids_tpu_torch import Session, f
    sess = Session()                    # cuda; Session(device="cpu") for tests
    df = sess.create_dataframe({"k": [...], "v": [...]})
    df.group_by("k").agg(f.sum("v").alias("s")).collect()

This package imports torch and numpy, never jax or spark_rapids_tpu.
"""
from . import types
from .plan import functions as f
from .session import Session

__all__ = ["Session", "f", "types"]
