"""Exchange transports: the data path between a mesh's shards.

Counterpart of ``spark_rapids_tpu/parallel/collective.py``.  The port
has one transport, ``DeviceCollectiveTransport``, which takes every
shard's batch at once
(``exchange.py``): a tile slice whose source and destination share a
device is joined by a device copy (``torch.cat``), one for another device
is sent with ``Tensor.to(device, non_blocking=True)``, and each
destination then compacts with K4.  No shard is moved to the host.  The
multi-process transport over ``torch.distributed`` (NCCL on the card)
comes with ``multiprocess.py`` (ROADMAP A11); the reference's
``spark.rapids.tpu.shuffle.transport.class``, which picks a transport by
reflection, is read once there is a second one to pick.
"""
from __future__ import annotations

from typing import List

import torch

from ..data.column import DeviceBatch
from ..shuffle.device_shuffle import collective_timer
from . import exchange as X


class DeviceCollectiveTransport:
    """All-to-all and all-gather between the shards of ``mesh``.  Each
    call appends its row placement to ``records`` (``label``, the
    capacity, the rows each shard sent and got, and ``bytes_swapped``:
    the bytes moved between shards, all shards together) and its wall to
    ``collectiveTimeNs``."""

    def __init__(self, mesh, min_bucket_rows: int = 128):
        self.mesh = mesh
        self.min_bucket = min_bucket_rows
        self.records: List[dict] = []

    def exchange(self, batches: List[DeviceBatch],
                 pids: List[torch.Tensor], num_parts: int,
                 capacity: int = 0, label: str = "exchange"
                 ) -> List[DeviceBatch]:
        """Repartition the shards' rows by ``pids``."""
        rec = {"exchange": label}
        with collective_timer():
            out = X.collective_exchange(batches, pids, num_parts,
                                        self.mesh.devices, capacity,
                                        self.min_bucket, rec)
        self.records.append(rec)
        return out

    def replicate(self, batches: List[DeviceBatch],
                  label: str = "replicate") -> List[DeviceBatch]:
        """Every shard's rows on every shard."""
        rec = {"exchange": label}
        with collective_timer():
            out = X.gather_replicate(batches, self.mesh.devices,
                                     self.min_bucket, rec)
        self.records.append(rec)
        return out

