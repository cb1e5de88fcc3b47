"""Exchange transports: the data path between a mesh's shards.

Counterpart of ``spark_rapids_tpu/parallel/collective.py``.  Two
transports share one interface (``exchange``, ``replicate`` and
``records``: per call its label, the capacity, the rows each shard sent
and got, and ``bytes_swapped``):

* ``DeviceCollectiveTransport`` takes every shard's batch at once, in
  one process (``exchange.py:collective_exchange``, ``gather_replicate``):
  a tile slice whose source and destination share a device is joined by a
  device copy, one for another device is sent with ``Tensor.to(device,
  non_blocking=True)``, and each destination then compacts with K4.
* ``ProcessGroupTransport`` takes this process's shards of a mesh whose
  shards belong to several processes (``multiprocess.py``) and moves rows
  between the processes of a ``torch.distributed`` group
  (``exchange.py:process_exchange``, ``process_replicate``).  Every
  decision comes from ``agree``: K27's max over the owned shards'
  statistics, all-reduced with MAX across the processes and read back
  once.  Its collectives run through ``elastic.guarded_call``.  With the
  gloo backend and tensors on a card, gloo works on host tensors: the
  transport stages every buffer a collective sends or receives through
  pinned host memory itself and counts those bytes (``hostStagedBytes``);
  so where processes share one card, the bytes between them cross host
  memory.  With NCCL (a card a process) the tensors stay on the card.

``make_transport(conf, mesh, across_processes)`` instantiates the class
that ``spark.rapids.tpu.shuffle.transport.class`` names, by reflection,
as the reference's ``collective.py:45`` does; the key's default, the
reference's ``IciCollectiveTransport``, names the transport the runner
needs.
"""
from __future__ import annotations

import importlib
from typing import List, Sequence

import numpy as np
import torch

from ..data.column import DeviceBatch
from ..shuffle.device_shuffle import GLOBAL as shuffle_stats
from ..shuffle.device_shuffle import collective_timer
from . import exchange as X


class DeviceCollectiveTransport:
    """All-to-all and all-gather between the shards of ``mesh``, in one
    process.  Each call appends its row placement to ``records`` and its
    wall to ``collectiveTimeNs``."""

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


class ProcessGroupTransport:
    """All-to-all and all-gather between the processes of a
    ``torch.distributed`` group (the default group unless ``group``), each
    call over this process's shards of ``mesh`` (``mesh.owners``).  Every
    process must make the same calls in the same order.  Records as
    ``DeviceCollectiveTransport``'s, over every shard of every process,
    ``bytes_swapped`` the bytes that crossed between processes, plus
    ``process_bytes_sent`` (this process's)."""

    def __init__(self, mesh, min_bucket_rows: int = 128, group=None):
        import torch.distributed as dist

        self.mesh = mesh
        self.min_bucket = min_bucket_rows
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        if mesh.num_processes != self.world:
            raise ValueError(f"the mesh's shards belong to "
                             f"{mesh.num_processes} processes, the group "
                             f"has {self.world}")
        self.owned = mesh.owned_shards(self.rank)
        if not self.owned:
            raise ValueError(f"process {self.rank} holds no shard of "
                             f"{mesh}")
        self.device = mesh.devices[self.owned[0]]
        # gloo takes host tensors: stage a card's buffers through host
        # memory here, where the bytes are counted
        self.staged = dist.get_backend(group) == "gloo" and \
            self.device.type == "cuda"
        self.records: List[dict] = []

    # ---- the guarded collectives ----------------------------------------
    def _call(self, fn, bytes_sent: int, site: str):
        from .elastic import guarded_call

        def dispatch():
            with collective_timer(bytes_sent, process=True):
                return fn()

        return guarded_call(dispatch, site=site)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        shuffle_stats.add("hostStagedBytes", host.numel()
                          * host.element_size())
        return host

    def agree(self, stats, k: int, n_bucket: int) -> np.ndarray:
        """K27: the max of ``stats`` (``ops/kernels/retile.Stat``s of the
        owned shards) over every process, ``k + 1`` int64 words, the last
        the bucket of the max of the first ``n_bucket``; one all-reduce and
        one read back."""
        import torch.distributed as dist

        from ..ops.kernels.retile import retile_max

        buf = retile_max(stats, k, n_bucket, self.min_bucket, self.device)
        if self.device.type == "cuda" and not self.staged:
            self._call(lambda: dist.all_reduce(buf, op=dist.ReduceOp.MAX,
                                               group=self.group),
                       buf.numel() * 8, "retile.max")
            return buf.cpu().numpy()
        host = self._to_host(buf)  # the one read back
        self._call(lambda: dist.all_reduce(host, op=dist.ReduceOp.MAX,
                                           group=self.group),
                   host.numel() * 8, "retile.max")
        return host.numpy()

    def all_to_all(self, send: torch.Tensor, send_rows: Sequence[int],
                   recv_rows: Sequence[int]) -> torch.Tensor:
        """One ``all_to_all_single`` of the rows of a 2-D uint8 matrix:
        ``send_rows[r]`` rows to process ``r`` (in order), ``recv_rows[r]``
        from it; returns the received rows on this process's device."""
        import torch.distributed as dist

        width = send.shape[1]
        recv = torch.empty((sum(recv_rows), width), dtype=send.dtype,
                           device="cpu" if self.staged else send.device,
                           pin_memory=self.staged)
        src = self._to_host(send)
        self._call(lambda: dist.all_to_all_single(
            recv, src, list(recv_rows), list(send_rows), group=self.group),
            sum(send_rows) * width, "shuffle.alltoall")
        if not self.staged:
            return recv
        shuffle_stats.add("hostStagedBytes", recv.numel())
        return recv.to(self.device, non_blocking=True)

    def gather_objects(self, value) -> List:
        """Every process's picklable ``value``, in rank order."""
        from .elastic import guarded_allgather

        return guarded_allgather(value, self.group, site="collect.gather")

    # ---- the transport interface ----------------------------------------
    def exchange(self, batches: List[DeviceBatch],
                 pids: List[torch.Tensor], num_parts: int,
                 capacity: int = 0, label: str = "exchange"
                 ) -> List[DeviceBatch]:
        """Repartition the rows of every process's shards by ``pids``
        (this process's shards' ids); returns this process's shards."""
        rec = {"exchange": label}
        out = X.process_exchange(batches, pids, num_parts, self.mesh.owners,
                                 self.rank, self, capacity, self.min_bucket,
                                 rec)
        self.records.append(rec)
        return out

    def replicate(self, batches: List[DeviceBatch],
                  label: str = "replicate") -> List[DeviceBatch]:
        """Every shard's rows of every process on this process's shards."""
        rec = {"exchange": label}
        out = X.process_replicate(batches, self.mesh.owners, self.rank,
                                  self, self.min_bucket, rec)
        self.records.append(rec)
        return out


#: the reference's transport (its default: ICI collectives), which names
#: whichever of the port's transports the runner needs
REFERENCE_TRANSPORT = \
    "spark_rapids_tpu.parallel.collective.IciCollectiveTransport"


def make_transport(conf, mesh, across_processes: bool = False):
    """The transport ``spark.rapids.tpu.shuffle.transport.class`` names,
    instantiated by reflection with ``mesh``.  The reference's transport
    (the key's default) takes the one the runner needs:
    ``ProcessGroupTransport`` for ``run_distributed_mp``
    (``across_processes``), else ``DeviceCollectiveTransport``.  An
    unknown module or class, or a transport of this module that does not
    fit the runner, raises ValueError."""
    from ..config import SHUFFLE_TRANSPORT_CLASS

    path = conf.get(SHUFFLE_TRANSPORT_CLASS)
    if path == REFERENCE_TRANSPORT:
        path = f"{__name__}." + ("ProcessGroupTransport" if across_processes
                                 else "DeviceCollectiveTransport")
    elif path.split(".")[0] == "spark_rapids_tpu":
        raise ValueError(f"spark.rapids.tpu.shuffle.transport.class="
                         f"{path!r} names a class of the reference package, "
                         "which has no counterpart here")
    module, _, cls_name = path.rpartition(".")
    try:
        cls = getattr(importlib.import_module(module), cls_name)
    except (ImportError, AttributeError, ValueError) as e:
        raise ValueError(f"spark.rapids.tpu.shuffle.transport.class={path!r}"
                         f" names no class: {e}") from e
    fits = {DeviceCollectiveTransport: False, ProcessGroupTransport: True}
    if cls in fits and fits[cls] != across_processes:
        raise ValueError(
            f"spark.rapids.tpu.shuffle.transport.class={path!r} moves rows "
            + ("between processes: run_distributed_mp takes it"
               if fits[cls] else "within one process: run_distributed "
               "takes it"))
    return cls(mesh)
