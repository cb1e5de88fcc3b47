"""The mesh a distributed query runs over.

Counterpart of ``spark_rapids_tpu/parallel/mesh.py:DATA_AXIS`` and
``make_mesh``.  A mesh is a list of ``torch.device``s, one a shard, on
one 1-D axis (``dp``): a SQL engine has data-parallel partitions and
repartitioning exchanges, no other axes.

``make_mesh(n)`` takes the first ``n`` CUDA devices and raises where
there are fewer.  ``make_mesh(n, device="cpu")`` or ``device="cuda"``
puts all ``n`` shards on that one device: the counterpart of the
reference's ``--xla_force_host_platform_device_count`` simulation, which
is how the tests run several shards on the CPU and how one card runs
several.

A mesh may span processes (``multiprocess.init_multiprocess``): each
shard then has an ``owners`` entry, the rank of the process that holds
its rows, and ``owned_shards(rank)`` lists a process's shards in global
order.  Ranks own contiguous runs of shards in rank order, the
reference's rule (``multiprocess.py:110``: shards of devices sorted by
id, a process's devices together), so that concatenating the processes'
shards in rank order gives global shard order.  A mesh built by
``make_mesh`` belongs to one process (every owner 0).
``surviving_devices`` and ``make_shrunken_mesh`` come with the rest of
the elastic layer (ROADMAP A step 9); ``shard_batch_arrays`` and
``replicate`` place stacked arrays for shard_map, which the port does
not use.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

DATA_AXIS = "dp"


class Mesh:
    """``devices``: one ``torch.device`` a shard (shards may share one);
    ``axis_names``: the one data axis; ``owners``: the rank of the
    process holding each shard (default: all 0)."""

    def __init__(self, devices: Sequence[torch.device],
                 axis_names: Sequence[str] = (DATA_AXIS,),
                 owners: Optional[Sequence[int]] = None):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: List[torch.device] = list(devices)
        self.axis_names = tuple(axis_names)
        self.owners: List[int] = [0] * len(self.devices) if owners is None \
            else [int(o) for o in owners]
        if len(self.owners) != len(self.devices):
            raise ValueError(f"{len(self.owners)} owners for "
                             f"{len(self.devices)} shards")
        if self.owners != sorted(self.owners):
            raise ValueError(f"processes own contiguous runs of shards in "
                             f"rank order, not {self.owners}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def num_processes(self) -> int:
        return max(self.owners) + 1

    def owned_shards(self, rank: int) -> List[int]:
        """The shards process ``rank`` holds, in global order."""
        return [s for s, o in enumerate(self.owners) if o == rank]

    def __repr__(self):  # pragma: no cover
        return f"Mesh({self.devices}, {self.axis_names}, {self.owners})"


def _pinned(device) -> torch.device:
    """``cuda`` with the current device's index, so that every shard of
    a shared card compares equal to its tensors' device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS,
              device=None) -> Mesh:
    """A 1-D mesh: over the first ``n_devices`` CUDA devices (all of them
    when None), or, with ``device``, ``n_devices`` shards (default 1) on
    that one device."""
    if device is not None:
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        return Mesh([_pinned(device)] * n, (axis_name,))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n < 1 or have < n:
        raise ValueError(
            f"need {max(n, 1)} CUDA devices, have {have} (pass device='cpu' "
            "or device='cuda' to run several shards on one device)")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis_name,))
