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
several.  ``surviving_devices`` and ``make_shrunken_mesh`` come with the
elastic layer (ROADMAP A11); ``shard_batch_arrays`` and ``replicate``
place stacked arrays for shard_map, which the port does not use.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

DATA_AXIS = "dp"


class Mesh:
    """``devices``: one ``torch.device`` a shard (shards may share one);
    ``axis_names``: the one data axis."""

    def __init__(self, devices: Sequence[torch.device],
                 axis_names: Sequence[str] = (DATA_AXIS,)):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: List[torch.device] = list(devices)
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):  # pragma: no cover
        return f"Mesh({self.devices}, {self.axis_names})"


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
