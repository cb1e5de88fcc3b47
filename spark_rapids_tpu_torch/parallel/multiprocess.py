"""Distributed execution over several OS processes.

Counterpart of ``spark_rapids_tpu/parallel/multiprocess.py``: the
executor model of the RAPIDS shuffle, one process per GPU, with shuffle
data moving between processes.  Every process calls
``init_multiprocess``, which joins a ``torch.distributed`` process group
and returns the global mesh: ``local_shards`` shards a process, owned by
the processes in rank order (``mesh.owners``).  Every process then runs
the same plan through ``run_distributed_mp`` and gets the whole result.

``MultiProcessRunner`` is the single-process ``DistributedRunner`` on
this process's shards (``local``), with ``ProcessGroupTransport``
(``collective.py``) moving rows between processes.  Host control flow
runs on every process, so every decision comes from values all of them
share: each agreement is K27's max over the owned shards' statistics
(``ops/kernels/retile.py``), all-reduced with MAX and read back once
(``ProcessGroupTransport.agree``):

* ``_run_leaf``: a process drains only the leaf partitions ``p`` with
  ``p % n`` one of its shards (``:118``; ``drained`` lists them), one
  after another as the single-process runner drains them; a drain with
  partitions left once ``fault.stageTimeoutMs`` has passed raises
  ``TpuStageTimeout`` (its peers then lose it at their next collective);
  a source with fewer partitions than shards is read whole by every
  process and dealt as the single-process runner deals it.  ``_place_owned`` agrees
  on the bucket of the largest shard and the string widths (``:209``) and
  uploads the owned shards only.
* ``_agreed_widths`` and ``_all_samples``: a range exchange's string key
  widths and every shard's samples, so that every process computes the
  same bounds.
* ``_retile`` (B.28, ``:342``): after each stage, the bucket of the
  largest shard of any process (K27's max, ``:348``), and every owned
  shard padded past it cut to it in one copy (K27's trim, ``:358``).
* ``_collect_output`` (``:389``): every process's host rows, gathered in
  shard order, so every process returns the whole result.

A keyless final aggregate over rows gathered to shard 0 runs on the
process holding shard 0 (ROADMAP C.13, as in the single-process runner).
A run never resumes mid-query (the reference's ``_try_resume_stage``
returns None, ``:369``; the port's runner has no stage resume at all).

``init_multiprocess`` picks ``gloo`` on the CPU and where the processes
share a card (each process keeps its shards' tensors on ``cuda:0``; gloo
then moves the bytes between processes through host memory) and
``nccl`` where each process has a card of its own.

Left out, each listed in ROADMAP A step 9: event ship-back (``:404``),
the fault budget and ``recovery=`` checkpoints, the heartbeat ledger and
the shrunken-mesh rung (a ``TpuPeerLost`` is raised, not recovered),
straggler speculation, the leaf drain's thread pool (``sql.taskThreads``;
a process drains its partitions one after another, as the single-process
runner does) and the host round-trip checksum.
"""
from __future__ import annotations

import time
from datetime import timedelta
from typing import Dict, List, Optional

import torch

from ..data.column import DeviceBatch, HostBatch, HostColumn, \
    device_to_host_many
from .mesh import DATA_AXIS, Mesh
from .runner import DistributedRunner

def init_multiprocess(coordinator: str, num_processes: int,
                      process_id: int, device=None,
                      backend: Optional[str] = None, local_shards: int = 1,
                      conf: Optional[dict] = None) -> Mesh:
    """Join the job at ``coordinator`` (``host:port``, where rank 0
    listens) as process ``process_id`` of ``num_processes`` and return the
    global mesh: ``local_shards`` shards a process, in rank order.
    ``device`` ``"cpu"`` keeps every shard on the CPU (gloo); else (the
    default) a card: ``cuda:<rank>`` with NCCL where there are as many
    cards as processes, otherwise ``cuda:0`` shared over gloo.  ``backend``
    overrides the choice.  ``conf``'s
    ``spark.rapids.tpu.fault.peer.collectiveTimeoutMs``, where set, is the
    process group's timeout."""
    import torch.distributed as dist

    from ..config import FAULT_PEER_COLLECTIVE_TIMEOUT_MS, TpuConf

    if not 0 <= process_id < num_processes:
        raise ValueError(f"process {process_id} of {num_processes}")
    if local_shards < 1:
        raise ValueError(f"a process holds at least one shard, not "
                         f"{local_shards}")
    kind = torch.device(device or "cuda").type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multiprocess: CUDA is not available "
                               "(pass device='cpu' to run on the CPU)")
        own = torch.cuda.device_count() >= num_processes
        cards = [torch.device("cuda", r if own else 0)
                 for r in range(num_processes)]
        backend = backend or ("nccl" if own else "gloo")
        torch.cuda.set_device(cards[process_id])
    elif kind == "cpu":
        cards = [torch.device("cpu")] * num_processes
        backend = backend or "gloo"
    else:
        raise ValueError(f"no multi-process runner on {kind}")
    timeout_ms = TpuConf(conf).get(FAULT_PEER_COLLECTIVE_TIMEOUT_MS)
    extra = {"timeout": timedelta(milliseconds=timeout_ms)} \
        if timeout_ms else {}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            **extra)
    return Mesh([cards[r] for r in range(num_processes)
                 for _ in range(local_shards)], (DATA_AXIS,),
                [r for r in range(num_processes)
                 for _ in range(local_shards)])


class MultiProcessRunner(DistributedRunner):
    """``DistributedRunner`` on this process's shards of a mesh that spans
    processes (see the module docstring); ``transport`` is a
    ``ProcessGroupTransport``."""

    def __init__(self, mesh, transport, min_bucket_rows: int = 128):
        super().__init__(mesh, min_bucket_rows, transport)
        self.local = self._owned_shards()
        #: the leaf partitions this process drained, leaf by leaf
        self.drained: List[List[int]] = []

    def _owned_shards(self) -> List[int]:
        return self.mesh.owned_shards(self.transport.rank)

    # ---------------- leaves: per-process split ownership --------------
    def _run_leaf(self, node, ctx) -> List[DeviceBatch]:
        from ..config import FAULT_STAGE_TIMEOUT_MS
        from ..plan.physical import _empty_batch

        n_parts, drain = self._leaf_source(node, ctx)
        if n_parts < self.n:
            # a small source: every process reads it whole and deals it
            # as the single-process runner does
            shards = self._deal([drain(p) for p in range(n_parts)],
                                node.schema)
            return self._stack_host([shards[s] for s in self.local],
                                    self.local, self._host_layout(shards))
        owned = set(self.local)
        my_pids = [p for p in range(n_parts) if p % self.n in owned]
        self.drained.append(my_pids)
        per_pid = self._drain(my_pids, drain,
                              ctx.conf.get(FAULT_STAGE_TIMEOUT_MS))
        lists: Dict[int, List[HostBatch]] = {s: [] for s in self.local}
        for pid, bs in zip(my_pids, per_pid):
            lists[pid % self.n].extend(b for b in bs if b.num_rows)
        # a shard's one batch is taken as it is, with no host copy
        shards = {s: (_empty_batch(node.schema) if not bs else bs[0]
                      if len(bs) == 1 else HostBatch.concat(bs))
                  for s, bs in lists.items()}
        return self._place_owned(shards, node.schema)

    @staticmethod
    def _drain(pids: List[int], drain,
               deadline_ms: int = 0) -> List[List[HostBatch]]:
        """The partitions' host batches, one partition after another;
        ``TpuStageTimeout`` once ``deadline_ms`` (0: none) has passed with
        partitions left."""
        from ..fault.errors import TpuStageTimeout

        t0 = time.monotonic()
        out = []
        for p in pids:
            if deadline_ms and (time.monotonic() - t0) * 1e3 > deadline_ms:
                raise TpuStageTimeout(
                    f"multiprocess leaf drain exceeded fault.stageTimeoutMs="
                    f"{deadline_ms}ms ({len(out)}/{len(pids)} partitions "
                    "done)", site="leaf.drain")
            out.append(drain(p))
        return out

    def _place_owned(self, shards: Dict[int, HostBatch],
                     schema) -> List[DeviceBatch]:
        """The owned shards on their device at the bucket of the largest
        shard of any process and every string column at its widest width
        over every process (K27's agreement: the only traffic between
        processes a leaf costs)."""
        from ..ops.kernels.retile import Stat

        str_cols = [i for i, f in enumerate(schema) if f.dtype.is_string]
        stats = [Stat(s, shards[s].num_rows) for s in self.local]
        stats += [Stat(self.n + j, max(shards[s].columns[i].data.shape[1]
                                       for s in self.local))
                  for j, i in enumerate(str_cols)]
        agreed = self.transport.agree(stats, self.n + len(str_cols), self.n)
        widths: List[Optional[int]] = [None] * len(schema)
        for j, i in enumerate(str_cols):
            widths[i] = int(agreed[self.n + j])
        return self._stack_host([shards[s] for s in self.local], self.local,
                                (int(agreed[-1]), widths))

    # ---------------- range bounds ------------------------------------
    def _agreed_widths(self, widths: List[int]) -> List[int]:
        from ..ops.kernels.retile import Stat

        if not widths:
            return widths
        agreed = self.transport.agree(
            [Stat(j, w) for j, w in enumerate(widths)], len(widths),
            len(widths))
        return [int(w) for w in agreed[:len(widths)]]

    def _all_samples(self, samples: List[torch.Tensor]):
        from . import exchange as X

        mine = X.to_host(samples)
        return [h for part in self.transport.gather_objects(mine)
                for h in part]

    # ---------------- B.28 --------------------------------------------
    def _retile(self, out: List[DeviceBatch]) -> List[DeviceBatch]:
        """K27: the bucket of the largest shard of any process, and every
        owned shard padded past it cut to it in one copy (skipped where no
        shard is)."""
        from ..ops.kernels.retile import Stat, retile_trim

        agreed = self.transport.agree(
            [Stat(s, b.num_rows) for s, b in zip(self.local, out)], self.n,
            self.n)
        need = int(agreed[-1])
        if all(b.padded_rows <= need for b in out):
            return out
        return retile_trim(out, need)

    # ---------------- the result --------------------------------------
    def _collect_output(self, out: List[DeviceBatch], stages) -> HostBatch:
        """Every process's shards downloaded and gathered in shard order
        (each column's arrays, rebuilt on this process's schema)."""
        from ..plan.physical import _empty_batch

        mine = [[(c.data, c.validity, c.lengths) for c in h.columns]
                for h in device_to_host_many(out)]
        schema = self._schema_of(stages[-1].root)
        host = [HostBatch(schema, [HostColumn(f.dtype, *arrays)
                                   for f, arrays in zip(schema, cols)])
                for part in self.transport.gather_objects(mine)
                for cols in part]
        host = [h for h in host if h.num_rows]
        if not host:
            return _empty_batch(schema)
        return HostBatch.concat(host)


def run_distributed_mp(session, df, mesh) -> HostBatch:
    """Run ``df`` over ``mesh`` (``init_multiprocess``'s), called by every
    process with the same plan and data; every process returns the whole
    result.  The transport is the one ``shuffle.transport.class`` names
    (``collective.make_transport``; by default ``ProcessGroupTransport``).  The per-query
    collective deadline (``fault.peer.collectiveTimeoutMs``) is installed
    for the run; a lost peer raises ``TpuPeerLost``.  Afterwards
    ``session.last_metrics`` holds the run's metrics and ``shuffle.*``
    counters (``collectiveTimeNs``, ``processCollectives``,
    ``processBytesSent``, ``hostStagedBytes``), ``session.last_placements``
    one record a collective and ``session.last_drained`` the leaf
    partitions this process drained."""
    from ..config import FAULT_PEER_COLLECTIVE_TIMEOUT_MS
    from ..plan.physical import ExecContext
    from ..shuffle.device_shuffle import GLOBAL as shuffle_stats
    from . import elastic
    from .collective import make_transport

    wrong = [d for d in mesh.devices if d.type != session.device.type]
    if wrong:
        raise ValueError(f"a session on {session.device} cannot run over "
                         f"mesh devices {wrong}")
    phys = session.physical_plan(df.plan)
    ctx = ExecContext(session.conf, session.device)
    transport = make_transport(session.conf, mesh, across_processes=True)
    runner = MultiProcessRunner(mesh, transport)
    prev = elastic.install_collective_deadline(
        session.conf.get(FAULT_PEER_COLLECTIVE_TIMEOUT_MS))
    mark = shuffle_stats.counters()
    try:
        return runner.run(phys, ctx)
    finally:
        elastic.install_collective_deadline(prev)
        session.last_metrics = dict(ctx.metrics)
        session.last_metrics.update(shuffle_stats.metrics_since(mark))
        session.last_placements = list(transport.records)
        session.last_drained = list(runner.drained)
