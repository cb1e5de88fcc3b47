"""Deadline-guarded collectives between the processes of a query.

Counterpart of ``spark_rapids_tpu/parallel/elastic.py:87-360``, the
guard only.  A peer process that dies or wedges inside a collective
blocks every surviving process, since a ``torch.distributed`` collective
has no deadline of its own shorter than its process group's.  Every
cross-process collective of ``parallel/`` therefore runs through
``guarded_call``: with a deadline installed
(``spark.rapids.tpu.fault.peer.collectiveTimeoutMs``, per query by
``multiprocess.run_distributed_mp``) the dispatch runs on an abandonable
daemon thread, and a deadline that passes, an error of the collective
(a peer's sockets closed) or an epoch bumped by another dispatch
(``abort_collectives``) raises ``TpuPeerLost``.  With no deadline the
dispatch is a direct call, and an error of the collective still raises
``TpuPeerLost``.  ``guarded_allgather`` gathers one picklable value from
every process; each dispatch's wall is billed to the shuffle's
``collectiveTimeNs`` and counted in ``processCollectives``.

Left out, each for a later slice (ROADMAP A step 9): the heartbeat ledger
(``:139 HeartbeatLedger``; only the deadline detects a lost peer here),
straggler speculation (``:366-569``), ``reexecute_on_shrunken_mesh``
(``:570``), cancellation polling (``scheduler/``) and the telemetry
event of a lost peer (``telemetry/``).
"""
from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from typing import Callable, List, Optional

from ..fault.errors import TpuPeerLost

log = logging.getLogger(__name__)

#: the guard's poll tick (seconds)
_TICK_S = 0.05

_state_lock = threading.Lock()
_epoch = 0
_deadline_ms = 0


def collective_epoch() -> int:
    """The current collective epoch; a guarded dispatch aborts when it
    changes while the dispatch runs."""
    return _epoch


def abort_collectives(reason: str = "peer lost") -> int:
    """Bump the epoch: every guarded dispatch in flight in this process
    raises ``TpuPeerLost`` at its next tick.  Returns the new epoch."""
    global _epoch
    with _state_lock:
        _epoch += 1
        new = _epoch
    log.warning("aborting in-flight collectives (epoch -> %d): %s", new,
                reason)
    return new


def install_collective_deadline(ms: int) -> int:
    """Install the per-query collective deadline; returns the previous
    one, for the caller to restore."""
    global _deadline_ms
    with _state_lock:
        prev = _deadline_ms
        _deadline_ms = max(0, int(ms or 0))
    return prev


def installed_collective_deadline() -> int:
    return _deadline_ms


def _declare_peer_lost(site: str, reason: str, cause=None) -> None:
    abort_collectives(reason)
    raise TpuPeerLost(reason, site=site) from cause


def guarded_call(fn: Callable, *, site: str = "shuffle.collective",
                 timeout_ms: Optional[int] = None):
    """Run one collective dispatch ``fn()`` under the guard (see the
    module docstring) and return its value."""
    tmo = installed_collective_deadline() if timeout_ms is None \
        else timeout_ms
    if not tmo or tmo <= 0:
        try:
            return fn()
        except TpuPeerLost:
            raise
        except RuntimeError as e:  # torch.distributed's errors
            _declare_peer_lost(site, f"collective failed (at {site}): {e}",
                               e)
    box: "_queue.Queue" = _queue.Queue(maxsize=1)
    epoch0 = collective_epoch()

    def dispatch():
        try:
            box.put(("ok", fn()))
        except BaseException as e:  # noqa: BLE001 — handed to the caller
            box.put(("err", e))

    threading.Thread(target=dispatch, daemon=True,
                     name="elastic-collective").start()
    deadline = time.monotonic() + tmo / 1000.0
    while True:
        try:
            kind, val = box.get(timeout=_TICK_S)
        except _queue.Empty:
            if collective_epoch() != epoch0:
                # another dispatch declared the loss; this one unwinds
                raise TpuPeerLost(
                    f"collective aborted by epoch bump (at {site})",
                    site=site) from None
            if time.monotonic() >= deadline:
                _declare_peer_lost(
                    site, f"collective exceeded fault.peer."
                    f"collectiveTimeoutMs={tmo}ms (at {site}); abandoning "
                    "the wedged dispatch")
            continue
        if kind == "err":
            if isinstance(val, RuntimeError) and \
                    not isinstance(val, TpuPeerLost):
                _declare_peer_lost(
                    site, f"collective failed (at {site}): {val}", val)
            raise val
        return val


def guarded_allgather(value, group=None, *,
                      site: str = "shuffle.collective",
                      timeout_ms: Optional[int] = None) -> List:
    """Every process's ``value`` (picklable), in rank order, through
    ``torch.distributed.all_gather_object`` (its pickled bytes counted as
    sent)."""
    import pickle

    import torch.distributed as dist

    from ..shuffle.device_shuffle import collective_timer

    def dispatch():
        out = [None] * dist.get_world_size(group)
        with collective_timer(len(pickle.dumps(value)), process=True):
            dist.all_gather_object(out, value, group=group)
        return out

    return guarded_call(dispatch, site=site, timeout_ms=timeout_ms)
