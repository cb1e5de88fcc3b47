"""Typed faults of the distributed runner.

Counterpart of ``spark_rapids_tpu/fault/errors.py`` (``:16``, ``:51``,
``:58``), cut to the classes the multi-process path raises:
``TpuPeerLost`` (``parallel/elastic.py``'s guarded collectives) and
``TpuStageTimeout`` (the leaf drain's ``fault.stageTimeoutMs``), under
their base ``TpuFaultError``.  Left out with the rest of the fault layer
(ROADMAP A10): ``TpuPayloadCorruption`` (CRC32C checks),
``TpuStageCrash`` (stage re-execution) and ``TpuStorageExhausted`` (the
spill tier).  Imports nothing of the engine.
"""
from __future__ import annotations


class TpuFaultError(RuntimeError):
    """Base of every typed distributed fault; ``site`` names the place
    that raised it (e.g. ``shuffle.collective``)."""

    def __init__(self, *args, site: str = "", injected: bool = False):
        super().__init__(*args)
        self.site = site
        #: True when raised by a fault injector rather than a real fault
        #: (the port has no injector yet: always False)
        self.injected = injected


class TpuStageTimeout(TpuFaultError):
    """A unit of work (the multi-process leaf drain) did not finish within
    ``spark.rapids.tpu.fault.stageTimeoutMs``."""


class TpuPeerLost(TpuFaultError):
    """A peer process died, or a collective failed or made no progress
    within ``spark.rapids.tpu.fault.peer.collectiveTimeoutMs``.  Not
    retryable in place: a peer that is gone would wedge the retry in the
    same collective."""
