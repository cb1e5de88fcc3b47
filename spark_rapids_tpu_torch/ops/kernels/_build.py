"""Build, load and call the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``.
The build happens at first use, from the sources in the checkout alone,
into ``csrc/build/<hash of the sources and flags>/`` (listed in
``.gitignore``), so an edited kernel rebuilds.  The sources compile in
parallel, one ``nvcc`` process each.

Nothing here runs at import time: the CPU tests import every module, on
machines that may have neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
Q = ctypes.c_longlong

#: library name -> (source file, {function: (argtypes, CUDA kernels it
#: launches)}); every function takes the stream last and returns the
#: cudaError of its launches
KERNELS: Dict[str, tuple] = {
    "sort": ("sort.cu", {
        "k1_encode_num": ([P, P, I, Q, I, I, P, P, P], 1),
        "k1_encode_str": ([P, P, I, Q, I, I, P, P, P], 1),
        "k1_encode_pad": ([P, Q, P, P], 1),
        "k1_global_hist": ([P, I, Q, P, P], 1),
        "k1_gather_keys": ([P, P, Q, P, P, P], 1),
        "k1_digit_step": ([P, P, Q, I, P, P, P, P, P], 3),
    }),
    "segment_ids": ("segment_ids.cu", {
        "k2_flags_init": ([P, Q, P, P], 1),
        "k2_flags_num": ([P, P, I, Q, P, P], 1),
        "k2_flags_str": ([P, P, P, I, Q, P, P], 1),
        "k2_scan_ids": ([P, Q, P, P, P], 3),
    }),
    "segment_reduce": ("segment_reduce.cu", {
        # 1 launch (the fill) when there are no rows
        "k3_segment_reduce": ([P, I, P, P, Q, Q, I, P, P, P, P, P, P], 4),
    }),
    "gather": ("gather.cu", {
        "k4_compact_plan": ([P, P, Q, P, P, P, P, P], 4),
        "k4_scatter_rows": ([P, P, Q, I, P, P], 1),
        "k4_scatter_valid": ([P, P, P, Q, P, P], 1),
        "k4_gather_rows": ([P, P, Q, Q, I, P, P], 1),
        "k4_gather_valid": ([P, P, P, Q, Q, P, P], 1),
        "k4_compact_order": ([P, P, Q, P, P, P, P, P, P], 5),
        "k7_gather_side": ([P, I, P, P, P, P, Q, Q, P, P, P, P], 1),
    }),
    "join_probe": ("join_probe.cu", {
        "k5_ok": ([P, P, Q, P, P, Q, I, P, P], 1),
        "k5_concat": ([P, Q, I, P, Q, I, I, P, P], 1),
        "k5_scatter_ids": ([P, P, P, Q, Q, P, P, P], 1),
        "k5_search": ([P, Q, P, Q, P, P, P], 1),
        "k5_has_r": ([P, Q, P, Q, P, P, P], 3),
    }),
    "join_expand": ("join_expand.cu", {
        "k6_emit": ([P, P, Q, P, P, Q, I, I, P, P, P], 1),
        "k6_scan": ([P, Q, P, P, P, P, P], 3),
        "k6_expand": ([P, P, Q, P, P, P, Q, P, P, Q, P, P, P, P], 1),
    }),
    "strings": ("strings.cu", {
        "k8_string_compare": ([P, P, I, I, P, P, I, I, Q, I, P, P], 1),
    }),
    "hashing": ("hashing.cu", {
        # no launch for an empty batch
        "k9_murmur3": ([P, I, Q, I, P, P, P], 1),
    }),
    "shuffle": ("shuffle.cu", {
        "k10_build": ([P, P, Q, I, P, P, P, P, P], 3),
        "k10_counts_wide": ([P, P, Q, I, P, P, P, P], 2),
        "k10_slice": ([P, I, Q, Q, Q, P], 1),
    }),
    "range_partition": ("range_partition.cu", {
        "k11_range_pids": ([P, I, Q, P, I, P, P], 1),
    }),
}
LAUNCHES_PER_CALL = {fn: n for _src, fns in KERNELS.values()
                     for fn, (_args, n) in fns.items()}

#: dtype codes of csrc/common.cuh
DTYPE_CODES = {
    torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
    torch.int64: 4, torch.float32: 5, torch.float64: 6, torch.uint8: 7,
}

TILE = 2048  # rows per tile in the kernels (csrc/common.cuh)


class LaunchCounter:
    """The number of CUDA kernels a wrapper has launched."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self, n: int = 1) -> None:
        self.count += n

    def reset(self) -> None:
        self.count = 0


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def build_all() -> Path:
    """Compile every kernel source that is not built yet, all at once;
    returns the build directory.  ``build.log`` there keeps ptxas's
    register and shared-memory report."""
    out = BUILD_ROOT / source_hash()
    todo = [(name, src) for name, (src, _fns) in KERNELS.items()
            if not (out / f"lib{name}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, src in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for name, tmp, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out / f"lib{name}.so")
    (out / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    return out


def load_libraries(out: Path) -> Dict[str, ctypes.CDLL]:
    """Load ``lib<name>.so`` of every kernel library in ``out`` and
    declare its functions' argument types."""
    libs = {}
    for name, (_src, fns) in KERNELS.items():
        cdll = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, (argtypes, _n) in fns.items():
            f = getattr(cdll, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        libs[name] = cdll
    return libs


class Kernels:
    """The kernel libraries that the wrappers launch and the stream they
    launch on.  ``CUDA`` is the package's one instance: it builds with
    ``build_all`` at first use and launches on the tensor's current CUDA
    stream.  A wrapper's ``kernels=`` argument takes another instance
    (libraries built elsewhere from the same sources) for tensors of any
    device."""

    def __init__(self, build: Callable[[], Path],
                 stream: Callable[[torch.Tensor], Optional[int]]):
        self._build = build
        self._stream = stream
        self.libs: Dict[str, ctypes.CDLL] = {}

    def library(self, name: str) -> ctypes.CDLL:
        if not self.libs:
            self.libs = load_libraries(self._build())
        return self.libs[name]

    def stream(self, t: torch.Tensor) -> Optional[int]:
        return self._stream(t)


CUDA = Kernels(build_all,
               lambda t: torch.cuda.current_stream(t.device).cuda_stream)


def kernels_for(t: torch.Tensor, kernels: Optional[Kernels] = None
                ) -> Optional[Kernels]:
    """The kernels to launch on ``t``: ``kernels`` where given, else
    ``CUDA`` for a CUDA tensor, or None (take the plain version) for a
    CPU tensor."""
    if kernels is not None:
        return kernels
    return CUDA if on_card(t) else None


def ptr(t: Optional[torch.Tensor]):
    """A tensor's device address for ctypes (None passes NULL)."""
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError("kernel arguments must be contiguous")
    return t.data_ptr()


def launch(counter: LaunchCounter, lib: ctypes.CDLL, fn: str, *args,
           launched: Optional[int] = None) -> None:
    """Call the library function ``fn``, raise on a nonzero cudaError,
    and add the CUDA kernels it launched (``launched``, else its
    ``KERNELS`` entry) to ``counter``."""
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"kernel launch {fn} failed: cudaError {rc}")
    counter.add(LAUNCHES_PER_CALL[fn] if launched is None else launched)


def tiles(n: int) -> int:
    return max(1, (n + TILE - 1) // TILE)
