"""Build, load and call the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``.
The build happens at first use, from the sources in the checkout alone,
into ``csrc/build/<hash of the sources and flags>/`` (listed in
``.gitignore``), so an edited kernel rebuilds.  The sources compile in
parallel, one ``nvcc`` process each.

Generated sources (K12's fused segments, ``ops/kernels/fused.py``) take
a second route: ``build_generated`` compiles each into
``csrc/build/k12-<hash of the source, the flags and the headers>/``,
all missing ones in parallel, and skips one whose library is there
already, so a library built by one process serves the next.  Every
build uses ``-fmad=false``: no multiply-add contraction, so float
expressions round as their plain versions do.

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
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
#: headers a generated source includes (their text is part of its key)
GENERATED_HEADERS = ("common.cuh", "strings.cuh", "pow10.cuh")

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
    "string_search": ("string_search.cu", {
        "k13_search": ([P, P, I, Q, P, I, I, P, P, P], 1),
    }),
    "string_transform": ("string_transform.cu", {
        "k15_substring": ([P, P, I, Q, I, I, I, P, P, P], 1),
        "k18_concat": ([P, P, P, P, I, Q, I, P, P, P], 1),
        "k20_trim": ([P, P, I, Q, I, I, I, P, P, P, P], 2),
        "k20_substring_index": ([P, P, I, Q, I, I, I, P, P, P, P], 2),
    }),
    "string_case": ("string_case.cu", {
        "k19_case_map": ([P, P, I, Q, I, P, P], 1),
        "k19_length": ([P, P, I, Q, P, P], 1),
    }),
    "string_replace": ("string_replace.cu", {
        "k21_replace": ([P, P, I, Q, I, P, I, I, P, P, P], 1),
    }),
    "cast_parse": ("cast_parse.cu", {
        "k16_trim": ([P, P, I, Q, P, P, P], 1),
        "k16_parse_int": ([P, P, P, I, Q, P, P, P], 1),
        "k16_parse_bool": ([P, P, P, I, Q, P, P, P], 1),
        "k16_parse_float": ([P, P, P, I, Q, P, P, P], 1),
        "k16_parse_date": ([P, P, P, I, Q, P, P, P], 1),
        "k16_parse_timestamp": ([P, P, P, I, Q, P, P, P], 1),
    }),
    "cast_format": ("cast_format.cu", {
        "k17_format_int": ([P, P, Q, P, P, P], 1),
        "k17_format_bool": ([P, P, Q, P, P, P], 1),
        "k17_format_date": ([P, P, Q, P, P, P], 1),
        "k17_format_timestamp": ([P, P, Q, P, P, P], 1),
    }),
    "hashing": ("hashing.cu", {
        # no launch for an empty batch
        "k9_murmur3": ([P, I, Q, Q, I, P, P, P], 1),
    }),
    "shuffle": ("shuffle.cu", {
        "k10_build": ([P, P, Q, I, P, P, P, P, P], 3),
        "k10_counts_wide": ([P, P, Q, I, P, P, P, P], 2),
        "k10_slice": ([P, I, Q, Q, Q, P], 1),
        "k24_tiles": ([P, I, Q, P, P, P, I, Q, P, P], 1),
    }),
    "bucket": ("bucket.cu", {
        "k25_bucket_split": ([P, I, I, Q, P, P], 1),
    }),
    "retile": ("retile.cu", {
        "k27_retile_max": ([P, I, I, I, Q, P, P], 1),
        "k27_retile_trim": ([P, I, Q, P], 1),
    }),
    "feature_matrix": ("feature_matrix.cu", {
        "k26_count": ([P, I, Q, P, P, P, P], 2),
        "k26_write": ([P, I, Q, P, P, P, P], 1),
    }),
    "range_partition": ("range_partition.cu", {
        "k11_range_pids": ([P, I, Q, P, I, P, P], 1),
    }),
    "generate": ("generate.cu", {
        "k22_explode": ([P, I, I, Q, P, P], 1),
    }),
    "expand": ("expand.cu", {
        "k23_expand": ([P, I, Q, P, P], 1),
    }),
    "window": ("window.cu", {
        "k14_bounds": ([P, P, P, P, Q, P, P, P, P, P], 3),
        "k14_rank": ([I, P, P, P, P, P, Q, P, P, P], 1),
        "k14_prefix": ([P, I, P, P, P, Q, P, P, P, P], 3),
        "k14_frame_sum": ([I, P, P, I, P, P, P, P, Q, Q, Q, I, P, P, P], 1),
        "k14_seg_scan": ([P, I, P, P, P, P, Q, I, I, P, P, P, P], 3),
        "k14_masked": ([P, I, P, P, P, Q, I, P, P], 1),
        "k14_sparse_level": ([P, P, I, Q, Q, I, P], 1),
        "k14_frame_minmax": ([I, P, I, I, I, P, P, P, P, P, Q, Q, Q, I, P,
                              P, P], 1),
        "k14_frame_pick": ([I, I, P, I, P, P, P, P, P, P, Q, Q, Q, I, P, P,
                            P], 1),
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


def generated_key(source: str) -> str:
    """The build key of a generated source: a hash of it, the flags and
    the headers it includes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in GENERATED_HEADERS:
        h.update((CSRC / name).read_bytes())
    h.update(source.encode())
    return h.hexdigest()[:16]


def build_generated(sources: Dict[str, str]) -> Dict[str, Path]:
    """Compile generated sources (key -> source text; each exports
    ``k12_segment``) whose library is not built yet, all at once, each
    into ``csrc/build/k12-<key>/libk12.so``; returns key -> library."""
    out = {key: BUILD_ROOT / f"k12-{key}" / "libk12.so" for key in sources}
    todo = [key for key in sources if not out[key].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = []
    for key in todo:
        d = out[key].parent
        d.mkdir(parents=True, exist_ok=True)
        src = d / f"k12.{os.getpid()}.cu"
        src.write_text(sources[key])
        tmp = d / f"libk12.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((key, src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for key, src, tmp, proc in procs:
        text, _ = proc.communicate()
        (src.parent / "build.log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"== {key} (rc {proc.returncode})\n{text}")
        else:
            os.replace(src, src.parent / "k12.cu")
            os.replace(tmp, out[key])
    if failed:
        raise RuntimeError("nvcc failed for generated sources:\n"
                           + "\n".join(failed))
    return out


def load_generated(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.k12_segment.argtypes = [P, P, P]
    lib.k12_segment.restype = ctypes.c_int
    return lib


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
    ``build_all`` (generated sources with ``build_generated``) at first
    use and launches on the tensor's current CUDA stream.  A wrapper's
    ``kernels=`` argument takes another instance (libraries built
    elsewhere from the same sources) for tensors of any device."""

    def __init__(self, build: Callable[[], Path],
                 stream: Callable[[torch.Tensor], Optional[int]],
                 build_generated: Callable[[Dict[str, str]],
                                           Dict[str, Path]] = build_generated):
        self._build = build
        self._stream = stream
        self._build_generated = build_generated
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.generated_libs: Dict[str, ctypes.CDLL] = {}

    def library(self, name: str) -> ctypes.CDLL:
        if not self.libs:
            self.libs = load_libraries(self._build())
        return self.libs[name]

    def prepare(self, sources: Dict[str, str]) -> None:
        """Build (in parallel) and load the generated sources (key ->
        text) that are not loaded yet."""
        todo = {k: s for k, s in sources.items()
                if k not in self.generated_libs}
        if todo:
            for key, path in self._build_generated(todo).items():
                self.generated_libs[key] = load_generated(path)

    def generated(self, key: str, source: str) -> ctypes.CDLL:
        self.prepare({key: source})
        return self.generated_libs[key]

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


def device_table(words, device: torch.device) -> torch.Tensor:
    """A kernel's table of int64 words on ``device``, sent from pinned
    memory with a non-blocking copy where that is a CUDA device."""
    t = torch.tensor(list(words), dtype=torch.int64)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


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
