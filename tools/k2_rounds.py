"""K2's tile size on the card: the committed ``csrc/segment_ids.cu``
(``rounds_for`` picks 1, 2 or 8 rounds of 1,024 rows a tile from n) and
copies of it with the rounds forced to 1, 2 and 8, built with nvcc,
each checked against ``segment_ids_plain`` 10 times and timed behind a
spin (20 back-to-back calls, CUDA events, ms a call) at 1 to 33,554,432
rows of two one-byte string keys and a padding mask (Q1's key shape);
then K25 (``split_by_bucket``, K10's split) against
``partition_split_plain`` at 2,097,152 rows with 2 and 64 buckets and
at 5,000 rows with 7, 10 runs each.  Run on a machine with a CUDA card:

    python3 tools/k2_rounds.py

Prints one line a size and ``FAILS <n>``; exits 1 if any call differs.
"""
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from spark_rapids_tpu_torch.ops.kernels import _build as B
from spark_rapids_tpu_torch.ops.kernels import segment as S
from spark_rapids_tpu_torch.shuffle import device_shuffle as DS
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.data.column import DeviceBatch, DeviceColumn

dev = torch.device("cuda")
t0 = time.time()
out = B.build_all()
print(f"build_all {time.time() - t0:.1f} s", flush=True)
lines = (out / "build.log").read_text().splitlines()
for i, line in enumerate(lines):
    if "Compiling entry function" in line and "segment_ids" in line:
        print("\n".join(l.strip() for l in lines[i:i + 4]), flush=True)

src = (B.CSRC / "segment_ids.cu").read_text()
RULE = "const int rounds = rounds_for(n);"
assert RULE in src
nvcc = B._nvcc()
tmp = tempfile.mkdtemp()
for f in B.CSRC.iterdir():
    if f.suffix == ".cuh":
        shutil.copy(f, tmp)


class K:
    """A ``Kernels`` stand-in that launches one variant library."""

    def __init__(self, lib):
        self.lib = lib

    def library(self, _name):
        return self.lib

    def stream(self, _t):
        return torch.cuda.current_stream().cuda_stream


libs = {"rule": B.CUDA}
procs = {}
for r in (1, 2, 8):
    cu = os.path.join(tmp, f"r{r}.cu")
    open(cu, "w").write(src.replace(RULE, f"const int rounds = {r};"))
    so = os.path.join(tmp, f"libr{r}.so")
    procs[r] = (so, subprocess.Popen([nvcc, *B.NVCC_FLAGS, "-I", tmp, "-o", so, cu],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
for r, (so, p) in procs.items():
    txt, _ = p.communicate()
    if p.returncode:
        print(f"r{r} build failed", txt[-1500:], flush=True)
        continue
    lib = ctypes.CDLL(so)
    fn = lib.k2_segment_ids
    fn.argtypes = B.KERNELS["segment_ids"][1]["k2_segment_ids"][0]
    fn.restype = ctypes.c_int
    libs[f"r{r}"] = K(lib)


def keys_for(n, seed):
    rng = np.random.default_rng(seed)
    g = np.sort(rng.integers(0, max(2, n // 2000), n))
    ks = []
    for shift in (0, 1):
        d = torch.from_numpy(((g // (1 + shift) + shift) % 3 + 65).astype(np.uint8).reshape(n, 1))
        ks.append(DeviceColumn(T.STRING, d.to(dev), torch.ones(n, dtype=torch.bool, device=dev),
                               torch.ones(n, dtype=torch.int32, device=dev)))
    pad = (torch.arange(n) < max(n - 300, 1)).to(dev)
    return ks, pad


fails = 0
for n in (1, 5000, 16384, 131072, 524288, 1081421, 2097152, 4194304, 8388608, 33554432):
    ks, pad = keys_for(n, n)
    want = S.segment_ids_plain(ks, pad)
    row = []
    for name, kern in libs.items():
        ok = all(torch.equal(S.segment_ids_device(ks, pad, kernels=kern), want) for _ in range(10))
        fails += not ok
        fn = lambda: S.segment_ids_device(ks, pad, kernels=kern)
        for _ in range(3): fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(20): fn()
        b.record(); b.synchronize()
        row.append(f"{name} {a.elapsed_time(b) / 20:.4f}{'' if ok else ' DIFFERS'}")
    print(f"K2 n={n}: " + ", ".join(row), flush=True)

# K25 through split_by_bucket (K10's split), grace-like: two bigint columns
for n, m in ((1 << 21, 2), (1 << 21, 64), (5000, 7)):
    rng = np.random.default_rng(m)
    real = n - 1000
    cols = []
    for _ in range(2):
        v = torch.from_numpy(rng.random(n) > 0.1)
        v[real:] = False
        cols.append(DeviceColumn(T.INT64, torch.from_numpy(rng.integers(-2**40, 2**40, n)), v))
    schema = T.Schema([T.Field(f"c{i}", c.dtype) for i, c in enumerate(cols)])
    hb = DeviceBatch(schema, cols, torch.tensor(real, dtype=torch.int32))
    pids = torch.from_numpy(rng.integers(0, m, n).astype(np.int32))
    o, c, _s = DS.partition_order_plain(pids, hb.num_rows, m)
    want = DS.partition_split_plain(hb, o, c.tolist())
    db = DeviceBatch(schema, [DeviceColumn(x.dtype, x.data.to(dev), x.validity.to(dev)) for x in cols],
                     hb.num_rows.to(dev))
    ok = True
    for _ in range(10):
        DS.SPLIT_LAUNCHES.reset()
        parts, counts = DS.split_by_bucket(db, pids.to(dev), m)
        ok = ok and counts == c.tolist() and DS.SPLIT_LAUNCHES.count == 1
        for g, w in zip(parts, want):
            ok = ok and (g is None) == (w is None)
            if w is not None:
                ok = ok and int(g.num_rows) == int(w.num_rows) and all(
                    torch.equal(gc.data.cpu(), wc.data) and torch.equal(gc.validity.cpu(), wc.validity)
                    for gc, wc in zip(g.columns, w.columns))
    fails += not ok
    print(f"K25 split_by_bucket n={n} m={m}: equal={ok}", flush=True)
print("FAILS", fails, flush=True)
sys.exit(1 if fails else 0)
