"""Drive the PyTorch/CUDA engine's main path on one NVIDIA card.

    python3 chip_smoke.py

1. builds the hand-written kernels (spark_rapids_tpu_torch/csrc/*.cu, one
   nvcc per source, in parallel) and prints the build time;
2. runs TPC-H Q1 and Q6 over lineitem at SF1 (6,000,000 rows, one
   partition) through ``Session()`` on ``cuda``, each query with every
   kernel launch count set to 0 just before it and read just after it,
   checks the rows against an independent numpy computation (floats to
   rel 1e-9), checks that each aggregate received one batch and that Q1
   launched every kernel (K1–K4) and Q6 the kernels of its plan (K3, K4),
   and times cold and warm runs;
3. calls each kernel's wrapper at the main path's shapes (8,388,608 padded
   rows; a 2,097,152-row reader batch for the filter's compaction) and
   holds it against its plain PyTorch version on the same card tensors —
   exact, or rel 1e-9 for float sums — timing kernel, plain version and
   one PyTorch library call with CUDA events (median of runs after warm-up);
4. prints the card's name and power limit, a ``kernels`` JSON line and,
   last, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  Without CUDA it exits with 2 and
prints no result.
"""
from __future__ import annotations

import datetime as dt
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): memory rate; float64
# outside the tensor cores; float32 outside the tensor cores, which stands
# in for the 32-bit integer work of the sort, scan and gather kernels
HBM_BYTES_PER_S = 3.35e12
FP64_PER_S = 34e12
FP32_PER_S = 67e12
SF = 1.0
SEED = 42
READER_ROWS = 1 << 21      # spark.rapids.tpu.sql.reader.batchSizeRows


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn`` between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def log_ptxas_summary(build_log: str) -> None:
    """One line per compiled kernel: registers, shared memory, spills."""
    name, spills = None, ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name, spills = line.split("'")[1], ""
        elif "spill stores" in line:
            spills = line.strip()
        elif ": Used " in line and name is not None:
            print(f"ptxas {name}: {line.split(':', 1)[1].strip()}; "
                  f"{spills}", file=sys.stderr)
            name = None


def profile_query(q, run) -> None:
    """Device busy time of one warm run under torch.profiler: the sum of
    device time over kernels and copies, the idle share of the wall, and
    the top entries by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    rows = []  # device-side entries only (kernels, copies, memsets)
    for e in prof.key_averages():
        dev_us = e.self_device_time_total
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"Q{q} profile: the profiler saw no device activity; device "
            "time not measured")
        return
    log(f"Q{q} profile (one warm run, profiler on): wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.2f} ms, idle "
        f"share {1 - busy / wall_us:.3f}")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


# --------------------------------------------------------------------------
# independent numpy reference for Q1 and Q6
# --------------------------------------------------------------------------
def _days(y, m, d):
    return (dt.date(y, m, d) - dt.date(1970, 1, 1)).days


def numpy_q1(hb):
    c = {f.name: col for f, col in zip(hb.schema, hb.columns)}
    keep = c["l_shipdate"].data <= _days(1998, 9, 2)
    qty = c["l_quantity"].data[keep]
    price = c["l_extendedprice"].data[keep]
    disc = c["l_discount"].data[keep]
    tax = c["l_tax"].data[keep]
    rf = c["l_returnflag"].data[keep, 0]
    ls = c["l_linestatus"].data[keep, 0]
    rows = []
    for code in sorted(set((rf.astype(np.int64) * 256 + ls).tolist())):
        g = (rf.astype(np.int64) * 256 + ls) == code
        n = int(g.sum())
        dp = price[g] * (1.0 - disc[g])
        rows.append((chr(code // 256), chr(code % 256),
                     float(np.sum(qty[g])), float(np.sum(price[g])),
                     float(np.sum(dp)), float(np.sum(dp * (1.0 + tax[g]))),
                     float(np.sum(qty[g])) / n, float(np.sum(price[g])) / n,
                     float(np.sum(disc[g])) / n, n))
    return rows


def numpy_q6(hb):
    c = {f.name: col for f, col in zip(hb.schema, hb.columns)}
    sd, disc = c["l_shipdate"].data, c["l_discount"].data
    keep = ((sd >= _days(1994, 1, 1)) & (sd < _days(1995, 1, 1))
            & (disc >= 0.05) & (disc <= 0.07) & (c["l_quantity"].data < 24.0))
    return [(float(np.sum(c["l_extendedprice"].data[keep] * disc[keep])),)]


def check_rows(got, want, what):
    require(len(got) == len(want), f"{what}: {len(got)} rows, want "
            f"{len(want)}")
    for g, w in zip(got, want):
        require(len(g) == len(w), f"{what}: row width")
        for a, b in zip(g, w):
            if isinstance(b, float):
                require(abs(a - b) <= 1e-9 * abs(b),
                        f"{what}: {a!r} vs numpy {b!r}")
            else:
                require(a == b, f"{what}: {a!r} vs numpy {b!r}")


# --------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2

    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
    from spark_rapids_tpu_torch.data.column import (DeviceColumn,
                                                    host_to_device)
    from spark_rapids_tpu_torch.ops.kernels import _build
    from spark_rapids_tpu_torch.ops.kernels import gather as G
    from spark_rapids_tpu_torch.ops.kernels import segment as S

    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    out_dir = _build.build_all()
    _build.CUDA.library("sort")  # loads every library
    log(f"kernel build: {time.perf_counter() - t0:.1f} s ({out_dir})")
    log_ptxas_summary((out_dir / "build.log").read_text())

    # ---- 2. main path -----------------------------------------------------
    t0 = time.perf_counter()
    hb = tpch_datagen.lineitem(sf=SF, seed=SEED)
    log(f"lineitem SF{SF:g}: {hb.num_rows} rows generated in "
        f"{time.perf_counter() - t0:.1f} s")
    sess = Session()
    torch.zeros(1, device=sess.device)  # CUDA context outside the timings
    tables = {"lineitem": sess.create_dataframe(hb, n_partitions=1)}
    counters = {"K1": [S.SORT_LAUNCHES], "K2": [S.SEGMENT_IDS_LAUNCHES],
                "K3": [S.SEGMENT_REDUCE_LAUNCHES],
                "K4": [G.GATHER_LAUNCHES, G.COMPACT_LAUNCHES]}
    all_counters = [c for cs in counters.values() for c in cs]
    # the wrappers each query's plan reaches: Q6 has no group keys, so no
    # sort, no segment ids and no gather by a sort permutation
    must_launch = {1: all_counters,
                   6: [S.SEGMENT_REDUCE_LAUNCHES, G.COMPACT_LAUNCHES]}
    want = {1: numpy_q1(hb), 6: numpy_q6(hb)}

    cold = {}
    results = {}
    launches = {}  # query -> kernel -> CUDA kernels launched in its run
    for q in (1, 6):
        torch.cuda.synchronize()
        for c in all_counters:
            c.reset()
        t0 = time.perf_counter()
        results[q] = tpch.QUERIES[q](tables).collect()
        cold[q] = time.perf_counter() - t0
        launches[q] = {k: sum(c.count for c in cs)
                       for k, cs in counters.items()}
        by_wrapper = {c.name: c.count for c in all_counters}
        log(f"Q{q} launches: {launches[q]} {by_wrapper}")
        for c in must_launch[q]:
            require(c.count > 0, f"Q{q}: wrapper {c.name} launched no "
                    "kernel")
        require(sess.last_metrics.get(
            "TpuHashAggregateExec[partial].numInputBatches") == 1,
            f"Q{q}: the partial aggregate did not receive exactly one "
            f"batch: {sess.last_metrics}")
    for q in (1, 6):
        check_rows(results[q], want[q], f"Q{q}")
        log(f"Q{q} rows match numpy: {results[q]}")
    warm = {}
    for q in (1, 6):
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tpch.QUERIES[q](tables).collect()
            runs.append(time.perf_counter() - t0)
        warm[q] = statistics.median(runs)
        log(f"Q{q} SF{SF:g} wall: cold {cold[q] * 1e3:.1f} ms, warm "
            f"{warm[q] * 1e3:.1f} ms (median of 3) on {card}")

    for q in (1, 6):
        profile_query(q, lambda: tpch.QUERIES[q](tables).collect())

    # ---- 3. kernels against their plain versions --------------------------
    dev = sess.device
    db = host_to_device(hb, 128, dev)          # 8,388,608 padded rows
    P = db.padded_rows
    cols = {f.name: c for f, c in zip(db.schema, db.columns)}
    keep = (cols["l_shipdate"].data <= _days(1998, 9, 2)) & \
        cols["l_shipdate"].validity
    fb = G.compact(db, keep)                   # the partial agg's input
    rm = fb.row_mask()
    fcols = {f.name: c for f, c in zip(fb.schema, fb.columns)}
    keys = [DeviceColumn(c.dtype, c.data, c.validity & rm, c.lengths)
            for c in (fcols["l_returnflag"], fcols["l_linestatus"])]
    entries = []

    def entry(name, source, replaces, kernel_ms, plain_ms, lib_ms,
              moved_bytes, ops, ops_per_s, err):
        bound_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
        bound_ops = ops / ops_per_s * 1e3
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[1][name[:2]],
             "launches_by_query": {f"q{q}": launches[q][name[:2]]
                                   for q in (1, 6)},
             "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
             "bound_ms": max(bound_bytes, bound_ops),
             "bound_by": "bytes" if bound_bytes >= bound_ops
             else "operations",
             "library_ms": lib_ms}
        entries.append(e)
        log(f"{name}: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"library {lib_ms if lib_ms is None else round(lib_ms, 3)} ms, "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
            f"max_abs_err {err}")

    # K1: Q1's keys (2 one-byte strings + padding) -> 5 passes
    perm = S.lexsort_device(keys, pad_valid=rm)
    ref = S.lexsort_plain(keys, pad_valid=rm)
    require(torch.equal(perm, ref), "K1 differs from its plain version")
    packed = ((~rm).to(torch.int64) << 40) | (
        keys[0].validity.to(torch.int64) << 32) | (
        keys[0].data[:, 0].to(torch.int64) << 16) | (
        keys[1].validity.to(torch.int64) << 8) | \
        keys[1].data[:, 0].to(torch.int64)
    entry("K1 sort_permutation", "spark_rapids_tpu_torch/csrc/sort.cu",
          "spark_rapids_tpu/ops/kernels/segment.py:313",
          cuda_ms(lambda: S.lexsort_device(keys, pad_valid=rm)),
          cuda_ms(lambda: S.lexsort_plain(keys, pad_valid=rm)),
          cuda_ms(lambda: torch.sort(packed, stable=True)),
          nbytes(rm, perm) + sum(nbytes(k.data, k.validity) for k in keys),
          P * 5, FP32_PER_S, 0.0)

    # K2: segment ids of the sorted keys
    sorted_keys = [G.gather_column(k, perm) for k in keys]
    pad_sorted = G.gather_array(rm, perm)
    ids = S.segment_ids_device(sorted_keys, pad_valid=pad_sorted)
    require(torch.equal(ids, S.segment_ids_plain(sorted_keys, pad_sorted)),
            "K2 differs from its plain version")
    change = torch.ones(P, dtype=torch.int32, device=dev)
    entry("K2 segment_ids", "spark_rapids_tpu_torch/csrc/segment_ids.cu",
          "spark_rapids_tpu/ops/kernels/segment.py:335",
          cuda_ms(lambda: S.segment_ids_device(sorted_keys, pad_sorted)),
          cuda_ms(lambda: S.segment_ids_plain(sorted_keys, pad_sorted)),
          cuda_ms(lambda: torch.cumsum(change, 0, dtype=torch.int32)),
          nbytes(pad_sorted, ids) + sum(
              nbytes(k.data, k.validity, k.lengths) for k in sorted_keys),
          P * 2, FP32_PER_S, 0.0)

    # K3: sum of l_extendedprice per segment (float64), count, min, starts
    price = G.gather_array(fcols["l_extendedprice"].data, perm)
    pvalid = G.gather_array(fcols["l_extendedprice"].validity & rm, perm)
    got_sum, got_cnt = S.segment_aggregate(price, pvalid, ids, P, "sum")
    ref_sum, ref_cnt = S.segment_aggregate_plain(price, pvalid, ids, P,
                                                 "sum")
    require(torch.equal(got_cnt, ref_cnt), "K3 counts differ")
    err = float((got_sum - ref_sum).abs().max())
    require(torch.allclose(got_sum, ref_sum, rtol=1e-9, atol=0),
            f"K3 float sums differ beyond rel 1e-9 (max abs {err})")
    for op in ("min", "max"):
        g, _ = S.segment_aggregate(price, pvalid, ids, P, op)
        r, _ = S.segment_aggregate_plain(price, pvalid, ids, P, op)
        require(torch.equal(g, r), f"K3 {op} differs")
    require(torch.equal(
        S.segment_min_index(ids, P),
        S.segment_aggregate_plain(None, None, ids, P, "min")[0]),
        "K3 segment starts differ")
    n_seg = int(ids[P - 1]) + 1
    lengths = torch.bincount(ids.to(torch.int64), minlength=n_seg)
    masked = torch.where(pvalid, price, torch.zeros_like(price))
    entry("K3 segment_reduce",
          "spark_rapids_tpu_torch/csrc/segment_reduce.cu",
          "spark_rapids_tpu/ops/kernels/segment.py:397",
          cuda_ms(lambda: S.segment_aggregate(price, pvalid, ids, P, "sum")),
          cuda_ms(lambda: S.segment_aggregate_plain(price, pvalid, ids, P,
                                                    "sum")),
          cuda_ms(lambda: torch.segment_reduce(masked, "sum",
                                               lengths=lengths)),
          nbytes(price, pvalid, ids, got_sum, got_cnt), P, FP64_PER_S, err)

    # K4: compaction of one reader batch by Q1's filter, gather at P
    rb = host_to_device(hb.slice(0, READER_ROWS), 128, dev)
    rcols = {f.name: c for f, c in zip(rb.schema, rb.columns)}
    rkeep = (rcols["l_shipdate"].data <= _days(1998, 9, 2)) & \
        rcols["l_shipdate"].validity
    got = G.compact(rb, rkeep)
    ref = G.compact_plain(rb, rkeep)
    require(torch.equal(got.num_rows, ref.num_rows), "K4 row count differs")
    for g, r in zip(got.columns, ref.columns):
        require(torch.equal(g.data, r.data) and
                torch.equal(g.validity, r.validity) and
                (g.lengths is None or torch.equal(g.lengths, r.lengths)),
                f"K4 compact differs in a {g.dtype} column")
    gathered = G.gather_column(fcols["l_extendedprice"], perm, rm)
    plain_g = G.gather_column_plain(fcols["l_extendedprice"], perm, rm)
    require(torch.equal(gathered.data, plain_g.data) and
            torch.equal(gathered.validity, plain_g.validity),
            "K4 gather differs")
    arrays = [a for c in rb.columns for a in (c.data, c.validity, c.lengths)
              if a is not None]
    entry("K4 compact+gather", "spark_rapids_tpu_torch/csrc/gather.cu",
          "spark_rapids_tpu/ops/kernels/gather.py:33",
          cuda_ms(lambda: G.compact(rb, rkeep)),
          cuda_ms(lambda: G.compact_plain(rb, rkeep)),
          cuda_ms(lambda: [a[rkeep] for a in arrays]),
          nbytes(rkeep, *arrays) * 2 - nbytes(rkeep), rb.padded_rows,
          FP32_PER_S, 0.0)

    log(f"timings: CUDA events, median of 10 after 2 warm-up runs, inputs "
        f"warm in L2 where they fit; card {card}")
    print(json.dumps({"queries": {f"q{q}": {"cold_s": cold[q],
                                            "warm_s": warm[q]}
                                  for q in (1, 6)},
                      "sf": SF, "rows": hb.num_rows, "padded_rows": P}))
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
