"""Drive the PyTorch/CUDA engine's main paths on one NVIDIA card.

    python3 chip_smoke.py

1. builds the hand-written kernels (spark_rapids_tpu_torch/csrc/*.cu, one
   nvcc per source, in parallel) and prints the build time; then
   generates the fused segments' kernels (K12) of the plans of Q3, Q12,
   Q13 and Q14 at one and two partitions (four distinct sources) and of
   the fifteen later queries at two, builds them in parallel and prints
   that build's seconds on a line of its own;
2. runs TPC-H Q1 and Q6 over lineitem, and Q3, Q4, Q12, Q13 and Q14 over
   customer, orders, lineitem and part, at SF1 (150,000 customers,
   1,500,000 orders, 6,000,000 lines, 200,000 parts; each table with the
   columns its query reads; first one partition) through ``Session()`` on
   ``cuda``, each query with every kernel launch count set to 0 just
   before it and read just after it; checks the rows against an
   independent numpy computation (keys and counts exact, floats to rel
   1e-9; Q3's top 10 and Q13's sort in order), that each aggregate and
   join side received one batch and each fused segment ran once a reader
   batch, that Q3 plans two shuffled
   hash joins and the reference's fused customer segment, and that each
   query launched the kernels of its plan and no others of K8, K12 and
   K13 (Q1: K1–K4, Q6: K3 and K4, Q3: K1–K7 and K12, Q4: K4 and K5, Q12:
   K1–K8 and K12, Q13: K1–K7 and K12, Q14: K1–K7, K12 and K13; K12 in
   none of Q1, Q4 and Q6); runs Q3 once with fusion off (its filter on K8
   again); prints the table sizes after each filter and join, and times
   cold and warm runs.
   Then runs the seven queries over the reference's default of two
   partitions (``create_dataframe``'s default): shuffled joins over 2-way
   Murmur3 hash exchanges, keyed aggregates over 2-way hash exchanges,
   global sorts over 2-way range exchanges.  Each is checked against the
   same numpy answer, each exchange's per-partition row counts are logged
   and must add up to the rows written, K9, K10 and K11 must launch in
   every query but Q6 (a single exchange) and Q14 (a broadcast join and
   no sort, as the reference plans it at SF1),
   and cold, warm and profiled walls are printed beside the one-partition
   ones;
2c. runs TPCx-BB q30 at SF1 (seed 99: 8,000,000 clicks, 100,000 items)
   at one and two partitions, and the clickstream windows (row_number, a
   5-row sum and a 5-row min per user in click order, three window nodes)
   over the 8,000,000 clicks at two partitions, each checked against an
   independent numpy computation (exact: all integers); logs the table
   sizes after q30's join, distinct, self-join and filter, and each
   exchange's per-partition rows; checks that each aggregate, join side
   and window received one batch a partition, that K14 launched in both
   queries and in none of the seven TPC-H queries; times cold, warm and
   profiled runs;
2d. runs the other fifteen TPC-H queries (Q2, Q5, Q7–Q11, Q15–Q22) at
   SF1 (plus 10,000 suppliers, 800,000 partsupp rows, the 25 nations and
   5 regions) at the default two partitions, each against
   ``benchmarks/tpch_oracle.py``'s numpy answer (floats rel 1e-9, the
   unordered queries after sorting) and required to return rows, with
   the table sizes after each filter and join, the launch counts (K1,
   K4, K5 and K12 in every one; no K14, and no K15 while Q22's substring
   runs inside its fused segment), each exchange's per-partition rows,
   the batch metrics, and cold, warm and profiled walls; then Q22 once
   with fusion off, where its substring runs on K15;
2e. the text ingest: lineitem's Q1/Q6 columns and l_orderkey at SF1 as
   dbgen prints them (``tpch_datagen.lineitem_text``, every field a
   string column), cast to TPC-H's types by one ``select``
   (``benchmarks/tpch_text.py``) under the three cast confs, then Q1 and
   Q6 at two partitions and at one (the cast Project fused with each
   query's Filter: K12 launches, K16 stays idle) and at two with fusion
   off (K16 parses, K12 idle), each against ``tpch_oracle``'s answer on
   the typed columns; the cast table read back through
   ``_result_batch()`` (keys, quantities, discounts, taxes and dates
   exact, l_extendedprice within 1 ULP, the 1-ULP rows counted);
2f. the text export: the typed SF1 lineitem formatted and concatenated
   into dbgen's line by one ``select`` (K17 formats, K18 concatenates;
   K12 idle) and again behind a filter on the ship mode (one fused
   segment: K12, K17 and K18 idle), at two partitions and at one, every
   line byte for byte, lengths included, against
   ``tpch_datagen.export_lines``; both with launch counts, table sizes
   and cold, warm and profiled walls;
2g. orders and customer cleaned as text (``benchmarks/tpch_clean.py``,
   under ``CLEAN_CONF``: the cast confs, ``incompatibleOps`` and the
   Upper/Lower keys): ``orders_profile`` over the 1,500,000 orders
   (substring_index, lower, length, locate, trim of a substring, upper
   of a replace, then a group-by with count, avg, sum, string min and
   string max) and ``customer_clean`` over the 150,000 customers (a
   length filter, then substring_index, casts, replace, lower, upper of
   an rtrim of a substring, ltrim of a substring_index, a sort), each at
   two partitions, at one and at two with fusion off, against
   ``tpch_clean``'s Python oracle (strings byte for byte, integers
   exact, avg_len rel 1e-9); logs the sizes after the filter, each
   exchange's per-partition rows (which must add up), the batch metrics
   and the launch counts: customer_clean with fusion on runs its
   expressions inside its K12 segment (K19-K21, K13, K15 and K16 idle);
   orders_profile's lone Project is no segment, so it runs them on
   K19-K21, K13, K15 and K16 in every cell, as customer_clean does with
   fusion off; orders_profile's string min/max launches K1, K3 and K4
   (B.5); cold, warm and profiled walls;
2h. the row-multiplying execs on TPCx-BB's SF1 tables (seed 99):
   TPC-DS q67's rollup (``benchmarks/tpcxbb_rollup.py``: three joins, a
   Project -> Expand of 8 grouping sets, a partial aggregate over ~6.4M
   expanded rows, rank() within i_category, a sort and a limit) at two
   partitions, at one, at two with fusion off (the Expand on K23 instead
   of K12) and at two with ``batchSizeBytes`` 64 MiB (every Expand batch
   reaches the partial aggregate alone: the chunked partial aggregate,
   more than one input batch required; each partition's sort gets a
   slice of each window output and merges them); the store_sales unpivot
   (Project -> Generate with pos: 4,000,000 rows to 12,000,000, grouped
   by store and pos) at two partitions and at two with fusion off (the
   Generate on K22); TPCx-BB q24 (a semi and an anti join, two global
   sums, a union, a sort) at two partitions and at one; each against a
   numpy oracle (``tpcxbb_rollup.ORACLES``, ``tpcxbb.oracle_q24``: keys
   exact, sums rel 1e-9, in order), with launch checks (K12 in the fused
   cells, K22/K23 in the unfused ones and nowhere else), the partial
   aggregate's input batches, placements, and cold, warm and profiled
   walls;
2i. the distributed runner (``parallel/runner.py:run_distributed``): TPC-H
   Q1, Q3, Q5, Q16 and Q18 at SF1 over ``make_mesh(4, device="cuda")``
   (four shards sharing the card) and Q1 and Q5 over ``make_mesh(1)``
   (this machine's real mesh), every table with as many partitions as
   shards, each against ``tpch_oracle``'s answer (in order where the
   query orders), with the launches by kernel (K4, K9, K10, K24 and K1
   required), every collective's rows each shard sent and got, its
   capacity and the bytes moved between shards, all shards together (the
   rows must add up), the number of exchanges and ``collectiveTimeNs``, and cold, warm
   and profiled walls; then one more run of Q3 and Q18 on four shards
   keeping the largest K24 call (a hash exchange of lineitem) for phase 3;
2j. TPC-H at SF10 (``tpch_datagen.draw_all(10.0, 42)``: 60,000,000
   lines, 15,000,000 orders): Q1, Q3, Q6, Q9, Q18 and Q21 at the default
   two partitions and 512 MiB ``batchSizeBytes``, and Q3 and Q21 again at
   64 MiB, each against ``tpch_oracle``'s answer, with cold, warm and
   profiled walls (busy, idle share, H2D copies and ms), the launches,
   the peak device memory and each shuffled join's batches a side,
   bucket pairs, buckets and deepest level (the grace join: every join
   partition whose side brings several batches must take it, some query
   must at 512 MiB and each 64 MiB cell must; these checks raise at the
   end of the script, after the ``kernels`` line); one SF10 reader batch
   of lineitem's Q1 columns uploaded packed (one pinned buffer, one
   copy) and per array, bit for bit, with both calls' event, device and
   host times; the warm runs keep the largest K25 split and seeded K9
   hash of Q21 (of any cell if Q21 took no grace path) for phase 3;
2k. the ML hand-off: the Mortgage ETL (``benchmarks/mortgage.py``) at sf
   50 (5,000,000 loans, 60,000,000 monthly records) at two partitions,
   ``etl`` read back as a host batch and ``summary`` as rows, each
   against the numpy oracles (keys, counts and strings exact, floats rel
   1e-9; the partial aggregate must merge several batches); the same
   ETL under ``exportColumnarRdd``: ``ml.columnar_batches`` (device
   batches on cuda, 5,000,000 rows), ``ml.feature_matrix`` (a
   (5000000, 9) float32 tensor on cuda equal to the oracle's features,
   ``avg_upb`` within 1 ULP, the 1-ULP rows counted), the export's share
   of its wall, the device-to-host bytes of the export (those of the ETL
   to device batches plus one int32 count a batch, under a tenth of a
   download's), the
   round trip through ``from_device_batches``; TPCx-BB q5, q20, q25,
   q26 and q28 at SF1 (seed 99) at two partitions and at one against
   ``tpcxbb.ORACLES``; the feature matrix of q26's result.  Launch
   checks: K26 in the two feature-matrix cells and in no other cell of
   the script, K12 in the Mortgage cells and q20 (q28's CASE WHEN is a
   lone Project, checked in its plan), K1, K3, K4 everywhere and K5 in
   every joining cell; every cell with cold, warm and profiled walls,
   busy and idle share, H2D copies and ms, peak device memory, launches
   and the aggregates' and joins' input batches;
2l. the dynamic-partition Parquet write (``phase_writes``): TPCx-BB
   SF1 store_sales (seed 99, 11 columns, 4,000,000 rows) written at two
   partitions with no ``partition_by`` (W0) and by ``ss_sold_date_sk``
   (W1: 1,825 directories, 3,650 files), and SF10 lineitem (phase 2j's
   draw, the 14 columns the generator draws, 60,000,000 rows) by
   ``l_returnflag`` and ``l_linestatus`` (W2), into a temporary
   directory whose free space is required first; every file read back
   by ``io/parquet.read_file`` (in spawned processes, a row group a task)
   and equal to numpy's answer (``write_oracle``: each partition's rows
   of each key, in input order, under ``partition_dir_name``'s
   directories), ``_SUCCESS`` present, the tracker's rows, files and
   bytes equal to the listing; K1 and K4 (B.26) and no other hand
   kernel launched in W1 and W2, none in W0; the cold wall, then one
   warm run under torch.profiler: its wall (the host clock around the
   write) split into input, sort + download, split, encode and file IO,
   its device busy and idle share and DtoH bytes and ms; files, bytes,
   MB/s, host ms a file, peak device memory; the phase's seconds on a
   line of their own;
2m. the multi-process runner (``parallel/multiprocess.py``), after phase
   2j: two worker processes spawned (``run_multiprocess``; every kernel
   library and every K12 segment of their plans built before), each
   joining a gloo group with ``init_multiprocess(..., device="cuda",
   local_shards=2)`` on ``cuda:0`` and owning two of four shards; M1:
   TPC-H Q1, Q3, Q5, Q16 and Q18 at SF1 on phase 2i's tables (four
   partitions a table), cold and warm (median of 3), each process's rows
   equal to ``tpch_oracle``'s and to phase 2i's four-shard rows; M2: Q3
   and Q18 at SF10 on phase 2j's draw, cold and one warm run, rows equal
   to numpy's.  The tables are staged once as ``.npy`` (``stage_tables``)
   and each worker maps them and uploads only the partitions it drains.
   Per process and cell: walls, the partitions drained (disjoint across
   the processes and covering every leaf), collectives, bytes sent to the
   other process, ``collectiveTimeNs``, host-staged bytes, H2D upload
   bytes, peak device memory and K27's launches (required in every
   worker); a check run of each cell after its timed runs, in which every
   K27 call (each agreement's max, each trim) is held against its plain
   version on the same inputs; which gloo collectives take CUDA tensors;
   a worker that fails, hangs or writes no result fails the run;
3. calls each kernel's wrapper at the main paths' shapes (K1–K3: Q1's
   8,388,608 padded rows; K4: a 2,097,152-row reader batch; K5–K7: the
   inputs of Q3's second join as the run above gave them, K6 for inner
   and full joins; K8: the 150,000-row c_mktsegment matrix against
   'BUILDING'; K9: Q3's lineitem join key, Q3's aggregate keys and Q4's
   priority key; K10: a 2-way build and slice of Q3's filtered lineitem
   batch; K11: Q3's final sort keys — K9–K11 as the two-partition runs
   gave them; K12: Q12's lineitem segment over a 2,097,152-row reader
   batch and Q13's orders segment over 1,500,000 orders; K13: Q14's
   startswith over p_type and contains, endswith and locate_from over
   o_comment; K14: every window function kind over the clickstream at one
   partition, 8,388,608 padded rows, partitioned by user and ordered by
   click date and time; K12 also over Q8's three-member segment (Year,
   the volume, the if_) and Q22's customer segment (Substring, isin) on
   the inputs the main path gave them; K15: Q22's substring of c_phone
   over the customer table and an 8,388,608 x 32-byte matrix with a
   negative start; K16-K18 at the text path's shapes; K12 also over
   customer_clean's segment; K13's locate with one start over o_comment;
   K19-K21 and the string min/max composition (B.5) on the calls phase
   2g's orders_profile at one partition and customer_clean with fusion
   off made; K22 at the unpivot's shape and over item's two string
   columns; K23 at q67's Expand input of one partition; K12 over q67's
   Project -> Expand and the unpivot's Project -> Generate segments;
   K24 at the largest hash exchange of Q3 and of Q18 on four shards, on
   every lane, with its device, event, enqueue, plain and
   ``index_select`` times; K25 and K9 from a grace seed at phase 2j's
   largest Q21 split, with the same times; K26 at the Mortgage feature
   frame's exported batches, bit for bit, with its device time (its
   count and write passes behind a spin), event, enqueue, plain and
   stack-of-casts times, its count and write passes also over the same
   rows as one batch, and bit for bit again on the same batches with
   nulls set at seeded rows of three columns and in every row of one
   batch, so that rows are dropped)
   K27 (the multi-process retile) as phase 2m's workers time it on the
   inputs of their check runs: retile_max at the largest agreement with
   torch.amax of the stacked vectors as yardstick and gloo's all-reduce
   of an agreed vector beside it, retile_trim at the largest trim the
   path made (Q18's cut after its limit) with a clone a buffer,
   and B.26 (the write's sort: K1 + K4) at the first partition's batch
   of W1 and W2, bit for bit, with its event, enqueue, K1 and gather
   (behind a spin) times and argsort + index_select at W1's int64 key)
   and holds it against its plain PyTorch version
   on the same card tensors — exact, or rel 1e-9 for float sums — timing
   kernel,
   plain version and one PyTorch library call with CUDA events (median
   of runs after warm-up; K22's and K23's ``ms`` is their device time,
   the call enqueued behind a spin kernel so that the events leave the
   host's enqueue out, with the plain event time, the enqueue time and
   the profiler's kernel time beside it);
4. prints the card's name and power limit, a ``kernels`` JSON line and,
   last, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  Without CUDA it exits with 2 and
prints no result.
"""
from __future__ import annotations

import collections
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
JOINED = (3, 4, 12, 13, 14)  # the queries over several tables
FUSED = (3, 12, 13, 14)      # the queries the reference fuses a segment in
# the other fifteen TPC-H queries, at the default two partitions
LATER = (2, 5, 7, 8, 9, 10, 11, 15, 16, 17, 18, 19, 20, 21, 22)
BB_SF = 1.0                  # TPCx-BB scale of q30 and the clickstream
BB_SEED = 99                 # the reference generator's default seed
# the row-multiplying path (phase 2h): TPC-DS q67's rollup and the
# store_sales unpivot (benchmarks/tpcxbb_rollup.py), TPCx-BB q24
ROLLUP = ("q67", "store_unpivot", "q24")
#: the chunked partial aggregate's cell: q67 at one partition with this
#: batchSizeBytes, so every Expand batch reaches the aggregate alone
CHUNK_BYTES = 64 << 20
# the distributed runner (phase 2i): these queries over four shards on the
# card, and the (query, shards) cells
DIST = (1, 3, 5, 16, 18)
DIST_CELLS = tuple((q, 4) for q in DIST) + ((1, 1), (5, 1))
# TPC-H at SF10 (phase 2j): these queries at the default two partitions
# and 512 MiB batch target, and the grace cells again at 64 MiB
SF10 = 10.0
SF10_QUERIES = (1, 3, 6, 9, 18, 21)
SF10_CHUNKED = (3, 21)
#: the cells whose largest hash exchange K24 is checked and timed at
DIST_K24 = ((3, 4), (18, 4))
# the multi-process runner (phase 2m): two processes share the card over
# gloo, each owning two of four shards; M1 is phase 2i's queries (DIST) at
# SF1, M2 these at SF10 on phase 2j's draw
MP_PROCESSES = 2
MP_SHARDS = 4
MP_SF10 = (3, 18)
MP_CONF = {"spark.rapids.tpu.fault.peer.collectiveTimeoutMs": 120_000}
MP_TIMEOUT_S = 420
# the ML hand-off (phase 2k): the Mortgage ETL at sf 50 (5,000,000 loans,
# 60,000,000 monthly records) and its export, and TPCx-BB's ML-prep
# queries at BB_SF
MORTGAGE_SF = 50.0
MORTGAGE_SEED = 31
EXPORT_CONF = {"spark.rapids.tpu.sql.exportColumnarRdd": True}
# TPC-H lineitem's columns in the specification's order (phase 2l's W2
# keeps those the generator draws)
LINEITEM_COLUMNS = ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                    "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                    "l_returnflag", "l_linestatus", "l_shipdate",
                    "l_commitdate", "l_receiptdate", "l_shipinstruct",
                    "l_shipmode", "l_comment"]


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


def walk_plan(plan):
    yield plan
    for c in plan.children:
        yield from walk_plan(c)


def profile_query(label, run, dtoh=False):
    """Device busy time of one warm run under torch.profiler: the sum of
    device time over kernels and copies, the idle share of the wall, and
    the top entries by device time.  Returns ``{"wall_ms", "busy_ms",
    "idle_share", "h2d_copies", "h2d_ms"}`` (with ``dtoh``, also
    ``"dtoh_copies", "dtoh_bytes", "dtoh_ms"`` from the same run's
    trace), or None where the profiler saw no device activity."""
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
        events = prof.events()
        log(f"{label} profile: the profiler saw no device activity; device "
            f"time not measured ({len(events)} events, "
            f"{sum(e.device_type == DeviceType.CUDA for e in events)} on "
            f"the device; the trace's {_trace_kinds(prof)})")
        return None
    h2d = [(dev_us, count) for dev_us, count, key in rows if "HtoD" in key]
    out = {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
           "idle_share": 1 - busy / wall_us,
           "h2d_copies": sum(c for _u, c in h2d),
           "h2d_ms": sum(u for u, _c in h2d) / 1e3}
    if dtoh:
        out["dtoh_copies"], out["dtoh_bytes"], out["dtoh_ms"] = \
            _dtoh_of(prof)
    log(f"{label} profile (one warm run, profiler on): wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.2f} ms, idle "
        f"share {1 - busy / wall_us:.3f}, H2D {out['h2d_copies']} copies "
        f"{out['h2d_ms']:.3f} ms")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        log(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    return out


def enqueue_ms(fn, reps=10) -> float:
    """Host milliseconds one call of ``fn`` takes to return, its work
    enqueued but not waited for (median of ``reps`` after a warm-up, the
    card drained between calls): where this is close to the CUDA-event
    time, the host sets the pace and the kernel's own time is below it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) * 1e3


#: GPU clock cycles of the spin that holds the card in ``device_ms``
#: (~60 ms at an H100's clocks, longer than any call's enqueue here)
SPIN_CYCLES = 100_000_000


def device_ms(fn, reps=10, warmup=2):
    """Median device milliseconds of one call of ``fn``, its host enqueue
    left out: a spin kernel holds the card while the call is enqueued
    behind it, so the events bracket the call's device work alone.  None
    where the spin ended before the enqueue did (the call waited on the
    card, or its enqueue outlasted the spin)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        if start.query():
            torch.cuda.synchronize()
            return None
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.3f} ms"


def profiled_kernel_ms(fn, kernel, reps=10):
    """Device milliseconds of one launch of the kernels whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls of ``fn`` after
    a warm-up (their device time over the launches it recorded), and
    the launches it recorded; (None, 0) where it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    seen = sum(e.count for e in rows)
    total = sum(e.self_device_time_total for e in rows)
    return (total / seen / 1e3 if seen else None), seen


def _trace_events(prof):
    """The finished profile's Chrome trace events."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def _trace_kinds(prof):
    """Events of a finished profile's Chrome trace by category."""
    kinds = collections.Counter(str(e.get("cat")) for e in
                                _trace_events(prof) if e.get("ph") == "X")
    return dict(sorted(kinds.items()))


def _dtoh_of(prof):
    """(copies, bytes, device ms) of the device-to-host copies a finished
    profile recorded, from its Chrome trace (the copy records'
    ``bytes``); bytes None where any copy's record lacks them, so that
    no caller compares a partial sum."""
    copies = [e for e in _trace_events(prof) if e.get("ph") == "X" and
              "DtoH" in str(e.get("name", ""))]
    sizes = [e.get("args", {}).get("bytes") for e in copies]
    total = None if None in sizes else sum(sizes)
    return len(copies), total, sum(e.get("dur", 0) for e in copies) / 1e3


def dtoh_copies(run):
    """(copies, bytes, device ms) of the device-to-host copies in one run
    of ``run`` under torch.profiler (``_dtoh_of``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return _dtoh_of(prof)


# --------------------------------------------------------------------------
# the write path (phase 2l): numpy's answer and the read-back check
# --------------------------------------------------------------------------
def _key_codes(col, lo, hi):
    """A key column's rows [lo, hi) as small non-negative integers in the
    key's order, and their range: int64 keys by their offset from the
    least, one-byte strings by their byte.  Nulls and other strings are
    not among the cells' keys."""
    valid = col.is_valid()[lo:hi]
    require(bool(valid.all()), "a write cell's key holds nulls")
    if col.dtype.is_string:
        require(col.data.shape[1] >= 1 and
                bool((col.lengths[lo:hi] == 1).all()),
                "a write cell's string key is not one byte wide")
        return col.data[lo:hi, 0].astype(np.int64), 256
    x = col.data[lo:hi].astype(np.int64)
    least = int(x.min()) if x.shape[0] else 0
    return x - least, int(x.max()) - least + 1 if x.shape[0] else 1


def write_oracle(hb, keys, n_parts, dir_name):
    """The rows each file of a write of ``hb`` over ``n_parts`` partitions
    by ``keys`` must hold, by numpy: {(partition, directory segments): row
    indices of ``hb``, in input order}.  A partition holds an even slice
    of the rows (as ``create_dataframe`` splits one batch); a file holds
    its partition's rows of one key value (a stable argsort of the
    combined key codes), in a directory named by ``dir_name`` for each
    key's value."""
    n = hb.num_rows
    per = -(-n // n_parts)
    out = {}
    idx = [hb.schema.index_of(k) for k in keys]
    for p in range(n_parts):
        lo, hi = p * per, min(n, (p + 1) * per)
        if lo >= hi:
            continue
        if not keys:
            out[(p, ())] = np.arange(lo, hi)
            continue
        code, span = np.zeros(hi - lo, np.int64), 1
        for i in idx:
            c, r = _key_codes(hb.columns[i], lo, hi)
            code, span = code * r + c, span * r
        code = code.astype(np.uint16 if span <= 1 << 16 else np.int64)
        order = np.argsort(code, kind="stable")
        cuts = np.flatnonzero(np.diff(code[order])) + 1
        for s, e in zip(np.concatenate([[0], cuts]).tolist(),
                        np.concatenate([cuts, [hi - lo]]).tolist()):
            row = lo + int(order[s])
            dirs = []
            for k, i in zip(keys, idx):
                c = hb.columns[i]
                v = bytes(c.data[row, :c.lengths[row]]).decode() \
                    if c.dtype.is_string else c.data[row]
                dirs.append(dir_name(k, v))
            out[(p, tuple(dirs))] = lo + order[s:e]
    return out


def _check_written_files(task):
    """Read written files (or row groups of them) with
    ``io/parquet.read_file`` and compare each with the rows it must hold:
    row count, schema, validity, and each column's valid values bit for
    bit (strings: lengths and the bytes inside them).  ``task`` is (the
    staged columns [(name, type name, .npy path prefix, has lengths)],
    the staged row indices' .npy path, [(path, row group or None, the
    file's slice of the row indices)]).  Returns [(path, row group, rows
    read, differences)]."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.io import parquet as PQ

    cols, rows_npy, items = task
    all_rows = np.load(rows_npy, mmap_mode="r")
    staged = [{part: np.load(f"{prefix}.{part}.npy", mmap_mode="r")
               for part in ("data", "valid") + (("lengths",) if ln else ())}
              for _n, _t, prefix, ln in cols]
    want_schema = [(name, T.from_name(t)) for name, t, _p, _l in cols]
    out = []
    for path, rg, lo, hi in items:
        rows = all_rows[lo:hi]
        if rg is None:
            got = PQ.read_file(path)
        else:
            got = PQ.read_file(path, row_groups=[rg])
            rows = rows[rg * PQ.ROW_GROUP_ROWS:(rg + 1) * PQ.ROW_GROUP_ROWS]
        rows = np.asarray(rows)
        n = rows.shape[0]
        if got.num_rows != n:
            out.append((path, rg, got.num_rows,
                        [f"{got.num_rows} rows, expected {n}"]))
            continue
        bad = []
        if [(f.name, f.dtype) for f in got.schema] != want_schema:
            bad.append(f"schema {got.schema}")
        for g, (name, *_), arrays in zip(got.columns, cols, staged):
            data = np.take(arrays["data"], rows, axis=0)
            v = np.take(arrays["valid"], rows)
            if not np.array_equal(g.is_valid(), v):
                bad.append(f"{name}: validity")
            elif "lengths" in arrays:
                lengths = np.take(arrays["lengths"], rows)
                width = max(g.data.shape[1], data.shape[1])
                inside = np.arange(width)[None, :] < lengths[:, None]
                gm = np.zeros((n, width), np.uint8)
                wm = np.zeros((n, width), np.uint8)
                gm[:, :g.data.shape[1]] = g.data
                wm[:, :data.shape[1]] = data
                if not (np.array_equal(g.lengths[v], lengths[v]) and
                        np.array_equal((gm * inside)[v], (wm * inside)[v])):
                    bad.append(f"{name}: strings")
            elif not np.array_equal(g.data[v].view(np.uint8),
                                    data[v].view(np.uint8)):
                bad.append(f"{name}: values")
        out.append((path, rg, got.num_rows, bad))
    return out


def check_written(files, hb, keep, rows, pool, stage):
    """``_check_written_files`` over each of ``files`` ({oracle key:
    path}) on ``pool`` (spawned worker processes: the decode of a string
    column is a Python loop over its values), a row group an item where
    a file has several, the items dealt into about 64 tasks.  ``hb``'s
    ``keep`` columns and each file's row indices (``rows``: oracle key ->
    indices) are staged as .npy files under ``stage``, which the workers
    map rather than receive."""
    from spark_rapids_tpu_torch.io import parquet as PQ

    os.makedirs(stage, exist_ok=True)
    cols = []
    for i in keep:
        c, f = hb.columns[i], hb.schema[i]
        prefix = os.path.join(stage, f"c{i}")
        np.save(f"{prefix}.data.npy", c.data)
        np.save(f"{prefix}.valid.npy", c.is_valid())
        if c.lengths is not None:
            np.save(f"{prefix}.lengths.npy", c.lengths)
        cols.append((f.name, f.dtype.sql_name, prefix, c.lengths is not None))
    keys = sorted(files)
    rows_npy = os.path.join(stage, "rows.npy")
    np.save(rows_npy, np.concatenate([rows[k] for k in keys]))
    items, at = [], 0
    for key in keys:
        n = rows[key].shape[0]
        n_rg = -(-n // PQ.ROW_GROUP_ROWS)
        items += [(files[key], rg, at, at + n)
                  for rg in ([None] if n_rg <= 1 else range(n_rg))]
        at += n
    step = -(-len(items) // 64)
    tasks = [(cols, rows_npy, items[i:i + step])
             for i in range(0, len(items), step)]
    try:
        return [r for rs in pool.imap_unordered(_check_written_files, tasks)
                for r in rs]
    finally:
        shutil.rmtree(stage, ignore_errors=True)


def phase_writes(cells, counters, cold, warm, card, check_pool):
    """Phase 2l: each cell ``name -> (host batch, partition columns)``
    written at two partitions through ``DataFrame.write_parquet`` on
    ``cuda`` into a temporary directory (free space checked first):
    the cold run's launches (K1 and K4, through B.26, and no other hand
    kernel where there are keys; none without), its files read back with
    ``io/parquet.read_file`` in spawned processes and held against
    ``write_oracle``'s answer (directories, files, _SUCCESS, each file's
    rows in input order, the tracker's rows, files and bytes); one warm
    run under torch.profiler (its wall on the host clock around the
    write, the split of that wall, busy, idle share, DtoH), keeping the
    first partition's sort input of W1 and W2 for phase 3.
    The files are removed.  ``check_pool`` is a pool of spawned
    processes for the read-back.  Returns (info by cell, launches by
    cell, B.26 inputs by cell); ``cold``/``warm`` get the walls."""
    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch.exec import write as WR
    from spark_rapids_tpu_torch.io.scans import partition_dir_name

    all_counters = [c for cs in counters.values() for c in cs]
    current = {}
    write_root = tempfile.mkdtemp(prefix="chip_smoke_write_")
    write_info, write_launches, b26_inputs = {}, {}, {}
    sort_impl = WR.TpuDataWritingCommandExec._sort_by_keys

    def recording_sort(self, b, kernels=None):
        # the first partition's batch of each cell's warm run, for phase 3
        b26_inputs.setdefault(current["cell"], (self, b))
        return sort_impl(self, b, kernels)

    def listing(root):
        files, sizes = [], {}
        for d, _dirs, names in os.walk(root):
            for n in names:
                path = os.path.join(d, n)
                files.append(path)
                sizes[path] = os.path.getsize(path)
        return files, sizes

    try:
        for cell, (whb, keys) in cells.items():
            root = os.path.join(write_root, cell)
            # what the files hold: the data's bytes, strings with their
            # 4-byte lengths (literal-only snappy adds 5 bytes a page);
            # the check stages about as much again
            est = sum(c.data.nbytes if not c.dtype.is_string else
                      int(c.lengths.sum()) + 4 * c.num_rows
                      for c in whb.columns)
            free = shutil.disk_usage(write_root).free
            require(free > 2.5 * est, f"{cell}: {free} bytes free under "
                    f"{write_root}, the write and its check need about "
                    f"{2 * est}")
            t0 = time.perf_counter()
            want = write_oracle(whb, keys, 2, partition_dir_name)
            log(f"{cell}: {whb.num_rows} rows x {len(whb.schema)} columns "
                f"by {keys or 'no key'}; numpy's answer ({len(want)} files)"
                f" in {time.perf_counter() - t0:.1f} s; about {est} bytes "
                f"to write, {free} free under {write_root}")

            def run(root=root, whb=whb, keys=keys):
                shutil.rmtree(root, ignore_errors=True)
                wsess = Session()
                df = wsess.create_dataframe(whb, n_partitions=2)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                df.write_parquet(root, partition_by=keys or None)
                torch.cuda.synchronize()
                return wsess, time.perf_counter() - t0

            current["cell"] = cell
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            for cnt in all_counters:
                cnt.reset()
            wsess, cold[cell] = run()
            peak = torch.cuda.max_memory_allocated() - held
            write_launches[cell] = {k: sum(x.count for x in cs)
                                    for k, cs in counters.items()}
            got = write_launches[cell]
            log(f"{cell} launches: {got}")
            if keys:
                require(got["K1"] > 0 and got["K4"] > 0 and
                        all(v == 0 for k, v in got.items()
                            if k not in ("K1", "K4")),
                        f"{cell}: the write's launches {got}; K1 and K4 "
                        "(B.26) and no other kernel expected")
            else:
                require(not any(got.values()), f"{cell}: launches {got}, "
                        "none expected")
            # the files against numpy's answer
            t0 = time.perf_counter()
            files, sizes = listing(root)
            expect = {key: os.path.join(root, *key[1],
                                        f"part-{key[0]:05d}.parquet")
                      for key in want}
            data_files = {f for f in files if f.endswith(".parquet")}
            require(data_files == set(expect.values()) and
                    os.path.join(root, "_SUCCESS") in files and
                    len(files) == len(data_files) + 1,
                    f"{cell}: {len(data_files)} data files, expected "
                    f"{len(expect)}; missing "
                    f"{sorted(set(expect.values()) - data_files)[:3]}, "
                    f"extra {sorted(set(files) - set(expect.values()))[:3]}")
            dirs = {os.path.relpath(os.path.dirname(f), root)
                    for f in data_files}
            require(dirs == {os.path.normpath(os.path.join(".", *k[1]))
                             for k in want},
                    f"{cell}: directories differ from numpy's keys")
            st = wsess.last_write_stats
            n_bytes = sum(sizes[f] for f in data_files)
            require(st.metrics["numOutputRows"].value == whb.num_rows and
                    st.metrics["numFiles"].value == len(data_files) and
                    st.metrics["numOutputBytes"].value == n_bytes,
                    f"{cell}: tracker "
                    f"{ {k: m.value for k, m in st.metrics.items()} } "
                    f"against {whb.num_rows} rows, {len(data_files)} "
                    f"files, {n_bytes} bytes listed")
            keep = [i for i, f in enumerate(whb.schema) if f.name not in keys]
            results = check_written(expect, whb, keep, want, check_pool,
                                    os.path.join(write_root, "check"))
            bad = [r for r in results if r[3]]
            require(not bad and sum(r[2] for r in results) == whb.num_rows,
                    f"{cell}: files differ from numpy's answer: {bad[:3]}")
            t_check = time.perf_counter() - t0
            log(f"{cell}: {len(data_files)} files in "
                f"{len(dirs)} directories, {n_bytes} bytes, _SUCCESS; "
                f"every file read back by io/parquet.read_file equals its "
                f"partition's rows of its key in input order "
                f"({t_check:.1f} s); tracker "
                f"rows, files and bytes equal the listing")
            # one warm run under the profiler, its wall on the host clock
            # around the write alone; its sort's input kept for phase 3
            shutil.rmtree(root, ignore_errors=True)
            wsess = Session()
            wdf = wsess.create_dataframe(whb, n_partitions=2)

            def warm_run(wdf=wdf, root=root, keys=keys):
                t0 = time.perf_counter()
                wdf.write_parquet(root, partition_by=keys or None)
                torch.cuda.synchronize()
                warm[cell] = time.perf_counter() - t0

            WR.TpuDataWritingCommandExec._sort_by_keys = recording_sort
            try:
                prof = profile_query(f"{cell} write", warm_run, dtoh=True)
            finally:
                WR.TpuDataWritingCommandExec._sort_by_keys = sort_impl
            m, st = wsess.last_metrics, wsess.last_write_stats
            split = {
                "input_s": m.get("TpuDataWritingCommandExec.inputTimeNs", 0),
                "sort_download_s": m.get(
                    "TpuDataWritingCommandExec.sortDownloadTimeNs", 0),
                "split_s": m.get("TpuDataWritingCommandExec.splitTimeNs", 0),
                "encode_s": st.metrics["encodeTimeNs"].value,
                "file_io_s": st.metrics["ioTimeNs"].value}
            split = {k: v / 1e9 for k, v in split.items()}
            split["other_s"] = warm[cell] - sum(split.values())
            shutil.rmtree(root, ignore_errors=True)
            write_info[cell] = {
                "rows": whb.num_rows, "columns": len(whb.schema),
                "partition_by": keys, "files": len(data_files),
                "directories": len(dirs), "bytes": n_bytes,
                "cold_s": cold[cell], "warm_s": warm[cell],
                "mb_per_s": n_bytes / warm[cell] / 1e6,
                "host_ms_per_file": warm[cell] * 1e3 / len(data_files),
                "split_of_warm_wall": split, "profile": prof,
                "peak_device_bytes": peak, "launches": write_launches[cell],
                "check_s": t_check}
            log(f"{cell} write: wall cold {cold[cell]:.3f} s, warm "
                f"{warm[cell]:.3f} s; warm split "
                + ", ".join(f"{k[:-2]} {v:.3f} s ({v / warm[cell]:.3f})"
                            for k, v in split.items())
                + f"; {len(data_files)} files, {n_bytes} bytes, "
                f"{n_bytes / warm[cell] / 1e6:.1f} MB/s, "
                f"{warm[cell] * 1e3 / len(data_files):.3f} ms a file; K1 "
                f"{got['K1']}, K4 {got['K4']} launches; DtoH "
                + (f"{prof['dtoh_copies']} copies, {prof['dtoh_bytes']} "
                   f"bytes, {prof['dtoh_ms']:.3f} ms; busy "
                   f"{prof['busy_ms']:.2f} ms, idle share "
                   f"{prof['idle_share']:.4f}" if prof else "not measured")
                + f"; peak device memory {peak} bytes; on {card}")
            del want, results
    finally:
        shutil.rmtree(write_root, ignore_errors=True)
    require(set(b26_inputs) == {"W1", "W2"},
            f"phase 2l kept B.26 inputs of {sorted(b26_inputs)}")
    return write_info, write_launches, b26_inputs


def measure_b26(b26_inputs):
    """Phase 3's B.26 (the write's sort by its partition columns: K1's
    lexsort and K4's gather of the whole batch) at the first partition's
    batch of W1 (2,000,000 store_sales rows, one int64 key) and W2
    (30,000,000 SF10 lines, two one-byte string keys) as phase 2l's warm
    runs gave them: bit for bit against its plain version, its event,
    enqueue, K1 and gather (behind a spin) times and the plain time.
    Returns (figures by cell, the library call's ms at W1)."""
    from spark_rapids_tpu_torch.data import column as C
    from spark_rapids_tpu_torch.ops.kernels import gather as G
    from spark_rapids_tpu_torch.ops.kernels import segment as S

    def b26_plain(b, key_idx):
        order = S.lexsort_plain([b.columns[i] for i in key_idx],
                                pad_valid=b.row_mask())
        return C.DeviceBatch(b.schema, [G.gather_column_plain(c, order)
                                        for c in b.columns], b.num_rows)

    def same_batch(a, b):
        return int(a.num_rows) == int(b.num_rows) and all(
            torch.equal(x.data, y.data) and torch.equal(x.validity,
                                                        y.validity) and
            (x.lengths is None) == (y.lengths is None) and
            (x.lengths is None or torch.equal(x.lengths, y.lengths))
            for x, y in zip(a.columns, b.columns))

    b26 = {}
    for cell, (wex, wb) in sorted(b26_inputs.items()):
        key_idx = wex._key_idx()
        kcols = [wb.columns[i] for i in key_idx]
        rm = wb.row_mask()
        require(same_batch(wex._sort_by_keys(wb), b26_plain(wb, key_idx)),
                f"B.26 differs from its plain version at {cell}'s batch")
        order = S.lexsort_device(kcols, pad_valid=rm)
        n_passes = 1 + S._n_passes(S._with_lengths(kcols, None, None)[0])
        moved = n_passes * wb.padded_rows * 8 + 2 * wb.device_bytes() + \
            sum(nbytes(c.data, c.validity, c.lengths) for c in kcols)
        b26[cell] = dict(
            rows=int(wb.num_rows), padded=wb.padded_rows, passes=n_passes,
            columns=len(wb.columns), bytes=moved,
            ms=cuda_ms(lambda: wex._sort_by_keys(wb)),
            enq=enqueue_ms(lambda: wex._sort_by_keys(wb)),
            sort_ms=cuda_ms(lambda: S.lexsort_device(kcols, pad_valid=rm)),
            gather_dev=device_ms(lambda: G.gather_batch(wb, order,
                                                        wb.num_rows)),
            plain=cuda_ms(lambda: b26_plain(wb, key_idx), reps=3,
                          warmup=1))
        log(f"B.26 at {cell}'s first partition: {b26[cell]['rows']} rows "
            f"({wb.padded_rows} padded) x {len(wb.columns)} columns, "
            f"{n_passes} K1 passes, {moved} bytes (bound "
            f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms), equal to its plain "
            f"version bit for bit; event {b26[cell]['ms']:.3f} ms (K1's "
            f"histogram read back inside: no spin time), enqueue "
            f"{b26[cell]['enq']:.3f} ms, K1 alone {b26[cell]['sort_ms']:.3f}"
            f" ms, K4's gather behind a spin "
            f"{_ms_text(b26[cell]['gather_dev'])}, plain "
            f"{b26[cell]['plain']:.3f} ms")
    # the library call at W1's one int64 key: a stable argsort of the key
    # (nulls first, padding last, as K1 orders them) and index_select of
    # every array
    wex, wb = b26_inputs["W1"]
    kc = wb.columns[wex._key_idx()[0]]
    rm = wb.row_mask()
    lib_key = torch.where(rm, torch.where(kc.validity, kc.data,
                                          torch.iinfo(torch.int64).min),
                          torch.iinfo(torch.int64).max)
    arrays = [t for c in wb.columns for t in (c.data, c.validity, c.lengths)
              if t is not None]

    def b26_library():
        o = torch.argsort(lib_key, stable=True)
        return [torch.index_select(t, 0, o) for t in arrays]

    require(torch.equal(torch.argsort(lib_key, stable=True).to(torch.int32),
                        S.lexsort_device([kc], pad_valid=rm)),
            "B.26's library order differs from K1's at W1")
    return b26, cuda_ms(b26_library)


# --------------------------------------------------------------------------
# the multi-process runner (phase 2m): two spawned workers share the card
# over gloo, each owning two of four shards
# --------------------------------------------------------------------------
def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def stage_tables(root, name, tables):
    """Every array of ``tables`` (table -> HostBatch) as ``.npy`` under
    ``root/name``; returns the manifest ``load_tables`` reads: table ->
    [(field, type name, [file or None for data, validity, lengths])]."""
    os.makedirs(os.path.join(root, name), exist_ok=True)
    manifest = {}
    for t, b in tables.items():
        cols = []
        for f, c in zip(b.schema, b.columns):
            files = []
            for part in ("data", "validity", "lengths"):
                a = getattr(c, part)
                if a is None:
                    files.append(None)
                    continue
                rel = os.path.join(name, f"{t}.{f.name}.{part}.npy")
                np.save(os.path.join(root, rel), np.ascontiguousarray(a))
                files.append(rel)
            cols.append((f.name, f.dtype.sql_name, files))
        manifest[t] = cols
    return manifest


def load_tables(root, manifest):
    """``stage_tables``'s tables, every array mapped read-only from its
    file (a process reads the pages of the partitions it uploads)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.data.column import HostBatch, HostColumn

    out = {}
    for t, cols in manifest.items():
        fields, hcols = [], []
        for name, tname, files in cols:
            dt = T.from_name(tname)
            arrays = [None if f is None else
                      np.load(os.path.join(root, f), mmap_mode="r")
                      for f in files]
            fields.append(T.Field(name, dt))
            hcols.append(HostColumn(dt, *arrays))
        out[t] = HostBatch(T.Schema(fields), hcols)
    return out


def mp_worker(coordinator, rank, root, manifests, out_path):
    """Phase 2m's worker ``rank`` of ``MP_PROCESSES``: joins the gloo group
    on ``cuda:0`` and runs a cell a staged table set of ``manifests``
    (``m1_q<n>``: query n at SF1, cold and three warm runs; ``m2_q<n>``: at
    SF10, cold and one warm run) through ``run_distributed_mp`` at
    ``MP_SHARDS`` partitions a table; then runs each cell once more, a
    check run in which every K27 call of the path is held against its
    plain version on the same inputs (its launches are not counted, and
    nothing is kept from the timed runs, so that their peak memory is the
    path's own); times K27 at the largest agreement and the largest trim
    the path gave it, and gloo's all-reduce of an agreed vector; and
    pickles its rows and figures to ``out_path``."""
    import pickle

    import torch.distributed as dist

    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch.benchmarks import tpch
    from spark_rapids_tpu_torch.ops.kernels import gather as G
    from spark_rapids_tpu_torch.ops.kernels import retile as R
    from spark_rapids_tpu_torch.parallel import multiprocess as MPR
    from spark_rapids_tpu_torch.parallel.elastic import guarded_call
    from spark_rapids_tpu_torch.parallel.runner import DistributedRunner
    from spark_rapids_tpu_torch.shuffle import device_shuffle as DS
    from spark_rapids_tpu_torch.utils import hashing as H

    t_start = time.perf_counter()
    mesh = MPR.init_multiprocess(coordinator, MP_PROCESSES, rank,
                                 device="cuda",
                                 local_shards=MP_SHARDS // MP_PROCESSES,
                                 conf=MP_CONF)
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.zeros(1, device=dev)
    owned = mesh.owned_shards(rank)
    result = {"rank": rank, "owned": owned, "backend": dist.get_backend(),
              "device": str(dev), "cells": {},
              "init_s": time.perf_counter() - t_start}
    tables = {name: load_tables(root, m) for name, m in manifests.items()}
    result["tables_s"] = time.perf_counter() - t_start

    k27 = [R.RETILE_MAX_LAUNCHES, R.RETILE_TRIM_LAUNCHES]
    watched = {"K4": [G.GATHER_LAUNCHES, G.COMPACT_LAUNCHES],
               "K9": [H.HASH_LAUNCHES],
               "K10": [DS.BUILD_LAUNCHES, DS.SLICE_LAUNCHES],
               "K24": [DS.TILE_LAUNCHES], "K27 max": k27[:1],
               "K27 trim": k27[1:]}
    every = [c for cs in watched.values() for c in cs]
    state = {"cell": None, "upload": 0, "check": False}
    #: per cell, what its check run held against the plain versions
    checked = {}
    #: the largest agreement and the largest trim the path gave K27 in the
    #: check runs, kept for phase 3's line
    timed = {}
    max_impl, trim_impl = R.retile_max, R.retile_trim
    stack_impl = DistributedRunner._stack_host

    def same(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))

    def checked_max(stats, k, n_bucket, min_bucket, device, kernels=None):
        """K27's max as the path calls it; in a check run also its plain
        version on the same statistics."""
        got = max_impl(stats, k, n_bucket, min_bucket, device, kernels)
        if state["check"]:
            want = R.retile_max_plain(stats, k, n_bucket, min_bucket, device)
            require(torch.equal(got, want), f"{state['cell']}: K27 "
                    f"retile_max differs from its plain version at k={k}: "
                    f"{got.tolist()} {want.tolist()}")
            checked[state["cell"]]["max_k"].append(k)
            if k >= timed.get("max", {}).get("k", -1):
                timed["max"] = {"cell": state["cell"], "k": k,
                                "n_bucket": n_bucket,
                                "min_bucket": min_bucket,
                                "stats": list(stats)}
        return got

    def checked_trim(batches, need, kernels=None):
        """K27's trim as the path calls it; in a check run, where it
        launches, also its plain version on the same batches."""
        got = trim_impl(batches, need, kernels)
        if state["check"] and any(b.padded_rows > need for b in batches):
            want = R.retile_trim_plain(batches, need)
            require(all(x.padded_rows == y.padded_rows and all(
                same(p, q) for c, d in zip(x.columns, y.columns)
                for p, q in ((c.data, d.data), (c.validity, d.validity),
                             (c.lengths, d.lengths)) if q is not None)
                for x, y in zip(got, want)), f"{state['cell']}: K27 "
                f"retile_trim at {need} rows differs from its plain version")
            nbytes = R.retile_trim_bytes(batches, need)
            checked[state["cell"]]["trims"].append({
                "need": need, "padded_rows": [b.padded_rows
                                              for b in batches],
                "bytes": nbytes})
            if nbytes >= timed.get("trim", {}).get("bytes", -1):
                timed["trim"] = {"cell": state["cell"], "need": need,
                                 "bytes": nbytes, "batches": list(batches)}
        return got

    def recording_stack(self, shards, shard_ids=None, layout=None):
        out = stack_impl(self, shards, shard_ids, layout)
        state["upload"] += sum(b.device_bytes() for b in out)
        return out

    R.retile_max, R.retile_trim = checked_max, checked_trim
    MPR.MultiProcessRunner._stack_host = recording_stack

    def uncounted(fn):
        """``fn()`` with every launch it makes left out of the counts."""
        saved = [c.count for c in every]
        try:
            return fn()
        finally:
            for c, n in zip(every, saved):
                c.count = n

    names = [m for m in manifests if m.startswith("m1_")] + \
        [m for m in manifests if m.startswith("m2_")]
    cells = [(f"M{m[1]} q{m.split('_q')[1]}", int(m.split("_q")[1]), m,
              3 if m.startswith("m1_") else 1) for m in names]
    for cell, q, tname, n_warm in cells:
        sess = Session(MP_CONF)
        tabs = {t: sess.create_dataframe(b, n_partitions=MP_SHARDS)
                for t, b in tables[tname].items()}
        df = tpch.QUERIES[q](tabs)
        state["cell"], state["upload"] = cell, 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in every:
            c.reset()
        dist.barrier()
        t0 = time.perf_counter()
        rows = MPR.run_distributed_mp(sess, df, mesh).to_rows()
        cold = time.perf_counter() - t0
        info = {
            "rows": rows, "cold_s": cold,
            "launches": {k: sum(c.count for c in cs)
                         for k, cs in watched.items()},
            "drained": sess.last_drained,
            "upload_bytes": state["upload"],
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "metrics": {k: v for k, v in sess.last_metrics.items()
                        if k.startswith("shuffle.")},
            "placements": [{k: p.get(k) for k in (
                "exchange", "capacity", "partition_rows", "rows_written",
                "bytes_swapped", "process_bytes_sent")}
                for p in sess.last_placements]}
        runs = []
        for _ in range(n_warm):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            MPR.run_distributed_mp(sess, df, mesh)
            runs.append(time.perf_counter() - t0)
        info["warm_s"] = statistics.median(runs)
        info["warm_runs_s"] = runs
        # the check run: the query once more, after the timed runs, with
        # every K27 call held against its plain version on its own inputs
        checked[cell] = {"max_k": [], "trims": []}
        state["check"] = True
        dist.barrier()
        try:
            uncounted(lambda: MPR.run_distributed_mp(sess, df, mesh))
        finally:
            state["check"] = False
        require(checked[cell]["max_k"], f"{cell}: the check run made no "
                "K27 agreement")
        info["k27_check"] = {
            "agreements": len(checked[cell]["max_k"]),
            "largest_k": max(checked[cell]["max_k"]),
            "trims": checked[cell]["trims"]}
        result["cells"][cell] = info
        del tabs, df, sess

    # phase 3's K27 line: K27's functions at the largest agreement and the
    # largest trim the path gave them in this worker
    n = mesh.size
    mx = timed.pop("max")
    stats, k = mx["stats"], mx["k"]
    vecs = []
    for st in stats:
        v = torch.zeros(k, dtype=torch.int64, device=dev)
        w = torch.as_tensor(st.value, device=dev).reshape(-1)
        v[st.slot:st.slot + w.numel()] = w.to(torch.int64)
        vecs.append(v)

    def k27_max():
        return max_impl(stats, k, mx["n_bucket"], mx["min_bucket"], dev)

    def k27_max_plain():
        return R.retile_max_plain(stats, k, mx["n_bucket"],
                                  mx["min_bucket"], dev)

    def measure_max():
        return {"max_ms": cuda_ms(k27_max), "max_device_ms":
                device_ms(k27_max), "max_enqueue_ms": enqueue_ms(k27_max),
                "max_plain_ms": cuda_ms(k27_max_plain),
                "max_library_ms": cuda_ms(lambda: torch.stack(vecs).amax(0))}

    k27_time = uncounted(measure_max)
    k27_time.update(
        max_cell=mx["cell"], k=k, entries=len(stats),
        # the table (4 words an entry), each tensor statistic's words,
        # the output words
        max_bytes=len(stats) * 32 + sum(
            0 if isinstance(st.value, int)
            else st.value.numel() * st.value.element_size()
            for st in stats) + (k + 1) * 8)
    if "trim" in timed:
        tr = timed.pop("trim")
        out, need = tr["batches"], tr["need"]
        bufs = [t for b in out if b.padded_rows > need for c in b.columns
                for t in (c.data, c.validity, c.lengths) if t is not None]

        def measure_trim():
            return {
                "trim_ms": cuda_ms(lambda: trim_impl(out, need)),
                "trim_device_ms": device_ms(lambda: trim_impl(out, need)),
                "trim_enqueue_ms": enqueue_ms(lambda: trim_impl(out, need)),
                "trim_plain_ms": cuda_ms(
                    lambda: R.retile_trim_plain(out, need)),
                "trim_library_ms": cuda_ms(
                    lambda: [t[:need].clone() for t in bufs])}

        k27_time.update(uncounted(measure_trim))
        k27_time.update(trim_cell=tr["cell"], need=need,
                        padded_rows=[b.padded_rows for b in out],
                        trim_bytes=tr["bytes"], trim_buffers=len(bufs))
        del out, bufs, tr
    # gloo's all-reduce of an agreed vector, on its own (host tensors)
    host = torch.zeros(n + 1, dtype=torch.int64)
    times = []
    for _ in range(20):
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(host, op=dist.ReduceOp.MAX)
        times.append((time.perf_counter() - t0) * 1e3)
    k27_time["gloo_all_reduce_ms"] = statistics.median(times)
    result["k27"] = k27_time
    del mx, stats, vecs

    # which collectives gloo takes on CUDA tensors (the transport stages
    # through host memory either way)
    probe = {}
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(
                torch.ones(4, device=dev), op=dist.ReduceOp.MAX)),
            ("all_to_all_single", lambda: dist.all_to_all_single(
                torch.empty(4, device=dev), torch.ones(4, device=dev)))):
        try:
            guarded_call(fn, timeout_ms=20_000)
            probe[name] = "accepted"
        except Exception as e:  # noqa: BLE001 — what gloo says is the datum
            probe[name] = f"refused: {type(e).__name__}: {str(e)[:300]}"
    result["gloo_cuda"] = probe
    result["total_s"] = time.perf_counter() - t_start
    with open(out_path, "wb") as fh:
        pickle.dump(result, fh)
    sys.stdout.flush()
    sys.stderr.flush()
    # a refused probe may leave gloo's threads behind: end here
    os._exit(0)


def run_multiprocess(root, manifests, timeout_s):
    """Spawn the ``MP_PROCESSES`` workers, join them within
    ``timeout_s``; every worker that fails, hangs or writes no result
    fails the run (the others are killed).  Returns their results by
    rank and the seconds from spawn to the last exit."""
    import multiprocessing as mp
    import pickle

    ctx = mp.get_context("spawn")
    coordinator = f"127.0.0.1:{free_port()}"
    paths = [os.path.join(root, f"result{r}.pkl")
             for r in range(MP_PROCESSES)]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=mp_worker, args=(
        coordinator, r, root, manifests, paths[r]), name=f"mp-worker-{r}")
        for r in range(MP_PROCESSES)]
    for p in procs:
        p.start()
    deadline = t0 + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            if time.perf_counter() > deadline:
                raise RuntimeError(f"phase 2m: workers still running after "
                                   f"{timeout_s} s")
            failed = [p.name for p in procs
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"phase 2m: {failed} exited with "
                                   f"{[p.exitcode for p in procs]}")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    require(all(p.exitcode == 0 for p in procs),
            f"phase 2m: worker exit codes {[p.exitcode for p in procs]}")
    results = []
    for path in paths:
        require(os.path.exists(path), f"phase 2m: no result at {path}")
        with open(path, "rb") as fh:
            results.append(pickle.load(fh))
    return results, time.perf_counter() - t0


# --------------------------------------------------------------------------
# independent numpy answers: TPC-H in benchmarks/tpch_oracle.py (imported
# in main, with the package), TPCx-BB q30 and the clickstream windows here
# --------------------------------------------------------------------------
def _cols(batches):
    return {f.name: c for b in batches.values()
            for f, c in zip(b.schema, b.columns)}


def numpy_q30(tables, sizes):
    """TPCx-BB q30: category pairs seen in one (user, day) session,
    top 3 per category by count, then by the other category."""
    c = _cols(tables)
    isk = c["i_item_sk"].data
    require(bool((isk == np.arange(1, len(isk) + 1)).all()),
            "q30 numpy: item keys are not 1..n")
    cat = c["i_category_id"].data.astype(np.int64)
    item = c["wcs_item_sk"].data
    joined = (item >= 1) & (item <= len(isk))
    user = c["wcs_user_sk"].data[joined]
    day = c["wcs_click_date_sk"].data[joined]
    cat_of = cat[item[joined] - 1]
    n_cat = int(cat.max()) + 1
    session = user * (int(day.max()) + 1) + day
    distinct = np.unique(session * n_cat + cat_of)
    _s, s_inv = np.unique(distinct // n_cat, return_inverse=True)
    per = np.bincount(s_inv)                  # categories per session
    x = np.zeros((len(per), n_cat))
    x[s_inv, distinct % n_cat] = 1.0
    pair = np.rint(x.T @ x).astype(np.int64)  # sessions per category pair
    np.fill_diagonal(pair, 0)
    sizes.update({"clicks joined with item": int(joined.sum()),
                  "distinct (user, day, category)": len(distinct),
                  "self-join on (user, day)": int((per * per).sum()),
                  "cat_a != cat_b": int((per * (per - 1)).sum()),
                  "groups": int((pair > 0).sum())})
    rows = []
    for a in range(n_cat):
        bs = sorted((b for b in range(n_cat) if pair[a, b] > 0),
                    key=lambda b: (-pair[a, b], b))
        rows += [(a, b, int(pair[a, b]), rn) for rn, b in
                 enumerate(bs[:3], 1)]
    return rows


def numpy_clickstream(hb):
    """The clickstream windows: clicks in (user, date, time) order, ties
    in table order; row number, sum of the last five sales keys, minimum
    time of the five clicks around.  Returns the sorted order and the
    three results in that order."""
    c = _cols({"t": hb})
    user, date, ctime = (c[n].data for n in (
        "wcs_user_sk", "wcs_click_date_sk", "wcs_click_time_sk"))
    order = np.lexsort((ctime, date, user))   # stable: ties keep row order
    n = len(order)
    i = np.arange(n)
    us = user[order]
    first = np.ones(n, bool)
    first[1:] = us[1:] != us[:-1]
    start = np.maximum.accumulate(np.where(first, i, 0))
    last = np.ones(n, bool)
    last[:-1] = us[:-1] != us[1:]
    end = np.minimum.accumulate(np.where(last, i + 1, n)[::-1])[::-1]
    prefix = np.concatenate([[0], np.cumsum(c["wcs_sales_sk"].data[order])])
    sum5 = prefix[i + 1] - prefix[np.maximum(i - 4, start)]
    ts = ctime[order]
    min5 = ts.copy()
    for k in (-2, -1, 1, 2):
        j = i + k
        inside = (j >= start) & (j < end)
        min5 = np.where(inside, np.minimum(min5, ts[np.clip(j, 0, n - 1)]),
                        min5)
    return order, (i - start + 1).astype(np.int32), sum5, min5


# --------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2

    from spark_rapids_tpu_torch import Session, ml
    from spark_rapids_tpu_torch import f as F
    from spark_rapids_tpu_torch.benchmarks import mortgage as M
    from spark_rapids_tpu_torch.benchmarks import (tpch, tpch_clean as TC,
                                                   tpch_datagen,
                                                   tpch_oracle as O,
                                                   tpch_text as TT,
                                                   tpcxbb, tpcxbb_datagen,
                                                   tpcxbb_rollup as RU)
    from spark_rapids_tpu_torch.data import strings as dstrings
    from spark_rapids_tpu_torch.config import BATCH_SIZE_BYTES
    from spark_rapids_tpu_torch.data import column as C
    from spark_rapids_tpu_torch.data.column import (DeviceColumn,
                                                    HostBatch, HostColumn,
                                                    bucket_rows,
                                                    host_to_device)
    from spark_rapids_tpu_torch.types import STRING, Field, Schema
    from spark_rapids_tpu_torch.exec.joins import TpuHashJoinExec
    from spark_rapids_tpu_torch.ops.expression import (Literal,
                                                       as_device_column)
    from spark_rapids_tpu_torch.exec.fused import TpuFusedSegmentExec
    from spark_rapids_tpu_torch.ops.kernels import _build
    from spark_rapids_tpu_torch.ops.kernels import castkernels as CK
    from spark_rapids_tpu_torch.ops.kernels import export as XK
    from spark_rapids_tpu_torch.ops.kernels import fused as FK
    from spark_rapids_tpu_torch.ops.kernels import gather as G
    from spark_rapids_tpu_torch.ops.kernels import generate as GK
    from spark_rapids_tpu_torch.ops.kernels import join as J
    from spark_rapids_tpu_torch.ops.kernels import retile as R
    from spark_rapids_tpu_torch.ops.kernels import segment as S
    from spark_rapids_tpu_torch.ops.kernels import stringkernels as SK
    from spark_rapids_tpu_torch.ops.kernels import window as W
    from spark_rapids_tpu_torch.exec import exchange as EX
    from spark_rapids_tpu_torch.parallel.mesh import make_mesh
    from spark_rapids_tpu_torch.parallel.runner import run_distributed
    from spark_rapids_tpu_torch.shuffle import device_shuffle as DS
    from spark_rapids_tpu_torch.utils import hashing as H

    check_rows = O.check_rows
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    out_dir = _build.build_all()
    _build.CUDA.library("sort")  # loads every library
    log(f"kernel build: {time.perf_counter() - t0:.1f} s ({out_dir})")
    log_ptxas_summary((out_dir / "build.log").read_text())

    # ---- 2. main paths ----------------------------------------------------
    t0 = time.perf_counter()
    # every column of every table, drawn once; each query's cut has the
    # rows of its own draw
    all_cols = tpch_datagen.draw_all(SF, SEED)
    hb = tpch_datagen.tables(1, SF, SEED, cols=all_cols)["lineitem"]
    host = {q: tpch_datagen.tables(q, SF, SEED, cols=all_cols)
            for q in JOINED + LATER}
    log(f"tables SF{SF:g} generated in {time.perf_counter() - t0:.1f} s: "
        f"Q1/Q6 lineitem {hb.num_rows} rows x {len(hb.schema)} columns; "
        + "; ".join(f"Q{q} " + ", ".join(
            f"{t} {b.num_rows} x {len(b.schema)}" for t, b in ts.items())
            for q, ts in host.items()))
    t0 = time.perf_counter()
    text_hb, typed_hb = tpch_datagen.lineitem_text(SF, SEED, cols=all_cols)
    export_hb = tpch_datagen.export_table(SF, SEED, cols=all_cols)
    want_lines = tpch_datagen.export_lines(export_hb)
    text_bytes = sum(c.data.nbytes + c.lengths.nbytes
                     for c in text_hb.columns)
    log(f"text tables SF{SF:g} generated in {time.perf_counter() - t0:.1f} "
        f"s: ingest {text_hb.num_rows} rows x {len(text_hb.schema)} string "
        f"columns, widths {[c.data.shape[1] for c in text_hb.columns]}, "
        f"{text_bytes} bytes of text and lengths; export {export_hb.num_rows}"
        f" rows x {len(export_hb.schema)} columns, expected lines "
        f"{want_lines[0].shape[1]} bytes wide at most, "
        f"{int(want_lines[1].sum())} bytes in all")
    t0 = time.perf_counter()
    bb_gen = tpcxbb_datagen.generate(BB_SF, BB_SEED)
    rollup_host = {q: RU.query_tables(bb_gen, q) for q in ROLLUP}
    log(f"TPCx-BB SF{BB_SF:g} (seed {BB_SEED}) generated in "
        f"{time.perf_counter() - t0:.1f} s; the rollup path's tables: "
        + "; ".join(f"{q} " + ", ".join(
            f"{t} {b.num_rows} x {len(b.schema)}" for t, b in ts.items())
            for q, ts in rollup_host.items()))
    sess = Session()
    torch.zeros(1, device=sess.device)  # CUDA context outside the timings
    tables = {1: {"lineitem": sess.create_dataframe(hb, n_partitions=1)}}
    tables[6] = tables[1]
    for q in JOINED:
        tables[q] = {t: sess.create_dataframe(b, n_partitions=1)
                     for t, b in host[q].items()}

    # every fused segment's generated kernel, built in parallel before any
    # query runs (the plans are made on CPU tensors, which build nothing)
    planner = Session(device="cpu")
    segments = {}
    for q in FUSED + LATER:
        for n_part in ((1, 2) if q in FUSED else (2,)):
            cpu_tables = {t: planner.create_dataframe(b, n_partitions=n_part)
                          for t, b in host[q].items()}
            for p in walk_plan(planner.physical_plan(
                    tpch.QUERIES[q](cpu_tables).plan)):
                if isinstance(p, TpuFusedSegmentExec):
                    segments.setdefault(p.program.key, (q, p.program))
    text_planner = Session(TT.CAST_CONF, device="cpu")
    for n_part in (1, 2):
        typed = TT.typed_select(text_planner.create_dataframe(
            text_hb, n_partitions=n_part))
        plans = [tpch.QUERIES[q]({"lineitem": typed}).plan for q in (1, 6)]
        plans.append(TT.filtered_export(text_planner.create_dataframe(
            export_hb, n_partitions=n_part)).plan)
        for what, plan in zip(("text q1", "text q6", "export"), plans):
            for p in walk_plan(text_planner.physical_plan(plan)):
                if isinstance(p, TpuFusedSegmentExec):
                    segments.setdefault(p.program.key, (what, p.program))
    clean_host = {name: tpch_datagen.tables(name, SF, SEED,
                                            cols=all_cols)[table]
                  for name, (_q, table) in TC.QUERIES.items()}
    clean_planner = Session(TC.CLEAN_CONF, device="cpu")
    for name, (query, _table) in TC.QUERIES.items():
        for n_part in (1, 2):
            for p in walk_plan(clean_planner.physical_plan(query(
                    clean_planner.create_dataframe(
                        clean_host[name], n_partitions=n_part)).plan)):
                if isinstance(p, TpuFusedSegmentExec):
                    segments.setdefault(p.program.key, (name, p.program))
    dist_host = {q: {"lineitem": hb} if q == 1 else host[q] for q in DIST}
    for q, n_part in DIST_CELLS:
        tabs = {t: planner.create_dataframe(b, n_partitions=n_part)
                for t, b in dist_host[q].items()}
        for p in walk_plan(planner.physical_plan(
                tpch.QUERIES[q](tabs).plan)):
            if isinstance(p, TpuFusedSegmentExec):
                segments.setdefault(p.program.key, (f"distributed q{q}",
                                                    p.program))
    for q in ROLLUP:
        for n_part in (1, 2):
            tabs = {t: planner.create_dataframe(b, n_partitions=n_part)
                    for t, b in rollup_host[q].items()}
            query = tpcxbb.q24 if q == "q24" else RU.QUERIES[q]
            for p in walk_plan(planner.physical_plan(query(tabs).plan)):
                if isinstance(p, TpuFusedSegmentExec):
                    segments.setdefault(p.program.key, (q, p.program))
    # the ML hand-off's plans (phase 2k): the segment sources depend on
    # the types alone, so a small Mortgage draw plans them
    ml_host = {q: tpcxbb.query_tables(bb_gen, q) for q in tpcxbb.ML_PREP}
    small_mortgage = M.tables(0.01, MORTGAGE_SEED)
    for n_part in (1, 2):
        mt = {t: planner.create_dataframe(b, n_partitions=n_part)
              for t, b in small_mortgage.items()}
        plans = [("mortgage", M.etl(mt).plan), ("mortgage", M.summary(mt)
                                                 .plan)]
        plans += [(f"q{q}", tpcxbb.QUERIES[q]({
            t: planner.create_dataframe(b, n_partitions=n_part)
            for t, b in ml_host[q].items()}).plan) for q in tpcxbb.ML_PREP]
        for what, plan in plans:
            for p in walk_plan(planner.physical_plan(plan)):
                if isinstance(p, TpuFusedSegmentExec):
                    segments.setdefault(p.program.key, (what, p.program))
    require({"mortgage", "q20"} <= {q for q, _p in segments.values()},
            "the Mortgage ETL or q20 planned no fused segment")
    require({"text q1", "text q6", "export"} <=
            {q for q, _p in segments.values()},
            "the text ingest or export planned no fused segment")
    # the reference fuses customer_clean's Filter -> Project; the lone
    # Project of orders_profile is no segment (a segment has two members)
    require({q for q, _p in segments.values() if q in TC.QUERIES}
            == {"customer_clean"},
            "customer_clean planned no fused segment, or orders_profile one")
    require(sorted(q for q, _p in segments.values() if q in FUSED)
            == sorted(FUSED),
            f"expected one segment source per fused query of Q1-Q14, got "
            f"{[(k, q) for k, (q, _p) in segments.items()]}")
    require({q for q, _p in segments.values()} >= set(LATER),
            "a later query planned no fused segment")
    t0 = time.perf_counter()
    _build.CUDA.prepare({k: p.source for k, (_q, p) in segments.items()})
    log(f"K12 codegen build: {len(segments)} generated sources, "
        f"{time.perf_counter() - t0:.1f} s ({len(segments)} nvcc in "
        f"parallel)")
    for key, (q, p) in segments.items():
        log_ptxas_summary((_build.BUILD_ROOT / f"k12-{key}" /
                           "build.log").read_text())
        log(f"K12 segment of Q{q} ({key}): {p.describe()}")
    counters = {"K1": [S.SORT_LAUNCHES], "K2": [S.SEGMENT_IDS_LAUNCHES],
                "K3": [S.SEGMENT_REDUCE_LAUNCHES],
                "K4": [G.GATHER_LAUNCHES, G.COMPACT_LAUNCHES],
                "K5": [J.JOIN_PROBE_LAUNCHES],
                "K6": [J.JOIN_EXPAND_LAUNCHES],
                "K7": [J.GATHER_SIDE_LAUNCHES],
                "K8": [SK.STRING_COMPARE_LAUNCHES],
                "K9": [H.HASH_LAUNCHES],
                "K10": [DS.BUILD_LAUNCHES, DS.SLICE_LAUNCHES],
                "K11": [EX.RANGE_PID_LAUNCHES],
                "K12": [FK.FUSED_LAUNCHES],
                "K13": [SK.STRING_SEARCH_LAUNCHES],
                "K14": [W.WINDOW_LAUNCHES],
                "K15": [SK.STRING_TRANSFORM_LAUNCHES],
                "K16": [CK.CAST_PARSE_LAUNCHES],
                "K17": [CK.CAST_FORMAT_LAUNCHES],
                "K18": [SK.STRING_CONCAT_LAUNCHES],
                "K19": [SK.STRING_CASE_LAUNCHES],
                "K20": [SK.STRING_TRIM_LAUNCHES],
                "K21": [SK.STRING_REPLACE_LAUNCHES],
                "B.5": [S.STRING_MINMAX_LAUNCHES],
                "K22": [GK.EXPLODE_LAUNCHES],
                "K23": [GK.EXPAND_LAUNCHES],
                "K24": [DS.TILE_LAUNCHES],
                "K25": [DS.SPLIT_LAUNCHES],
                "K26": [XK.FEATURE_LAUNCHES],
                "K27": [R.RETILE_MAX_LAUNCHES, R.RETILE_TRIM_LAUNCHES]}
    # the string transforms and string min/max run in phase 2g alone
    # (and the explode and expand kernels in phase 2h alone)
    text_kernels = [CK.CAST_PARSE_LAUNCHES, CK.CAST_FORMAT_LAUNCHES,
                    SK.STRING_CONCAT_LAUNCHES, SK.STRING_CASE_LAUNCHES,
                    SK.STRING_TRIM_LAUNCHES, SK.STRING_REPLACE_LAUNCHES,
                    S.STRING_MINMAX_LAUNCHES, GK.EXPLODE_LAUNCHES,
                    GK.EXPAND_LAUNCHES]
    all_counters = [c for cs in counters.values() for c in cs]
    # the wrappers each query's plan reaches: Q6 has no group keys, so no
    # sort, no segment ids and no gather by a sort permutation; Q4's semi
    # join compacts the left side instead of expanding pairs; Q3's
    # customer filter runs inside its fused segment (K12), so K8 launches
    # in Q12 alone (its aggregate's isin); K13 runs Q14's like
    join_kernels = [S.SORT_LAUNCHES, S.SEGMENT_IDS_LAUNCHES,
                    G.GATHER_LAUNCHES, G.COMPACT_LAUNCHES,
                    J.JOIN_PROBE_LAUNCHES, J.JOIN_EXPAND_LAUNCHES,
                    J.GATHER_SIDE_LAUNCHES, S.SEGMENT_REDUCE_LAUNCHES]
    must_launch = {
        1: [S.SORT_LAUNCHES, S.SEGMENT_IDS_LAUNCHES,
            S.SEGMENT_REDUCE_LAUNCHES, G.GATHER_LAUNCHES,
            G.COMPACT_LAUNCHES],
        6: [S.SEGMENT_REDUCE_LAUNCHES, G.COMPACT_LAUNCHES],
        3: join_kernels + [FK.FUSED_LAUNCHES],
        4: [G.COMPACT_LAUNCHES, J.JOIN_PROBE_LAUNCHES],
        12: join_kernels + [FK.FUSED_LAUNCHES, SK.STRING_COMPARE_LAUNCHES],
        13: join_kernels + [FK.FUSED_LAUNCHES],
        14: join_kernels + [FK.FUSED_LAUNCHES, SK.STRING_SEARCH_LAUNCHES],
    }
    # no TPC-H query runs a window (K14)
    must_not_launch = {
        1: [FK.FUSED_LAUNCHES], 6: [FK.FUSED_LAUNCHES],
        4: [FK.FUSED_LAUNCHES],
        3: [SK.STRING_COMPARE_LAUNCHES, SK.STRING_SEARCH_LAUNCHES],
        12: [SK.STRING_SEARCH_LAUNCHES],
        13: [SK.STRING_COMPARE_LAUNCHES, SK.STRING_SEARCH_LAUNCHES],
        14: [SK.STRING_COMPARE_LAUNCHES],
    }
    for q in must_not_launch:  # no window, no substring, no cast, no concat
        must_not_launch[q] += [W.WINDOW_LAUNCHES,
                               SK.STRING_TRANSFORM_LAUNCHES] + text_kernels
    # partial aggregates a query runs (Q13 two: per customer, per count)
    # and join pairs
    n_partial = {13: 2}
    n_pairs = {3: 2, 4: 1, 12: 1, 13: 1, 14: 1}
    sizes = {q: {} for q in JOINED}
    want = {1: O.numpy_q1(hb), 6: O.numpy_q6(hb)}
    for q in JOINED:
        want[q] = O.answer(q, host[q], sizes[q])
        log(f"Q{q} table sizes after each filter and join (numpy): "
            f"{sizes[q]}")
    queries = (1, 6, 3, 4, 12, 13, 14)

    def segment_batches(q, n_part):
        """Reader batches of the table under Q{q}'s fused segment: each
        partition's rows in pieces of at most READER_ROWS."""
        table = {3: "customer", 12: "lineitem", 13: "orders",
                 14: "lineitem"}[q]
        part_rows = -(-host[q][table].num_rows // n_part)
        return n_part * -(-part_rows // READER_ROWS)

    def check_launches(q, what):
        for c in must_launch[q]:
            require(c.count > 0, f"Q{q}{what}: wrapper {c.name} launched "
                    "no kernel")
        for c in must_not_launch[q]:
            require(c.count == 0, f"Q{q}{what}: wrapper {c.name} "
                    f"launched {c.count} kernels, none expected")

    def run(q):
        return tpch.QUERIES[q](tables[q]).collect()

    cold = {}
    results = {}
    launches = {}  # query -> kernel -> CUDA kernels launched in its run
    for q in queries:
        torch.cuda.synchronize()
        for c in all_counters:
            c.reset()
        t0 = time.perf_counter()
        results[q] = run(q)
        cold[q] = time.perf_counter() - t0
        launches[q] = {k: sum(c.count for c in cs)
                       for k, cs in counters.items()}
        by_wrapper = {c.name: c.count for c in all_counters}
        log(f"Q{q} launches: {launches[q]} {by_wrapper}")
        check_launches(q, "")
        m = sess.last_metrics
        require(m.get("TpuHashAggregateExec[partial].numInputBatches") ==
                n_partial.get(q, 1),
                f"Q{q}: a partial aggregate did not receive exactly one "
                f"batch: {m}")
        if q in FUSED:
            require(m.get("TpuFusedSegmentExec.numInputBatches") ==
                    segment_batches(q, 1),
                    f"Q{q}: the fused segment did not run once a reader "
                    f"batch: {m}")
        if q in JOINED:
            pairs = m.get("TpuHashJoinExec.numJoinedPairs")
            require(pairs == n_pairs[q] and
                    m.get("TpuHashJoinExec.numLeftBatches") == pairs and
                    m.get("TpuHashJoinExec.numRightBatches") == pairs,
                    f"Q{q}: a join side did not arrive as one batch: {m}")
    for q in queries:
        check_rows(results[q], want[q], f"Q{q}")
        log(f"Q{q} rows match numpy: {results[q]}")
    plan3 = str(sess.physical_plan(tpch.q3(tables[3]).plan))
    require(plan3.count("TpuShuffledHashJoin[inner]") == 2 and
            plan3.count("TpuFusedSegment[2: TpuFilter[(c_mktsegment == "
                        "'BUILDING')] -> TpuProject[c_custkey]]") == 1,
            f"Q3 does not plan two shuffled hash joins and the reference's "
            f"fused customer segment:\n{plan3}")
    log(f"Q3 device plan:\n{plan3}")

    # the unfused route: Q3 once with fusion off (its customer filter
    # then runs on K8 and K4, its project as torch copies)
    unfused = Session({"spark.rapids.tpu.sql.fusion.enabled": False})
    tables_unfused = {t: unfused.create_dataframe(b, n_partitions=1)
                      for t, b in host[3].items()}
    torch.cuda.synchronize()
    for c in all_counters:
        c.reset()
    t0 = time.perf_counter()
    rows = tpch.q3(tables_unfused).collect()
    unfused_s = time.perf_counter() - t0
    check_rows(rows, want[3], "Q3 fusion off")
    require(SK.STRING_COMPARE_LAUNCHES.count > 0 and
            FK.FUSED_LAUNCHES.count == 0,
            "Q3 with fusion off did not run its filter through K8 alone")
    unfused_launches = {k: sum(c.count for c in cs)
                        for k, cs in counters.items()}
    log(f"Q3 fusion off rows match numpy (cold {unfused_s * 1e3:.1f} ms; "
        f"launches {unfused_launches})")

    # one more run of each join query, recording every join's input and
    # output row counts and keeping Q3's second join's inputs for phase 3
    joined = []
    join_impl = TpuHashJoinExec._join

    def recording_join(self, lb, rb):
        out = join_impl(self, lb, rb)
        joined.append((self, lb, rb, out))
        return out

    TpuHashJoinExec._join = recording_join
    try:
        for q in (3, 4):
            joined.clear()
            run(q)
            for ex, lb, rb, out in joined:
                log(f"Q{q} {ex.describe()}: left {int(lb.num_rows)} rows "
                    f"({lb.padded_rows} padded), right {int(rb.num_rows)} "
                    f"({rb.padded_rows}), out {int(out.num_rows)} "
                    f"({out.padded_rows})")
            if q == 3:
                q3_join2 = joined[-1]
    finally:
        TpuHashJoinExec._join = join_impl

    warm = {}
    for q in queries:
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(q)
            runs.append(time.perf_counter() - t0)
        warm[q] = statistics.median(runs)
        log(f"Q{q} SF{SF:g} wall: cold {cold[q] * 1e3:.1f} ms, warm "
            f"{warm[q] * 1e3:.1f} ms (median of 3) on {card}")

    for q in queries:
        profile_query(f"Q{q}", lambda: run(q))

    # ---- 2b. the reference's default: two partitions ----------------------
    t0 = time.perf_counter()
    tables2 = {q: {t: sess.create_dataframe(b) for t, b in host[q].items()}
               for q in JOINED}
    tables2[1] = {"lineitem": sess.create_dataframe(hb)}
    tables2[6] = tables2[1]
    require(all(df.plan.n_partitions == 2 for ts in tables2.values()
                for df in ts.values()),
            "the two-partition tables are not split over two partitions")
    log(f"two-partition tables generated in "
        f"{time.perf_counter() - t0:.1f} s")
    exchange_kernels = [H.HASH_LAUNCHES, DS.BUILD_LAUNCHES,
                        DS.SLICE_LAUNCHES, EX.RANGE_PID_LAUNCHES]

    def run2(q):
        return tpch.QUERIES[q](tables2[q]).collect()

    cold2 = {}
    launches2 = {}
    for q in queries:
        torch.cuda.synchronize()
        for c in all_counters:
            c.reset()
        DS.GLOBAL.reset()
        t0 = time.perf_counter()
        rows = run2(q)
        cold2[q] = time.perf_counter() - t0
        log(f"Q{q} two partitions: packed exchange blocks "
            f"{DS.GLOBAL.counters()['deviceBytes']} bytes")
        launches2[q] = {k: sum(c.count for c in cs)
                        for k, cs in counters.items()}
        by_wrapper = {c.name: c.count for c in all_counters}
        log(f"Q{q} two partitions launches: {launches2[q]} {by_wrapper}")
        for c in exchange_kernels:
            # Q6's only exchange is a single one; Q14 broadcasts part (its
            # 6.6 MB estimate is under broadcastSizeThreshold, as in the
            # reference's plan) and sorts nothing
            live = q not in (6, 14)
            require((c.count > 0) == live, f"Q{q} at two partitions: "
                    f"wrapper {c.name} launched {c.count} kernels")
        check_launches(q, " at two partitions")
        m = sess.last_metrics
        require(m.get("TpuHashAggregateExec[partial].numInputBatches") ==
                2 * n_partial.get(q, 1),
                f"Q{q} at two partitions: each partition's partial "
                f"aggregate did not receive one batch: {m}")
        if q in FUSED:
            require(m.get("TpuFusedSegmentExec.numInputBatches") ==
                    segment_batches(q, 2),
                    f"Q{q} at two partitions: the fused segment did not "
                    f"run once a reader batch: {m}")
        if q in JOINED:
            pairs = m.get("TpuHashJoinExec.numJoinedPairs")
            require(pairs == 2 * n_pairs[q] and
                    m.get("TpuHashJoinExec.numLeftBatches") == pairs and
                    m.get("TpuHashJoinExec.numRightBatches") == pairs,
                    f"Q{q} at two partitions: a join side did not arrive "
                    f"as one batch a partition: {m}")
        for pl in sess.last_placements:
            log(f"Q{q} placement {pl['exchange']}: rows written "
                f"{pl['rows_written']}, per partition "
                f"{pl['partition_rows']}")
            require(sum(pl["partition_rows"]) == pl["rows_written"],
                    f"Q{q}: {pl['exchange']} lost or duplicated rows")
        require(len(sess.last_placements) ==
                {1: 2, 6: 0, 3: 6, 4: 4, 12: 4, 13: 5, 14: 0}[q],
                f"Q{q} at two partitions planned "
                f"{len(sess.last_placements)} multi-partition exchanges")
        check_rows(rows, want[q], f"Q{q} two partitions")
        log(f"Q{q} two partitions rows match numpy: {rows}")
    plan3 = str(sess.physical_plan(tpch.q3(tables2[3]).plan))
    require(plan3.count("TpuShuffledHashJoin[inner]") == 2 and
            plan3.count("HashPartitioning(") == 5 and
            "RangePartitioning(2)" in plan3,
            f"Q3 at two partitions does not plan two shuffled joins over "
            f"hash exchanges, a hash-partitioned aggregate and a range "
            f"exchange under the sort:\n{plan3}")
    log(f"Q3 two-partition device plan:\n{plan3}")

    # one more run of Q3 and Q4, keeping K9's, K10's and K11's inputs
    recorded = {"hash": [], "build": [], "range": []}
    hash_impl, build_impl = H.hash_pids, DS.packed_build
    range_impl = EX.range_pids_from_bounds
    current = {}

    def rec_hash(cols, n_out, kernels=None, seed=H.SEED):
        recorded["hash"].append((current["q"], cols, n_out))
        return hash_impl(cols, n_out, kernels, seed)

    def rec_build(batch, pids, n_out, kernels=None):
        recorded["build"].append((current["q"], batch, pids, n_out))
        return build_impl(batch, pids, n_out, kernels)

    def rec_range(passes, bounds, kernels=None):
        recorded["range"].append((current["q"], passes, bounds))
        return range_impl(passes, bounds, kernels)

    H.hash_pids, DS.packed_build = rec_hash, rec_build
    EX.range_pids_from_bounds = rec_range
    try:
        for q in (3, 4):
            current["q"] = q
            run2(q)
    finally:
        H.hash_pids, DS.packed_build = hash_impl, build_impl
        EX.range_pids_from_bounds = range_impl

    warm2 = {}
    for q in queries:
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run2(q)
            runs.append(time.perf_counter() - t0)
        warm2[q] = statistics.median(runs)
        log(f"Q{q} SF{SF:g} two partitions wall: cold "
            f"{cold2[q] * 1e3:.1f} ms, warm {warm2[q] * 1e3:.1f} ms (median "
            f"of 3); one partition: cold {cold[q] * 1e3:.1f} ms, warm "
            f"{warm[q] * 1e3:.1f} ms; on {card}")

    for q in queries:
        profile_query(f"Q{q} (two partitions)", lambda: run2(q))

    # ---- 2c. TPCx-BB q30 and the clickstream windows ----------------------
    t0 = time.perf_counter()
    bb_host = tpcxbb_datagen.tables_of(bb_gen,
                                       names=("web_clickstreams", "item"))
    bb_sizes = {}
    want30 = numpy_q30(bb_host, bb_sizes)
    clicks_host = bb_host["web_clickstreams"]
    want_cs = numpy_clickstream(clicks_host)
    log(f"TPCx-BB SF{BB_SF:g} (seed {BB_SEED}) generated and answered in "
        f"numpy in {time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{t} {b.num_rows} x {len(b.schema)}" for t, b in bb_host.items()))
    log(f"q30 table sizes after the join, distinct, self-join and filter "
        f"(numpy): {bb_sizes}")
    # q30: a broadcast join with item (planned on both sides of the
    # self-join), the distinct twice, the self-join, the pair count, the
    # window and its fused filter; K8 and K13 (strings) stay idle
    q30_kernels = join_kernels + [FK.FUSED_LAUNCHES, W.WINDOW_LAUNCHES]
    bb_tables = {}
    bb_runs = {}
    for n_part in (1, 2):
        tabs = {t: sess.create_dataframe(b, n_partitions=n_part)
                for t, b in bb_host.items()}
        bb_tables[n_part] = tabs
        bb_runs[n_part] = (lambda tabs=tabs:
                           tpcxbb.q30(tabs).collect())
        where = launches if n_part == 1 else launches2
        torch.cuda.synchronize()
        for c in all_counters:
            c.reset()
        t0 = time.perf_counter()
        rows = bb_runs[n_part]()
        cold[f"q30/{n_part}"] = time.perf_counter() - t0
        where["q30"] = {k: sum(c.count for c in cs)
                        for k, cs in counters.items()}
        log(f"q30 {n_part} partition(s) launches: {where['q30']} "
            f"{ {c.name: c.count for c in all_counters} }")
        for c in q30_kernels + (exchange_kernels if n_part == 2 else []):
            require(c.count > 0, f"q30 at {n_part} partition(s): wrapper "
                    f"{c.name} launched no kernel")
        for c in (SK.STRING_COMPARE_LAUNCHES, SK.STRING_SEARCH_LAUNCHES):
            require(c.count == 0, f"q30: wrapper {c.name} launched")
        m = sess.last_metrics
        pairs = m.get("TpuHashJoinExec.numJoinedPairs")
        require(m.get("TpuHashAggregateExec[partial].numInputBatches") ==
                3 * n_part and pairs == 3 * n_part and
                m.get("TpuHashJoinExec.numLeftBatches") == pairs and
                m.get("TpuHashJoinExec.numRightBatches") == pairs and
                m.get("TpuWindowExec.numInputBatches") == n_part,
                f"q30 at {n_part} partition(s): an aggregate, join side or "
                f"window did not receive one batch a partition: {m}")
        for pl in sess.last_placements:
            log(f"q30 placement {pl['exchange']}: rows written "
                f"{pl['rows_written']}, per partition {pl['partition_rows']}")
            require(sum(pl["partition_rows"]) == pl["rows_written"],
                    f"q30: {pl['exchange']} lost or duplicated rows")
        check_rows(rows, want30, f"q30 at {n_part} partition(s)")
        log(f"q30 {n_part} partition(s) rows match numpy: {rows}")
    log("q30 two-partition device plan:\n" + str(sess.physical_plan(
        tpcxbb.q30(bb_tables[2]).plan)))

    # the clickstream windows at the default two partitions
    cs_table = {"web_clickstreams": sess.create_dataframe(clicks_host)}
    require(cs_table["web_clickstreams"].plan.n_partitions == 2,
            "the clickstream is not split over two partitions")

    def run_cs():
        return tpcxbb.clickstream_windows(cs_table)._result_batch()

    torch.cuda.synchronize()
    for c in all_counters:
        c.reset()
    t0 = time.perf_counter()
    out_cs = run_cs()
    cold["clickstream/2"] = time.perf_counter() - t0
    launches2["clickstream"] = {k: sum(c.count for c in cs)
                                for k, cs in counters.items()}
    log(f"clickstream launches: {launches2['clickstream']} "
        f"{ {c.name: c.count for c in all_counters} }")
    for c in (S.SORT_LAUNCHES, S.SEGMENT_IDS_LAUNCHES, G.GATHER_LAUNCHES,
              W.WINDOW_LAUNCHES, H.HASH_LAUNCHES, DS.BUILD_LAUNCHES,
              DS.SLICE_LAUNCHES):
        require(c.count > 0, f"clickstream: wrapper {c.name} launched no "
                "kernel")
    require(sess.last_metrics.get("TpuWindowExec.numInputBatches") == 6,
            f"clickstream: a window did not receive one batch a partition: "
            f"{sess.last_metrics}")
    require(len(sess.last_placements) == 3,
            "clickstream: expected one hash exchange a window node")
    for pl in sess.last_placements:
        log(f"clickstream placement {pl['exchange']}: rows written "
            f"{pl['rows_written']}, per partition {pl['partition_rows']}")
        require(sum(pl["partition_rows"]) == pl["rows_written"]
                == clicks_host.num_rows,
                f"clickstream: {pl['exchange']} lost or duplicated rows")
    oc = {f.name: c for f, c in zip(out_cs.schema, out_cs.columns)}
    require(out_cs.num_rows == clicks_host.num_rows and all(
        c.validity is None for c in out_cs.columns),
        "clickstream: row count or a null result")
    by_user = np.lexsort((oc["click_no"].data, oc["wcs_user_sk"].data))
    order_cs, rn_cs, sum5_cs, min5_cs = want_cs
    src = {f.name: c.data for f, c in zip(clicks_host.schema,
                                          clicks_host.columns)}
    for name, want_col in [(n, a[order_cs]) for n, a in src.items()] + [
            ("click_no", rn_cs), ("sales_last5", sum5_cs),
            ("min_time_5", min5_cs)]:
        got_col = oc[name].data[by_user]
        require(got_col.dtype == want_col.dtype and
                np.array_equal(got_col, want_col),
                f"clickstream column {name} differs from numpy")
    log(f"clickstream rows match numpy: {out_cs.num_rows} rows, "
        f"{int(rn_cs.max())} clicks in the longest history, "
        f"{int((rn_cs == 1).sum())} users")

    bb_cells = {"q30/1": bb_runs[1], "q30/2": bb_runs[2],
                "clickstream/2": run_cs}
    for cell, fn in bb_cells.items():
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t0)
        warm[cell] = statistics.median(runs)
        log(f"{cell} partition(s) SF{BB_SF:g} wall: cold "
            f"{cold[cell] * 1e3:.1f} ms, warm {warm[cell] * 1e3:.1f} ms "
            f"(median of 3) on {card}")
    for cell, fn in bb_cells.items():
        profile_query(f"{cell} partition(s)", fn)

    # ---- 2d. the other fifteen TPC-H queries, two partitions --------------
    t0 = time.perf_counter()
    later_sizes = {q: {} for q in LATER}
    for q in LATER:
        want[q] = O.answer(q, host[q], later_sizes[q])
        log(f"Q{q} table sizes after each filter and join (numpy): "
            f"{later_sizes[q]}")
    log(f"Q{', Q'.join(map(str, LATER))} answered in numpy in "
        f"{time.perf_counter() - t0:.1f} s")
    later_tables = {q: {t: sess.create_dataframe(b)
                        for t, b in host[q].items()} for q in LATER}

    def run_later(q):
        return tpch.QUERIES[q](later_tables[q]).collect()

    # every later query joins (K1 sorts, K4 gathers, K5 probes) and runs a
    # fused segment (K12); none runs a window (K14), and Q22's substring
    # runs inside its K12 segment, so K15 stays idle with fusion on
    later_must = [S.SORT_LAUNCHES, G.GATHER_LAUNCHES, G.COMPACT_LAUNCHES,
                  J.JOIN_PROBE_LAUNCHES, FK.FUSED_LAUNCHES]
    later_must_not = [W.WINDOW_LAUNCHES, SK.STRING_TRANSFORM_LAUNCHES] \
        + text_kernels
    for q in LATER:
        torch.cuda.synchronize()
        for c in all_counters:
            c.reset()
        t0 = time.perf_counter()
        rows = run_later(q)
        cold2[q] = time.perf_counter() - t0
        launches2[q] = {k: sum(c.count for c in cs)
                        for k, cs in counters.items()}
        log(f"Q{q} two partitions launches: {launches2[q]} "
            f"{ {c.name: c.count for c in all_counters} }")
        for c in later_must:
            require(c.count > 0, f"Q{q}: wrapper {c.name} launched no "
                    "kernel")
        for c in later_must_not:
            require(c.count == 0, f"Q{q}: wrapper {c.name} launched "
                    f"{c.count} kernels, none expected")
        m = sess.last_metrics
        log(f"Q{q} batches: " + ", ".join(
            f"{k} {v}" for k, v in sorted(m.items()) if "Batches" in k
            or "Pairs" in k))
        for pl in sess.last_placements:
            log(f"Q{q} placement {pl['exchange']}: rows written "
                f"{pl['rows_written']}, per partition "
                f"{pl['partition_rows']}")
            require(sum(pl["partition_rows"]) == pl["rows_written"],
                    f"Q{q}: {pl['exchange']} lost or duplicated rows")
        require(len(rows) > 0, f"Q{q} returned no rows")
        check_rows(rows, want[q], f"Q{q} two partitions",
                   ordered=q not in O.UNORDERED)
        log(f"Q{q} two partitions rows match numpy: {len(rows)} rows, "
            f"first {rows[:2]}")
    for q in (8, 22):
        log(f"Q{q} two-partition device plan:\n" + str(sess.physical_plan(
            tpch.QUERIES[q](later_tables[q]).plan)))

    # Q22 with fusion off: its substring runs on K15
    unfused22 = {t: unfused.create_dataframe(b) for t, b in host[22].items()}
    torch.cuda.synchronize()
    for c in all_counters:
        c.reset()
    t0 = time.perf_counter()
    rows = tpch.q22(unfused22).collect()
    cold["q22 fusion off"] = time.perf_counter() - t0
    launches_q22_unfused = {k: sum(c.count for c in cs)
                            for k, cs in counters.items()}
    require(SK.STRING_TRANSFORM_LAUNCHES.count > 0 and
            FK.FUSED_LAUNCHES.count == 0,
            "Q22 with fusion off did not run its substring on K15")
    check_rows(rows, want[22], "Q22 fusion off", ordered=False)
    log(f"Q22 fusion off rows match numpy (cold "
        f"{cold['q22 fusion off'] * 1e3:.1f} ms; launches "
        f"{launches_q22_unfused})")

    # one more run of Q8 and Q22, keeping each segment's first input
    # batch for phase 3
    seg_inputs = {}
    seg_impl = TpuFusedSegmentExec._compute

    def recording_segment(self, batch):
        seg_inputs.setdefault(self.program.key, batch)
        return seg_impl(self, batch)

    TpuFusedSegmentExec._compute = recording_segment
    try:
        for q in (8, 22):
            run_later(q)
    finally:
        TpuFusedSegmentExec._compute = seg_impl

    for q in LATER:
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_later(q)
            runs.append(time.perf_counter() - t0)
        warm2[q] = statistics.median(runs)
        log(f"Q{q} SF{SF:g} two partitions wall: cold "
            f"{cold2[q] * 1e3:.1f} ms, warm {warm2[q] * 1e3:.1f} ms (median "
            f"of 3) on {card}")
    for q in LATER:
        profile_query(f"Q{q} (two partitions)", lambda: run_later(q))

    # ---- 2e. the text ingest: dbgen's text cast to TPC-H's types --------
    cast_sess = Session(TT.CAST_CONF)
    cast_unfused = Session({**TT.CAST_CONF,
                            "spark.rapids.tpu.sql.fusion.enabled": False})
    want_text = {1: O.numpy_q1(typed_hb), 6: O.numpy_q6(typed_hb)}
    tsd = typed_hb.column("l_shipdate").data
    log(f"text ingest sizes (numpy): {typed_hb.num_rows} lines; Q1's filter "
        f"keeps {int((tsd <= O._days(1998, 9, 2)).sum())}, Q6's 1994 "
        f"shipdates {int(((tsd >= O._days(1994, 1, 1)) & (tsd < O._days(1995, 1, 1))).sum())}")
    text_runs = {}      # cell -> callable
    text_launches = {}  # cell -> kernel -> CUDA kernels in its cold run
    text_frames = {}
    for label, tsess, n_part in (("2", cast_sess, 2), ("1", cast_sess, 1),
                                 ("2 fusion off", cast_unfused, 2)):
        typed = TT.typed_select(tsess.create_dataframe(
            text_hb, n_partitions=n_part))
        text_frames[label] = typed
        for q in (1, 6):
            cell = f"text q{q}/{label}"
            text_runs[cell] = (lambda q=q, typed=typed: tpch.QUERIES[q](
                {"lineitem": typed}).collect())
            torch.cuda.synchronize()
            for c in all_counters:
                c.reset()
            t0 = time.perf_counter()
            rows = text_runs[cell]()
            cold[cell] = time.perf_counter() - t0
            text_launches[cell] = {k: sum(c.count for c in cs)
                                   for k, cs in counters.items()}
            log(f"{cell} launches: {text_launches[cell]} "
                f"{ {c.name: c.count for c in all_counters} }")
            fused = "fusion off" not in label
            require((FK.FUSED_LAUNCHES.count > 0) == fused and
                    (CK.CAST_PARSE_LAUNCHES.count > 0) != fused,
                    f"{cell}: the parses did not run in K12 alone (fusion "
                    f"on) or in K16 alone (fusion off)")
            for c in (CK.CAST_FORMAT_LAUNCHES, SK.STRING_CONCAT_LAUNCHES):
                require(c.count == 0, f"{cell}: wrapper {c.name} launched")
            log(f"{cell} batches: " + ", ".join(
                f"{k} {v}" for k, v in sorted(tsess.last_metrics.items())
                if "Batches" in k))
            check_rows(rows, want_text[q], cell)
            log(f"{cell} rows match numpy on the typed columns: {rows}")
    log("text q1/2 device plan:\n" + str(cast_sess.physical_plan(
        tpch.q1({"lineitem": text_frames["2"]}).plan)))

    # the cast table itself, read back (a lone Project: K16)
    for c in all_counters:
        c.reset()
    t0 = time.perf_counter()
    cast_tb = text_frames["2"]._result_batch()
    cast_table_s = time.perf_counter() - t0
    require(CK.CAST_PARSE_LAUNCHES.count > 0,
            "the cast table did not parse on K16")
    got_cols = {f.name: c for f, c in zip(cast_tb.schema, cast_tb.columns)}
    for f, want_c in zip(typed_hb.schema, typed_hb.columns):
        g = got_cols[f.name]
        require(g.validity is None or bool(g.validity.all()),
                f"cast table: nulls in {f.name}")
        if f.name == "l_extendedprice":
            ulps = np.abs(g.data.view(np.int64) - want_c.data.view(np.int64))
            require(int(ulps.max()) <= 1,
                    f"cast table: l_extendedprice {int(ulps.max())} ULPs off")
            log(f"cast table: l_extendedprice within 1 ULP of the typed "
                f"column; {int((ulps == 1).sum())} of {len(ulps)} rows "
                f"({(ulps == 1).mean():.4f}) 1 ULP off")
        elif f.dtype.is_string:
            require(np.array_equal(g.data, want_c.data) and
                    np.array_equal(g.lengths, want_c.lengths),
                    f"cast table: {f.name} differs")
        else:
            require(g.data.dtype == want_c.data.dtype and
                    np.array_equal(g.data, want_c.data),
                    f"cast table: {f.name} differs")
    log(f"cast table read back in {cast_table_s * 1e3:.1f} ms: "
        f"{cast_tb.num_rows} rows; l_orderkey, l_quantity, l_discount, "
        f"l_tax, l_shipdate and the flags exact")

    # ---- 2f. the text export: typed lineitem back to dbgen's text -------
    smode = export_hb.column("l_shipmode")
    not_air = O._text(smode) != b"AIR"
    export_frames = {n: cast_sess.create_dataframe(export_hb, n_partitions=n)
                     for n in (2, 1)}

    def check_lines(out, keep, what):
        line = out.columns[0]
        require(out.num_rows == int(keep.sum()) and (
            line.validity is None or bool(line.validity.all())),
            f"{what}: {out.num_rows} lines or nulls")
        wbm, wln = want_lines[0][keep], want_lines[1][keep]
        w = line.data.shape[1]
        require(w >= wbm.shape[1] and np.array_equal(line.lengths, wln)
                and np.array_equal(line.data[:, :wbm.shape[1]], wbm)
                and not line.data[:, wbm.shape[1]:].any(),
                f"{what}: the lines differ from numpy's bytes")
        return w

    for n_part in (2, 1):
        for kind, build, keep in (("export", TT.export_select,
                                   np.ones(export_hb.num_rows, bool)),
                                  ("export filtered", TT.filtered_export,
                                   not_air)):
            cell = f"{kind}/{n_part}"
            df = build(export_frames[n_part])
            text_runs[cell] = df._result_batch
            torch.cuda.synchronize()
            for c in all_counters:
                c.reset()
            t0 = time.perf_counter()
            out = df._result_batch()
            cold[cell] = time.perf_counter() - t0
            text_launches[cell] = {k: sum(c.count for c in cs)
                                   for k, cs in counters.items()}
            log(f"{cell} launches: {text_launches[cell]} "
                f"{ {c.name: c.count for c in all_counters} }")
            fused = kind == "export filtered"
            for c, live in ((FK.FUSED_LAUNCHES, fused),
                            (CK.CAST_FORMAT_LAUNCHES, not fused),
                            (SK.STRING_CONCAT_LAUNCHES, not fused),
                            (CK.CAST_PARSE_LAUNCHES, False)):
                require((c.count > 0) == live, f"{cell}: wrapper {c.name} "
                        f"launched {c.count} kernels")
            w = check_lines(out, keep, cell)
            log(f"{cell}: {out.num_rows} lines byte for byte equal to "
                f"numpy's ({w} bytes wide, {int(out.columns[0].lengths.sum())}"
                f" bytes of text)")
    log("export filtered/2 device plan:\n" + str(cast_sess.physical_plan(
        TT.filtered_export(export_frames[2]).plan)))

    # one more run of the ingest and the filtered export, keeping each
    # fused segment's first input and the export's K17 and K18 calls
    text_seg_inputs = {}
    fmt_calls, concat_calls = {}, []
    fmt_impl, concat_impl = CK._format, SK.concat

    def recording_text_segment(self, batch):
        text_seg_inputs.setdefault(self.program.key, batch)
        return seg_impl(self, batch)

    def rec_format(kind, values, validity, kernels):
        fmt_calls.setdefault(kind, (values, validity))
        return fmt_impl(kind, values, validity, kernels)

    def rec_concat(parts, kernels=None):
        if not concat_calls:
            concat_calls.append(list(parts))
        return concat_impl(parts, kernels)

    TpuFusedSegmentExec._compute = recording_text_segment
    CK._format, SK.concat = rec_format, rec_concat
    try:
        for cell in ("text q1/2", "export filtered/2", "export/2"):
            text_runs[cell]()
    finally:
        TpuFusedSegmentExec._compute = seg_impl
        CK._format, SK.concat = fmt_impl, concat_impl

    for cell, fn in text_runs.items():
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t0)
        warm[cell] = statistics.median(runs)
        log(f"{cell} SF{SF:g} wall: cold {cold[cell] * 1e3:.1f} ms, warm "
            f"{warm[cell] * 1e3:.1f} ms (median of 3) on {card}")
    for cell, fn in text_runs.items():
        profile_query(cell, fn)

    # ---- 2g. orders and customer cleaned as text ------------------------
    t0 = time.perf_counter()
    want_clean = {name: TC.ORACLES[name](b) for name, b in clean_host.items()}
    log(f"clean tables SF{SF:g} answered in Python in "
        f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{name} {b.num_rows} x {len(b.schema)} (widths "
            f"{[c.data.shape[1] for c in b.columns]})"
            for name, b in clean_host.items()))
    log(f"clean table sizes after the filter (Python): orders_profile "
        f"{clean_host['orders_profile'].num_rows} orders in "
        f"{len(want_clean['orders_profile'])} groups; customer_clean "
        f"{len(want_clean['customer_clean'])} of "
        f"{clean_host['customer_clean'].num_rows} customers")
    clean_sess = Session(TC.CLEAN_CONF)
    clean_unfused = Session({**TC.CLEAN_CONF,
                             "spark.rapids.tpu.sql.fusion.enabled": False})
    clean_runs = {}      # cell -> callable
    clean_frames = {}    # cell -> DataFrame
    clean_launches = {}  # cell -> kernel -> CUDA kernels in its cold run
    transform_kernels = [SK.STRING_CASE_LAUNCHES, SK.STRING_TRIM_LAUNCHES,
                         SK.STRING_REPLACE_LAUNCHES, SK.STRING_TRANSFORM_LAUNCHES,
                         CK.CAST_PARSE_LAUNCHES]
    for name, (query, _table) in TC.QUERIES.items():
        for label, csess, n_part in (("2", clean_sess, 2),
                                     ("1", clean_sess, 1),
                                     ("2 fusion off", clean_unfused, 2)):
            cell = f"{name}/{label}"
            df = query(csess.create_dataframe(clean_host[name],
                                              n_partitions=n_part))
            clean_runs[cell] = df.collect
            clean_frames[cell] = df
            torch.cuda.synchronize()
            for c in all_counters:
                c.reset()
            t0 = time.perf_counter()
            rows = df.collect()
            cold[cell] = time.perf_counter() - t0
            clean_launches[cell] = {k: sum(c.count for c in cs)
                                    for k, cs in counters.items()}
            log(f"{cell} launches: {clean_launches[cell]} "
                f"{ {c.name: c.count for c in all_counters} }")
            # with fusion on, customer_clean's expressions run inside its
            # K12 segment; orders_profile's lone Project and every
            # expression with fusion off run on K19-K21, K15 and K16 (and
            # K13 for orders_profile's locate)
            in_k12 = name == "customer_clean" and "fusion off" not in label
            require((FK.FUSED_LAUNCHES.count > 0) == in_k12,
                    f"{cell}: wrapper {FK.FUSED_LAUNCHES.name} launched "
                    f"{FK.FUSED_LAUNCHES.count} kernels")
            for c in transform_kernels:
                require((c.count > 0) != in_k12,
                        f"{cell}: wrapper {c.name} launched {c.count} "
                        "kernels")
            require((SK.STRING_SEARCH_LAUNCHES.count > 0) ==
                    (name == "orders_profile"),
                    f"{cell}: locate did not run on K13 alone")
            minmax = name == "orders_profile"
            for c in (S.SORT_LAUNCHES, S.SEGMENT_REDUCE_LAUNCHES,
                      G.GATHER_LAUNCHES, S.STRING_MINMAX_LAUNCHES):
                require((c.count > 0) == (minmax or c is S.SORT_LAUNCHES
                                          or c is G.GATHER_LAUNCHES),
                        f"{cell}: wrapper {c.name} launched {c.count} "
                        "kernels")
            for c in (W.WINDOW_LAUNCHES, CK.CAST_FORMAT_LAUNCHES,
                      SK.STRING_CONCAT_LAUNCHES):
                require(c.count == 0, f"{cell}: wrapper {c.name} launched")
            m = csess.last_metrics
            log(f"{cell} batches: " + ", ".join(
                f"{k} {v}" for k, v in sorted(m.items()) if "Batches" in k))
            if minmax:
                require(m.get("TpuHashAggregateExec[partial].numInputBatches")
                        == n_part, f"{cell}: a partial aggregate did not "
                        f"receive one batch a partition: {m}")
            for pl in csess.last_placements:
                log(f"{cell} placement {pl['exchange']}: rows written "
                    f"{pl['rows_written']}, per partition "
                    f"{pl['partition_rows']}")
                require(sum(pl["partition_rows"]) == pl["rows_written"],
                        f"{cell}: {pl['exchange']} lost or duplicated rows")
            require(len(csess.last_placements) == (
                0 if n_part == 1 else (2 if minmax else 1)),
                f"{cell} planned {len(csess.last_placements)} "
                "multi-partition exchanges")
            TC.check_rows(rows, want_clean[name], cell)
            log(f"{cell} rows match the Python oracle: {len(rows)} rows, "
                f"first {rows[:2]}")
    for name in TC.QUERIES:
        log(f"{name}/2 device plan:\n" + str(clean_sess.physical_plan(
            TC.QUERIES[name][0](clean_sess.create_dataframe(
                clean_host[name])).plan)))

    # one more run of orders_profile at one partition and customer_clean
    # with fusion off, keeping the first call of each transform, of the
    # string min/max, and customer_clean's fused segment input (its run
    # at two partitions with fusion on)
    clean_calls = {}
    rec_names = ("upper", "lower", "length", "trim_ws", "substring_index",
                 "replace_single", "locate")
    impls = {n: getattr(SK, n) for n in rec_names}
    minmax_impl = S.string_minmax

    rec_cell = [None]

    def recorder(n):
        def rec(*args, **kw):
            clean_calls.setdefault(n, []).append((rec_cell[0], args, kw))
            return impls[n](*args, **kw)
        return rec

    def rec_minmax(*args, **kw):
        clean_calls.setdefault("string_minmax", []).append(
            (rec_cell[0], args, kw))
        return minmax_impl(*args, **kw)

    for n in rec_names:
        setattr(SK, n, recorder(n))
    S.string_minmax = rec_minmax
    TpuFusedSegmentExec._compute = recording_text_segment
    try:
        for cell in ("orders_profile/1", "customer_clean/2 fusion off",
                     "customer_clean/2"):
            rec_cell[0] = cell
            clean_runs[cell]()
    finally:
        for n in rec_names:
            setattr(SK, n, impls[n])
        S.string_minmax = minmax_impl
        TpuFusedSegmentExec._compute = seg_impl

    for cell, fn in clean_runs.items():
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t0)
        warm[cell] = statistics.median(runs)
        log(f"{cell} SF{SF:g} wall: cold {cold[cell] * 1e3:.1f} ms, warm "
            f"{warm[cell] * 1e3:.1f} ms (median of 3) on {card}")
    # the wall split at the host batch: collect() is _result_batch() and
    # then the Python rows built from it
    for cell, df in clean_frames.items():
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            df._result_batch()
            runs.append(time.perf_counter() - t0)
        hb_s = statistics.median(runs)
        log(f"{cell}: host batch {hb_s * 1e3:.1f} ms (median of 3), "
            f"collect {warm[cell] * 1e3:.1f} ms: Python rows ~"
            f"{(warm[cell] - hb_s) * 1e3:.1f} ms")
    for cell, fn in clean_runs.items():
        profile_query(cell, fn)

    # ---- 2h. row-multiplying execs: q67's rollup, the unpivot, q24 ------
    t0 = time.perf_counter()
    want_rollup = {q: (tpcxbb.oracle_q24 if q == "q24" else RU.ORACLES[q])(
        rollup_host[q]) for q in ROLLUP}
    log(f"rollup path answered in numpy in {time.perf_counter() - t0:.1f} "
        f"s: q67 {len(want_rollup['q67'])} rows (first "
        f"{want_rollup['q67'][:2]}), store_unpivot "
        f"{len(want_rollup['store_unpivot'])} groups, q24 "
        f"{want_rollup['q24']}")
    c = {f.name: col for f, col in zip(
        rollup_host["q67"]["store_sales"].schema,
        rollup_host["q67"]["store_sales"].columns)}
    log(f"q67 table sizes (numpy): store_sales in {RU.YEAR} "
        f"{int(((c['ss_sold_date_sk'].data // 365) == RU.YEAR - 2001).sum())}"
        f" of {rollup_host['q67']['store_sales'].num_rows} rows, expanded "
        f"x{len(RU.KEYS) + 1}")
    no_fusion = {"spark.rapids.tpu.sql.fusion.enabled": False}
    chunk_conf = {"spark.rapids.tpu.sql.batchSizeBytes": CHUNK_BYTES}
    rollup_cells = [("q67/2", "q67", 2, {}), ("q67/1", "q67", 1, {}),
                    ("q67/2 fusion off", "q67", 2, no_fusion),
                    ("q67/2 64 MiB", "q67", 2, chunk_conf),
                    ("store_unpivot/2", "store_unpivot", 2, {}),
                    ("store_unpivot/2 fusion off", "store_unpivot", 2,
                     no_fusion),
                    ("q24/2", "q24", 2, {}), ("q24/1", "q24", 1, {})]
    rollup_runs = {}      # cell -> callable
    rollup_launches = {}  # cell -> kernel -> CUDA kernels in its cold run
    rollup_batches = {}   # cell -> the partial aggregate's input batches
    for cell, q, n_part, conf in rollup_cells:
        rsess = Session(conf)
        tabs = {t: rsess.create_dataframe(b, n_partitions=n_part)
                for t, b in rollup_host[q].items()}
        df = tpcxbb.q24(tabs) if q == "q24" else RU.QUERIES[q](tabs)
        rollup_runs[cell] = df.collect
        torch.cuda.synchronize()
        for cnt in all_counters:
            cnt.reset()
        t0 = time.perf_counter()
        rows = df.collect()
        cold[cell] = time.perf_counter() - t0
        rollup_launches[cell] = {k: sum(x.count for x in cs)
                                 for k, cs in counters.items()}
        log(f"{cell} launches: {rollup_launches[cell]} "
            f"{ {x.name: x.count for x in all_counters} }")
        # fused, q67's Project -> Expand and the unpivot's Project ->
        # Generate run in K12; unfused, on K23 and K22
        fused = "fusion off" not in cell
        want_k = {"K22": q == "store_unpivot" and not fused,
                  "K23": q == "q67" and not fused}
        for k, on in want_k.items():
            require((rollup_launches[cell][k] > 0) == on,
                    f"{cell}: {k} launched {rollup_launches[cell][k]} "
                    "kernels")
        require((FK.FUSED_LAUNCHES.count > 0) == fused,
                f"{cell}: K12 launched {FK.FUSED_LAUNCHES.count} kernels")
        for x in (S.SORT_LAUNCHES, S.SEGMENT_REDUCE_LAUNCHES,
                  G.GATHER_LAUNCHES):
            require(x.count > 0, f"{cell}: wrapper {x.name} launched no "
                    "kernel")
        require((W.WINDOW_LAUNCHES.count > 0) == (q == "q67"),
                f"{cell}: the window kernel (K14) launched "
                f"{W.WINDOW_LAUNCHES.count} kernels")
        for x in text_kernels[:-2]:
            require(x.count == 0, f"{cell}: wrapper {x.name} launched")
        m = rsess.last_metrics
        rollup_batches[cell] = m.get(
            "TpuHashAggregateExec[partial].numInputBatches")
        log(f"{cell} batches: " + ", ".join(
            f"{k} {v}" for k, v in sorted(m.items()) if "Batches" in k))
        if cell == "q67/2 64 MiB":
            require(rollup_batches[cell] > n_part,
                    f"{cell}: the partial aggregate got "
                    f"{rollup_batches[cell]} batch(es); the chunked path "
                    "did not run")
        for pl in rsess.last_placements:
            log(f"{cell} placement {pl['exchange']}: rows written "
                f"{pl['rows_written']}, per partition "
                f"{pl['partition_rows']}")
            require(sum(pl["partition_rows"]) == pl["rows_written"],
                    f"{cell}: {pl['exchange']} lost or duplicated rows")
        check_rows(rows, want_rollup[q], cell)
        log(f"{cell} rows match numpy: {len(rows)} rows, first {rows[:2]}")
    for q in ("q67", "store_unpivot"):
        ps = Session()
        log(f"{q}/2 device plan:\n" + str(ps.physical_plan(
            RU.QUERIES[q]({t: ps.create_dataframe(b) for t, b in
                           rollup_host[q].items()}).plan)))

    # one more run of the unfused cells keeping K22's and K23's first
    # calls, and of the fused ones keeping the first input of each
    # segment with an Expand or Generate member, for phase 3
    rollup_calls = {}
    rollup_seg_inputs = {}
    explode_impl, expand_impl = GK.explode, GK.expand

    def rec_explode(*args, **kw):
        rollup_calls.setdefault("explode", (args, kw))
        return explode_impl(*args, **kw)

    def rec_expand(*args, **kw):
        rollup_calls.setdefault("expand", (args, kw))
        return expand_impl(*args, **kw)

    def recording_rollup_segment(self, batch):
        if any(type(mm).__name__ in ("TpuExpandExec", "TpuGenerateExec")
               for mm in self.members):
            rollup_seg_inputs.setdefault(self.program.key,
                                         (self.program, batch))
        return seg_impl(self, batch)

    GK.explode, GK.expand = rec_explode, rec_expand
    TpuFusedSegmentExec._compute = recording_rollup_segment
    try:
        for cell in ("q67/2 fusion off", "store_unpivot/2 fusion off",
                     "q67/2", "store_unpivot/2"):
            rollup_runs[cell]()
    finally:
        GK.explode, GK.expand = explode_impl, expand_impl
        TpuFusedSegmentExec._compute = seg_impl
    require(set(rollup_calls) == {"explode", "expand"} and
            len(rollup_seg_inputs) == 2,
            "phase 2h recorded no K22/K23 call or no segment input")

    for cell, fn in rollup_runs.items():
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t0)
        warm[cell] = statistics.median(runs)
        log(f"{cell} SF{BB_SF:g} wall: cold {cold[cell] * 1e3:.1f} ms, "
            f"warm {warm[cell] * 1e3:.1f} ms (median of 3), partial "
            f"aggregate input batches {rollup_batches[cell]}, on {card}")
    for cell, fn in rollup_runs.items():
        profile_query(cell, fn)

    # ---- 2i. the distributed runner: four shards on the card, and one ---
    # every table with as many partitions as shards, so that the leaves
    # deal one source partition to each shard
    t_dist = time.perf_counter()
    meshes = {4: make_mesh(4, device="cuda"), 1: make_mesh(1)}
    dist_runs, dist_launches, dist_info, dist_rows = {}, {}, {}, {}
    for q, n in DIST_CELLS:
        tabs = {t: sess.create_dataframe(b, n_partitions=n)
                for t, b in dist_host[q].items()}
        dist_runs[f"q{q}/{n} shards"] = (
            q, lambda df=tpch.QUERIES[q](tabs), n=n: run_distributed(
                sess, df, mesh=meshes[n]).to_rows())
    # the exchange kernels of the path (K9 where it hash-partitions, K10's
    # build, K24's tiles, K4's compaction) and the queries' own
    dist_must = [DS.BUILD_LAUNCHES, DS.TILE_LAUNCHES, G.COMPACT_LAUNCHES,
                 H.HASH_LAUNCHES, S.SORT_LAUNCHES]
    for cell, (q, fn) in dist_runs.items():
        torch.cuda.synchronize()
        for c in all_counters:
            c.reset()
        t0 = time.perf_counter()
        rows = fn()
        cold[cell] = time.perf_counter() - t0
        dist_launches[cell] = {k: sum(c.count for c in cs)
                                for k, cs in counters.items()}
        log(f"{cell} launches: {dist_launches[cell]} "
            f"{ {c.name: c.count for c in all_counters} }")
        for c in dist_must:
            require(c.count > 0, f"{cell}: wrapper {c.name} launched no "
                    "kernel")
        places = sess.last_placements
        swaps = [p for p in places if p["capacity"] is not None]
        for pl in places:
            log(f"{cell} {pl['exchange']}: rows each shard got "
                f"{pl['partition_rows']}, sent {pl['rows_sent']}, capacity "
                f"{pl['capacity']}, bytes swapped {pl['bytes_swapped']}")
            if pl["capacity"] is not None:
                require(sum(pl["partition_rows"]) == pl["rows_written"],
                        f"{cell}: {pl['exchange']} lost or duplicated rows")
        dist_info[cell] = {
            "exchanges": len(swaps), "replicates": len(places) - len(swaps),
            "bytes_swapped": sum(p["bytes_swapped"] for p in places),
            "collective_ns": sess.last_metrics["shuffle.collectiveTimeNs"]}
        check_rows(rows, want[q], cell, ordered=q not in O.UNORDERED)
        dist_rows[cell] = rows
        log(f"{cell} rows match numpy: {len(rows)} rows, first {rows[:2]}; "
            f"{dist_info[cell]}")
    for cell, (q, fn) in dist_runs.items():
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t0)
        warm[cell] = statistics.median(runs)
        log(f"{cell} SF{SF:g} wall: cold {cold[cell] * 1e3:.1f} ms, warm "
            f"{warm[cell] * 1e3:.1f} ms (median of 3), on {card}")
    for cell, (q, fn) in dist_runs.items():
        profile_query(cell, fn)

    # one more run of the cells K24 is checked at, keeping the K24 call on
    # four destinations with the largest capacity (a hash exchange of
    # lineitem)
    tile_calls = {}
    tiles_impl = DS.exchange_tiles

    def recording_tiles(batch, order, starts, counts, capacity,
                        widths=None, kernels=None):
        if counts.shape[0] == 4:
            best = tile_calls.get(current["cell"])
            if best is None or capacity > best[4]:
                tile_calls[current["cell"]] = (batch, order, starts, counts,
                                               capacity, widths)
        return tiles_impl(batch, order, starts, counts, capacity, widths,
                          kernels)

    DS.exchange_tiles = recording_tiles
    try:
        for q, n in DIST_K24:
            current["cell"] = f"q{q}/{n} shards"
            dist_runs[current["cell"]][1]()
    finally:
        DS.exchange_tiles = tiles_impl
    require(len(tile_calls) == len(DIST_K24), "phase 2i recorded no K24 call")
    log(f"phase 2i (distributed) took {time.perf_counter() - t_dist:.1f} s")

    # ---- 2j. SF10: the grace join and the packed upload ------------------
    # the default conf (two partitions, 512 MiB batches): a partition of
    # SF10 lineitem is 30,000,000 rows, so the join sides reach the join as
    # several batches and join bucket by bucket; Q3 and Q21 again at 64 MiB
    t_sf10 = time.perf_counter()
    # phase 2m's workers map the tables of its cells from .npy files here
    mp_dir = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    free = shutil.disk_usage(mp_dir).free
    require(free > 8 << 30, f"phase 2m stages ~5 GB of tables under "
            f"{mp_dir}, which has {free} bytes free")
    mp_manifests, mp_want, mp_segments = {}, {}, {}
    t0 = time.perf_counter()
    cols10 = tpch_datagen.draw_all(SF10, SEED)
    log(f"SF{SF10:g}: every column drawn in {time.perf_counter() - t0:.1f} "
        f"s ({sum(c.data.nbytes for c in cols10.values())} bytes of data)")
    sf10_launches, sf10_info, upload = {}, {}, {}
    # K25's and the seeded K9's largest calls, kept from the warm runs for
    # phase 3: Q21's at the default conf ("q21"), and the largest of
    # any cell ("any") where Q21 took no grace path
    split_impl, seeded_impl = DS.bucket_split, H.hash_pids
    k25_calls = {"q21": {}, "any": {}}
    k9_seeded_calls = {"q21": {}, "any": {}}
    # the grace path's checks, raised at the end of the script so that one
    # run reports every cell
    late = []

    def require_late(cond, what):
        if not cond:
            late.append(what)
            log(f"FAILED (raised at the end): {what}")

    def keep_largest(calls, rows, args):
        for key in ("any", "q21"):
            if key == "q21" and current.get("cell") != \
                    f"q21 SF{SF10:g} default":
                continue
            if rows > calls[key].get("rows", -1):
                calls[key].update(rows=rows, args=args,
                                  cell=current.get("cell"))

    def recording_split(batch, order, counts, kernels=None,
                        min_bucket_rows=128):
        keep_largest(k25_calls, sum(counts), (batch, order, list(counts)))
        return split_impl(batch, order, counts, kernels, min_bucket_rows)

    def recording_hash(cols, n_out, kernels=None, seed=H.SEED):
        if seed != H.SEED:
            keep_largest(k9_seeded_calls, cols[0].data.shape[0],
                         (cols, n_out, seed))
        return seeded_impl(cols, n_out, kernels, seed)

    def join_summary(records):
        """Each shuffled join's batches and grace figures over its
        partitions, in plan order."""
        out = {}
        for r in records:
            j = out.setdefault(r["exec"], {
                "join": r["join"], "left_batches": 0, "right_batches": 0,
                "left_bytes": 0, "right_bytes": 0, "grace_pairs": 0,
                "grace_buckets": 0, "grace_max_level": None})
            for k in ("left_batches", "right_batches", "left_bytes",
                      "right_bytes", "grace_pairs", "grace_buckets"):
                j[k] += r[k]
            if r["grace_max_level"] is not None:
                j["grace_max_level"] = max(j["grace_max_level"] or 0,
                                           r["grace_max_level"])
        return list(out.values())

    for q in SF10_QUERIES:
        t0 = time.perf_counter()
        host10 = tpch_datagen.tables(q, SF10, SEED, cols=cols10)
        sizes10 = {}
        want10 = O.answer(q, host10, sizes10)
        log(f"Q{q} SF{SF10:g}: tables " + ", ".join(
            f"{t} {b.num_rows} x {len(b.schema)}" for t, b in host10.items())
            + f"; numpy answer ({len(want10)} rows) in "
            f"{time.perf_counter() - t0:.1f} s; sizes {sizes10}")
        if q in MP_SF10:
            # phase 2m's M2 cell: the tables staged, the answer kept, the
            # plan's fused segments (at MP_SHARDS partitions) to build
            t0 = time.perf_counter()
            mp_manifests[f"m2_q{q}"] = stage_tables(mp_dir, f"m2_q{q}",
                                                    host10)
            mp_want[q] = want10
            for p in walk_plan(planner.physical_plan(tpch.QUERIES[q]({
                    t: planner.create_dataframe(b, n_partitions=MP_SHARDS)
                    for t, b in host10.items()}).plan)):
                if isinstance(p, TpuFusedSegmentExec):
                    mp_segments[p.program.key] = p.program.source
            log(f"Q{q} SF{SF10:g} staged for phase 2m in "
                f"{time.perf_counter() - t0:.1f} s")
        if q == 1:
            # one reader batch of lineitem's Q1 columns, packed (one pinned
            # buffer, one copy) against one copy per array, bit for bit
            rb10 = host10["lineitem"].slice(0, READER_ROWS)
            arrays = C._upload_arrays(rb10, bucket_rows(rb10.num_rows))
            packed = host_to_device(rb10, 128, sess.device)
            flat = [t for c in packed.columns
                    for t in (c.data, c.validity, c.lengths)
                    if t is not None]
            per_array = [C._staged(a, shape[0], sess.device, valid)
                         for a, shape, valid in arrays]
            require(len(flat) == len(per_array) and all(
                p.dtype == a.dtype and p.shape == a.shape and torch.equal(
                    p.contiguous().view(torch.uint8),
                    a.contiguous().view(torch.uint8))
                for p, a in zip(flat, per_array)) and
                int(packed.num_rows) == rb10.num_rows,
                "the packed upload differs from the per-array upload")
            upload.update({
                "rows": rb10.num_rows, "arrays": len(arrays),
                "bytes": sum(int(np.prod(shape)) * a.dtype.itemsize
                             for a, shape, _v in arrays),
            })

            def packed_fn(rb10=rb10):
                return host_to_device(rb10, 128, sess.device)

            def per_array_fn(arrays=arrays):
                return [C._staged(a, shape[0], sess.device, valid)
                        for a, shape, valid in arrays]

            for name, fn in (("packed", packed_fn),
                             ("per_array", per_array_fn)):
                upload[f"{name}_ms"] = cuda_ms(fn)
                upload[f"{name}_device_ms"] = device_ms(fn)
                upload[f"{name}_enqueue_ms"] = enqueue_ms(fn)
            log(f"packed upload of one SF{SF10:g} reader batch of "
                f"lineitem's Q1 columns ({upload['rows']} rows, "
                f"{upload['arrays']} arrays, {upload['bytes']} bytes) "
                f"equals the per-array upload bit for bit; call "
                f"{upload['packed_ms']:.3f} ms (1 copy; device "
                f"{_ms_text(upload['packed_device_ms'])}, host enqueue "
                f"{upload['packed_enqueue_ms']:.3f} ms) against "
                f"{upload['per_array_ms']:.3f} ms ({upload['arrays']} "
                f"copies; device {_ms_text(upload['per_array_device_ms'])}"
                f", host enqueue {upload['per_array_enqueue_ms']:.3f} ms), "
                f"events, on {card}")
            del packed, flat, per_array
        cells = [("default", {})]
        if q in SF10_CHUNKED:
            cells.append(("64 MiB", {
                "spark.rapids.tpu.sql.batchSizeBytes": CHUNK_BYTES}))
        for cname, conf in cells:
            cell = f"q{q} SF{SF10:g} {cname}"
            s10 = Session(conf)
            target = s10.conf.get(BATCH_SIZE_BYTES)
            tabs10 = {t: s10.create_dataframe(b) for t, b in host10.items()}

            def run10(q=q, tabs10=tabs10):
                return tpch.QUERIES[q](tabs10).collect()

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in all_counters:
                c.reset()
            t0 = time.perf_counter()
            rows = run10()
            cold[cell] = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            sf10_launches[cell] = {k: sum(c.count for c in cs)
                                   for k, cs in counters.items()}
            log(f"{cell} launches: {sf10_launches[cell]} "
                f"{ {c.name: c.count for c in all_counters} }")
            check_rows(rows, want10, cell, ordered=q not in O.UNORDERED)
            joins = join_summary(s10.last_joins)
            for r in s10.last_joins:
                if r["left_batches"] > 1 or r["right_batches"] > 1:
                    require(r["grace_pairs"] > 0, f"{cell}: {r['join']} "
                            f"partition {r['partition']} brought several "
                            f"batches and took no grace path: {r}")
                elif max(r["left_bytes"], r["right_bytes"]) > target:
                    log(f"{cell}: {r['join']} partition {r['partition']} "
                        f"joins one batch a side, {r['left_bytes']} / "
                        f"{r['right_bytes']} bytes, over the {target}-byte "
                        "target (joined directly, as the reference does)")
            if any(j["grace_pairs"] for j in joins):
                require(DS.SPLIT_LAUNCHES.count > 0 and
                        H.HASH_LAUNCHES.count > 0,
                        f"{cell}: the grace path launched no K25 or K9")
            if cname != "default":
                # every join with a side over the target in several
                # batches took the grace path (the records above); one a
                # side joins directly, as in the reference (Q21's join
                # with its late-supplier counts: an aggregate's output,
                # one batch a partition)
                require_late(any(j["grace_pairs"] for j in joins),
                             f"{cell}: no join took the grace path: "
                             f"{joins}")
            for j in joins:
                log(f"{cell} {j['join']}: numLeftBatches "
                    f"{j['left_batches']}, numRightBatches "
                    f"{j['right_batches']}, side bytes {j['left_bytes']} / "
                    f"{j['right_bytes']}, numGracePairs {j['grace_pairs']}, "
                    f"graceMaxLevel {j['grace_max_level']}, "
                    f"numGraceBuckets {j['grace_buckets']}")
            for pl in s10.last_placements:
                require(sum(pl["partition_rows"]) == pl["rows_written"],
                        f"{cell}: {pl['exchange']} lost or duplicated rows")
            current["cell"] = cell
            H.hash_pids, DS.bucket_split = recording_hash, recording_split
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run10()
                warm[cell] = time.perf_counter() - t0
            finally:
                H.hash_pids, DS.bucket_split = seeded_impl, split_impl
            prof = profile_query(cell, run10)
            sf10_info[cell] = {
                "cold_s": cold[cell], "warm_s": warm[cell],
                "peak_device_bytes": peak, "joins": joins,
                "profile": prof,
                "hand_kernel_launches": sum(sf10_launches[cell].values())}
            log(f"{cell} rows match numpy: {len(rows)} rows, first "
                f"{rows[:2]}; wall: cold {cold[cell] * 1e3:.1f} ms, warm "
                f"{warm[cell] * 1e3:.1f} ms (one run); peak device memory "
                f"{peak} bytes; hand-kernel launches "
                f"{sf10_info[cell]['hand_kernel_launches']}; on {card}")
            del tabs10, s10, rows
        del host10, want10
    require_late(any(j["grace_pairs"] for c, v in sf10_info.items()
                     if c.endswith("default") for j in v["joins"]),
                 "no SF10 query took the grace path at the default conf")
    k25_call = k25_calls["q21"] or k25_calls["any"]
    k9_seeded_call = k9_seeded_calls["q21"] or k9_seeded_calls["any"]
    require("args" in k25_call and "args" in k9_seeded_call,
            "phase 2j recorded no K25 or seeded K9 call")
    log(f"K25 and K9 are checked at the largest split of "
        f"{k25_call['cell']} and the largest seeded hash of "
        f"{k9_seeded_call['cell']}")
    # SF10 lineitem with the 14 columns the generator draws, for phase
    # 2l's W2 (the columns themselves, not copies)
    w2_names = [c for c in LINEITEM_COLUMNS if c in cols10]
    require(len(w2_names) == 14, f"SF10 lineitem columns: {w2_names}")
    w2_host = HostBatch(Schema([Field(c, cols10[c].dtype)
                                for c in w2_names]),
                        [cols10[c] for c in w2_names])
    del cols10, k25_calls, k9_seeded_calls
    log(f"phase 2j (SF{SF10:g}) took {time.perf_counter() - t_sf10:.1f} s")

    # ---- 2m. the multi-process runner: two processes share the card -----
    # M1: phase 2i's queries at SF1 on its tables, four partitions a table;
    # M2: Q3 and Q18 at SF10 on phase 2j's draw.  Each worker owns two of
    # the four shards and drains only their partitions; the rows must equal
    # numpy's (and, at SF1, phase 2i's single-process rows)
    t_mp = time.perf_counter()
    for q in DIST:
        mp_manifests[f"m1_q{q}"] = stage_tables(mp_dir, f"m1_q{q}",
                                                dist_host[q])
    # every library is built (phase 1); the M2 plans' segments too, so
    # that the workers compile nothing
    _build.CUDA.prepare(mp_segments)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 2m staged its tables in {time.perf_counter() - t_mp:.1f} s "
        f"under {mp_dir}")
    mp_results, mp_wall = run_multiprocess(mp_dir, mp_manifests,
                                           MP_TIMEOUT_S)
    shutil.rmtree(mp_dir, ignore_errors=True)
    mp_cells = [f"M1 q{q}" for q in DIST] + [f"M2 q{q}" for q in MP_SF10]
    mp_launches, mp_info = {}, {"workers_wall_s": mp_wall, "processes": []}
    for res in mp_results:
        r = res["rank"]
        require(res["backend"] == "gloo" and res["owned"] == [
            s for s in range(MP_SHARDS)
            if s // (MP_SHARDS // MP_PROCESSES) == r],
            f"phase 2m worker {r}: backend {res['backend']}, shards "
            f"{res['owned']}")
        log(f"phase 2m worker {r} on {res['device']} ({res['backend']}), "
            f"shards {res['owned']}: joined in {res['init_s']:.1f} s, tables "
            f"mapped by {res['tables_s']:.1f} s, done at "
            f"{res['total_s']:.1f} s; gloo with CUDA tensors: "
            f"{res['gloo_cuda']}")
        k27_total = 0
        for cell in mp_cells:
            v = res["cells"][cell]
            q = int(cell.split("q")[1])
            if cell.startswith("M1"):
                check_rows(v["rows"], want[q], f"{cell} worker {r}",
                           ordered=q not in O.UNORDERED)
                check_rows(v["rows"], dist_rows[f"q{q}/4 shards"],
                           f"{cell} worker {r} against phase 2i",
                           ordered=q not in O.UNORDERED)
            else:
                check_rows(v["rows"], mp_want[q], f"{cell} worker {r}",
                           ordered=q not in O.UNORDERED)
            for pl in v["placements"]:
                if pl["capacity"] is not None:
                    require(sum(pl["partition_rows"]) == pl["rows_written"],
                            f"{cell}: {pl['exchange']} lost or duplicated "
                            "rows")
            k27_n = v["launches"]["K27 max"] + v["launches"]["K27 trim"]
            k27_total += k27_n
            mp_launches[f"{cell} rank {r}"] = {"K27": k27_n}
            m = v["metrics"]
            log(f"{cell} worker {r}: {len(v['rows'])} rows equal numpy's"
                + (" and phase 2i's" if cell.startswith("M1") else "")
                + f"; cold {v['cold_s'] * 1e3:.1f} ms, warm "
                f"{v['warm_s'] * 1e3:.1f} ms (median of "
                f"{len(v['warm_runs_s'])}); drained partitions "
                f"{v['drained']}; collectives "
                f"{m['shuffle.processCollectives']}, bytes sent to the other "
                f"process {m['shuffle.processBytesSent']}, collectiveTimeNs "
                f"{m['shuffle.collectiveTimeNs']}, host-staged bytes "
                f"{m['shuffle.hostStagedBytes']}, H2D upload bytes "
                f"{v['upload_bytes']}, peak device memory "
                f"{v['peak_device_bytes']} bytes; launches {v['launches']}; "
                f"K27 equals its plain version at {v['k27_check']}; on "
                f"{card}")
        require(k27_total > 0, f"phase 2m worker {r} launched no K27")
        mp_info["processes"].append({
            "rank": r, "owned": res["owned"], "init_s": res["init_s"],
            "gloo_cuda": res["gloo_cuda"],
            "cells": {c: {k: v for k, v in res["cells"][c].items()
                          if k != "rows"} for c in mp_cells}})
    # every leaf's partitions drained by exactly one process
    for cell in mp_cells:
        per_rank = [res["cells"][cell]["drained"] for res in mp_results]
        require(len({len(d) for d in per_rank}) == 1 and per_rank[0],
                f"{cell}: leaves drained {per_rank}")
        for leaf in zip(*per_rank):
            parts = [p for d in leaf for p in d]
            require(sorted(parts) == list(range(len(parts))) and
                    all(d for d in leaf),
                    f"{cell}: a leaf's partitions by process {leaf} are not "
                    "disjoint or do not cover it")
    log(f"phase 2m: partition ownership disjoint and covering in every "
        f"cell; K27 launched in every worker")
    log(f"phase 2m (multi-process) took {time.perf_counter() - t_mp:.1f} s")

    # phase 2l's read-back check runs in spawned processes; they start
    # now, so that their imports overlap phase 2k (they are daemons: the
    # interpreter ends them at exit, and phase 2l terminates them)
    import multiprocessing as mp

    check_pool = mp.get_context("spawn").Pool(max(1, min(8, os.cpu_count()
                                                          or 1)))

    # ---- 2k. the ML hand-off: the Mortgage ETL, its export, ML prep -----
    # every cell before this one launched no K26 (its counter is read in
    # every cell's launches)
    t_ml = time.perf_counter()
    earlier = [launches, launches2, text_launches, clean_launches,
               rollup_launches, dist_launches, sf10_launches]
    require(all(v["K26"] == 0 for m in earlier for v in m.values()),
            "K26 launched in a cell before the export")
    t0 = time.perf_counter()
    mtabs = M.tables(MORTGAGE_SF, MORTGAGE_SEED)
    log(f"Mortgage sf {MORTGAGE_SF:g} (seed {MORTGAGE_SEED}) generated in "
        f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{t} {b.num_rows} x {len(b.schema)} "
            f"({sum(c.data.nbytes + (0 if c.lengths is None else c.lengths.nbytes) for c in b.columns)} bytes)"
            for t, b in mtabs.items()))
    t0 = time.perf_counter()
    mwant = M.oracle_etl(mtabs)
    want_summary = M.oracle_summary(mwant)
    want_feats = M.oracle_features(mwant).astype(np.float32)
    log(f"Mortgage answered in numpy in {time.perf_counter() - t0:.1f} s: "
        f"etl {len(mwant['loan_id'][0])} rows, features "
        f"{want_feats.shape}, summary {want_summary}")
    t0 = time.perf_counter()
    want_bb = {q: tpcxbb.ORACLES[q](ml_host[q]) for q in tpcxbb.ML_PREP}
    log(f"TPCx-BB ML prep answered in numpy in "
        f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
            f"q{q} {len(r)} rows, first {r[:1]}" for q, r in want_bb.items()))
    ml_launches, ml_info, ml_runs = {}, {}, {}
    # the kernels each cell's plan reaches: every cell groups by a key
    # (K1 sorts, K3 reduces, K4 gathers), every one but q25 joins (K5);
    # the Mortgage ETL fuses its Project chain after the join and q20 its
    # Project -> Filter -> Project with greatest (K12); q28's CASE WHEN
    # is a lone Project under the aggregate, which never fuses
    grouped = [S.SORT_LAUNCHES, S.SEGMENT_REDUCE_LAUNCHES,
               G.GATHER_LAUNCHES]
    ml_must = {"mortgage": grouped + [J.JOIN_PROBE_LAUNCHES,
                                      FK.FUSED_LAUNCHES],
               5: grouped + [J.JOIN_PROBE_LAUNCHES],
               20: grouped + [J.JOIN_PROBE_LAUNCHES, FK.FUSED_LAUNCHES],
               25: grouped, 26: grouped + [J.JOIN_PROBE_LAUNCHES],
               28: grouped + [J.JOIN_PROBE_LAUNCHES]}
    ml_must_not = {25: [J.JOIN_PROBE_LAUNCHES], 28: [FK.FUSED_LAUNCHES]}
    k26_inputs = {}

    def ml_cell(cell, sess_, fn, check, key, warm_runs=3, export=False):
        """One cell: the cold run (launches, peak device memory, batches,
        joins, the check), warm runs and a profiled run."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # earlier phases' tensors
        for cnt in all_counters:
            cnt.reset()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        cold[cell] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        ml_launches[cell] = {k: sum(x.count for x in cs)
                             for k, cs in counters.items()}
        log(f"{cell} launches: {ml_launches[cell]} "
            f"{ {x.name: x.count for x in all_counters} }")
        require((XK.FEATURE_LAUNCHES.count > 0) == export,
                f"{cell}: K26 launched {XK.FEATURE_LAUNCHES.count} kernels")
        for x in ml_must[key]:
            require(x.count > 0, f"{cell}: wrapper {x.name} launched no "
                    "kernel")
        for x in ml_must_not.get(key, []) + text_kernels:
            require(x.count == 0, f"{cell}: wrapper {x.name} launched "
                    f"{x.count} kernels, none expected")
        m = sess_.last_metrics
        batches = {k: v for k, v in sorted(m.items()) if "Batches" in k}
        joins = join_summary(sess_.last_joins)
        for r in sess_.last_joins:
            if r["left_batches"] > 1 or r["right_batches"] > 1:
                require(r["grace_pairs"] > 0, f"{cell}: {r['join']} "
                        f"partition {r['partition']} brought several "
                        f"batches and took no grace path: {r}")
        for pl in sess_.last_placements:
            require(sum(pl["partition_rows"]) == pl["rows_written"],
                    f"{cell}: {pl['exchange']} lost or duplicated rows")
        check(res)
        del res
        runs = []
        for _ in range(warm_runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        warm[cell] = statistics.median(runs)
        prof = profile_query(cell, fn)
        ml_runs[cell] = fn
        ml_info[cell] = {
            "cold_s": cold[cell], "warm_s": warm[cell],
            "warm_runs": warm_runs, "peak_device_bytes": peak,
            "held_device_bytes": held,
            "batches": batches, "joins": joins, "profile": prof,
            "hand_kernel_launches": sum(ml_launches[cell].values())}
        log(f"{cell} wall: cold {cold[cell] * 1e3:.1f} ms, warm "
            f"{warm[cell] * 1e3:.1f} ms (median of {warm_runs}); peak "
            f"device memory {peak} bytes above the {held} held before it; "
            f"batches {batches}; joins "
            f"{joins}; on {card}")

    # the Mortgage ETL and its summary, two partitions (the default)
    msess = Session()
    mdf = {t: msess.create_dataframe(b) for t, b in mtabs.items()}

    def check_etl(hb):
        M.check_etl(hb, mwant)
        log(f"mortgage etl equals numpy: {hb.num_rows} rows in loan_id "
            f"order")

    etl_df = M.etl(mdf)
    ml_cell("mortgage etl/2", msess, etl_df._result_batch, check_etl,
            "mortgage", warm_runs=1)
    require_late(msess.last_metrics.get(
        "TpuHashAggregateExec[partial].numInputBatches", 0) > 2,
        "mortgage etl: the partial aggregate got no more than one batch a "
        "partition; the chunked path did not run")

    def check_summary(rows):
        check_rows(rows, want_summary, "mortgage summary")
        log(f"mortgage summary rows match numpy: {rows}")

    ml_cell("mortgage summary/2", msess, M.summary(mdf).collect,
            check_summary, "mortgage", warm_runs=1)
    log(f"mortgage etl device plan:\n{msess.physical_plan(etl_df.plan)}")

    # the export: the same ETL under exportColumnarRdd, its device
    # batches, and its feature matrix on K26
    esess = Session(EXPORT_CONF)
    edf = M.etl({t: esess.create_dataframe(b) for t, b in mtabs.items()})

    def check_batches(bs):
        require(bs and all(isinstance(b, C.DeviceBatch) and
                           b.device.type == "cuda" for b in bs),
                "export: a batch is not a DeviceBatch on cuda")
        rows = sum(int(b.num_rows) for b in bs)
        require(rows == len(mwant["loan_id"][0]),
                f"export: the batches hold {rows} rows")
        k26_inputs["etl"] = bs
        log(f"export: {len(bs)} device batches on cuda, "
            f"{[int(b.num_rows) for b in bs]} rows "
            f"({[b.padded_rows for b in bs]} padded)")

    ml_cell("export batches/2", esess, lambda: ml.columnar_batches(edf),
            check_batches, "mortgage", warm_runs=1)

    def check_matrix(X):
        require(tuple(X.shape) == want_feats.shape and
                X.dtype == torch.float32 and X.device.type == "cuda",
                f"feature_matrix: {tuple(X.shape)} {X.dtype} on "
                f"{X.device}, want {want_feats.shape} float32 on cuda")
        got = X.cpu().numpy().view(np.int32)
        want = want_feats.view(np.int32)
        avg = M.FEATURES.index("avg_upb")
        for j, name in enumerate(M.FEATURES):
            diff = np.abs(got[:, j].astype(np.int64) - want[:, j])
            if j == avg:
                require(int(diff.max()) <= 1, f"feature_matrix: {name} "
                        f"off by {int(diff.max())} ULP")
                ml_info_extra["avg_upb_1ulp_rows"] = int((diff == 1).sum())
            else:
                require(not diff.any(), f"feature_matrix: {name} differs "
                        f"at {int((diff > 0).sum())} rows")
        log(f"feature_matrix(etl): {tuple(X.shape)} float32 on "
            f"{X.device}, equal to numpy's features (avg_upb "
            f"{ml_info_extra['avg_upb_1ulp_rows']} rows 1 ULP apart)")

    ml_info_extra = {}
    ml_cell("export feature_matrix/2", esess,
            lambda: ml.feature_matrix(edf), check_matrix, "mortgage",
            warm_runs=1, export=True)
    # the export's share of the wall: the ETL to device batches, then
    # the feature matrix of those batches (K26 and its one read back)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs = ml.columnar_batches(edf)
    torch.cuda.synchronize()
    t_batches = time.perf_counter() - t0
    t0 = time.perf_counter()
    ml.to_feature_matrix(bs)
    torch.cuda.synchronize()
    t_matrix = time.perf_counter() - t0
    del bs
    # device-to-host copies under the profiler: the export against the
    # ETL to device batches alone (the engine's own read-backs), and
    # against a download of the same result.  torch.profiler can drop a
    # session's device records (PERF.md §6), which only lowers a
    # count: each is taken twice and the larger kept

    def dtoh_most(run):
        return max(dtoh_copies(run), dtoh_copies(run),
                   key=lambda r: -1 if r[1] is None else r[1])

    copies, dtoh, dtoh_ms = dtoh_most(lambda: ml.feature_matrix(edf))
    b_copies, b_bytes, b_ms = dtoh_most(lambda: ml.columnar_batches(edf))
    d_copies, d_bytes, d_ms = dtoh_most(edf._result_batch)
    n_batches = len(k26_inputs["etl"])
    # every copy's bytes from the trace, and beyond the ETL's own
    # read-backs one int32 count a batch
    require_late(None not in (dtoh, b_bytes, d_bytes) and
                 0 <= dtoh - b_bytes <= 4 * n_batches and
                 dtoh < 0.1 * d_bytes,
                 f"export: {dtoh} bytes copied to the host, the ETL to "
                 f"device batches {b_bytes}, a download {d_bytes} (None: "
                 "the profiler's trace gave no bytes for some DtoH copy)")
    ml_info_extra.update({
        "etl_to_batches_s": t_batches, "feature_matrix_s": t_matrix,
        "export_share": t_matrix / (t_batches + t_matrix),
        "dtoh_copies": copies, "dtoh_bytes": dtoh, "dtoh_ms": dtoh_ms,
        "batches_dtoh_copies": b_copies, "batches_dtoh_bytes": b_bytes,
        "download_dtoh_copies": d_copies, "download_dtoh_bytes": d_bytes,
        "download_dtoh_ms": d_ms,
        "result_device_bytes": sum(b.device_bytes()
                                   for b in k26_inputs["etl"])})
    log(f"export: ETL to device batches {t_batches * 1e3:.1f} ms, "
        f"feature matrix {t_matrix * 1e3:.3f} ms (share "
        f"{ml_info_extra['export_share']:.4f}); DtoH copies under the "
        f"profiler: ml.feature_matrix {copies} copies, {dtoh} bytes, "
        f"{dtoh_ms:.3f} ms; ml.columnar_batches {b_copies} copies, "
        f"{b_bytes} bytes, {b_ms:.3f} ms; a download of the same result "
        f"(_result_batch) {d_copies} copies, {d_bytes} bytes, "
        f"{d_ms:.3f} ms; on {card}")
    t0 = time.perf_counter()
    back = ml.from_device_batches(esess, k26_inputs["etl"])
    n_back = back.agg(F.count("*").alias("n")).collect()[0][0]
    require(n_back == len(mwant["loan_id"][0]),
            f"from_device_batches: {n_back} rows")
    log(f"from_device_batches round trip: {n_back} rows "
        f"({time.perf_counter() - t0:.1f} s)")
    del back

    # TPCx-BB's ML prep at SF1, two partitions and one
    for q in tpcxbb.ML_PREP:
        for n_part in (2, 1):
            cell = f"q{q}/{n_part}"
            bsess = Session()
            df = tpcxbb.QUERIES[q]({
                t: bsess.create_dataframe(b, n_partitions=n_part)
                for t, b in ml_host[q].items()})

            def check_bb(rows, q=q, cell=cell):
                check_rows(rows, want_bb[q], cell)
                log(f"{cell} rows match numpy: {len(rows)} rows, first "
                    f"{rows[:2]}")

            ml_cell(cell, bsess, df.collect, check_bb, q)
    q28_plan = str(planner.physical_plan(tpcxbb.q28({
        t: planner.create_dataframe(b) for t, b in ml_host[28].items()})
        .plan))
    require("TpuFusedSegment" not in q28_plan and "CASE WHEN" in q28_plan,
            f"q28's CASE WHEN is not a lone Project:\n{q28_plan}")

    # the feature matrix of q26's result (its numeric columns: all seven)
    qsess = Session(EXPORT_CONF)
    q26_df = tpcxbb.q26({t: qsess.create_dataframe(b)
                         for t, b in ml_host[26].items()})
    q26_want = np.array(want_bb[26], dtype=np.float64).astype(np.float32)

    def check_q26(X):
        require(tuple(X.shape) == q26_want.shape and
                X.device.type == "cuda", f"q26 feature_matrix: "
                f"{tuple(X.shape)} on {X.device}")
        got = X.cpu().numpy().view(np.int32)
        want = q26_want.view(np.int32)
        require(np.array_equal(got[:, :2], want[:, :2]),
                "q26 feature_matrix: c or n differs")
        require(int(np.abs(got[:, 2:].astype(np.int64) - want[:, 2:])
                    .max()) <= 1, "q26 feature_matrix: a category sum "
                "more than 1 ULP from numpy's")
        log(f"feature_matrix(q26): {tuple(X.shape)} float32 on {X.device}, "
            f"equal to numpy's rows (category sums within 1 ULP)")

    ml_cell("q26 feature_matrix/2", qsess, lambda: ml.feature_matrix(q26_df),
            check_q26, 26, export=True)
    ml_info["export feature_matrix/2"].update(ml_info_extra)
    del mtabs, mdf, edf, mwant, want_feats, etl_df
    log(f"phase 2k (ML hand-off) took {time.perf_counter() - t_ml:.1f} s")

    # ---- 2l. the dynamic-partition Parquet write (B.26) ------------------
    # W0: TPCx-BB SF1 store_sales unpartitioned; W1: the same by
    # ss_sold_date_sk (spark-sql-perf's partitioned TPC-DS layout); W2:
    # SF10 lineitem (phase 2j's draw) by its status flags
    t_write = time.perf_counter()
    w1_host = tpcxbb_datagen.tables_of(bb_gen, ["store_sales"])[
        "store_sales"]
    try:
        write_info, write_launches, b26_inputs = phase_writes(
            {"W0": (w1_host, []), "W1": (w1_host, ["ss_sold_date_sk"]),
             "W2": (w2_host, ["l_returnflag", "l_linestatus"])},
            counters, cold, warm, card, check_pool)
    finally:
        check_pool.terminate()
        check_pool.join()
    del w1_host, w2_host
    log(f"phase 2l (writes) took {time.perf_counter() - t_write:.1f} s")

    # ---- 3. kernels against their plain versions --------------------------
    dev = sess.device
    db = host_to_device(hb, 128, dev)          # 8,388,608 padded rows
    P = db.padded_rows
    cols = {f.name: c for f, c in zip(db.schema, db.columns)}
    keep = (cols["l_shipdate"].data <= O._days(1998, 9, 2)) & \
        cols["l_shipdate"].validity
    fb = G.compact(db, keep)                   # the partial agg's input
    rm = fb.row_mask()
    fcols = {f.name: c for f, c in zip(fb.schema, fb.columns)}
    keys = [DeviceColumn(c.dtype, c.data, c.validity & rm, c.lengths)
            for c in (fcols["l_returnflag"], fcols["l_linestatus"])]
    entries = []

    def bound(moved_bytes, ops, ops_per_s):
        bound_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
        bound_ops = ops / ops_per_s * 1e3
        return max(bound_bytes, bound_ops), \
            "bytes" if bound_bytes >= bound_ops else "operations"

    def label(q):
        return f"q{q}" if isinstance(q, int) else q

    def entry(name, source, replaces, kernel_ms, plain_ms, lib_ms,
              moved_bytes, ops, ops_per_s, err, **extra):
        b, by = bound(moved_bytes, ops, ops_per_s)
        k = name.split()[0]
        # the exchange kernels' main path is the two-partition runs, the
        # window kernel's q30 at both partition counts and the clickstream
        # K15's is Q22 with fusion off (with fusion on, Q22's substring
        # runs inside K12); every other kernel's the one-partition runs
        # (and, for K12, the later queries at two partitions); phase 2g's
        # six cells are the main path of K19-K21 and the string min/max
        # (B.5) and count for K12, K13, K15 and K16 too
        mains = {"K9": [launches2], "K10": [launches2], "K11": [launches2],
                 "K12": [launches, {q: launches2[q] for q in LATER},
                         clean_launches],
                 "K13": [launches, clean_launches],
                 "K14": [launches, launches2],
                 "K15": [{"q22 fusion off": launches_q22_unfused},
                         clean_launches],
                 "K16": [{c: v for c, v in text_launches.items()
                          if "fusion off" in c}, clean_launches],
                 "K17": [{c: v for c, v in text_launches.items()
                          if c.startswith("export/")}],
                 "K18": [{c: v for c, v in text_launches.items()
                          if c.startswith("export/")}],
                 "K19": [clean_launches], "K20": [clean_launches],
                 "K21": [clean_launches], "B.5": [clean_launches],
                 "K22": [rollup_launches], "K23": [rollup_launches],
                 "K24": [dist_launches],
                 "K25": [sf10_launches],
                 "K26": [ml_launches],
                 "K27": [mp_launches],
                 # B.26 is K1 + K4: its launches are theirs in the write
                 # cells, where phase 2l found no other kernel launched
                 "B.26": [{c: {k: v["K1"] + v["K4"]}
                           for c, v in write_launches.items()}],
                 }.get(k, [launches])
        if k == "K12":
            mains.append(rollup_launches)

        def by_cell(runs):
            return {label(q): v[k] for q, v in runs.items() if k in v}
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces,
             # summed over the cold runs of the queries
             "launches": sum(m[q][k] for m in mains for q in m),
             "launches_by_query": by_cell(launches),
             "launches_by_query_two_partitions": by_cell(launches2),
             "launches_by_text_cell": by_cell(text_launches),
             "launches_by_clean_cell": by_cell(clean_launches),
             "launches_by_rollup_cell": by_cell(rollup_launches),
             "launches_by_distributed_cell": by_cell(dist_launches),
             "launches_by_sf10_cell": by_cell(sf10_launches),
             "launches_by_ml_cell": by_cell(ml_launches),
             "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
             "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
             "status": "ported; launched in " + ", ".join(sorted({
                 label(q) for m in mains for q in m if m[q][k]})),
             **extra}
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
    rkeep = (rcols["l_shipdate"].data <= O._days(1998, 9, 2)) & \
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

    # K5: the probe of Q3's second join (its K1 sorts, K2 ids and K4
    # gathers included in the time), on the inputs the main path gave it
    ex, lb, rb, _out = q3_join2
    lkeys = ex._keys_of(lb, ex.left_keys)
    rkeys = ex._keys_of(rb, ex.right_keys)
    l_rm, r_rm = lb.row_mask(), rb.row_mask()
    nl, nr = lb.padded_rows, rb.padded_rows
    # checked with has_r (right/full joins ask for it); timed without it,
    # as the main path's inner joins call it
    pk = J.probe(lkeys, rkeys, l_rm, r_rm)
    pp = J.probe_plain(lkeys, rkeys, l_rm, r_rm)
    for f in J.Probe._fields:
        require(torch.equal(getattr(pk, f), getattr(pp, f)),
                f"K5 {f} differs from its plain version")
    sorted_gr = pp.gr[pp.order_r.to(torch.int64)]
    log(f"K5/K6/K7 at Q3's second join: {nl} + {nr} padded key rows")
    entry("K5 join_probe", "spark_rapids_tpu_torch/csrc/join_probe.cu",
          "spark_rapids_tpu/ops/kernels/join.py:89",
          cuda_ms(lambda: J.probe(lkeys, rkeys, l_rm, r_rm,
                                  with_has_r=False)),
          cuda_ms(lambda: J.probe_plain(lkeys, rkeys, l_rm, r_rm,
                                        with_has_r=False)),
          cuda_ms(lambda: torch.searchsorted(sorted_gr, pp.gl)),
          sum(nbytes(k.data, k.validity, k.lengths) for k in lkeys + rkeys)
          + nbytes(l_rm, r_rm, *pk[:-1]),
          (nl + nr) + nl * 2 * max(1, nr.bit_length()), FP32_PER_S, 0.0)

    def k6_bytes(ek, pairs, how):
        """What emit_counts + expand_pairs must move for this join type,
        on this run's data: cnt and l_rm read; emit, offs, the total and
        the pairs written; lo read at the left rows with a match and
        order_r at the matched slots.  Right and full joins also read
        has_r and r_rm and write r_extra and the unmatched order."""
        live = torch.where(l_rm, pk.cnt, torch.zeros_like(pk.cnt))
        moved = nbytes(pk.cnt, l_rm, ek.emit, ek.offs, ek.total, *pairs) \
            + 4 * int((live > 0).sum()) + 4 * int(live.sum())
        if how in ("right", "full"):
            moved += nbytes(pk.has_r, r_rm, ek.r_extra, ek.unmatched_order)
        return moved

    # K6: emit counts + expansion, inner (Q3's type) and full
    k6 = {}
    for how in ("inner", "full"):
        ek = J.emit_counts(pk, how, l_rm, r_rm)
        ep = J.emit_counts_plain(pp, how, l_rm, r_rm)
        for f in ("emit", "total", "offs"):
            require(torch.equal(getattr(ek, f), getattr(ep, f)),
                    f"K6 {how} {f} differs from its plain version")
        if how == "full":
            require(torch.equal(ek.r_extra, ep.r_extra) and
                    torch.equal(ek.unmatched_order, ep.unmatched_order),
                    "K6 full unmatched rows differ")
        else:
            require(ek.r_extra is None and ep.r_extra is None,
                    "K6 inner built an unmatched-right mask")
        c_out = bucket_rows(int(ek.total))
        pairs = J.expand_pairs(pk, ek, c_out)
        for g, r in zip(pairs, J.expand_pairs_plain(pp, ep, c_out)):
            require(torch.equal(g, r), f"K6 {how} pairs differ")
        lanes = torch.arange(nl, dtype=torch.int32, device=dev)
        moved = k6_bytes(ek, pairs, how)
        # one binary search over the prefix sums per left-part slot
        ops = int(ek.offs[-1]) * max(1, nl.bit_length()) + nl
        b, _by = bound(moved, ops, FP32_PER_S)
        k6[how] = dict(
            pairs=pairs, c_out=c_out, bound=b, bytes=moved, ops=ops,
            ms=cuda_ms(lambda: J.expand_pairs(
                pk, J.emit_counts(pk, how, l_rm, r_rm), c_out)),
            plain=cuda_ms(lambda: J.expand_pairs_plain(
                pp, J.emit_counts_plain(pp, how, l_rm, r_rm), c_out)),
            lib=cuda_ms(lambda: torch.repeat_interleave(lanes, ek.emit)))
        log(f"K6 {how}: {int(ek.total)} output rows in {c_out} slots")
    inner = k6["inner"]
    entry("K6 join_expand", "spark_rapids_tpu_torch/csrc/join_expand.cu",
          "spark_rapids_tpu/ops/kernels/join.py:126",
          inner["ms"], inner["plain"], inner["lib"], inner["bytes"],
          inner["ops"], FP32_PER_S, 0.0,
          ms_by_join={h: v["ms"] for h, v in k6.items()},
          plain_ms_by_join={h: v["plain"] for h, v in k6.items()},
          library_ms_by_join={h: v["lib"] for h, v in k6.items()},
          bound_ms_by_join={h: v["bound"] for h, v in k6.items()})

    # K7: both sides of Q3's second join gathered by the inner pairs
    lidx, ridx, slot_valid = inner["pairs"]

    def gather_both(fn):
        return fn(lb.columns, lidx, slot_valid) + \
            fn(rb.columns, ridx, slot_valid)

    for g, r in zip(gather_both(J.gather_side),
                    gather_both(J.gather_side_plain)):
        require(torch.equal(g.data, r.data) and
                torch.equal(g.validity, r.validity) and
                (r.lengths is None or torch.equal(g.lengths, r.lengths)),
                f"K7 differs from its plain version in a {r.dtype} column")
    safe = [(c, torch.clamp(i, 0, c.data.shape[0] - 1).to(torch.int64))
            for cols_, i in ((lb.columns, lidx), (rb.columns, ridx))
            for c in cols_]
    side_bytes = sum(2 * lidx.shape[0] * (
        c.data.element_size() * (c.data.shape[1] if c.data.dim() == 2
                                 else 1) + 1
        + (4 if c.lengths is not None else 0)) for c, _i in safe)
    entry("K7 gather_side", "spark_rapids_tpu_torch/csrc/gather.cu",
          "spark_rapids_tpu/ops/kernels/join.py:158",
          cuda_ms(lambda: gather_both(J.gather_side)),
          cuda_ms(lambda: gather_both(J.gather_side_plain)),
          cuda_ms(lambda: [c.data[i] for c, i in safe]),
          side_bytes + nbytes(lidx, ridx, slot_valid), lidx.shape[0]
          * len(safe), FP32_PER_S, 0.0)

    # K8: Q3's customer filter, c_mktsegment == 'BUILDING'
    cb = host_to_device(host[3]["customer"], 128, dev)
    seg_col = cb.columns[cb.schema.index_of("c_mktsegment")]
    lit = as_device_column(Literal("BUILDING").eval_tpu(cb),
                           cb.padded_rows, dev)
    args = (seg_col.data, seg_col.lengths, lit.data, lit.lengths)
    got_eq = SK.equals(*args)
    require(torch.equal(got_eq, SK.equals_plain(*args)),
            "K8 equals differs from its plain version")
    require(torch.equal(SK.compare(*args), SK.compare_plain(*args)),
            "K8 compare differs from its plain version")
    require(int((got_eq & cb.row_mask()).sum()) ==
            sizes[3]["customer BUILDING"], "K8 count differs from numpy")
    w = seg_col.data.shape[1]
    pos = torch.arange(w, device=dev)[None, :]
    masked = torch.where(pos < seg_col.lengths[:, None], seg_col.data, 0)
    wide_lit = torch.nn.functional.pad(lit.data[:1], (
        0, w - lit.data.shape[1])).expand(cb.padded_rows, w)
    entry("K8 string_compare", "spark_rapids_tpu_torch/csrc/strings.cu",
          "spark_rapids_tpu/ops/kernels/stringkernels.py:58",
          cuda_ms(lambda: SK.equals(*args)),
          cuda_ms(lambda: SK.equals_plain(*args)),
          cuda_ms(lambda: (masked == wide_lit).all(1)),
          nbytes(seg_col.data, seg_col.lengths, lit.data[:1],
                 lit.lengths[:1], got_eq),
          cb.padded_rows * w, FP32_PER_S, 0.0)

    # K9: Murmur3 partition ids at the two-partition main path's inputs:
    # Q3's lineitem join key, Q3's aggregate keys, Q4's priority key
    def largest(calls):
        return max(calls, key=lambda c: c[1][0].data.shape[0])

    k9_inputs = {
        "Q3 l_orderkey": largest([
            r for r in recorded["hash"] if r[0] == 3 and len(r[1]) == 1
            and r[1][0].data.dtype == torch.int64]),
        "Q3 aggregate keys": largest([
            r for r in recorded["hash"] if r[0] == 3 and len(r[1]) == 3]),
        "Q4 o_orderpriority": largest([
            r for r in recorded["hash"] if r[0] == 4 and len(r[1]) == 1
            and r[1][0].dtype.is_string]),
    }
    k9 = {}
    for what, (_q, kcols, n_out) in k9_inputs.items():
        n = kcols[0].data.shape[0]
        require(torch.equal(H.hash_pids(kcols, n_out),
                            H.pmod(H.hash_batch_plain(kcols), n_out)),
                f"K9 pids differ from the plain version at {what}")
        require(torch.equal(H.hash_device_batch(kcols),
                            H.hash_batch_plain(kcols)),
                f"K9 hashes differ from the plain version at {what}")
        words = sum(-(-c.data.shape[1] // 4) + 1 if c.dtype.is_string
                    else c.data.element_size() // 4 or 1 for c in kcols)
        k9[what] = dict(
            ms=cuda_ms(lambda: H.hash_pids(kcols, n_out)),
            plain=cuda_ms(lambda: H.pmod(H.hash_batch_plain(kcols), n_out)),
            bytes=sum(nbytes(c.data, c.validity, c.lengths) for c in kcols)
            + 4 * n, ops=12 * words * n, rows=n,
            dtypes=[str(c.dtype) for c in kcols])
        log(f"K9 at {what}: {n} padded rows, {k9[what]['dtypes']}, "
            f"kernel {k9[what]['ms']:.3f} ms, plain {k9[what]['plain']:.3f} "
            f"ms")
    first = k9["Q3 l_orderkey"]
    entry("K9 murmur3", "spark_rapids_tpu_torch/csrc/hashing.cu",
          "spark_rapids_tpu/utils/hashing.py:269",
          first["ms"], first["plain"], None, first["bytes"], first["ops"],
          FP32_PER_S, 0.0,
          ms_by_input={w: v["ms"] for w, v in k9.items()},
          plain_ms_by_input={w: v["plain"] for w, v in k9.items()},
          bound_ms_by_input={w: bound(v["bytes"], v["ops"], FP32_PER_S)[0]
                             for w, v in k9.items()},
          rows_by_input={w: v["rows"] for w, v in k9.items()})

    # K10: the 2-way build and slices of Q3's filtered lineitem batch
    _q, kb, kpids, kn = max(
        (r for r in recorded["build"] if r[0] == 3
         and "l_orderkey" in r[1].schema.names),
        key=lambda r: r[1].padded_rows)
    built = DS.partition_order(kpids, kb.num_rows, kn)
    for g, r, f in zip(built, DS.partition_order_plain(kpids, kb.num_rows,
                                                       kn),
                       ("order", "counts", "starts")):
        require(torch.equal(g, r), f"K10 build {f} differs from its plain "
                "version")
    block = G.gather_batch(kb, built[0], kb.num_rows)
    counts_h, starts_h = built[1].tolist(), built[2].tolist()
    require(sum(counts_h) == int(kb.num_rows), "K10 lost rows")
    for p in range(kn):
        g = DS.packed_slice(block, starts_h[p], counts_h[p])
        r = DS.packed_slice_plain(block, starts_h[p], counts_h[p])
        require(int(g.num_rows) == counts_h[p], "K10 slice row count")
        for gc, rc in zip(g.columns, r.columns):
            require(torch.equal(gc.data, rc.data) and
                    torch.equal(gc.validity, rc.validity) and
                    (rc.lengths is None or
                     torch.equal(gc.lengths, rc.lengths)),
                    f"K10 slice {p} differs in a {rc.dtype} column")
    P2 = kb.padded_rows
    lane2 = torch.arange(P2, dtype=torch.int32, device=dev)
    bucket = torch.where(lane2 < kb.num_rows, kpids,
                         torch.full_like(kpids, kn))

    def k10_slices(fn):
        return [fn(block, starts_h[p], counts_h[p]) for p in range(kn)]

    k10_build_ms = cuda_ms(lambda: DS.partition_order(kpids, kb.num_rows,
                                                      kn))
    k10_slice_ms = cuda_ms(lambda: k10_slices(DS.packed_slice))
    k10_build_plain = cuda_ms(lambda: DS.partition_order_plain(
        kpids, kb.num_rows, kn))
    k10_slice_plain = cuda_ms(lambda: k10_slices(DS.packed_slice_plain))
    log(f"K10 at Q3's lineitem batch: {int(kb.num_rows)} rows ({P2} "
        f"padded) into {kn} partitions {counts_h}; build {k10_build_ms:.3f}"
        f" ms, slices {k10_slice_ms:.3f} ms")
    entry("K10 partition_build+slice",
          "spark_rapids_tpu_torch/csrc/shuffle.cu",
          "spark_rapids_tpu/shuffle/device_shuffle.py:96",
          k10_build_ms + k10_slice_ms, k10_build_plain + k10_slice_plain,
          cuda_ms(lambda: torch.argsort(bucket, stable=True)),
          nbytes(kpids, built[0], built[1], built[2])
          + (1 + kn) * block.device_bytes(), 4 * P2, FP32_PER_S, 0.0,
          ms_build=k10_build_ms, ms_slices=k10_slice_ms,
          plain_ms_build=k10_build_plain, plain_ms_slices=k10_slice_plain,
          library_call="torch.argsort(stable=True) of the bucket ids "
          "(the build's order only)")

    # K11: the range partition ids of Q3's final sort keys
    _q, rpasses, rbounds = max(
        (r for r in recorded["range"] if r[0] == 3),
        key=lambda r: r[1].shape[1])
    rp = EX.range_pids_from_bounds(rpasses, rbounds)
    require(torch.equal(rp, EX.range_pids_plain(rpasses, rbounds)),
            "K11 differs from its plain version")
    k, n = rpasses.shape
    first_pass = rpasses[0].contiguous()
    first_bounds = rbounds[0].contiguous()
    log(f"K11 at Q3's final sort: {k} passes x {n} rows, "
        f"{rbounds.shape[1]} bound(s); pids per partition "
        f"{torch.bincount(rp.to(torch.int64), minlength=2).tolist()}")
    entry("K11 range_pids", "spark_rapids_tpu_torch/csrc/range_partition.cu",
          "spark_rapids_tpu/exec/exchange.py:98",
          cuda_ms(lambda: EX.range_pids_from_bounds(rpasses, rbounds)),
          cuda_ms(lambda: EX.range_pids_plain(rpasses, rbounds)),
          cuda_ms(lambda: torch.searchsorted(first_bounds, first_pass)),
          nbytes(rpasses, rbounds, rp), n * k * rbounds.shape[1],
          FP32_PER_S, 0.0, library_call="torch.searchsorted over the first "
          "pass only")

    # K12: Q12's lineitem segment over its first 2,097,152-row reader
    # batch, Q13's orders segment (1,500,000 orders, one batch), and the
    # segments with the new rules on the inputs the main path gave them:
    # Q8's three-member segment (Year, the volume, the if_) and Q22's
    # customer segment (Substring filtered by isin)
    seg_of = {q: prog for _k, (q, prog) in segments.items()}
    k12_cases = {}
    for q, table in ((12, "lineitem"), (13, "orders")):
        hbt = host[q][table]
        k12_cases[f"q{q}"] = (seg_of[q], host_to_device(
            hbt.slice(0, min(hbt.num_rows, READER_ROWS)), 128, dev))
    for q, needle in ((8, "Year(o_orderdate)"), (22, "Substring(c_phone)")):
        key, prog = next((k, p) for k, (qq, p) in segments.items()
                         if qq == q and needle in p.describe()
                         and len(p.members) == 3)
        k12_cases[f"q{q}"] = (prog, seg_inputs[key])
    # the text path's segments: the ingest's casts fused with Q1's filter,
    # the export's formats and concatenation behind its filter
    for what in ("text q1", "export", "customer_clean"):
        key, prog = next((k, p) for k, (qq, p) in segments.items()
                         if qq == what and k in text_seg_inputs)
        k12_cases[what.replace(" ", "_")] = (prog, text_seg_inputs[key])
    # the rollup path's segments: q67's Project -> Expand (8 branches) and
    # the unpivot's Project -> Generate (k = 3), on a partition's input
    for prog, kb in rollup_seg_inputs.values():
        name = "q67_expand" if prog.describe().endswith(
            "TpuExpand[8 projections]") else "unpivot_generate"
        k12_cases[name] = (prog, kb)
    require({"q67_expand", "unpivot_generate"} <= set(k12_cases),
            "the rollup path's segments were not recorded")
    k12 = {}
    for case, (prog, kb) in k12_cases.items():
        got_l = FK.run_segment(prog, kb)
        ref_l = FK.segment_plain(prog, kb)
        require(len(got_l) == len(ref_l) == len(prog.mults),
                f"K12 {case}: {len(got_l)} output batches, plain "
                f"{len(ref_l)}")
        for (got, gkeep), (ref, rkeep) in zip(got_l, ref_l):
            require((gkeep is None and rkeep is None) or
                    torch.equal(gkeep, rkeep),
                    f"K12 {case} keep mask differs from the plain "
                    "composition")
            require(torch.equal(got.num_rows, ref.num_rows),
                    f"K12 {case} row count differs")
            for g, r in zip(got.columns, ref.columns):
                require(torch.equal(g.validity, r.validity) and
                        torch.equal(g.data.contiguous(),
                                    r.data.contiguous()) and
                        (r.lengths is None or torch.equal(
                            g.lengths.contiguous(), r.lengths.contiguous())),
                        f"K12 {case} differs from the plain composition in "
                        f"a {r.dtype} column")
        k12[case] = dict(
            ms=cuda_ms(lambda: FK.run_segment(prog, kb)),
            dev=device_ms(lambda: FK.run_segment(prog, kb)),
            plain=cuda_ms(lambda: FK.segment_plain(prog, kb)),
            enq=enqueue_ms(lambda: FK.run_segment(prog, kb)),
            bytes=prog.bytes_moved(kb), rows=kb.padded_rows,
            batches=len(got_l),
            kept=sum(int(k.sum()) if k is not None else int(b.num_rows)
                     for b, k in got_l))
        log(f"K12 {case} segment ({prog.describe()[:120]}): "
            f"{int(kb.num_rows)} rows ({kb.padded_rows} padded), "
            f"{k12[case]['kept']} kept, {k12[case]['bytes']} bytes moved; "
            f"kernel {k12[case]['ms']:.3f} ms (enqueue "
            f"{k12[case]['enq']:.3f} ms; device "
            f"{_ms_text(k12[case]['dev'])}), plain "
            f"{k12[case]['plain']:.3f} ms")
    first = k12["q12"]
    log("K12 over the text path's segments checked against their plain "
        "compositions: " + ", ".join(
            f"{c} {v['rows']} padded rows, {v['bytes']} bytes, kernel "
            f"{v['ms']:.3f} ms" for c, v in k12.items()
            if c in ("text_q1", "export")))
    entry("K12 fused_segment", "spark_rapids_tpu_torch/ops/kernels/fused.py",
          "spark_rapids_tpu/exec/fused.py:113",
          first["ms"], first["plain"], None, first["bytes"], first["rows"],
          FP32_PER_S, 0.0,
          generated_sources=len(segments),
          ms_by_segment={c: v["ms"] for c, v in k12.items()},
          plain_ms_by_segment={c: v["plain"] for c, v in k12.items()},
          bound_ms_by_segment={c: bound(v["bytes"], v["rows"],
                                        FP32_PER_S)[0]
                               for c, v in k12.items()},
          rows_by_segment={c: v["rows"] for c, v in k12.items()},
          output_batches_by_segment={c: v["batches"]
                                     for c, v in k12.items()},
          enqueue_ms_by_segment={c: v["enq"] for c, v in k12.items()},
          device_ms_by_segment={c: v["dev"] for c, v in k12.items()})

    # K13: Q14's like (startswith 'PROMO' over p_type, 200,000 parts), and
    # contains / endswith / locate_from over Q13's o_comment (1,500,000)
    pb = host_to_device(host[14]["part"], 128, dev)
    ptype = pb.columns[pb.schema.index_of("p_type")]
    ob = host_to_device(host[13]["orders"], 128, dev)
    comment = ob.columns[ob.schema.index_of("o_comment")]
    start = (torch.arange(ob.padded_rows, device=dev) % 9).to(torch.int32)
    k13_cases = {
        "startswith": (ptype, b"PROMO", ()),
        "contains": (comment, b"special", ()),
        "endswith": (comment, b"requests", ()),
        "locate_from": (comment, b"requests", (start,)),
        # orders_profile's locate('special', o_comment): one start
        "locate": (comment, b"special", (1,)),
    }
    k13 = {}
    for fn, (c, needle, extra) in k13_cases.items():
        kernel = getattr(SK, fn)
        plain = getattr(SK, f"{fn}_plain")
        got = kernel(c.data, c.lengths, needle, *extra)
        require(torch.equal(got, plain(c.data, c.lengths, needle, *extra)),
                f"K13 {fn} differs from its plain version")
        rows = c.data.shape[0]
        k13[fn] = dict(
            ms=cuda_ms(lambda: kernel(c.data, c.lengths, needle, *extra)),
            plain=cuda_ms(lambda: plain(c.data, c.lengths, needle, *extra)),
            bytes=nbytes(c.data, c.lengths, got,
                         *[x for x in extra if torch.is_tensor(x)]),
            rows=rows,
            ops=rows * c.data.shape[1], hits=int((got != 0).sum()))
        log(f"K13 {fn} {needle!r}: {rows} rows x {c.data.shape[1]} bytes, "
            f"{k13[fn]['hits']} hits; kernel {k13[fn]['ms']:.3f} ms, plain "
            f"{k13[fn]['plain']:.3f} ms")
    promo = np.char.startswith(O._text(host[14]["part"].column("p_type")),
                               b"PROMO")
    require(k13["startswith"]["hits"] == int(promo.sum()),
            "K13 startswith count differs from numpy")
    needle_t = torch.tensor(list(b"PROMO"), dtype=torch.uint8, device=dev)
    lib = (ptype.data[:, :5] == needle_t).all(1)
    require(torch.equal(lib, SK.startswith(ptype.data, ptype.lengths,
                                           b"PROMO")),
            "the library form of startswith disagrees on p_type")
    sw = k13["startswith"]
    entry("K13 string_search",
          "spark_rapids_tpu_torch/csrc/string_search.cu",
          "spark_rapids_tpu/ops/kernels/stringkernels.py:160",
          sw["ms"], sw["plain"],
          cuda_ms(lambda: (ptype.data[:, :5] == needle_t).all(1)),
          sw["bytes"], sw["ops"], FP32_PER_S, 0.0,
          library_call="(p_type[:, :5] == b'PROMO').all(1), startswith "
          "only; contains, endswith, locate_from and locate have none",
          ms_by_function={f: v["ms"] for f, v in k13.items()},
          plain_ms_by_function={f: v["plain"] for f, v in k13.items()},
          bound_ms_by_function={f: bound(v["bytes"], v["ops"],
                                         FP32_PER_S)[0]
                                for f, v in k13.items()},
          rows_by_function={f: v["rows"] for f, v in k13.items()})

    # K14: every window function kind over the clickstream at one
    # partition (8,388,608 padded rows), partitioned by user, ordered by
    # click date and time (rank and dense_rank by date alone, so ties
    # occur); first/last on wcs_sales_sk nulled where it is 0
    wb = host_to_device(clicks_host, 128, dev)
    wcols = {f.name: c for f, c in zip(wb.schema, wb.columns)}
    wrm = wb.row_mask()
    user, cdate, ctime, csales = (wcols[n] for n in (
        "wcs_user_sk", "wcs_click_date_sk", "wcs_click_time_sk",
        "wcs_sales_sk"))
    NW = wb.padded_rows

    def window_order(keys):
        order = S.lexsort_device(keys, pad_valid=wrm)
        rm_s = G.gather_array(wrm, order)
        seg_ids = S.segment_ids_device([G.gather_column(user, order)],
                                       pad_valid=rm_s)
        return order, rm_s, seg_ids

    korder, krm_s, kseg = window_order([user, cdate, ctime])
    kstart, kend = W.segment_bounds(kseg)
    dorder, drm_s, dseg = window_order([user, cdate])
    dstart = W.segment_bounds(dseg)[0]
    dok = S.segment_ids_device([G.gather_column(c, dorder)
                                for c in (user, cdate)], pad_valid=drm_s)
    dok_start = W.segment_bounds(dok)[0]
    sales_valid = csales.validity & (csales.data != 0)
    k14_cases = {
        "segment_bounds": (lambda f: f(kseg), W.segment_bounds,
                           W.segment_bounds_plain, nbytes(kseg) * 3),
        "row_number": (lambda f: f("row_number", korder, wrm, kstart),
                       W.rank_values, W.rank_values_plain,
                       nbytes(korder, wrm, kstart) + 5 * NW),
        "rank": (lambda f: f("rank", dorder, wrm, dstart, dok, dok_start),
                 W.rank_values, W.rank_values_plain,
                 nbytes(dorder, wrm, dstart, dok_start) + 5 * NW),
        "dense_rank": (lambda f: f("dense_rank", dorder, wrm, dstart, dok),
                       W.rank_values, W.rank_values_plain,
                       nbytes(dorder, wrm, dstart, dok) + 5 * NW),
    }
    frames = {"rows -4..0": (-4, 0), "unbounded": (None, None),
              "running": (None, 0), "reverse running": (0, None),
              "rows -2..2": (-2, 2)}
    fa_cases = [(k, "rows -4..0", csales.data, csales.validity)
                for k in ("count", "sum", "avg")]
    fa_cases += [(k, "unbounded", csales.data, csales.validity)
                 for k in ("count", "sum", "avg")]
    fa_cases += [(k, f, ctime.data, ctime.validity) for k in ("min", "max")
                 for f in ("unbounded", "running", "reverse running",
                           "rows -2..2")]
    fa_cases += [(k, "rows -4..0", csales.data, sales_valid)
                 for k in ("first", "last")]
    for kind, fname, vals, vvalid in fa_cases:
        lo, up = frames[fname]
        for ignore in ((False, True) if kind in ("first", "last")
                       else (False,)):
            case = f"{kind} {fname}" + (" ignore_nulls" if ignore else "")
            # read: validity, order, row mask, bounds, the values (not
            # for count) and the ids (the min/max scans); written: an
            # 8-byte result and its validity
            scan = kind in ("min", "max") and fname != "rows -2..2"
            moved = nbytes(vvalid, korder, wrm, kstart, kend) + \
                (0 if kind == "count" else nbytes(vals)) + \
                (nbytes(kseg) if scan else 0) + 9 * NW
            k14_cases[case] = (
                lambda f, kind=kind, lo=lo, up=up, ig=ignore, v=vals,
                vv=vvalid: f(kind, lo, up, ig, v, vv, korder, wrm, kseg,
                             kstart, kend),
                W.frame_aggregate, W.frame_aggregate_plain, moved)
    levels = max(1, min(5, NW).bit_length())
    log(f"K14 sparse table of rows -2..2: {levels} levels x {NW} rows x "
        f"{ctime.data.element_size()} B = "
        f"{levels * NW * ctime.data.element_size()} bytes")
    k14 = {}
    for case, (call, kernel, plain, moved) in k14_cases.items():
        got, want = call(kernel), call(plain)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            require(g.dtype == w.dtype and g.shape == w.shape,
                    f"K14 {case}: dtype or shape differs")
            if g.dtype.is_floating_point:
                # avg: a float division of exact integer sums and counts
                err = max(err, float((g - w).abs().max()))
                require(torch.allclose(g, w, rtol=1e-9, atol=0),
                        f"K14 {case} differs beyond rel 1e-9 ({err})")
            else:
                require(torch.equal(g, w),
                        f"K14 {case} differs from its plain version")
        k14[case] = dict(ms=cuda_ms(lambda: call(kernel)),
                         plain=cuda_ms(lambda: call(plain)),
                         bound=moved / HBM_BYTES_PER_S * 1e3, bytes=moved,
                         err=err)
        log(f"K14 {case}: kernel {k14[case]['ms']:.3f} ms, plain "
            f"{k14[case]['plain']:.3f} ms, bound {k14[case]['bound']:.4f} "
            f"ms, max_abs_err {err}")
    sorted_sales = G.gather_array(csales.data, korder)
    sorted_time = G.gather_array(ctime.data, korder)
    k14_lib = {"sum rows -4..0": cuda_ms(lambda: torch.cumsum(
                   sorted_sales, 0)),
               "max running": cuda_ms(lambda: torch.cummax(
                   sorted_time, 0))}
    log(f"K14 library calls: torch.cumsum of the sorted sales keys "
        f"{k14_lib['sum rows -4..0']:.3f} ms, torch.cummax of the sorted "
        f"click times {k14_lib['max running']:.3f} ms")
    head = k14["sum rows -4..0"]
    entry("K14 window", "spark_rapids_tpu_torch/csrc/window.cu",
          "spark_rapids_tpu/exec/window.py:179",
          head["ms"], head["plain"], k14_lib["sum rows -4..0"],
          head["bytes"], NW, FP32_PER_S,
          max(v["err"] for v in k14.values()),
          library_call="torch.cumsum over the sorted values (the "
          "prefix-sum part of the sum); torch.cummax for the running max",
          rows=NW,
          ms_by_function={c: v["ms"] for c, v in k14.items()},
          plain_ms_by_function={c: v["plain"] for c, v in k14.items()},
          bound_ms_by_function={c: v["bound"] for c, v in k14.items()},
          library_ms_by_function=k14_lib)

    # K15: Q22's substring(c_phone, 1, 2) over the customer table
    # (150,000 rows, 262,144 padded, 15 bytes wide), and a synthetic
    # 8,388,608 x 32-byte matrix with a negative start and out_w 8
    cust = host_to_device(host[22]["customer"], 128, dev)
    phone = cust.columns[cust.schema.index_of("c_phone")]
    rng = np.random.default_rng(15)
    syn_n, syn_w = 1 << 23, 32
    syn_len = torch.from_numpy(rng.integers(
        0, syn_w + 1, syn_n).astype(np.int32)).to(dev)
    syn_bm = torch.randint(1, 256, (syn_n, syn_w), dtype=torch.uint8,
                           device=dev)
    syn_bm = torch.where(torch.arange(syn_w, device=dev)[None, :]
                         < syn_len[:, None], syn_bm,
                         torch.zeros((), dtype=torch.uint8, device=dev))
    k15_cases = {"q22 c_phone": (phone.data, phone.lengths, 0, 2, 2),
                 "8388608 x 32 start -12": (syn_bm, syn_len, -12, 8, 8)}
    k15 = {}
    for case, (bm, lens, start, sub_len, out_w) in k15_cases.items():
        got = SK.substring(bm, lens, start, sub_len, out_w)
        ref = SK.substring_plain(bm, lens, start, sub_len, out_w)
        require(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                f"K15 differs from its plain version at {case}")
        n, w = bm.shape
        lib = None
        if start >= 0:
            sliced = (bm[:, start:start + out_w].contiguous(),
                      torch.clamp(lens - start, 0, sub_len))
            require(torch.equal(sliced[0], got[0]) and
                    torch.equal(sliced[1].to(torch.int32), got[1]),
                    f"the library form of substring disagrees at {case}")
            lib = cuda_ms(lambda: (bm[:, start:start + out_w].contiguous(),
                                   torch.clamp(lens - start, 0, sub_len)))
        k15[case] = dict(
            ms=cuda_ms(lambda: SK.substring(bm, lens, start, sub_len,
                                            out_w)),
            plain=cuda_ms(lambda: SK.substring_plain(bm, lens, start,
                                                     sub_len, out_w)),
            lib=lib, bytes=n * (4 + w) + n * (out_w + 4), rows=n)
        log(f"K15 at {case}: {n} rows x {w} bytes -> {out_w}; kernel "
            f"{k15[case]['ms']:.3f} ms, plain {k15[case]['plain']:.3f} ms, "
            f"library {lib if lib is None else round(lib, 3)} ms")
    q22c = k15["q22 c_phone"]
    entry("K15 substring", "spark_rapids_tpu_torch/csrc/string_transform.cu",
          "spark_rapids_tpu/ops/kernels/stringkernels.py:93",
          q22c["ms"], q22c["plain"], q22c["lib"], q22c["bytes"],
          q22c["rows"], FP32_PER_S, 0.0,
          library_call="bm[:, s0:s0 + out_w].contiguous() and a clamp of "
          "the lengths (a fixed start >= 0 only)",
          ms_by_shape={c: v["ms"] for c, v in k15.items()},
          plain_ms_by_shape={c: v["plain"] for c, v in k15.items()},
          library_ms_by_shape={c: v["lib"] for c, v in k15.items()},
          bound_ms_by_shape={c: bound(v["bytes"], v["rows"], FP32_PER_S)[0]
                             for c, v in k15.items()},
          rows_by_shape={c: v["rows"] for c, v in k15.items()})


    # K16: every parse over the ingest's text columns at 6,000,000 rows
    # (8,388,608 padded), a timestamp text column and a boolean column
    tdb = host_to_device(text_hb, 128, dev)
    tcol = {f.name: c for f, c in zip(tdb.schema, tdb.columns)}
    rng = np.random.default_rng(16)
    n_text = text_hb.num_rows
    ts_us = tsd.astype(np.int64) * 86_400_000_000 + rng.integers(
        0, 86_400_000_000, n_text)
    ts_bm, ts_len = tpch_datagen.timestamp_text(ts_us)
    spellings = ["t", "true", "y", "yes", "1", "f", "false", "n", "no", "0",
                 "TRUE", "False", " Yes ", "N"]
    sp_bm, sp_len = dstrings.encode(spellings)
    codes = rng.integers(0, len(spellings), n_text)
    extra = host_to_device(HostBatch(
        Schema([Field("ts", STRING), Field("b", STRING)]),
        [HostColumn(STRING, ts_bm, None, ts_len),
         HostColumn(STRING, sp_bm[codes], None, sp_len[codes])]), 128, dev)
    k16_cases = {
        "int l_orderkey": ("int", tcol["l_orderkey"]),
        "float l_extendedprice": ("float", tcol["l_extendedprice"]),
        "float l_quantity": ("float", tcol["l_quantity"]),
        "float l_discount": ("float", tcol["l_discount"]),
        "date l_shipdate": ("date", tcol["l_shipdate"]),
        "timestamp l_shipdate + time": ("timestamp", extra.columns[0]),
        "bool spellings": ("bool", extra.columns[1]),
        "trim l_extendedprice": ("trim", tcol["l_extendedprice"]),
    }

    def same_bits(g, w):
        if w.dtype.is_floating_point:
            return torch.equal(g.view(torch.int64), w.view(torch.int64))
        return torch.equal(g, w)

    k16 = {}
    for case, (kind, c) in k16_cases.items():
        if kind == "trim":
            def run_k(c=c):
                return CK.trim_aligned(c.data, c.lengths)

            def run_p(c=c):
                return CK.trim_aligned_plain(c.data, c.lengths)
        else:
            def run_k(c=c, kind=kind):
                return getattr(CK, f"parse_{kind}")(c.data, c.lengths,
                                                    c.validity)

            def run_p(c=c, kind=kind):
                return getattr(CK, f"parse_{kind}_plain")(
                    c.data, c.lengths, c.validity)
        got, ref = run_k(), run_p()
        require(all(same_bits(g, r) for g, r in zip(got, ref)),
                f"K16 {case} differs from its plain version")
        if kind not in ("trim", "bool", "timestamp"):
            require(bool(got[1][:n_text].all()),
                    f"K16 {case}: a dbgen field did not parse")
        moved = nbytes(c.data, c.lengths, *got) + \
            (0 if kind == "trim" else nbytes(c.validity))
        k16[case] = dict(ms=cuda_ms(run_k), plain=cuda_ms(run_p, reps=5),
                         bytes=moved, rows=c.data.shape[0],
                         bound=moved / HBM_BYTES_PER_S * 1e3)
        log(f"K16 {case}: {c.data.shape[0]} rows x {c.data.shape[1]} bytes; "
            f"kernel {k16[case]['ms']:.3f} ms, plain "
            f"{k16[case]['plain']:.3f} ms, bound {k16[case]['bound']:.4f} ms")
    head = k16["float l_extendedprice"]
    entry("K16 cast_parse", "spark_rapids_tpu_torch/csrc/cast_parse.cu",
          "spark_rapids_tpu/ops/kernels/castkernels.py:124",
          head["ms"], head["plain"], None, head["bytes"], head["rows"],
          FP32_PER_S, 0.0,
          library_call="none: no PyTorch call parses decimal or ISO text",
          ms_by_function={c: v["ms"] for c, v in k16.items()},
          plain_ms_by_function={c: v["plain"] for c, v in k16.items()},
          bound_ms_by_function={c: v["bound"] for c, v in k16.items()},
          rows_by_function={c: v["rows"] for c, v in k16.items()})

    # K17: the export's formats as its two-partition run called them, and
    # timestamps and booleans at the same rows
    n17 = fmt_calls["int"][0].shape[0]
    fmt_cases = {f"{k} (export)": (k, v, ok) for k, (v, ok)
                 in fmt_calls.items()}
    ts_vals = torch.from_numpy(ts_us[:n17] if n17 <= n_text else np.resize(
        ts_us, n17)).to(dev)
    any_valid = fmt_calls["int"][1]
    fmt_cases["timestamp"] = ("timestamp", ts_vals, any_valid)
    fmt_cases["bool"] = ("bool", ts_vals % 2 == 0, any_valid)
    k17 = {}
    for case, (kind, v, ok) in fmt_cases.items():
        run_k = (lambda kind=kind, v=v, ok=ok:
                 getattr(CK, f"format_{kind}")(v, ok))
        run_p = (lambda kind=kind, v=v, ok=ok:
                 getattr(CK, f"format_{kind}_plain")(v, ok))
        got, ref = run_k(), run_p()
        require(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                f"K17 {case} differs from its plain version")
        moved = nbytes(v, ok, *got)
        k17[case] = dict(ms=cuda_ms(run_k), plain=cuda_ms(run_p, reps=5),
                         bytes=moved, rows=v.shape[0],
                         bound=moved / HBM_BYTES_PER_S * 1e3)
        log(f"K17 {case}: {v.shape[0]} rows -> {got[0].shape[1]} bytes; "
            f"kernel {k17[case]['ms']:.3f} ms, plain "
            f"{k17[case]['plain']:.3f} ms, bound {k17[case]['bound']:.4f} ms")
    head = k17["int (export)"]
    entry("K17 cast_format", "spark_rapids_tpu_torch/csrc/cast_format.cu",
          "spark_rapids_tpu/ops/kernels/castkernels.py:359",
          head["ms"], head["plain"], None, head["bytes"], head["rows"],
          FP32_PER_S, 0.0,
          library_call="none: no PyTorch call formats numbers or dates as "
          "text",
          ms_by_function={c: v["ms"] for c, v in k17.items()},
          plain_ms_by_function={c: v["plain"] for c, v in k17.items()},
          bound_ms_by_function={c: v["bound"] for c, v in k17.items()},
          rows_by_function={c: v["rows"] for c, v in k17.items()})

    # K18: the export's concatenation as its two-partition run called it
    parts = concat_calls[0]
    got = SK.concat(parts)
    ref = SK.concat_plain(parts)
    require(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
            "K18 differs from its plain version")
    n18 = got[0].shape[0]
    moved = nbytes(*got) + sum(
        nbytes(bm, ln) if bm.stride(0) else nbytes(bm[:1], ln[:1])
        for bm, ln in parts)
    k18_ms = cuda_ms(lambda: SK.concat(parts))
    k18_plain = cuda_ms(lambda: SK.concat_plain(parts), reps=3, warmup=1)
    log(f"K18 at the export: {len(parts)} parts, {n18} rows -> "
        f"{got[0].shape[1]} bytes; kernel {k18_ms:.3f} ms, plain "
        f"{k18_plain:.3f} ms")
    entry("K18 concat", "spark_rapids_tpu_torch/csrc/string_transform.cu",
          "spark_rapids_tpu/ops/kernels/stringkernels.py:113",
          k18_ms, k18_plain, None, moved, n18 * got[0].shape[1], FP32_PER_S,
          0.0, library_call="none: torch.cat joins whole columns, not each "
          "row's bytes at its running length", parts=len(parts),
          rows=n18, out_width=got[0].shape[1])

    # K19-K21: each transform as the clean path called it (orders_profile
    # at one partition: 1,500,000 orders, 2,097,152 padded rows;
    # customer_clean at two with fusion off: a partition's customers),
    # against its plain version
    def case_plain(which):
        return lambda bm, ln: (SK.case_map_plain(bm, ln, which), ln)

    plain_of = {"upper": case_plain("upper"), "lower": case_plain("lower"),
                "length": SK.length_plain, "trim_ws": SK.trim_ws_plain,
                "substring_index": SK.substring_index_plain,
                "replace_single": SK.replace_single_plain}
    # (kernel, call name, cell, which of its calls there, label)
    transform_cases = [
        ("K19", "upper", "orders_profile/1", 0, "upper comment_key"),
        ("K19", "length", "orders_profile/1", 0, "length o_comment"),
        ("K19", "lower", "orders_profile/1", 0, "lower priority name"),
        ("K19", "lower", "customer_clean/2 fusion off", 0,
         "lower c_mktsegment"),
        ("K20", "trim_ws", "orders_profile/1", 0, "trim preview"),
        ("K20", "substring_index", "orders_profile/1", 0,
         "substring_index o_orderpriority '-' 1"),
        ("K20", "substring_index", "orders_profile/1", 1,
         "substring_index o_orderpriority '-' -1"),
        ("K20", "substring_index", "customer_clean/2 fusion off", 3,
         "substring_index c_comment ' ' -2"),
        ("K21", "replace_single", "orders_profile/1", 0,
         "replace o_comment ' ' -> '_'"),
        ("K21", "replace_single", "customer_clean/2 fusion off", 0,
         "replace c_phone '-' -> ''"),
    ]
    transform = {}
    for kname, fn, cell, which, what in transform_cases:
        calls = [(a, kw) for c, a, kw in clean_calls[fn] if c == cell]
        args, kw = calls[which]
        run_k = (lambda fn=fn, args=args, kw=kw: getattr(SK, fn)(*args,
                                                                 **kw))
        run_p = (lambda fn=fn, args=args, kw=kw: plain_of[fn](*args, **kw))
        got, ref = run_k(), run_p()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        require(all(torch.equal(g.to(r.dtype), r) for g, r in zip(got, ref)),
                f"{kname} {what} differs from its plain version")
        bm, ln = args[0], args[1]
        outs = [g for g in got if g is not ln]
        moved = nbytes(bm, ln, *outs)
        transform[what] = dict(
            k=kname, ms=cuda_ms(run_k), plain=cuda_ms(run_p, reps=5),
            bytes=moved, rows=bm.shape[0], width=bm.shape[1],
            out_width=got[0].shape[1] if got[0].dim() == 2 else None,
            bound=moved / HBM_BYTES_PER_S * 1e3)
        log(f"{kname} {what} ({cell}): {bm.shape[0]} rows x {bm.shape[1]} "
            f"bytes; kernel {transform[what]['ms']:.3f} ms, plain "
            f"{transform[what]['plain']:.3f} ms, bound "
            f"{transform[what]['bound']:.4f} ms")
    for kname, head_case, fname, src, ref_line, fns in (
            ("K19", "upper comment_key", "case_map", "string_case.cu",
             "stringkernels.py:66", "upper, lower (_case_map :66) and "
             "length (:83)"),
            ("K20", "trim preview", "trim_substring_index",
             "string_transform.cu", "stringkernels.py:279",
             "trim_ws (:279) and substring_index (:216)"),
            ("K21", "replace o_comment ' ' -> '_'", "replace",
             "string_replace.cu", "stringkernels.py:250",
             "replace_single (:250)")):
        mine = {c: v for c, v in transform.items() if v["k"] == kname}
        head = mine[head_case]
        entry(f"{kname} {fname}", f"spark_rapids_tpu_torch/csrc/{src}",
              f"spark_rapids_tpu/ops/kernels/{ref_line}",
              head["ms"], head["plain"], None, head["bytes"],
              head["rows"] * head["width"], FP32_PER_S, 0.0,
              library_call=f"none: no PyTorch call computes {fns} of a "
              "byte matrix",
              ms_by_call={c: v["ms"] for c, v in mine.items()},
              plain_ms_by_call={c: v["plain"] for c, v in mine.items()},
              bound_ms_by_call={c: v["bound"] for c, v in mine.items()},
              rows_by_call={c: v["rows"] for c, v in mine.items()},
              width_by_call={c: v["width"] for c, v in mine.items()})

    # B.5: the partial aggregate's string min and max of orders_profile
    # at one partition (2,097,152 padded rows, five groups), K1 + K4 + K3
    # + K4 against the reference's rank encoding in torch
    minmax = {}
    for (cell, args, kw) in clean_calls["string_minmax"][:2]:
        op = args[5]
        got = minmax_impl(*args, **kw)
        ref = S.string_minmax_plain(*args, **kw)
        require(all(torch.equal(g.to(r.dtype), r) for g, r in zip(got, ref)),
                f"string {op} differs from its plain version")
        bm, ln, valid, seg_ids, n_seg = args[:5]
        moved = nbytes(bm, ln, valid, seg_ids, *got)
        minmax[op] = dict(
            ms=cuda_ms(lambda args=args: minmax_impl(*args)),
            plain=cuda_ms(lambda args=args: S.string_minmax_plain(*args),
                          reps=3, warmup=1),
            bytes=moved, rows=bm.shape[0], width=bm.shape[1],
            groups=int((got[2] > 0).sum()),
            bound=moved / HBM_BYTES_PER_S * 1e3)
        log(f"B.5 string {op} ({cell}): {bm.shape[0]} rows x {bm.shape[1]} "
            f"bytes, {minmax[op]['groups']} groups; composition "
            f"{minmax[op]['ms']:.3f} ms, plain {minmax[op]['plain']:.3f} ms, "
            f"bound {minmax[op]['bound']:.4f} ms")
    head = minmax["min"]
    entry("B.5 string_minmax", "spark_rapids_tpu_torch/ops/kernels/segment.py",
          "spark_rapids_tpu/exec/aggregate.py:32", head["ms"],
          head["plain"], None, head["bytes"], head["rows"] * head["width"],
          FP32_PER_S, 0.0,
          library_call="none: no PyTorch call reduces strings per group",
          composition="K1 (csrc/sort.cu) + K4 scatter (csrc/gather.cu) + "
          "K3 (csrc/segment_reduce.cu) + K4 gathers",
          ms_by_op={o: v["ms"] for o, v in minmax.items()},
          plain_ms_by_op={o: v["plain"] for o, v in minmax.items()},
          bound_ms_by_op={o: v["bound"] for o, v in minmax.items()},
          rows=head["rows"], width_by_op={o: v["width"]
                                          for o, v in minmax.items()})

    # K22: the unpivot's explode as its unfused two-partition run called
    # it (a partition's 2,000,000 store sales, 2,097,152 padded rows, four
    # pass-through columns, k = 3 float64 elements), and an explode of
    # item's i_category and i_class (string elements) over its 100,000
    # rows, each against its plain version
    (xcols, xnr, xelems, xdt, xpos), _kw = rollup_calls["explode"]
    got = GK.explode(xcols, xnr, xelems, xdt, xpos)
    prm = torch.arange(xelems[0].validity.shape[0], dtype=torch.int32,
                       device=dev) < xnr
    ref = GK.explode_plain(xcols, prm, xelems, xdt, xpos)

    def same_cols(a, b):
        return all(g.dtype == r.dtype and torch.equal(g.validity, r.validity)
                   and torch.equal(g.data, r.data) and
                   (r.lengths is None or torch.equal(g.lengths, r.lengths))
                   for g, r in zip(a, b)) and len(a) == len(b)

    require(same_cols(got, ref), "K22 differs from its plain version at "
            "the unpivot's shape")
    k22_bytes = GK.explode_bytes(xcols, xelems, got)
    k = len(xelems)

    def k22_library():
        outs = [torch.repeat_interleave(c.data, k) for c in xcols]
        outs.append(torch.stack([e.data for e in xelems], 1).reshape(-1))
        return outs

    k22 = dict(ms=cuda_ms(lambda: GK.explode(xcols, xnr, xelems, xdt,
                                              xpos)),
               dev=device_ms(lambda: GK.explode(xcols, xnr, xelems, xdt,
                                                xpos)),
               prof=profiled_kernel_ms(lambda: GK.explode(
                   xcols, xnr, xelems, xdt, xpos), "explode_kernel"),
               enq=enqueue_ms(lambda: GK.explode(xcols, xnr, xelems, xdt,
                                                xpos)),
               plain=cuda_ms(lambda: GK.explode_plain(xcols, prm, xelems,
                                                      xdt, xpos)),
               lib=cuda_ms(k22_library), bytes=k22_bytes,
               rows=xelems[0].validity.shape[0])
    log(f"K22 explode at the unpivot's shape: {k22['rows']} padded rows x "
        f"{k}, {len(xcols)} pass-through columns, {k22_bytes} bytes; call "
        f"{k22['ms']:.3f} ms (enqueue {k22['enq']:.3f} ms; device "
        f"{_ms_text(k22['dev'])}; profiler's explode_kernel "
        f"{_ms_text(k22['prof'][0])} a launch, {k22['prof'][1]} of 10 "
        "launches recorded), plain "
        f"{k22['plain']:.3f} ms, repeat_interleave + stack "
        f"{k22['lib']:.3f} ms")
    ib = host_to_device(bb_host["item"], 128, dev)
    icols = {f.name: col for f, col in zip(ib.schema, ib.columns)}
    s_elems = [icols["i_category"], icols["i_class"]]
    got = GK.explode(ib.columns, ib.num_rows, s_elems, STRING, True)
    ref = GK.explode_plain(ib.columns, ib.row_mask(), s_elems, STRING, True)
    require(same_cols(got, ref), "K22 differs from its plain version on "
            "string elements")
    k22_str = dict(ms=cuda_ms(lambda: GK.explode(
        ib.columns, ib.num_rows, s_elems, STRING, True)),
        plain=cuda_ms(lambda: GK.explode_plain(
            ib.columns, ib.row_mask(), s_elems, STRING, True)),
        bytes=GK.explode_bytes(ib.columns, s_elems, got))
    log(f"K22 explode of i_category, i_class over item ({ib.padded_rows} "
        f"padded rows, {k22_str['bytes']} bytes): kernel "
        f"{k22_str['ms']:.3f} ms, plain {k22_str['plain']:.3f} ms")
    entry("K22 explode", "spark_rapids_tpu_torch/csrc/generate.cu",
          "spark_rapids_tpu/exec/generate.py:47",
          k22["ms"] if k22["dev"] is None else k22["dev"], k22["plain"],
          k22["lib"], k22_bytes, k22["rows"] * k, FP32_PER_S, 0.0,
          library_call="torch.repeat_interleave of each pass-through column "
          "+ torch.stack of the elements", enqueue_ms=k22["enq"],
          event_ms=k22["ms"], device_ms=k22["dev"],
          profiler_kernel_ms=k22["prof"][0],
          profiler_launches_of_10=k22["prof"][1],
          ms_string_elements=k22_str["ms"],
          plain_ms_string_elements=k22_str["plain"],
          bound_ms_string_elements=k22_str["bytes"] / HBM_BYTES_PER_S * 1e3)

    # K23: q67's expand as its unfused two-partition run called it (a
    # partition's joined rows, 8 projection lists x 9 columns)
    (esrc, enr, eops), _kw = rollup_calls["expand"]
    got = GK.expand(esrc, enr, eops)
    erm = torch.arange(esrc[0].validity.shape[0], dtype=torch.int32,
                       device=dev) < enr
    ref = GK.expand_plain(esrc, erm, eops)
    require(len(got) == len(ref) and all(same_cols(a, b)
                                         for a, b in zip(got, ref)),
            "K23 differs from its plain version at q67's shape")
    k23_bytes = GK.expand_bytes(esrc, eops, got)
    n_ops = sum(len(o) for o in eops)
    k23 = dict(ms=cuda_ms(lambda: GK.expand(esrc, enr, eops)),
               dev=device_ms(lambda: GK.expand(esrc, enr, eops)),
               prof=profiled_kernel_ms(lambda: GK.expand(esrc, enr, eops),
                                       "expand_kernel"),
               enq=enqueue_ms(lambda: GK.expand(esrc, enr, eops)),
               plain=cuda_ms(lambda: GK.expand_plain(esrc, erm, eops)),
               rows=esrc[0].validity.shape[0])
    log(f"K23 expand at q67's shape: {k23['rows']} padded rows ("
        f"{int(enr)} logical), {len(eops)} projections, {n_ops} ops, "
        f"{k23_bytes} bytes; call {k23['ms']:.3f} ms (enqueue "
        f"{k23['enq']:.3f} ms; device {_ms_text(k23['dev'])}; profiler's "
        f"expand_kernel {_ms_text(k23['prof'][0])} a launch, "
        f"{k23['prof'][1]} of 10 launches recorded), plain "
        f"{k23['plain']:.3f} ms")
    entry("K23 expand", "spark_rapids_tpu_torch/csrc/expand.cu",
          "spark_rapids_tpu/exec/basic.py:223",
          k23["ms"] if k23["dev"] is None else k23["dev"], k23["plain"],
          None, k23_bytes, k23["rows"] * n_ops, FP32_PER_S, 0.0,
          library_call="none: no PyTorch call writes several projected "
          "batches of literals, nulls and masked references at once",
          enqueue_ms=k23["enq"], event_ms=k23["ms"], device_ms=k23["dev"],
          profiler_kernel_ms=k23["prof"][0],
          profiler_launches_of_10=k23["prof"][1])

    # K24: the tiles of Q3's and Q18's largest hash exchange on four
    # shards, as phase 2i called it
    def same_bytes(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))

    k24 = {}
    for cell, (tb, to, ts, tc, cap, tw) in tile_calls.items():
        got, lane = DS.exchange_tiles(tb, to, ts, tc, cap, tw)
        ref, ref_lane = DS.exchange_tiles_plain(tb, to, ts, tc, cap, tw)
        require(torch.equal(lane, ref_lane), f"K24 lane mask differs from "
                f"its plain version at {cell}")
        for g, r in zip(got, ref):
            require(same_bytes(g.data[ref_lane], r.data[ref_lane]) and
                    torch.equal(g.validity, r.validity) and
                    (r.lengths is None or
                     torch.equal(g.lengths[ref_lane], r.lengths[ref_lane])),
                    f"K24 differs from its plain version in a {r.dtype} "
                    f"column at {cell}")
        flat = DS.tile_rows_plain(to, ts, tc, cap)[0].reshape(-1)

        def k24_library(tb=tb, flat=flat):
            return [t.index_select(0, flat) for c in tb.columns
                    for t in (c.data, c.validity, c.lengths)
                    if t is not None]

        def call(tb=tb, to=to, ts=ts, tc=tc, cap=cap, tw=tw):
            return DS.exchange_tiles(tb, to, ts, tc, cap, tw)

        k24[cell] = dict(
            ms=cuda_ms(call), dev=device_ms(call), enq=enqueue_ms(call),
            plain=cuda_ms(lambda tb=tb, to=to, ts=ts, tc=tc, cap=cap, tw=tw:
                          DS.exchange_tiles_plain(tb, to, ts, tc, cap, tw)),
            lib=cuda_ms(k24_library),
            bytes=DS.exchange_tiles_bytes(tb, got, ts, tc, cap),
            lanes=lane.shape[0], rows=int(tb.num_rows), capacity=cap,
            columns=[str(c.dtype) for c in tb.columns])
        v = k24[cell]
        log(f"K24 exchange_tiles at {cell}'s largest hash exchange: "
            f"{v['rows']} rows ({tb.padded_rows} padded), {len(tb.columns)} "
            f"columns {v['columns']}, capacity {cap}, {v['lanes']} lanes, "
            f"{v['bytes']} bytes (bound "
            f"{v['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms); device "
            f"{_ms_text(v['dev'])}, event {v['ms']:.3f} ms, enqueue "
            f"{v['enq']:.3f} ms, plain {v['plain']:.3f} ms, index_select "
            f"{v['lib']:.3f} ms")
    a, b = (k24[f"q{q}/{n} shards"] for q, n in DIST_K24)
    entry("K24 exchange_tiles", "spark_rapids_tpu_torch/csrc/shuffle.cu",
          "spark_rapids_tpu/parallel/exchange.py:47",
          a["ms"] if a["dev"] is None else a["dev"], a["plain"], a["lib"],
          a["bytes"], a["lanes"], FP32_PER_S, 0.0,
          library_call="torch.index_select of each column's data, validity "
          "and lengths by the plain version's rows",
          shape=f"q3/4 shards' largest hash exchange: {a['rows']} rows, "
          f"{a['lanes']} lanes", enqueue_ms=a["enq"], event_ms=a["ms"],
          device_ms=a["dev"], q18_device_ms=b["dev"], q18_event_ms=b["ms"],
          q18_enqueue_ms=b["enq"], q18_plain_ms=b["plain"],
          q18_library_ms=b["lib"],
          q18_bound_ms=b["bytes"] / HBM_BYTES_PER_S * 1e3,
          q18_rows=b["rows"], q18_lanes=b["lanes"])

    # K25: the grace join's largest bucket split of Q21 at SF10 (default
    # conf; of any SF10 cell where that took no grace path), as phase 2j's
    # warm run called it
    sb, so, sc = k25_call["args"]
    got = DS.bucket_split(sb, so, sc)
    ref = DS.bucket_split_plain(sb, so, sc)
    require(len(got) == len(ref) and all(
        (g is None) == (r is None) and (r is None or (
            int(g.num_rows) == int(r.num_rows) and all(
                same_bytes(a.data, b.data) and
                torch.equal(a.validity, b.validity) and
                (b.lengths is None or torch.equal(a.lengths, b.lengths))
                for a, b in zip(g.columns, r.columns))))
        for g, r in zip(got, ref)),
        "K25 differs from its plain version at Q21's largest split")
    layout = DS.bucket_layout(sc)
    k25_idx = [so[start:start + cnt].to(torch.int64)
               for _b, start, cnt, _cap in layout]

    def k25_library():
        return [t.index_select(0, i) for i in k25_idx for c in sb.columns
                for t in (c.data, c.validity, c.lengths) if t is not None]

    def k25_fn():
        return DS.bucket_split(sb, so, sc)

    k25 = dict(ms=cuda_ms(k25_fn), dev=device_ms(k25_fn),
               enq=enqueue_ms(k25_fn),
               plain=cuda_ms(lambda: DS.bucket_split_plain(sb, so, sc)),
               lib=cuda_ms(k25_library),
               bytes=DS.bucket_split_bytes(sb, sc),
               lanes=sum(cap for _b, _s, _c, cap in layout))
    log(f"K25 bucket_split at {k25_call['cell']}'s largest split: "
        f"{int(sb.num_rows)} rows ({sb.padded_rows} padded), "
        f"{len(sb.columns)} columns {[str(c.dtype) for c in sb.columns]}, "
        f"{len(sc)} buckets ({len(layout)} non-empty), {k25['lanes']} output "
        f"rows, {k25['bytes']} bytes (bound "
        f"{k25['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms); device "
        f"{_ms_text(k25['dev'])}, event {k25['ms']:.3f} ms, enqueue "
        f"{k25['enq']:.3f} ms, plain {k25['plain']:.3f} ms, index_select "
        f"{k25['lib']:.3f} ms")
    # K9 from the grace seed at the same run's largest seeded call
    kc, km, kseed = k9_seeded_call["args"]
    require(torch.equal(H.hash_device_batch(kc, seed=kseed),
                        H.hash_batch_plain(kc, kseed)) and
            torch.equal(H.hash_pids(kc, km, seed=kseed),
                        H.pmod(H.hash_batch_plain(kc, kseed), km)),
            f"K9 from seed {kseed} differs from its plain version")
    k9_seeded = dict(seed=kseed, m=km, rows=kc[0].data.shape[0],
                     ms=cuda_ms(lambda: H.hash_pids(kc, km, seed=kseed)),
                     plain=cuda_ms(lambda: H.pmod(
                         H.hash_batch_plain(kc, kseed), km)))
    log(f"K9 from seed {kseed} (pmod {km}) over {k9_seeded['rows']} rows "
        f"equals its plain version; {k9_seeded['ms']:.3f} ms, plain "
        f"{k9_seeded['plain']:.3f} ms")
    entry("K25 bucket_split", "spark_rapids_tpu_torch/csrc/bucket.cu",
          "spark_rapids_tpu/exec/joins.py:108",
          k25["ms"] if k25["dev"] is None else k25["dev"], k25["plain"],
          k25["lib"], k25["bytes"], k25["lanes"] * len(sb.columns),
          FP32_PER_S, 0.0,
          library_call="torch.index_select of each column's data, "
          "validity and lengths by each bucket's slice of the order",
          shape=f"{k25_call['cell']}'s largest grace split: "
          f"{int(sb.num_rows)} rows, {len(sb.columns)} columns, "
          f"{len(sc)} buckets", enqueue_ms=k25["enq"], event_ms=k25["ms"],
          device_ms=k25["dev"], k9_seeded=k9_seeded)

    # K26: the feature matrix of the Mortgage ETL's exported batches
    # (5,000,000 rows, 9 columns), as phase 2k's export called it
    kb, names = k26_inputs["etl"], M.FEATURES
    got = XK.feature_matrix(kb, names)
    ref = XK.feature_matrix_plain(kb, names)
    require(same_bytes(got, ref),
            "K26 differs from its plain version at the Mortgage frame")
    kept = int(got.shape[0])
    plans, counts = XK.count_kept(kb, names, _build.CUDA)
    sizes = counts.cpu().tolist()
    ns = [int(b.num_rows) for b in kb]
    sel = [[b.columns[b.schema.index_of(n)].data for n in names]
           for b in kb]

    def k26_library():  # a stack of casts, no null drop
        return [torch.stack([d[:n].to(torch.float32) for d in ds], 1)
                for ds, n in zip(sel, ns)]

    def k26_fn():
        return XK.feature_matrix(kb, names)

    count_dev = device_ms(lambda: XK.count_kept(kb, names, _build.CUDA))
    write_dev = device_ms(lambda: XK.write_kept(plans, sizes, _build.CUDA))
    k26 = dict(ms=cuda_ms(k26_fn), enq=enqueue_ms(k26_fn),
               dev=None if count_dev is None or write_dev is None
               else count_dev + write_dev, count_dev=count_dev,
               write_dev=write_dev,
               plain=cuda_ms(lambda: XK.feature_matrix_plain(kb, names)),
               lib=cuda_ms(k26_library),
               bytes=XK.feature_matrix_bytes(kb, names, kept))
    log(f"K26 feature_matrix at the Mortgage frame: {len(kb)} batches, "
        f"{sum(ns)} rows, {len(names)} columns "
        f"{[str(kb[0].schema[kb[0].schema.index_of(n)].dtype) for n in names]}"
        f", {kept} kept, {k26['bytes']} bytes (bound "
        f"{k26['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms); device "
        f"{_ms_text(k26['dev'])} (count {_ms_text(count_dev)}, write "
        f"{_ms_text(write_dev)}), event {k26['ms']:.3f} ms (one read back "
        f"included), enqueue {k26['enq']:.3f} ms, plain "
        f"{k26['plain']:.3f} ms, stack of casts {k26['lib']:.3f} ms")
    # the same rows as one 5,000,000-row batch: its count and write
    # passes beside the 12 batches' separate the launches' cost from
    # the rows'
    one_cols = [DeviceColumn(kb[0].schema[kb[0].schema.index_of(n)].dtype,
                             torch.cat([d[:m] for d, m in zip(ds, ns)]),
                             torch.cat([b.columns[b.schema.index_of(n)]
                                        .validity[:m]
                                        for b, m in zip(kb, ns)]))
                for n, ds in zip(names, zip(*sel))]
    one = [C.DeviceBatch(Schema([kb[0].schema[n] for n in names]),
                         one_cols, torch.tensor(sum(ns), dtype=torch.int32,
                                                device=kb[0].device))]
    require(same_bytes(XK.feature_matrix(one, names), ref),
            "K26 over the frame as one batch differs from the 12 batches'")
    one_plans, one_counts = XK.count_kept(one, names, _build.CUDA)
    one_sizes = one_counts.cpu().tolist()
    one_count_dev = device_ms(
        lambda: XK.count_kept(one, names, _build.CUDA))
    one_write_dev = device_ms(
        lambda: XK.write_kept(one_plans, one_sizes, _build.CUDA))
    log(f"K26 over the same {sum(ns)} rows as one batch (3 launches, not "
        f"{3 * len(kb)}): count {_ms_text(one_count_dev)}, write "
        f"{_ms_text(one_write_dev)}")
    del one, one_cols, one_plans, one_counts
    # the same batches with nulls: validity cleared at a seeded 1/64 of
    # the rows of three columns, and at every row of the second batch in
    # a fourth, so that K26 drops rows across tiles and skips a batch
    gen = torch.Generator(device=kb[0].device).manual_seed(26)
    nulled = []
    for i, b in enumerate(kb):
        cols = list(b.columns)
        for j, n in enumerate(names):
            c = cols[b.schema.index_of(n)]
            if j in (1, 4, 7):
                drop = torch.rand(b.padded_rows, generator=gen,
                                  device=b.device) < 1 / 64
            elif j == 2 and i == 1:
                drop = torch.ones_like(c.validity)
            else:
                continue
            cols[b.schema.index_of(n)] = DeviceColumn(
                c.dtype, c.data, c.validity & ~drop, c.lengths)
        nulled.append(C.DeviceBatch(b.schema, cols, b.num_rows))
    n_got = XK.feature_matrix(nulled, names)
    n_ref = XK.feature_matrix_plain(nulled, names)
    n_plans, n_counts = XK.count_kept(nulled, names, _build.CUDA)
    n_sizes = n_counts.cpu().tolist()
    require(same_bytes(n_got, n_ref),
            "K26 differs from its plain version with nulls at the Mortgage "
            "frame")
    require(int(n_got.shape[0]) < kept and n_sizes[1] == 0 and
            all(m < r for m, r in zip(n_sizes, ns) if r >= 1024),
            f"K26 with nulls kept {int(n_got.shape[0])} of {kept} rows, "
            f"{n_sizes} a batch of {ns}: no row or batch was dropped")
    log(f"K26 with nulls at the Mortgage frame: {int(n_got.shape[0])} of "
        f"{kept} rows kept ({n_sizes} a batch), equal to its plain version "
        "bit for bit")
    entry("K26 feature_matrix", "spark_rapids_tpu_torch/csrc/feature_matrix.cu",
          "spark_rapids_tpu/ml/columnar_export.py:53",
          k26["ms"] if k26["dev"] is None else k26["dev"], k26["plain"],
          k26["lib"], k26["bytes"], kept * len(names), FP32_PER_S, 0.0,
          library_call="stack of casts, no null drop: torch.stack of each "
          "column's first num_rows rows as float32, per batch",
          shape=f"the Mortgage feature frame: {sum(ns)} rows x "
          f"{len(names)} columns in {len(kb)} batches",
          enqueue_ms=k26["enq"], event_ms=k26["ms"], device_ms=k26["dev"],
          count_device_ms=count_dev, write_device_ms=write_dev,
          one_batch_count_device_ms=one_count_dev,
          one_batch_write_device_ms=one_write_dev)
    del got, ref, plans, counts, sel, nulled, n_got, n_ref, n_plans, n_counts

    # K27: the multi-process retile as phase 2m's workers timed it, at
    # the largest agreement and the largest trim the path gave it (worker
    # 0's max figures in the row, worker 1's beside them; the trim runs
    # on the worker that holds shard 0 after a limit)
    k27w = [res["k27"] for res in mp_results]
    a = k27w[0]
    t = next((w for w in k27w if "trim_ms" in w), None)
    require(t is not None, "phase 2m: no worker trimmed a stage output")
    k27_launch = {
        part: sum(res["cells"][c]["launches"][f"K27 {part}"]
                  for res in mp_results for c in mp_cells)
        for part in ("max", "trim")}
    log(f"K27 retile_max at {a['max_cell']}'s largest agreement (worker 0: "
        f"{a['entries']} statistics into {a['k']} words): device "
        f"{_ms_text(a['max_device_ms'])}, event {a['max_ms']:.3f} ms, "
        f"enqueue {a['max_enqueue_ms']:.3f} ms, plain "
        f"{a['max_plain_ms']:.3f} ms, torch.amax of the stacked vectors "
        f"{a['max_library_ms']:.3f} ms; gloo all_reduce(MAX) of an agreed "
        f"vector {a['gloo_all_reduce_ms']:.3f} ms (host clock); "
        f"retile_trim at {t['trim_cell']}'s trim to {t['need']} rows "
        f"({t['padded_rows']} padded rows, {t['trim_buffers']} buffers, "
        f"{t['trim_bytes']} bytes moved, bound "
        f"{t['trim_bytes'] / HBM_BYTES_PER_S * 1e3:.6f} ms) device "
        f"{_ms_text(t['trim_device_ms'])}, event {t['trim_ms']:.3f} ms, "
        f"enqueue {t['trim_enqueue_ms']:.3f} ms, plain "
        f"{t['trim_plain_ms']:.3f} ms, per-buffer clone "
        f"{t['trim_library_ms']:.3f} ms; worker 1: {k27w[1]}; on {card}")
    entry("K27 retile_max", "spark_rapids_tpu_torch/csrc/retile.cu",
          "spark_rapids_tpu/parallel/multiprocess.py:348",
          a["max_ms"] if a["max_device_ms"] is None else a["max_device_ms"],
          a["max_plain_ms"], a["max_library_ms"], a["max_bytes"],
          a["entries"] * a["k"], FP32_PER_S, 0.0,
          launches=k27_launch["max"],
          library_call="torch.stack of the shards' statistics vectors and "
          "amax(0)",
          shape=f"{a['max_cell']}'s largest agreement: {a['entries']} "
          f"statistics into {a['k']} words", event_ms=a["max_ms"],
          device_ms=a["max_device_ms"], enqueue_ms=a["max_enqueue_ms"],
          gloo_all_reduce_ms=a["gloo_all_reduce_ms"],
          bound_note="launch latency in practice: a few hundred bytes",
          worker1={k: k27w[1][k] for k in (
              "max_cell", "k", "max_ms", "max_device_ms", "max_plain_ms",
              "max_library_ms", "gloo_all_reduce_ms")})
    entry("K27 retile_trim", "spark_rapids_tpu_torch/csrc/retile.cu",
          "spark_rapids_tpu/parallel/multiprocess.py:358",
          t["trim_ms"] if t["trim_device_ms"] is None
          else t["trim_device_ms"], t["trim_plain_ms"], t["trim_library_ms"],
          t["trim_bytes"], 0, FP32_PER_S, 0.0,
          launches=k27_launch["trim"],
          status="ported; launched in " + ", ".join(
              f"{c} rank {res['rank']}" for res in mp_results
              for c in mp_cells
              if res["cells"][c]["launches"]["K27 trim"]),
          library_call="Tensor.clone of each buffer's first need rows",
          shape=f"{t['trim_cell']}'s largest trim: {t['padded_rows']} "
          f"padded rows cut to {t['need']}, {t['trim_buffers']} buffers",
          event_ms=t["trim_ms"], device_ms=t["trim_device_ms"],
          enqueue_ms=t["trim_enqueue_ms"],
          bound_note="launch latency in practice: the path trims only "
          "after a limit")

    # B.26: the write's sort by its partition columns, at phase 2l's W1
    # and W2 batches (``measure_b26``); the row's numbers are W1's, whose
    # one int64 key has a library call, W2's ride beside them
    t_b26 = time.perf_counter()
    b26, b26_lib = measure_b26(b26_inputs)
    log(f"phase 3's B.26 line took {time.perf_counter() - t_b26:.1f} s")
    w1 = b26["W1"]
    entry("B.26 sort_by_keys",
          "spark_rapids_tpu_torch/exec/write.py",
          "spark_rapids_tpu/exec/write.py:57",
          w1["ms"], w1["plain"], b26_lib, w1["bytes"],
          w1["padded"] * w1["passes"], FP32_PER_S, 0.0,
          library_call="torch.argsort(stable=True) of the key (nulls first,"
          " padding last) and torch.index_select of every array",
          shape=f"W1's first partition: {w1['rows']} rows "
          f"({w1['padded']} padded) x {w1['columns']} columns, one int64"
          " key",
          route_note="K1 (csrc/sort.cu) + K4 (csrc/gather.cu), no new "
          "kernel", enqueue_ms=w1["enq"], event_ms=w1["ms"],
          sort_event_ms=w1["sort_ms"], gather_device_ms=w1["gather_dev"],
          w2={k: b26["W2"][k] for k in ("rows", "padded", "passes", "ms",
                                        "enq", "sort_ms", "gather_dev",
                                        "plain")},
          w2_bound_ms=b26["W2"]["bytes"] / HBM_BYTES_PER_S * 1e3,
          launches_by_write_cell={c: {"K1": v["K1"], "K4": v["K4"]}
                                  for c, v in write_launches.items()})
    del b26_inputs

    log(f"timings: CUDA events, median of 10 after 2 warm-up runs, inputs "
        f"warm in L2 where they fit; card {card}")
    print(json.dumps({"queries": {f"q{q}": {"cold_s": cold[q],
                                            "warm_s": warm[q]}
                                  for q in queries},
                      "queries_two_partitions": {
                          f"q{q}": {"cold_s": cold2[q], "warm_s": warm2[q]}
                          for q in queries + LATER},
                      "tpcxbb": {cell: {"cold_s": cold[cell],
                                        "warm_s": warm[cell]}
                                 for cell in bb_cells},
                      "text": {cell: {"cold_s": cold[cell],
                                      "warm_s": warm[cell]}
                               for cell in text_runs},
                      "clean": {cell: {"cold_s": cold[cell],
                                       "warm_s": warm[cell]}
                                for cell in clean_runs},
                      "rollup": {cell: {"cold_s": cold[cell],
                                        "warm_s": warm[cell],
                                        "partial_input_batches":
                                            rollup_batches[cell]}
                                 for cell in rollup_runs},
                      "distributed": {cell: {"cold_s": cold[cell],
                                             "warm_s": warm[cell],
                                             **dist_info[cell]}
                                      for cell in dist_runs},
                      "sf10": sf10_info, "packed_upload": upload,
                      "multiprocess": mp_info,
                      "ml": ml_info, "writes": write_info,
                      "sf": SF, "rows": hb.num_rows, "padded_rows": P}))
    print(card)
    print(json.dumps({"kernels": entries}))
    require(not late, "phases 2j and 2k: " + "; ".join(late))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
