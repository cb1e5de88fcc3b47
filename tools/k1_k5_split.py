"""Per-launch split of K1 (the sort) and K5 (the join probe) on the card.

Times ``segment.lexsort_device`` and ``join.probe`` of the package found
on ``sys.path`` at the main path's shapes, and splits each call's device
time by CUDA kernel with ``torch.profiler``:

  * K1 at Q1's partial-aggregate keys (TPC-H SF1 lineitem after Q1's
    filter: two one-byte string keys, 8,388,608 padded rows);
  * K1 at a W2-shaped partition: 30,000,000 rows of Q1's two flag keys
    (SF1 lineitem's flags repeated five times), 33,554,432 padded;
  * K5 at Q3's second join at SF1, one partition (with and without
    ``has_r``);
  * with ``--sf10``, K1 at the largest sort that Q21 makes at SF10 (two
    partitions, the default conf).

It also counts, for Q3 and Q21 at SF1 (two partitions, one warm run),
the K1 sorts by size and the device-to-host copies the profiler records.
It imports the package of the checkout it lives in.  Run it on a
machine with a CUDA card:

    python3 tools/k1_k5_split.py --label change [--sf10] [--out DIR]

Writes ``k1_k5_split_<label>.json`` into ``DIR`` (default: the current
directory) and prints a summary.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

# the checkout this script lives in
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SPIN_CYCLES = 100_000_000


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def device_ms(fn, reps=10):
    """Median device milliseconds of ``fn`` enqueued behind a spin; None
    where the call waits on the card (a read back inside it)."""
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


def short_name(key: str) -> str:
    """A kernel's name without namespaces, template arguments and
    parameters (``void (anonymous namespace)::scatter(...)`` ->
    ``scatter``); a copy or memset keeps its name."""
    head = key[5:] if key.startswith("void ") else key
    head = head.replace("(anonymous namespace)::", "")
    head = re.sub(r"<.*>", "", head.split("(", 1)[0]).strip()
    return head.split("::")[-1] or key[:40]


def split(fn, reps=10):
    """Device ms and launches a call, by kernel name, from torch.profiler
    over ``reps`` calls after a warm-up; also every other device entry
    (copies, memsets) by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        name = short_name(e.key)
        ms, n = out.get(name, (0.0, 0))
        out[name] = (ms + e.self_device_time_total / 1e3 / reps,
                     n + e.count / reps)
    return {k: {"ms_per_call": round(v[0], 5), "launches_per_call": v[1]}
            for k, v in sorted(out.items(), key=lambda kv: -kv[1][0])}


def count_dtoh(run):
    """Device-to-host copies torch.profiler records in one call of
    ``run``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "DtoH" in e.key)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--sf10", action="store_true",
                    help="also K1 at Q21's largest sort at SF10")
    ap.add_argument("--out", default=".",
                    help="directory for the JSON result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_k5_split: no CUDA device", file=sys.stderr)
        return 2

    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
    from spark_rapids_tpu_torch.benchmarks import tpch_oracle as O
    from spark_rapids_tpu_torch.data.column import (DeviceColumn,
                                                    host_to_device)
    from spark_rapids_tpu_torch.exec.joins import TpuHashJoinExec
    from spark_rapids_tpu_torch.ops.kernels import _build
    from spark_rapids_tpu_torch.ops.kernels import gather as G
    from spark_rapids_tpu_torch.ops.kernels import join as J
    from spark_rapids_tpu_torch.ops.kernels import segment as S

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    _build.CUDA.library("sort")
    result = {"label": args.label, "card": card,
              "build_s": time.perf_counter() - t0}
    dev = torch.device("cuda")
    counters = [S.SORT_LAUNCHES, J.JOIN_PROBE_LAUNCHES,
                S.SEGMENT_IDS_LAUNCHES, G.GATHER_LAUNCHES]

    def launches(fn):
        for c in counters:
            c.reset()
        fn()
        torch.cuda.synchronize()
        return {c.name: c.count for c in counters if c.count}

    def sort_cell(name, keys, rm, repeats=10):
        want = S.lexsort_plain(keys, pad_valid=rm)
        for _ in range(repeats):
            got = S.lexsort_device(keys, pad_valid=rm)
            if not torch.equal(got, want):
                raise AssertionError(f"K1 differs from its plain version "
                                     f"at {name}")

        def fn():
            return S.lexsort_device(keys, pad_valid=rm)

        cell = {"padded": rm.shape[0], "rows": int(rm.sum()),
                "event_ms": cuda_ms(fn), "device_ms": device_ms(fn),
                "launches": launches(fn), "split": split(fn),
                "equal_runs": repeats}
        result[name] = cell
        print(f"{name}: {json.dumps(cell)}", flush=True)

    # K1 at Q1's keys (chip_smoke.py phase 3's inputs)
    all_cols = tpch_datagen.draw_all(1.0, 42)
    hb = tpch_datagen.tables(1, 1.0, 42, cols=all_cols)["lineitem"]
    db = host_to_device(hb, 128, dev)
    cols = {f.name: c for f, c in zip(db.schema, db.columns)}
    keep = (cols["l_shipdate"].data <= O._days(1998, 9, 2)) & \
        cols["l_shipdate"].validity
    fb = G.compact(db, keep)
    rm = fb.row_mask()
    fcols = {f.name: c for f, c in zip(fb.schema, fb.columns)}
    keys = [DeviceColumn(c.dtype, c.data, c.validity & rm, c.lengths)
            for c in (fcols["l_returnflag"], fcols["l_linestatus"])]
    sort_cell("k1_q1", keys, rm)

    # K1 at a W2-shaped partition: 30,000,000 rows of the two flags
    real = 30_000_000
    padded = 1 << 25
    w2 = []
    for name in ("l_returnflag", "l_linestatus"):
        c = cols[name]
        n1 = int(db.num_rows)
        reps = -(-real // n1)
        data = c.data[:n1].repeat(reps, 1)[:real]
        lengths = c.lengths[:n1].repeat(reps)[:real]
        pad = padded - real
        data = torch.cat([data, torch.zeros((pad, data.shape[1]),
                                            dtype=data.dtype, device=dev)])
        lengths = torch.cat([lengths, torch.zeros(pad, dtype=lengths.dtype,
                                                  device=dev)])
        valid = torch.arange(padded, device=dev) < real
        w2.append(DeviceColumn(c.dtype, data, valid, lengths))
    sort_cell("k1_w2", w2, torch.arange(padded, device=dev) < real)
    del w2

    # K5 at Q3's second join, and the sorts and copies of Q3 and Q21
    sess = Session()
    host = {q: tpch_datagen.tables(q, 1.0, 42, cols=all_cols)
            for q in (3, 21)}
    joined = []
    join_impl = TpuHashJoinExec._join

    def recording_join(self, lb, rb):
        out = join_impl(self, lb, rb)
        joined.append((self, lb, rb, out))
        return out

    TpuHashJoinExec._join = recording_join
    try:
        tabs = {t: sess.create_dataframe(b, n_partitions=1)
                for t, b in host[3].items()}
        tpch.q3(tabs).collect()
    finally:
        TpuHashJoinExec._join = join_impl
    ex, lb, rb, _out = joined[-1]
    lkeys = ex._keys_of(lb, ex.left_keys)
    rkeys = ex._keys_of(rb, ex.right_keys)
    l_rm, r_rm = lb.row_mask(), rb.row_mask()
    pp = J.probe_plain(lkeys, rkeys, l_rm, r_rm)
    for _ in range(10):
        pk = J.probe(lkeys, rkeys, l_rm, r_rm)
        for f in J.Probe._fields:
            if not torch.equal(getattr(pk, f), getattr(pp, f)):
                raise AssertionError(f"K5 {f} differs from its plain "
                                     "version")
    for has_r in (False, True):
        def fn(has_r=has_r):
            return J.probe(lkeys, rkeys, l_rm, r_rm, with_has_r=has_r)

        cell = {"left_padded": lb.padded_rows, "right_padded": rb.padded_rows,
                "event_ms": cuda_ms(fn), "device_ms": device_ms(fn),
                "launches": launches(fn), "split": split(fn),
                "equal_runs": 10}
        name = f"k5_q3_join2{'_has_r' if has_r else ''}"
        result[name] = cell
        print(f"{name}: {json.dumps(cell)}", flush=True)

    # every K1 sort of a query, with its rows: through _sort_cuda where
    # the package has it (the sort and the join's sort), else through
    # lexsort_device (each of whose calls read its histogram back)
    sorts = []
    sort_impl = S.lexsort_device
    if hasattr(S, "_sort_cuda"):
        inner, name = S._sort_cuda, "_sort_cuda"

        def recording(lib, words, n, dev, st, want_key=False):
            sorts.append(n)
            return inner(lib, words, n, dev, st, want_key)
    else:
        inner, name = S.lexsort_device, "lexsort_device"

        def recording(key_cols, descending=None, nulls_first=None,
                      pad_valid=None, kernels=None):
            probe = key_cols[0].data if key_cols else pad_valid
            sorts.append(probe.shape[0])
            return inner(key_cols, descending, nulls_first, pad_valid,
                         kernels)

    readbacks = getattr(S, "SORT_READBACKS", None)
    for q in (3, 21):
        tabs = {t: sess.create_dataframe(b) for t, b in host[q].items()}
        run = (lambda tabs=tabs, q=q: tpch.QUERIES[q](tabs).collect())
        run()
        setattr(S, name, recording)
        before = readbacks.count if readbacks else 0
        try:
            sorts.clear()
            run()
        finally:
            setattr(S, name, inner)
        small = getattr(S, "SMALL_SORT_ROWS", 0)
        cell = {"sorts": len(sorts), "sort_rows": sorted(sorts),
                "sort_readbacks": (readbacks.count - before) if readbacks
                else len(sorts),
                "sorts_one_block": sum(0 < n <= small for n in sorts),
                "dtoh_copies": count_dtoh(run)}
        result[f"q{q}_sf1_two_partitions"] = cell
        print(f"Q{q} SF1: {json.dumps(cell)}", flush=True)

    if args.sf10:
        del db, fb, keys
        cols10 = tpch_datagen.draw_all(10.0, 42)
        host10 = tpch_datagen.tables(21, 10.0, 42, cols=cols10)
        del cols10
        largest = {}

        def keep_largest(key_cols, descending=None, nulls_first=None,
                         pad_valid=None, kernels=None):
            probe = key_cols[0].data if key_cols else pad_valid
            if probe.shape[0] > largest.get("n", -1):
                largest.update(n=probe.shape[0], args=(
                    [DeviceColumn(c.dtype, c.data.clone(),
                                  c.validity.clone(),
                                  None if c.lengths is None
                                  else c.lengths.clone())
                     for c in key_cols], descending, nulls_first,
                    None if pad_valid is None else pad_valid.clone()))
            return sort_impl(key_cols, descending, nulls_first, pad_valid,
                             kernels)

        s10 = Session()
        tabs = {t: s10.create_dataframe(b) for t, b in host10.items()}
        S.lexsort_device = keep_largest
        try:
            tpch.QUERIES[21](tabs).collect()
        finally:
            S.lexsort_device = sort_impl
        kc, desc, nf, pv = largest["args"]
        print(f"Q21 SF10 largest sort: {largest['n']} rows, "
              f"{[str(c.dtype) for c in kc]}", flush=True)
        want = S.lexsort_plain(kc, desc, nf, pv)
        for _ in range(10):
            if not torch.equal(S.lexsort_device(kc, desc, nf, pv), want):
                raise AssertionError("K1 differs at Q21 SF10's sort")

        def fn():
            return S.lexsort_device(kc, desc, nf, pv)

        result["k1_q21_sf10"] = {
            "padded": largest["n"], "keys": [str(c.dtype) for c in kc],
            "event_ms": cuda_ms(fn), "device_ms": device_ms(fn),
            "launches": launches(fn), "split": split(fn), "equal_runs": 10}
        print(f"k1_q21_sf10: {json.dumps(result['k1_q21_sf10'])}",
              flush=True)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"k1_k5_split_{args.label}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
