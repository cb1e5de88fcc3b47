"""Per-launch split of K10 (the exchange's partition write) and K2
(segment ids) on the card.

Runs the main path's cells once with the exchange exec and the K2
wrapper of the package found on ``sys.path`` wrapped, records every
batch an exchange writes (with its partition ids and fan-out) and every
K2 call, then replays them one cell at a time:

  * TPC-H Q1 and Q3 at SF1, two partitions (the default);
  * orders_profile (``benchmarks/tpch_clean.py`` under ``CLEAN_CONF``) at
    SF1, two partitions;
  * TPC-DS q67 (``benchmarks/tpcxbb_rollup.py``) on TPCx-BB's SF1
    tables, two partitions;
  * with ``--sf10``, TPC-H Q21 at SF10, two partitions: its largest
    exchanged batch and its largest K2 call; and the peak device memory
    of every SF10 cell of chip_smoke.py's phase 2j (Q1, Q3, Q6, Q9, Q18,
    Q21 at the default conf, Q3 and Q21 at a 64 MiB ``batchSizeBytes``),
    one cold run each.

K10 is replayed as the tree's exchange writes a batch, the count read
back left out (the counts are the data's): on a tree with
``partition_split``, K10's build and its split; on an earlier tree, the
build, K4's gather of the batch into a block (``packed_build``) and one
``packed_slice`` a non-empty partition for hash and round robin, or one
K4 compaction of ``pids == p`` a partition for range.  Each group is
held against the tree's plain versions (its calls on CPU copies) 10
times, and timed: CUDA events, device time behind a spin, host enqueue,
launches (K10's and K4's counters), the profiler's split by kernel (the
build alone too, for its ``scan_buckets`` share), the bytes the work must
move and their bound at 3.35 TB/s (the real rows' pids read twice, their
order entry written and read, each real row's data, validity and lengths
read once and written once, every padding row of a ``bucket_rows(count)``
output written once), and like-for-like library times: a stable
``argsort`` of the bucket ids, ``bincount``, ``cumsum``, and
``index_select`` of each partition's rows into a zeroed output; and the
earlier figure's composition beside it (``index_select`` into a block,
then of each partition's clamped slice at the block's padded size).

K2 is replayed call by call with the same checks; its bytes are the keys
read once (data, validity, lengths), the padding mask once and the ids
written once; its library is each key's change flags by torch
comparisons (floats with NaN equal to NaN and -0.0 to 0.0), ORed with
the padding, then ``torch.cumsum``.

K27's retile max is timed beside ``torch.stack(...).amax(0)`` at a
4-statistic agreement of 18 words (phase 2m's largest, M1 Q16), each in
one loop of 100 back-to-back calls behind a spin.

It imports the package of the checkout it lives in, so a parent tree
unpacked elsewhere with this file (and ``k1_k5_split.py``,
``k3_k4_split.py``) copied into its ``tools/`` measures the old code.
Run it on a machine with a CUDA card:

    python3 tools/k10_k2_split.py --label change [--sf10] [--out DIR]

Writes ``k10_k2_split_<label>.json`` into ``DIR`` (default: the current
directory) and prints a summary.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# the checkout this script lives in, and its sibling tools
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from k1_k5_split import card_line, cuda_ms, device_ms, split  # noqa: E402
from k3_k4_split import compare, enqueue_ms, to_cpu  # noqa: E402

REPEATS = 10
#: the scales of the SF1 cells and of the SF10 cells
SF = 1.0
SF10 = 10.0
SEED = 42
#: the device the tables go to
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12
#: chip_smoke.py's phase 2j cells: (query, batchSizeBytes or None)
SF10_CELLS = ((1, None), (3, None), (6, None), (9, None), (18, None),
              (21, None), (3, 64 << 20), (21, 64 << 20))


def row_bytes(c) -> int:
    t = c.data
    w = t.shape[1] if t.dim() == 2 else 1
    return t.element_size() * w + 1 + (4 if c.lengths is not None else 0)


def k10_bytes(batch, counts, bucket_rows) -> int:
    """Bytes K10's work must move for one batch (see the docstring)."""
    per_row = sum(row_bytes(c) for c in batch.columns)
    total = 0
    for cnt in counts:
        if cnt:
            total += 16 * cnt + 2 * per_row * cnt + \
                (bucket_rows(cnt) - cnt) * per_row
    return total


def k2_bytes(keys, pad) -> int:
    n = (keys[0].data if keys else pad).shape[0]
    total = 4 * n + (0 if pad is None else n)
    for c in keys:
        total += c.data.numel() * c.data.element_size()
        total += 0 if c.validity is None else n
        total += 0 if c.lengths is None else 4 * n
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--sf10", action="store_true",
                    help="also Q21 at SF10 and the SF10 cells' peaks")
    ap.add_argument("--out", default=".",
                    help="directory for the JSON result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k10_k2_split: no CUDA device", file=sys.stderr)
        return 2

    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch.benchmarks import (tpch, tpch_clean,
                                                   tpch_datagen,
                                                   tpcxbb_datagen,
                                                   tpcxbb_rollup)
    from spark_rapids_tpu_torch.data.column import bucket_rows
    from spark_rapids_tpu_torch.exec import exchange as EX
    from spark_rapids_tpu_torch.ops.kernels import _build
    from spark_rapids_tpu_torch.ops.kernels import gather as G
    from spark_rapids_tpu_torch.ops.kernels import retile as R
    from spark_rapids_tpu_torch.ops.kernels import segment as S
    from spark_rapids_tpu_torch.shuffle import device_shuffle as DS

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    _build.CUDA.library("shuffle")
    has_split = hasattr(DS, "partition_split")
    result = {"label": args.label, "card": card, "has_split": has_split,
              "build_s": time.perf_counter() - t0}
    dev = torch.device(DEVICE)
    k10_counters = [c for c in (
        DS.BUILD_LAUNCHES, getattr(DS, "PARTITION_SPLIT_LAUNCHES", None),
        getattr(DS, "SLICE_LAUNCHES", None), G.GATHER_LAUNCHES,
        G.COMPACT_LAUNCHES) if c is not None]

    def count(counters, fn):
        for c in counters:
            c.reset()
        fn()
        torch.cuda.synchronize()
        return {c.name: c.count for c in counters if c.count}

    # ---- record ---------------------------------------------------------
    rec = {"tag": None, "k10": [], "k2": [], "largest": False}
    Exec = EX.TpuShuffleExchangeExec
    pids_impl, range_impl = Exec._pids, Exec._write_range
    ids_impl = S.segment_ids_device

    def keep(kind, item, rows):
        calls = rec[kind]
        if rec["largest"]:
            # one call a kind and tag: the largest
            old = [c for c in calls if c[0] == rec["tag"]]
            if old and old[0][-1] >= rows:
                return
            for c in old:
                calls.remove(c)
        calls.append(item + (rows,))

    def rec_pids(self, batch, rr):
        pids = pids_impl(self, batch, rr)
        if rec["tag"] is not None:
            keep("k10", (rec["tag"], "hash", batch, pids, self.n_out),
                 batch.padded_rows)
        return pids

    def rec_range(self, child, placement):
        out = range_impl(self, child, placement)

        def seen(b, pids):
            if rec["tag"] is not None:
                keep("k10", (rec["tag"], "range", b, pids, self.n_out),
                     b.padded_rows)

        if isinstance(out, list):
            for b, pids in out:
                seen(b, pids)
            return out

        def tee():
            for b, pids in out:
                seen(b, pids)
                yield b, pids
        return tee()

    def rec_ids(sorted_keys, pad_valid=None, kernels=None):
        if rec["tag"] is not None:
            probe = sorted_keys[0].data if sorted_keys else pad_valid
            keep("k2", (rec["tag"], list(sorted_keys), pad_valid),
                 probe.shape[0])
        return ids_impl(sorted_keys, pad_valid, kernels)

    Exec._pids, Exec._write_range = rec_pids, rec_range
    S.segment_ids_device = rec_ids
    cells = {}

    def run(tag, fn):
        rec["tag"] = tag
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            fn()
        finally:
            rec["tag"] = None
        torch.cuda.synchronize()
        cells[tag] = time.perf_counter() - t
        print(f"recorded {tag} in {cells[tag]:.1f} s", flush=True)

    try:
        sess = Session(device=DEVICE)
        all_cols = tpch_datagen.draw_all(SF, SEED)
        for q in (1, 3):
            tabs = {t: sess.create_dataframe(b) for t, b in
                    tpch_datagen.tables(q, SF, SEED, cols=all_cols).items()}
            run(f"q{q}/2", lambda q=q, tabs=tabs: tpch.QUERIES[q](tabs)
                .collect())
        query, table = tpch_clean.QUERIES["orders_profile"]
        orders = tpch_datagen.tables("orders_profile", SF, SEED,
                                     cols=all_cols)[table]
        csess = Session(tpch_clean.CLEAN_CONF, device=DEVICE)
        run("orders_profile/2", lambda: query(csess.create_dataframe(
            orders, n_partitions=2)).collect())
        del all_cols
        bb = tpcxbb_datagen.generate(SF, 99)
        rtabs = {t: sess.create_dataframe(b) for t, b in
                 tpcxbb_rollup.query_tables(bb, "q67").items()}
        run("q67/2", lambda: tpcxbb_rollup.QUERIES["q67"](rtabs).collect())
        del bb, rtabs
        peaks = {}
        if args.sf10:
            cols10 = tpch_datagen.draw_all(SF10, SEED)
            for q, chunk in SF10_CELLS:
                host = tpch_datagen.tables(q, SF10, SEED, cols=cols10)
                conf = {} if chunk is None else {
                    "spark.rapids.tpu.sql.batchSizeBytes": chunk}
                s10 = Session(conf, device=DEVICE)
                tabs = {t: s10.create_dataframe(b) for t, b in host.items()}
                name = f"q{q} SF10 " + ("default" if chunk is None
                                        else "64 MiB")
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                if q == 21 and chunk is None:
                    rec["largest"] = True
                    run("q21 SF10", lambda: tpch.QUERIES[21](tabs).collect())
                    rec["largest"] = False
                else:
                    t = time.perf_counter()
                    tpch.QUERIES[q](tabs).collect()
                    torch.cuda.synchronize()
                    cells[name] = time.perf_counter() - t
                peaks[name] = torch.cuda.max_memory_allocated()
                print(f"{name}: peak device memory {peaks[name]} B",
                      flush=True)
                del tabs, s10, host
            del cols10
        result["sf10_peak_bytes"] = peaks
        result["cell_wall_s"] = cells
    finally:
        Exec._pids, Exec._write_range = pids_impl, range_impl
        S.segment_ids_device = ids_impl

    # ---- K10 ------------------------------------------------------------
    def prepared(calls):
        """Per batch: (kind, batch, pids, n_out, counts, starts)."""
        out = []
        for _tag, kind, b, pids, n, _rows in calls:
            _o, c, s = DS.partition_order_plain(pids, b.num_rows, n)
            out.append((kind, b, pids, n, c.tolist(), s.tolist()))
        return out

    def k10_work(items):
        """The tree's exchange write of every batch, counts given."""
        def fn():
            out = []
            for kind, b, pids, n, counts, starts in items:
                if has_split:
                    order, c, _s = DS.partition_order(pids, b.num_rows, n)
                    out.append(DS.partition_split(b, order, counts,
                                                  device_counts=c))
                elif kind == "range":
                    out.append([G.compact(b, pids == p) for p in range(n)])
                else:
                    block, _c, _s = DS.packed_build(b, pids, n)
                    out.append([DS.packed_slice(block, starts[p], counts[p])
                                for p in range(n) if counts[p]])
            return out
        return fn

    def k10_build(items):
        def fn():
            return [DS.partition_order(pids, b.num_rows, n)
                    for _k, b, pids, n, _c, _s in items]
        return fn

    def k10_library(items, old):
        """Like for like (see the docstring); ``old``: the earlier
        figure's composition."""
        prep = []
        for _k, b, pids, n, counts, starts in items:
            lane = torch.arange(b.padded_rows, device=dev)
            bucket = torch.where(lane < b.num_rows, pids.to(torch.int64),
                                 torch.full((), n, device=dev))
            arrays = [(a, a is c.validity) for c in b.columns
                      for a in (c.data, c.validity, c.lengths)
                      if a is not None]
            prep.append((bucket, n, counts, starts, arrays, lane))

        def fn():
            out = []
            for bucket, n, counts, starts, arrays, lane in prep:
                o = torch.argsort(bucket, stable=True)
                cnt = torch.bincount(bucket, minlength=n + 1)[:n]
                out += [cnt, torch.cumsum(cnt, 0) - cnt]
                if old:
                    blk = [(torch.index_select(a, 0, o), v)
                           for a, v in arrays]
                    top = lane.shape[0] - 1
                    for p in range(n):
                        if not counts[p]:
                            continue
                        idx = torch.clamp(starts[p] + lane, 0, top)
                        live = lane < counts[p]
                        out += [torch.index_select(a, 0, idx) & live if v
                                else torch.index_select(a, 0, idx)
                                for a, v in blk]
                    continue
                for p in range(n):
                    if not counts[p]:
                        continue
                    idx = o[starts[p]:starts[p] + counts[p]]
                    for a, _v in arrays:
                        part = torch.zeros((bucket_rows(counts[p]),) +
                                           tuple(a.shape[1:]),
                                           dtype=a.dtype, device=dev)
                        part[:counts[p]] = torch.index_select(a, 0, idx)
                        out.append(part)
            return out
        return fn

    def group(name, items, work, plain_items, counters, moved, libs):
        want = work(plain_items)()
        fn = work(items)
        first = None
        for _ in range(REPEATS):
            got = fn()
            compare(got, want, name, first)
            if first is None:
                first = got
        del first, want
        cell = {"bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "event_ms": cuda_ms(fn), "device_ms": device_ms(fn),
                "enqueue_ms": enqueue_ms(fn),
                "launches": count(counters, fn), "split": split(fn),
                "equal_runs": REPEATS}
        for key, lib in libs.items():
            cell[key] = cuda_ms(lib)
        result[name] = cell
        print(f"{name}: {json.dumps(cell)}", flush=True)
        return cell

    for tag in cells:
        calls = [c for c in rec["k10"] if c[0] == tag]
        if not calls:
            continue
        items = prepared(calls)
        plain_items = [to_cpu(it) for it in items]
        largest = max(items, key=lambda it: it[1].padded_rows)
        for name, its, plain_its in (
                (f"k10 {tag} all", items, plain_items),
                (f"k10 {tag} largest", [largest],
                 [plain_items[items.index(largest)]])):
            moved = sum(k10_bytes(b, counts, bucket_rows)
                        for _k, b, _p, _n, counts, _s in its)
            cell = group(name, its, k10_work, plain_its, k10_counters, moved,
                         {"library_ms": k10_library(its, False),
                          "library_old_ms": k10_library(its, True)})
            build = k10_build(its)
            cell["build_device_ms"] = device_ms(build)
            cell["build_split"] = split(build)
            cell["batches"] = [
                {"kind": k, "rows": int(b.num_rows), "padded": b.padded_rows,
                 "columns": len(b.columns), "n_out": n, "counts": counts,
                 "row_bytes": [row_bytes(c) for c in b.columns]}
                for k, b, _p, n, counts, _s in its]
            print(f"{name} batches: {json.dumps(cell['batches'])[:2000]}",
                  flush=True)
        del items, plain_items, largest

    # ---- K2 -------------------------------------------------------------
    def k2_work(calls):
        def fn():
            return [S.segment_ids_device(keys, pad)
                    for _t, keys, pad, _r in calls]
        return fn

    def k2_library(calls):
        def one(keys, pad):
            n = (keys[0].data if keys else pad).shape[0]
            flag = torch.zeros(n, dtype=torch.bool, device=dev)
            if pad is not None:
                flag |= ~pad
            for k in keys:
                d = k.data
                if d.is_floating_point():
                    d = torch.where(d == 0, torch.zeros_like(d), d)
                    neq = (d[1:] != d[:-1]) & ~(torch.isnan(d[1:]) &
                                                 torch.isnan(d[:-1]))
                else:
                    neq = d[1:] != d[:-1]
                if d.dim() == 2:
                    neq = neq.any(1)
                if k.lengths is not None:
                    neq = neq | (k.lengths[1:] != k.lengths[:-1])
                v = k.validity
                if v is None:
                    flag[1:] |= neq
                else:
                    flag[1:] |= (neq & v[1:] & v[:-1]) | (v[1:] != v[:-1])
            flag[0] = True
            return torch.cumsum(flag, 0, dtype=torch.int32) - 1

        def fn():
            return [one(keys, pad) for _t, keys, pad, _r in calls]
        return fn

    for tag in cells:
        calls = [c for c in rec["k2"] if c[0] == tag]
        if not calls:
            continue
        largest = max(calls, key=lambda c: c[-1])
        for name, cs in ((f"k2 {tag} all", calls),
                         (f"k2 {tag} largest", [largest])):
            moved = sum(k2_bytes(keys, pad) for _t, keys, pad, _r in cs)
            lib = k2_library(cs)
            compare(lib(), [t.cpu() for t in k2_work(cs)()],
                    f"{name} library")
            cell = group(name, cs, k2_work, to_cpu(cs),
                         [S.SEGMENT_IDS_LAUNCHES], moved,
                         {"library_ms": lib})
            cell["calls"] = [
                {"rows": r, "keys": [str(k.dtype) for k in keys],
                 "widths": [k.data.shape[1] if k.data.dim() == 2 else 0
                            for k in keys]}
                for _t, keys, _p, r in cs]
            cell["launches_per_call"] = sum(cell["launches"].values()) / \
                len(cs)

    # ---- K27's max in a loop of 100 -------------------------------------
    k = 18
    stats = [R.Stat(4 * j, torch.arange(6 if j == 3 else 4, device=dev,
                                        dtype=torch.int64) + j)
             for j in range(4)]
    vecs = []
    for st in stats:
        v = torch.zeros(k, dtype=torch.int64, device=dev)
        v[st.slot:st.slot + st.value.numel()] = st.value
        vecs.append(v)

    def loop100(fn):
        ms = device_ms(lambda: [fn() for _ in range(100)])
        return None if ms is None else ms / 100

    want = R.retile_max_plain([R.Stat(st.slot, st.value.cpu())
                               for st in stats], k, 1, 128,
                              torch.device("cpu"))
    compare(R.retile_max(stats, k, 1, 128, dev), want, "K27 max")
    result["k27_max_loop100"] = {
        "kernel_device_ms": loop100(
            lambda: R.retile_max(stats, k, 1, 128, dev)),
        "library_device_ms": loop100(lambda: torch.stack(vecs).amax(0))}
    print(f"k27: {json.dumps(result['k27_max_loop100'])}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"k10_k2_split_{args.label}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
