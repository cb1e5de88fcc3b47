"""Per-launch split of K7 (the join's side gather) and K14 (the window
kernel) on the card.

Times the K7 and K14 wrappers of the package found on ``sys.path`` at
the main path's shapes, and splits each call's device time by CUDA
kernel with ``torch.profiler``:

  * K7 at Q3's second join (TPC-H SF1, one partition): both sides of the
    join output, through ``join.gather_pair`` where the package has it,
    else ``join.gather_side`` once a side; its CUDA-event time, its
    device time (enqueued behind a spin), its host enqueue, its launches,
    the host cost of allocating its outputs (one ``torch.empty`` an array
    against one buffer cut into views), and two library times: the data
    arrays alone indexed by clamped indices built outside the timed call,
    and like for like (per column the clamp inside the call, data,
    validity ANDed with ``idx >= 0`` and the slot mask, lengths);
  * with ``--sf10``, K7 at the largest join output of Q18 and Q21 at
    SF10 (two partitions, the default conf), by slots times row bytes;
  * K14 for every window function kind over the clickstream (TPCx-BB
    SF1, seed 99: 8,000,000 clicks, 8,388,608 padded rows) partitioned
    by user, ordered by click date and time, as chip_smoke.py's phase 3
    calls it, with the composed library time of "sum rows -4..0".

Every call is held against its plain version 10 times (K14's float sums
also to the same bits in all 10 runs).  It imports the package of the
checkout it lives in, so a parent tree unpacked elsewhere with this file
(and ``k1_k5_split.py``) copied into its ``tools/`` measures the old
code.  Run it on a machine with a CUDA card:

    python3 tools/k7_k14_split.py --label change [--sf10] [--out DIR]

Writes ``k7_k14_split_<label>.json`` into ``DIR`` (default: the current
directory) and prints a summary.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# the checkout this script lives in, and its sibling k1_k5_split
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from k1_k5_split import card_line, cuda_ms, device_ms, split  # noqa: E402

REPEATS = 10


def enqueue_ms(fn, reps=10):
    """Host ms one call takes to return, the card drained between calls
    (median after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def host_ms(fn, reps=200):
    """Median host ms of ``fn`` (no device work waited for)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def same_cols(got, want, what):
    for g, w in zip(got, want):
        if not (torch.equal(g.data, w.data)
                and torch.equal(g.validity, w.validity)
                and (w.lengths is None or torch.equal(g.lengths, w.lengths))):
            raise AssertionError(f"K7 differs from its plain version at "
                                 f"{what} in a {w.dtype} column")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--sf10", action="store_true",
                    help="also K7 at the largest join output of Q18 and "
                    "Q21 at SF10")
    ap.add_argument("--out", default=".",
                    help="directory for the JSON result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_k14_split: no CUDA device", file=sys.stderr)
        return 2

    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch.benchmarks import (tpch, tpch_datagen,
                                                   tpcxbb_datagen)
    from spark_rapids_tpu_torch.data.column import host_to_device
    from spark_rapids_tpu_torch.exec.joins import TpuHashJoinExec
    from spark_rapids_tpu_torch.ops.kernels import _build
    from spark_rapids_tpu_torch.ops.kernels import gather as G
    from spark_rapids_tpu_torch.ops.kernels import join as J
    from spark_rapids_tpu_torch.ops.kernels import segment as S
    from spark_rapids_tpu_torch.ops.kernels import window as W

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    _build.CUDA.library("gather")
    result = {"label": args.label, "card": card,
              "build_s": time.perf_counter() - t0}
    dev = torch.device("cuda")

    def count(counter, fn):
        counter.reset()
        fn()
        torch.cuda.synchronize()
        return counter.count

    # ---- K7 -------------------------------------------------------------
    def k7_cell(name, lb_cols, rb_cols, lidx, ridx, slot_valid):
        if hasattr(J, "gather_pair"):
            def fn():
                return J.gather_pair(lb_cols, lidx, rb_cols, ridx,
                                     slot_valid)
        else:
            def fn():
                return J.gather_side(lb_cols, lidx, slot_valid) + \
                    J.gather_side(rb_cols, ridx, slot_valid)

        def plain():
            return J.gather_side_plain(lb_cols, lidx, slot_valid) + \
                J.gather_side_plain(rb_cols, ridx, slot_valid)

        want = plain()
        for _ in range(REPEATS):
            same_cols(fn(), want, name)
        pairs = [(c, i) for cols, i in ((lb_cols, lidx), (rb_cols, ridx))
                 for c in cols]
        safe = [(c, torch.clamp(i, 0, c.data.shape[0] - 1).to(torch.int64))
                for c, i in pairs]

        def library():
            out = []
            for c, i in pairs:
                s = torch.clamp(i, 0, c.data.shape[0] - 1).to(torch.int64)
                out.append((c.data[s], c.validity[s] & (i >= 0) & slot_valid,
                            None if c.lengths is None else c.lengths[s]))
            return out

        n_out = lidx.shape[0]
        shapes = [((n_out,) + tuple(c.data.shape[1:]), c.data.dtype,
                   c.lengths is not None) for c, _i in pairs]

        def alloc_each():
            return [(torch.empty(s, dtype=d, device=dev),
                     torch.empty(n_out, dtype=torch.bool, device=dev),
                     torch.empty(n_out, dtype=torch.int32, device=dev)
                     if ln else None) for s, d, ln in shapes]

        sizes = []
        for s, d, ln in shapes:
            nb = d.itemsize
            for x in s:
                nb *= x
            sizes += [-(-nb // 256) * 256, -(-n_out // 256) * 256]
            if ln:
                sizes.append(-(-4 * n_out // 256) * 256)

        def alloc_views():
            buf = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
            return buf.split(sizes)

        row_bytes = sum(c.data.element_size() * (c.data.shape[1]
                                                 if c.data.dim() == 2 else 1)
                        + 1 + (4 if c.lengths is not None else 0)
                        for c, _i in pairs)
        cell = {
            "slots": n_out, "columns": len(pairs),
            "dtypes": [str(c.dtype) for c, _i in pairs],
            "left_rows": lb_cols[0].data.shape[0],
            "right_rows": rb_cols[0].data.shape[0],
            "bytes": 2 * n_out * row_bytes + 9 * n_out,
            "event_ms": cuda_ms(fn), "device_ms": device_ms(fn),
            "enqueue_ms": enqueue_ms(fn),
            "launches": count(J.GATHER_SIDE_LAUNCHES, fn),
            "split": split(fn),
            "plain_ms": cuda_ms(plain),
            "library_like_for_like_ms": cuda_ms(library),
            "library_data_only_ms": cuda_ms(
                lambda: [c.data[i] for c, i in safe]),
            "alloc_each_host_ms": host_ms(alloc_each),
            "alloc_each_arrays": sum(3 if ln else 2 for _s, _d, ln in shapes),
            "alloc_one_buffer_views_host_ms": host_ms(alloc_views),
            "equal_runs": REPEATS}
        cell["bound_ms"] = cell["bytes"] / 3.35e12 * 1e3
        result[name] = cell
        print(f"{name}: {json.dumps(cell)}", flush=True)

    all_cols = tpch_datagen.draw_all(1.0, 42)
    sess = Session()
    expands = []
    expand_impl = TpuHashJoinExec._expand

    def recording_expand(self, c_out, total, lb, rb, pr, e):
        expands.append((lb, rb, pr, e, c_out))
        return expand_impl(self, c_out, total, lb, rb, pr, e)

    TpuHashJoinExec._expand = recording_expand
    try:
        host3 = tpch_datagen.tables(3, 1.0, 42, cols=all_cols)
        tabs = {t: sess.create_dataframe(b, n_partitions=1)
                for t, b in host3.items()}
        tpch.q3(tabs).collect()
    finally:
        TpuHashJoinExec._expand = expand_impl
    lb, rb, pr, e, c_out = expands[-1]
    lidx, ridx, slot_valid = J.expand_pairs(pr, e, c_out)
    result["q3_joins"] = len(expands)
    k7_cell("k7_q3_join2", lb.columns, rb.columns, lidx, ridx, slot_valid)
    del expands[:]

    # ---- K14 ------------------------------------------------------------
    gen = tpcxbb_datagen.generate(1.0, 99)
    clicks = tpcxbb_datagen.tables_of(gen, names=("web_clickstreams",))[
        "web_clickstreams"]
    wb = host_to_device(clicks, 128, dev)
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

    korder, _krm, kseg = window_order([user, cdate, ctime])
    kstart, kend = W.segment_bounds(kseg)
    dorder, drm_s, dseg = window_order([user, cdate])
    dstart = W.segment_bounds(dseg)[0]
    dok = S.segment_ids_device([G.gather_column(c, dorder)
                                for c in (user, cdate)], pad_valid=drm_s)
    dok_start = W.segment_bounds(dok)[0]
    sales_valid = csales.validity & (csales.data != 0)
    fsales = csales.data.to(torch.float64) * 0.01
    cases = {
        "segment_bounds": (lambda f: f(kseg), W.segment_bounds,
                           W.segment_bounds_plain),
        "row_number": (lambda f: f("row_number", korder, wrm, kstart),
                       W.rank_values, W.rank_values_plain),
        "rank": (lambda f: f("rank", dorder, wrm, dstart, dok, dok_start),
                 W.rank_values, W.rank_values_plain),
        "dense_rank": (lambda f: f("dense_rank", dorder, wrm, dstart, dok),
                       W.rank_values, W.rank_values_plain),
    }
    frames = {"rows -4..0": (-4, 0), "unbounded": (None, None),
              "running": (None, 0), "reverse running": (0, None),
              "rows -2..2": (-2, 2)}
    fa = [(k, "rows -4..0", csales.data, csales.validity)
          for k in ("count", "sum", "avg")]
    fa += [(k, "unbounded", csales.data, csales.validity)
           for k in ("count", "sum", "avg")]
    fa += [(k, f, ctime.data, ctime.validity) for k in ("min", "max")
           for f in ("unbounded", "running", "reverse running",
                     "rows -2..2")]
    fa += [(k, "rows -4..0", csales.data, sales_valid)
           for k in ("first", "last")]
    # a float64 sum (the sales keys / 100): the fixed-order prefix path
    fa += [("sum", "rows -4..0 float64", fsales, csales.validity)]
    for kind, fname, vals, vvalid in fa:
        lo, up = frames[fname.replace(" float64", "")]
        for ignore in ((False, True) if kind in ("first", "last")
                       else (False,)):
            case = f"{kind} {fname}" + (" ignore_nulls" if ignore else "")
            cases[case] = (
                lambda f, kind=kind, lo=lo, up=up, ig=ignore, v=vals,
                vv=vvalid: f(kind, lo, up, ig, v, vv, korder, wrm, kseg,
                             kstart, kend),
                W.frame_aggregate, W.frame_aggregate_plain)
    # float sums: rel 1e-9 of max(|result|, |P[hi]|), |P| at most the
    # sum of |v| (ops/kernels/window.py)
    scale = float(fsales.abs().sum())
    for case, (call, kernel, plain) in cases.items():
        want = call(plain)
        first = None
        for _ in range(REPEATS):
            got = call(kernel)
            for g, w in zip(got, want):
                if g.dtype.is_floating_point:
                    tol = 1e-9 * torch.clamp(w.abs(), min=scale)
                    if not bool(((g - w).abs() <= tol).all()):
                        raise AssertionError(f"K14 {case} differs beyond "
                                             "its tolerance")
                elif not torch.equal(g, w):
                    raise AssertionError(f"K14 {case} differs from its "
                                         "plain version")
            if first is None:
                first = got
            elif not all(torch.equal(a.view(torch.uint8),
                                     b.view(torch.uint8))
                         for a, b in zip(got, first)):
                raise AssertionError(f"K14 {case}: two runs differ in bits")

        def fn(call=call, kernel=kernel):
            return call(kernel)

        cell = {"event_ms": cuda_ms(fn), "device_ms": device_ms(fn),
                "launches": count(W.WINDOW_LAUNCHES, fn), "split": split(fn),
                "equal_runs": REPEATS}
        result[f"k14 {case}"] = cell
        print(f"k14 {case}: {json.dumps(cell)}", flush=True)

    # the composed library time of "sum rows -4..0" (chip_smoke.py's)
    o = korder.to(torch.int64)
    kvalid = csales.validity & wrm

    def frame_sum_library():
        v = torch.where(kvalid, csales.data, torch.zeros_like(csales.data))[o]
        starts = torch.searchsorted(kseg, kseg)
        pre = torch.cat([torch.zeros(1, dtype=v.dtype, device=dev),
                         torch.cumsum(v, 0)])
        i = torch.arange(v.shape[0], device=dev)
        s = pre[i + 1] - pre[torch.maximum(i - 4, starts)]
        out = torch.empty_like(s)
        out[o] = s
        return out

    result["k14 library sum rows -4..0"] = cuda_ms(frame_sum_library)
    result["k14_rows"] = NW
    print(f"k14 library sum rows -4..0: "
          f"{result['k14 library sum rows -4..0']:.4f} ms", flush=True)
    del wb, korder, dorder, kseg, dseg, kstart, kend, dok, gen, clicks

    if args.sf10:
        cols10 = tpch_datagen.draw_all(10.0, 42)
        largest = {}

        def keep_largest(self, c_out, total, lb, rb, pr, e):
            size = c_out * sum(
                c.data.element_size() * (c.data.shape[1]
                                         if c.data.dim() == 2 else 1)
                for c in lb.columns + rb.columns)
            if size > largest.get("size", -1):
                largest.update(size=size, q=current[0],
                               args=(lb, rb, J.expand_pairs(pr, e, c_out)))
            return expand_impl(self, c_out, total, lb, rb, pr, e)

        current = [None]
        TpuHashJoinExec._expand = keep_largest
        try:
            for q in (18, 21):
                current[0] = q
                host10 = tpch_datagen.tables(q, 10.0, 42, cols=cols10)
                s10 = Session()
                tabs = {t: s10.create_dataframe(b)
                        for t, b in host10.items()}
                tpch.QUERIES[q](tabs).collect()
                del tabs, host10, s10
        finally:
            TpuHashJoinExec._expand = expand_impl
        del cols10
        lb, rb, (lidx, ridx, slot_valid) = largest["args"]
        result["k7_sf10_query"] = f"Q{largest['q']}"
        k7_cell("k7_sf10_largest", lb.columns, rb.columns, lidx, ridx,
                slot_valid)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"k7_k14_split_{args.label}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
