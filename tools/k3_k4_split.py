"""Per-launch split of K4 (gather and compaction) and K3 (the segmented
reduction) on the card.

Times the K4 and K3 wrappers of the package found on ``sys.path`` at the
main path's shapes, and splits each call's device time by CUDA kernel
with ``torch.profiler``.  The calls are the ones the main path makes:
TPC-H Q1 (SF1, one partition) and the filtered text export run once
with the wrappers wrapped, and every outermost K4 or K3 call is recorded
with its arguments, then replayed as one group a place:

  * K4 at Q1's reader batch (the filter's compaction of 2,097,152 rows),
    at the partial and final aggregate nodes (their gathers: the sorted
    keys and buffer inputs, the output keys), and at the filtered text
    export's compaction of 147-byte rows;
  * B.26's gather (the write's ``gather_batch`` of every column by K1's
    order) at W1's first partition (TPCx-BB SF1 store_sales, 2,000,000
    rows, 11 columns) and, with ``--sf10``, at W2's (SF10 lineitem,
    30,000,000 rows, 14 columns);
  * K3 at Q1's partial and final aggregate nodes (every buffer and the
    segment starts), and at chip_smoke.py's one-buffer shape (the float64
    sum of l_extendedprice over Q1's 8,388,608 padded rows).

Where the package has ``gather.move`` (K4's column table), the two
compactions are also timed the other way: the kept rows' order, then one
gather by it.

For each group: CUDA events, device time behind a spin, host enqueue,
launches, the profiler's split, the bytes it must move and their bound
at 3.35 TB/s, and like-for-like library times: ``index_select`` of every
array by the same clamped indices (the mask ANDed into the validity;
compaction: a stable ``argsort`` of the dropped flags first), and
``torch.segment_reduce`` of every buffer (integer buffers as float64,
the only kind it takes).  Every group is held against
its plain version (its calls on CPU copies) 10 times: exact, K3's float
sums within rel 1e-9 and with the same bits in all 10 runs.

It imports the package of the checkout it lives in, so a parent tree
unpacked elsewhere with this file (and ``k1_k5_split.py``) copied into
its ``tools/`` measures the old code.  Run it on a machine with a CUDA
card:

    python3 tools/k3_k4_split.py --label change [--sf10] [--out DIR]

Writes ``k3_k4_split_<label>.json`` into ``DIR`` (default: the current
directory) and prints a summary.
"""
from __future__ import annotations

import argparse
import contextlib
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
#: the scale of the TPC-H and TPCx-BB tables (SF1 on the card)
SF = 1.0
#: the device the tables go to
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12
K4_NAMES = ("compact", "gather_batch", "gather_column", "gather_array",
            "gather_columns", "gather_arrays")
K3_NAMES = ("segment_min_index", "segment_reduce_device",
            "segment_aggregate", "segment_reduce_many",
            "segment_aggregate_many")


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


def to_cpu(x):
    """``x`` with every tensor (also inside columns, batches, lists and
    tuples) copied to the CPU."""
    from spark_rapids_tpu_torch.data.column import DeviceBatch, DeviceColumn

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, DeviceColumn):
        return DeviceColumn(x.dtype, to_cpu(x.data), to_cpu(x.validity),
                            to_cpu(x.lengths))
    if isinstance(x, DeviceBatch):
        return DeviceBatch(x.schema, to_cpu(x.columns), to_cpu(x.num_rows))
    if isinstance(x, (list, tuple)):
        return type(x)(to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    return x


def tensors(x):
    """Every tensor inside ``x`` (columns, batches, sequences), in order."""
    from spark_rapids_tpu_torch.data.column import DeviceBatch, DeviceColumn

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, DeviceColumn):
        return [t for t in (x.data, x.validity, x.lengths) if t is not None]
    if isinstance(x, DeviceBatch):
        return tensors(x.columns) + [x.num_rows]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in tensors(v)]
    return []


def compare(got, want, what, first=None):
    """Raise unless ``got`` (on the card) equals ``want`` (the plain
    version): exact, float64 within rel 1e-9; with ``first`` (an earlier
    run's result), also the same bits as it."""
    g, w = tensors(got), tensors(want)
    if len(g) != len(w):
        raise AssertionError(f"{what}: {len(g)} tensors, plain {len(w)}")
    for a, b in zip(g, w):
        a = a.cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: {a.dtype}{tuple(a.shape)} against"
                                 f" {b.dtype}{tuple(b.shape)}")
        if a.dtype.is_floating_point:
            ok = torch.allclose(a, b, rtol=1e-9, atol=0, equal_nan=True)
        else:
            ok = torch.equal(a, b)
        if not ok:
            raise AssertionError(f"{what} differs from its plain version")
    if first is not None:
        for a, b in zip(g, tensors(first)):
            if not torch.equal(a.reshape(-1).view(torch.uint8).cpu(),
                               b.reshape(-1).view(torch.uint8).cpu()):
                raise AssertionError(f"{what}: two runs differ in bits")


class Recorder:
    """Wraps the K4 and K3 wrappers of modules ``G`` and ``S`` (and the
    execs' own bindings of ``compact``) and records every outermost call
    made while ``tag`` is set: (tag, module name, function name, args,
    kwargs)."""

    def __init__(self, G, S, extra_modules):
        self.calls = []
        self.tag = None
        self.depth = 0
        self.saved = []
        for mod in (G, S):
            names = K4_NAMES if mod is G else K3_NAMES
            for name in names:
                if hasattr(mod, name):
                    self._wrap(mod, name, mod.__name__)
        for mod in extra_modules:
            if hasattr(mod, "compact"):
                self._wrap(mod, "compact", G.__name__)

    def _wrap(self, mod, name, owner):
        fn = getattr(mod, name)
        rec = self

        def wrapped(*args, **kwargs):
            outer = rec.depth == 0 and rec.tag is not None
            rec.depth += 1
            try:
                if outer:
                    rec.calls.append((rec.tag, owner, name, args, kwargs))
                return fn(*args, **kwargs)
            finally:
                rec.depth -= 1

        self.saved.append((mod, name, fn))
        setattr(mod, name, wrapped)

    @contextlib.contextmanager
    def tagged(self, tag):
        old, self.tag = self.tag, tag
        try:
            yield
        finally:
            self.tag = old

    def restore(self):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--sf10", action="store_true",
                    help="also B.26's gather at W2 (SF10 lineitem)")
    ap.add_argument("--out", default=".",
                    help="directory for the JSON result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_k4_split: no CUDA device", file=sys.stderr)
        return 2

    import importlib

    from spark_rapids_tpu_torch import Session
    from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
    from spark_rapids_tpu_torch.benchmarks import tpch_oracle as O
    from spark_rapids_tpu_torch.benchmarks import tpch_text as TT
    from spark_rapids_tpu_torch.benchmarks import tpcxbb_datagen
    from spark_rapids_tpu_torch.data.column import (DeviceColumn, HostBatch,
                                                    host_to_device)
    from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
    from spark_rapids_tpu_torch.ops.kernels import _build
    from spark_rapids_tpu_torch.ops.kernels import gather as G
    from spark_rapids_tpu_torch.ops.kernels import segment as S
    from spark_rapids_tpu_torch.types import Field, Schema

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    _build.CUDA.library("gather")
    result = {"label": args.label, "card": card,
              "build_s": time.perf_counter() - t0}
    dev = torch.device(DEVICE)
    k4_counters = [G.GATHER_LAUNCHES, G.COMPACT_LAUNCHES]
    k3_counters = [S.SEGMENT_REDUCE_LAUNCHES]

    def count(counters, fn):
        for c in counters:
            c.reset()
        fn()
        torch.cuda.synchronize()
        return sum(c.count for c in counters)

    def replay(calls, mods):
        def fn():
            return [getattr(mods[owner], name)(*a, **kw)
                    for _tag, owner, name, a, kw in calls]
        return fn

    def plain_of(calls, mods):
        return [getattr(mods[owner], name)(*to_cpu(a), **to_cpu(kw))
                for _tag, owner, name, a, kw in calls]

    def arrays_of(owner, name, a, kw):
        """K4 call -> ([(array, is_validity)], order, mask, keep)."""
        if name == "compact":
            batch, keep = a[0], a[1]
            return ([(t, t is c.validity) for c in batch.columns
                     for t in (c.data, c.validity, c.lengths)
                     if t is not None], None, batch.row_mask(), keep)
        order = a[1]
        mask = kw.get("valid_mask", kw.get("mask"))
        if name == "gather_batch":
            cols = a[0].columns
            mask = a[3] if len(a) > 3 else mask
        elif name in ("gather_column", "gather_columns"):
            cols = [a[0]] if name == "gather_column" else list(a[0])
            mask = a[2] if len(a) > 2 else mask
        else:
            xs = [a[0]] if name == "gather_array" else list(a[0])
            return [(x, False) for x in xs], order, None, None
        return ([(t, t is c.validity) for c in cols
                 for t in (c.data, c.validity, c.lengths) if t is not None],
                order, mask, None)

    def k4_bytes(calls):
        """Each input array read once and each output written once (the
        indices and the mask once a call)."""
        total = 0
        for _t, owner, name, a, kw in calls:
            arrs, order, mask, keep = arrays_of(owner, name, a, kw)
            for t, _v in arrs:
                n_out = t.shape[0] if order is None else order.shape[0]
                row = t.element_size() * (t.shape[1] if t.dim() == 2 else 1)
                total += row * (t.shape[0] + n_out)
            for x in (order, mask, keep):
                if x is not None:
                    total += x.numel() * x.element_size()
        return total

    def k4_library(calls):
        """index_select of every array by the call's clamped indices, the
        mask ANDed into the validity; a compaction's indices a stable
        argsort of its dropped flags, its validity cleared past the
        kept count."""
        prepared = [arrays_of(o, n, a, kw) for _t, o, n, a, kw in calls]

        def fn():
            out = []
            for arrs, order, mask, keep in prepared:
                if keep is not None:
                    kept = keep & mask
                    idx = torch.argsort((~kept).to(torch.uint8),
                                        stable=True)
                    n = kept.shape[0]
                    vmask = torch.arange(n, device=dev) < kept.sum()
                else:
                    n = arrs[0][0].shape[0]
                    idx = torch.clamp(order, 0, n - 1).to(torch.int64)
                    vmask = mask
                for t, is_valid in arrs:
                    r = torch.index_select(t, 0, idx)
                    if is_valid and vmask is not None:
                        r = r & vmask
                    out.append(r)
            return out
        return fn

    def k3_buffers(calls):
        """K3 call -> [(values or None, valid or None, op)], seg_ids."""
        bufs, ids = [], None
        for _t, owner, name, a, kw in calls:
            if name == "segment_min_index":
                bufs.append((None, None, "min"))
                ids = a[0]
            elif name in ("segment_reduce_device", "segment_aggregate"):
                op = a[4]
                vals, valid = a[0], a[1]
                if op in ("first", "first_any"):
                    vals, op = None, "min"
                elif op in ("last", "last_any"):
                    vals, op = None, "max"
                elif op == "count":
                    vals, op = None, "count"
                bufs.append((vals, valid, op))
                ids = a[2]
            else:  # segment_reduce_many / segment_aggregate_many
                for sp in a[0]:
                    vals, valid, op = sp[0], sp[1], sp[2]
                    if op in ("first", "first_any", "last", "last_any"):
                        vals, op = None, "min" if op.startswith("f") \
                            else "max"
                    elif op == "count":
                        vals = None
                    bufs.append((vals, valid, op))
                if kw.get("starts"):
                    bufs.append((None, None, "min"))
                ids = a[1]
        return bufs, ids

    def k3_bytes(calls):
        bufs, ids = k3_buffers(calls)
        n = ids.shape[0]
        nseg = n
        for _t, owner, name, a, kw in calls:
            nseg = a[1] if name == "segment_min_index" else (
                a[3] if name in ("segment_reduce_device",
                                 "segment_aggregate") else a[2])
        total = 4 * n
        for vals, valid, op in bufs:
            if vals is not None:
                total += vals.element_size() * n
            if valid is not None:
                total += n
            total += 8 * nseg * (1 if op in ("count",) else 2)
        return total

    def k3_library(calls):
        bufs, ids = k3_buffers(calls)
        n = ids.shape[0]
        lane = torch.arange(n, dtype=torch.int64, device=dev)

        def fn():
            lengths = torch.bincount(ids.to(torch.int64))
            out = []
            for vals, valid, op in bufs:
                v = lane if vals is None else vals
                if op == "count":
                    v = valid.to(torch.int64)
                    op = "sum"
                elif valid is not None:
                    if op == "sum":
                        fill = torch.zeros((), dtype=v.dtype, device=dev)
                    elif v.dtype.is_floating_point:
                        fill = torch.full((), float("inf") if op == "min"
                                          else float("-inf"), dtype=v.dtype,
                                          device=dev)
                    else:
                        info = torch.iinfo(v.dtype)
                        fill = torch.full((), info.max if op == "min"
                                          else info.min, dtype=v.dtype,
                                          device=dev)
                    v = torch.where(valid, v, fill)
                if not v.dtype.is_floating_point:
                    # torch.segment_reduce takes floating inputs only
                    v = v.to(torch.float64)
                out.append(torch.segment_reduce(v, op, lengths=lengths))
            return out
        return fn

    def group_cell(name, calls, mods, counters, kind):
        want = plain_of(calls, mods)
        fn = replay(calls, mods)
        first = None
        for _ in range(REPEATS):
            got = fn()
            compare(got, want, f"{kind} at {name}", first)
            if first is None:
                first = got
        moved = k4_bytes(calls) if kind == "K4" else k3_bytes(calls)
        cell = {"calls": [n for _t, _o, n, _a, _k in calls],
                "bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "event_ms": cuda_ms(fn), "device_ms": device_ms(fn),
                "enqueue_ms": enqueue_ms(fn),
                "launches": count(counters, fn), "split": split(fn),
                "equal_runs": REPEATS}
        try:
            cell["library_ms"] = cuda_ms(k4_library(calls) if kind == "K4"
                                         else k3_library(calls))
        except (RuntimeError, NotImplementedError) as e:
            cell["library_ms"] = None
            cell["library_error"] = str(e).splitlines()[0]
        result[name] = cell
        print(f"{name}: {json.dumps(cell)}", flush=True)
        return cell

    def compaction_by_gather(args_, name):
        """The other way to compact: the kept rows' order (K4's scan and
        order, 3 launches), then one gather of every column by it with
        the validity cleared past the count; timed beside ``compact``
        (which scatters each tile's rows to their destinations)."""
        from spark_rapids_tpu_torch.data.column import DeviceBatch

        batch, keep = args_[0], args_[1]
        lib = _build.CUDA.library("gather")
        n = batch.padded_rows

        def fn():
            order, cnt = G.compact_order(keep & batch.row_mask())
            cols = G.move(G.COMPACT_LAUNCHES, lib, "k4_gather",
                          [batch.columns], n, dev,
                          (order.data_ptr(), None, cnt.data_ptr(), n,
                           torch.cuda.current_stream().cuda_stream))
            return DeviceBatch(batch.schema, cols, cnt)

        want = G.compact_plain(to_cpu(batch), to_cpu(keep))
        for _ in range(REPEATS):
            compare(fn(), want, f"compaction by gather at {name}")
        result[name]["by_gather"] = {
            "event_ms": cuda_ms(fn), "device_ms": device_ms(fn),
            "launches": count(k4_counters, fn), "split": split(fn)}
        print(f"{name} by gather: {json.dumps(result[name]['by_gather'])}",
              flush=True)

    mods = {G.__name__: G, S.__name__: S}
    execs = [importlib.import_module(f"spark_rapids_tpu_torch.exec.{m}")
             for m in ("basic", "fused", "joins", "exchange")]
    rec = Recorder(G, S, execs)
    compute = TpuHashAggregateExec._compute

    def tagged_compute(self, batch, phase, emit):
        with rec.tagged(f"agg {self.mode}"):
            return compute(self, batch, phase, emit)

    TpuHashAggregateExec._compute = tagged_compute
    all_cols = tpch_datagen.draw_all(SF, 42)
    try:
        sess = Session(device=DEVICE)
        hb = tpch_datagen.tables(1, SF, 42, cols=all_cols)["lineitem"]
        li = sess.create_dataframe(hb, n_partitions=1)
        with rec.tagged("q1"):
            tpch.q1({"lineitem": li}).collect()
        export_hb = tpch_datagen.export_table(SF, 42, cols=all_cols)
        tsess = Session(TT.CAST_CONF, device=DEVICE)
        with rec.tagged("export"):
            TT.filtered_export(tsess.create_dataframe(
                export_hb, n_partitions=1))._result_batch()
    finally:
        TpuHashAggregateExec._compute = compute
        rec.restore()
    del all_cols
    calls = rec.calls
    result["recorded"] = [(t, n) for t, _o, n, _a, _k in calls]
    print(f"recorded: {result['recorded']}", flush=True)

    def pick(tag, names):
        return [c for c in calls if c[0] == tag and c[2] in names]

    reader = pick("q1", ("compact",))[:1]
    group_cell("k4 q1 reader batch compact", reader, mods, k4_counters,
               "K4")
    for mode in ("partial", "final"):
        group_cell(f"k4 q1 {mode} aggregate gathers",
                   pick(f"agg {mode}", K4_NAMES), mods, k4_counters, "K4")
        group_cell(f"k3 q1 {mode} aggregate", pick(f"agg {mode}", K3_NAMES),
                   mods, k3_counters, "K3")
    if hasattr(G, "move"):
        compaction_by_gather(reader[0][3], "k4 q1 reader batch compact")
    exp = pick("export", ("compact",))
    exp = sorted(exp, key=lambda c: -c[3][0].padded_rows)[:1]
    result["export_row_bytes"] = exp[0][3][0].columns[0].data.shape[1]
    group_cell("k4 export compact", exp, mods, k4_counters, "K4")
    if hasattr(G, "move"):
        compaction_by_gather(exp[0][3], "k4 export compact")
    del calls, rec.calls[:], reader, exp

    # K3 at chip_smoke.py's one-buffer shape: the float64 sum of
    # l_extendedprice over Q1's filtered, sorted lineitem
    db = host_to_device(hb, 128, dev)
    cols = {f.name: c for f, c in zip(db.schema, db.columns)}
    keep = (cols["l_shipdate"].data <= O._days(1998, 9, 2)) & \
        cols["l_shipdate"].validity
    fb = G.compact(db, keep)
    P = fb.padded_rows
    rm = fb.row_mask()
    fcols = {f.name: c for f, c in zip(fb.schema, fb.columns)}
    keys = [DeviceColumn(c.dtype, c.data, c.validity & rm, c.lengths)
            for c in (fcols["l_returnflag"], fcols["l_linestatus"])]
    perm = S.lexsort_device(keys, pad_valid=rm)
    sorted_keys = [G.gather_column(k, perm) for k in keys]
    ids = S.segment_ids_device(sorted_keys, pad_valid=rm)
    price = G.gather_array(fcols["l_extendedprice"].data, perm)
    pvalid = G.gather_array(fcols["l_extendedprice"].validity & rm, perm)
    one = [("row4", S.__name__, "segment_aggregate",
            (price, pvalid, ids, P, "sum"), {})]
    group_cell("k3 one buffer (row 4)", one, mods, k3_counters, "K3")
    del db, fb, cols, fcols, keys, perm, sorted_keys, ids, price, pvalid

    # B.26's gather at W1's (and W2's) first partition
    def b26_cell(name, host, key_names):
        b = host_to_device(host, 128, dev)
        kcols = [b.columns[b.schema.index_of(k)] for k in key_names]
        order = S.lexsort_device(kcols, pad_valid=b.row_mask())
        call = [(name, G.__name__, "gather_batch",
                 (b, order, b.num_rows), {})]
        cell = group_cell(name, call, mods, k4_counters, "K4")
        cell.update(rows=int(b.num_rows), padded=b.padded_rows,
                    columns=len(b.columns))

    gen = tpcxbb_datagen.generate(SF, 99)
    ss = tpcxbb_datagen.tables_of(gen, ["store_sales"])["store_sales"]
    b26_cell("k4 b26 gather W1", ss.slice(0, min(2_000_000, ss.num_rows)),
             ["ss_sold_date_sk"])
    del gen, ss
    if args.sf10:
        cols10 = tpch_datagen.draw_all(10.0, 42)
        names = [c for c in cols10 if c.startswith("l_")]
        w2 = HostBatch(Schema([Field(c, cols10[c].dtype) for c in names]),
                       [cols10[c] for c in names])
        del cols10
        b26_cell("k4 b26 gather W2", w2.slice(0, 30_000_000),
                 ["l_returnflag", "l_linestatus"])

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"k3_k4_split_{args.label}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
