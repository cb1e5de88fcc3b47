"""The exchange's write by K10's split (``exec/exchange.py:_split``; on
CPU tensors, where every kernel wrapper takes its plain PyTorch version)
against the JAX package's device session.

Hash, round-robin and range exchanges at 2, 3 and 7 output partitions,
through ``Session``: ``repartition(n, keys)``, ``repartition(n)`` and a
global sort under ``shuffle.partitions`` n, over a table of 3,000 rows in
two input partitions with a 147-byte string column, NULLs in every
column, NaN and -0.0, and a low-cardinality key, so that some hash
partitions are empty.  Rows are held against the reference's under
``spark_rapids_tpu/testing/asserts.py``'s rules, in order: a
repartition's rows come partition by partition, each in write order.
The exchange exec alone: every output partition holds the reference's
rows in the reference's order, each of its batches at
``bucket_rows(count)`` rows, the padding zero and invalid, and the
placement counts every row once."""
import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plan import functions as JF
from spark_rapids_tpu.plan import physical as JP
from spark_rapids_tpu.plan.overrides import TpuOverrides as JOverrides
from spark_rapids_tpu.plan.planner import Planner as JPlanner
from spark_rapids_tpu.plan.transitions import \
    TpuTransitionOverrides as JTransitions
from spark_rapids_tpu.shuffle import partitioning as JPart
from spark_rapids_tpu.testing.asserts import assert_rows_equal
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.data.column import bucket_rows, device_to_host
from spark_rapids_tpu_torch.exec.exchange import TpuShuffleExchangeExec
from spark_rapids_tpu_torch.plan import functions as PF
from spark_rapids_tpu_torch.plan import physical as PP
from spark_rapids_tpu_torch.plan.overrides import TpuOverrides as POverrides
from spark_rapids_tpu_torch.plan.planner import Planner as PPlanner
from spark_rapids_tpu_torch.plan.transitions import \
    TpuTransitionOverrides as PTransitions
from spark_rapids_tpu_torch.shuffle import partitioning as PPart

ROWS = 3000
STATIC = {"spark.rapids.tpu.sql.adaptive.enabled": False}
SCHEMA = [("g", "int"), ("k", "bigint"), ("s", "string"), ("v", "double")]


def _data():
    rng = np.random.default_rng(18)
    g = [None if rng.random() < 0.05 else int(x)
         for x in rng.integers(0, 2, ROWS)]
    k = [None if rng.random() < 0.1 else int(x)
         for x in rng.integers(-50, 50, ROWS)]
    s = []
    for _ in range(ROWS):
        if rng.random() < 0.1:
            s.append(None)
            continue
        n = int(rng.choice([0, 1, 5, 60, 147]))
        text = "".join(rng.choice(list("abcxyz"), n))
        if n >= 2 and rng.random() < 0.2:
            text = "é" + text[2:]  # two bytes: n bytes in all
        s.append(text)
    v = [None if rng.random() < 0.1 else float(x)
         for x in rng.choice([0.0, -0.0, np.nan, 1.5, -2.25, 3e10], ROWS)]
    return {"g": g, "k": k, "s": s, "v": v}


DATA = _data()


def _frames(conf):
    jschema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in SCHEMA])
    pschema = PT.Schema([PT.Field(n, PT.from_name(t)) for n, t in SCHEMA])
    jdf = jsrt.Session(conf).create_dataframe(
        {n: np.array(v, dtype=object) for n, v in DATA.items()}, jschema,
        n_partitions=2)
    psess = Session(conf, device="cpu")
    return psess, psess.create_dataframe(DATA, pschema, n_partitions=2), jdf


def test_strings_are_wide():
    widths = {len(x.encode()) for x in DATA["s"] if x is not None}
    assert max(widths) == 147 and 0 in widths


@pytest.mark.parametrize("n_out", [2, 3, 7])
@pytest.mark.parametrize("kind", ["hash", "round_robin", "range"])
def test_exchange_through_session_matches_reference(kind, n_out):
    conf = {**STATIC, "spark.rapids.tpu.sql.shuffle.partitions": n_out}
    psess, pdf, jdf = _frames(conf)
    if kind == "hash":
        got = pdf.repartition(n_out, "g").collect()
        want = jdf.repartition(n_out, "g").collect()
    elif kind == "round_robin":
        got = pdf.repartition(n_out).collect()
        want = jdf.repartition(n_out).collect()
    else:
        got = pdf.sort(PF.col("v").desc(), PF.col("s"), PF.col("k")) \
            .collect()
        want = jdf.sort(JF.col("v").desc(), JF.col("s"), JF.col("k")) \
            .collect()
    assert len(got) == ROWS
    assert_rows_equal(want, got)
    placements = psess.last_placements
    assert placements and all(
        sum(pl["partition_rows"]) == pl["rows_written"] == ROWS
        for pl in placements)
    if kind == "hash" and n_out == 7:
        # g has two values and nulls: four of the seven at least empty
        assert placements[0]["partition_rows"].count(0) >= 4


def _exchange(pkg, kind, n_out):
    """Per-partition batches (port) or rows (reference) of one exchange
    exec over the table."""
    if pkg == "ref":
        sess = jsrt.Session(STATIC)
        schema = JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in SCHEMA])
        df = sess.create_dataframe(
            {n: np.array(v, dtype=object) for n, v in DATA.items()}, schema,
            n_partitions=2)
        Pl, P, Part, F, Ov, Tr = (JPlanner, JP, JPart, JF, JOverrides,
                                  JTransitions)
        ctx = JP.ExecContext(sess.conf, sess)
    else:
        sess = Session(STATIC, device="cpu")
        schema = PT.Schema([PT.Field(n, PT.from_name(t)) for n, t in SCHEMA])
        df = sess.create_dataframe(DATA, schema, n_partitions=2)
        Pl, P, Part, F, Ov, Tr = (PPlanner, PP, PPart, PF, POverrides,
                                  PTransitions)
        ctx = PP.ExecContext(sess.conf, sess.device)
    scan = Pl(sess.conf).plan(df.plan)
    col = lambda n: F.col(n).expr  # noqa: E731
    if kind == "hash":
        part = Part.HashPartitioning([col("s"), col("g")], n_out)
    elif kind == "round_robin":
        part = Part.RoundRobinPartitioning(n_out)
    else:
        part = Part.RangePartitioning(
            [F.SortKey(col("v"), False), F.SortKey(col("s"), True)], n_out)
    phys = P.ShuffleExchangeExec(scan, part.bind(scan.schema))
    phys = Tr(sess.conf).apply(Ov(sess.conf).apply(phys))
    if pkg == "ref":
        data = phys.execute(ctx)
        return [[r for b in data.iterator(p) for r in b.to_rows()]
                for p in range(data.n_partitions)], None
    # the device exec under the transition back to the host
    node = phys
    while not isinstance(node, TpuShuffleExchangeExec):
        (node,) = node.children
    data = node.execute_columnar(ctx)
    return [list(data.iterator(p)) for p in range(data.n_partitions)], ctx


@pytest.mark.parametrize("n_out", [2, 3, 7])
@pytest.mark.parametrize("kind", ["hash", "round_robin", "range"])
def test_exchange_exec_partitions_match_reference(kind, n_out):
    got, ctx = _exchange("port", kind, n_out)
    want, _ = _exchange("ref", kind, n_out)
    assert len(got) == len(want) == n_out
    for batches, rows in zip(got, want):
        assert_rows_equal(rows, [r for b in batches
                                 for r in device_to_host(b).to_rows()])
        for b in batches:
            n = int(b.num_rows)
            assert n > 0 and b.padded_rows == bucket_rows(n)
            for c in b.columns:
                assert not c.validity[n:].any()
                assert not c.data[n:].any()
                if c.lengths is not None:
                    assert not c.lengths[n:].any()
    (pl,) = ctx.placements
    assert pl["rows_written"] == ROWS
    assert pl["partition_rows"] == [sum(int(b.num_rows) for b in bs)
                                    for bs in got]
