"""TPCx-BB q30 and the clickstream windows through spark_rapids_tpu_torch
(on CPU tensors, where every kernel wrapper takes its plain version)
against the JAX package's device session, on the same generated tables.

* ``tpcxbb_datagen.generate`` gives the reference generator's arrays, bit
  for bit, table for table, at two small scale factors.
* q30 at sf 0.002 (16,000 clicks, 200 items) at one and two partitions:
  the same rows in the same order (``sort("cat_a", "rn")``), all
  integers, so equal exactly; the same physical plan, exec for exec, and
  the same explain marks.
* The clickstream windows (row_number, a 5-row sum and a 5-row min per
  user in click order) over web_clickstreams at sf 0.001 (8,000 clicks),
  at one and two partitions: the same rows (all int64, exact)."""
import re

import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import f as JF
from spark_rapids_tpu.benchmarks import tpcxbb as jtpcxbb
from spark_rapids_tpu.benchmarks import tpcxbb_datagen as jgen
from spark_rapids_tpu.ops import windowexprs as JW
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch.benchmarks import tpcxbb, tpcxbb_datagen

Q30_TABLES = ("web_clickstreams", "item")


def _names(plan_string):
    return re.findall(r"^\s*(\w+)", plan_string, re.M)


def _marks(report):
    return [tuple(re.match(r"\s*([*!@]) (\w+)", line).groups())
            for line in report.splitlines()]


def _both(sf, names, n_partitions):
    gen = jgen.generate(sf, 99)
    jsess = jsrt.Session()
    jt = {n: jsess.create_dataframe(gen[n][1], gen[n][0],
                                    n_partitions=n_partitions)
          for n in names}
    psess = Session(device="cpu")
    pt = tpcxbb_datagen.dataframes(psess, sf, 99, names=names,
                                   n_partitions=n_partitions)
    return psess, pt, jt


@pytest.mark.parametrize("sf", [0.001, 0.003])
def test_generator_matches_reference(sf):
    want = jgen.generate(sf, 99)
    got = tpcxbb_datagen.generate(sf, 99)
    assert list(got) == list(want)
    for name, (schema, cols) in want.items():
        pschema, pcols = got[name]
        assert [(f.name, f.dtype.sql_name) for f in pschema] == \
            [(f.name, f.dtype.sql_name) for f in schema]
        assert list(pcols) == list(cols)
        for c, arr in cols.items():
            assert pcols[c].dtype == arr.dtype, (name, c)
            assert np.array_equal(pcols[c], arr), (name, c)


@pytest.mark.parametrize("n_partitions", [1, 2])
def test_q30_matches_reference(n_partitions):
    psess, pt, jt = _both(0.002, Q30_TABLES, n_partitions)
    df, jdf = tpcxbb.q30(pt), jtpcxbb.q30(jt)
    assert _marks(df.explain()) == _marks(jdf.explain())
    got_plan = str(psess.physical_plan(df.plan))
    want_plan = str(jdf.session.physical_plan(jdf.plan))
    assert _names(got_plan) == _names(want_plan)
    assert "TpuWindow[row_number OVER (...)]" in got_plan
    got, want = df.collect(), jdf.collect()
    assert got == want and len(got) > 10
    assert all(1 <= r[3] <= 3 for r in got)
    # v is planned twice (both sides of the self-join), so its join with
    # item and its distinct run twice: three joins, three partial
    # aggregates, each input one batch a partition
    m = psess.last_metrics
    assert m["TpuWindowExec.numInputBatches"] == n_partitions
    assert m["TpuHashAggregateExec[partial].numInputBatches"] == \
        3 * n_partitions
    assert m["TpuHashJoinExec.numJoinedPairs"] == 3 * n_partitions


@pytest.mark.parametrize("n_partitions", [1, 2])
def test_clickstream_windows_match_reference(n_partitions):
    psess, pt, jt = _both(0.001, ("web_clickstreams",), n_partitions)

    def session():
        return JW.window().partition_by("wcs_user_sk").order_by(
            "wcs_click_date_sk", "wcs_click_time_sk")

    jdf = (jt["web_clickstreams"]
           .with_window("click_no", JW.over(JW.row_number(), session()))
           .with_window("sales_last5", JW.over(
               JF.sum("wcs_sales_sk"), session().rows_between(-4, 0)))
           .with_window("min_time_5", JW.over(
               JF.min("wcs_click_time_sk"), session().rows_between(-2, 2))))
    df = tpcxbb.clickstream_windows(pt)
    assert _marks(df.explain()) == _marks(jdf.explain())
    assert _names(str(psess.physical_plan(df.plan))) == \
        _names(str(jdf.session.physical_plan(jdf.plan)))
    got, want = df.collect(), jdf.collect()
    assert len(got) == 8000
    assert sorted(got) == sorted(want)
    assert psess.last_metrics["TpuWindowExec.numInputBatches"] == \
        3 * n_partitions
