"""The port's TPC-H generators and numpy oracles.

* ``tpch_datagen.generate`` gives the reference generator's arrays bit
  for bit (every table, column, dtype and value; strings as ``str``),
  at ``tests/test_tpch.py``'s SF 0.0007 and seed 7 and at a second scale
  and seed; ``reference_tables`` carries them into host batches intact.
* The fast generator (the chip's SF1 tables): ``draw_all`` cut per query
  equals each query's own draw, Q1–Q14's columns did not change when the
  later queries' columns were added after them, and every query's
  columns come with the reference's types.
* On the fast generator's tables at SF 0.003, all 22 queries through the
  port (CPU tensors, two partitions) equal ``tpch_oracle``'s numpy
  answers and return rows: the pairing ``chip_smoke.py`` checks at SF1.
  (Each oracle is held against the reference's own rows in
  ``test_torch_tpch_slice.py``, which computes them once.)"""
import numpy as np
import pytest

from spark_rapids_tpu.benchmarks import tpch_datagen as jgen
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch.benchmarks import tpch, tpch_datagen
from spark_rapids_tpu_torch.benchmarks import tpch_oracle


@pytest.mark.parametrize("sf,seed", [(0.0007, 7), (0.002, 11)])
def test_generate_matches_reference_bit_for_bit(sf, seed):
    want = jgen.generate(sf, seed)
    got = tpch_datagen.generate(sf, seed)
    assert list(got) == list(want)
    for table, (schema, cols) in want.items():
        gschema, gcols = got[table]
        assert [(f.name, f.dtype.sql_name) for f in gschema] == \
            [(f.name, f.dtype.sql_name) for f in schema]
        for f in schema:
            a, b = gcols[f.name], cols[f.name]
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tolist() == b.tolist(), f"{table}.{f.name}"
    batches = tpch_datagen.reference_tables(sf, seed)
    for table, (schema, cols) in want.items():
        b = batches[table]
        for f in schema:
            assert b.column(f.name).to_pylist() == cols[f.name].tolist()


def test_fast_generator_columns_and_cuts():
    sf, seed = 0.004, 5
    allc = tpch_datagen.draw_all(sf, seed)
    for q, layout in tpch_datagen.QUERY_COLUMNS.items():
        own = tpch_datagen.tables(q, sf, seed)
        cut = tpch_datagen.tables(q, sf, seed, cols=allc)
        assert list(own) == list(cut) == list(layout)
        for t, names in layout.items():
            assert own[t].schema.names == names
            for a, b in zip(own[t].columns, cut[t].columns):
                assert np.array_equal(a.data, b.data)
    # the reference's types for every column the queries read
    ref = {f.name: f.dtype.sql_name
           for schema, _c in jgen.generate(0.0007, 7).values()
           for f in schema}
    for layout in tpch_datagen.QUERY_COLUMNS.values():
        for names in layout.values():
            for n in names:
                assert allc[n].dtype.sql_name == ref[n], n
    # Q1's lineitem is drawn first: its rows do not depend on the rest
    q1 = tpch_datagen.lineitem(sf, seed)
    for f, col in zip(q1.schema, q1.columns):
        assert np.array_equal(col.data, allc[f.name].data)


@pytest.fixture(scope="module")
def fast_tables():
    return tpch_datagen.draw_all(0.003, 3)


@pytest.mark.parametrize("q", range(1, 23))
def test_port_matches_oracle_on_fast_tables(fast_tables, q):
    host = tpch_datagen.tables(q, 0.003, 3, cols=fast_tables)
    sess = Session(device="cpu")
    frames = {t: sess.create_dataframe(b) for t, b in host.items()}
    got = tpch.QUERIES[q](frames).collect()
    want = tpch_oracle.answer(q, host, {})
    assert len(want) > 0 and want[0][-1] is not None
    tpch_oracle.check_rows(got, want, f"Q{q}",
                           ordered=q not in tpch_oracle.UNORDERED)
