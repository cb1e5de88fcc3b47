"""The Mortgage ETL (``benchmarks/mortgage.py``) in spark_rapids_tpu_torch
(on CPU tensors) against the JAX package's device session at sf 0.005
(500 loans, 6,000 monthly records), seed 31.

* ``generate`` equals the reference's generator bit for bit, and
  ``tables`` (the string columns encoded once and indexed by the drawn
  codes) equals ``strings.encode`` of ``generate``'s object arrays byte
  for byte, numbers bit for bit.
* ``etl`` and ``summary`` at one and two partitions equal the
  reference's rows, in order: integers, strings and nulls exactly,
  floats within relative 1e-9 (averages and sums add in another order).
* ``oracle_etl``, ``oracle_summary`` and ``oracle_features`` (numpy
  alone) equal the reference's rows, so the answers the card's run is
  held against are held against the reference; the feature matrix of
  ``etl`` equals the oracle's features cast to float32, ``avg_upb``
  within 1 ULP."""
import jax
import numpy as np
import pytest

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.benchmarks import mortgage as jmortgage
from spark_rapids_tpu.exec import kernel_cache
from spark_rapids_tpu_torch import Session, ml
from spark_rapids_tpu_torch.benchmarks import mortgage as M
from spark_rapids_tpu_torch.benchmarks.tpch_oracle import check_rows
from spark_rapids_tpu_torch.data import strings as dstrings

SF, SEED = 0.005, 31


def etl_rows(want):
    """``oracle_etl``'s columns as Python rows (for small results)."""
    cols = []
    for n in want:  # etl's column order
        data, valid = want[n]
        if n == "seller":
            bm, ln = data
            vals = [dstrings.decode_one(r, k) for r, k in zip(bm, ln)]
        else:
            vals = data.tolist()
        if valid is not None:
            vals = [v if ok else None for v, ok in zip(vals, valid)]
        cols.append(vals)
    return list(zip(*cols))


@pytest.fixture(scope="module", autouse=True)
def quick_reference_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(scope="module")
def want():
    """The reference's etl and summary rows, computed once."""
    out = {}
    for name, query in (("etl", jmortgage.etl),
                        ("summary", jmortgage.summary)):
        kernel_cache.GLOBAL.reset()
        t = jmortgage.dataframes(jsrt.Session(), SF, SEED)
        out[name] = query(t).collect()
    return out


def test_generators_match_reference():
    ref = jmortgage.generate(SF, SEED)
    mine = M.generate(SF, SEED)
    tabs = M.tables(SF, SEED)
    for table, (schema, cols) in ref.items():
        mschema, mcols = mine[table]
        assert [(f.name, f.dtype.sql_name) for f in mschema] == \
            [(f.name, f.dtype.sql_name) for f in schema]
        hb = tabs[table]
        for f, c in zip(hb.schema, hb.columns):
            a = cols[f.name]
            if f.dtype.is_string:
                assert list(mcols[f.name]) == list(a)
                bm, ln = dstrings.encode(list(a))
                assert np.array_equal(c.data, bm)
                assert np.array_equal(c.lengths, ln)
                assert c.validity is None
            else:
                assert mcols[f.name].dtype == a.dtype
                assert np.array_equal(mcols[f.name].view(np.uint8),
                                      a.view(np.uint8))
                assert np.array_equal(c.data.view(np.uint8),
                                      a.view(np.uint8))


@pytest.mark.parametrize("name", ["etl", "summary"])
@pytest.mark.parametrize("n_partitions", [1, 2])
def test_query_matches_reference(want, name, n_partitions):
    sess = Session(device="cpu")
    t = M.dataframes(sess, SF, SEED, n_partitions=n_partitions)
    rows = getattr(M, name)(t).collect()
    check_rows(rows, want[name], f"{name}/{n_partitions}")


def test_oracles_match_reference(want):
    tabs = M.tables(SF, SEED)
    cols = M.oracle_etl(tabs)
    check_rows(etl_rows(cols), want["etl"], "oracle_etl")
    check_rows(M.oracle_summary(cols), want["summary"], "oracle_summary")
    # and the checker the card's run uses, on the port's result batch
    sess = Session({"spark.rapids.tpu.sql.exportColumnarRdd": True},
                   device="cpu")
    df = M.etl(M.dataframes(sess, SF, SEED))
    M.check_etl(df._result_batch(), cols)
    feats = M.oracle_features(cols)
    assert feats.shape == (len(want["etl"]), len(M.FEATURES))
    ref = np.array([[r[i] for i in (0, 2, 3, 4, 5, 6, 7, 8, 9)]
                    for r in want["etl"]], dtype=np.float64)
    assert np.allclose(feats, ref, rtol=1e-12, atol=0)
    X = ml.feature_matrix(df).numpy()
    f32 = feats.astype(np.float32)
    avg = M.FEATURES.index("avg_upb")
    others = [j for j in range(len(M.FEATURES)) if j != avg]
    assert np.array_equal(X[:, others].view(np.int32),
                          f32[:, others].view(np.int32))
    assert np.abs(X[:, avg].view(np.int32).astype(np.int64)
                  - f32[:, avg].view(np.int32)).max() <= 1


def test_check_etl_catches_a_changed_value():
    tabs = M.tables(SF, SEED)
    cols = M.oracle_etl(tabs)
    sess = Session(device="cpu")
    hb = M.etl(M.dataframes(sess, SF, SEED))._result_batch()
    hb.columns[hb.schema.index_of("avg_upb")].data[7] *= 1 + 1e-8
    with pytest.raises(AssertionError, match="avg_upb"):
        M.check_etl(hb, cols)
