"""Plain versions of K8 (string equality and comparison) and K13 (string
search) in spark_rapids_tpu_torch, held against the JAX package's
``stringkernels`` on the same numpy byte matrices.  Exact.

K8: ``equals`` and ``compare`` at widths 1, 8, 10 and 25 on either side;
empty strings, equal prefixes of different lengths, bytes >= 0x80, and a
one-row literal against a matrix (the form a string literal takes in a
predicate).  The five string comparisons also run as DataFrame filters
against the reference session.

K13: ``contains``, ``startswith``, ``endswith`` and ``locate_from`` at
widths 1, 7 and 12, for empty needles, needles as wide as the matrix and
wider, and multi-byte characters; and ``Like`` for prefix, suffix,
``%a%b%``, exact and empty patterns, the port's expression against the
reference's ``Like.eval_tpu``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.ops.kernels import stringkernels as jsk
from spark_rapids_tpu_torch import Session
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.ops.kernels import stringkernels as psk

N = 96
WORDS = [b"", b"a", b"ab", b"abc", b"abd", b"BUILDING", b"BUILDINGS",
         b"AUTOMOBILE", b"\xc3\xa9", b"\xc3\xa9a", b"\xff", b"a\x80",
         b"abcdefghijklmnopqrstuvwxy"]


def _matrix(rng, n, w):
    """n strings of at most w bytes (longer words are cut to w)."""
    bm = np.zeros((n, w), dtype=np.uint8)
    ln = np.zeros(n, dtype=np.int32)
    for i, k in enumerate(rng.integers(0, len(WORDS), n)):
        b = WORDS[k][:w]
        bm[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        ln[i] = len(b)
    return bm, ln


def _check(lbm, llen, rbm, rlen):
    want_eq = np.asarray(jsk.equals(*(jnp.asarray(a) for a in
                                      (lbm, llen, rbm, rlen))))
    want_cmp = np.asarray(jsk.compare(*(jnp.asarray(a) for a in
                                        (lbm, llen, rbm, rlen))))
    args = [torch.from_numpy(a) for a in (lbm, llen, rbm, rlen)]
    got_eq = psk.equals(*args)
    got_cmp = psk.compare(*args)
    assert got_eq.dtype == torch.bool and got_cmp.dtype == torch.int32
    np.testing.assert_array_equal(got_eq.numpy(), want_eq)
    np.testing.assert_array_equal(got_cmp.numpy(), want_cmp)
    return got_eq, got_cmp


@pytest.mark.parametrize("lw", [1, 8, 10, 25])
@pytest.mark.parametrize("rw", [1, 8, 10, 25])
def test_matrix_against_matrix(lw, rw):
    rng = np.random.default_rng(lw * 100 + rw)
    lbm, llen = _matrix(rng, N, lw)
    rbm, rlen = _matrix(rng, N, rw)
    # half the rows compare a string with itself or its own prefix
    half = N // 2
    k = min(lw, rw)
    rbm[:half] = 0
    rbm[:half, :k] = lbm[:half, :k]
    rlen[:half] = np.minimum(llen[:half], k)
    eq, cmp = _check(lbm, llen, rbm, rlen)
    assert bool(eq.any()) and bool((cmp != 0).any())


@pytest.mark.parametrize("literal", [b"BUILDING", b"", b"\xc3\xa9", b"ab"])
@pytest.mark.parametrize("w", [1, 10, 25])
def test_literal_against_matrix(literal, w):
    rng = np.random.default_rng(w)
    bm, ln = _matrix(rng, N, w)
    lit = np.zeros((1, max(1, len(literal))), dtype=np.uint8)
    lit[0, :len(literal)] = np.frombuffer(literal, dtype=np.uint8)
    lit_len = np.array([len(literal)], dtype=np.int32)
    # the reference broadcasts the literal; the port reads one row
    want = np.asarray(jsk.compare(
        jnp.asarray(bm), jnp.asarray(ln),
        jnp.broadcast_to(jnp.asarray(lit), (N, lit.shape[1])),
        jnp.broadcast_to(jnp.asarray(lit_len), (N,))))
    got = psk.compare(torch.from_numpy(bm), torch.from_numpy(ln),
                      torch.from_numpy(lit), torch.from_numpy(lit_len))
    np.testing.assert_array_equal(got.numpy(), want)
    got_eq = psk.equals(torch.from_numpy(lit).expand(N, -1),
                        torch.from_numpy(lit_len).expand(N),
                        torch.from_numpy(bm), torch.from_numpy(ln))
    want_eq = np.asarray(jsk.equals(
        jnp.broadcast_to(jnp.asarray(lit), (N, lit.shape[1])),
        jnp.broadcast_to(jnp.asarray(lit_len), (N,)),
        jnp.asarray(bm), jnp.asarray(ln)))
    np.testing.assert_array_equal(got_eq.numpy(), want_eq)


def test_equal_prefix_orders_by_length():
    rbm = np.frombuffer(b"abcde", dtype=np.uint8).reshape(1, 5)
    lbm = np.repeat(rbm, 3, 0)
    lbm[0, 3:] = 0
    _eq, cmp = _check(lbm, np.array([3, 5, 4], np.int32),
                      np.repeat(rbm, 3, 0), np.array([5, 5, 3], np.int32))
    assert cmp.tolist() == [-1, 0, 1]


_S = {"s": ["BUILDING", "BUILD", "", None, "é", "AUTOMOBILE", "BUILDINGS",
            "zz"],
      "t": ["BUILDING", "BUILDING", "a", "x", None, "AUTO", "BUILDING", "z"]}


@pytest.mark.parametrize("op", ["==", "<", "<=", ">", ">="])
@pytest.mark.parametrize("rhs", ["literal", "column"])
def test_string_predicates_match_reference(op, rhs):
    fields = [("s", "string"), ("t", "string")]
    jdf = jsrt.Session().create_dataframe(
        {n: np.array(v, dtype=object) for n, v in _S.items()},
        JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in fields]),
        n_partitions=1)
    pdf = Session(device="cpu").create_dataframe(
        _S, PT.Schema([PT.Field(n, PT.from_name(t)) for n, t in fields]))

    def cond(df, f):
        left = f.col("s")
        right = f.lit("BUILDING") if rhs == "literal" else f.col("t")
        return {"==": left == right, "<": left < right, "<=": left <= right,
                ">": left > right, ">=": left >= right}[op]

    from spark_rapids_tpu import f as jf
    from spark_rapids_tpu_torch import f as pf
    want = jdf.filter(cond(jdf, jf)).collect()
    got = pdf.filter(cond(pdf, pf)).collect()
    assert got == want and len(got) > 0


# --------------------------------------------------------------------------
# K13: search
# --------------------------------------------------------------------------
SEARCH_WORDS = [b"", b"a", b"ab", b"abc", b"cab", b"babab", b"\xc3\xa9ab",
                b"special", b"xspecialx", b"requests", b"aaaaaaaaaaaa"]
NEEDLES = [b"", b"a", b"ab", b"ba", b"abc", b"\xc3\xa9", b"special",
           b"aaaaaaa", b"aaaaaaaaaaaa", b"aaaaaaaaaaaaa"]


def _search_matrix(rng, n, w):
    bm = np.zeros((n, w), dtype=np.uint8)
    ln = np.zeros(n, dtype=np.int32)
    for i, k in enumerate(rng.integers(0, len(SEARCH_WORDS), n)):
        b = SEARCH_WORDS[k][:w]
        bm[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        ln[i] = len(b)
    return bm, ln


@pytest.mark.parametrize("w", [1, 7, 12])
@pytest.mark.parametrize("fn", ["contains", "startswith", "endswith",
                                "locate_from"])
def test_search_matches_reference(fn, w):
    rng = np.random.default_rng(w)
    bm, ln = _search_matrix(rng, N, w)
    start = rng.integers(-1, w + 2, N).astype(np.int32)
    hits = 0
    for needle in NEEDLES:
        extra = (start,) if fn == "locate_from" else ()
        want = np.asarray(getattr(jsk, fn)(
            jnp.asarray(bm), jnp.asarray(ln), needle,
            *(jnp.asarray(a) for a in extra)))
        got = getattr(psk, fn)(torch.from_numpy(bm), torch.from_numpy(ln),
                               needle, *(torch.from_numpy(a) for a in extra))
        assert got.dtype == (torch.int32 if fn == "locate_from"
                             else torch.bool)
        np.testing.assert_array_equal(got.numpy(), want)
        hits += int((got.numpy() != 0).sum())
    assert hits > 0


_LIKE = {"s": ["special requests", "requests special", "", None, "abc",
               "xaby", "PROMO BRUSHED TIN", "promo", "ab", "a", "éab",
               "STANDARD PROMO"]}


@pytest.mark.parametrize("pattern", ["PROMO%", "%TIN", "%a%b%", "abc", "",
                                     "%", "%special%requests%", "a%",
                                     "%é%"])
def test_like_matches_reference(pattern):
    schema = [("s", "string")]
    jdf = jsrt.Session().create_dataframe(
        {"s": np.array(_LIKE["s"], dtype=object)},
        JT.Schema([JT.Field(n, JT.from_name(t)) for n, t in schema]),
        n_partitions=1)
    pdf = Session(device="cpu").create_dataframe(
        _LIKE, PT.Schema([PT.Field(n, PT.from_name(t)) for n, t in schema]),
        n_partitions=1)
    from spark_rapids_tpu import f as jf
    from spark_rapids_tpu_torch import f as pf
    want = jdf.select(jf.col("s").like(pattern).alias("m")).collect()
    got = pdf.select(pf.col("s").like(pattern).alias("m")).collect()
    assert got == want
    assert any(r[0] for r in got)
