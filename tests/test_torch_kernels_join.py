"""Plain versions of K5 (group ids + probe), K6 (emit counts + pair
expansion) and K7 (null-side gather) in spark_rapids_tpu_torch, held
against the JAX package's ``ops/kernels/join.py`` on the same numpy
inputs, for every join type.  Exact: ``gl``, ``gr``, ``order_r``, ``lo``,
``cnt``, ``has_r``, the emit counts and total, ``lidx``, ``ridx``,
``slot_valid`` and every gathered column.

Keys: int64, int32, DATE32, float64 with NaN and ±0.0, strings with
shared prefixes and bytes >= 0x80 (the two sides' matrices of different
widths), and a two-key join; every case has null keys on both sides,
padding rows, and keys drawn from a small domain so that matches are
many-to-many.  Two more cases leave one side without a logical row."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.data.column import DeviceColumn as JCol
from spark_rapids_tpu.ops.kernels import join as jj
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.data.column import DeviceColumn as PCol
from spark_rapids_tpu_torch.data.column import bucket_rows
from spark_rapids_tpu_torch.ops.kernels import join as pj

NL, NL_REAL = 64, 53
NR, NR_REAL = 128, 101
HOWS = ["inner", "left", "right", "full", "semi", "anti"]
STRINGS = ["", "a", "ab", "abc", "abd", "abcdefgh", "abcdefghij", "é",
           "éa", "zz"]


def _strings(rng, n, choices):
    raw = [s.encode() for s in rng.choice(choices, n)]
    w = max(1, max(len(b) for b in raw))
    bm = np.zeros((n, w), dtype=np.uint8)
    for i, b in enumerate(raw):
        bm[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    return bm, np.array([len(b) for b in raw], dtype=np.int32)


def _key(kind, rng, n, side):
    """(type name, data, lengths) of one key column of one side."""
    if kind == "int64":
        return "bigint", rng.integers(-4, 12, n).astype(np.int64), None
    if kind == "int32":
        return "int", rng.integers(0, 9, n).astype(np.int32), None
    if kind == "date":
        return "date", rng.integers(9000, 9012, n).astype(np.int32), None
    if kind == "double":
        return "double", rng.choice(
            [0.0, -0.0, np.nan, 1.5, -2.25, np.inf, 7.0], n), None
    # the right side draws from fewer strings, so its matrix is narrower
    bm, ln = _strings(rng, n, STRINGS if side == "l" else STRINGS[:5])
    return "string", bm, ln


KINDS = {"int64": ["int64"], "int32": ["int32"], "date": ["date"],
         "double": ["double"], "string": ["string"],
         "two_keys": ["int32", "string"], "empty_left": ["int64"],
         "empty_right": ["int64"]}


def _side(kinds, rng, n, n_real, side, empty):
    """Key columns and payload columns (keys + one more) of one side, for
    both packages, and its row mask."""
    specs = [_key(k, rng, n, side) for k in kinds]
    specs.append(("double", np.round(rng.uniform(-9, 9, n), 2), None)
                 if side == "l" else ("string",) + _strings(rng, n, STRINGS))
    jcols, pcols = [], []
    for tname, data, ln in specs:
        valid = rng.random(n) > 0.15
        jcols.append(JCol(JT.from_name(tname), jnp.asarray(data),
                          jnp.asarray(valid),
                          None if ln is None else jnp.asarray(ln)))
        pcols.append(PCol(PT.from_name(tname), torch.from_numpy(data),
                          torch.from_numpy(valid),
                          None if ln is None else torch.from_numpy(ln)))
    rm = np.arange(n) < (0 if empty else n_real)
    k = len(kinds)
    return (jcols[:k], pcols[:k], jcols, pcols, jnp.asarray(rm),
            torch.from_numpy(rm))


@functools.lru_cache(maxsize=None)
def _case(kind):
    rng = np.random.default_rng(sorted(KINDS).index(kind) + 11)
    left = _side(KINDS[kind], rng, NL, NL_REAL, "l", kind == "empty_left")
    right = _side(KINDS[kind], rng, NR, NR_REAL, "r", kind == "empty_right")
    want = jj.probe(left[0], right[0], left[4], right[4])
    got = pj.probe(left[1], right[1], left[5], right[5])
    return left, right, want, got


def _eq(got: torch.Tensor, want, what):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_probe_matches_reference(kind):
    _l, _r, want, got = _case(kind)
    for name in pj.Probe._fields:
        _eq(getattr(got, name), getattr(want, name), name)
    if kind not in ("empty_left", "empty_right"):
        assert int(got.cnt.max()) > 1  # many-to-many
    gl, gr = pj.group_ids(_l[1], _r[1], _l[5], _r[5])
    assert torch.equal(gl, got.gl) and torch.equal(gr, got.gr)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_expand_and_gather_match_reference(kind, how):
    left, right, jp, pp = _case(kind)
    emit, r_extra, total = jj.emit_counts(jp, how, left[4], right[4])
    e = pj.emit_counts(pp, how, left[5], right[5])
    _eq(e.emit, emit, "emit")
    if how in ("right", "full"):
        _eq(e.r_extra, r_extra, "r_extra")
    else:  # the reference's mask is all False; the port builds none
        assert e.r_extra is None and not np.asarray(r_extra).any()
    assert int(e.total) == int(total)
    c_out = bucket_rows(int(total))
    want = jj.expand_pairs(jp, emit, r_extra, c_out)
    got = pj.expand_pairs(pp, e, c_out)
    for g, w, name in zip(got, want, ("lidx", "ridx", "slot_valid")):
        _eq(g, w, name)
    for side, idx_g, idx_w in ((left, got[0], want[0]),
                               (right, got[1], want[1])):
        gcols = pj.gather_side(side[3], idx_g, got[2])
        wcols = jj.gather_side(side[2], idx_w, want[2])
        for g, w in zip(gcols, wcols):
            _eq(g.data, w.data, "data")
            _eq(g.validity, w.validity, "validity")
            if w.lengths is not None:
                _eq(g.lengths, w.lengths, "lengths")


@pytest.mark.parametrize("kind", ["int64", "string"])
def test_probe_without_has_r(kind):
    """Joins other than right/full ask for no has_r; every other field
    is unchanged, and right/full refuse such a probe."""
    left, right, want, full = _case(kind)
    p = pj.probe(left[1], right[1], left[5], right[5], with_has_r=False)
    assert p.has_r is None
    for name in pj.Probe._fields[:-1]:
        assert torch.equal(getattr(p, name), getattr(full, name)), name
    for how in ("inner", "left", "semi", "anti"):
        e = pj.emit_counts(p, how, left[5], right[5])
        _eq(e.emit, jj.emit_counts(want, how, left[4], right[4])[0], how)
    for how in ("right", "full"):
        with pytest.raises(ValueError, match="has_r"):
            pj.emit_counts(p, how, left[5], right[5])


def test_unknown_join_type_is_refused():
    _l, _r, _w, pp = _case("int64")
    with pytest.raises(ValueError, match="join type"):
        pj.emit_counts(pp, "cross", _l[5], _r[5])
