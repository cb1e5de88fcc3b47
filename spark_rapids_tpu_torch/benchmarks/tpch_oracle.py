"""An independent numpy computation of the 22 TPC-H queries.

The yardstick ``chip_smoke.py`` holds the engine's rows against on the
card: each ``numpy_q<n>`` computes query ``n`` of ``benchmarks/tpch.py``
from the host tables alone (numpy filters, lookups, joins by sorted
keys, ``np.unique`` and ``np.bincount`` groups), with nothing of this
engine's planner, expressions or kernels, and returns the rows in the
query's output order (ordered queries) or in any order (``UNORDERED``,
the queries without a total order, as ``tests/test_tpch.py:27`` lists
them).  Strings come back as ``str``, dates as day numbers, counts as
``int``.  ``numpy_q1`` and ``numpy_q6`` take lineitem's host batch, the
others the tables' dict and a dict they fill with the table sizes after
each filter and join.  ``answer(q, tables, sizes)`` calls either form.

The oracles assume what both generators give: unique primary keys
(``c_custkey``, ``o_orderkey``, ``p_partkey`` 1..n, ``s_suppkey``,
``n_nationkey``, ``r_regionkey``) and no nulls.
"""
from __future__ import annotations

import datetime as dt
from typing import Dict, List, Tuple

import numpy as np

#: queries whose output has no total order (ties in the sort keys, or
#: no sort), as ``tests/test_tpch.py:27`` lists them
UNORDERED = {2, 5, 6, 10, 11, 13, 14, 16, 17, 18, 19, 21, 22}

#: TPC-H Q18's threshold as the queries set it (``tpch.py:Q18_MIN_QTY``)
Q18_MIN_QTY = 150.0


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def _days(y, m, d):
    return (dt.date(y, m, d) - dt.date(1970, 1, 1)).days


def numpy_q1(hb):
    c = {f.name: col for f, col in zip(hb.schema, hb.columns)}
    keep = c["l_shipdate"].data <= _days(1998, 9, 2)
    qty = c["l_quantity"].data[keep]
    price = c["l_extendedprice"].data[keep]
    disc = c["l_discount"].data[keep]
    tax = c["l_tax"].data[keep]
    rf = c["l_returnflag"].data[keep, 0]
    ls = c["l_linestatus"].data[keep, 0]
    codes = rf.astype(np.int64) * 256 + ls
    rows = []
    for code in np.unique(codes).tolist():
        g = codes == code
        n = int(g.sum())
        dp = price[g] * (1.0 - disc[g])
        rows.append((chr(code // 256), chr(code % 256),
                     float(np.sum(qty[g])), float(np.sum(price[g])),
                     float(np.sum(dp)), float(np.sum(dp * (1.0 + tax[g]))),
                     float(np.sum(qty[g])) / n, float(np.sum(price[g])) / n,
                     float(np.sum(disc[g])) / n, n))
    return rows


def numpy_q6(hb):
    c = {f.name: col for f, col in zip(hb.schema, hb.columns)}
    sd, disc = c["l_shipdate"].data, c["l_discount"].data
    keep = ((sd >= _days(1994, 1, 1)) & (sd < _days(1995, 1, 1))
            & (disc >= 0.05) & (disc <= 0.07) & (c["l_quantity"].data < 24.0))
    return [(float(np.sum(c["l_extendedprice"].data[keep] * disc[keep])),)]


def _cols(batches):
    return {f.name: c for b in batches.values()
            for f, c in zip(b.schema, b.columns)}


def _strings_equal(c, literal: bytes):
    w = c.data.shape[1]
    lit = np.zeros(w, dtype=np.uint8)
    lit[:len(literal)] = np.frombuffer(literal, dtype=np.uint8)
    return (c.lengths == len(literal)) & (c.data == lit).all(axis=1)


def _semi(keys, build_keys):
    """Mask of ``keys`` present in ``build_keys`` (sorted-key probe)."""
    b = np.unique(build_keys)
    pos = np.clip(np.searchsorted(b, keys), 0, max(len(b) - 1, 0))
    return (b[pos] == keys) if len(b) else np.zeros(len(keys), bool)


def numpy_q3(tables, sizes):
    c = _cols(tables)
    cust = c["c_custkey"].data[_strings_equal(c["c_mktsegment"],
                                              b"BUILDING")]
    o_keep = c["o_orderdate"].data < _days(1995, 3, 15)
    okey = c["o_orderkey"].data[o_keep]
    odate = c["o_orderdate"].data[o_keep]
    oship = c["o_shippriority"].data[o_keep]
    j1 = _semi(c["o_custkey"].data[o_keep], cust)  # c_custkey is unique
    okey, odate, oship = okey[j1], odate[j1], oship[j1]
    l_keep = c["l_shipdate"].data > _days(1995, 3, 15)
    lkey = c["l_orderkey"].data[l_keep]
    rev = (c["l_extendedprice"].data * (1.0 - c["l_discount"].data))[l_keep]
    order = np.argsort(okey)
    okey, odate, oship = okey[order], odate[order], oship[order]
    j2 = _semi(lkey, okey)                          # o_orderkey is unique
    at = np.searchsorted(okey, lkey[j2])
    groups, inv = np.unique(at, return_inverse=True)
    sums = np.bincount(inv, weights=rev[j2])
    top = np.lexsort((odate[groups], -sums))[:10]
    sizes.update({"customer BUILDING": len(cust),
                  "orders < 1995-03-15": int(o_keep.sum()),
                  "join 1 (customer x orders)": len(okey),
                  "lineitem > 1995-03-15": int(l_keep.sum()),
                  "join 2 (x lineitem)": int(j2.sum()),
                  "groups": len(groups)})
    return [(int(okey[groups[i]]), float(sums[i]), int(odate[groups[i]]),
             int(oship[groups[i]])) for i in top]


def numpy_q4(tables, sizes):
    c = _cols(tables)
    od = c["o_orderdate"].data
    o_keep = (od >= _days(1993, 7, 1)) & (od < _days(1993, 10, 1))
    late = c["l_commitdate"].data < c["l_receiptdate"].data
    semi = _semi(c["o_orderkey"].data[o_keep],
                 c["l_orderkey"].data[late])
    pr = c["o_orderpriority"]
    bm, ln = pr.data[o_keep][semi], pr.lengths[o_keep][semi]
    names = np.array([bytes(r[:n]).decode() for r, n in zip(bm, ln)])
    keys, counts = np.unique(names, return_counts=True)
    sizes.update({"orders in 1993 Q3": int(o_keep.sum()),
                  "lineitem late": int(late.sum()),
                  "semi join": int(semi.sum()), "groups": len(keys)})
    return [(str(k), int(n)) for k, n in zip(keys, counts)]


def _text(c):
    """A string column's rows as numpy fixed-width bytes (trailing NUL
    bytes dropped, as past the length every byte is 0)."""
    return np.ascontiguousarray(c.data).view(f"S{c.data.shape[1]}")[:, 0]


def numpy_q12(tables, sizes):
    c = _cols(tables)
    mode = _text(c["l_shipmode"])
    sd, cd, rd = (c[n].data for n in ("l_shipdate", "l_commitdate",
                                      "l_receiptdate"))
    keep = (np.isin(mode, [b"MAIL", b"SHIP"]) & (cd < rd) & (sd < cd)
            & (rd >= _days(1994, 1, 1)) & (rd < _days(1995, 1, 1)))
    okey = c["o_orderkey"].data
    order = np.argsort(okey)
    lkey = c["l_orderkey"].data[keep]
    at = order[np.searchsorted(okey, lkey, sorter=order)]
    require(bool((okey[at] == lkey).all()), "Q12 numpy: an order is missing")
    high = np.isin(_text(c["o_orderpriority"])[at], [b"1-URGENT", b"2-HIGH"])
    sizes.update({"lineitem filtered": int(keep.sum()),
                  "join": len(lkey)})
    rows = []
    for m in sorted(set(mode[keep].tolist())):
        g = mode[keep] == m
        rows.append((m.decode(), int((high & g).sum()),
                     int((~high & g).sum())))
    return rows


def numpy_q13(tables, sizes):
    c = _cols(tables)
    comment = _text(c["o_comment"])
    special = (np.char.find(comment, b"special") >= 0) & \
        (np.char.find(comment, b"requests") >= 0)
    custs = c["c_custkey"].data
    per_cust = np.bincount(c["o_custkey"].data[~special],
                           minlength=int(custs.max()) + 1)[custs]
    counts, dist = np.unique(per_cust, return_counts=True)
    sizes.update({"orders kept": int((~special).sum()),
                  "customers": len(custs), "groups": len(counts)})
    order = np.lexsort((-counts, -dist))
    return [(int(counts[i]), int(dist[i])) for i in order]


def numpy_q14(tables, sizes):
    c = _cols(tables)
    sd = c["l_shipdate"].data
    keep = (sd >= _days(1995, 9, 1)) & (sd < _days(1995, 10, 1))
    pkey = c["p_partkey"].data
    require(bool((pkey == np.arange(1, len(pkey) + 1)).all()),
            "Q14 numpy: part keys are not 1..n")
    promo = np.char.startswith(_text(c["p_type"]), b"PROMO")
    rev = (c["l_extendedprice"].data * (1.0 - c["l_discount"].data))[keep]
    is_promo = promo[c["l_partkey"].data[keep] - 1]
    sizes.update({"lineitem in 1995-09": int(keep.sum()),
                  "promo lines": int(is_promo.sum())})
    return [(100.0 * float(np.sum(np.where(is_promo, rev, 0.0)))
             / float(np.sum(rev)),)]


# --------------------------------------------------------------------------
# Q2, Q5, Q7–Q11 and Q15–Q22
# --------------------------------------------------------------------------
def _str(c) -> np.ndarray:
    """A string column as numpy fixed-width bytes (``_text``), which
    compare and sort as UTF-8 binary, as the engine's strings do."""
    return _text(c)


def _dec(b: bytes) -> str:
    return b.decode("utf-8")


def _index(keys: np.ndarray, unique_keys: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """For each of ``keys``, its row in ``unique_keys`` and whether it is
    there (a lookup on a primary key)."""
    if len(unique_keys) == 0:
        return np.zeros(len(keys), np.int64), np.zeros(len(keys), bool)
    order = np.argsort(unique_keys, kind="stable")
    # search a sorted copy, not through the permutation (``sorter=``):
    # one random read a step of the search instead of two
    pos = np.clip(np.searchsorted(unique_keys[order], keys), 0,
                  len(unique_keys) - 1)
    at = order[pos]
    return at, unique_keys[at] == keys


def _sorted_unique(a: np.ndarray, return_counts: bool = False):
    """``np.unique(a)`` (and the counts) by one sort: NumPy 2.3's
    hash-table ``unique`` is slow over tens of millions of distinct
    values, such as SF10's 60,000,000 (order, supplier) pairs."""
    s = np.sort(a)
    first = np.ones(len(s), dtype=bool)
    first[1:] = s[1:] != s[:-1]
    if not return_counts:
        return s[first]
    starts = np.flatnonzero(first)
    return s[first], np.diff(np.append(starts, len(s)))


def _codes(*cols) -> np.ndarray:
    """One int64 code a row for a tuple of columns (equal tuples, equal
    codes)."""
    code = np.zeros(len(cols[0]), dtype=np.int64)
    for c in cols:
        u, inv = np.unique(c, return_inverse=True)
        code = code * len(u) + inv.reshape(-1)
    return code


def _pairs(lcols: List[np.ndarray], rcols: List[np.ndarray]
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Every (left row, right row) whose keys are equal: an inner join."""
    n = len(lcols[0])
    k = _codes(*[np.concatenate([l, r]) for l, r in zip(lcols, rcols)])
    lk, rk = k[:n], k[n:]
    order = np.argsort(rk, kind="stable")
    rs = rk[order]
    lo = np.searchsorted(rs, lk, "left")
    cnt = np.searchsorted(rs, lk, "right") - lo
    li = np.repeat(np.arange(n), cnt)
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    ri = order[np.repeat(lo, cnt) + np.arange(int(cnt.sum())) - first]
    return li, ri


def _year(days: np.ndarray) -> np.ndarray:
    """Calendar years of day numbers, through numpy's datetime64."""
    return days.astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970


def _group_sum(keys: List[np.ndarray], values: np.ndarray):
    """(first row of each group, sum of ``values`` a group), groups in
    the order of their key codes."""
    code = _codes(*keys)
    groups, first, inv = np.unique(code, return_index=True,
                                   return_inverse=True)
    return first, np.bincount(inv.reshape(-1), weights=values,
                              minlength=len(groups))


def _nation_names(c) -> Dict[int, str]:
    return {int(k): _dec(n) for k, n in zip(c["n_nationkey"].data,
                                             _str(c["n_name"]))}


def _revenue(c, rows=slice(None)) -> np.ndarray:
    return (c["l_extendedprice"].data * (1.0 - c["l_discount"].data))[rows]


def numpy_q2(tables, sizes):
    c = _cols(tables)
    eu_regions = c["r_regionkey"].data[_str(c["r_name"]) == b"EUROPE"]
    eu_nations = c["n_nationkey"].data[np.isin(c["n_regionkey"].data,
                                               eu_regions)]
    names = _nation_names(c)
    s_eu = np.isin(c["s_nationkey"].data, eu_nations)
    p_ok = (c["p_size"].data == 15) & \
        np.char.endswith(_str(c["p_type"]), b"BRASS")
    si, s_found = _index(c["ps_suppkey"].data, c["s_suppkey"].data)
    pi, p_found = _index(c["ps_partkey"].data, c["p_partkey"].data)
    keep = s_found & s_eu[si] & p_found & p_ok[pi]
    rows = np.flatnonzero(keep)
    cost = c["ps_supplycost"].data[rows]
    part = c["ps_partkey"].data[rows]
    upart, inv = np.unique(part, return_inverse=True)
    mins = np.full(len(upart), np.inf)
    np.minimum.at(mins, inv.reshape(-1), cost)
    best = rows[cost == mins[inv.reshape(-1)]]
    s, p = si[best], pi[best]
    acct = c["s_acctbal"].data[s]
    s_name = _str(c["s_name"])[s]
    n_name = np.array([names[int(k)] for k in c["s_nationkey"].data[s]],
                      dtype=object).astype(bytes) if len(s) else \
        np.zeros(0, "S1")
    pkey = c["p_partkey"].data[p]
    order = np.lexsort((pkey, s_name, n_name, -acct))[:100]
    sizes.update({"part size 15 %BRASS": int(p_ok.sum()),
                  "suppliers in EUROPE": int(s_eu.sum()),
                  "part x partsupp x supplier": len(rows),
                  "at the minimum cost": len(best)})
    mfgr, addr = _str(c["p_mfgr"]), _str(c["s_address"])
    phone, comment = _str(c["s_phone"]), _str(c["s_comment"])
    return [(float(acct[i]), _dec(s_name[i]), _dec(n_name[i]),
             int(pkey[i]), _dec(mfgr[p[i]]), _dec(addr[s[i]]),
             _dec(phone[s[i]]), _dec(comment[s[i]])) for i in order]


def numpy_q5(tables, sizes):
    c = _cols(tables)
    asia = c["r_regionkey"].data[_str(c["r_name"]) == b"ASIA"]
    nations = c["n_nationkey"].data[np.isin(c["n_regionkey"].data, asia)]
    names = _nation_names(c)
    od = c["o_orderdate"].data
    o_keep = (od >= _days(1994, 1, 1)) & (od < _days(1995, 1, 1))
    oi, o_found = _index(c["l_orderkey"].data, c["o_orderkey"].data)
    line = o_found & o_keep[oi]
    ci, c_found = _index(c["o_custkey"].data[oi], c["c_custkey"].data)
    cnation = c["c_nationkey"].data[ci]
    line &= c_found & np.isin(cnation, nations)
    si, s_found = _index(c["l_suppkey"].data, c["s_suppkey"].data)
    line &= s_found & (c["s_nationkey"].data[si] == cnation)
    first, sums = _group_sum([cnation[line]], _revenue(c, line))
    keys = cnation[line][first]
    sizes.update({"orders in 1994": int(o_keep.sum()),
                  "lines, customer and supplier in one ASIA nation":
                  int(line.sum()), "groups": len(keys)})
    order = np.argsort(-sums, kind="stable")
    return [(names[int(keys[i])], float(sums[i])) for i in order]


def numpy_q7(tables, sizes):
    c = _cols(tables)
    names = _nation_names(c)
    sd = c["l_shipdate"].data
    line = (sd >= _days(1995, 1, 1)) & (sd <= _days(1996, 12, 31))
    si, s_found = _index(c["l_suppkey"].data, c["s_suppkey"].data)
    oi, o_found = _index(c["l_orderkey"].data, c["o_orderkey"].data)
    ci, c_found = _index(c["o_custkey"].data[oi], c["c_custkey"].data)
    line &= s_found & o_found & c_found
    snat = c["s_nationkey"].data[si]
    cnat = c["c_nationkey"].data[ci]
    fr = [k for k, n in names.items() if n == "FRANCE"]
    de = [k for k, n in names.items() if n == "GERMANY"]
    line &= (np.isin(snat, fr) & np.isin(cnat, de)) | \
        (np.isin(snat, de) & np.isin(cnat, fr))
    year = _year(sd)
    first, sums = _group_sum([snat[line], cnat[line], year[line]],
                             _revenue(c, line))
    rows = [(names[int(snat[line][i])], names[int(cnat[line][i])],
             int(year[line][i]), float(s)) for i, s in zip(first, sums)]
    sizes.update({"lines FRANCE <-> GERMANY 1995-96": int(line.sum()),
                  "groups": len(rows)})
    return sorted(rows, key=lambda r: (r[0].encode(), r[1].encode(), r[2]))


def numpy_q8(tables, sizes):
    c = _cols(tables)
    names = _nation_names(c)
    america = c["r_regionkey"].data[_str(c["r_name"]) == b"AMERICA"]
    nations = c["n_nationkey"].data[np.isin(c["n_regionkey"].data,
                                            america)]
    steel = c["p_partkey"].data[_str(c["p_type"]) ==
                                b"ECONOMY ANODIZED STEEL"]
    line = np.isin(c["l_partkey"].data, steel)
    si, s_found = _index(c["l_suppkey"].data, c["s_suppkey"].data)
    oi, o_found = _index(c["l_orderkey"].data, c["o_orderkey"].data)
    od = c["o_orderdate"].data[oi]
    ci, c_found = _index(c["o_custkey"].data[oi], c["c_custkey"].data)
    line &= s_found & o_found & c_found & (od >= _days(1995, 1, 1)) & \
        (od <= _days(1996, 12, 31)) & \
        np.isin(c["c_nationkey"].data[ci], nations)
    brazil = [k for k, n in names.items() if n == "BRAZIL"]
    vol = _revenue(c, line)
    is_br = np.isin(c["s_nationkey"].data[si][line], brazil)
    year = _year(od[line])
    first, den = _group_sum([year], vol)
    _f, num = _group_sum([year], np.where(is_br, vol, 0.0))
    sizes.update({"ECONOMY ANODIZED STEEL parts": len(steel),
                  "lines in AMERICA 1995-96": int(line.sum())})
    rows = [(int(year[i]), float(n) / float(d))
            for i, n, d in zip(first, num, den)]
    return sorted(rows)


def numpy_q9(tables, sizes):
    c = _cols(tables)
    names = _nation_names(c)
    green = c["p_partkey"].data[np.char.find(_str(c["p_name"]),
                                             b"green") >= 0]
    lines = np.flatnonzero(np.isin(c["l_partkey"].data, green))
    li, pi = _pairs([c["l_partkey"].data[lines],
                     c["l_suppkey"].data[lines]],
                    [c["ps_partkey"].data, c["ps_suppkey"].data])
    rows = lines[li]
    si, s_found = _index(c["l_suppkey"].data[rows], c["s_suppkey"].data)
    oi, o_found = _index(c["l_orderkey"].data[rows], c["o_orderkey"].data)
    ok = s_found & o_found
    rows, si, oi, pi = rows[ok], si[ok], oi[ok], pi[ok]
    amount = _revenue(c, rows) - c["ps_supplycost"].data[pi] * \
        c["l_quantity"].data[rows]
    nat = c["s_nationkey"].data[si]
    year = _year(c["o_orderdate"].data[oi])
    first, sums = _group_sum([nat, year], amount)
    sizes.update({"green parts": len(green), "lines joined": len(rows),
                  "groups": len(first)})
    out = [(names[int(nat[i])], int(year[i]), float(s))
           for i, s in zip(first, sums)]
    return sorted(out, key=lambda r: (r[0].encode(), -r[1]))


def numpy_q10(tables, sizes):
    c = _cols(tables)
    names = _nation_names(c)
    od = c["o_orderdate"].data
    o_keep = (od >= _days(1993, 10, 1)) & (od < _days(1994, 1, 1))
    oi, o_found = _index(c["l_orderkey"].data, c["o_orderkey"].data)
    line = o_found & o_keep[oi] & (_str(c["l_returnflag"]) == b"R")
    ci, c_found = _index(c["o_custkey"].data[oi], c["c_custkey"].data)
    line &= c_found
    cust = ci[line]
    first, sums = _group_sum([cust], _revenue(c, line))
    custs = cust[first]
    order = np.argsort(-sums, kind="stable")[:20]
    sizes.update({"orders in 1993 Q4": int(o_keep.sum()),
                  "returned lines joined": int(line.sum()),
                  "customers": len(custs)})
    name, addr = _str(c["c_name"]), _str(c["c_address"])
    phone, comment = _str(c["c_phone"]), _str(c["c_comment"])
    return [(int(c["c_custkey"].data[k]), _dec(name[k]), float(sums[i]),
             float(c["c_acctbal"].data[k]),
             names[int(c["c_nationkey"].data[k])], _dec(addr[k]),
             _dec(phone[k]), _dec(comment[k]))
            for i, k in ((i, custs[i]) for i in order)]


def numpy_q11(tables, sizes):
    c = _cols(tables)
    names = _nation_names(c)
    de = [k for k, n in names.items() if n == "GERMANY"]
    si, s_found = _index(c["ps_suppkey"].data, c["s_suppkey"].data)
    rows = np.flatnonzero(s_found & np.isin(c["s_nationkey"].data[si], de))
    value = c["ps_supplycost"].data[rows] * \
        c["ps_availqty"].data[rows].astype(np.float64)
    part = c["ps_partkey"].data[rows]
    first, sums = _group_sum([part], value)
    total = float(np.sum(value))
    keep = sums > total * 0.0001
    sizes.update({"partsupp of GERMANY": len(rows),
                  "parts": len(first), "above the threshold":
                  int(keep.sum())})
    order = np.argsort(-sums, kind="stable")
    return [(int(part[first[i]]), float(sums[i])) for i in order
            if keep[i]]


def numpy_q15(tables, sizes):
    c = _cols(tables)
    sd = c["l_shipdate"].data
    line = (sd >= _days(1996, 1, 1)) & (sd < _days(1996, 4, 1))
    supp = c["l_suppkey"].data[line]
    first, sums = _group_sum([supp], _revenue(c, line))
    top = sums == sums.max()
    keys = supp[first][top]
    si, found = _index(keys, c["s_suppkey"].data)
    sizes.update({"lines in 1996 Q1": int(line.sum()),
                  "suppliers": len(first), "at the maximum": int(top.sum())})
    name, addr, phone = (_str(c[n]) for n in ("s_name", "s_address",
                                               "s_phone"))
    rows = [(int(k), _dec(name[s]), _dec(addr[s]), _dec(phone[s]), float(r))
            for k, s, f, r in zip(keys, si, found, sums[top]) if f]
    return sorted(rows)


def numpy_q16(tables, sizes):
    c = _cols(tables)
    brand, ptype = _str(c["p_brand"]), _str(c["p_type"])
    p_ok = (brand != b"Brand#45") & \
        ~np.char.startswith(ptype, b"MEDIUM POLISHED") & \
        np.isin(c["p_size"].data, [49, 14, 23, 45, 19, 3, 36, 9])
    bad = c["s_suppkey"].data[np.char.find(_str(c["s_comment"]),
                                           b"Customer Complaints") >= 0]
    pi, p_found = _index(c["ps_partkey"].data, c["p_partkey"].data)
    rows = np.flatnonzero(~np.isin(c["ps_suppkey"].data, bad) & p_found
                          & p_ok[pi])
    p = pi[rows]
    supp = c["ps_suppkey"].data[rows]
    size = c["p_size"].data[p]
    distinct = np.unique(np.stack([_codes(brand[p], ptype[p], size),
                                   supp]), axis=1)
    first, cnt = _group_sum([distinct[0]], np.ones(distinct.shape[1]))
    code = _codes(brand[p], ptype[p], size)
    at = {int(k): i for i, k in enumerate(code)}
    out = []
    for g, n in zip(distinct[0][first], cnt):
        i = p[at[int(g)]]
        out.append((_dec(brand[i]), _dec(ptype[i]), int(c["p_size"].data[i]),
                    int(n)))
    sizes.update({"parts kept": int(p_ok.sum()), "suppliers with "
                  "complaints": len(bad), "partsupp joined": len(rows),
                  "groups": len(out)})
    return sorted(out, key=lambda r: (-r[3], r[0].encode(), r[1].encode(),
                                      r[2]))


def numpy_q17(tables, sizes):
    c = _cols(tables)
    p_ok = (_str(c["p_brand"]) == b"Brand#23") & \
        (_str(c["p_container"]) == b"MED BOX")
    parts = c["p_partkey"].data[p_ok]
    lp, qty = c["l_partkey"].data, c["l_quantity"].data
    upart, inv = np.unique(lp, return_inverse=True)
    inv = inv.reshape(-1)
    avg = np.bincount(inv, weights=qty) / np.bincount(inv)
    line = np.isin(lp, parts) & (qty < 0.2 * avg[inv])
    sizes.update({"parts Brand#23 MED BOX": len(parts),
                  "lines of them": int(np.isin(lp, parts).sum()),
                  "small lines": int(line.sum())})
    if not line.any():
        return [(None,)]
    return [(float(np.sum(c["l_extendedprice"].data[line])) / 7.0,)]


def numpy_q18(tables, sizes):
    c = _cols(tables)
    lk, qty = c["l_orderkey"].data, c["l_quantity"].data
    first, sums = _group_sum([lk], qty)
    big = lk[first][sums > Q18_MIN_QTY]
    orders = np.flatnonzero(np.isin(c["o_orderkey"].data, big))
    ci, c_found = _index(c["o_custkey"].data[orders], c["c_custkey"].data)
    orders, ci = orders[c_found], ci[c_found]
    per_order = dict(zip(lk[first].tolist(), sums.tolist()))
    price = c["o_totalprice"].data[orders]
    odate = c["o_orderdate"].data[orders]
    order = np.lexsort((odate, -price))[:100]
    sizes.update({"orders above the quantity": len(big),
                  "joined with customer": len(orders)})
    name = _str(c["c_name"])
    return [(_dec(name[ci[i]]), int(c["c_custkey"].data[ci[i]]),
             int(c["o_orderkey"].data[orders[i]]), int(odate[i]),
             float(price[i]),
             float(per_order[int(c["o_orderkey"].data[orders[i]])]))
            for i in order]


def numpy_q19(tables, sizes):
    c = _cols(tables)
    mode = _str(c["l_shipmode"])
    line = np.isin(mode, [b"AIR", b"REG AIR"]) & \
        (_str(c["l_shipinstruct"]) == b"DELIVER IN PERSON")
    pi, p_found = _index(c["l_partkey"].data, c["p_partkey"].data)
    line &= p_found
    brand, cont = _str(c["p_brand"])[pi], _str(c["p_container"])[pi]
    size, qty = c["p_size"].data[pi], c["l_quantity"].data

    def branch(b, conts, lo, hi, top):
        return (brand == b) & np.isin(cont, conts) & (qty >= lo) & \
            (qty <= hi) & (size >= 1) & (size <= top)

    hit = line & (
        branch(b"Brand#12", [b"SM CASE", b"SM BOX", b"SM PACK", b"SM PKG"],
               1.0, 11.0, 5)
        | branch(b"Brand#23", [b"MED BAG", b"MED BOX", b"MED PKG",
                               b"MED PACK"], 10.0, 20.0, 10)
        | branch(b"Brand#34", [b"LG CASE", b"LG BOX", b"LG PACK",
                               b"LG PKG"], 20.0, 30.0, 15))
    sizes.update({"AIR lines delivered in person": int(line.sum()),
                  "lines in a branch": int(hit.sum())})
    if not hit.any():
        return [(None,)]
    return [(float(np.sum(_revenue(c, hit))),)]


def numpy_q20(tables, sizes):
    c = _cols(tables)
    names = _nation_names(c)
    forest = c["p_partkey"].data[np.char.startswith(_str(c["p_name"]),
                                                    b"forest")]
    sd = c["l_shipdate"].data
    line = (sd >= _days(1994, 1, 1)) & (sd < _days(1995, 1, 1))
    lp, ls = c["l_partkey"].data[line], c["l_suppkey"].data[line]
    first, qty = _group_sum([lp, ls], c["l_quantity"].data[line])
    ps = np.flatnonzero(np.isin(c["ps_partkey"].data, forest))
    pi, gi = _pairs([c["ps_partkey"].data[ps], c["ps_suppkey"].data[ps]],
                    [lp[first], ls[first]])
    rows = ps[pi]
    ok = c["ps_availqty"].data[rows] > 0.5 * qty[gi]
    supps = np.unique(c["ps_suppkey"].data[rows[ok]])
    canada = [k for k, n in names.items() if n == "CANADA"]
    s_ok = np.isin(c["s_suppkey"].data, supps) & \
        np.isin(c["s_nationkey"].data, canada)
    sizes.update({"forest parts": len(forest), "partsupp joined with "
                  "1994's shipments": len(rows), "with excess stock":
                  int(ok.sum()), "suppliers in CANADA": int(s_ok.sum())})
    name, addr = _str(c["s_name"])[s_ok], _str(c["s_address"])[s_ok]
    order = np.argsort(name, kind="stable")
    return [(_dec(name[i]), _dec(addr[i])) for i in order]


def numpy_q21(tables, sizes):
    c = _cols(tables)
    names = _nation_names(c)
    ok, sk = c["l_orderkey"].data, c["l_suppkey"].data
    late = c["l_receiptdate"].data > c["l_commitdate"].data

    span = int(sk.max()) + 1 if len(sk) else 1

    def distinct_suppliers(rows):
        pairs = _sorted_unique(ok[rows] * span + sk[rows])
        return _sorted_unique(pairs // span, return_counts=True)

    k_all, n_all = distinct_suppliers(np.ones(len(ok), bool))
    k_late, n_late = distinct_suppliers(late)
    f_orders = c["o_orderkey"].data[_str(c["o_orderstatus"]) == b"F"]
    saudi = [k for k, n in names.items() if n == "SAUDI ARABIA"]
    si, s_found = _index(sk, c["s_suppkey"].data)
    line = late & np.isin(ok, f_orders) & s_found & \
        np.isin(c["s_nationkey"].data[si], saudi)
    ai, a_found = _index(ok, k_all)
    li, l_found = _index(ok, k_late)
    line &= a_found & (n_all[ai] > 1) & l_found & (n_late[li] == 1)
    name = _str(c["s_name"])[si[line]]
    keys, counts = np.unique(name, return_counts=True)
    sizes.update({"late lines": int(late.sum()), "late lines of SAUDI "
                  "suppliers, sole late supplier": int(line.sum()),
                  "suppliers": len(keys)})
    order = np.lexsort((keys, -counts))[:100]
    return [(_dec(keys[i]), int(counts[i])) for i in order]


def numpy_q22(tables, sizes):
    c = _cols(tables)
    codes = np.array([b"13", b"31", b"23", b"29", b"30", b"18", b"17"])
    phone = c["c_phone"]
    cc = np.ascontiguousarray(phone.data[:, :2]).view("S2")[:, 0]
    cc = np.where(phone.lengths >= 2, cc, b"")
    bal = c["c_acctbal"].data
    cust = np.isin(cc, codes)
    pos = cust & (bal > 0.0)
    avg = float(np.sum(bal[pos])) / int(pos.sum())
    keep = cust & (bal > avg) & ~np.isin(c["c_custkey"].data,
                                         c["o_custkey"].data)
    keys, inv = np.unique(cc[keep], return_inverse=True)
    inv = inv.reshape(-1)
    counts = np.bincount(inv, minlength=len(keys))
    sums = np.bincount(inv, weights=bal[keep], minlength=len(keys))
    sizes.update({"customers in the seven codes": int(cust.sum()),
                  "above the average, no orders": int(keep.sum())})
    return [(_dec(k), int(n), float(s)) for k, n, s in zip(keys, counts,
                                                           sums)]


ORACLES = {1: numpy_q1, 2: numpy_q2, 3: numpy_q3, 4: numpy_q4, 5: numpy_q5,
           6: numpy_q6, 7: numpy_q7, 8: numpy_q8, 9: numpy_q9,
           10: numpy_q10, 11: numpy_q11, 12: numpy_q12, 13: numpy_q13,
           14: numpy_q14, 15: numpy_q15, 16: numpy_q16, 17: numpy_q17,
           18: numpy_q18, 19: numpy_q19, 20: numpy_q20, 21: numpy_q21,
           22: numpy_q22}


def answer(q: int, tables, sizes) -> list:
    """Query ``q``'s rows over ``tables`` (name -> host batch)."""
    if q in (1, 6):
        return ORACLES[q](tables["lineitem"])
    return ORACLES[q](tables, sizes)


def check_rows(got, want, what, ordered=True):
    """Raise unless ``got`` equals ``want``: floats to rel 1e-9, the rest
    exactly; in order, or after sorting both by their non-float fields
    when not ``ordered``."""
    require(len(got) == len(want), f"{what}: {len(got)} rows, want "
            f"{len(want)}")
    if not ordered:
        def key(r):
            return tuple(repr(v) for v in r if not isinstance(v, float))

        got, want = sorted(got, key=key), sorted(want, key=key)
    for g, w in zip(got, want):
        require(len(g) == len(w), f"{what}: row width")
        for a, b in zip(g, w):
            if isinstance(b, float):
                require(isinstance(a, float) and abs(a - b) <= 1e-9 * abs(b),
                        f"{what}: {a!r} vs numpy {b!r}")
            else:
                require(a == b, f"{what}: {a!r} vs numpy {b!r}")
