"""Plain reference of TPC-H's LINEITEM rules (specification clause 4.2.3),
for the columns the benchmark's layout draws (``layouts/tpch_lineitem.py``).

Written from the specification, in numpy, independent of the layout's code:
:func:`violations` checks every rule row by row and counts the rows that
break each; :func:`stored` computes every column the benchmark stores from
the drawn columns, which a sound layout gives bit for bit.

Dates are days since 1992-01-01.  Flags: A, N, R = 0, 1, 2; statuses: F, O
= 0, 1; discounts and taxes in hundredths.  The measures hold two float32
prices, then seven int32 columns in the words' bits (order key, part key,
supplier key, line number, ship, commit and receipt dates), then the
comment's 44 bytes.
"""
from __future__ import annotations

import datetime

import numpy as np

EPOCH = datetime.date(1992, 1, 1)
CURRENT = (datetime.date(1995, 6, 17) - EPOCH).days
LAST_ORDER = (datetime.date(1998, 12, 31) - EPOCH).days - 151
A, N, R = 0, 1, 2
SYMBOLS = np.frombuffer(b"0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ,.",
                        dtype=np.uint8)
SPACE = ord(" ")


def _np(cols: dict) -> dict:
    """The columns as int64 numpy arrays, the comment as its uint8 bytes."""
    out = {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v) for k, v in cols.items()}
    return {k: v if k == "comment" else v.astype(np.int64) for k, v in out.items()}


def _first_line(order: np.ndarray) -> np.ndarray:
    """The index of each line's order's first line."""
    idx = np.arange(order.size)
    starts = np.concatenate([[True], order[1:] != order[:-1]])
    return np.maximum.accumulate(np.where(starts, idx, 0))


def _bad_comments(comment: np.ndarray) -> int:
    """Comments that are not 10–43 symbols followed by spaces to 44 bytes."""
    sym = np.isin(comment, SYMBOLS)
    length = sym.sum(axis=1)
    lead = np.arange(comment.shape[1])[None, :] < length[:, None]
    ok = (sym == lead).all(axis=1) & ((comment == SPACE) | sym).all(axis=1)
    ok &= (length >= 10) & (length <= 43) & (comment.shape[1] == 44)
    return int(np.sum(~ok))


def violations(cols: dict, scale_factor: int) -> dict:
    """Rows (or orders) that break each rule, by rule: all 0 for a sound table."""
    c = _np(cols)
    order = c["order"]
    step = np.diff(order)
    starts = np.flatnonzero(np.concatenate([[True], step != 0]))
    lines = np.diff(np.concatenate([starts, [order.size]]))
    received = c["receiptdate"] <= CURRENT
    supp = scale_factor * 10_000
    pk = c["partkey"]
    suppliers = [(pk + i * (supp // 4 + (pk - 1) // supp)) % supp + 1 for i in range(4)]
    return {
        "order_key_order": int(np.sum((step != 0) & (step != 1))) + int(order[0] != 0),
        "lines_per_order": int(np.sum((lines < 1) | (lines > 7))),
        "orderdate_range": int(np.sum((c["orderdate"] < 0) | (c["orderdate"] > LAST_ORDER))),
        "orderdate_per_order": int(np.sum(c["orderdate"][1:][step == 0]
                                          != c["orderdate"][:-1][step == 0])),
        "partkey_range": int(np.sum((c["partkey"] < 1)
                                    | (c["partkey"] > scale_factor * 200_000))),
        "quantity_range": int(np.sum((c["quantity"] < 1) | (c["quantity"] > 50))),
        "discount_range": int(np.sum((c["discount"] < 0) | (c["discount"] > 10))),
        "tax_range": int(np.sum((c["tax"] < 0) | (c["tax"] > 8))),
        "shipinstruct_range": int(np.sum((c["shipinstruct"] < 0) | (c["shipinstruct"] > 3))),
        "shipmode_range": int(np.sum((c["shipmode"] < 0) | (c["shipmode"] > 6))),
        "shipdate_lag": int(np.sum((c["shipdate"] - c["orderdate"] < 1)
                                   | (c["shipdate"] - c["orderdate"] > 121))),
        "receiptdate_lag": int(np.sum((c["receiptdate"] - c["shipdate"] < 1)
                                      | (c["receiptdate"] - c["shipdate"] > 30))),
        "returnflag": int(np.sum(np.where(received, c["returnflag"] == N,
                                          c["returnflag"] != N))),
        "commitdate_lag": int(np.sum((c["commitdate"] - c["orderdate"] < 30)
                                     | (c["commitdate"] - c["orderdate"] > 90))),
        "suppkey": int(np.sum(~np.any([c["suppkey"] == k for k in suppliers], axis=0))),
        "comment": _bad_comments(c["comment"]),
    }


def _ship_year(days: np.ndarray) -> np.ndarray:
    """The calendar year of each date, less 1992."""
    dates = np.datetime64("1992-01-01") + days.astype("timedelta64[D]")
    return dates.astype("datetime64[Y]").astype(np.int64) - (1992 - 1970)


def stored(cols: dict) -> tuple[np.ndarray, np.ndarray]:
    """``(dims [n, 8] int32, measures [n, 20] float32)``, as the benchmark
    stores them, from the drawn columns."""
    c = _np(cols)
    status = (c["shipdate"] > CURRENT).astype(np.int64)
    dims = np.stack([c["returnflag"], status, c["shipinstruct"], c["shipmode"],
                     c["quantity"] - 1, c["discount"], c["tax"], _ship_year(c["shipdate"])],
                    axis=1).astype(np.int32)
    pk = c["partkey"]
    retail_cents = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    ext_cents = c["quantity"] * retail_cents
    ext = (ext_cents / 100.0).astype(np.float32)
    disc = (ext_cents * (100 - c["discount"]) / 10_000.0).astype(np.float32)
    order = c["order"]
    ints = np.stack([(order // 8) * 32 + order % 8 + 1,  # the first 8 keys of every 32
                     pk, c["suppkey"], np.arange(order.size) - _first_line(order) + 1,
                     c["shipdate"], c["commitdate"], c["receiptdate"]], axis=1)
    comment = np.ascontiguousarray(c["comment"], dtype=np.uint8)
    return dims, np.concatenate([np.stack([ext, disc], axis=1),
                                 ints.astype(np.int32).view(np.float32),
                                 comment.view(np.float32)], axis=1)
