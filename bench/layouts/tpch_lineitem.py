"""TPC-H's LINEITEM table (specification clause 4.2.3), generated on the
device from the seed, in order-key order, every column of its row kept.

Orders get 1–7 lines each and an order date uniform over [1992-01-01,
1998-12-31 − 151 days]; order keys are sparse, the first 8 of every 32.
Each line draws its part key (1 to SF · 200,000), one of the part's four
suppliers, its quantity (1–50), discount (0.00–0.10), tax (0.00–0.08), ship
instruction (4 values) and ship mode (7); it ships 1–121 days after its
order, is committed 30–90 days after it and received 1–30 days after
shipping.  Its return flag is R or A at random when it was received by
1995-06-17 (CURRENTDATE), else N; its line status is O when it shipped after
CURRENTDATE, else F; its extended price is the quantity times the part's
retail price, ``(90000 + (partkey / 10) mod 20001 + 100 · (partkey mod
1000)) / 100``; its comment is 10–43 characters of :data:`ALPHABET`,
space-padded to the column's 44 bytes.  Generation stops at ``n`` rows, so
the last order may be cut short.

Stored, as the configuration's dims and measures: return flag (A, N, R),
line status (F, O), ship instruction, ship mode, quantity − 1, 100 ·
discount, 100 · tax and ship year − 1992 (int32 dims); then 20 measure
words: the extended price and the discounted price ``extendedprice · (1 −
discount)`` (float32, each the exact value in cents rounded once), then the
order key, part key, supplier key, line number, ship, commit and receipt
dates (days since 1992-01-01), each an int32 in a word's bits, then the
comment's 44 bytes in 11 words.  Since dates are drawn per order and orders
follow one another, every column's density is flat across blocks.
"""
from __future__ import annotations

import datetime
import math

import torch

EPOCH = datetime.date(1992, 1, 1)


def day(y: int, m: int, d: int) -> int:
    """Days since 1992-01-01."""
    return (datetime.date(y, m, d) - EPOCH).days


CURRENT_DATE = day(1995, 6, 17)
ORDER_DAYS = day(1998, 12, 31) - 151 + 1  # order dates 0 .. ORDER_DAYS - 1
YEAR_STARTS = [day(y, 1, 1) for y in range(1993, 1999)]  # ship year boundaries
INSTRUCTIONS = ("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN")
MODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
FLAGS = ("A", "N", "R")
STATUSES = ("F", "O")
# the comment's 64 symbols; a space pads it to COMMENT_BYTES
ALPHABET = b"0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ,."
COMMENT_BYTES = 44
COMMENT_LENGTHS = (10, 43)
INT_WORDS = ("orderkey", "partkey", "suppkey", "linenumber", "shipdate", "commitdate",
             "receiptdate")
MEASURES = 2 + len(INT_WORDS) + COMMENT_BYTES // 4
_CHUNK = 1 << 20  # comment rows drawn at a time


def _draw(lo: int, hi: int, size: int, gen: torch.Generator, device) -> torch.Tensor:
    """int32 uniform on ``[lo, hi]``."""
    return torch.randint(lo, hi + 1, (size,), generator=gen, device=device, dtype=torch.int32)


def _comments(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``[n, COMMENT_BYTES]`` uint8: 10–43 symbols of :data:`ALPHABET`, then spaces."""
    out = torch.empty((n, COMMENT_BYTES), dtype=torch.uint8, device=device)
    symbols = torch.tensor(list(ALPHABET), dtype=torch.uint8, device=device)
    at = torch.arange(COMMENT_BYTES, device=device, dtype=torch.int32)
    for lo in range(0, n, _CHUNK):
        m = min(_CHUNK, n - lo)
        chars = symbols[torch.randint(0, len(ALPHABET), (m, COMMENT_BYTES), generator=gen,
                                      device=device)]
        length = _draw(*COMMENT_LENGTHS, m, gen, device)
        out[lo:lo + m] = torch.where(at < length[:, None], chars, ord(" "))
    return out


def columns(n: int, gen: torch.Generator, device, scale_factor: int) -> dict:
    """The drawn columns of ``n`` lines: each line's ``order`` (its order's
    position), ``orderdate``, ``shipdate``, ``commitdate``, ``receiptdate``
    (days since 1992-01-01), ``partkey``, ``suppkey``, ``quantity``,
    ``discount`` and ``tax`` (in hundredths), ``shipinstruct``, ``shipmode``
    and ``returnflag`` (indices into :data:`INSTRUCTIONS`, :data:`MODES`,
    :data:`FLAGS`), int32 ``[n]`` tensors on ``device``; and ``comment``,
    uint8 ``[n, COMMENT_BYTES]``."""
    orders = n // 4 + 8 * math.isqrt(n) + 64  # 4 lines an order on average
    while True:
        lines = _draw(1, 7, orders, gen, device)
        if int(lines.sum()) >= n:
            break
        orders *= 2  # too few orders drawn for n lines: draw a larger set
    order = torch.repeat_interleave(torch.arange(orders, device=device, dtype=torch.int32),
                                    lines)[:n]
    orderdate = _draw(0, ORDER_DAYS - 1, orders, gen, device)[order]
    cols = {"order": order, "orderdate": orderdate,
            "partkey": _draw(1, scale_factor * 200_000, n, gen, device),
            "quantity": _draw(1, 50, n, gen, device),
            "discount": _draw(0, 10, n, gen, device),
            "tax": _draw(0, 8, n, gen, device),
            "shipinstruct": _draw(0, len(INSTRUCTIONS) - 1, n, gen, device),
            "shipmode": _draw(0, len(MODES) - 1, n, gen, device)}
    cols["shipdate"] = orderdate + _draw(1, 121, n, gen, device)
    cols["receiptdate"] = cols["shipdate"] + _draw(1, 30, n, gen, device)
    returned = _draw(0, 1, n, gen, device)  # R or A, for lines received by CURRENTDATE
    cols["returnflag"] = torch.where(cols["receiptdate"] > CURRENT_DATE, FLAGS.index("N"),
                                     torch.where(returned == 1, FLAGS.index("R"),
                                                 FLAGS.index("A"))).to(torch.int32)
    cols["commitdate"] = orderdate + _draw(30, 90, n, gen, device)
    # the part's i-th supplier, i in 0..3: (partkey + i · (S/4 + (partkey − 1)/S)) mod S + 1
    s = scale_factor * 10_000
    pk = cols["partkey"].long()
    i = _draw(0, 3, n, gen, device).long()
    cols["suppkey"] = ((pk + i * (s // 4 + (pk - 1) // s)) % s + 1).to(torch.int32)
    cols["comment"] = _comments(n, gen, device)
    return cols


def encode(cols: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dims [n, 8] int32, measures [n, MEASURES] float32)`` of the drawn columns."""
    ship, order = cols["shipdate"], cols["order"]
    n, dev = ship.numel(), ship.device
    status = (ship > CURRENT_DATE).to(torch.int32)  # O after CURRENTDATE, else F
    year = torch.bucketize(ship, torch.tensor(YEAR_STARTS, device=dev, dtype=ship.dtype),
                           right=True).to(torch.int32)
    dims = torch.stack([cols["returnflag"], status, cols["shipinstruct"], cols["shipmode"],
                        cols["quantity"] - 1, cols["discount"], cols["tax"], year], dim=1)
    meas = torch.empty((n, MEASURES), dtype=torch.float32, device=dev)
    pk = cols["partkey"].long()
    cents = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)  # the part's retail price
    price = cols["quantity"].long() * cents
    meas[:, 0] = (price.double() / 100).float()
    meas[:, 1] = ((price * (100 - cols["discount"].long())).double() / 10_000).float()
    # sparse order keys: the first 8 of every 32; line numbers count from an order's first
    key = (order // 8) * 32 + order % 8 + 1
    first = torch.searchsorted(order, order)  # each line's order's first line
    ints = {"orderkey": key,
            "linenumber": (torch.arange(n, device=dev) - first + 1).to(torch.int32),
            **{k: cols[k] for k in INT_WORDS if k in cols}}
    words = meas.view(torch.int32)
    for j, k in enumerate(INT_WORDS):
        words[:, 2 + j] = ints[k]
    words[:, 2 + len(INT_WORDS):] = cols["comment"].view(torch.int32)
    return dims, meas


def generate(n: int, gen: torch.Generator, device, scale_factor: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dims [n, 8] int32 on ``device``, measures [n, MEASURES] float32 on
    the host)``: the first ``n`` lines.  Set-up counts matches on the dims
    alone and keeps a host copy of the table, so the measures, 20 of its 28
    words a row, leave the device here, and its cached temporaries are
    released before the store and the cache are built beside the dims."""
    dims, meas = encode(columns(n, gen, device, scale_factor))
    meas = meas.cpu()
    if dims.is_cuda:
        torch.cuda.empty_cache()
    return dims, meas
