"""Plain reference of the any-k LIMIT semantics (NeedleTail §3–4, §7.2).

Written from the paper, independent of the program: numpy on the host, and
plain PyTorch where a pass over the whole table is needed (the density
counts and each query's matches, on the table the benchmark generated).

* **Index** (§3): each (dimension, value) row holds, per block, the share of
  the block's ``records_per_block`` rows that match, in float32, as the
  configuration states (``index_dtype``).
* **Combine** (§3.2): AND is the float32 product of a query's rows, OR their
  float32 sum clipped to 1, each folded left to right.
* **THRESHOLD** (§4.1): blocks by density, highest first (ties by lower id),
  up to the first prefix whose expected records reach the need; every
  nonzero block when none does.
* **TWO-PRONG** (§4.2): the shortest window of consecutive blocks whose
  expected records reach the need, ties to the smallest start; the whole
  table when none does.
* **auto** (§7.2): the cheaper of the two under the configuration's cost
  model (the paper's HDD model, §4.3.1), THRESHOLD on a tie.
* **Refill** (§4.1): the blocks read are excluded (density 0) and the query
  re-plans for its remaining need until it has k records, its plan comes up
  empty, or it has read in ``max_refills`` rounds.

Sums here are float64.  The program keeps its prefix sums in float32, so
where a decision lies within float32 rounding of its boundary the two can
part.  :func:`follow` accepts such a plan only when every expected-record
sum it compares lies within ``SLACK_ULPS`` float32 ulps of the sum's size of
the need, and counts it as a tie; anything else is off.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# A float32 prefix sum of λ ≤ 16⁴ non-negative terms, added in chunks of 16 at
# each of ≤ 4 levels, takes ≤ 64 roundings of ≤ ½ ulp of its result: 32 ulps.
# Twice that is the slack a plan may use and still count as a tie.
SLACK_ULPS = 64
AND, OR = "and", "or"


# ----------------------------------------------------------------- the index
def density_index(dims: torch.Tensor, cards, records_per_block: int,
                  round_to: torch.dtype | None = None, chunk: int = 1 << 24) -> np.ndarray:
    """``[Σ cards, λ]`` float32 densities from an ``[n, r]`` int32 table on any
    device.  ``round_to`` stores them in a narrower type first (the control)."""
    n, r = dims.shape
    lam = -(-n // records_per_block)
    offsets = np.concatenate([[0], np.cumsum(cards)]).astype(np.int64)
    rows = int(offsets[-1])
    counts = torch.zeros(rows * lam, dtype=torch.int64, device=dims.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        block = torch.arange(lo, hi, device=dims.device) // records_per_block
        for a in range(r):
            flat = (int(offsets[a]) + dims[lo:hi, a].long()) * lam + block
            counts += torch.bincount(flat, minlength=rows * lam)
    dens = (counts.to(torch.float64) / records_per_block).to(torch.float32)
    if round_to is not None:
        dens = dens.to(round_to).to(torch.float32)
    return dens.reshape(rows, lam).cpu().numpy()


def row_ids(cards, predicates) -> list[int]:
    offsets = np.concatenate([[0], np.cumsum(cards)])
    return [int(offsets[a]) + int(v) for a, v in predicates]


def combine(dens: np.ndarray, rows: list[int], op: str, bf16: bool = False) -> np.ndarray:
    """§3.2 in float32 (or, for the control, bfloat16), folded left to right."""
    if bf16:
        d = torch.from_numpy(dens).to(torch.bfloat16)
        acc = torch.full((dens.shape[1],), 1.0 if op == AND else 0.0, dtype=torch.bfloat16)
        for r in rows:
            acc = acc * d[r] if op == AND else acc + d[r]
        acc = acc.clamp(max=1.0) if op == OR else acc
        return acc.to(torch.float32).numpy()
    acc = np.full(dens.shape[1], 1.0 if op == AND else 0.0, dtype=np.float32)
    for r in rows:
        acc = acc * dens[r] if op == AND else acc + dens[r]
    return np.minimum(acc, np.float32(1.0)) if op == OR else acc


def _cumsum(x: np.ndarray, bf16: bool) -> np.ndarray:
    """Prefix sums: float64 for the reference, bfloat16 outputs for the control."""
    if not bf16:
        return np.cumsum(x)
    return torch.cumsum(torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16), 0
                        ).to(torch.float64).numpy()


# ---------------------------------------------------------- the cost model
@dataclasses.dataclass(frozen=True)
class HddCost:
    """§4.3.1's HDD model: a linear ramp from ``seq`` at distance 1 to ``far``
    at distance ``t``, ``far`` beyond it and for the first block."""

    seq: float = 0.8e-3
    far: float = 7e-3
    t: int = 64

    def io_time(self, blocks: np.ndarray) -> float:
        ids = np.unique(np.asarray(blocks, dtype=np.int64))
        if ids.size == 0:
            return 0.0
        d = np.maximum(np.abs(np.diff(ids)), 1).astype(np.float64)
        near = self.seq + (self.far - self.seq) * (d - 1) / max(self.t - 1, 1)
        return self.far + float(np.sum(np.where(d <= self.t, near, self.far)))


COST_MODELS = {"hdd": HddCost()}


# -------------------------------------------------------------- the planners
def _slack(x) -> np.ndarray:
    return SLACK_ULPS * np.spacing(np.abs(np.asarray(x, dtype=np.float64)).astype(np.float32)
                                   ).astype(np.float64)


def threshold_plans(mass: np.ndarray, need: float, bf16: bool = False):
    """``(exact, others)``: THRESHOLD's block set (ascending ids) for the
    need, and the other prefixes a float32 sum within slack could cut."""
    order = np.argsort(-mass.astype(np.float32), kind="stable")
    srt = mass[order]
    nnz = int(np.count_nonzero(srt > 0))
    if nnz == 0:
        return np.zeros(0, np.int64), []
    cum = _cumsum(srt[:nnz], bf16)
    i = int(np.searchsorted(cum, need, side="left"))
    exact_n = i + 1 if i < nnz else nnz
    n = np.arange(1, nnz + 1)
    reach = cum >= need - _slack(cum)
    before = np.concatenate([[-np.inf], cum[:-1]])
    ok = reach & (before < need + _slack(before))
    if cum[-1] < need + _slack(cum[-1]):
        ok[nnz - 1] = True  # no prefix surely reaches: all nonzero blocks
    return (np.sort(order[:exact_n]),
            [np.sort(order[:m]) for m in n[ok] if m != exact_n])


def _max_window(c: np.ndarray, length: int) -> float:
    return float(np.max(c[length:] - c[:-length])) if length >= 1 else 0.0


def window_plans(mass: np.ndarray, need: float, cap: int = 256, bf16: bool = False):
    """``(exact, others, capped)``: TWO-PRONG's ``(start, end)`` for the
    need, and the other windows a float32 scan within slack could pick."""
    lam = mass.size
    c = np.concatenate([[0.0], _cumsum(mass, bf16)])
    slack = float(_slack(c[-1]))
    ends = np.searchsorted(c, c[:-1] + need, side="left")
    feas = ends <= lam
    if feas.any():
        lengths = np.where(feas, ends - np.arange(lam), lam + 1)
        s = int(np.argmin(lengths))
        exact = (s, s + int(lengths[s]))
    else:
        exact = (0, lam)

    def shortest(bar: float) -> int:  # least length with a window of mass >= bar
        if c[-1] < bar:
            return lam + 1
        lo, hi = 0, lam
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if _max_window(c, mid) >= bar else (mid, hi)
        return hi

    others, capped = [], False
    if c[-1] < need + slack and exact != (0, lam):
        others.append((0, lam))
    l_lo, l_def = shortest(need - slack), min(shortest(need + slack), lam)
    for length in range(l_lo, l_def + 1):
        m = c[length:] - c[:-length]
        sure = np.flatnonzero(m >= need + slack)
        last = int(sure[0]) if sure.size else lam
        for s in np.flatnonzero(m[: last + 1] >= need - slack):
            if (int(s), int(s) + length) != exact:
                if len(others) >= cap:
                    return exact, others, True
                others.append((int(s), int(s) + length))
    return exact, others, capped


def candidates(comb: np.ndarray, excl: np.ndarray, need: float, rpb: int, cost,
               bf16: bool = False) -> dict:
    """The round's plans under ``auto``: ``{"exact": new blocks, "others":
    [new blocks, ...], "capped": bool}``, each a sorted array of the blocks
    not yet read."""
    mass = np.where(excl, 0.0, comb.astype(np.float64) * rpb)
    t_exact, t_others = threshold_plans(mass, need, bf16)
    w_exact, w_others, capped = window_plans(mass, need, bf16=bf16)

    def choose(tb: np.ndarray, win: tuple[int, int]) -> list[np.ndarray]:
        wb = np.arange(win[0], win[1], dtype=np.int64)
        ct, c2 = cost.io_time(tb), cost.io_time(wb)
        wnew = wb[~excl[wb]]
        if abs(ct - c2) <= 1e-12 * max(ct, c2):
            return [tb, wnew]
        return [tb] if ct <= c2 else [wnew]

    exact = choose(t_exact, w_exact)[0]
    seen = {exact.tobytes()}
    others = []
    for tb in [t_exact] + t_others:
        for win in [w_exact] + w_others:
            for plan in choose(tb, win):
                if plan.tobytes() not in seen:
                    seen.add(plan.tobytes())
                    others.append(plan)
    return {"exact": exact, "others": others, "capped": capped}


# ------------------------------------------------------------ refill rounds
def run_exact(comb: np.ndarray, k: int, matches: np.ndarray, rpb: int, max_refills: int,
              cost, bf16: bool = False) -> tuple[np.ndarray, int]:
    """The reference's own rounds: ``(blocks read in round order, rounds)``;
    with ``bf16`` its sums kept in bfloat16 (the control)."""
    excl = np.zeros(comb.size, dtype=bool)
    got, rounds, read = 0, 0, []
    while got < k and rounds < max_refills:
        new = candidates(comb, excl, float(k - got), rpb, cost, bf16)["exact"]
        if new.size == 0:
            break
        read.append(new)
        excl[new] = True
        got += int(matches[new].sum())
        rounds += 1
    return (np.concatenate(read) if read else np.zeros(0, np.int64)), rounds


def follow(comb: np.ndarray, k: int, matches: np.ndarray, blocks: np.ndarray, rounds: int,
           rpb: int, max_refills: int, cost, budget: int = 4096) -> tuple[str, bool]:
    """Judge a program's read sequence (``blocks``, all rounds in order, and
    its round count) against the refill rounds: ``("exact" | "tie" | "off",
    capped)``.  Where a round admits several plans (ties), each is tried."""
    blocks = np.asarray(blocks, dtype=np.int64)
    capped = False
    nodes = 0

    def walk(pos: int, excl: np.ndarray, got: int, r: int) -> str | None:
        nonlocal capped, nodes
        nodes += 1
        if nodes > budget:
            capped = True
            return None
        if got >= k or r >= max_refills:
            return "exact" if pos == blocks.size and r == rounds else None
        cand = candidates(comb, excl, float(k - got), rpb, cost)
        capped = capped or cand["capped"]
        best = None
        for i, new in enumerate([cand["exact"]] + cand["others"]):
            if new.size == 0:
                res = "exact" if pos == blocks.size and r == rounds else None
            elif pos + new.size <= blocks.size and np.array_equal(blocks[pos:pos + new.size], new):
                nxt = excl.copy()
                nxt[new] = True
                res = walk(pos + new.size, nxt, got + int(matches[new].sum()), r + 1)
            else:
                res = None
            if res is not None:
                res = res if i == 0 else "tie"
                if res == "exact":
                    return res
                best = best or res
        return best

    verdict = walk(0, np.zeros(comb.size, dtype=bool), 0, 0)
    return (verdict or "off"), capped


# ------------------------------------------------------------------ records
def query_mask(dims: torch.Tensor, predicates, op: str) -> torch.Tensor:
    hits = [dims[..., a] == v for a, v in predicates]
    out = hits[0]
    for h in hits[1:]:
        out = (out & h) if op == AND else (out | h)
    return out


def block_matches(dims: torch.Tensor, predicates, op: str, rpb: int) -> np.ndarray:
    """``[λ]`` int64: matching rows in each block of the ``[n, r]`` table."""
    n = dims.shape[0]
    lam = -(-n // rpb)
    m = query_mask(dims, predicates, op).to(torch.int32)
    m = torch.nn.functional.pad(m, (0, lam * rpb - n))
    return m.reshape(lam, rpb).sum(dim=1).cpu().numpy().astype(np.int64)


def records(dims: torch.Tensor, measures: torch.Tensor, predicates, op: str,
            blocks: np.ndarray, rpb: int):
    """Every matching row of ``blocks`` (in that order, then by row):
    ``(block, row, measures)`` on the table's device."""
    dev = dims.device
    b = torch.as_tensor(np.asarray(blocks, dtype=np.int64), device=dev)
    idx = (b[:, None] * rpb + torch.arange(rpb, device=dev)[None, :]).reshape(-1)
    idx = idx[idx < dims.shape[0]]
    hit = idx[query_mask(dims[idx], predicates, op)]
    return hit // rpb, hit % rpb, measures[hit]
