"""Group-by / join any-k (paper Appendix A).

Counterpart of ``repro/core/groupby.py``.  Priority of block l for groups
{V_G^j}:
    d_(S,G)_l = d_P_l * Σ_j w_l(V_G^j)
with NeedleTail's inverse-frequency heuristic (Eq. 10):
    w_l(V_G^j) = (1/f_G^j) * min(k - r_G^j, d_G_l^j * records_per_block)
    f_G^j = mean block density of the group.

The iterative algorithm re-scores after every ψ fetched blocks (Algorithm 4);
joins reduce to group-by on the FK attribute (Appendix A.2).

The priority runs on the card in the reference's dtypes: ``d_g·rpb`` in
f32, promoted to f64 by the ``min`` with the int64 ``k − r_g``, divided by
``f_g``, summed over the groups left to right, times ``d_p``; blocks are
chosen by a stable sort of ``−prio``, so the choice equals the reference's.
``f_g`` is numpy's f32 mean (a pairwise sum, which ``torch.mean`` does not
reproduce), taken once a query on the host from one ``[G, λ]`` copy.  Each
round's records are admitted per group on the card, in the reference's
order (groups ascending, then block and row).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.density_map import AND, combine_densities
from repro_torch.core.engine import NeedleTailEngine


@dataclasses.dataclass
class GroupByResult:
    per_group_counts: np.ndarray  # [num_groups] retrieved sample counts
    blocks_fetched: np.ndarray
    record_block: np.ndarray
    record_row: np.ndarray
    record_group: np.ndarray
    modeled_io_s: float
    rounds: int
    # streaming per-group CIs (measure != None): final snapshot + one
    # snapshot per round, each a {group: Estimate} dict from the incremental
    # fold (repro_torch.core.online_agg.OnlineGroupFold)
    group_estimates: dict | None = None
    estimate_stream: list | None = None


def groupby_any_k(
    engine: NeedleTailEngine,
    predicates,
    group_attr: int,
    k: int,
    op: str = AND,
    psi: int = 8,
    max_rounds: int = 64,
    measure: int | None = None,
) -> GroupByResult:
    """Algorithm 4 with the Eq. 10 priority over ``(attr, value)`` pairs
    (empty: every record).

    With ``measure`` set, every fetched block also folds per-group (τ_g,
    L_g) partials through :class:`repro_torch.core.online_agg.
    OnlineGroupFold`, and the result streams a per-round ``{group:
    Estimate}`` snapshot."""
    store = engine.store
    vocab = store.index.vocab
    rpb = store.records_per_block
    dens = store.index.densities
    dev = dens.device
    lam = dens.shape[1]

    d_p = (combine_densities(dens, vocab.rows(predicates), op).double() if predicates
           else torch.ones(lam, dtype=torch.float64, device=dev))
    num_groups = int(vocab.attr_cards[group_attr])
    g_rows = [vocab.row(group_attr, g) for g in range(num_groups)]
    d_g = dens[torch.as_tensor(g_rows, device=dev)]  # [G, λ] f32
    d_g_host = d_g.cpu().numpy()
    f_g = np.maximum(d_g_host.mean(axis=1), 1e-12)  # group frequencies (Appendix A.1)
    f_g = torch.from_numpy(f_g).to(dev).double()[:, None]
    d_g_rpb = (d_g * rpb).double()  # f32 product, promoted as numpy's min promotes it

    fold = None
    stream: list[dict] = []
    if measure is not None:
        from repro_torch.core.online_agg import OnlineGroupFold

        fold = OnlineGroupFold(d_g_host, rpb)

    r_g = np.zeros(num_groups, dtype=np.int64)  # samples retrieved per group
    seen = torch.zeros(lam, dtype=torch.bool, device=dev)
    rec_b: list[torch.Tensor] = []
    rec_r: list[torch.Tensor] = []
    rec_g: list[torch.Tensor] = []
    fetched: list[np.ndarray] = []
    rounds = 0
    while np.any(r_g < k) and rounds < max_rounds:
        # Eq. 10 priorities
        need = torch.from_numpy(k - r_g).to(dev)
        w = torch.minimum(need[:, None].double(), d_g_rpb).clamp(min=0.0) / f_g  # [G, λ]
        total = w[0]
        for g in range(1, num_groups):
            total = total + w[g]
        prio = torch.where(seen, 0.0, d_p * total)
        order = torch.sort(-prio, stable=True).indices[:psi]
        head = torch.stack([order, (prio[order] > 0).long()]).cpu().numpy()
        top = head[0][head[1] > 0]
        if top.size == 0:  # no block left with a positive priority
            break
        top = np.sort(top)
        bd, bm, bv = store.fetch(top)
        mask = (store.predicate_mask(bd, predicates, op) & bv) if predicates else bv
        gvals = bd[..., group_attr]
        if fold is not None:
            fold.fold(top, gvals, bm[..., measure], mask)
            stream.append(fold.snapshot())
        hit = torch.nonzero(mask)
        gv = gvals[hit[:, 0], hit[:, 1]].long()
        # admit records only for groups still short of k, in the reference's
        # order: groups ascending, then block and row (a stable sort by group)
        order = torch.sort(gv, stable=True).indices
        gs = gv[order]
        counts = torch.bincount(gv, minlength=num_groups)
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(gs.numel(), device=dev) - start[gs]
        keep = rank < need.clamp(min=0)[gs]
        sel = order[keep]
        top_dev = torch.from_numpy(top).to(dev)
        rec_b.append(top_dev[hit[sel, 0]])
        rec_r.append(hit[sel, 1])
        rec_g.append(gs[keep])
        r_g += torch.bincount(gs[keep], minlength=num_groups).cpu().numpy()
        seen[top_dev] = True
        fetched.append(top)
        rounds += 1
    blocks = np.concatenate(fetched) if fetched else np.asarray([], dtype=np.int64)

    def host(parts):
        return torch.cat(parts).cpu().numpy() if parts else np.asarray([], np.int64)

    return GroupByResult(
        per_group_counts=r_g,
        blocks_fetched=blocks,
        record_block=host(rec_b),
        record_row=host(rec_r),
        record_group=host(rec_g),
        modeled_io_s=engine.cost.io_time(blocks),
        rounds=rounds,
        group_estimates=stream[-1] if stream else ({} if fold is not None else None),
        estimate_stream=stream if fold is not None else None,
    )


def join_any_k(
    engine: NeedleTailEngine,
    join_attr: int,
    join_values: Sequence[int],
    k: int,
    predicates=(),
    psi: int = 8,
) -> GroupByResult:
    """FK/PK join any-k (Appendix A.2): k samples per join value, reduced to
    group-by on the FK attribute. ``join_values`` come from scanning the PK
    table."""
    res = groupby_any_k(engine, predicates, join_attr, k, psi=psi)
    keep = np.isin(res.record_group, np.asarray(list(join_values)))
    return dataclasses.replace(
        res,
        record_block=res.record_block[keep],
        record_row=res.record_row[keep],
        record_group=res.record_group[keep],
    )
