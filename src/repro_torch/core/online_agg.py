"""Online aggregation: the §5 estimators folded incrementally, round by round.

Counterpart of ``repro/core/online_agg.py``.  The offline path
(:meth:`repro_torch.core.engine.NeedleTailEngine.aggregate`) plans one
:class:`~repro_torch.core.hybrid.HybridPlan`, reads every planned block at
once and runs the Eq. 1-8 estimators on the full block statistics.
:class:`OnlineAggregator` restructures the same math as a stream, so a
request can stop at an error SLO or a time SLO:

* **Pinned design.**  At admission it fixes the chosen arm ``S_c`` (the
  any-k densest-block prefix of :func:`~repro_torch.core.hybrid.
  plan_hybrid`, π = 1) and a seeded permutation of the remaining valid
  blocks, both drawn on the host from one copy of the combined row.  Any
  fetched prefix of the permutation is a uniform without-replacement sample
  of its size, so after round t the fetched set is a valid hybrid design
  with ``π_r = |prefix| / |remaining|``.
* **Incremental fold.**  Each round reads exactly the newly staged blocks
  through the engine's block cache and computes their partials (``τ_i``,
  the masked measure sum, and ``L_i``, the valid-row count) on the card
  with :func:`~repro_torch.core.engine.block_partials`, the function the
  offline path uses.  A block's partials do not depend on the blocks read
  beside it, so after the final round the stream's last ``Estimate`` equals
  the offline estimator on the same fetched set under ``==``.
* **Invalidation.**  The aggregator listens to the store: folded blocks
  that the store reports rewritten are read and folded again on the next
  round.

:func:`run_online_aggregate` drives one aggregate to its SLO, arbitrating
answer-now vs fetch-more with :func:`repro_torch.serving.admission.
arbitrate_aggregate`, each chunk priced by :func:`repro_torch.storage.
prefetch.effective_block_cost`.  :class:`OnlineGroupFold` reuses the fold
for per-group streaming CIs in :func:`repro_torch.core.groupby.
groupby_any_k`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import estimators as est
from repro_torch.core.density_map import AND
from repro_torch.core.engine import block_partials
from repro_torch.core.estimators import Z95
from repro_torch.core.hybrid import HybridPlan, plan_hybrid


@dataclasses.dataclass(frozen=True)
class AggregateQuery:
    """One online aggregate: mean/total of ``measure`` over the predicate set.

    ``k`` and ``alpha`` only seed the design split (how much of the any-k
    densest prefix becomes the π=1 chosen arm); the random arm is
    open-ended — the SLO decides how far down the permutation the request
    reads.
    """

    predicates: Any
    measure: int
    k: int
    alpha: float = 0.3
    op: str = AND
    estimator: str = "ratio"  # "ratio" | "ht"
    algo: str = "threshold"
    seed: int = 0


class OnlineAggregator:
    """Incremental HT/ratio estimate over an evolving hybrid design."""

    def __init__(self, engine, query: AggregateQuery, chunk_blocks: int = 8):
        if chunk_blocks < 1:
            raise ValueError("chunk_blocks must be >= 1")
        self.engine = engine
        self.query = query
        self.chunk_blocks = int(chunk_blocks)
        store = engine.store
        self.rpb = store.records_per_block
        combined = engine.combined_density(query.predicates, query.op).cpu().numpy()
        anyk_blocks, _ = engine.plan(query.predicates, query.k, query.op, query.algo)
        rng = np.random.default_rng(query.seed)
        seed_plan = plan_hybrid(anyk_blocks, combined, query.k, query.alpha, self.rpb, rng)
        self.sc = np.sort(seed_plan.sc)
        valid = np.nonzero(np.asarray(combined, dtype=np.float64) > 0)[0]
        self.num_valid_blocks = int(valid.size)
        self._remaining = np.setdiff1d(valid, self.sc)
        # the random-arm schedule: any fetched prefix of a seeded permutation
        # is a uniform SRSWOR of its size over `remaining`
        self._perm = (
            rng.permutation(self._remaining).astype(np.int64)
            if self._remaining.size
            else np.asarray([], dtype=np.int64)
        )
        self._cursor = 0
        self._sc_folded = False
        # per-block partials keyed by block id; values keep the numpy scalar
        # dtype of block_partials, so re-assembled arrays sum as the
        # offline one-shot arrays do
        self._tau: dict[int, Any] = {}
        self._n: dict[int, Any] = {}
        # same expression as the offline aggregate's population estimate
        self.population_size = float(np.sum(combined) * self.rpb)
        self.rounds = 0
        self.estimates: list[est.Estimate] = []
        self.spent_io_s = 0.0  # modeled demand I/O charged by the caller
        self._staged: tuple[np.ndarray, int, np.ndarray] | None = None
        self._dirty: set[int] = set()
        self._listening = True
        store.register_invalidation_listener(self._on_invalidate)

    # ------------------------------------------------------------ lifecycle
    def _on_invalidate(self, block_ids) -> None:
        self._dirty.update(int(b) for b in np.asarray(block_ids, dtype=np.int64))

    def close(self) -> None:
        """Unregister the invalidation listener (idempotent).  The store
        holds the listener weakly, so a dropped aggregator cannot leak."""
        if self._listening:
            self.engine.store.unregister_invalidation_listener(self._on_invalidate)
            self._listening = False

    # ------------------------------------------------------------- schedule
    @property
    def sr_fetched(self) -> int:
        """Random-arm blocks folded so far."""
        return self._cursor

    @property
    def exhausted(self) -> bool:
        """Every block of the pinned design has been folded."""
        return self._sc_folded and self._cursor >= self._perm.size

    def next_blocks(self) -> np.ndarray:
        """Stage and return the next chunk this request wants read:
        ascending ids, the chosen arm on the first call, then
        ``chunk_blocks`` of the random-arm permutation per round, plus any
        folded blocks the store has reported rewritten.  Staging again
        before :meth:`fold` is safe."""
        parts: list[np.ndarray] = []
        refold = np.asarray(sorted(b for b in self._dirty if b in self._tau), dtype=np.int64)
        if not self._sc_folded and self.sc.size:
            parts.append(self.sc)
        nxt = self._perm[self._cursor: self._cursor + self.chunk_blocks]
        if nxt.size:
            parts.append(nxt)
        if refold.size:
            parts.append(refold)
        chunk = np.unique(np.concatenate(parts)) if parts else np.asarray([], np.int64)
        self._staged = (chunk, int(nxt.size), refold)
        return chunk

    # ----------------------------------------------------------------- fold
    def fold(self) -> est.Estimate:
        """Read + fold the staged chunk; append and return this round's
        :class:`~repro_torch.core.estimators.Estimate`."""
        if self._staged is None:
            self.next_blocks()
        chunk, n_new_r, refold = self._staged
        self._staged = None
        engine, q = self.engine, self.query
        if chunk.size:
            bd, bm, bv = engine.block_cache.get_many(engine.store, chunk)
            mask = engine._mask(bd, q.predicates, q.op) & bv
            tau, n = block_partials(mask, bm[..., q.measure])
            for j, b in enumerate(chunk):
                self._tau[int(b)] = tau[j]
                self._n[int(b)] = n[j]
        self._sc_folded = True
        self._cursor += n_new_r
        # any block just read reflects current bytes, design blocks dirtied
        # before their first fold included; blocks outside the pinned design
        # stay dirty and are never folded
        self._dirty.difference_update(int(b) for b in chunk)
        self.rounds += 1
        e = self.estimate()
        self.estimates.append(e)
        return e

    # ------------------------------------------------------------ estimates
    def design_snapshot(self) -> HybridPlan:
        """The evolving design, frozen at the current fold state: the full
        chosen arm plus the fetched random-arm prefix at its current π_r."""
        sr = np.sort(self._perm[: self._cursor])
        pi_r = sr.size / max(self._remaining.size, 1)
        return HybridPlan(sc=self.sc, sr=sr, num_valid_blocks=self.num_valid_blocks, pi_r=pi_r)

    def estimate(self) -> est.Estimate:
        """The Eq. 1-8 estimate over every folded partial — what the
        offline estimator returns on the same fetched block set."""
        plan = self.design_snapshot()
        blocks = np.sort(plan.blocks)
        tau_i = np.asarray([self._tau[int(b)] for b in blocks])
        n_i = np.asarray([self._n[int(b)] for b in blocks])
        in_sc = np.isin(blocks, plan.sc)
        fn = est.horvitz_thompson if self.query.estimator == "ht" else est.ratio_estimator
        return fn(tau_i[in_sc], tau_i[~in_sc], n_i[in_sc], n_i[~in_sc], plan,
                  self.population_size)

    def halfwidth(self) -> float:
        """95% CI half-width of the latest estimate; ``inf`` until the
        random arm can support a variance estimate (≥ 2 blocks) unless the
        design is fully covered (the answer is exact)."""
        if not self.estimates:
            return math.inf
        full = self._cursor >= self._perm.size
        if self._cursor < 2 and not full:
            return math.inf
        return self.estimates[-1].ci_halfwidth(Z95)

    def predicted_halfwidth(self, extra_blocks: int) -> float:
        """Expected CI half-width after folding ``extra_blocks`` more
        random-arm blocks, by the SRSWOR scaling var ∝ (N−n)/(N·n)."""
        hw = self.halfwidth()
        if not math.isfinite(hw) or hw <= 0.0:
            return hw
        big_n, n1 = int(self._remaining.size), self._cursor
        n2 = min(n1 + max(int(extra_blocks), 0), self._perm.size)
        if n1 <= 0 or n1 >= big_n or n2 <= n1:
            return hw
        factor = ((big_n - n2) / n2) / ((big_n - n1) / n1)
        return hw * math.sqrt(max(factor, 0.0))


@dataclasses.dataclass
class OnlineAggResult:
    estimate: est.Estimate  # the stream's final entry
    stream: list[est.Estimate]  # one Estimate per round
    reason: str  # "ci" | "deadline" | "diminishing" | "exhausted" | "budget"
    rounds: int
    blocks_fetched: int  # distinct design blocks folded
    spent_io_s: float  # modeled demand I/O (effective_block_cost per chunk)
    plan: HybridPlan  # the final design snapshot
    population_size: float


def run_online_aggregate(
    engine,
    query: AggregateQuery,
    *,
    error_slo: float | None = None,
    deadline_s: float | None = None,
    chunk_blocks: int = 8,
    max_rounds: int = 64,
    max_s_per_width: float | None = None,
) -> OnlineAggResult:
    """Drive one aggregate to its SLO.

    Rounds read and fold ``chunk_blocks`` design blocks each, priced by
    :func:`repro_torch.storage.prefetch.effective_block_cost`; after every
    round :func:`repro_torch.serving.admission.arbitrate_aggregate` decides
    answer-now vs fetch-more.  With no SLOs the loop runs to ``max_rounds``
    (reason ``"budget"``) or design exhaustion.
    """
    from repro_torch.serving.admission import arbitrate_aggregate
    from repro_torch.storage.prefetch import effective_block_cost

    agg = OnlineAggregator(engine, query, chunk_blocks=chunk_blocks)
    reason = "budget"
    try:
        for _ in range(max_rounds):
            chunk = agg.next_blocks()
            if chunk.size == 0 and agg.rounds > 0:
                reason = "exhausted"
                break
            cost = effective_block_cost(engine, chunk)
            agg.fold()
            agg.spent_io_s += cost
            if agg.exhausted:
                reason = "exhausted"
                break
            nxt = agg.next_blocks()  # peek: the following chunk's price
            verdict = arbitrate_aggregate(
                halfwidth=agg.halfwidth(),
                error_slo=error_slo,
                deadline_s=deadline_s,
                spent_s=agg.spent_io_s,
                next_cost_s=effective_block_cost(engine, nxt),
                predicted_halfwidth=agg.predicted_halfwidth(chunk_blocks),
                max_s_per_width=max_s_per_width,
            )
            if verdict is not None:
                reason = verdict
                break
    finally:
        agg.close()
    if not agg.estimates:  # max_rounds == 0: still return a defined snapshot
        agg.estimates.append(agg.estimate())
    return OnlineAggResult(
        estimate=agg.estimates[-1],
        stream=list(agg.estimates),
        reason=reason,
        rounds=agg.rounds,
        blocks_fetched=len(agg._tau),
        spent_io_s=agg.spent_io_s,
        plan=agg.design_snapshot(),
        population_size=agg.population_size,
    )


class OnlineGroupFold:
    """Per-group streaming CIs for the group-by loop (the same fold).

    Every fetched block contributes per-group partials (τ_g, L_g), computed
    on the card for all groups at once.  Group ``g``'s snapshot treats its
    fetched support blocks as the random arm of a hybrid design with an
    empty chosen arm over the group's valid blocks (π_r = fetched_g / N_g):
    self-weighting, so the ratio mean is the plain mean of g's retrieved
    records while Eqs. 5-8 supply a design-based variance.  The fetch order
    is priority-driven, not random: these CIs are a streaming-progress
    heuristic, each snapshot exactly the estimator over the folded partials.
    """

    def __init__(self, group_densities: np.ndarray, records_per_block: int):
        self._d_g = np.asarray(group_densities, dtype=np.float64)  # [G, λ], host
        self.num_groups, self.lam = self._d_g.shape
        self.rpb = records_per_block
        self._valid_g = self._d_g > 0  # [G, λ] block support per group
        self._pop_g = self._d_g.sum(axis=1) * records_per_block
        self._tau: list[dict[int, float]] = [{} for _ in range(self.num_groups)]
        self._n: list[dict[int, float]] = [{} for _ in range(self.num_groups)]

    def fold(self, block_ids: np.ndarray, group_vals: torch.Tensor, vals: torch.Tensor,
             mask: torch.Tensor) -> None:
        """Fold one round's slabs: ``group_vals`` / ``vals`` / ``mask`` are
        the ``[B, R]`` group attribute, measure and valid-record mask of
        ``block_ids``, on their device."""
        groups = torch.arange(self.num_groups, device=mask.device)[:, None, None]
        m = mask[None] & (group_vals[None] == groups)  # [G, B, R]
        tau, n = block_partials(m, vals[None])
        for g in range(self.num_groups):
            sup = self._valid_g[g]
            for j, b in enumerate(block_ids):
                if sup[int(b)]:
                    self._tau[g][int(b)] = float(tau[g, j])
                    self._n[g][int(b)] = float(n[g, j])

    def snapshot(self) -> dict[int, est.Estimate]:
        """Per-group Estimates over everything folded so far (groups with no
        folded support blocks are omitted)."""
        out: dict[int, est.Estimate] = {}
        empty = np.asarray([], dtype=np.float64)
        for g in range(self.num_groups):
            if not self._tau[g]:
                continue
            blocks = np.asarray(sorted(self._tau[g]), dtype=np.int64)
            tau_r = np.asarray([self._tau[g][int(b)] for b in blocks])
            n_r = np.asarray([self._n[g][int(b)] for b in blocks])
            n_valid = int(np.sum(self._valid_g[g]))
            plan = HybridPlan(
                sc=np.asarray([], dtype=np.int64),
                sr=blocks,
                num_valid_blocks=n_valid,
                pi_r=blocks.size / max(n_valid, 1),
            )
            out[g] = est.ratio_estimator(empty, tau_r, empty, n_r, plan, float(self._pop_g[g]))
        return out
