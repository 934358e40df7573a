"""Placement policies for the tiered block-storage hierarchy.

Counterpart of ``repro/storage/policy.py`` (host bookkeeping, unchanged).
The paper's core observation is that the density/locality tradeoff is a
function of the storage medium: which blocks are "promising" depends on what
a fetch *costs*.  :mod:`repro_torch.storage.tiers` lifts that to a memory
hierarchy — each tier carries its own :class:`~repro_torch.core.cost_model.CostModel`
preset — and this module supplies the arbiter: a **placement policy** decides,
per block, which tier admits a fresh store read, when a hit earns a promotion,
which resident is displaced to make room, and where an evicted block lands
(demotion down the stack, not a drop, whenever a lower tier exists).

Policy contract
---------------
A policy is any object implementing the four hooks of :class:`PlacementPolicy`
(duck-typed; subclassing is optional):

``admit_tier(stack, block_id, nbytes) -> int``
    Tier index a block freshly read from the backing store is admitted to.
``promote_tier(stack, block_id, tier_idx) -> int``
    Called on a hit at ``tier_idx``; return a tier index ``<= tier_idx`` to
    move the block up (equal means stay).  Promotions move one level at a
    time per hit.
``victim(stack, tier_idx) -> int | None``
    Which resident of ``tier_idx`` is displaced when the tier must shed
    bytes; ``None`` falls back to LRU order.
``demote_target(stack, tier_idx) -> int | None``
    Where a displaced block from ``tier_idx`` lands; ``None`` drops it out
    of the stack (the backing store still holds every block, so a drop
    changes I/O cost, never correctness).

Policies only *place*; they never touch bytes — the
:class:`~repro_torch.storage.tiers.TierStack` byte-identity guarantee holds under
any policy, including an adversarial one.

Two policies ship:

* :class:`CostAwarePolicy` — the default.  Scores a block's residency at a
  tier by the modeled **io_time saved per byte**: how many seconds of backing
  I/O its resident copy avoids per access, divided by the slab size
  (density-per-cost — the paper's DensityMap promise/cost scoring lifted to
  the memory hierarchy).  Free capacity in a faster tier always admits
  (displacing nothing costs nothing); a full *upper* tier is entered only by
  out-scoring its weakest incumbent (so one cold sweep cannot flush the fast
  tiers); tiers whose cost model is not actually faster than the level below
  are never promoted into.  The BOTTOM tier deliberately admits like an LRU —
  fresh traffic is always cacheable there, which means a scan larger than the
  bottom budget can churn it (the classic recency/frequency trade; the fast
  tiers stay protected by the promotion gate).
* :class:`RecencyPolicy` — pure recency: every fresh block and every hit
  lands in tier 0, LRU victims cascade down.  This is the flat
  ``BlockLRUCache`` heuristic expressed as a stack policy — the control the
  equivalence suite and benchmarks compare the cost-aware arbiter against.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.storage.tiers import TierStack


class PlacementPolicy:
    """Base policy: admit to the top, promote on hit, demote one level down.

    Subclasses override the four hooks; the defaults implement
    :class:`RecencyPolicy` behavior (documented here so the base class is a
    usable policy on its own).
    """

    def admit_tier(self, stack: "TierStack", block_id: int, nbytes: int) -> int:
        return 0

    def promote_tier(self, stack: "TierStack", block_id: int, tier_idx: int) -> int:
        return 0

    def victim(self, stack: "TierStack", tier_idx: int) -> int | None:
        return None  # LRU order

    def demote_target(self, stack: "TierStack", tier_idx: int) -> int | None:
        nxt = tier_idx + 1
        return nxt if nxt < len(stack.tiers) else None


class RecencyPolicy(PlacementPolicy):
    """Pure recency: the flat LRU heuristic as a stack policy.

    Fresh blocks and hits always land in tier 0; displaced blocks cascade
    down one tier at a time; the bottom tier's victims drop.  No cost model
    is consulted — this is the control arm for the cost-aware arbiter.
    """


class CostAwarePolicy(PlacementPolicy):
    """Arbitrate placement by modeled io_time saved per byte.

    The score of keeping block ``b`` resident at tier ``t`` is::

        score(b, t) = accesses(b) * (backing.far_cost - tier_t.far_cost) / nbytes

    — seconds of backing-store I/O the resident copy avoids, per byte of
    capacity it occupies, weighted by how often the block is actually
    touched (the stack counts logical accesses per block id).  Promotion
    from ``t`` to ``t-1`` adds ``accesses * (cost_t.far - cost_{t-1}.far) /
    nbytes`` of additional saving; it happens when that marginal saving is
    positive (the upper tier really is faster) AND either the upper tier has
    free room or the candidate out-scores the upper tier's weakest incumbent.

    Parameters
    ----------
    promote_after : int
        Minimum access count before a block is promotion-eligible (default
        2: second-touch promotion, the classic scan-resistance guard — one
        cold sweep cannot flush the fast tier).
    """

    def __init__(self, promote_after: int = 2):
        self.promote_after = int(promote_after)

    # ------------------------------------------------------------- scoring
    @staticmethod
    def _far_cost(stack: "TierStack", level_name: str, far: float) -> float:
        """Model far_cost scaled by the stack's plan-ledger correction (if
        any) — placement chases *observed* costs, not the preset's claim."""
        lg = getattr(stack, "ledger", None)
        return far * lg.correction(level_name) if lg is not None else far

    @classmethod
    def _saving(cls, stack: "TierStack", tier_idx: int) -> float:
        """io_time saved per access by residency at `tier_idx` vs backing."""
        tier = stack.tiers[tier_idx]
        return cls._far_cost(stack, stack.backing.name, stack.backing.far_cost) - \
            cls._far_cost(stack, tier.name, tier.cost.far_cost)

    def score(self, stack: "TierStack", block_id: int, tier_idx: int) -> float:
        """Modeled io_time saved per byte by this block's residency."""
        tier = stack.tiers[tier_idx]
        nbytes = tier.slab_nbytes(block_id) or 1
        return (
            stack.accesses(block_id) * self._saving(stack, tier_idx) / nbytes
        )

    # --------------------------------------------------------------- hooks
    def admit_tier(self, stack: "TierStack", block_id: int, nbytes: int) -> int:
        # highest tier that (a) actually saves io_time vs the backing store
        # and (b) has free room — filling free fast capacity displaces
        # nothing, so a positive saving always justifies it.  With no free
        # room anywhere, admit to the bottom tier (its weakest resident is
        # the cheapest displacement in the whole stack).
        for t, tier in enumerate(stack.tiers):
            if self._saving(stack, t) <= 0.0:
                continue
            if tier.has_room(nbytes):
                return t
        # bottom-most tier that owns local capacity: a zero-capacity view
        # tier (the reference's peer tier) can never admit anything
        for t in range(len(stack.tiers) - 1, -1, -1):
            cap = stack.tiers[t].capacity_bytes
            if cap is None or cap > 0:
                return t
        return 0

    def promote_tier(self, stack: "TierStack", block_id: int, tier_idx: int) -> int:
        if tier_idx == 0:
            return 0
        lo, up = stack.tiers[tier_idx], stack.tiers[tier_idx - 1]
        # marginal saving of the move: upper tier must really be faster
        # (under corrected costs — a mis-preset "fast" tier measured slow
        # stops attracting promotions once the ledger has seen it)
        if self._far_cost(stack, lo.name, lo.cost.far_cost) <= \
                self._far_cost(stack, up.name, up.cost.far_cost):
            return tier_idx
        acc = stack.accesses(block_id)
        if acc < self.promote_after:
            return tier_idx
        nbytes = stack.tiers[tier_idx].slab_nbytes(block_id) or 1
        if not up.fits_at_all(nbytes):  # upper tier can never hold this slab
            return tier_idx
        if up.has_room(nbytes):
            return tier_idx - 1
        victim = self.victim(stack, tier_idx - 1)
        if victim is None:  # upper tier empty but roomless: stay put
            return tier_idx
        # displace the weakest incumbent only if we out-score it (same
        # Δcost and slab size on both sides, so this is an access-frequency
        # comparison weighted by the cost ladder)
        if self.score(stack, block_id, tier_idx) > self.score(
            stack, victim, tier_idx - 1
        ):
            return tier_idx - 1
        return tier_idx

    def victim(self, stack: "TierStack", tier_idx: int) -> int | None:
        """Displace the lowest-score resident (ties broken by LRU order)."""
        tier = stack.tiers[tier_idx]
        best_id, best_key = None, None
        for pos, b in enumerate(tier.block_ids()):
            key = (self.score(stack, b, tier_idx), pos)  # LRU-oldest loses ties
            if best_key is None or key < best_key:
                best_id, best_key = b, key
        return best_id
