"""Heat-driven block-ownership rebalancing for the cooperative peer tier.

Counterpart of ``repro/storage/rebalance.py``: host Python over the stacks'
logical-access ledgers (:meth:`~repro_torch.storage.tiers.TierStack.
access_counts`).  Per-block heat per shard is an exponentially decayed sum of
access deltas, and ownership is periodically migrated toward the shard that
touches each block, prioritised by ``heat × density`` (the paper's density
scoring: a block both hot and dense amortises its one resident copy over more
answered records), behind a hysteresis gate so ownership does not thrash.

Migration moves the ownership and the one resident copy
(:meth:`~repro_torch.storage.peer.PeerGroup.migrate`); bytes are relocated,
never re-read, so rebalancing under any schedule keeps the stack's byte
identity.  Appends invalidate migrated residents through the usual listener.
"""
from __future__ import annotations

import numpy as np

from repro_torch.storage.peer import PeerGroup


class HeatTracker:
    """Per-(shard, block) access heat from the stacks' access ledgers.

    Each :meth:`sample` reads every registered stack's access counts, takes
    the delta since the previous sample (an eviction resets a block's count;
    the delta clamps to the new count, never negative) and folds it into an
    exponentially decayed accumulator::

        heat[s][b] = decay * heat[s][b] + delta[s][b]

    Invalidation (append or compaction rewriting a block id) resets both the
    heat and the last-sample baseline of the dirtied ids, through the
    tracker's own listener on the group's store.
    """

    def __init__(self, group: PeerGroup, decay: float = 0.5):
        if not (0.0 <= decay < 1.0):
            raise ValueError("decay must be in [0, 1)")
        self.group = group
        self.decay = float(decay)
        self._last: list[dict[int, int]] = [{} for _ in range(group.n_shards)]
        self.heat: list[dict[int, float]] = [{} for _ in range(group.n_shards)]
        group._store.register_invalidation_listener(self._on_invalidate)

    def _on_invalidate(self, block_ids) -> None:
        """Forget dirtied ids everywhere: heat and the delta baseline."""
        for b in np.asarray(list(block_ids), dtype=np.int64).ravel():
            b = int(b)
            for sid in range(self.group.n_shards):
                self.heat[sid].pop(b, None)
                self._last[sid].pop(b, None)

    def sample(self) -> None:
        for sid, stack in enumerate(self.group.stacks):
            if stack is None:
                continue
            cur = stack.access_counts()
            last = self._last[sid]
            heat = self.heat[sid]
            for b in set(cur) | set(heat):
                c, l = cur.get(b, 0), last.get(b, 0)
                delta = c - l if c >= l else c  # count reset by eviction
                h = heat.get(b, 0.0) * self.decay + delta
                if h > 1e-9:
                    heat[b] = h
                elif b in heat:
                    del heat[b]
            self._last[sid] = cur

    def hottest_shard(self, block_id: int) -> tuple[int | None, float]:
        """``(shard, heat)`` of the shard touching ``block_id`` the most."""
        b = int(block_id)
        best, best_h = None, 0.0
        for sid in range(self.group.n_shards):
            h = self.heat[sid].get(b, 0.0)
            if h > best_h:
                best, best_h = sid, h
        return best, best_h


class OwnershipRebalancer:
    """Periodically migrate block ownership toward observed heat.

    Parameters
    ----------
    group : PeerGroup
        The cluster whose directory is rebalanced.
    tracker : HeatTracker | None
        Heat source (a fresh one with default decay if omitted).
    hysteresis : float
        A shard steals ownership only when its heat exceeds ``hysteresis ×``
        the current owner's.
    min_heat : float
        Ignore blocks whose hottest shard is below this (noise floor).
    max_moves : int | None
        Per-call migration budget; the hottest × densest candidates move
        first.  ``None`` moves every qualifying block.
    every : int
        :meth:`tick` cadence: one :meth:`rebalance` per ``every`` ticks.
    """

    def __init__(self, group: PeerGroup, tracker: HeatTracker | None = None,
                 hysteresis: float = 1.5, min_heat: float = 1.0,
                 max_moves: int | None = None, every: int = 1):
        self.group = group
        self.tracker = tracker or HeatTracker(group)
        self.hysteresis = float(hysteresis)
        self.min_heat = float(min_heat)
        self.max_moves = max_moves
        self.every = max(int(every), 1)
        self._ticks = 0
        self.moves_applied = 0  # lifetime count, for reporting

    # ------------------------------------------------------------------ score
    def _density(self, block_id: int) -> float:
        """Valid-record fraction of the block's resident slot (the paper's
        per-block density), read from the holder's pool; 1.0 when no copy is
        resident to inspect."""
        sid = self.group.locate(block_id)
        if sid is None:
            return 1.0
        tier = self.group._host_tier(sid)
        entry = tier.peek(int(block_id))
        if entry is None:
            return 1.0
        return float(tier._pool[2][entry[0]].cpu().numpy().mean())

    # -------------------------------------------------------------- rebalance
    def rebalance(self) -> int:
        """Sample heat and migrate qualifying blocks; returns moves applied."""
        self.tracker.sample()
        candidates: list[tuple[float, int, int]] = []
        blocks = set(self.group.owner)
        for heat in self.tracker.heat:
            blocks.update(heat)
        for b in blocks:
            best, best_h = self.tracker.hottest_shard(b)
            if best is None or best_h < self.min_heat:
                continue
            owner = self.group.owner_of(b)
            if best == owner:
                continue
            owner_h = self.tracker.heat[owner].get(b, 0.0)
            if best_h <= self.hysteresis * owner_h:
                continue
            candidates.append((best_h * self._density(b), b, best))
        candidates.sort(key=lambda c: (-c[0], c[1]))
        if self.max_moves is not None:
            candidates = candidates[: self.max_moves]
        applied = 0
        for _, b, to in candidates:
            if self.group.migrate(b, to):
                applied += 1
        self.moves_applied += applied
        return applied

    def tick(self) -> int:
        """Cadenced entry point: one :meth:`rebalance` per ``every`` calls."""
        self._ticks += 1
        if self._ticks % self.every:
            return 0
        return self.rebalance()
