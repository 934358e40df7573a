"""SLO admission for the batched serving path (BlinkDB-style bounded
response time).

Counterpart of ``repro/serving/admission.py``.  The
:class:`AdmissionController` holds queued requests under an explicit policy:

* requests **accumulate** while the queue is short and every deadline is in
  the future (larger waves share more fetches and plan-memo entries);
* a wave **launches** the moment it is full (``max_wave``), or as soon as
  the *oldest* request's latency SLO (``slo_s``) would otherwise be
  violated, whichever comes first; past the batching floor two probes may
  launch it early: the cost probe (its missed blocks price at or under
  ``cheap_cost_s``) and the residency probe (it would read nothing from the
  store);
* waves are FIFO, so no request starves.

The controller is host code with an injectable clock; it performs no I/O
and starts no thread.  Callers drive it with :meth:`AdmissionController.
poll` (one launch-ready wave or ``None``) or, in the continuous loop,
:meth:`AdmissionController.claim`; ``flush`` drains everything.  The probes
it calls run on the engine's device.

:func:`arbitrate_aggregate` is the third arbitration arm, which the online
aggregation imports: fetch more blocks, or answer now within the CI.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Latency/throughput trade of wave admission.

    ``slo_s`` — the most seconds a request may wait before its wave is
    forced out.  ``max_wave`` — the wave cap, and the eager-launch
    threshold.  ``min_wave`` — smaller waves wait for the deadline even when
    polled (1: a deadline launch always happens).  ``cheap_cost_s`` — with a
    ``cost_probe`` installed, a wave whose missed-block I/O prices at or
    under this many modeled seconds launches before its deadline; ``None``
    disables the gate.
    """

    slo_s: float = 0.05
    max_wave: int = 8
    min_wave: int = 1
    cheap_cost_s: float | None = None

    def __post_init__(self):
        if self.slo_s < 0:
            raise ValueError("slo_s must be >= 0")
        if self.max_wave < 1:
            raise ValueError("max_wave must be >= 1")
        if not (1 <= self.min_wave <= self.max_wave):
            raise ValueError("need 1 <= min_wave <= max_wave")
        if self.cheap_cost_s is not None and self.cheap_cost_s < 0:
            raise ValueError("cheap_cost_s must be >= 0 (or None)")


@dataclasses.dataclass
class AdmissionStats:
    submitted: int = 0
    served: int = 0
    waves: int = 0
    full_waves: int = 0  # launched because the wave filled
    deadline_waves: int = 0  # launched because the oldest SLO came due
    resident_waves: int = 0  # launched early: fully cache-resident (probe)
    cheap_waves: int = 0  # launched early: missed-block cost under the bar
    flush_waves: int = 0  # launched by an explicit flush barrier
    refill_waves: int = 0  # popped mid-wave into freed slots (continuous loop)
    max_wave_size: int = 0
    total_wait_s: float = 0.0
    max_wait_s: float = 0.0
    slo_violations: int = 0  # waits beyond slo_s (flush/overload artifacts)

    @property
    def mean_wait_s(self) -> float:
        return self.total_wait_s / self.served if self.served else 0.0

    @property
    def mean_wave_size(self) -> float:
        return self.served / self.waves if self.waves else 0.0


class AdmissionController:
    """FIFO admission queue with the SLO-deadline / full-wave launch policy.

    ``clock`` is the time source (injectable: tests drive admission in
    virtual time).  ``residency_probe`` (:func:`repro_torch.storage.
    residency.make_residency_probe`) answers whether a pending wave would be
    served from the cache tiers alone, without side effects;
    ``cost_probe`` (:func:`repro_torch.storage.prefetch.
    make_missed_cost_probe`) prices its missed blocks, or returns ``None``
    when it cannot.  ``obs`` (a :class:`repro_torch.obs.TraceRecorder`)
    receives one ``admission.launch`` event a pop, with the launch reason
    and each request's queue wait.

    :meth:`poll` and :meth:`flush_one` hand out one wave at a time, which
    the caller runs before asking again; waves not yet popped stay queued,
    so :meth:`requeue_front` can restore a failed wave without losing later
    requests.
    """

    def __init__(
        self,
        policy: AdmissionPolicy | None = None,
        clock: Callable[[], float] = time.monotonic,
        residency_probe: Callable[[list], bool] | None = None,
        cost_probe: Callable[[list], float | None] | None = None,
        obs=None,
    ):
        self.policy = policy or AdmissionPolicy()
        self.clock = clock
        self.stats = AdmissionStats()
        self.obs = obs
        self.residency_probe = residency_probe
        self.cost_probe = cost_probe
        # the cheap gate's last quote (None until the probe ran, or when it
        # could not price): the plan ledger's audit trail reads it
        self.last_cost_price_s: float | None = None
        self._pending: "deque[tuple[Any, float]]" = deque()  # (request, t_submit)
        self._last_pop: dict | None = None  # rollback record for requeue_front

    # ----------------------------------------------------------------- state
    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending(self) -> int:
        return len(self._pending)

    def next_deadline(self) -> float | None:
        """``t_submit(oldest) + slo_s``, or ``None`` when the queue is empty:
        when the next :meth:`poll` is due."""
        if not self._pending:
            return None
        return self._pending[0][1] + self.policy.slo_s

    # ---------------------------------------------------------------- intake
    def submit(self, request: Any) -> Any:
        """Enqueue ``request`` (opaque here) stamped at ``clock()``; returns it."""
        self._pending.append((request, self.clock()))
        self.stats.submitted += 1
        return request

    def requeue_front(self, requests) -> None:
        """Put failed requests back at the head of the queue, in order.  Their
        wait clocks restart and ``submitted`` is not counted again; each one
        that came from the last pop has its launch accounting (served, wait,
        violation) rolled back, and only when the whole pop comes back does
        the wave itself unwind (``waves``, its reason's counter, the
        max-wait and max-size marks): a partly failed wave did run."""
        requests = list(requests)
        lp = self._last_pop
        if lp is not None:
            s = self.stats
            for r in requests:
                rec = lp["waits"].pop(id(r), None)
                if rec is None:
                    continue
                wait, violated = rec
                s.served -= 1
                s.total_wait_s -= wait
                s.slo_violations -= int(violated)
            if not lp["waits"]:  # the whole pop came back: the wave never ran
                s.waves -= 1
                s.max_wait_s = lp["prev_max_wait"]
                s.max_wave_size = lp["prev_max_size"]
                setattr(s, lp["reason"], getattr(s, lp["reason"]) - 1)
                self._last_pop = None
        now = self.clock()
        for r in reversed(requests):
            self._pending.appendleft((r, now))

    # ---------------------------------------------------------------- launch
    def _pop_wave(self, n: int, now: float, reason: str) -> list[Any]:
        wave = []
        waits: dict[int, tuple[float, bool]] = {}  # id(req) -> (wait, violated)
        wait_sum = 0.0
        violations = 0
        prev_max_wait = self.stats.max_wait_s
        prev_max_size = self.stats.max_wave_size
        for _ in range(min(n, len(self._pending))):
            req, t_sub = self._pending.popleft()
            wait = max(now - t_sub, 0.0)
            wait_sum += wait
            self.stats.max_wait_s = max(self.stats.max_wait_s, wait)
            violated = wait > self.policy.slo_s + 1e-9
            if violated:
                violations += 1
            waits[id(req)] = (wait, violated)
            wave.append(req)
        self.stats.total_wait_s += wait_sum
        self.stats.slo_violations += violations
        self.stats.served += len(wave)
        self.stats.waves += 1
        self.stats.max_wave_size = max(self.stats.max_wave_size, len(wave))
        setattr(self.stats, reason, getattr(self.stats, reason) + 1)
        self._last_pop = dict(waits=waits, reason=reason,
                              prev_max_wait=prev_max_wait, prev_max_size=prev_max_size)
        if self.obs is not None and wave:
            m = self.obs.metrics
            for w, _ in waits.values():
                m.observe("admission.wait_s", w)
            self.obs.event(
                "admission.launch", reason=reason, wave_size=len(wave),
                rids=[getattr(r, "rid", None) for r in wave],
                waits_s=[round(w, 9) for w, _ in waits.values()],
                violations=violations,
            )
        return wave

    def peek_pending(self, n: int | None = None) -> list[Any]:
        """The next ``n`` pending requests (all when ``None``), oldest first,
        without popping: the prefetcher's and the probes' input."""
        if n is None:
            return [r for r, _ in self._pending]
        return [r for r, _ in list(self._pending)[:n]]

    def _launch_reason(self, now: float) -> str | None:
        """The stats counter a launch right ``now`` would book under, or
        ``None`` to keep accumulating.  Priority: full wave → deadline →
        cheap (cost probe) → resident (residency probe); the probes run last
        and only past the batching floor, so a wave that launches anyway
        pays no probe."""
        p = self.policy
        if len(self._pending) >= p.max_wave:
            return "full_waves"
        deadline = self.next_deadline()
        if deadline is not None and now >= deadline and len(self._pending) >= p.min_wave:
            return "deadline_waves"
        if not self._pending or len(self._pending) < p.min_wave:
            return None
        if self.cost_probe is not None and p.cheap_cost_s is not None:
            c = self.cost_probe(self.peek_pending(p.max_wave))
            self.last_cost_price_s = c
            if c is not None and c <= p.cheap_cost_s:
                return "cheap_waves"
        if self.residency_probe is not None and self.residency_probe(
            self.peek_pending(p.max_wave)
        ):
            return "resident_waves"
        return None

    def poll(self, now: float | None = None) -> list[Any] | None:
        """One launch decision: the launched wave (at most ``max_wave``, run
        it before polling again), or ``None`` to keep accumulating.  ``now``
        defaults to ``clock()``."""
        now = self.clock() if now is None else now
        reason = self._launch_reason(now)
        if reason is None:
            return None
        return self._pop_wave(self.policy.max_wave, now, reason)

    def claim(
        self,
        n: int,
        now: float | None = None,
        *,
        mid_wave: bool = False,
        force: bool = False,
    ) -> list[Any]:
        """Pop up to ``min(n, max_wave)`` requests into a slot pool's ``n``
        free slots (0+): the continuous loop's intake.  ``mid_wave=True``
        claims unconditionally (a round is running; freed slots are pure
        capacity) and books under ``refill_waves``; ``force=True`` claims
        unconditionally at an idle flush barrier (``flush_waves``); otherwise
        the launch policy gates the claim, so an idle pool accumulates as the
        drain path does."""
        if n <= 0 or not self._pending:
            return []
        now = self.clock() if now is None else now
        n = min(n, self.policy.max_wave)
        if mid_wave:
            reason = "refill_waves"
        elif force:
            reason = "flush_waves"
        else:
            reason = self._launch_reason(now)
            if reason is None:
                return []
        return self._pop_wave(n, now, reason)

    def drain_ready(self, now: float | None = None) -> list[list[Any]]:
        """Launch every wave that is ready right now (0+ waves)."""
        waves = []
        while True:
            w = self.poll(now)
            if not w:
                return waves
            waves.append(w)

    def flush_one(self, now: float | None = None) -> list[Any] | None:
        """Pop ONE wave (at most ``max_wave``), deadline or not; ``None``
        when empty.  Prefer it to :meth:`flush` when waves are run one by
        one, so the waves not yet popped survive a failure."""
        if not self._pending:
            return None
        now = self.clock() if now is None else now
        return self._pop_wave(self.policy.max_wave, now, "flush_waves")

    def flush(self, now: float | None = None) -> list[list[Any]]:
        """Barrier: launch everything pending in FIFO waves of ``max_wave``."""
        now = self.clock() if now is None else now
        waves = []
        while self._pending:
            waves.append(self.flush_one(now))
        return waves


def arbitrate_aggregate(
    *,
    halfwidth: float,
    error_slo: float | None = None,
    deadline_s: float | None = None,
    spent_s: float = 0.0,
    next_cost_s: float = 0.0,
    predicted_halfwidth: float | None = None,
    max_s_per_width: float | None = None,
) -> str | None:
    """Decide after every fold whether a seated aggregate stops, priced in
    the modeled seconds of :func:`repro_torch.storage.prefetch.
    effective_block_cost`.  Returns the leave reason, or ``None`` to keep
    fetching:

    * ``"ci"`` — the error SLO is met: the 95% CI half-width closed;
    * ``"deadline"`` — spent + the next chunk's modeled I/O would overrun
      ``deadline_s``: answer now with the best estimate (never start a
      chunk you cannot afford);
    * ``"diminishing"`` — optional marginal-value cutoff: the next chunk's
      modeled seconds per expected unit of CI-width reduction exceed
      ``max_s_per_width``.
    """
    if error_slo is not None and halfwidth <= error_slo:
        return "ci"
    if deadline_s is not None and spent_s + next_cost_s > deadline_s:
        return "deadline"
    if (
        max_s_per_width is not None
        and predicted_halfwidth is not None
        and halfwidth != float("inf")
    ):
        gain = halfwidth - predicted_halfwidth
        if gain <= 0.0 or next_cost_s / gain > max_s_per_width:
            return "diminishing"
    return None
