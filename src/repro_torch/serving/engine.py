"""Wave-batched and continuous serving over prefill + decode_step and any-k.

Counterpart of ``repro/serving/engine.py``.

**LM waves** (:meth:`ServeEngine.run_until_drained`): requests are drained
from the queue in waves of ``max_slots``; each wave's prompts are
left-padded to a common length (``pad_id`` padding, attended as it is, as in
the reference), prefilled as one batch, then decoded in lock-step, one
``decode_step`` per tick for the whole wave.  Rows are independent, so
finished rows simply stop sampling.  Where the reference ``jax.jit``-
compiles prefill and decode, the engine here calls
:func:`~repro_torch.models.decode.prefill` and :func:`~repro_torch.models.
decode.decode_step` directly under ``torch.inference_mode()``.  It prefills
with ``impl="kernel"`` by default, so on the card every attention block goes
through the flash-attention kernel (#8) and every Mamba block through the
SSD kernel (#9); the reference's engine prefills on its default ``"xla"``
path.  ``impl="plain"`` is for tests and ``chip_smoke.py``, to compare on the
card.  Each wave's host-clock times land in :attr:`ServeEngine.wave_stats`,
and each request records the gap between its top two logits at every token
(``Request.top2_gap``), so a comparison of two runs can tell a near-tie from
a wrong token.

**Exemplar waves** (the NeedleTail tie-in): :meth:`ServeEngine.
submit_exemplar_request` admits a few-shot lookup (k records matching
predicates) through an SLO :class:`~repro_torch.serving.admission.
AdmissionController`; :meth:`ServeEngine.pump_exemplar_requests` runs the
waves that are ready (full, due, cheap or resident) and
:meth:`ServeEngine.drain_exemplar_requests` all of them, each as ONE
``any_k_batch`` call: the device-resident wave with ``exemplar_device=True``
(one packed device→host transfer a round), the host-mirror loop otherwise,
over the λ-sharded wave when a mesh is attached (``exemplar_mesh``).

**Continuous batching** (:meth:`ServeEngine.step` /
:meth:`ServeEngine.run_continuous`): a :class:`SlotScheduler` owns a fixed
pool of ``max_slots`` slots per request kind; requests join between rounds
and leave the instant they are satisfied, and freed slots are refilled from
the admission queue mid-wave (``AdmissionController.claim``):

* exemplar slots ride a :class:`~repro_torch.core.multi_query.DeviceWave`
  (``exemplar_device=True``: joiners combined and seated on the card in one
  launch a tick, one planning round a tick) or the host-mirror round; each
  request's rows equal a solo ``any_k``'s;
* aggregate slots each hold an :class:`~repro_torch.core.online_agg.
  OnlineAggregator`; one shared ``ensure`` reads the tick's chunk union and
  :func:`~repro_torch.serving.admission.arbitrate_aggregate` decides per
  slot whether to answer now;
* LM slots share one decode cache; a queued prompt no longer than the
  position counter is left-padded to exactly that many positions,
  prefilled as its own batch and its cache rows grafted into the live
  cache (:func:`_merge_lm_cache_rows`), so its tokens equal a solo wave's.

The residency probe (``exemplar_residency``), the cost-fed launch gate
(``AdmissionPolicy.cheap_cost_s``), the tier prefetcher
(``exemplar_prefetch``) and periodic recalibration (``recalibrate_every``)
are wired in as the reference wires them.  ``obs`` (a
:class:`~repro_torch.obs.TraceRecorder`) is shared with admission, the
any-k engine and its tier stack; every pool writes the closed
``last_wave_stats`` schema (:mod:`repro_torch.obs.wave_stats`).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import decode as D
from repro_torch.models.layers import check_impl
from repro_torch.models.lm import LM
from repro_torch.obs.trace import span_or_null
from repro_torch.obs.wave_stats import make_wave_stats, record_wave_metrics
from repro_torch.serving.admission import AdmissionController, AdmissionPolicy


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [P] int32
    max_new_tokens: int = 32
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # top-1 minus top-2 logit at each emitted token
    top2_gap: list[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ExemplarRequest:
    """Queued few-shot exemplar lookup: k records matching the predicates."""

    rid: int
    predicates: Any
    k: int
    op: str = "and"
    result: Any = None  # QueryResult once the wave it rode in has run
    done: bool = False


@dataclasses.dataclass
class AggregateRequest:
    """Queued online aggregate (the BlinkDB contract): mean/total of
    ``measure`` over the predicates, answered the moment its 95% CI
    half-width closes under ``error_slo`` or its modeled-I/O ``deadline_s``
    would be overrun by the next chunk; with neither, it runs to
    ``max_rounds`` or the design's end."""

    rid: int
    predicates: Any
    measure: int
    k: int  # design-split seed (chosen-arm size), not a row target
    op: str = "and"
    error_slo: float | None = None  # target CI half-width on the mean
    deadline_s: float | None = None  # modeled demand-I/O budget
    alpha: float = 0.3
    estimator: str = "ratio"
    algo: str = "threshold"
    seed: int = 0
    chunk_blocks: int = 8
    max_rounds: int = 64
    result: Any = None  # final Estimate once answered
    stream: list = dataclasses.field(default_factory=list)  # per-round Estimates
    reason: str | None = None  # "ci" | "deadline" | "diminishing" | "exhausted" | "budget"
    rounds: int = 0
    spent_io_s: float = 0.0
    done: bool = False


def pad_wave(wave: list[Request], max_slots: int, pad_id: int) -> np.ndarray:
    """``[max_slots, plen]`` int32 tokens: each prompt left-padded so the
    wave's last prompt tokens align; unused rows are all padding."""
    plen = max(len(r.prompt) for r in wave)
    toks = np.full((max_slots, plen), pad_id, np.int32)
    for b, r in enumerate(wave):
        toks[b, plen - len(r.prompt):] = r.prompt
    return toks


def _merge_lm_cache_rows(cache: D.Cache, joined: D.Cache, row_mask: np.ndarray) -> D.Cache:
    """Graft the joiners' batch rows of ``joined`` (a freshly prefilled
    cache) into the live decode cache, in place.  The port's cache is a list
    of per-layer dicts whose every leaf has the batch at axis 0 (``k``/``v``
    of a ring or a full cache, ``conv``, ``ssd``); the ``[B]`` mask becomes
    one index on the card, and each leaf takes those rows by one
    ``index_copy_``.  Incumbent rows are untouched, and nothing of
    ``joined`` stays referenced."""
    rows_np = np.flatnonzero(np.asarray(row_mask, bool))
    if not rows_np.size:
        return cache
    rows = None
    for live, new in zip(cache, joined):
        for key, a in live.items():
            b = new[key]
            if hasattr(a, "to_local"):  # DTensors of one placement: each rank's own rows
                a, b, local_rows = a.to_local(), b.to_local(), _local_rows(live[key], rows_np)
                if local_rows.size:
                    r = torch.from_numpy(local_rows).to(a.device)
                    a.index_copy_(0, r, b.index_select(0, r).to(a.dtype))
                continue
            if rows is None:
                rows = torch.from_numpy(rows_np).to(a.device)
            a.index_copy_(0, rows, b.index_select(0, rows).to(a.dtype))
    return cache


def _local_rows(dt, rows: np.ndarray) -> np.ndarray:
    """The batch rows ``rows`` that this rank holds of DTensor ``dt``, as
    indices into its local tensor."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(dt.shape, dt.device_mesh,
                                                          dt.placements)
    lo = offset[0]
    return rows[(rows >= lo) & (rows < lo + shape[0])] - lo


class SlotScheduler:
    """A fixed pool of serving slots with join/leave bookkeeping.

    Every round ticks ``busy_slot_rounds`` by the occupied slots, so
    :attr:`occupancy` is the busy-slot fraction per round.  Slot items are
    opaque (the exemplar loop stores ``(request, refill state)`` pairs).
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        self.slots: list[Any] = [None] * n_slots
        self.joins = 0
        self.leaves = 0
        self.rounds = 0
        self.busy_slot_rounds = 0

    @property
    def busy(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def busy_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def join(self, item: Any) -> int:
        """Seat ``item`` in the lowest free slot; returns the slot index."""
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = item
                self.joins += 1
                return i
        raise ValueError("no free slot")

    def leave(self, slot: int) -> Any:
        item = self.slots[slot]
        if item is None:
            raise ValueError(f"slot {slot} is already free")
        self.slots[slot] = None
        self.leaves += 1
        return item

    def tick(self) -> None:
        """Account one executed round at the current occupancy."""
        self.rounds += 1
        self.busy_slot_rounds += self.busy

    @property
    def occupancy(self) -> float:
        """Busy-slot fraction per executed round, pool lifetime."""
        if self.rounds == 0:
            return 0.0
        return self.busy_slot_rounds / (self.rounds * self.n_slots)


class _ExemplarLoop:
    """State of the continuous exemplar loop: the slot pool, the device
    wave (``device=True``) and the loop-lifetime first-touch ledger.
    Rebuilt when the serving engine is pointed at another any-k engine; the
    device wave alone is rebuilt when the engine's store is swapped."""

    def __init__(self, engine, n_slots: int, device: bool):
        self.engine = engine
        self.sched = SlotScheduler(n_slots)
        self.device = device
        self.store = engine.store
        self.dwave = None
        if device:
            self._build_dwave()
        self.touched: list[int] = []
        self.touched_set: set[int] = set()

    def _build_dwave(self) -> None:
        from repro_torch.core.multi_query import DeviceWave

        self.dwave = DeviceWave(self.engine, self.sched.n_slots, default_algo="auto",
                                planner=self.engine.distributed)
        self.store = self.engine.store

    def sync_store(self) -> None:
        """The store was swapped (an append grew it): rebuild the device
        wave at the new λ and re-seat the occupants with their exclusions
        and needs; their rows recompute on the next join flush."""
        if self.engine.store is self.store:
            return
        if self.device:
            self._build_dwave()
            for slot in self.sched.busy_slots():
                self.dwave.join(slot, self.sched.slots[slot][1])
        else:
            self.store = self.engine.store


class _AggregateLoop:
    """State of the continuous online-aggregation loop: one slot pool of
    ``(AggregateRequest, OnlineAggregator)`` pairs."""

    def __init__(self, engine, n_slots: int):
        self.engine = engine
        self.sched = SlotScheduler(n_slots)


class ServeEngine:
    """LM, exemplar and aggregate serving.

    ``cfg=None, model=None`` serves exemplars and aggregates only.  The
    engine runs on ``device`` (``"cuda"`` by default; ``"cpu"`` only when
    asked); the any-k engines handed to its exemplar and aggregate methods
    must live there too.  ``impl`` picks the LM prefill path.  ``rules``
    (a :class:`~repro_torch.models.layers.MeshRules`) serves the LM over a
    mesh, as the reference's ``rules`` does: the model's parameters are
    DTensors (``distributed.sharding.distribute_params``), every rank runs
    the same engine with the same requests, prefill and decode run under
    ``rules`` (the cache placed by ``cache_specs``), and each rank samples
    from the whole logits.  The rest follows the reference: ``exemplar_policy`` / ``aggregate_policy`` (the
    admission policies, ``max_wave = max_slots`` by default) on ``clock``;
    ``exemplar_mesh`` attached to the any-k engine on its first wave;
    ``exemplar_device`` (the device-resident wave), ``exemplar_residency``
    (the residency probe), ``exemplar_prefetch`` (a tier prefetcher in the
    continuous loop), ``recalibrate_every`` (refit the cost models every N
    exemplar ticks) and ``obs``.
    """

    def __init__(
        self,
        cfg: ArchConfig | None,
        model: LM | None,
        max_slots: int = 4,
        max_seq: int = 256,
        eos_id: int | None = None,
        pad_id: int = 0,
        impl: str = "kernel",
        device: str | torch.device = "cuda",
        rules=None,
        exemplar_policy: AdmissionPolicy | None = None,
        clock=time.monotonic,
        exemplar_mesh=None,
        exemplar_device: bool = False,
        exemplar_residency: bool = False,
        exemplar_prefetch: bool = False,
        aggregate_policy: AdmissionPolicy | None = None,
        recalibrate_every: int = 0,
        obs=None,
    ):
        check_impl(impl)
        self.device = resolve_device(device)
        if (cfg is None) != (model is None):
            raise ValueError("give both cfg and model, or neither (exemplar-only serving)")
        if model is not None:
            if model.device != self.device:
                raise ValueError(f"the model lies on {model.device}, the engine on {self.device}")
            if model.cfg != cfg:
                raise ValueError("the model was built for another config")
        self.cfg = cfg
        self.model = model
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.impl = impl
        self.rules = rules
        self.exemplar_mesh = exemplar_mesh
        self.exemplar_device = bool(exemplar_device)
        # the residency probe peeks the host-mirror plan memo: device waves
        # write none, so with exemplar_device=True alone it never fires
        self.exemplar_residency = bool(exemplar_residency)
        self.exemplar_prefetch = bool(exemplar_prefetch)
        self.recalibrate_every = int(recalibrate_every)
        self._ticks_since_cal = 0
        #: the closed-schema ledger of the last wave any pool ran
        self.last_wave_stats: dict | None = None
        self.obs = obs
        self.queue: deque[Request] = deque()
        self.exemplar_queue: deque[ExemplarRequest] = deque()  # the legacy intake
        self.exemplar_admission = AdmissionController(
            exemplar_policy or AdmissionPolicy(max_wave=max_slots), clock=clock, obs=obs)
        self.aggregate_admission = AdmissionController(
            aggregate_policy or AdmissionPolicy(max_wave=max_slots), clock=clock, obs=obs)
        # optional marginal-value cutoff of the answer-now arbitration
        # (modeled seconds per unit of expected CI-width reduction)
        self.aggregate_max_s_per_width: float | None = None
        self._rid = itertools.count()
        self._exemplar_loop: _ExemplarLoop | None = None
        self._aggregate_loop: _AggregateLoop | None = None
        self._residency_probe = None  # (engine, probe)
        self._cost_probe = None  # (engine, probe)
        self._prefetcher = None  # (engine, TierPrefetcher)
        self._lm: dict | None = None  # the continuous LM wave: cache, pos, slots
        #: per LM wave of run_until_drained: size, prompt_len, prefill_s,
        #: decode_steps, decode_s, new_tokens (host clock)
        self.wave_stats: list[dict] = []
        #: per continuous LM tick: prefill_s (first wave or joiners),
        #: joiners, decode_s, active (host clock)
        self.lm_tick_stats: list[dict] = []

    # --------------------------------------------------------------- LM waves
    def submit(self, prompt, max_new_tokens: int = 32) -> Request:
        req = Request(next(self._rid), np.asarray(prompt, np.int32), max_new_tokens)
        self.queue.append(req)
        if self.obs is not None:
            self.obs.event("request.submit", rid=req.rid, kind="lm")
            self.obs.metrics.inc("serve.lm.submitted")
        return req

    def _next_wave(self) -> list[Request]:
        wave = []
        while self.queue and len(wave) < self.max_slots:
            wave.append(self.queue.popleft())
        return wave

    def _greedy(self, logits: torch.Tensor, slots: list, rows) -> np.ndarray:
        """Argmax tokens of ``rows``, appended to ``slots[b]``; records each
        row's top-2 logit gap.  One device→host copy per call."""
        if self.rules is not None:
            logits = logits.full_tensor()
        top = torch.topk(logits, 2, dim=-1).values
        packed = torch.stack([torch.argmax(logits, dim=-1).to(top.dtype),
                              top[:, 0] - top[:, 1]], dim=1).cpu().numpy()
        nxt = packed[:, 0].astype(np.int64)
        for b in rows:
            slots[b].out_tokens.append(int(nxt[b]))
            slots[b].top2_gap.append(float(packed[b, 1]))
        return nxt

    def _prefill(self, toks: np.ndarray):
        return D.prefill(self.model, torch.from_numpy(toks).to(self.device), impl=self.impl,
                         max_seq=self.max_seq, rules=self.rules)

    def _decode(self, cache, slots: list, active, pos: int):
        cur = np.full(self.max_slots, self.pad_id, np.int64)
        for b in active:
            cur[b] = slots[b].out_tokens[-1]
        logits, cache = D.decode_step(self.model, cache, torch.from_numpy(cur).to(self.device),
                                      pos, rules=self.rules)
        return self._greedy(logits, slots, sorted(active)), cache

    def _finished(self, r: Request, tok: int) -> bool:
        return (self.eos_id is not None and tok == self.eos_id) or \
            len(r.out_tokens) >= r.max_new_tokens

    @torch.inference_mode()
    def _run_wave(self, wave: list[Request]) -> None:
        n = len(wave)
        toks = pad_wave(wave, self.max_slots, self.pad_id)
        plen = toks.shape[1]
        t0 = time.perf_counter()
        last, cache = self._prefill(toks)
        self._greedy(last, wave, range(n))
        t1 = time.perf_counter()
        pos = plen
        steps = 0
        active = set(range(n))
        while active and pos < self.max_seq - 1:
            nxt, cache = self._decode(cache, wave, active, pos)
            pos += 1
            steps += 1
            for b in list(active):
                if self._finished(wave[b], int(nxt[b])):
                    wave[b].done = True
                    active.discard(b)
        for r in wave:
            r.done = True
        self.wave_stats.append({
            "size": n, "prompt_len": plen, "prefill_s": t1 - t0, "decode_steps": steps,
            "decode_s": time.perf_counter() - t1,
            "new_tokens": sum(len(r.out_tokens) for r in wave),
        })
        self._note_lm_wave(n)

    def run_until_drained(self) -> list[Request]:
        done = []
        while self.queue:
            wave = self._next_wave()
            self._run_wave(wave)
            done.extend(wave)
        return done

    # ------------------------------------------------ NeedleTail integration
    @staticmethod
    def select_exemplars(engine, predicates, k: int):
        """any-k retrieval of k cached exemplars matching request predicates."""
        return engine.any_k(predicates, k=k, algo="auto")

    def _exemplar_admission(self) -> AdmissionController:
        """The exemplar controller, after moving anything pushed straight
        onto the legacy ``exemplar_queue`` deque into its FIFO."""
        adm = self.exemplar_admission
        while self.exemplar_queue:
            adm.submit(self.exemplar_queue.popleft())
        return adm

    def _check_engine(self, engine) -> None:
        dev = getattr(engine, "device", None)
        if dev is not None and dev != self.device:
            raise ValueError(f"the any-k engine lies on {dev}, the serving engine on "
                             f"{self.device}")

    def _wire_obs(self, engine) -> None:
        """Share this engine's recorder with the any-k engine, its tier
        stack and the stack's peer group; never replace a recorder one of
        them already has."""
        obs = self.obs
        if obs is None:
            return
        if getattr(engine, "obs", None) is None:
            engine.obs = obs
        bc = getattr(engine, "block_cache", None)
        if bc is not None and getattr(bc, "obs", "absent") is None:
            bc.obs = obs
        group = getattr(getattr(bc, "peer_tier", None), "group", None)
        if group is not None and group.obs is None:
            group.obs = obs

    def _note_wave_stats(self) -> None:
        """Mirror ``last_wave_stats`` into the recorder's metrics registry."""
        if self.obs is not None and self.last_wave_stats is not None:
            record_wave_metrics(self.obs.metrics, self.last_wave_stats)

    def _install_admission_probes(self, engine, adm: AdmissionController) -> None:
        """The residency probe (``exemplar_residency``) and the cost probe
        (armed by ``cheap_cost_s``), one per any-k engine, kept across ticks
        (they memoize template row bytes); uninstalled when turned off."""
        if self.exemplar_residency:
            if self._residency_probe is None or self._residency_probe[0] is not engine:
                from repro_torch.storage.residency import make_residency_probe

                self._residency_probe = (engine, make_residency_probe(engine))
            adm.residency_probe = self._residency_probe[1]
        elif self._residency_probe is not None:
            self._residency_probe = None
            adm.residency_probe = None
        if adm.policy.cheap_cost_s is not None:
            if self._cost_probe is None or self._cost_probe[0] is not engine:
                from repro_torch.storage.prefetch import make_missed_cost_probe

                self._cost_probe = (engine, make_missed_cost_probe(engine))
            adm.cost_probe = self._cost_probe[1]
        elif self._cost_probe is not None:
            self._cost_probe = None
            adm.cost_probe = None

    def _tier_prefetcher(self, engine):
        """The loop's :class:`~repro_torch.storage.prefetch.TierPrefetcher`,
        one per any-k engine; ``None`` unless ``exemplar_prefetch``."""
        if not self.exemplar_prefetch:
            return None
        if self._prefetcher is None or self._prefetcher[0] is not engine:
            from repro_torch.storage.prefetch import TierPrefetcher

            self._prefetcher = (engine, TierPrefetcher(engine))
        return self._prefetcher[1]

    def _attach_mesh(self, engine) -> None:
        if self.exemplar_mesh is not None and getattr(engine, "distributed", None) is None:
            engine.attach_mesh(self.exemplar_mesh)

    def submit_exemplar_request(self, predicates, k: int, op: str = "and") -> ExemplarRequest:
        """Admit an exemplar lookup under the SLO policy; it rides in the
        next wave that launches."""
        req = ExemplarRequest(next(self._rid), predicates, k, op)
        if self.obs is not None:
            self.obs.event("request.submit", rid=req.rid, kind="exemplar", k=k)
            self.obs.metrics.inc("serve.exemplar.submitted")
        self._exemplar_admission().submit(req)
        return req

    def _run_exemplar_wave(self, engine, wave: list[ExemplarRequest]) -> None:
        from repro_torch.core.multi_query import BatchQuery

        self._attach_mesh(engine)
        try:
            batch = engine.any_k_batch([BatchQuery(r.predicates, r.k, r.op) for r in wave],
                                       algo="auto", device=self.exemplar_device)
        except Exception:
            # put the wave back so no admitted request is lost
            self._exemplar_admission().requeue_front(wave)
            raise
        apr = batch.active_per_round or []
        occ = sum(apr) / (len(apr) * max(self.max_slots, 1)) if apr else 0.0
        self.last_wave_stats = make_wave_stats(
            "exemplar",
            wave_size=len(wave),
            rounds=batch.rounds,
            device_transfers=batch.device_transfers,
            store_blocks_fetched=batch.store_blocks_fetched,
            cache_hits=batch.cache_hits,
            unique_blocks=int(batch.unique_blocks_fetched.size),
            tiers=batch.tier_stats,
            slot_occupancy=min(occ, 1.0),
            modeled_store_io_s=batch.modeled_store_io_s,
            pending=self.exemplar_admission.pending,
        )
        self._note_wave_stats()
        for req, res in zip(wave, batch.results):
            req.result = res
            req.done = True
            if self.obs is not None:
                self.obs.event("request.done", rid=req.rid, kind="exemplar",
                               rounds=res.plan_rounds, records=res.num_records)

    def pump_exemplar_requests(self, engine, now: float | None = None) -> list[ExemplarRequest]:
        """Launch every wave that is ready under the SLO policy, one
        ``any_k_batch`` call each; returns the requests completed.  Waves
        not yet popped stay queued if one fails."""
        self._check_engine(engine)
        adm = self._exemplar_admission()
        self._install_admission_probes(engine, adm)
        done: list[ExemplarRequest] = []
        while True:
            wave = adm.poll(now)
            if not wave:
                return done
            self._run_exemplar_wave(engine, wave)
            done.extend(wave)

    def drain_exemplar_requests(self, engine) -> list[ExemplarRequest]:
        """Flush barrier: launch everything pending, deadlines or not, in FIFO
        waves of the policy's ``max_wave``, one ``any_k_batch`` call each."""
        self._check_engine(engine)
        adm = self._exemplar_admission()
        done: list[ExemplarRequest] = []
        while True:
            wave = adm.flush_one()
            if not wave:
                return done
            self._run_exemplar_wave(engine, wave)
            done.extend(wave)

    # ------------------------------------------------- continuous batching
    def exemplar_tick(self, engine, now: float | None = None,
                      drain: bool = False) -> list[ExemplarRequest]:
        """One round of the continuous exemplar loop: refill freed slots from
        the admission queue (mid-wave when the pool is busy; under the launch
        policy when idle, or unconditionally with ``drain``), run ONE refill
        round, and retire every satisfied slot.  Each request's rows equal a
        solo ``any_k``'s; ``last_wave_stats`` carries this round's ledger.
        Returns the requests completed this tick."""
        self._check_engine(engine)
        self._wire_obs(engine)
        obs = self.obs
        if obs is None:
            return self._exemplar_tick_body(engine, now, drain)
        with obs.span("serve.exemplar_tick") as sp:
            done = self._exemplar_tick_body(engine, now, drain)
            sp.set(completed=len(done))
        return done

    def _end_exemplar_tick(self, done: list[ExemplarRequest]) -> list[ExemplarRequest]:
        """The tick's last step, inside its last span: one ``request.done``
        event a completed request.  Returns ``done``."""
        obs = self.obs
        if obs is not None:
            for req in done:
                r = req.result
                obs.event("request.done", rid=req.rid, kind="exemplar",
                          rounds=getattr(r, "plan_rounds", 0),
                          records=getattr(r, "num_records", 0))
        return done

    def _claim(self, adm: AdmissionController, sched: SlotScheduler, now, drain: bool) -> list:
        free = sched.free_slots()
        if not free or not adm.pending:
            return []
        if sched.busy:
            return adm.claim(len(free), now, mid_wave=True)
        if drain:
            return adm.claim(len(free), now, force=True)
        return adm.claim(len(free), now)

    def _exemplar_tick_body(self, engine, now, drain: bool) -> list[ExemplarRequest]:
        """Traced, the tick's host steps are spans in turn: ``tick.claim``,
        the round (``plan.device_round`` or ``plan.round``, then
        ``wave.execute``) and ``tick.retire``; the last of them to run ends
        with the completed requests' ``request.done`` events."""
        from repro_torch.core.multi_query import (
            BatchQuery, _execute_wave, _union, finalize_query_result, new_query_state,
            plan_round_host,
        )

        obs = self.obs
        with span_or_null(obs, "tick.claim"):
            adm = self._exemplar_admission()
            self._install_admission_probes(engine, adm)
            if self.recalibrate_every and hasattr(engine, "recalibrate"):
                self._ticks_since_cal += 1
                if self._ticks_since_cal >= self.recalibrate_every:
                    engine.recalibrate()
                    self._ticks_since_cal = 0
            self._attach_mesh(engine)
            loop = self._exemplar_loop
            if (loop is None or loop.engine is not engine
                    or loop.sched.n_slots != self.max_slots
                    or loop.device != self.exemplar_device):
                loop = self._exemplar_loop = _ExemplarLoop(engine, self.max_slots,
                                                           self.exemplar_device)
            loop.sync_store()
            sched = loop.sched
            done: list[ExemplarRequest] = []
            for req in self._claim(adm, sched, now, drain):
                st = new_query_state(BatchQuery(req.predicates, req.k, req.op))
                if st.done:  # k <= 0: satisfied with zero rows, never seats
                    req.result = finalize_query_result(engine, st)
                    req.done = True
                    done.append(req)
                    continue
                slot = sched.join((req, st))
                if loop.dwave is not None:
                    loop.dwave.join(slot, st)
            # prefetch overlap: warm the still-pending requests' predicted round-0
            # union now; its reads land outside the demand window below
            pf = self._tier_prefetcher(engine)
            if pf is not None:
                pf.drain()
                pf.kick(adm.peek_pending(self.max_slots))
            if not sched.busy:  # no round: the claim's own completions end the tick
                return self._end_exemplar_tick(done)
        cache = engine.block_cache
        hits0, store0 = cache.stats.hits, cache.stats.store_blocks_fetched
        tier_fn = getattr(cache, "tier_counters", None)
        tier0 = tier_fn() if tier_fn is not None else None
        transfers0 = loop.dwave.transfers if loop.dwave is not None else 0
        touched0 = len(loop.touched)
        missed: list[np.ndarray] = []  # demand reads only (the prefetch ran above)
        prev_log, cache.fetch_log = cache.fetch_log, missed
        try:
            if loop.dwave is not None:
                active, wave_blocks = loop.dwave.plan_round()
            else:
                active = [sched.slots[s][1] for s in sched.busy_slots()]
                wave_blocks = plan_round_host(engine, active, "auto", engine.distributed)
            _execute_wave(engine, active, wave_blocks, loop.touched, loop.touched_set)
        finally:
            cache.fetch_log = prev_log
        with span_or_null(obs, "tick.retire"):
            sched.tick()
            for slot in sched.busy_slots():
                req, st = sched.slots[slot]
                # a state at the refill cap leaves with what it has, where the
                # solo loop would have stopped
                if st.done or st.rounds >= engine.max_refills:
                    req.result = finalize_query_result(engine, st)
                    req.done = True
                    sched.leave(slot)
                    if loop.dwave is not None:
                        loop.dwave.leave(slot)
                    done.append(req)
            if pf is not None:
                pf.observe_wave(_union(wave_blocks))
            lg = engine.ledger
            if lg is not None:
                lg.note_wave()
            self.last_wave_stats = make_wave_stats(
                "exemplar",
                wave_size=len(active),
                rounds=1,
                device_transfers=((loop.dwave.transfers - transfers0)
                                  if loop.dwave is not None else 0),
                store_blocks_fetched=int(cache.stats.store_blocks_fetched - store0),
                cache_hits=int(cache.stats.hits - hits0),
                unique_blocks=len(loop.touched) - touched0,
                tiers=({k: v - tier0[k] for k, v in tier_fn().items()}
                       if tier0 is not None else None),
                slot_occupancy=sched.occupancy,
                modeled_store_io_s=sum(engine.cost.io_time(m) for m in missed),
                pending=adm.pending,
                prefetch=pf.stats.snapshot() if pf is not None else None,
                plan_qerror=lg.qerror(site="placement") if lg is not None else None,
            )
            self._note_wave_stats()
            return self._end_exemplar_tick(done)

    def submit_aggregate_request(
        self,
        predicates,
        measure: int,
        k: int,
        *,
        op: str = "and",
        error_slo: float | None = None,
        deadline_s: float | None = None,
        alpha: float = 0.3,
        estimator: str = "ratio",
        algo: str = "threshold",
        seed: int = 0,
        chunk_blocks: int = 8,
        max_rounds: int = 64,
    ) -> AggregateRequest:
        """Admit an online aggregate under the SLO policy; it seats in the
        aggregate pool and streams one Estimate a round until its SLO
        answers it."""
        req = AggregateRequest(
            next(self._rid), predicates, measure, k, op,
            error_slo=error_slo, deadline_s=deadline_s, alpha=alpha,
            estimator=estimator, algo=algo, seed=seed,
            chunk_blocks=chunk_blocks, max_rounds=max_rounds,
        )
        if self.obs is not None:
            self.obs.event("request.submit", rid=req.rid, kind="aggregate")
            self.obs.metrics.inc("serve.aggregate.submitted")
        self.aggregate_admission.submit(req)
        return req

    def aggregate_tick(self, engine, now: float | None = None,
                       drain: bool = False) -> list[AggregateRequest]:
        """One round of the continuous online-aggregation loop: refill freed
        slots, stage every slot's next chunk and price it
        (:func:`~repro_torch.storage.prefetch.effective_block_cost`), read
        the union in one shared ``ensure``, fold each slot, then let
        :func:`~repro_torch.serving.admission.arbitrate_aggregate` decide
        per slot whether to answer now.  A request whose CI closes leaves
        this tick; ``last_wave_stats["answered"]`` records each leave.
        Returns the requests answered this tick."""
        self._check_engine(engine)
        self._wire_obs(engine)
        obs = self.obs
        if obs is None:
            return self._aggregate_tick_body(engine, now, drain)
        with obs.span("serve.aggregate_tick") as sp:
            done = self._aggregate_tick_body(engine, now, drain)
            sp.set(completed=len(done))
            for req in done:
                obs.event("request.done", rid=req.rid, kind="aggregate",
                          rounds=req.rounds, reason=req.reason)
        return done

    def _aggregate_tick_body(self, engine, now, drain: bool) -> list[AggregateRequest]:
        from repro_torch.core.online_agg import AggregateQuery, OnlineAggregator
        from repro_torch.serving.admission import arbitrate_aggregate
        from repro_torch.storage.prefetch import effective_block_cost

        adm = self.aggregate_admission
        loop = self._aggregate_loop
        if loop is None or loop.engine is not engine or loop.sched.n_slots != self.max_slots:
            if loop is not None:  # stranded on a stale engine: answer as-is
                for slot in loop.sched.busy_slots():
                    req, agg = loop.sched.slots[slot]
                    if agg.estimates:
                        req.result = agg.estimates[-1]
                    req.reason, req.done = "budget", True
                    agg.close()
            loop = self._aggregate_loop = _AggregateLoop(engine, self.max_slots)
        sched = loop.sched
        done: list[AggregateRequest] = []
        for req in self._claim(adm, sched, now, drain):
            q = AggregateQuery(req.predicates, req.measure, req.k, alpha=req.alpha, op=req.op,
                               estimator=req.estimator, algo=req.algo, seed=req.seed)
            sched.join((req, OnlineAggregator(engine, q, chunk_blocks=req.chunk_blocks)))
        if not sched.busy:
            return done
        cache = engine.block_cache
        hits0, store0 = cache.stats.hits, cache.stats.store_blocks_fetched
        tier_fn = getattr(cache, "tier_counters", None)
        tier0 = tier_fn() if tier_fn is not None else None
        # stage every slot's chunk and price it BEFORE the shared read: the
        # demand price a solo run would have paid for that chunk
        staged: dict[int, tuple[np.ndarray, float]] = {}
        for slot in sched.busy_slots():
            chunk = sched.slots[slot][1].next_blocks()
            staged[slot] = (chunk, effective_block_cost(engine, chunk))
        chunks = [c for c, _ in staged.values() if c.size]
        union = np.unique(np.concatenate(chunks)) if chunks else np.asarray([], np.int64)
        missed: list[np.ndarray] = []
        prev_log, cache.fetch_log = cache.fetch_log, missed
        try:
            if union.size:
                cache.ensure(engine.store, union)
            for slot in sorted(staged):
                req, agg = sched.slots[slot]
                e = agg.fold()
                agg.spent_io_s += staged[slot][1]
                req.stream.append(e)
                req.rounds = agg.rounds
                req.spent_io_s = agg.spent_io_s
        finally:
            cache.fetch_log = prev_log
        sched.tick()
        answered: list[dict] = []
        for slot in sched.busy_slots():
            req, agg = sched.slots[slot]
            nxt = agg.next_blocks()  # peek the following chunk's price
            verdict = arbitrate_aggregate(
                halfwidth=agg.halfwidth(),
                error_slo=req.error_slo,
                deadline_s=req.deadline_s,
                spent_s=agg.spent_io_s,
                next_cost_s=effective_block_cost(engine, nxt),
                predicted_halfwidth=agg.predicted_halfwidth(agg.chunk_blocks),
                max_s_per_width=self.aggregate_max_s_per_width,
            )
            if verdict is None and agg.exhausted:
                verdict = "exhausted"
            if verdict is None and agg.rounds >= req.max_rounds:
                verdict = "budget"
            if verdict is not None:
                req.result = agg.estimates[-1]
                req.reason = verdict
                req.done = True
                agg.close()
                sched.leave(slot)
                done.append(req)
                answered.append({"rid": req.rid, "reason": verdict, "rounds": agg.rounds,
                                 "halfwidth": agg.halfwidth()})
        self.last_wave_stats = make_wave_stats(
            "aggregate",
            wave_size=len(staged),
            rounds=1,
            store_blocks_fetched=int(cache.stats.store_blocks_fetched - store0),
            cache_hits=int(cache.stats.hits - hits0),
            unique_blocks=int(union.size),
            tiers=({k: v - tier0[k] for k, v in tier_fn().items()}
                   if tier0 is not None else None),
            slot_occupancy=sched.occupancy,
            modeled_store_io_s=sum(engine.cost.io_time(m) for m in missed),
            pending=adm.pending,
            answered=answered,
        )
        self._note_wave_stats()
        return done

    def lm_tick(self) -> list[Request]:
        """One tick of the continuous LM decode loop.

        The first tick of an empty pool prefills a wave as :meth:`_run_wave`
        does (same padding, same first token).  Every later tick first seats
        queued joiners whose prompt fits the position counter
        (``len(prompt) <= pos``): each is left-padded to exactly ``pos``,
        the joiners are prefilled as one batch and their cache rows grafted
        into the live cache (:func:`_merge_lm_cache_rows`); then ONE decode
        step runs and every slot that hit EOS or ``max_new_tokens`` retires,
        freeing it for the next tick.  A tick that ran writes a
        ``kind="lm"`` ledger to ``last_wave_stats`` and its host-clock times
        to ``lm_tick_stats``.  Returns the requests completed this tick."""
        obs = self.obs
        if obs is None:
            return self._lm_tick_body()
        with obs.span("serve.lm_tick") as sp:
            done = self._lm_tick_body()
            sp.set(completed=len(done))
            for req in done:
                obs.event("request.done", rid=req.rid, kind="lm", tokens=len(req.out_tokens))
        return done

    def _note_lm_wave(self, wave_size: int) -> None:
        """One LM tick's or wave's ledger (schema-complete, mirrored)."""
        self.last_wave_stats = make_wave_stats(
            "lm", wave_size=wave_size, rounds=1,
            slot_occupancy=wave_size / max(self.max_slots, 1), pending=len(self.queue))
        self._note_wave_stats()

    @torch.inference_mode()
    def _lm_tick_body(self) -> list[Request]:
        if self.model is None:
            return []
        done: list[Request] = []
        t0 = time.perf_counter()
        if self._lm is None:
            if not self.queue:
                return []
            wave = self._next_wave()
            toks = pad_wave(wave, self.max_slots, self.pad_id)
            last, cache = self._prefill(toks)
            slots: list[Request | None] = [None] * self.max_slots
            slots[:len(wave)] = wave
            self._greedy(last, slots, range(len(wave)))
            self._lm = {"cache": cache, "pos": toks.shape[1], "slots": slots}
            self.lm_tick_stats.append({"prefill_s": time.perf_counter() - t0,
                                       "joiners": len(wave), "decode_s": 0.0, "active": 0})
            self._note_lm_wave(len(wave))
            return done  # the prefill is the tick; the first decode lands next tick
        lm = self._lm
        pos = int(lm["pos"])
        slots = lm["slots"]
        free = [b for b, s in enumerate(slots) if s is None]
        joiners: list[tuple[int, Request]] = []
        while free and self.queue and len(self.queue[0].prompt) <= pos:
            req = self.queue.popleft()
            b = free.pop(0)
            slots[b] = req
            joiners.append((b, req))
        if joiners:
            toks = np.full((self.max_slots, pos), self.pad_id, np.int32)
            mask = np.zeros(self.max_slots, bool)
            for b, r in joiners:
                toks[b, pos - len(r.prompt):] = r.prompt
                mask[b] = True
            last, cache_j = self._prefill(toks)
            lm["cache"] = _merge_lm_cache_rows(lm["cache"], cache_j, mask)
            del cache_j
            self._greedy(last, slots, [b for b, _ in joiners])
        t1 = time.perf_counter()
        active = [b for b, s in enumerate(slots) if s is not None]
        if not active or pos >= self.max_seq - 1:
            for b in active:  # sequence budget exhausted: retire as-is
                slots[b].done = True
                done.append(slots[b])
                slots[b] = None
            self._lm = None
            self.lm_tick_stats.append({"prefill_s": t1 - t0, "joiners": len(joiners),
                                       "decode_s": 0.0, "active": len(active)})
            self._note_lm_wave(len(active))
            return done
        nxt, lm["cache"] = self._decode(lm["cache"], slots, active, pos)
        lm["pos"] = pos + 1
        for b in active:
            r = slots[b]
            # the retire check follows the decode append, as in _run_wave, so
            # the continuous and wave paths emit identical streams
            if self._finished(r, int(nxt[b])):
                r.done = True
                slots[b] = None
                done.append(r)
        if all(s is None for s in slots):
            self._lm = None
        self.lm_tick_stats.append({"prefill_s": t1 - t0, "joiners": len(joiners),
                                   "decode_s": time.perf_counter() - t1, "active": len(active)})
        self._note_lm_wave(len(active))
        return done

    def step(self, engine=None, now: float | None = None, drain: bool = False) -> dict:
        """One continuous-batching tick over every request kind: the LM pool
        advances one token (joiners seated first) and, given an any-k
        ``engine``, the exemplar pool runs one refill round and the
        aggregate pool one fold round.  Returns ``{"lm": [...], "exemplar":
        [...], "aggregate": [...]}`` of the requests completed."""
        out = {"lm": [], "exemplar": [], "aggregate": []}
        if self.model is not None and (self.queue or self._lm is not None):
            out["lm"] = self.lm_tick()
        if engine is not None:
            out["exemplar"] = self.exemplar_tick(engine, now=now, drain=drain)
            out["aggregate"] = self.aggregate_tick(engine, now=now, drain=drain)
        return out

    def run_continuous(self, engine=None, max_ticks: int = 100_000, drain: bool = True) -> dict:
        """Tick :meth:`step` until every pool and queue is empty, or the loop
        stalls (``drain=False`` under a holding policy).  Returns every
        completion keyed as :meth:`step` keys them."""
        out_all: dict[str, list] = {"lm": [], "exemplar": [], "aggregate": []}
        adm, agg_adm = self._exemplar_admission(), self.aggregate_admission

        def busy(loop) -> bool:
            return loop is not None and loop.engine is engine and loop.sched.busy > 0

        def signature():
            loop, aloop = self._exemplar_loop, self._aggregate_loop
            return (adm.pending, loop.sched.rounds if loop is not None else 0,
                    agg_adm.pending, aloop.sched.rounds if aloop is not None else 0,
                    len(self.queue), int(self._lm["pos"]) if self._lm is not None else -1)

        for _ in range(max_ticks):
            lm_busy = self.model is not None and (bool(self.queue) or self._lm is not None)
            ex_busy = engine is not None and (adm.pending > 0 or busy(self._exemplar_loop))
            agg_busy = engine is not None and (agg_adm.pending > 0
                                               or busy(self._aggregate_loop))
            if not (lm_busy or ex_busy or agg_busy):
                break
            sig = signature()
            out = self.step(engine, drain=drain)
            for k, v in out.items():
                out_all[k].extend(v)
            if not any(out.values()) and signature() == sig:
                break  # stalled: nothing moved and nothing finished
        return out_all
