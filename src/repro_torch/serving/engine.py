"""Wave-batched LM serving over prefill + decode_step.

Counterpart of the LM wave of ``repro/serving/engine.py``.  Requests are
drained from the queue in waves of ``max_slots``: each wave's prompts are
left-padded to a common length (``pad_id`` padding, attended as it is, as in
the reference), prefilled as one batch, then decoded in lock-step, one
``decode_step`` per tick for the whole wave.  Rows are independent, so
finished rows simply stop sampling.

Where the reference ``jax.jit``-compiles prefill and decode, the engine here
calls :func:`~repro_torch.models.decode.prefill` and
:func:`~repro_torch.models.decode.decode_step` directly under
``torch.inference_mode()``.  It prefills with ``impl="kernel"`` by default,
so on the card every attention block goes through the flash-attention
kernel (#8) and every Mamba block through the SSD kernel (#9); the
reference's engine prefills on its default ``"xla"`` path.  ``impl="plain"``
is for tests and ``chip_smoke.py``, to compare on the card.

Each wave's host-clock times (prefill, decode steps) land in
:attr:`ServeEngine.wave_stats`, and each request records the gap between
its top two logits at every token it emitted (``Request.top2_gap``), so a
comparison of two runs can tell a near-tie from a wrong token.

The exemplar (any-k), aggregate and continuous-batching pools of the
reference's engine arrive with the serving slice (ROADMAP Queue 1); their
methods raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import decode as D
from repro_torch.models.layers import check_impl
from repro_torch.models.lm import LM

_LATER = "arrives with the serving slice of the port (ROADMAP Queue 1)"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [P] int32
    max_new_tokens: int = 32
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # top-1 minus top-2 logit at each emitted token
    top2_gap: list[float] = dataclasses.field(default_factory=list)


def pad_wave(wave: list[Request], max_slots: int, pad_id: int) -> np.ndarray:
    """``[max_slots, plen]`` int32 tokens: each prompt left-padded so the
    wave's last prompt tokens align; unused rows are all padding."""
    plen = max(len(r.prompt) for r in wave)
    toks = np.full((max_slots, plen), pad_id, np.int32)
    for b, r in enumerate(wave):
        toks[b, plen - len(r.prompt):] = r.prompt
    return toks


class ServeEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        model: LM,
        max_slots: int = 4,
        max_seq: int = 256,
        eos_id: int | None = None,
        pad_id: int = 0,
        impl: str = "kernel",
        device: str | torch.device = "cuda",
        **later,
    ):
        if later:
            raise NotImplementedError(f"ServeEngine({', '.join(sorted(later))}=...) {_LATER}")
        if cfg is None:
            raise NotImplementedError(f"exemplar-only serving (cfg=None) {_LATER}")
        check_impl(impl)
        self.device = resolve_device(device)
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
        self.queue: deque[Request] = deque()
        self._rid = itertools.count()
        #: per wave: size, prompt_len, prefill_s, decode_steps, decode_s, new_tokens
        self.wave_stats: list[dict] = []

    def submit(self, prompt, max_new_tokens: int = 32) -> Request:
        req = Request(next(self._rid), np.asarray(prompt, np.int32), max_new_tokens)
        self.queue.append(req)
        return req

    def _next_wave(self) -> list[Request]:
        wave = []
        while self.queue and len(wave) < self.max_slots:
            wave.append(self.queue.popleft())
        return wave

    def _greedy(self, logits: torch.Tensor, wave: list[Request], rows) -> np.ndarray:
        """Argmax tokens of ``rows``; records each row's top-2 logit gap.
        One device→host copy per call."""
        top = torch.topk(logits, 2, dim=-1).values
        packed = torch.stack([torch.argmax(logits, dim=-1).to(top.dtype),
                              top[:, 0] - top[:, 1]], dim=1).cpu().numpy()
        nxt = packed[:, 0].astype(np.int64)
        for b in rows:
            wave[b].out_tokens.append(int(nxt[b]))
            wave[b].top2_gap.append(float(packed[b, 1]))
        return nxt

    @torch.inference_mode()
    def _run_wave(self, wave: list[Request]) -> None:
        n = len(wave)
        toks = pad_wave(wave, self.max_slots, self.pad_id)
        plen = toks.shape[1]
        t0 = time.perf_counter()
        last, cache = D.prefill(self.model, torch.from_numpy(toks).to(self.device),
                                impl=self.impl, max_seq=self.max_seq)
        self._greedy(last, wave, range(n))
        t1 = time.perf_counter()
        pos = plen
        steps = 0
        active = set(range(n))
        while active and pos < self.max_seq - 1:
            cur = np.full(self.max_slots, self.pad_id, np.int64)
            for b in active:
                cur[b] = wave[b].out_tokens[-1]
            logits, cache = D.decode_step(self.model, cache,
                                          torch.from_numpy(cur).to(self.device), pos)
            nxt = self._greedy(logits, wave, sorted(active))
            pos += 1
            steps += 1
            for b in list(active):
                r = wave[b]
                tok = int(nxt[b])
                if (self.eos_id is not None and tok == self.eos_id) or len(
                    r.out_tokens
                ) >= r.max_new_tokens:
                    r.done = True
                    active.discard(b)
        for r in wave:
            r.done = True
        self.wave_stats.append({
            "size": n, "prompt_len": plen, "prefill_s": t1 - t0, "decode_steps": steps,
            "decode_s": time.perf_counter() - t1,
            "new_tokens": sum(len(r.out_tokens) for r in wave),
        })

    def run_until_drained(self) -> list[Request]:
        done = []
        while self.queue:
            wave = self._next_wave()
            self._run_wave(wave)
            done.extend(wave)
        return done

    # -------------------------------------------- later slices of the port
    def _later(self, *args, **kwargs):
        raise NotImplementedError(f"this ServeEngine method {_LATER}")

    select_exemplars = submit_exemplar_request = pump_exemplar_requests = _later
    drain_exemplar_requests = exemplar_tick = submit_aggregate_request = _later
    aggregate_tick = lm_tick = step = run_continuous = _later
