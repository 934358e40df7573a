"""One run of one cell: set-up, the measured window, the check.

Set-up generates the configuration's table on the device from the seed
(``layouts/<layout>.py``), keeps a host copy, lays it out with
``build_block_store(table, records_per_block, device)``, fills the engine's
flat block cache with every block (a long-running server's steady state),
counts the queries' matches and warms up on the cell's own traffic; the
device's copy of the table is then freed and the peak reset, so the
window's peak is the serving program's.  The window then drives
``ServeEngine.step`` → ``exemplar_tick`` (64 slots, the device-resident
wave, ``auto`` planning, the default ``AdmissionPolicy(max_wave=64)`` on the
real clock) with the mix's open or closed loop.  While the store lives on
the card, a cache hit and a store read are the same gather from device
memory.

With ``trace`` the run also attaches an ``obs.TraceRecorder``, times each
``DeviceWave.plan_round`` from here, and profiles a stretch of the window
(``TRACE_SPAN`` of it from ``TRACE_FROM``, device activity only); the
per-layer metrics are read from those (``metrics/<name>.py``): the host
layers' before the profiler starts, and the device's in the profiled
stretch, whose rate or latency the run prints beside the window's.  After
the window every request due in it is awaited, device memory's peak is read,
the program's state is freed, and the plain reference (``reference/``)
judges the answers on the table's host copy, moved back to the device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import resource
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bench import devtrace, traffic
from bench.check import judge

ROOT = Path(__file__).resolve().parent
GRACE_S = 60.0  # how long after the window a due request is awaited
# the profiled stretch: from TRACE_FROM of the window, for TRACE_SPAN of it
TRACE_FROM, TRACE_SPAN = 0.4, 0.15
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
E2E = ("setup_s", "query_p50_ms", "query_p95_ms", "queries_per_s")


def load_json(*parts: str) -> dict:
    return json.loads(ROOT.joinpath(*parts).read_text())


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (names may hold ``.`` and ``-``)."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}".replace(".", "_")
                                                  .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names, compared whole, of the loaded modules (``sys.modules``
    unless given) that the harness must not load."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    params: dict  # bench/cells/<name>.json: what is fixed in the cell (a rate)
    end_to_end: list
    per_layer: list


def load_cell(bench: dict, workload: str) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = json.loads((ROOT.parent / conf["file"]).read_text())
    cell_file = ROOT / "cells" / f"{workload}.json"
    params = json.loads(cell_file.read_text()) if cell_file.exists() else {}

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return Cell(workload, cfg, load_json("traffic", f"{entry['traffic']}.json"), params,
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


@dataclasses.dataclass
class Rec:
    query: traffic.Query
    due: float
    submit: float = math.nan
    done: float = math.nan
    completions: int = 0
    req: object = None


@dataclasses.dataclass
class PlanCall:
    seconds: float
    phase: int  # 0 before the profiled stretch, 1 in it, 2 after it
    rows: int
    lam: int
    joiner_gammas: list
    union_blocks: int


@dataclasses.dataclass
class Run:
    """What a run leaves for the per-layer readers."""

    cell: Cell
    window_s: float
    recs: list
    admission: dict  # AdmissionStats deltas from the window's start to the profiler's
    plan_calls: list
    spans: list  # obs events of the window
    device: devtrace.DeviceTrace | None
    block_bytes: int
    host_until: float  # the profiler's start on the obs clock: host layers are read before it


# ------------------------------------------------------------------ set-up
@dataclasses.dataclass
class Setup:
    dims: torch.Tensor  # the generated table on the device, until the window
    measures: torch.Tensor
    host_dims: torch.Tensor  # its copy on the host: the reference's input
    host_measures: torch.Tensor
    store: object
    engine: object

    def table_to_host(self) -> None:
        """Free the device's copy of the table (set-up counts matches on it;
        the deployment holds only the store and the cache)."""
        self.dims = self.measures = None

    def table_on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The table on ``device`` again, for the reference."""
        return self.host_dims.to(device), self.host_measures.to(device)


def build(cfg: dict, seed: int, device) -> Setup:
    from repro_torch.core.cost_model import make_cost_model
    from repro_torch.core.engine import NeedleTailEngine
    from repro_torch.data.block_store import Table, build_block_store

    stage = Stages()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    layout = load_module("layouts", cfg["layout"])
    dims, meas = layout.generate(int(cfg["num_records"]), gen, device, **cfg["layout_params"])
    stage("table generated on the device")
    table = Table(dims=dims.cpu().numpy(), measures=meas.cpu().numpy(),
                  cards=np.asarray(cfg["cards"], dtype=np.int64))
    stage("host copy")
    store = build_block_store(table, int(cfg["records_per_block"]), device)
    stage("build_block_store")
    engine = NeedleTailEngine(store, cost_model=make_cost_model(cfg["cost_model"]),
                              max_refills=int(cfg["max_refills"]), device=device)
    engine.block_cache.ensure(store, np.arange(store.num_blocks))
    stage("block cache filled")
    return Setup(dims, meas, torch.from_numpy(table.dims), torch.from_numpy(table.measures),
                 store, engine)


class Stages:
    """Prints each set-up stage's seconds to standard error."""

    def __init__(self):
        self.t = time.monotonic()

    def __call__(self, what: str) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.monotonic()
        print(f"setup: {what} {now - self.t:.3f} s", file=sys.stderr)
        self.t = now


def match_counter(dims: torch.Tensor):
    """How many rows of the generated table match an AND of pairs."""
    def count(preds) -> int:
        m = dims[:, preds[0][0]] == preds[0][1]
        for a, v in preds[1:]:
            m &= dims[:, a] == v
        return int(m.sum())
    return count


# ------------------------------------------------------------------ tracing
class _Range:
    """A host range kept by the tracer while it profiles."""

    __slots__ = ("tr", "name", "t0")

    def __init__(self, tr: "Tracer", name: str):
        self.tr, self.name = tr, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.tr.profiling:
            self.tr.ranges.append((self.name, self.t0, time.perf_counter()))


class Tracer:
    """Profiler, host ranges and the plan-round timer of a traced run; every
    method is a no-op in an untraced one.  The profiler records device
    activity alone; the host ranges are kept here, on ``time.perf_counter``,
    and two anchor kernels bracket the stretch (``devtrace``)."""

    def __init__(self, on: bool, seconds: float, on_start=None):
        self.on = on
        self.t_from, self.span = TRACE_FROM * seconds, TRACE_SPAN * seconds
        self.t_to = math.inf
        self.prof = None
        self.started = False
        self.done = False
        self.recording = False
        self.calls: list[PlanCall] = []
        self.ranges: list[tuple[str, float, float]] = []
        self.started_at = math.inf  # perf_counter() at the first anchor
        self.stopped_at = math.inf  # perf_counter() at the second
        self.loop_span = (math.inf, math.inf)  # the stretch on the loop's clock
        self.on_start = on_start
        self._restore = None

    @property
    def phase(self) -> int:
        return 0 if not self.started else (1 if not self.done else 2)

    @property
    def profiling(self) -> bool:
        return self.started and not self.done

    def label(self, name: str):
        return _Range(self, name) if self.on else contextlib.nullcontext()

    def at(self, t: float) -> None:
        """Between ticks: start or stop the profiled stretch."""
        if not self.on or self.done:
            return
        if not self.started and t >= self.t_from:
            if self.on_start is not None:
                self.on_start()
            self.prof = self._profile()
            if self.prof is not None:
                self.prof.__enter__()
            self.started_at = _anchor()
            self.started = True
            self.t_to = t + self.span
            self.loop_span = (t, math.inf)
        elif self.started and t >= self.t_to:
            self.loop_span = (self.loop_span[0], t)
            self.stop()

    @staticmethod
    def _profile():
        """A profiler of the device's activity alone; none without a card."""
        if not torch.cuda.is_available():
            return None
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA])

    def prewarm(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        initialises the device tracer, which stalls the host for seconds."""
        prof = self._profile() if self.on else None
        if prof is not None:
            with prof:
                _anchor()

    def stop(self) -> None:
        if self.started and not self.done:
            self.stopped_at = _anchor()
            if self.prof is not None:
                torch.cuda.synchronize()
                self.prof.__exit__(None, None, None)
            self.done = True

    def device_trace(self, spans: list):
        """The stretch's device trace; ``spans`` are the program's ``obs``
        events, whose spans name idle gaps too."""
        if not self.done or self.prof is None:
            return None
        t0 = time.monotonic()
        host = self.ranges + [(e["name"], e["t0"], e["t1"]) for e in spans
                              if e.get("kind") == "span"]
        out = devtrace.from_profiler(self.prof, self.started_at, self.stopped_at, host)
        print(f"trace: read in {time.monotonic() - t0:.3f} s, window "
              f"{out.window_s if out else 0.0:.3f} s", file=sys.stderr)
        return out

    def install(self) -> None:
        """Time every ``DeviceWave.plan_round`` from here (traced runs only)."""
        if not self.on:
            return
        from repro_torch.core.multi_query import DeviceWave

        orig = DeviceWave.plan_round
        tracer = self
        last: list = []  # the previous round's states, held so no id is reused

        def plan_round(wave):
            t0 = time.perf_counter()
            active, blocks = orig(wave)
            t1 = time.perf_counter()
            if tracer.profiling:
                tracer.ranges.append(("bench.plan_round", t0, t1))
            if tracer.recording:
                was = {id(st) for st in last}
                joiners = [st for st in active if id(st) not in was]
                union = np.unique(np.concatenate(blocks)).size if blocks else 0
                tracer.calls.append(PlanCall(
                    t1 - t0, tracer.phase, wave.qb, wave.lam,
                    [len(st.query.predicates) for st in joiners], int(union)))
            last[:] = active
            return active, blocks

        DeviceWave.plan_round = plan_round
        self._restore = lambda: setattr(DeviceWave, "plan_round", orig)

    def uninstall(self) -> None:
        if self._restore is not None:
            self._restore()
            self._restore = None


ANCHOR_CYCLES = 1000


def _anchor() -> float:
    """Synchronise, note the host's clock and launch an anchor kernel
    (``devtrace.ANCHOR``); returns the time noted."""
    if not torch.cuda.is_available():
        return time.perf_counter()
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(ANCHOR_CYCLES)
    return t


# ------------------------------------------------------------------- loops
def _tick(serve, engine, recs_by_req: dict, t0: float, tr: Tracer) -> tuple[bool, list]:
    """One ``ServeEngine.step``; stamps the completions.  Returns whether a
    plan round ran, and the records completed."""
    before = serve.last_wave_stats
    with tr.label("bench.tick"):
        done = serve.step(engine)["exemplar"]
    t = time.monotonic() - t0
    out = []
    for req in done:
        rec = recs_by_req[id(req)]
        rec.completions += 1
        rec.done = t
        out.append(rec)
    return serve.last_wave_stats is not before, out


def _submit(serve, rec: Rec, recs_by_req: dict, t: float) -> None:
    q = rec.query
    rec.req = serve.submit_exemplar_request(list(q.predicates), q.k, q.op)
    rec.submit = t
    recs_by_req[id(rec.req)] = rec


def _idle_wait(serve, t0: float, next_arrival: float, tr: Tracer) -> None:
    """No round ran: sleep until the next arrival or the oldest deadline."""
    until = next_arrival
    deadline = serve.exemplar_admission.next_deadline()
    if deadline is not None:
        until = min(until, deadline - t0)
    pause = until - (time.monotonic() - t0)
    if pause > 0:
        with tr.label("bench.sleep"):
            time.sleep(min(pause, 0.05))


def open_loop(serve, engine, queries, due, seconds: float, tr: Tracer,
              grace_s: float = GRACE_S) -> list[Rec]:
    """Poisson arrivals: each query is submitted at its due time, whatever the
    system is doing; the loop then waits for every one (up to ``GRACE_S``)."""
    recs = [Rec(q, float(d)) for q, d in zip(queries, due)]
    by_req: dict = {}
    i, outstanding = 0, 0
    t0 = time.monotonic()
    while True:
        now = time.monotonic() - t0
        with tr.label("bench.submit"):
            while i < len(recs) and recs[i].due <= now:
                _submit(serve, recs[i], by_req, now)
                i, outstanding = i + 1, outstanding + 1
        tr.at(now)
        if (outstanding == 0 and i == len(recs)) or now > seconds + grace_s:
            break
        ran, finished = _tick(serve, engine, by_req, t0, tr)
        outstanding -= len(finished)
        if not ran:
            _idle_wait(serve, t0, recs[i].due if i < len(recs) else seconds + grace_s, tr)
    tr.stop()
    return recs


def closed_loop(serve, engine, stream: traffic.QueryStream, clients: int, seconds: float | None,
                tr: Tracer, max_ticks: int | None = None, grace_s: float = GRACE_S) -> list[Rec]:
    """``clients`` callers that each send their next query when the last one
    returns, until ``seconds`` (or ``max_ticks`` rounds) have passed; the
    loop then waits for the queries in flight (up to ``GRACE_S``)."""
    recs: list[Rec] = []
    by_req: dict = {}
    t0 = time.monotonic()
    for _ in range(clients):
        rec = Rec(stream.next(), 0.0)
        _submit(serve, rec, by_req, 0.0)
        recs.append(rec)
    outstanding, rounds = clients, 0
    limit = (seconds or 0.0) + grace_s
    while outstanding and time.monotonic() - t0 <= limit:
        tr.at(time.monotonic() - t0)
        ran, finished = _tick(serve, engine, by_req, t0, tr)
        rounds += ran
        outstanding -= len(finished)
        t = time.monotonic() - t0
        if (seconds is None or t < seconds) and (max_ticks is None or rounds < max_ticks):
            with tr.label("bench.submit"):
                for _ in finished:
                    rec = Rec(stream.next(), t)
                    _submit(serve, rec, by_req, t)
                    recs.append(rec)
                    outstanding += 1
        if not ran:
            _idle_wait(serve, t0, math.inf, tr)
    tr.stop()
    return recs


# --------------------------------------------------------------------- run
def _quantile_ms(values: np.ndarray, q: float) -> float:
    with np.errstate(invalid="ignore"):
        v = float(np.percentile(values, q))
    return math.inf if math.isnan(v) else v * 1e3  # nan: between two lost requests


def end_to_end(cell: Cell, recs: list[Rec], seconds: float, setup_s: float) -> dict:
    """The cell's end-to-end metrics: ``setup_s`` and the mix's latency or
    rate.  A request never answered counts as infinitely late."""
    out = {"setup_s": {"value": setup_s, "unit": "s"}}
    if cell.mix["loop"] == "open":
        lat = np.asarray([r.done - r.due if r.completions else math.inf for r in recs])
        out["query_p50_ms"] = {"value": _quantile_ms(lat, 50), "unit": "ms"}
        out["query_p95_ms"] = {"value": _quantile_ms(lat, 95), "unit": "ms"}
    else:
        n = sum(1 for r in recs if r.completions and r.done <= seconds)
        out["queries_per_s"] = {"value": n / seconds, "unit": "queries/s"}
    names = {m["name"] for m in cell.end_to_end}
    return {k: v for k, v in out.items() if k in names}


def host_sample() -> dict:
    """The process's clock and CPU seconds, for :func:`host_report`."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall": time.perf_counter(), "cpu": ru.ru_utime + ru.ru_stime}


def host_report(a: dict, b: dict) -> str:
    """What the host did over the window: the process's CPU seconds against
    the wall's, and the time a fixed loop of Python takes afterwards (the
    core's speed, which sets a host-bound window's pace)."""
    t0 = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i
    loop_ms = 1e3 * (time.perf_counter() - t0)
    return (f"wall_s {b['wall'] - a['wall']:.3f}, cpu_s {b['cpu'] - a['cpu']:.3f}, "
            f"threads {torch.get_num_threads()}, python_loop_ms {loop_ms:.2f}")


def stretch_report(mix: dict, recs: list[Rec], span: tuple[float, float]) -> str:
    """The profiled stretch's rate or latency beside the window's before it,
    so that what the profiler costs the host shows."""
    a, b = span
    if mix["loop"] == "open":
        def tails(lo, hi):
            lat = np.asarray([r.done - r.due if r.completions else math.inf
                              for r in recs if lo <= r.due < hi])
            return (f"p50_ms {_quantile_ms(lat, 50):.3f} p95_ms {_quantile_ms(lat, 95):.3f}"
                    if lat.size else "none")
        return f"before {tails(0.0, a)}; in it {tails(a, b)}"

    def rate(lo, hi):
        n = sum(1 for r in recs if r.completions and lo <= r.done < hi)
        return n / (hi - lo) if hi > lo else math.nan
    return f"before {rate(0.0, a):.3f} queries/s; in it {rate(a, b):.3f} queries/s"


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: dict | None = None, grace_s: float = GRACE_S,
             cell_params: dict | None = None) -> dict:
    """One run; returns the result line's object (``correct`` and all).
    ``t_start`` is the process's start on ``time.monotonic``'s clock;
    ``overrides`` replace configuration keys, ``cell_params`` the cell's own
    (its rate) and ``grace_s`` the wait for late answers (tests run tiny
    tables slowly)."""
    from repro_torch.obs import TraceRecorder
    from repro_torch.serving.engine import ServeEngine

    cell = load_cell(bench, workload)
    cell.params.update(cell_params or {})
    cfg = dict(cell.cfg, **(overrides or {}))
    mix = cell.mix
    dev = torch.device(device)
    setup = build(cfg, seed, dev)

    def count(preds) -> int:  # set-up's match counts, on the device's copy of the table
        return match_counter(setup.dims)(preds)

    slots = int(cfg["slots"])
    obs = TraceRecorder(max_events=1 << 22) if trace else None
    serve = ServeEngine(None, None, max_slots=slots, exemplar_device=True, device=dev, obs=obs)
    adm_at_profile: dict = {}
    tr = Tracer(trace, seconds, on_start=lambda: adm_at_profile.update(
        dataclasses.asdict(serve.exemplar_admission.stats)))
    tr.install()
    tr.prewarm()
    try:
        warm = traffic.QueryStream(cfg, mix, seed, traffic.STREAM_WARMUP, count)
        t_warm = time.monotonic()
        closed_loop(serve, setup.engine, warm, slots, None, Tracer(False, seconds),
                    max_ticks=int(mix["warmup_ticks"]))
        print(f"setup: warm-up {time.monotonic() - t_warm:.3f} s", file=sys.stderr)
        stream = traffic.QueryStream(cfg, mix, seed, traffic.STREAM_WINDOW, count)
        if mix["loop"] == "open":
            due = traffic.poisson_arrivals(float(cell.params["rate_per_s"]), seconds, seed,
                                           int(mix["pool"]))
            queries = stream.take(due.size)
        adm0 = dataclasses.asdict(serve.exemplar_admission.stats)
        if obs is not None:
            obs.events.clear()
        setup.table_to_host()
        gc.collect()
        gc.freeze()  # set-up's objects: full collections in the window skip them
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)  # the peak is the serving program's
        tr.recording = True
        host0 = host_sample()
        setup_s = time.monotonic() - t_start
        if mix["loop"] == "open":
            recs = open_loop(serve, setup.engine, queries, due, seconds, tr, grace_s)
        else:
            recs = closed_loop(serve, setup.engine, stream, int(mix["clients"]), seconds, tr,
                               grace_s=grace_s)
        tr.recording = False
        host1 = host_sample()
        gc.unfreeze()
    finally:
        tr.uninstall()
    adm1 = adm_at_profile or dataclasses.asdict(serve.exemplar_admission.stats)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    spans = obs.to_events() if obs is not None else []
    run = Run(cell, seconds, recs, {k: adm1[k] - adm0[k] for k in adm0}, tr.calls,
              spans, tr.device_trace(spans),
              int(cfg["records_per_block"]) * (4 * len(cfg["cards"]) + 4 * len(cfg["measures"])
                                                 + 1), tr.started_at)
    own = end_to_end(dataclasses.replace(cell, end_to_end=[{"name": n} for n in E2E]), recs,
                     seconds, setup_s)
    print("window: " + ", ".join(f"{k} {v['value']}" for k, v in own.items()), file=sys.stderr)
    print("host: " + host_report(host0, host1), file=sys.stderr)
    if tr.done:
        print("stretch: " + stretch_report(mix, recs, tr.loop_span), file=sys.stderr)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = end_to_end(cell, recs, seconds, setup_s)
    # the program's state goes before the reference runs
    del serve, obs
    setup.engine = setup.store = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    verdict = judge(cfg, mix, *setup.table_on(dev), recs, seed)
    print(f"check: {time.monotonic() - t_check:.3f} s", file=sys.stderr)
    result = {
        "correct": verdict["correct"],
        "attempted": len(recs),
        "failed": verdict["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace and run.device is not None:
        result["device"]["busy_s"] = run.device.busy_s
        result["device"]["window_s"] = run.device.window_s
        result["breakdown"] = run.device.breakdown()
    result["check_counts"] = verdict["counts"]
    result["check"] = verdict["check"]
    return result
