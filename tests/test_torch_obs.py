"""Port parity: telemetry (``repro_torch.obs``) against ``repro.obs``, and
the engine's async request API.

  * The metrics registry: the same operations give the reference's
    ``snapshot()``, JSON and Prometheus text, and ``render_report``.
  * The lifecycle tracer: the ring's bound and drop count, the Chrome
    trace equal to the reference's for the same events, and the
    reference's ``validate_chrome_trace`` passing the port's engine
    trace, whose per-request invariants hold and whose admit / resume /
    preempt / finish counts equal the registry's.
  * ``Telemetry``: off records nothing, ``on(profile=True)`` carries a
    ``DispatchProfiler``, a decode span closes after the step's token
    readback.
  * ``start()`` / ``submit()`` / ``get_result()`` / ``stop()`` give
    ``run()``'s tokens; a dead serve loop surfaces as ``RuntimeError``;
    submitters on many threads each get one Result.

Engine runs: scaled-down fp32 qwen2, the port's own seeded weights x4.
"""

import collections
import dataclasses
import json
import queue
import time
import types

import numpy as np
import pytest

import _resilience_trace as RT
from repro import obs as RO
from repro.obs import events as RE
from repro.obs import metrics as RM
from repro_torch import configs as TC
from repro_torch.kernels._build import KernelError
from repro_torch.models import network as TN
from repro_torch.models.layers import tree_map
from repro_torch.obs import DispatchProfiler, Telemetry, render_report
from repro_torch.obs import events as TEV
from repro_torch.obs import metrics as TM
from repro_torch.serving.engine import ContinuousEngine, Request
from repro_torch.serving.resilience import (FaultPlane, FaultSpec,
                                            ResilienceConfig,
                                            serve_with_restarts)


def _ops(reg):
    """One fixed sequence of registry operations."""
    c = reg.counter("engine.steps", "decode/verify dispatches")
    c.inc()
    c.inc(2.5)
    g = reg.gauge("engine.pool_util", "util")
    g.set(0.25)
    g.inc(0.5)
    h = reg.histogram("engine.ttft_steps", "steps before the first token")
    for v in (0, 1, 3, 3, 7, 100, 2000, 5.5):
        h.observe(v)
    hl = reg.histogram("engine.request_latency_s", "latency",
                       buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.02, 0.5, 3.0):
        hl.observe(v)
    s = reg.series("engine.decode_step_stamps", "stamps", maxlen=3)
    for v in (1.0, 2.0, 3.5, 4.25):
        s.append(v)
    reg.counter("kv_pool.evictions").inc(4)
    reg.counter("9.weird-name:x", "odd characters").inc()
    reg.counter("schedule.hits").inc(30)
    reg.counter("schedule.misses").inc(2)
    reg.counter("engine.pool_util_sum").inc(1.5)
    reg.counter("engine.pool_util_samples").inc(3)
    reg.counter("engine.tokens_emitted").inc(64)
    reg.counter("engine.requests_finished").inc(4)
    reg.counter("spec.slot_verifies").inc(10)
    reg.counter("spec.tokens_emitted").inc(25)
    return reg


@pytest.mark.parametrize("view", ["snapshot", "json", "prometheus",
                                  "report"])
def test_registry_matches_reference(view):
    port, ref = _ops(TM.MetricsRegistry()), _ops(RM.MetricsRegistry())
    if view == "snapshot":
        assert port.snapshot() == ref.snapshot()
        assert json.loads(json.dumps(port.snapshot())) == port.snapshot()
    elif view == "json":
        assert port.to_json(indent=2) == ref.to_json(indent=2)
    elif view == "prometheus":
        assert port.to_prometheus() == ref.to_prometheus()
        assert "_9_weird_name_x" in port.to_prometheus()
    else:
        for wall in (0.0, 2.0):
            assert render_report(port, wall_s=wall) == \
                RO.render_report(ref, wall_s=wall)
    assert len(port) == len(ref)
    assert port.value("engine.steps") == 3.5
    assert port.value("absent", 7.0) == 7.0
    assert port.get("engine.ttft_steps").percentile(50) == \
        ref.get("engine.ttft_steps").percentile(50)


def test_registry_exports_and_null_path(tmp_path):
    reg = _ops(TM.MetricsRegistry())
    reg.export(str(tmp_path / "m.json"))
    reg.export(str(tmp_path / "m.prom"))
    assert json.loads((tmp_path / "m.json").read_text()) == reg.snapshot()
    assert (tmp_path / "m.prom").read_text() == reg.to_prometheus()
    with pytest.raises(TypeError):
        reg.gauge("engine.steps")
    off = TM.MetricsRegistry(enabled=False)
    for make in (off.counter, off.gauge, off.histogram, off.series):
        assert make("x") is TM.NULL_METRIC
    _ops(off)
    assert off.snapshot() == {} and len(off) == 0
    assert TM.NULL_REGISTRY.snapshot() == {}


def _events(tr):
    tr.event("submit", rid=0, step=0, ts=10.0, prompt_len=5)
    tr.event("admit", rid=0, slot=1, step=0, ts=10.001)
    tr.event("chunk_batch", step=1, ts=10.002, dur=0.004, rows=1)
    tr.event("prefill_chunk", rid=0, slot=1, step=1, ts=10.002, dur=0.004)
    tr.event("first_token", rid=0, slot=1, step=1, ts=10.0061)
    tr.event("decode", step=2, ts=10.007, dur=0.002, rows=1)
    tr.event("dispatch", step=2, ts=10.007, dur=0.001)
    tr.event("fault_injected", step=2, ts=10.0071, kind="dispatch")
    tr.event("finish", rid=0, slot=1, step=3, ts=10.01, tokens=2)
    tr.counter("pool_util", 0.5, step=2, ts=10.0072)
    tr.counter("pending_queue", 3, step=3, ts=10.0102)
    return tr


def test_tracer_ring_bound_and_drops():
    tr = TEV.Tracer(capacity=4)
    for i in range(10):
        tr.event("decode", step=i, dur=0.001)
    assert len(tr) == 4 and tr.emitted == 10 and tr.dropped == 6
    assert [e.step for e in tr.events] == [6, 7, 8, 9]
    assert tr.chrome_trace()["otherData"]["dropped_events"] == 6
    off = TEV.Tracer(enabled=False)
    off.event("submit", rid=1)
    off.counter("pool_util", 1.0)
    assert len(off) == 0 and not off.counters and off.dropped == 0
    assert TEV.EVENT_TYPES == RE.EVENT_TYPES


def test_chrome_trace_matches_reference(tmp_path):
    port, ref = _events(TEV.Tracer()), _events(RE.Tracer())
    assert port.chrome_trace() == ref.chrome_trace()
    assert RE.validate_chrome_trace(port.chrome_trace()) == []
    port.export(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == \
        ref.chrome_trace()
    bad = [None, {}, {"traceEvents": []},
           {"traceEvents": [{"ph": "X", "name": "d", "pid": 1, "tid": 0,
                             "ts": 0.0, "dur": -1}, 3,
                            {"ph": "C", "name": "c", "pid": 1, "tid": "0",
                             "ts": "x", "args": {"value": "y"}},
                            {"name": "n", "pid": 1, "tid": 0}]}]
    for doc in bad:
        assert TEV.validate_chrome_trace(doc) == RE.validate_chrome_trace(
            doc) != []


# ---------------------------------------------------------------------------
# the engine under telemetry
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = TC.get("qwen2_0_5b").scaled_down()
    return cfg, tree_map(lambda _p, a: a * 4.0, TN.init(cfg, 0, "cpu"))


def _engine(tiny, **kw):
    cfg, params = tiny
    kw.setdefault("slots", RT.SLOTS)
    kw.setdefault("max_len", RT.MAX_LEN)
    return ContinuousEngine(cfg, params, device="cpu", audit=True, **kw)


def _api(tiny):
    return types.SimpleNamespace(
        make=lambda **kw: _engine(tiny, **kw), Request=Request,
        FaultPlane=FaultPlane, FaultSpec=FaultSpec,
        ResilienceConfig=ResilienceConfig,
        serve_with_restarts=serve_with_restarts, Telemetry=Telemetry)


def _reqs(vocab, n=4, new=5):
    return [Request(i, np.random.default_rng(i).integers(
        3, vocab, 10 + 9 * i).astype(np.int32), new, eos=-1)
        for i in range(n)]


@pytest.mark.parametrize("drill", ["spec", "restart"])
def test_engine_trace_validates_and_counts(tiny, tmp_path, drill):
    """The port's trace passes the reference's validator, each request's
    lifecycle is well formed, and the trace's admit / resume / preempt /
    finish counts equal the registry's."""
    captured = {}
    api = _api(tiny)
    make = api.make

    def keep(**kw):
        eng = make(**kw)
        captured["obs"] = eng.obs
        return eng

    api.make = keep
    rec = RT.drill(drill, api, tiny[0].vocab)
    obs = captured["obs"]
    obs.export_trace(str(tmp_path / "t.json"))
    obs.export_metrics(str(tmp_path / "m.prom"))
    doc = json.loads((tmp_path / "t.json").read_text())
    assert RE.validate_chrome_trace(doc) == []
    assert "engine_steps" in (tmp_path / "m.prom").read_text()
    kinds = collections.Counter(e.etype for e in obs.tracer.events)
    v = obs.metrics.value
    assert kinds["admit"] == v("engine.admissions") - v("engine.resumes")
    assert kinds["resume"] == v("engine.resumes")
    assert kinds["preempt"] == v("engine.preemptions")
    assert kinds["finish"] == v("engine.requests_finished") == 4
    assert kinds["decode"] + kinds["verify"] == v("engine.steps")
    assert kinds["chunk_batch"] == v("engine.chunk_steps")
    if drill == "spec":
        assert kinds["preempt"] >= 1 and kinds["degrade"] >= 1
    else:
        assert kinds["restore"] == 1 and rec["engines"] == 2
    by_rid = collections.defaultdict(list)
    for e in obs.tracer.events:
        if e.rid >= 0:
            by_rid[e.rid].append(e.etype)
    for rid, seq in by_rid.items():
        assert seq.count("submit") == 1 and seq[0] == "submit", rid
        assert seq.count("finish") == 1 and seq[-1] == "finish", rid
        first = seq.index("first_token")
        assert {"admit", "resume"} & set(seq[:first]), rid
        for i, t in enumerate(seq):
            if t == "resume":
                assert "preempt" in seq[:i], rid
    counters = {c[0] for c in obs.tracer.counters}
    assert counters == {"pool_util", "batch_occupancy", "pending_queue"}


def test_telemetry_off_and_profile_refused(tiny, monkeypatch):
    eng = _engine(tiny)
    assert eng.obs.tracer.enabled is False and eng.obs.profiler is None
    eng.run(_reqs(tiny[0].vocab, n=2))
    assert len(eng.obs.tracer) == 0 and not eng.obs.tracer.counters
    assert eng.metrics.value("engine.requests_finished") == 2
    tel = Telemetry.on(profile=True, reps=2)
    assert isinstance(tel.profiler, DispatchProfiler)
    assert tel.profiler.reps == 2 and tel.tracer.enabled
    # a decode span closes after the step's token readback
    real = ContinuousEngine._pick

    def slow(self, logits, temps):
        time.sleep(0.03)
        return real(self, logits, temps)

    monkeypatch.setattr(ContinuousEngine, "_pick", slow)
    eng = _engine(tiny, telemetry=Telemetry.on())
    eng.run(_reqs(tiny[0].vocab, n=1, new=3))
    spans = [e.dur for e in eng.obs.tracer.events
             if e.etype in ("decode", "chunk_batch")]
    assert spans and min(spans) >= 0.03


# ---------------------------------------------------------------------------
# the async request API
# ---------------------------------------------------------------------------

def test_serve_loop_matches_run(tiny):
    cfg, _ = tiny
    want = {r.rid: r.tokens.tolist()
            for r in _engine(tiny).run(_reqs(cfg.vocab))}
    eng = _engine(tiny, telemetry=Telemetry.on())
    eng.start()
    eng.start()                                 # idempotent
    with pytest.raises(RuntimeError):
        eng.run(_reqs(cfg.vocab))
    for r in _reqs(cfg.vocab):
        eng.submit(dataclasses.replace(r))
        time.sleep(0.002)
    got = [eng.get_result(timeout=60) for _ in range(4)]
    with pytest.raises(queue.Empty):
        eng.get_result(timeout=0.05)
    eng.stop()
    assert eng._thread is None
    assert {r.rid: r.tokens.tolist() for r in got} == want
    assert {r.status for r in got} == {"ok"}
    assert RE.validate_chrome_trace(eng.obs.tracer.chrome_trace()) == []


def test_dead_serve_loop_raises(tiny, monkeypatch):
    """A fault the watchdog does not absorb (here a kernel's) kills the
    loop; ``get_result`` then raises instead of hanging."""
    real = TN.decode_step
    calls = {"n": 0}

    def broken(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KernelError("launch refused")
        return real(*a, **k)

    monkeypatch.setattr(TN, "decode_step", broken)
    monkeypatch.setattr("threading.excepthook", lambda args: None)
    eng = _engine(tiny)
    eng.start()
    eng.submit(_reqs(tiny[0].vocab, n=1, new=6)[0])
    with pytest.raises(RuntimeError, match="serve loop died") as err:
        eng.get_result(timeout=60)
    assert isinstance(err.value.__cause__, KernelError)
    eng.stop()


def test_concurrent_submits_each_get_one_result(tiny):
    """Submitters on more threads than cores, a short switch interval:
    every request gets exactly one Result and the pool stays consistent
    (a lost update of the queue would drop or double one)."""
    import sys
    import threading
    cfg, _ = tiny
    eng = _engine(tiny)
    reqs = [Request(i, np.random.default_rng(i).integers(
        3, cfg.vocab, 6 + i % 5).astype(np.int32), 2, eos=-1)
        for i in range(24)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng.start()
        workers = [threading.Thread(target=lambda k=k: [
            eng.submit(r) for r in reqs[k::12]]) for k in range(12)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        got = [eng.get_result(timeout=60) for _ in reqs]
        eng.stop()
    finally:
        sys.setswitchinterval(interval)
    assert sorted(r.rid for r in got) == list(range(24))
    assert {r.status for r in got} == {"ok"}
    assert eng.drain_results() == []
    eng.pool.check()
