"""Port parity: the serving fault-tolerance plane
(``repro_torch.serving.resilience``, ``runtime.faults``, the engine's
guards, step watchdog and warm restart) against ``repro.serving``.

  * The fault drills of ``tests/_resilience_trace.py`` (allocation
    denials, transient step faults, poison, a cancel, a hard deadline,
    shedding, speculation under extend denials and corrupted drafts, a
    crash served through ``serve_with_restarts``) give the reference's
    per-request tokens, statuses and errors, its lifecycle events
    ``(etype, rid, slot, step)`` in order and its deterministic
    counters.  The engines register the reference's metric names.
  * ``FaultPlane.random`` draws the reference's schedules (seeds 0-23),
    and ``classify_error``, ``RestartPolicy`` and ``run_with_restarts``
    agree with the reference's.
  * The guards at the reference's ``tests/test_chaos.py`` geometry (2
    slots, max_len 96), a chaos sweep at 6 seeds, device faults
    propagating out of ``step()``, and a genuine failure part way
    through a step re-run to the same tokens.

The reference engines run in one process, started with this file's first
test and running beside the others; each of its dispatches gets a copy
of the host arrays it reads (``tests/test_torch_serving_paths.py`` says
why).  Scaled-down fp32 qwen2 at weights x4.
"""

import dataclasses
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _resilience_trace as RT
from _torch_port import reference_params, reference_process
from repro_torch.kernels._build import KernelError
from repro_torch.models import bridge
from repro_torch.models import network as TN
from repro_torch.obs import Telemetry
from repro_torch.runtime import faults as TF
from repro_torch.runtime.faults import RestartPolicy, run_with_restarts
from repro_torch.serving import engine as TE
from repro_torch.serving.engine import ContinuousEngine, Request
from repro_torch.serving.kv_pool import KVPool, PoolAuditError
from repro_torch.serving.resilience import (RESULT_STATUSES, EngineCrash,
                                            FaultPlane, FaultSpec,
                                            InjectedFault, ResilienceConfig,
                                            classify_error,
                                            serve_with_restarts)

ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = """
from repro.obs import Telemetry
from repro.serving.engine import ContinuousEngine, Request
from repro.serving.resilience import (FaultPlane, FaultSpec,
                                      ResilienceConfig, serve_with_restarts)
import _resilience_trace as RT
from _torch_port import reference_params
jcfg, params, _ = reference_params()
params = jax.tree.map(jnp.asarray, params)

def make(**kw):
    return ContinuousEngine(jcfg, params, slots=RT.SLOTS,
                            max_len=RT.MAX_LEN, audit=True, **kw)

api = types.SimpleNamespace(
    make=make, Request=Request, FaultPlane=FaultPlane, FaultSpec=FaultSpec,
    ResilienceConfig=ResilienceConfig,
    serve_with_restarts=serve_with_restarts, Telemetry=Telemetry)
print(json.dumps({
    "drills": {d: RT.drill(d, api, jcfg.vocab) for d in RT.DRILLS},
    "metrics": {k: RT.metric_kinds(make(**kw))
                for k, kw in RT.METRIC_CONFIGS.items()}}))
"""


@pytest.fixture(scope="module", autouse=True)
def reference_proc():
    """The reference's drills, started with the file's first test so that
    they run beside the in-process tests (which take half the cores
    meanwhile)."""
    yield from reference_process(_REFERENCE, ROOT, one_thread=False)


_RUNS: dict = {}


def reference_runs(proc) -> dict:
    if not _RUNS:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-2000:]
        _RUNS.update(json.loads(out.strip().splitlines()[-1]))
    return _RUNS


@pytest.fixture(scope="module")
def tiny():
    _jcfg, params, cfg = reference_params()
    return cfg, bridge.from_jax_params(params, cfg, "cpu")


def _engine(tiny, **kw):
    cfg, params = tiny
    kw.setdefault("slots", RT.SLOTS)
    kw.setdefault("max_len", RT.MAX_LEN)
    kw.setdefault("audit", True)
    return ContinuousEngine(cfg, params, device="cpu", **kw)


def _req(rid, plen, max_new, vocab, **kw):
    rng = np.random.default_rng(rid)
    return Request(rid=rid, prompt=rng.integers(3, vocab, plen).astype(
        np.int32), max_new_tokens=max_new, eos=-1, **kw)


def _reqs(vocab, n=4, plen=20, max_new=4):
    return [_req(i, plen, max_new, vocab) for i in range(n)]


def _tokens(results) -> dict:
    return {r.rid: [int(t) for t in r.tokens] for r in results}


def _run_plain(tiny, reqs, **kw):
    return _tokens(_engine(tiny, **kw).run(
        [dataclasses.replace(r) for r in reqs]))


def _pump(eng, n, max_steps=500):
    out = list(eng.drain_results())
    for _ in range(max_steps):
        if len(out) >= n:
            return out
        eng.step()
        out += eng.drain_results()
    raise AssertionError(f"only {len(out)}/{n} results")


@pytest.fixture(scope="module")
def baseline(tiny):
    return _run_plain(tiny, _reqs(tiny[0].vocab))


# ---------------------------------------------------------------------------
# the plane's plumbing against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"rids": (0, 1, 2, 3), "horizon": 24},
                                {"rids": (5, 9), "horizon": 16,
                                 "n_faults": 7}],
                         ids=["default", "chaos", "wide"])
def test_random_schedules_match_reference(kw):
    from repro.serving import resilience as R
    for seed in range(24):
        assert FaultPlane.random(seed, **kw).to_schedule() == \
            R.FaultPlane.random(seed, **kw).to_schedule(), seed
        sched = FaultPlane.random(seed, **kw).to_schedule()
        assert sum(s["kind"] == "crash" for s in sched) <= 1
        assert FaultPlane.from_schedule(sched).to_schedule() == sched


def test_fault_spec_validation_and_labels():
    from repro.serving import resilience as R
    from repro.serving.kv_pool import PoolAuditError as RefAudit
    for bad in ({"kind": "meteor"}, {"kind": "dispatch", "count": 0}):
        with pytest.raises(ValueError):
            FaultSpec(**bad)
        with pytest.raises(ValueError):
            R.FaultSpec(**bad)
    cases = [(InjectedFault("poison", rid=3), R.InjectedFault("poison",
                                                              rid=3)),
             (MemoryError("x"), MemoryError("x")),
             (PoolAuditError(["v"], {}), RefAudit(["v"], {})),
             (ValueError("x"), ValueError("x"))]
    for port, ref in cases:
        assert classify_error(port) == R.classify_error(ref)
    assert classify_error(torch.OutOfMemoryError("card")) == "resource"
    assert RESULT_STATUSES == R.RESULT_STATUSES
    assert FaultSpec("poison", rid=2).to_dict() == \
        R.FaultSpec("poison", rid=2).to_dict()


def test_restart_policy_and_driver_match_reference():
    from repro.runtime import faults as RF
    for kw in ({}, {"backoff_s": 0.5, "backoff_max_s": 3.0, "jitter": 0.3},
               {"backoff_s": 0.0}):
        port, ref = RestartPolicy(**kw), RF.RestartPolicy(**kw)
        for restarts in range(1, 9):
            for u in (0.0, 0.25, 0.99):
                assert port.delay_s(restarts, u) == ref.delay_s(restarts, u)

    def drive(mod):
        inj = mod.FailureInjector((3, 7), count=2)
        slept, resumed = [], []

        def loop(step):
            while step < 12:
                inj.maybe_fail(step)
                step += 1
            return step

        def on_restart(step, exc):
            resumed.append((step, str(exc)))
            return step

        final = mod.run_with_restarts(
            loop, start_step=0, final_step=12,
            policy=mod.RestartPolicy(backoff_s=0.1, jitter=0.5),
            on_restart=on_restart, sleep=slept.append, rng=lambda: 0.5)
        return final, slept, resumed

    assert drive(TF) == drive(RF)

    def dead(_step):
        raise RuntimeError("host lost")

    with pytest.raises(RuntimeError):
        run_with_restarts(dead, start_step=0, final_step=1,
                          policy=RestartPolicy(max_restarts=2,
                                               backoff_s=0.0))


def test_pool_from_snapshot_round_trip(tiny):
    """``from_snapshot`` inverts ``snapshot_state`` on a pool mid-run
    (shared prefixes, cached blocks, a slot mid-decode), and rebuilds the
    reference's state from the port's snapshot."""
    from repro.serving.kv_pool import KVPool as RefPool
    eng = _engine(tiny, slots=2, max_len=96)
    pre = np.arange(3, 40, dtype=np.int32)
    for rid in range(3):
        eng.submit(Request(rid, np.concatenate([pre, [50 + rid]]).astype(
            np.int32), max_new_tokens=5, eos=-1))
    for _ in range(4):
        eng.step()
    s = eng.pool.snapshot_state()
    assert s["prefix"] and s["n_slot_blocks"] != [0, 0]
    assert KVPool.from_snapshot(s).snapshot_state() == s
    ref = RefPool.from_snapshot(s).snapshot_state()
    ref.pop("prefix_blocks")
    assert ref == json.loads(json.dumps(s))
    assert KVPool.from_snapshot(s).audit_violations() == []


# ---------------------------------------------------------------------------
# lifecycle guards (the reference's tests/test_chaos.py, on the port)
# ---------------------------------------------------------------------------

def test_cancel_queued_and_running(tiny, baseline):
    cfg, _ = tiny
    reqs = _reqs(cfg.vocab)
    eng = _engine(tiny)
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    assert eng.cancel(99) is False
    assert eng.cancel(3) is True               # still queued
    for _ in range(3):
        eng.step()
    running = next(s.req.rid for s in eng._slots if s is not None)
    assert eng.cancel(running) is True
    out = {r.rid: r for r in _pump(eng, len(reqs))}
    assert eng.cancel(3) is False
    assert out[3].status == "cancelled" and len(out[3].tokens) == 0
    assert out[running].status == "cancelled"
    for rid in set(out) - {3, running}:
        assert out[rid].status == "ok"
        assert [int(t) for t in out[rid].tokens] == baseline[rid]
    eng.pool.check()
    assert eng.metrics.value("resilience.cancelled") == 2


def test_hard_deadline_times_out(tiny):
    cfg, _ = tiny
    eng = _engine(tiny)
    eng.submit(_req(0, 20, 4, cfg.vocab, deadline_s=0.0))
    eng.submit(_req(1, 20, 4, cfg.vocab, ttft_deadline_s=3600.0))
    out = {r.rid: r for r in _pump(eng, 2)}
    assert out[0].status == "timeout" and out[0].error == "deadline_s exceeded"
    assert out[1].status == "ok"
    assert eng.metrics.value("resilience.timeouts") == 1
    eng.pool.check()


def test_load_shedding_and_backpressure(tiny):
    cfg, _ = tiny
    eng = _engine(tiny, resilience=ResilienceConfig(max_pending=3))
    assert eng.backpressure() is False
    for i in range(6):
        eng.submit(_req(i, 8, 2, cfg.vocab))
    assert eng.backpressure() is True
    shed = [r for r in eng.drain_results() if r.status == "shed"]
    assert sorted(r.rid for r in shed) == [3, 4, 5]
    assert len(shed + _pump(eng, 3)) == 6
    assert eng.backpressure() is False
    assert eng.metrics.value("resilience.shed") == 3
    eng.pool.check()


def test_poisoned_request_quarantined_alone(tiny, baseline):
    cfg, _ = tiny
    eng = _engine(tiny, faults=FaultPlane([FaultSpec("poison", rid=1)]))
    out = {r.rid: r for r in eng.run(_reqs(cfg.vocab))}
    assert out[1].status == "failed" and out[1].error == "injected:poison"
    for rid in set(out) - {1}:
        assert out[rid].status == "ok"
        assert [int(t) for t in out[rid].tokens] == baseline[rid]
    eng.pool.check()
    assert eng.metrics.value("resilience.quarantined") == 1


def test_admission_retries_exhaust_terminally(tiny):
    cfg, _ = tiny
    eng = _engine(tiny, faults=FaultPlane([FaultSpec("reserve", at=0,
                                                     count=100)]),
                  resilience=ResilienceConfig(max_admit_retries=3,
                                              admit_backoff_steps=1))
    eng.submit(_req(0, 8, 2, cfg.vocab))
    [r] = _pump(eng, 1)
    assert r.status == "failed" and "admission failed" in r.error
    assert eng.metrics.value("resilience.admit_failures") == 4
    eng.pool.check()


def test_transient_dispatch_failure_retries_token_identical(tiny,
                                                            baseline):
    cfg, _ = tiny
    eng = _engine(tiny, faults=FaultPlane([FaultSpec("dispatch", at=5)]))
    out = eng.run(_reqs(cfg.vocab))
    assert {r.status for r in out} == {"ok"}
    assert _tokens(out) == baseline
    assert eng.metrics.value("resilience.retries") == 1
    assert eng.metrics.value("resilience.faults_injected") == 1
    eng.pool.check()


@pytest.mark.parametrize("fault", ["extend", "draft"])
def test_spec_faults_keep_tokens(tiny, baseline, fault):
    """Extend denials degrade the live spec_k, corrupted drafts are
    rejected: greedy tokens equal the vanilla run's either way."""
    cfg, _ = tiny
    spec = FaultSpec("extend", at=2, count=2) if fault == "extend" else \
        FaultSpec("draft", at=3, count=2)
    eng = _engine(tiny, faults=FaultPlane([spec]), spec="ngram", spec_k=4,
                  resilience=ResilienceConfig(spec_degrade=True))
    assert _tokens(eng.run(_reqs(cfg.vocab))) == baseline
    if fault == "extend":
        assert eng.metrics.value("resilience.spec_degrades") >= 1
    eng.pool.check()


def test_crash_without_driver_propagates(tiny):
    cfg, _ = tiny
    eng = _engine(tiny, faults=FaultPlane([FaultSpec("crash", at=0)]))
    eng.submit(_req(0, 8, 2, cfg.vocab))
    with pytest.raises(EngineCrash):
        for _ in range(50):
            eng.step()


def test_restore_requires_fresh_engine(tiny):
    cfg, _ = tiny
    eng = _engine(tiny)
    eng.submit(_req(0, 8, 2, cfg.vocab))
    snap = eng.snapshot()
    assert len(snap["in_flight"]) == 1
    assert json.loads(json.dumps(snap)) == snap
    with pytest.raises(RuntimeError):
        eng.restore(snap)


def test_warm_restart_mid_trace_token_identical(tiny, baseline):
    cfg, _ = tiny
    plane = FaultPlane([FaultSpec("crash", at=6)])
    engines = []

    def make_engine():
        engines.append(_engine(tiny, faults=plane))
        return engines[-1]

    results = serve_with_restarts(make_engine, _reqs(cfg.vocab))
    assert len(engines) == 2
    assert {r.status for r in results} == {"ok"}
    assert _tokens(results) == baseline
    engines[-1].pool.check()
    assert engines[-1].metrics.value("resilience.restored") > 0


def test_default_resilience_config_is_noop(tiny, baseline):
    cfg, _ = tiny
    assert _run_plain(tiny, _reqs(cfg.vocab),
                      resilience=ResilienceConfig()) == baseline


# ---------------------------------------------------------------------------
# the chaos sweep: seeded random schedules, three invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_chaos_schedule_invariants(tiny, baseline, seed, tmp_path):
    cfg, _ = tiny
    reqs = _reqs(cfg.vocab)
    plane = FaultPlane.random(seed, rids=[r.rid for r in reqs], horizon=24)
    engines = []

    def make_engine():
        engines.append(_engine(
            tiny, faults=plane,
            resilience=ResilienceConfig(max_admit_retries=40)))
        return engines[-1]

    try:
        results = serve_with_restarts(make_engine, reqs, max_steps=2_000)
        assert sorted(r.rid for r in results) == [r.rid for r in reqs]
        assert all(r.status in RESULT_STATUSES for r in results)
        engines[-1].pool.check()
        for r in results:
            if r.status == "ok":
                assert [int(t) for t in r.tokens] == baseline[r.rid]
        crashed = any(f["kind"] == "crash" for f in plane.fired)
        assert len(engines) == (2 if crashed else 1)
    except BaseException:
        (tmp_path / f"failed_seed{seed}.json").write_text(json.dumps(
            {"seed": seed, "schedule": plane.to_schedule(),
             "fired": plane.fired}, indent=1))
        raise


# ---------------------------------------------------------------------------
# the port's own design points: device faults, in-place state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exc", [KernelError, torch.AcceleratorError],
                         ids=["kernel_error", "accelerator_error"])
def test_device_faults_propagate(tiny, monkeypatch, exc):
    """A kernel that fails to build or launch, and a sticky CUDA error,
    leave ``step()`` (and ``serve_with_restarts``): never retried, never
    a failed Result."""
    cfg, _ = tiny
    real = TN.decode_step

    def broken(*a, **k):
        real(*a, **k)
        raise exc("injected device fault")

    monkeypatch.setattr(TN, "decode_step", broken)
    eng = _engine(tiny)
    eng.submit(_req(0, 8, 4, cfg.vocab))
    with pytest.raises(exc):
        for _ in range(20):
            eng.step()
    assert eng.drain_results() == []
    assert eng.metrics.value("resilience.retries") == 0
    engines = []
    with pytest.raises(exc):
        serve_with_restarts(
            lambda: engines.append(_engine(tiny)) or engines[-1],
            [_req(0, 8, 4, cfg.vocab)])
    assert len(engines) == 1


_STEPS = {"decode": ("decode_step", "decode"),
          "chunk": ("prefill_paged_chunk", "chunk"),
          "verify": ("verify_paged_chunk", "verify")}


@pytest.mark.parametrize("kind", ["decode", "chunk", "verify", "sampled"])
def test_genuine_midstep_failure_retries_same_tokens(tiny, baseline,
                                                     monkeypatch, kind):
    """A step whose model call ran (KV rows written in place) and then
    raised is re-run next step to the same tokens: no cursor, token,
    chunk queue, table or generator state moved before the readback."""
    cfg, _ = tiny
    reqs = _reqs(cfg.vocab, max_new=6)
    spec = {"spec": "ngram"} if kind == "verify" else {}
    if kind == "sampled":
        reqs = [dataclasses.replace(r, temperature=0.8) for r in reqs]
    want = _run_plain(tiny, reqs, **spec)
    if kind == "sampled":
        fn, target = TE, "_draw"        # fail after the generator moved
    else:
        fn, target = TN, _STEPS[kind][0]
    real = getattr(fn, target)
    calls = {"n": 0}

    def flaky(*a, **k):
        out = real(*a, **k)
        calls["n"] += 1
        if calls["n"] in (2, 3):
            raise RuntimeError("mid-step failure")
        return out

    monkeypatch.setattr(fn, target, flaky)
    eng = _engine(tiny, resilience=ResilienceConfig(dispatch_retries=2),
                  **spec)
    out = eng.run([dataclasses.replace(r) for r in reqs])
    assert {r.status for r in out} == {"ok"}
    assert _tokens(out) == want
    assert eng.metrics.value("resilience.retries") == 2
    assert isinstance(eng.last_dispatch_error, RuntimeError)
    eng.pool.check()


def test_recurrent_state_failure_fails_the_step(monkeypatch):
    """mamba2 writes its recurrent state in place layer by layer: a
    genuine failure part way through a step fails that step's requests
    (a re-run would apply the step twice) and the engine serves on."""
    from repro_torch import configs as TC
    cfg = TC.get("mamba2_2_7b").scaled_down()
    params = TN.init(cfg, 0, "cpu")
    real = TN.decode_step
    calls = {"n": 0}

    def flaky(*a, **k):
        out = real(*a, **k)
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("mid-step failure")
        return out

    monkeypatch.setattr(TN, "decode_step", flaky)
    eng = ContinuousEngine(cfg, params, slots=2, max_len=64, audit=True,
                           device="cpu")
    out = {r.rid: r for r in eng.run(_reqs(cfg.vocab, n=3, plen=8,
                                           max_new=4))}
    failed = {rid for rid, r in out.items() if r.status == "failed"}
    assert failed and all(out[rid].error == "RuntimeError" for rid in failed)
    assert all(r.status == "ok" for rid, r in out.items()
               if rid not in failed)
    assert eng.metrics.value("resilience.retries") == 0
    assert eng.metrics.value("resilience.quarantined") == len(failed)


# ---------------------------------------------------------------------------
# the drills against the reference (its process has been running)
# ---------------------------------------------------------------------------

_PORT_DRILLS: dict = {}


def port_drill(tiny, name: str) -> dict:
    if name not in _PORT_DRILLS:
        api = types.SimpleNamespace(
            make=lambda **kw: _engine(tiny, **kw), Request=Request,
            FaultPlane=FaultPlane, FaultSpec=FaultSpec,
            ResilienceConfig=ResilienceConfig,
            serve_with_restarts=serve_with_restarts, Telemetry=Telemetry)
        _PORT_DRILLS[name] = json.loads(json.dumps(
            RT.drill(name, api, tiny[0].vocab)))
    return _PORT_DRILLS[name]


@pytest.mark.parametrize("part", ["results", "events", "counters"])
@pytest.mark.parametrize("name", RT.DRILLS)
def test_drill_matches_reference(reference_proc, tiny, name, part):
    ref = reference_runs(reference_proc)["drills"][name]
    got = port_drill(tiny, name)
    if part == "counters":
        assert (got["counters"], got["fired"], got["engines"]) == (
            ref["counters"], ref["fired"], ref["engines"])
    else:
        assert got[part] == ref[part]
    if part == "results":
        assert any(r[1] == "ok" and len(set(r[0])) > 1
                   for r in got["results"].values())


@pytest.mark.parametrize("config", list(RT.METRIC_CONFIGS))
def test_engine_metric_names_match_reference(reference_proc, tiny, config):
    ref = reference_runs(reference_proc)["metrics"][config]
    assert RT.metric_kinds(_engine(tiny, **RT.METRIC_CONFIGS[config])) == ref
