"""Port parity: the dispatch profiler (``repro_torch.obs.profile``), the
step's dispatch indirection, ``launch.serve --profile`` and the two
report CLIs, against ``repro.obs.profile`` and the reference's
``scripts/trace_report.py`` / ``scripts/plan_report.py``.

  * One profiled run (scaled-down fp32 qwen2, the port's own seeded
    weights x4, ngram speculation): calibration spans for all four
    dispatch names, serve spans for the dispatches the run executes, the
    ``profile.*_us`` histograms counting the spans, a trace that passes
    both packages' validators, and the tokens of an unprofiled run.
  * ``attach`` mid-flight leaves the engine bit-identical (caches,
    recurrent state, block tables, pool, cursors, sampler, schedule
    statistics) on qwen2 and on mamba2, and the run's tokens unchanged;
    a dense engine is refused.
  * The port's trace feeds the reference's calibration fit and a trace
    from the reference's tracer feeds the port's; the reference's report
    scripts, loaded by path, give the port's drift rows, waterfall and
    ``plan_report`` JSON on the port's trace.

Every engine here runs on the CPU; no reference engine runs.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import events as JEV
from repro.planner import calibrate as JCAL
from repro_torch import configs as TC
from repro_torch.launch import plan_report as TPR
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import trace_report as TTR
from repro_torch.models import network as TN
from repro_torch.models.layers import tree_map
from repro_torch.obs import (DISPATCH_NAMES, DispatchProfiler, Telemetry,
                             validate_chrome_trace)
from repro_torch.planner import calibrate as TCAL
from repro_torch.serving.engine import ContinuousEngine, Request

ROOT = Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model(arch, scale):
    cfg = TC.get(arch).scaled_down()
    return cfg, tree_map(lambda _p, a: a * scale, TN.init(cfg, 0, "cpu"))


def _reqs(vocab, n=3, new=6):
    out = []
    for i in range(n):
        rng = np.random.default_rng(i)
        # a repeated phrase gives the ngram drafter something to match
        phrase = rng.integers(3, vocab, 6)
        prompt = np.concatenate([rng.integers(3, vocab, 14 + 5 * i),
                                 phrase, phrase]).astype(np.int32)
        out.append(Request(i, prompt, new, eos=-1))
    return out


def _engine(model, **kw):
    cfg, params = model
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 96)
    return ContinuousEngine(cfg, params, device="cpu", **kw)


@pytest.fixture(scope="module")
def qwen():
    return _model("qwen2_0_5b", 4.0)


@pytest.fixture(scope="module")
def profiled(qwen):
    reqs = _reqs(qwen[0].vocab)
    want = {r.rid: r.tokens.tolist()
            for r in _engine(qwen, spec="ngram").run(reqs)}
    eng = _engine(qwen, spec="ngram",
                  telemetry=Telemetry.on(profile=True, reps=2))
    got = {r.rid: r.tokens.tolist() for r in eng.run(_reqs(qwen[0].vocab))}
    return eng, want, got


def test_profiled_run_covers_every_dispatch(profiled):
    eng, want, got = profiled
    assert got == want
    assert len({t for v in got.values() for t in v}) > 4
    prof = eng.obs.profiler
    assert isinstance(prof, DispatchProfiler) and prof.reps == 2
    kinds = {}
    for s in prof.spans:
        kinds.setdefault(s["name"], []).append(s["kind"])
    assert set(kinds) == set(DISPATCH_NAMES)
    for name in DISPATCH_NAMES:
        assert kinds[name].count("calibration") == 2, name
    # a spec run serves chunk batches and verify steps, no decode step
    serve = {n for n, k in kinds.items() if "serve" in k}
    assert serve == {"prefill_paged_chunk", "verify_paged_chunk"}
    assert kinds["verify_paged_chunk"].count("serve") == eng.steps
    assert kinds["prefill_paged_chunk"].count("serve") == eng.chunk_steps
    for s in prof.spans:
        assert s["dur_s"] > 0 and s["modeled_cycles"] > 0
        assert s["flops"] > 0 and s["bytes"] > 0
    assert eng.spec_stats()["accepted"] > 0


def test_profile_histograms_and_trace(profiled):
    eng, _, _ = profiled
    prof = eng.obs.profiler
    for name in DISPATCH_NAMES:
        h = eng.metrics.get(f"profile.{name}_us")
        assert h.count == sum(s["name"] == name for s in prof.spans)
    doc = eng.obs.tracer.chrome_trace()
    assert validate_chrome_trace(doc) == []
    assert JEV.validate_chrome_trace(doc) == []
    disp = [e for e in doc["traceEvents"] if e.get("cat") == "dispatch"]
    assert len(disp) == len(prof.spans)
    assert all(e["pid"] == 2 and e["ph"] == "X" for e in disp)
    assert {e["args"]["dispatch"] for e in disp} == set(DISPATCH_NAMES)


def test_port_trace_feeds_reference_fit(profiled):
    eng, _, _ = profiled
    ev = eng.obs.tracer.chrome_trace()["traceEvents"]
    t = TCAL.calibration_from_events(ev, meta={"src": "port"})
    j = JCAL.calibration_from_events(ev, meta={"src": "port"})
    assert t.to_json() == j.to_json()
    assert set(t.cycles) == set(DISPATCH_NAMES)
    assert t.host_us_per_dispatch > 0 and t.startup_us > 0
    assert TCAL.drift_rows(ev) == JCAL.drift_rows(ev)


def test_reference_trace_feeds_port(profiled):
    """A trace written by the reference's tracer, with the events its
    engine and profiler emit (the port's run replayed through it), gives
    the port's fit, drift rows, trace adapters and report the
    reference's results."""
    from repro.obs.events import Tracer as JTracer
    from repro.planner import model as JM
    from repro_torch.planner import model as TM
    eng, _, _ = profiled
    tr = JTracer(enabled=True)
    for e in eng.obs.tracer.events:
        tr.event(e.etype, rid=e.rid, slot=e.slot, step=e.step, ts=e.ts,
                 dur=e.dur, **e.args)
    ev = tr.chrome_trace()["traceEvents"]
    assert JEV.validate_chrome_trace(tr.chrome_trace()) == []
    assert (TCAL.calibration_from_events(ev).to_json()
            == JCAL.calibration_from_events(ev).to_json())
    assert TCAL.drift_rows(ev) == JCAL.drift_rows(ev)
    assert ([vars(r) for r in TM.requests_from_trace(ev)]
            == [vars(r) for r in JM.requests_from_trace(ev)])
    assert TM.measured_latencies(ev) == JM.measured_latencies(ev)
    assert TTR.render_drift(ev) == _script("trace_report").render_drift(ev)


def test_reports_match_reference_scripts(profiled, tmp_path, capsys):
    eng, _, _ = profiled
    trace = str(tmp_path / "t.json")
    eng.obs.export_trace(trace)
    ev = json.loads(Path(trace).read_text())["traceEvents"]
    rtr, rpr = _script("trace_report"), _script("plan_report")
    assert TTR.render_drift(ev) == rtr.render_drift(ev)
    assert TTR.render_waterfall(ev) == rtr.render_waterfall(ev)
    outs = {}
    for tag, mod in (("port", TTR), ("ref", rtr)):
        cal = str(tmp_path / f"cal_{tag}.json")
        assert mod.main([trace, "--validate", "--calibration-out",
                         cal]) == 0
        outs[tag] = json.loads(Path(cal).read_text())
    assert outs["port"] == outs["ref"]
    geom = ["--arch", "qwen2-0.5b", "--scaled-down", "--slots", "2",
            "--max-len", "96", "--spec"]
    for tag, mod in (("port", TPR), ("ref", rpr)):
        out = str(tmp_path / f"drift_{tag}.json")
        assert mod.main(["drift", trace, *geom, "--out", out]) == 0
        outs[tag] = json.loads(Path(out).read_text())
    assert outs["port"] == outs["ref"]
    assert outs["port"]["steps_modeled"] > 0
    for cmd in (["sweep", "--replicas", "1,2"],
                ["frontier", "--rates", "10,1000", "--slo-ms", "50"],
                ["headroom"]):
        for tag, mod in (("port", TPR), ("ref", rpr)):
            out = str(tmp_path / f"{cmd[0]}_{tag}.json")
            assert mod.main([cmd[0], trace, *geom, *cmd[1:],
                             "--out", out]) == 0
            outs[tag] = json.loads(Path(out).read_text())
        assert outs["port"] == outs["ref"], cmd[0]
    # an unprofiled expectation list fails validation on a missing name
    assert TTR.main([trace, "--validate", "--expect-dispatches",
                     "decode_step,absent_dispatch"]) == 1
    capsys.readouterr()


# ---------------------------------------------------------------------------
# attach leaves the engine as it was
# ---------------------------------------------------------------------------

def _leaves(tree):
    out = []
    tree_map(lambda _p, a: out.append(a.clone()), tree)
    return out


def _state(eng):
    st = eng.schedule.stats()
    # entries may grow: the planner read memoizes unseen shapes
    return {"caches": _leaves(eng.caches), "bt": eng._bt.clone(),
            "pos": eng._pos.copy(), "pool": eng.pool.snapshot_state(),
            "generator": eng.generator.get_state(),
            "schedule": (st["hits"], st["misses"], st["applied"],
                         eng.schedule.key_stats(),
                         list(eng.schedule.applied)),
            "counters": (eng.steps, eng.chunk_steps, eng.admissions)}


def _same(a, b):
    assert len(a["caches"]) == len(b["caches"])
    for x, y in zip(a["caches"], b["caches"]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(a["bt"], b["bt"])
    assert np.array_equal(a["pos"], b["pos"])
    assert torch.equal(a["generator"], b["generator"])
    for k in ("pool", "schedule", "counters"):
        assert a[k] == b[k], k


@pytest.mark.parametrize("arch,scale", [("qwen2_0_5b", 4.0),
                                        ("mamba2_2_7b", 1.0)])
def test_attach_mid_flight_leaves_engine_bit_identical(arch, scale):
    model = _model(arch, scale)
    reqs = _reqs(model[0].vocab, n=3, new=8)
    want = {r.rid: r.tokens.tolist() for r in _engine(model).run(reqs)}
    eng = _engine(model, telemetry=Telemetry.on())
    for r in _reqs(model[0].vocab, n=3, new=8):
        eng.submit(r)
    for _ in range(4):                   # prefill, then decode steps
        eng.step()
    before = _state(eng)
    assert before["counters"][0] > 0 and any(
        x.abs().sum() > 0 for x in before["caches"])
    prof = DispatchProfiler(reps=1)
    eng.obs.profiler = prof
    prof.attach(eng)
    _same(before, _state(eng))
    names = {s["name"] for s in prof.spans}
    assert names == set(DISPATCH_NAMES) - (
        {"verify_paged_chunk"} if model[0].has_recurrent_state else set())
    got = {}
    while len(got) < len(reqs):
        eng.step()
        got.update({r.rid: r.tokens.tolist() for r in eng.drain_results()})
    assert got == want
    assert any(s["kind"] == "serve" and s["name"] == "decode_step"
               for s in prof.spans)


def test_dense_engine_refuses_profiler(qwen):
    with pytest.raises(ValueError, match="paged"):
        _engine(qwen, paged=False, telemetry=Telemetry.on(profile=True))


def test_serve_cli_profile(tmp_path, capsys):
    trace = str(tmp_path / "t.json")
    rep = TSERVE.main(["--arch", "qwen2_0_5b", "--scaled-down",
                       "--device", "cpu", "--profile", "--trace-out",
                       trace, "--requests", "3", "--max-new", "4",
                       "--prompt-len", "20", "--slots", "2",
                       "--max-len", "96"])
    assert rep["ok"] == 3 and rep["profile_spans"] > 0
    assert TTR.main([trace, "--validate", "--expect-dispatches",
                     ",".join(DISPATCH_NAMES)]) == 0
    assert TPR.main(["drift", trace, "--arch", "qwen2_0_5b",
                     "--scaled-down", "--slots", "2", "--max-len",
                     "96"]) == 0
    for engine in ("dense", "wave"):
        with pytest.raises(SystemExit, match="profile"):
            TSERVE.main(["--arch", "qwen2_0_5b", "--scaled-down",
                         "--device", "cpu", "--profile", "--engine",
                         engine])
    capsys.readouterr()
