"""Port parity: the capacity planner (``repro_torch.planner``), the
schedule cache's planner read path and ``launch.step_cost``, against
``repro.planner``, ``repro.core.scheduler`` and ``repro.launch.jaxpr_cost``.

  * Exact: ``modeled_cycles`` and ``key_stats`` on a seeded stream of
    shapes (``modeled_cycles`` moves no statistic), the per-dispatch GEMM
    attribution of all seven served archs, the workload model's cycles,
    traffic and step costs, the simulator's counts and occupancy on three
    seeded traces, and the model policies' decisions under those costs.
  * The reference's engine fixture replayed against the port's engine:
    the planner's steps and chunk steps equal the engine's, and planning
    moves no schedule statistic.
  * Relative 1e-9: microsecond predictions under one calibration, the
    capacity queries, the calibration fit and its JSON across packages,
    and the trace adapters.
  * ``step_cost`` against the reference's jaxpr count: the head exactly
    2 * slots * vocab * d, the other dispatches' flops within 1%, bytes
    within 25%, and the reference's own pins.

The reference's committed serve_bench calibrations load in the port.
Everything but the one engine run is host arithmetic.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro import configs as JC
from repro import planner as JP
from repro.core import scheduler as JS
from repro.obs import profile as JPROF
from repro.planner import calibrate as JCAL
from repro.planner import model as JM
from repro.serving import policy as JPOL
from repro_torch import configs as TC
from repro_torch import planner as TP
from repro_torch.core import scheduler as TS
from repro_torch.obs import profile as TPROF
from repro_torch.planner import calibrate as TCAL
from repro_torch.planner import model as TM
from repro_torch.serving import policy as TPOL

REL = 1e-9
ARCHS = ("qwen2_0_5b", "mamba2_2_7b", "qwen1_5_4b", "chatglm3_6b",
         "gemma2_9b", "llava_next_mistral_7b", "zamba2_7b")


def _choice(c):
    return (c.dataflow.name, dataclasses.astuple(c.array), c.k_fold,
            c.direction.name, c.cycles, c.traffic_bytes)


def _close(a, b):
    """Equal structures, floats within REL."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=REL, abs=1e-12)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# ScheduleCache: the planner's read path and the per-key statistics
# ---------------------------------------------------------------------------

def test_modeled_cycles_and_key_stats_match_reference():
    rng = np.random.default_rng(0)
    caches = {"ref": JS.ScheduleCache(), "port": TS.ScheduleCache()}
    shapes = [(int(rng.choice([1, 2, 8, 64, 256])),
               int(rng.choice([64, 128, 896, 4864])),
               int(rng.choice([64, 128, 896])),
               str(rng.choice(["FP32", "BP16", "INT8"])))
              for _ in range(40)]
    for shape in shapes:
        got = {k: _choice(c.resolve(*shape)) for k, c in caches.items()}
        assert got["ref"] == got["port"], shape
    stats = {k: (c.stats(), c.key_stats()) for k, c in caches.items()}
    assert stats["ref"] == stats["port"]
    assert sum(v["hits"] for v in stats["port"][1].values()) > 0
    assert len(caches["port"]) == len(caches["ref"])
    # planner reads: seen and unseen shapes, no statistic moves
    for shape in shapes[:5] + [(3, 320, 192, "FP32"), (5, 64, 640, "INT8")]:
        got = {k: _choice(c.modeled_cycles(*shape))
               for k, c in caches.items()}
        assert got["ref"] == got["port"], shape
    assert {k: (c.stats()["hits"], c.stats()["misses"], c.key_stats())
            for k, c in caches.items()} == {
        k: (s[0]["hits"], s[0]["misses"], s[1]) for k, s in stats.items()}
    assert len(caches["port"]) == len(caches["ref"])
    # an unseen shape read by the planner then resolves as a hit
    hits = caches["port"].stats()["hits"]
    caches["port"].resolve(3, 320, 192, "FP32")
    assert caches["port"].stats()["hits"] == hits + 1
    assert ([(k, _choice(c)) for k, c in caches["port"].summary()]
            == [(k, _choice(c)) for k, c in caches["ref"].summary()])
    caches["port"].reset()
    assert caches["port"].key_stats() == {}


# ---------------------------------------------------------------------------
# per-dispatch GEMM attribution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_gemm_shapes_match_reference(arch):
    for scaled in (True, False):
        jcfg, tcfg = JC.get(arch), TC.get(arch)
        if scaled:
            jcfg, tcfg = jcfg.scaled_down(), tcfg.scaled_down()
        for geom in (dict(slots=2, prefill_chunk=32, spec_k=4,
                          block_size=16),
                     dict(slots=8, prefill_chunk=256, spec_k=2,
                          block_size=32)):
            assert (TPROF.dispatch_gemm_shapes(tcfg, **geom)
                    == JPROF.dispatch_gemm_shapes(jcfg, **geom)), (
                arch, scaled, geom)
    assert TPROF.DISPATCH_NAMES == JPROF.DISPATCH_NAMES


# ---------------------------------------------------------------------------
# the workload model and the simulator
# ---------------------------------------------------------------------------

def _models(arch="qwen2_0_5b", **geom):
    return (JM.WorkloadModel(JC.get(arch).scaled_down(),
                             JM.EngineGeometry(**geom)),
            TM.WorkloadModel(TC.get(arch).scaled_down(),
                             TM.EngineGeometry(**geom)))


@pytest.mark.parametrize("precision", ["FP32", "BP16", "INT8"])
def test_workload_model_costs_match_reference(precision):
    for arch in ("qwen2_0_5b", "mamba2_2_7b"):
        ref, port = _models(arch, slots=4, max_len=160,
                            precision=precision, spec=True)
        assert port.shapes == ref.shapes
        assert port.dispatch_cycles == ref.dispatch_cycles
        assert port.dispatch_traffic == ref.dispatch_traffic
        assert (dataclasses.asdict(port.step_costs())
                == dataclasses.asdict(ref.step_costs()))
        assert port.geom.pool_blocks == ref.geom.pool_blocks


def _trace(seed, n, *, spread_us=400.0):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt_len=int(rng.integers(5, 90)),
                 max_new=int(rng.integers(1, 24)),
                 arrival_us=float(rng.random() * spread_us * n))
            for i in range(n)]


#: (geometry, accept_len): spec off, spec on, and a tight pool
SIM_CASES = [(dict(slots=4, max_len=160), 1.0),
             (dict(slots=4, max_len=160, spec=True, spec_k=4), 2.5),
             (dict(slots=4, max_len=160, kv_blocks=14), 1.0)]


@pytest.mark.parametrize("case", range(len(SIM_CASES)))
def test_simulate_matches_reference(case):
    geom, acc = SIM_CASES[case]
    ref, port = _models(**geom)
    trace = _trace(case, 24)
    cal = dict(ns_per_cycle=3.5, overhead_us={"decode_step": 40.0},
               mean_us={"prefill_paged_chunk": 900.0},
               cycles={"prefill_paged_chunk": 615124.0},
               host_us_per_dispatch=120.0, startup_us=2500.0)
    for calibrated in (False, True):
        runs = []
        for M, C, m in ((JM, JCAL, ref), (TM, TCAL, port)):
            res = m.simulate([M.RequestSpec(**r) for r in trace],
                             calibration=(C.Calibration(**cal)
                                          if calibrated else None),
                             accept_len=acc)
            runs.append(res)
        a, b = runs
        assert (b.steps, b.chunk_steps, b.peak_blocks, b.occupancy) == (
            a.steps, a.chunk_steps, a.peak_blocks, a.occupancy)
        assert b.ttft_steps() == a.ttft_steps()
        _close(dataclasses.asdict(b), dataclasses.asdict(a))
        _close([b.p95_ttft_us(), b.mean_tpot_us(), b.p95_ttft_steps()],
               [a.p95_ttft_us(), a.mean_tpot_us(), a.p95_ttft_steps()])
    if case == 2:
        assert a.peak_blocks <= 13          # the tight pool binds
    with pytest.raises(ValueError, match="accept_len"):
        _models(slots=2, max_len=96, spec=True)[1].simulate(
            [TM.RequestSpec(0, 8, 4)], accept_len=0.5)


def test_model_policies_match_reference_under_workload_costs():
    jcost = JM.WorkloadModel(JC.get("qwen2_0_5b"), JM.EngineGeometry(
        slots=4, max_len=160, kv_blocks=20)).step_costs()
    tcost = TM.WorkloadModel(TC.get("qwen2_0_5b"), TM.EngineGeometry(
        slots=4, max_len=160, kv_blocks=20)).step_costs()
    assert dataclasses.asdict(tcost) == dataclasses.asdict(jcost)
    assert tcost.chunk_cost != TPOL.StepCosts().chunk_cost
    from test_torch_pool_policy import _PKGS, _views
    for cls in ("ModelFitPolicy", "ModelPreemptPolicy"):
        ref = getattr(JPOL, cls)(costs=jcost)
        port = getattr(TPOL, cls)(costs=tcost)
        decisions = set()
        for seed in range(300):
            picks = []
            for pkg, pol in (("ref", ref), ("port", port)):
                rng = np.random.default_rng(seed)
                pending, slots = _views(rng, _PKGS[pkg],
                                        int(rng.integers(0, 6)), 4)
                picks.append((pol.select_admission(pending, 1.0),
                              pol.select_victim(pending, slots, 1.0)))
            assert picks[0] == picks[1], (cls, seed)
            decisions.add(picks[1])
        assert len(decisions) >= 4


def test_step_costs_lives_in_planner():
    assert TPOL.StepCosts is TM.StepCosts is TP.StepCosts
    for name in JP.__dict__:
        if not name.startswith("_") and not isinstance(
                getattr(JP, name), type(JP)):
            assert hasattr(TP, name), name


# ---------------------------------------------------------------------------
# the reference's engine fixture replayed against the port's engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_run():
    from repro_torch.models import network as TN
    from repro_torch.serving.engine import ContinuousEngine, Request

    cfg = TC.get("qwen2_0_5b").scaled_down()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        3, cfg.vocab, 20 + 3 * i).astype(np.int32), max_new_tokens=4,
        eos=-1) for i in range(3)]
    eng = ContinuousEngine(cfg, TN.init(cfg, device="cpu"), slots=2,
                           max_len=96, device="cpu")
    res = eng.run(reqs)
    assert sorted(r.rid for r in res) == [0, 1, 2]
    return cfg, eng, reqs


def test_simulator_matches_port_engine_dispatch_counts(engine_run):
    cfg, eng, reqs = engine_run
    geom = TM.EngineGeometry.from_engine(eng)
    assert (geom.slots, geom.max_len, geom.spec) == (2, 96, False)
    assert geom.pool_blocks == eng.pool.num_blocks
    def stats():
        st = eng.schedule.stats()
        return st["hits"], st["misses"], eng.schedule.key_stats()

    before = stats()
    model = TM.WorkloadModel(cfg, geom, schedule=eng.schedule)
    plan = model.simulate([TM.RequestSpec(rid=r.rid,
                                          prompt_len=len(r.prompt),
                                          max_new=r.max_new_tokens)
                           for r in reqs])
    # unseen shapes (the verify family) are memoized, nothing is counted
    assert stats() == before
    assert plan.steps == eng.steps
    assert plan.chunk_steps == eng.chunk_steps
    assert len(plan.ttft_steps()) == len(reqs)
    assert 0 < plan.peak_blocks <= geom.pool_blocks - 1
    assert all(plan.per_request[r.rid]["tokens"] == r.max_new_tokens
               for r in reqs)
    # the engine's own cycles equal a fresh cache's (same explorer)
    fresh = TM.WorkloadModel(cfg, geom)
    assert fresh.dispatch_cycles == model.dispatch_cycles


# ---------------------------------------------------------------------------
# calibration, capacity queries, trace adapters (relative 1e-9)
# ---------------------------------------------------------------------------

def _cal_kw():
    return dict(ns_per_cycle=41.5, overhead_us={"head_apply": 12.0},
                mean_us={"decode_step": 50.0, "prefill_paged_chunk": 700.0},
                cycles={"decode_step": 1000.0,
                        "prefill_paged_chunk": 25000.0},
                host_us_per_dispatch=3.5, startup_us=1234.5,
                meta={"source": "unit"})


def test_calibration_predictions_match_reference():
    j, t = JCAL.Calibration(**_cal_kw()), TCAL.Calibration(**_cal_kw())
    for name in ("decode_step", "prefill_paged_chunk", "head_apply",
                 "verify_paged_chunk"):
        for cyc in (0.0, 500.0, 1000.0, 31337.5):
            _close(t.dispatch_us(name, cyc), j.dispatch_us(name, cyc))
    ref, port = _models(slots=2, max_len=96)
    for name in port.dispatch_cycles:
        _close(port.dispatch_us(name, t), ref.dispatch_us(name, j))
        _close(port.dispatch_us(name, None), ref.dispatch_us(name, None))
    _close(dataclasses.asdict(port.step_costs(t)),
           dataclasses.asdict(ref.step_costs(j)))


def test_calibration_json_crosses_packages(tmp_path):
    assert TCAL.CALIBRATION_VERSION == JCAL.CALIBRATION_VERSION
    t = TCAL.Calibration(**_cal_kw())
    t.save(str(tmp_path / "port.json"))
    assert dataclasses.asdict(JCAL.Calibration.load(
        str(tmp_path / "port.json"))) == dataclasses.asdict(t)
    JCAL.Calibration(**_cal_kw()).save(str(tmp_path / "ref.json"))
    assert TCAL.Calibration.load(str(tmp_path / "ref.json")) == t
    doc = json.loads((tmp_path / "ref.json").read_text())
    doc["version"] = TCAL.CALIBRATION_VERSION + 1
    with pytest.raises(ValueError, match="calibration version"):
        TCAL.Calibration.from_json(doc)
    with pytest.raises(ValueError):
        TCAL.calibration_from_events([])


@pytest.mark.parametrize("name", ["planner_calibration",
                                  "planner_calibration_smoke"])
def test_reference_calibration_artifacts_load(name):
    """The reference's committed serve_bench calibrations load in the
    port as in the reference, predict the same, and their modeled cycles
    are the port's at their geometry (scaled-down qwen2, 4 slots, max_len
    160)."""
    path = str(Path(__file__).resolve().parents[1] / "experiments"
               / "bench" / f"{name}.json")
    t, j = TCAL.Calibration.load(path), JCAL.Calibration.load(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    geom = dict(slots=t.meta["slots"], max_len=t.meta["max_len"])
    ref, port = _models(**geom)
    assert port.dispatch_cycles == t.cycles
    for name_ in t.cycles:
        _close(port.dispatch_us(name_, t), ref.dispatch_us(name_, j))


def _span(name, ts, dur, cycles, kind="serve", **extra):
    return {"cat": "dispatch", "ph": "X", "name": "dispatch", "ts": ts,
            "dur": dur, "args": {"dispatch": name, "kind": kind,
                                 "modeled_cycles": cycles, **extra}}


def _life(name, ts, rid, **extra):
    return {"cat": "lifecycle", "ph": "i", "name": name, "ts": ts,
            "args": {"rid": rid, **extra}}


def synthetic_events(seed=0, n_req=6):
    """A seeded lifecycle + dispatch trace (shared with the profile
    tests)."""
    rng = np.random.default_rng(seed)
    ev, t = [], 0.0
    for rid in range(n_req):
        t0 = float(rng.random() * 200)
        ev.append(_life("submit", t0, rid))
        adm = t0 + float(rng.random() * 300)
        ev.append(_life("admit", adm, rid,
                        prompt_len=int(rng.integers(5, 80))))
        first = adm + 400 + float(rng.random() * 900)
        ev.append(_life("first_token", first, rid))
        ev.append(_life("finish", first + float(rng.random() * 3000), rid,
                        tokens=int(rng.integers(1, 12))))
    for name, cyc in (("decode_step", 28280.0),
                      ("prefill_paged_chunk", 615124.0),
                      ("head_apply", 6292.0),
                      ("verify_paged_chunk", 112144.0)):
        for kind, n in (("calibration", 3), ("serve", 4)):
            for _ in range(n):
                t += float(rng.random() * 500)
                dur = float(rng.random() * cyc / 50)
                ev.append(_span(name, t, dur, cyc, kind,
                                modeled_traffic=cyc * 3.0,
                                shape_cycles=[[2, 512, 128, 1, cyc]],
                                flops=cyc * 7.0, bytes=cyc * 11.0))
                t += dur
    ev.append(_span("decode_step", t + 5.0, 0.0, 0.0))   # unfittable
    ev.append({"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
               "args": {"name": "serving"}})
    return ev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibration_fit_matches_reference(seed):
    ev = synthetic_events(seed)
    _close(TCAL.drift_rows(ev), JCAL.drift_rows(ev))
    _close(TCAL.dispatch_spans(ev), JCAL.dispatch_spans(ev))
    rows = TCAL.drift_rows(ev)
    _close(TCAL.fit_ns_per_cycle(rows), JCAL.fit_ns_per_cycle(rows))
    t = TCAL.calibration_from_events(ev, meta={"seed": seed})
    j = JCAL.calibration_from_events(ev, meta={"seed": seed})
    _close(t.to_json(), j.to_json())
    assert t.host_us_per_dispatch > 0 and t.startup_us > 0


@pytest.mark.parametrize("seed", [0, 3])
def test_trace_adapters_match_reference(seed):
    ev = synthetic_events(seed, n_req=8)
    ev.append(_life("submit", 5.0, 99))          # never admitted
    ev.append(_life("resume", 9000.0, 3, prompt_len=44))
    t, j = TM.requests_from_trace(ev), JM.requests_from_trace(ev)
    _close([dataclasses.asdict(r) for r in t],
           [dataclasses.asdict(r) for r in j])
    assert len(t) == 8
    _close(TM.measured_latencies(ev), JM.measured_latencies(ev))


def _query_models():
    ref, port = _models(slots=2, max_len=96)
    trace = [dict(rid=i, prompt_len=16 + 4 * (i % 3), max_new=4,
                  arrival_us=200.0 * i) for i in range(8)]
    return (ref, [JM.RequestSpec(**r) for r in trace],
            port, [TM.RequestSpec(**r) for r in trace])


def test_capacity_queries_match_reference():
    from repro.planner import capacity as JCAP
    from repro_torch.planner import capacity as TCAP
    ref, jreqs, port, treqs = _query_models()
    jcal, tcal = JCAL.Calibration(**_cal_kw()), TCAL.Calibration(**_cal_kw())
    for jc, tc in ((None, None), (jcal, tcal)):
        _close(TCAP.sweep_replicas(port, treqs, [1, 2, 4], calibration=tc),
               JCAP.sweep_replicas(ref, jreqs, [1, 2, 4], calibration=jc))
        _close(TCAP.admission_frontier(port, treqs, [10.0, 500.0, 1e4],
                                       n_requests=12, slo_us=5e4,
                                       calibration=tc),
               JCAP.admission_frontier(ref, jreqs, [10.0, 500.0, 1e4],
                                       n_requests=12, slo_us=5e4,
                                       calibration=jc))
        _close(TCAP.pool_headroom(port, treqs, tolerance=0.2,
                                  calibration=tc),
               JCAP.pool_headroom(ref, jreqs, tolerance=0.2,
                                  calibration=jc))
    with pytest.raises(ValueError):
        TCAP.sweep_replicas(port, treqs, [0])
    with pytest.raises(ValueError):
        TCAP.admission_frontier(port, [], [1.0])


# ---------------------------------------------------------------------------
# step_cost against the reference's jaxpr count
# ---------------------------------------------------------------------------

GEOM = dict(slots=2, max_len=96, block_size=16, prefill_chunk=32, spec_k=4)


def _ref_costs(arch, backend):
    from repro.analysis.jaxpr_lint import hot_dispatches
    from repro.launch.jaxpr_cost import step_cost
    cfg = dataclasses.replace(JC.get(arch).scaled_down(),
                              gemm_backend=backend)
    return {name: step_cost(fn, *args)
            for name, fn, args in hot_dispatches(cfg, **GEOM)}


def _port_costs(arch, backend):
    from repro_torch.launch.step_cost import hot_dispatches, step_cost
    cfg = dataclasses.replace(TC.get(arch).scaled_down(),
                              gemm_backend=backend)
    return cfg, {name: step_cost(fn, *args)
                 for name, fn, args in hot_dispatches(cfg, **GEOM)}


@pytest.mark.parametrize("arch,backend", [("qwen2_0_5b", "xla"),
                                          ("qwen2_0_5b", "scheduled"),
                                          ("mamba2_2_7b", "xla")])
def test_step_cost_matches_reference(arch, backend):
    # the reference's scheduled count drops its Pallas GEMMs (the seed's
    # failing test_analysis.py::test_step_cost_sees_pallas_call); the
    # GEMMs it means to count are the dots its xla count holds
    ref = _ref_costs(arch, "xla")
    cfg, port = _port_costs(arch, backend)
    assert set(port) == set(ref)
    slots, d, V = GEOM["slots"], cfg.d_model, cfg.vocab
    assert port["head_apply"]["flops"] == 2 * slots * V * d
    assert ref["head_apply"]["flops"] == 2 * slots * V * d
    for name, c in port.items():
        want = ref[name]["flops"]
        if cfg.has_recurrent_state and name == "prefill_paged_chunk":
            # the port's grouped SSD computes C.B^T once a group, the
            # reference's jnp path once a head (H / G times)
            s = cfg.ssm
            H = s.expand * d // s.head_dim
            per = 2.0 * slots * GEOM["prefill_chunk"] ** 2 * s.d_state
            want -= (H // s.n_groups - 1) * s.n_groups * per * cfg.n_layers
        assert c["flops"] == pytest.approx(want, rel=0.01), name
        assert 0.75 <= c["bytes"] / ref[name]["bytes"] <= 1.25, name
    if backend == "scheduled":
        # against the reference's own scheduled count: the same bytes
        # outside its uncounted head kernel
        sref = _ref_costs(arch, "scheduled")
        for name in ("decode_step", "prefill_paged_chunk",
                     "verify_paged_chunk"):
            assert 0.75 <= port[name]["bytes"] / sref[name]["bytes"] <= 1.25
    # the reference's pins (tests/test_planner.py)
    assert port["head_apply"]["bytes"] >= 4 * V * d
    if "verify_paged_chunk" in port:
        shapes = TPROF.dispatch_gemm_shapes(
            cfg, slots=slots, prefill_chunk=GEOM["prefill_chunk"],
            spec_k=GEOM["spec_k"], block_size=GEOM["block_size"])
        gemm = sum(2.0 * M * N * K * n
                   for M, N, K, n in shapes["verify_paged_chunk"])
        ver = port["verify_paged_chunk"]["flops"]
        assert gemm <= ver <= 2.0 * gemm
        assert port["decode_step"]["flops"] < ver


def test_step_cost_moves_no_counter_and_workload_costs():
    from repro_torch.kernels import mpgemm as MP
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch import step_cost as SC
    cfg = dataclasses.replace(TC.get("qwen2_0_5b").scaled_down(),
                              gemm_backend="scheduled", n_layers=1)
    sched = OPS.backend_for(cfg).schedule
    sched.resolve(2, 64, 64, "FP32")
    before = (sched.stats(), sched.key_stats(), len(sched.applied),
              MP.launches.count, PA.launches.count)
    with OPS.private_backends():
        assert OPS.backend_for(cfg).schedule is not sched
    fn = lambda a, b: OPS.backend_for(cfg).matmul(a, b)   # noqa: E731
    import torch
    c = SC.step_cost(fn, torch.empty(2, 64, device="meta"),
                     torch.empty(64, 64, device="meta"))
    assert c["flops"] == 2 * 2 * 64 * 64
    model = TM.WorkloadModel(cfg, TM.EngineGeometry(slots=2, max_len=96),
                             jaxpr_costs=True)
    assert model.dispatch_flops["head_apply"] == 2 * 2 * cfg.vocab * \
        cfg.d_model
    assert set(model.dispatch_bytes) == set(model.dispatch_cycles)
    assert (sched.stats(), sched.key_stats(), len(sched.applied),
            MP.launches.count, PA.launches.count) == before
