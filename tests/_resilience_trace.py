"""The fault drills that ``tests/test_torch_resilience.py`` runs through
the reference engine (in a subprocess) and through the port's, with the
same code on both sides: the caller hands in its package's classes.
Importable without torch or JAX.

Each drill pumps ``step()`` on one thread (no serve loop) and returns a
JSON-safe record: every request's tokens, status and error, the
lifecycle events as ``(etype, rid, slot, step)`` in emission order, the
deterministic counters and the faults the plane fired.

  * ``faults``: 6 requests on 2 slots with ``max_pending=4`` (rids 4 and
    5 are shed), rid 1 with ``deadline_s=0`` (times out in the queue),
    two ``reserve`` denials (admission retries with backoff), a
    transient ``dispatch`` fault at step 4, a ``poison`` on rid 3, and a
    ``cancel`` of rid 0 before step 5;
  * ``spec``: ngram speculation on looped prompts with two ``extend``
    denials (``spec_degrade``: the depth halves, then recovers), two
    corrupted drafts and a transient fault on a verify step;
  * ``restart``: ``serve_with_restarts`` through a ``crash`` at step 6,
    both engines recording into one telemetry bundle.
"""

from types import SimpleNamespace

import numpy as np

DRILLS = ("faults", "spec", "restart")

#: counters that depend on the schedule alone (not on the clock)
COUNTERS = ("engine.steps", "engine.chunk_steps", "engine.prefills",
            "engine.preemptions", "engine.admissions", "engine.resumes",
            "engine.tokens_emitted", "engine.requests_finished",
            "resilience.faults_injected", "resilience.retries",
            "resilience.cancelled", "resilience.timeouts", "resilience.shed",
            "resilience.quarantined", "resilience.admit_failures",
            "resilience.spec_degrades", "resilience.restored",
            "spec.tokens_emitted", "spec.drafted", "spec.accepted",
            "spec.slot_verifies")

SLOTS, MAX_LEN = 2, 96


def _prompt(rid: int, plen: int, vocab: int, looped: bool) -> np.ndarray:
    rng = np.random.default_rng(100 + rid)
    if looped:                      # a repeated pattern: ngram drafts hit
        return np.tile(rng.integers(3, vocab, 5), plen // 5 + 1)[
            :plen].astype(np.int32)
    return rng.integers(3, vocab, plen).astype(np.int32)


def requests(api, vocab: int, n: int, new: int, looped: bool = False,
             **per_rid) -> list:
    """``n`` requests of 12-47 prompt tokens and ``new`` new tokens;
    ``per_rid[f"r{rid}"]`` adds Request fields."""
    return [api.Request(rid=i, prompt=_prompt(i, 12 + 7 * i % 29, vocab,
                                              looped),
                        max_new_tokens=new, eos=-1,
                        **per_rid.get(f"r{i}", {}))
            for i in range(n)]


def _pump(eng, n: int, hooks=None, max_steps: int = 500) -> list:
    out = list(eng.drain_results())
    for i in range(max_steps):
        if len(out) >= n:
            return out
        if hooks and i in hooks:
            hooks[i](eng)
        eng.step()
        out += eng.drain_results()
    raise AssertionError(f"{len(out)}/{n} results after {max_steps} steps")


def _record(results, tracer, metrics, plane, engines: int) -> dict:
    return {
        "results": {str(r.rid): [[int(t) for t in r.tokens], r.status,
                                 r.error] for r in results},
        "events": [[e.etype, int(e.rid), int(e.slot), int(e.step)]
                   for e in tracer.events],
        "counters": {k: metrics.value(k) for k in COUNTERS},
        "fired": plane.fired, "engines": engines}


def drill(name: str, api: SimpleNamespace, vocab: int) -> dict:
    """Run drill ``name``.  ``api`` holds ``make(**engine_kw)`` (an engine
    on the caller's config and weights), ``Request``, ``FaultPlane``,
    ``FaultSpec``, ``ResilienceConfig``, ``serve_with_restarts`` and
    ``Telemetry``."""
    F = api.FaultSpec
    if name == "faults":
        plane = api.FaultPlane([F("reserve", at=1, count=2),
                                F("dispatch", at=4), F("poison", rid=3)])
        eng = api.make(faults=plane, telemetry=api.Telemetry.on(),
                       resilience=api.ResilienceConfig(
                           max_pending=4, max_admit_retries=3,
                           admit_backoff_steps=1))
        reqs = requests(api, vocab, 6, 6, r1={"deadline_s": 0.0})
        for r in reqs:
            eng.submit(r)
        res = _pump(eng, len(reqs), {5: lambda e: e.cancel(0)})
        return _record(res, eng.obs.tracer, eng.metrics, plane, 1)
    if name == "spec":
        plane = api.FaultPlane([F("extend", at=2, count=2),
                                F("draft", at=5), F("draft", at=10),
                                F("dispatch", at=9)])
        eng = api.make(faults=plane, telemetry=api.Telemetry.on(),
                       spec="ngram", spec_k=4,
                       resilience=api.ResilienceConfig(
                           spec_degrade=True, spec_recover_steps=2))
        reqs = requests(api, vocab, 4, 12, looped=True)
        for r in reqs:
            eng.submit(r)
        res = _pump(eng, len(reqs))
        return _record(res, eng.obs.tracer, eng.metrics, plane, 1)
    if name == "restart":
        plane = api.FaultPlane([F("crash", at=6)])
        obs = api.Telemetry.on()
        engines = []

        def make_engine():
            engines.append(api.make(faults=plane, telemetry=obs))
            return engines[-1]

        res = api.serve_with_restarts(make_engine,
                                      requests(api, vocab, 4, 6))
        return _record(res, obs.tracer, obs.metrics, plane, len(engines))
    raise ValueError(name)


def metric_kinds(eng) -> dict:
    """The engine's registered metric names by kind."""
    snap = eng.metrics.snapshot()
    return {kind: sorted(names) for kind, names in snap.items()}


#: the engine configurations whose metric names are compared
METRIC_CONFIGS = {"paged": {}, "ngram": {"spec": "ngram"},
                  "dense": {"paged": False}}
