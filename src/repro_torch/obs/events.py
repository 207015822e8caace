"""Request-lifecycle tracing: typed events in a bounded ring (a copy of
``repro.obs.events``).

Every request through the continuous engine emits events from a fixed
vocabulary (``EVENT_TYPES``): submit -> admit -> prefill_chunk x N ->
first_token -> decode / verify steps -> preempt -> resume -> finish,
and the resilience plane's fault_injected, retry, cancel, timeout, shed,
quarantine, degrade and restore.  Each carries a host timestamp
(``time.perf_counter`` seconds), the engine step index, the request id
and slot, and a duration for spans.

The ring is a bounded ``collections.deque``: under sustained load old
events fall off the front (``dropped`` counts them), so tracing can stay
on for long runs.  Counter samples (pool utilisation, batch occupancy,
queue depth) have their own ring.

``chrome_trace()`` renders the rings as Chrome trace-event JSON (the
``{"traceEvents": [...]}`` object form) that Perfetto and
``chrome://tracing`` open:

  * pid 1 ("serving"): one track per slot (tid 100 + slot) with the
    request lifecycle, tid 0 "engine" with the batch-level decode,
    verify and chunk spans, tid 1 "queue" with the submits;
  * counter tracks (``ph: "C"``) for the counter samples;
  * pid 2 ("profiler"): dispatch spans, named for a dispatch profiler.

The tracer is host-side only: it never touches a tensor.
"""

from __future__ import annotations

import collections
import json
import time
from dataclasses import dataclass, field

#: the lifecycle event vocabulary (instant events unless noted)
EVENT_TYPES = (
    "submit",         # request entered the pending queue
    "admit",          # slot assigned, prefill scheduled (fresh prompt)
    "resume",         # re-admission of a previously preempted request
    "prefill_chunk",  # span: one chunk of this slot's prefill
    "first_token",    # first emitted token for this request (TTFT mark)
    "decode",         # span: one batched vanilla decode step (engine)
    "verify",         # span: one batched speculative verify step
    "chunk_batch",    # span: one batched prefill-chunk dispatch
    "preempt",        # victim released mid-flight, re-queued
    "finish",         # request completed, Result emitted
    "dispatch",       # span: a profiled dispatch
    # resilience-plane events (docs/RELIABILITY.md); all instants
    "fault_injected",  # the fault plane fired a scheduled fault
    "retry",          # transient failure, will retry (dispatch/admission)
    "cancel",         # request cancelled via ContinuousEngine.cancel
    "timeout",        # request exceeded its TTFT/total deadline
    "shed",           # request rejected at submit: queue at bound
    "quarantine",     # deterministically failing request isolated
    "degrade",        # live spec_k lowered/recovered under pool pressure
    "restore",        # warm-restart: snapshot entries re-admitted
)

_SPAN_TYPES = frozenset(
    {"prefill_chunk", "decode", "verify", "chunk_batch", "dispatch"})


@dataclass
class Event:
    """One trace event; ``dur == 0`` renders as an instant."""

    etype: str
    ts: float                   # perf_counter seconds
    rid: int = -1               # request id (-1: engine-level event)
    slot: int = -1              # slot index (-1: not slot-bound)
    step: int = -1              # engine step index at emission
    dur: float = 0.0            # span duration in seconds
    args: dict = field(default_factory=dict)


class Tracer:
    """Bounded lifecycle-event ring with Chrome trace-event export."""

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self.enabled = enabled
        self.capacity = capacity
        self.events: collections.deque[Event] = collections.deque(
            maxlen=capacity)
        self.counters: collections.deque = collections.deque(
            maxlen=capacity)
        self.emitted = 0            # lifetime count, incl. dropped
        self._t0 = time.perf_counter()

    @property
    def dropped(self) -> int:
        return self.emitted - len(self.events)

    def event(self, etype: str, *, rid: int = -1, slot: int = -1,
              step: int = -1, ts: float | None = None, dur: float = 0.0,
              **args) -> None:
        """Record one event (no-op when disabled).

        Callers on hot paths should guard with ``if tracer.enabled:``
        to skip kwarg packing entirely; this check is the backstop.
        """
        if not self.enabled:
            return
        if ts is None:
            ts = time.perf_counter()
        self.events.append(
            Event(etype, ts, rid=rid, slot=slot, step=step, dur=dur,
                  args=args))
        self.emitted += 1

    def counter(self, name: str, value: float, step: int = -1,
                ts: float | None = None) -> None:
        """Record one counter-track sample (no-op when disabled)."""
        if not self.enabled:
            return
        if ts is None:
            ts = time.perf_counter()
        self.counters.append((name, float(value), step, ts))

    def __len__(self) -> int:
        return len(self.events)

    # -- export --------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The ring as a Chrome trace-event JSON object.

        Timestamps are microseconds relative to the earliest recorded
        stamp, so traces start at t=0 in Perfetto.
        """
        stamps = [e.ts for e in self.events]
        stamps += [c[3] for c in self.counters]
        base = min(stamps) if stamps else self._t0

        def us(t: float) -> float:
            return (t - base) * 1e6

        tracks: dict[tuple[int, int], str] = {
            (1, 0): "engine", (1, 1): "queue"}
        out: list[dict] = []
        for e in self.events:
            if e.etype == "dispatch":
                pid, tid = 2, 0
                tracks.setdefault((2, 0), "dispatches")
            elif e.etype == "submit":
                pid, tid = 1, 1
            elif e.slot >= 0:
                pid, tid = 1, 100 + e.slot
                tracks.setdefault((pid, tid), f"slot {e.slot}")
            else:
                pid, tid = 1, 0
            args = {"etype": e.etype, "rid": e.rid, "step": e.step}
            args.update(e.args)
            ev: dict = {"name": e.etype, "pid": pid, "tid": tid,
                        "ts": us(e.ts), "args": args}
            if e.etype in _SPAN_TYPES:
                ev["ph"] = "X"
                ev["dur"] = e.dur * 1e6
                ev["cat"] = ("dispatch" if e.etype == "dispatch"
                             else "lifecycle")
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
                ev["cat"] = "lifecycle"
            out.append(ev)
        for name, value, step, ts in self.counters:
            out.append({"name": name, "ph": "C", "pid": 1, "tid": 0,
                        "ts": us(ts), "cat": "counter",
                        "args": {"value": value, "step": step}})
        meta: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "serving"}},
            {"name": "process_name", "ph": "M", "pid": 2, "tid": 0,
             "args": {"name": "profiler"}},
        ]
        for (pid, tid), label in sorted(tracks.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": label}})
        return {"traceEvents": meta + out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")


def validate_chrome_trace(doc: dict) -> list[str]:
    """Structural check against the Chrome trace-event format.

    Returns a list of problems (empty == valid).  Checks the object
    form, per-event required keys by phase, and numeric timestamps —
    the subset Perfetto's importer actually requires.
    """
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["top level is not a JSON object"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing traceEvents array"]
    if not evs:
        errs.append("traceEvents is empty")
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            errs.append(f"{where}: missing ph")
            continue
        if ev.get("name") in (None, ""):
            errs.append(f"{where}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errs.append(f"{where}: {key} not an int")
        if ph != "M":
            if not isinstance(ev.get("ts"), (int, float)):
                errs.append(f"{where}: ts not numeric")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: complete event needs dur >= 0")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                errs.append(f"{where}: counter event needs args")
            elif not all(isinstance(v, (int, float))
                         for k, v in args.items() if k != "step"):
                errs.append(f"{where}: counter args must be numeric")
    return errs
