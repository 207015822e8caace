"""Calibration: anchor the cycle model to measured wall clock (a copy of
``repro.planner.calibrate``; the JSON schema and ``CALIBRATION_VERSION``
are the reference's, so a calibration written by either package loads
in the other).

The ScheduleCache predicts RELATIVE cost — cycles on the modeled GTA
array, not seconds on the host that actually runs the dispatch — so the
planner carries a small fitted affine model per dispatch:

    time_us(name, cycles) = overhead_us[name] + cycles * ns_per_cycle / 1e3

fit from the profiled dispatch spans of an ``obs`` Chrome-trace export
(``repro_torch.launch.serve --profile`` / ``Telemetry(profiler=...)``):

  * ``ns_per_cycle`` — ONE global scale, the median implied ns/cycle
    across dispatches (the same fit ``launch/trace_report.py`` renders
    in its drift table; the function below is the shared
    implementation).  The median is deliberately robust: a dispatch
    whose measured wall is dominated by fixed overhead would drag a
    mean fit toward absurd scales.
  * ``overhead_us[name]`` — the per-dispatch residual at the fit,
    clamped at zero: host-side launch cost, sampling, sync.  The read
    path (:meth:`Calibration.dispatch_us`) anchors each CALIBRATED
    dispatch at its measured mean and extrapolates proportionally in
    cycles from there, so the model is exact at the calibrated
    geometry; the global fit + overhead form is the fallback for
    dispatches the calibration trace never saw.
  * ``host_us_per_dispatch`` — inter-dispatch host time (bookkeeping
    between engine steps: numpy block-table work, queue scans, policy
    probes), fit as (serve-span extent - sum of serve-span durations) /
    dispatch count.  Zero when the trace has fewer than two serve
    spans.

The fitted :class:`Calibration` round-trips through JSON
(``save``/``load``); ``python -m repro_torch.launch.trace_report
--calibration-out`` exports one from any profiled trace.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

#: calibration JSON schema version (bump on incompatible field changes)
CALIBRATION_VERSION = 1


def dispatch_spans(events: list[dict]) -> dict[str, dict]:
    """Group profiled dispatch spans from Chrome-trace events.

    Returns ``name -> {"serve": [dur_us...], "calibration": [dur_us...],
    "model": args-of-first-span, "ts": [(ts, dur) of serve spans]}`` —
    the grouping both the trace_report drift table and the calibration
    fit consume (``cat == "dispatch"``, ``ph == "X"`` complete events,
    dispatch name and modeled costs in ``args``).
    """
    out: dict[str, dict] = {}
    for ev in events:
        if ev.get("cat") != "dispatch" or ev.get("ph") != "X":
            continue
        a = ev.get("args", {})
        name = a.get("dispatch")
        if not name:
            continue
        d = out.setdefault(name, {"serve": [], "calibration": [],
                                  "model": a, "ts": []})
        kind = a.get("kind", "serve")
        d.setdefault(kind, []).append(ev.get("dur", 0.0))
        if kind == "serve":
            d["ts"].append((ev.get("ts", 0.0), ev.get("dur", 0.0)))
    return out


def fit_ns_per_cycle(rows: list[dict]) -> float:
    """Median implied ns/cycle over dispatch rows.

    Each row needs ``mean_us`` (measured mean wall) and ``cycles``
    (modeled cycles per dispatch); rows with a non-positive cycle model
    are skipped.  Returns 0.0 when nothing is fittable.  This is THE
    fit: trace_report's drift table and the planner's calibration both
    call here, so the drift a human reads and the scale the model
    extrapolates with can never disagree.
    """
    implied = sorted(r["mean_us"] * 1e3 / r["cycles"]
                     for r in rows if r.get("cycles", 0) > 0
                     and r.get("mean_us", 0) > 0)
    return implied[len(implied) // 2] if implied else 0.0


def drift_rows(events: list[dict]) -> list[dict]:
    """Per-dispatch measured/modeled summary rows from trace events
    (the drift table's data, shared with the calibration fit)."""
    rows = []
    for name, d in dispatch_spans(events).items():
        meas = d["serve"] or d["calibration"]
        mean_us = sum(meas) / max(len(meas), 1)
        cal = d["calibration"]
        rows.append({
            "name": name,
            "n_serve": len(d["serve"]),
            "n_cal": len(cal),
            "mean_us": mean_us,
            "cal_us": sum(cal) / max(len(cal), 1) if cal else 0.0,
            "cycles": float(d["model"].get("modeled_cycles", 0.0)),
            "traffic": float(d["model"].get("modeled_traffic", 0.0)),
            "flops": d["model"].get("flops"),
            "bytes": d["model"].get("bytes"),
            "shape_cycles": d["model"].get("shape_cycles", []),
        })
    return rows


@dataclasses.dataclass
class Calibration:
    """Fitted wall-clock anchor for the cycle model (module docstring).

    ``dispatch_us(name, cycles)`` is the read path: overhead + scaled
    cycles for a known dispatch, pure cycle scaling for an unseen one.
    """

    ns_per_cycle: float
    #: per-dispatch fixed overhead (us), clamped >= 0 at fit time
    overhead_us: dict[str, float] = dataclasses.field(default_factory=dict)
    #: measured mean wall per dispatch (us) — provenance, not a model
    #: input; what-if queries must extrapolate from cycles, not replay
    mean_us: dict[str, float] = dataclasses.field(default_factory=dict)
    #: modeled cycles per dispatch at the calibrated geometry
    cycles: dict[str, float] = dataclasses.field(default_factory=dict)
    #: host time between dispatches, per engine dispatch (us)
    host_us_per_dispatch: float = 0.0
    #: one-time engine warm-up before the first steady-state dispatch
    #: (first calls, probe setup) — first serve span ts minus first
    #: submit ts; the simulator starts its clock here, since every
    #: submitted-at-t0 request measurably waits through it
    startup_us: float = 0.0
    #: free-form provenance (source trace, config name, fit date)
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def dispatch_us(self, name: str, cycles: float) -> float:
        """Modeled wall time of one dispatch at ``cycles`` modeled
        cycles (host_us_per_dispatch NOT included — the simulator adds
        it once per engine dispatch).

        A dispatch seen at calibration is ANCHORED: its measured mean
        is exact at the calibrated cycle count and the cycle term
        extrapolates proportionally from that point — on hosts where
        wall is overhead-dominated (an eager CPU run) a single global
        ns/cycle would overpredict the cycle-heavy dispatches by
        orders of magnitude.  A dispatch never seen at calibration
        falls back to the global median ns/cycle fit."""
        c0 = self.cycles.get(name, 0.0)
        m0 = self.mean_us.get(name, 0.0)
        if c0 > 0 and m0 > 0:
            return m0 * (cycles / c0)
        return (self.overhead_us.get(name, 0.0)
                + cycles * self.ns_per_cycle / 1e3)

    def to_json(self) -> dict:
        return {"version": CALIBRATION_VERSION,
                "ns_per_cycle": self.ns_per_cycle,
                "overhead_us": self.overhead_us,
                "mean_us": self.mean_us,
                "cycles": self.cycles,
                "host_us_per_dispatch": self.host_us_per_dispatch,
                "startup_us": self.startup_us,
                "meta": self.meta}

    @classmethod
    def from_json(cls, doc: dict) -> "Calibration":
        if doc.get("version", 1) != CALIBRATION_VERSION:
            raise ValueError(
                f"calibration version {doc.get('version')} != "
                f"{CALIBRATION_VERSION} — refit from a fresh trace")
        return cls(ns_per_cycle=float(doc["ns_per_cycle"]),
                   overhead_us={k: float(v) for k, v
                                in doc.get("overhead_us", {}).items()},
                   mean_us={k: float(v) for k, v
                            in doc.get("mean_us", {}).items()},
                   cycles={k: float(v) for k, v
                           in doc.get("cycles", {}).items()},
                   host_us_per_dispatch=float(
                       doc.get("host_us_per_dispatch", 0.0)),
                   startup_us=float(doc.get("startup_us", 0.0)),
                   meta=doc.get("meta", {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "Calibration":
        with open(path) as f:
            return cls.from_json(json.load(f))


def _host_overhead(groups: dict[str, dict]) -> float:
    """Inter-dispatch host time per dispatch: serve-span wall extent
    minus time spent inside serve spans, amortized per span."""
    stamps = sorted(ts_dur for d in groups.values() for ts_dur in d["ts"])
    if len(stamps) < 2:
        return 0.0
    extent = stamps[-1][0] + stamps[-1][1] - stamps[0][0]
    inside = sum(dur for _, dur in stamps)
    return max(extent - inside, 0.0) / len(stamps)


def _startup(events: list[dict], groups: dict[str, dict]) -> float:
    """One-time warm-up: first serve dispatch span minus first submit
    (the profiler's calibration pass and the first calls dominate it
    on a fresh engine).  Zero when either side is missing from the trace."""
    subs = [ev["ts"] for ev in events
            if ev.get("cat") == "lifecycle" and ev.get("name") == "submit"]
    serve = [ts for d in groups.values() for ts, _ in d["ts"]]
    if not subs or not serve:
        return 0.0
    return max(min(serve) - min(subs), 0.0)


def calibration_from_events(events: list[dict],
                            meta: dict | None = None) -> Calibration:
    """Fit a :class:`Calibration` from profiled trace events.

    Raises ``ValueError`` when the trace carries no fittable dispatch
    span (an unprofiled run) — calibrating against nothing would return
    a model that predicts zero for everything.
    """
    groups = dispatch_spans(events)
    rows = drift_rows(events)
    scale = fit_ns_per_cycle(rows)
    if scale <= 0:
        raise ValueError(
            "no fittable dispatch spans in trace (need cat='dispatch' "
            "spans with modeled_cycles args — rerun with --profile)")
    cal = Calibration(ns_per_cycle=scale,
                      host_us_per_dispatch=_host_overhead(groups),
                      startup_us=_startup(events, groups),
                      meta=dict(meta or {}))
    for r in rows:
        if r["cycles"] <= 0 or r["mean_us"] <= 0:
            continue
        cal.mean_us[r["name"]] = r["mean_us"]
        cal.cycles[r["name"]] = r["cycles"]
        cal.overhead_us[r["name"]] = max(
            r["mean_us"] - r["cycles"] * scale / 1e3, 0.0)
    return cal
