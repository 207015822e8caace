"""Render a serving trace: per-request waterfall + dispatch drift table
(a port of the reference's ``scripts/trace_report.py``).

Input is the Chrome trace-event JSON written by ``--trace-out``
(``repro_torch.obs.events.Tracer.export``).  Three sections:

  * structural validation (``--validate`` exits nonzero on a malformed
    trace or when an expected dispatch is missing from the profile);
  * a per-request ASCII waterfall from the lifecycle events — queued
    (submit→admit ``-``), prefill (admit→first-token ``=``), decode
    (first-token→finish ``#``), with preempt/resume marked ``!``/``r``;
  * a modeled-vs-measured drift table from the profiled dispatch spans
    (``repro_torch.launch.serve --profile``): per dispatch, mean measured
    wall vs
    the ScheduleCache cycle model.  The model predicts RELATIVE cost —
    cycles, not seconds — so the table derives one global seconds-per-
    cycle scale (the median across dispatches) and reports each
    dispatch's drift from that fit; per-shape sub-rows apportion the
    measured mean by modeled cycle share.

    PYTHONPATH=src python -m repro_torch.launch.trace_report trace.json \
        --metrics metrics.json --validate [--calibration-out cal.json]
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.events import validate_chrome_trace
from repro_torch.obs.profile import DISPATCH_NAMES
from repro_torch.planner.calibrate import (calibration_from_events,
                                           dispatch_spans, drift_rows,
                                           fit_ns_per_cycle)

WATERFALL_WIDTH = 60


def _lifecycle_by_rid(events: list[dict]) -> dict[int, list[dict]]:
    out: dict[int, list[dict]] = {}
    for ev in events:
        if ev.get("ph") == "M" or ev.get("cat") not in ("lifecycle",):
            continue
        rid = ev.get("args", {}).get("rid", -1)
        if rid is None or rid < 0:
            continue
        out.setdefault(rid, []).append(ev)
    for evs in out.values():
        evs.sort(key=lambda e: e["ts"])
    return out


def render_waterfall(events: list[dict]) -> list[str]:
    """ASCII per-request timeline (one row per rid, run-relative µs)."""
    by_rid = _lifecycle_by_rid(events)
    if not by_rid:
        return ["(no per-request lifecycle events in trace)"]
    t_lo = min(e["ts"] for evs in by_rid.values() for e in evs)
    t_hi = max(e["ts"] + e.get("dur", 0.0)
               for evs in by_rid.values() for e in evs)
    span = max(t_hi - t_lo, 1e-9)

    def col(ts: float) -> int:
        return min(WATERFALL_WIDTH - 1,
                   int((ts - t_lo) / span * WATERFALL_WIDTH))

    lines = [f"-- request waterfall ({len(by_rid)} requests, "
             f"{span/1e3:.1f} ms span; '-' queued, '=' prefill, "
             f"'#' decode, '!' preempt, 'r' resume) --"]
    hdr = (f"{'rid':>4} {'slot':>4} {'queue_ms':>9} {'ttft_ms':>8} "
           f"{'total_ms':>9} {'tok':>4}  timeline")
    lines.append(hdr)
    for rid in sorted(by_rid):
        evs = by_rid[rid]
        stamp = {}
        slots, preempts, resumes = set(), [], []
        tokens = 0
        for e in evs:
            name = e["name"]
            if name in ("submit", "admit", "first_token", "finish"):
                stamp.setdefault(name, e["ts"])
            if name == "preempt":
                preempts.append(e["ts"])
            if name == "resume":
                resumes.append(e["ts"])
                stamp.setdefault("admit", e["ts"])
            s = e.get("args", {}).get("slot", e.get("tid", 0) - 100)
            if name != "submit" and 0 <= s < 100:
                slots.add(s)
            if name == "finish":
                tokens = e.get("args", {}).get("tokens", 0)
        t_sub = stamp.get("submit", t_lo)
        t_adm = stamp.get("admit", t_sub)
        t_first = stamp.get("first_token", t_adm)
        t_fin = stamp.get("finish", t_hi)
        bar = [" "] * WATERFALL_WIDTH
        for i in range(col(t_sub), col(t_adm)):
            bar[i] = "-"
        for i in range(col(t_adm), col(t_first)):
            bar[i] = "="
        for i in range(col(t_first), col(t_fin) + 1):
            bar[i] = "#"
        bar[col(t_adm)] = "="
        for ts in preempts:
            bar[col(ts)] = "!"
        for ts in resumes:
            bar[col(ts)] = "r"
        slot_s = ",".join(str(s) for s in sorted(slots)) or "-"
        lines.append(
            f"{rid:>4} {slot_s:>4} {(t_adm - t_sub)/1e3:>9.2f} "
            f"{(t_first - t_sub)/1e3:>8.2f} {(t_fin - t_sub)/1e3:>9.2f} "
            f"{tokens:>4}  |{''.join(bar)}|")
    return lines


def render_drift(events: list[dict], *, shapes: bool = True) -> list[str]:
    """Modeled-vs-measured drift table (module docstring).  The row
    grouping and the median ns/cycle fit live in
    ``repro_torch.planner.calibrate`` — the planner's calibration is the same
    fit this table renders."""
    rows = drift_rows(events)
    if not rows:
        return ["(no profiled dispatch spans — rerun with --profile)"]
    scale = fit_ns_per_cycle(rows)

    lines = [f"-- dispatch drift table (modeled cycles vs measured wall; "
             f"fit {scale:.2f} ns/cycle median) --"]
    lines.append(f"{'dispatch':<22}{'n':>5}{'cal':>5}{'meas_us':>10}"
                 f"{'model_kcyc':>12}{'ns/cyc':>8}{'drift%':>8}"
                 f"{'GB/s_model':>11}")
    for r in sorted(rows, key=lambda r: -r["mean_us"]):
        if r["cycles"] > 0 and scale > 0:
            pred_us = r["cycles"] * scale / 1e3
            drift = (r["mean_us"] - pred_us) / pred_us * 100.0
            ns_cyc = r["mean_us"] * 1e3 / r["cycles"]
        else:
            drift = ns_cyc = 0.0
        gbs = (r["traffic"] / (r["mean_us"] * 1e-6) / 1e9
               if r["mean_us"] > 0 else 0.0)
        lines.append(f"{r['name']:<22}{r['n_serve']:>5}{r['n_cal']:>5}"
                     f"{r['mean_us']:>10.1f}{r['cycles']/1e3:>12.1f}"
                     f"{ns_cyc:>8.2f}{drift:>+8.1f}{gbs:>11.2f}")
        if shapes and r["shape_cycles"]:
            for M, N, K, count, cyc in r["shape_cycles"]:
                share = count * cyc / max(r["cycles"], 1e-9)
                lines.append(
                    f"    {M:>5} x {N:>5} x {K:>5}  x{count:<3} "
                    f"{count*cyc/1e3:>10.1f} kcyc  {share*100:>5.1f}%  "
                    f"~{r['mean_us']*share:>8.1f} us")
    lines.append("(drift% is deviation from the median ns/cycle fit — "
                 "the cycle model predicts relative, not absolute, cost)")
    return lines


def render_metrics(path: str) -> list[str]:
    with open(path) as f:
        snap = json.load(f)
    lines = [f"-- metrics snapshot ({path}) --"]
    c = snap.get("counters", {})
    for k in sorted(c):
        if k.startswith(("engine.", "spec.", "schedule.", "kv_pool.")):
            lines.append(f"  {k:<32}{c[k]:>12.0f}")
    for name, h in sorted(snap.get("histograms", {}).items()):
        lines.append(f"  {name:<32}{h['count']:>6.0f} obs   "
                     f"p50 {h['p50']:>10.1f}   p95 {h['p95']:>10.1f}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="Chrome trace JSON from --trace-out")
    ap.add_argument("--metrics", default=None,
                    help="metrics snapshot JSON from --metrics-out")
    ap.add_argument("--validate", action="store_true",
                    help="exit nonzero on a malformed trace or missing "
                         "expected dispatches")
    ap.add_argument("--expect-dispatches",
                    default=",".join(DISPATCH_NAMES),
                    help="comma list the drift table must cover under "
                         "--validate (default: all four hot dispatches; "
                         "pass a narrower list for e.g. hybrid configs "
                         "with no verify dispatch)")
    ap.add_argument("--no-shapes", action="store_true",
                    help="suppress per-shape sub-rows")
    ap.add_argument("--calibration-out", default=None,
                    help="write a planner calibration JSON (ns/cycle + "
                         "per-dispatch overheads) fitted from this "
                         "trace's profiled spans")
    args = ap.parse_args(argv)

    try:
        with open(args.trace) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"trace_report: cannot read {args.trace}: {e}")
        return 1

    failures = []
    if args.validate:
        errs = validate_chrome_trace(doc)
        if errs:
            failures += [f"invalid trace: {e}" for e in errs[:10]]
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else []

    dropped = 0
    if isinstance(doc, dict):
        dropped = doc.get("otherData", {}).get("dropped_events", 0)
    n_life = sum(1 for e in events if e.get("cat") == "lifecycle")
    n_disp = sum(1 for e in events if e.get("cat") == "dispatch")
    print(f"[trace_report] {args.trace}: {len(events)} events "
          f"({n_life} lifecycle, {n_disp} dispatch, {dropped} dropped)")

    for line in render_waterfall(events):
        print(line)
    print()
    for line in render_drift(events, shapes=not args.no_shapes):
        print(line)

    if args.validate:
        have = set(dispatch_spans(events))
        want = [s for s in args.expect_dispatches.split(",") if s]
        missing = [n for n in want if n not in have]
        if missing:
            failures.append(
                f"drift table missing expected dispatches: {missing} "
                f"(have {sorted(have)}) — was the run profiled?")

    if args.calibration_out:
        try:
            cal = calibration_from_events(
                events, meta={"source": args.trace})
            cal.save(args.calibration_out)
            print(f"[trace_report] calibration "
                  f"({cal.ns_per_cycle:.2f} ns/cycle, "
                  f"{len(cal.overhead_us)} dispatches) "
                  f"-> {args.calibration_out}")
        except (ValueError, OSError) as e:
            failures.append(f"cannot export calibration: {e}")

    if args.metrics:
        print()
        try:
            for line in render_metrics(args.metrics):
                print(line)
        except (OSError, json.JSONDecodeError, KeyError) as e:
            failures.append(f"cannot read metrics {args.metrics}: {e}")

    for msg in failures:
        print(f"FAIL: {msg}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
