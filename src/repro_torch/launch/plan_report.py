"""Capacity-planner CLI: drift reports and what-if queries from a trace
(a port of the reference's ``scripts/plan_report.py``).

Front-end for ``repro_torch.planner``.  Every subcommand starts from a
Chrome-trace export of a profiled serve run
(``repro_torch.launch.serve --profile --trace-out ...``): the trace carries both
the measured side (lifecycle events) and the calibration input
(dispatch spans), and the engine geometry is restated on the command
line because a trace does not embed it.

    # model-vs-measured drift of a profiled run
    PYTHONPATH=src python -m repro_torch.launch.plan_report drift TRACE \
        --arch qwen2-0.5b --scaled-down --slots 2 --max-len 96 --spec

    # fleet sizing: how does TTFT p95 scale over replica counts?
    PYTHONPATH=src python -m repro_torch.launch.plan_report sweep TRACE \
        --arch qwen2-0.5b --scaled-down --slots 2 --max-len 96 \
        --replicas 1,2,4,8

    # admission frontier: highest arrival rate that meets a 50ms TTFT SLO
    PYTHONPATH=src python -m repro_torch.launch.plan_report frontier TRACE \
        --arch qwen2-0.5b --scaled-down --slots 2 --max-len 96 \
        --rates 20,50,100,200 --slo-ms 50

    # memory provisioning: smallest KV pool within 10% of baseline TTFT
    PYTHONPATH=src python -m repro_torch.launch.plan_report headroom TRACE \
        --arch qwen2-0.5b --scaled-down --slots 2 --max-len 96
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch import configs as CONFIGS
from repro_torch.planner import (Calibration, EngineGeometry, WorkloadModel,
                                 admission_frontier, calibration_from_events,
                                 pool_headroom, requests_from_trace,
                                 sweep_replicas)
from repro_torch.planner.model import VERIFY, measured_latencies


def estimate_accept_len(events: list[dict]) -> float:
    """Expected tokens per verify dispatch, from the trace itself:
    decoded tokens over serve-kind verify spans (>= 1.0)."""
    n_verify = sum(1 for e in events
                   if e.get("cat") == "dispatch" and e.get("ph") == "X"
                   and e.get("args", {}).get("dispatch") == VERIFY
                   and e.get("args", {}).get("kind", "serve") == "serve")
    decoded = sum(max(m["tokens"] - 1, 0)
                  for m in measured_latencies(events).values())
    if n_verify <= 0 or decoded <= 0:
        return 1.0
    return max(decoded / n_verify, 1.0)


def build(args, events):
    cfg = CONFIGS.get(args.arch)
    if args.scaled_down:
        cfg = cfg.scaled_down()
    geom = EngineGeometry(slots=args.slots, max_len=args.max_len,
                          prefill_chunk=min(args.prefill_chunk,
                                            args.max_len),
                          block_size=args.block_size,
                          kv_blocks=args.kv_blocks,
                          spec=args.spec, spec_k=args.spec_k,
                          precision=args.precision)
    model = WorkloadModel(cfg, geom)
    if args.calibration:
        cal = Calibration.load(args.calibration)
    else:
        cal = calibration_from_events(events, meta={"source": args.trace})
    acc = args.accept_len
    if acc is None:
        acc = estimate_accept_len(events) if args.spec else 1.0
    return model, cal, acc


def cmd_drift(args, events) -> int:
    model, cal, acc = build(args, events)
    specs = requests_from_trace(events)
    if not specs:
        print("plan_report: no finished requests in trace")
        return 1
    meas = measured_latencies(events)
    plan = model.simulate(specs, calibration=cal, accept_len=acc)
    ttft = [meas[s.rid]["ttft_us"] for s in specs]
    tpot = [meas[s.rid]["tpot_us"] for s in specs if meas[s.rid]["tpot_us"]]
    p95_meas = float(np.percentile(ttft, 95))
    tpot_meas = float(np.mean(tpot)) if tpot else 0.0
    report = {
        "requests": len(specs),
        "accept_len": round(acc, 3),
        "ns_per_cycle": round(cal.ns_per_cycle, 3),
        "startup_us": round(cal.startup_us, 1),
        "host_us_per_dispatch": round(cal.host_us_per_dispatch, 2),
        "ttft_p95_modeled_us": round(plan.p95_ttft_us(), 1),
        "ttft_p95_measured_us": round(p95_meas, 1),
        "ttft_p95_drift": round(plan.p95_ttft_us() / p95_meas - 1.0, 4)
                          if p95_meas > 0 else None,
        "tpot_modeled_us": round(plan.mean_tpot_us(), 1),
        "tpot_measured_us": round(tpot_meas, 1),
        "tpot_drift": round(plan.mean_tpot_us() / tpot_meas - 1.0, 4)
                      if tpot_meas > 0 else None,
        "steps_modeled": plan.steps,
        "chunk_steps_modeled": plan.chunk_steps,
        "peak_blocks_modeled": plan.peak_blocks,
        "avg_pool_util_modeled": round(plan.avg_pool_util, 4),
    }
    print(f"-- planner drift ({args.trace}: {report['requests']} "
          f"requests, accept_len {report['accept_len']}) --")
    for k in ("ttft_p95", "tpot"):
        d = report[f"{k}_drift"]
        print(f"  {k:<10} modeled {report[f'{k}_modeled_us']:>10.1f} us   "
              f"measured {report[f'{k}_measured_us']:>10.1f} us   "
              f"drift {d*100:+.1f}%" if d is not None else
              f"  {k:<10} unmeasurable in this trace")
    print(f"  dispatch counts: {plan.steps} decode/verify + "
          f"{plan.chunk_steps} chunk batches; peak "
          f"{plan.peak_blocks} blocks, avg pool util "
          f"{plan.avg_pool_util:.2f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"  -> {args.out}")
    if args.max_drift is not None:
        bad = [k for k in ("ttft_p95_drift", "tpot_drift")
               if report[k] is not None and abs(report[k]) > args.max_drift]
        if bad:
            print(f"FAIL: {', '.join(bad)} outside "
                  f"±{args.max_drift*100:.0f}%")
            return 1
    return 0


def cmd_sweep(args, events) -> int:
    model, cal, acc = build(args, events)
    specs = requests_from_trace(events)
    counts = [int(x) for x in args.replicas.split(",")]
    rows = sweep_replicas(model, specs, counts, calibration=cal,
                          accept_len=acc)
    print(f"-- replica sweep ({len(specs)} requests) --")
    print(f"{'replicas':>9}{'p95_ttft_ms':>13}{'tpot_ms':>9}"
          f"{'makespan_ms':>13}{'util':>7}{'peak_blk':>9}")
    for r in rows:
        print(f"{r['replicas']:>9}{r['p95_ttft_us']/1e3:>13.1f}"
              f"{r['mean_tpot_us']/1e3:>9.2f}"
              f"{r['makespan_us']/1e3:>13.1f}"
              f"{r['avg_pool_util']:>7.2f}{r['peak_blocks']:>9}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"  -> {args.out}")
    return 0


def cmd_frontier(args, events) -> int:
    model, cal, acc = build(args, events)
    specs = requests_from_trace(events)
    rates = [float(x) for x in args.rates.split(",")]
    slo_us = args.slo_ms * 1e3 if args.slo_ms is not None else None
    rows = admission_frontier(model, specs, rates,
                              n_requests=args.n_requests, slo_us=slo_us,
                              calibration=cal, accept_len=acc)
    print(f"-- admission frontier ({args.n_requests} synthesized "
          f"requests per rate) --")
    print(f"{'req/s':>8}{'p95_ttft_ms':>13}{'tpot_ms':>9}{'util':>7}"
          f"{'slo':>5}")
    frontier = None
    for r in rows:
        met = r.get("slo_met")
        print(f"{r['rate_per_s']:>8.1f}{r['p95_ttft_us']/1e3:>13.1f}"
              f"{r['mean_tpot_us']/1e3:>9.2f}{r['avg_pool_util']:>7.2f}"
              f"{'' if met is None else ('  ok' if met else ' MISS'):>5}")
        if met:
            frontier = r["rate_per_s"]
    if slo_us is not None:
        print(f"  admission frontier: "
              f"{frontier if frontier is not None else 'none'} req/s "
              f"under a {args.slo_ms:.0f}ms TTFT p95 SLO")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"  -> {args.out}")
    return 0


def cmd_headroom(args, events) -> int:
    model, cal, acc = build(args, events)
    specs = requests_from_trace(events)
    rep = pool_headroom(model, specs, tolerance=args.tolerance,
                        calibration=cal, accept_len=acc)
    print(f"-- pool headroom (tolerance {args.tolerance:.0%}) --")
    print(f"  provisioned {rep['pool_blocks']} blocks, modeled peak "
          f"{rep['peak_blocks']}, baseline TTFT p95 "
          f"{rep['baseline_p95_ttft_us']/1e3:.1f}ms")
    print(f"  smallest pool within tolerance: {rep['min_blocks']} blocks "
          f"-> headroom {rep['headroom_blocks']} blocks "
          f"({rep['headroom_frac']:.0%})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2)
        print(f"  -> {args.out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("trace", help="Chrome trace JSON from --trace-out")
    common.add_argument("--arch", default="qwen2-0.5b")
    common.add_argument("--scaled-down", action="store_true")
    common.add_argument("--slots", type=int, default=4)
    common.add_argument("--max-len", type=int, default=160)
    common.add_argument("--prefill-chunk", type=int, default=32)
    common.add_argument("--block-size", type=int, default=16)
    common.add_argument("--kv-blocks", type=int, default=None)
    common.add_argument("--spec", action="store_true",
                        help="model the speculative verify path")
    common.add_argument("--spec-k", type=int, default=4)
    common.add_argument("--precision", default="FP32")
    common.add_argument("--accept-len", type=float, default=None,
                        help="expected tokens per verify dispatch "
                             "(default: estimated from the trace)")
    common.add_argument("--calibration", default=None,
                        help="calibration JSON (trace_report "
                             "--calibration-out); default fits from the "
                             "trace itself")
    common.add_argument("--out", default=None, help="write report JSON")

    p = sub.add_parser("drift", parents=[common],
                       help="model-vs-measured TTFT/TPOT drift")
    p.add_argument("--max-drift", type=float, default=None,
                   help="exit nonzero when |drift| exceeds this fraction")
    p.set_defaults(fn=cmd_drift)
    p = sub.add_parser("sweep", parents=[common],
                       help="replica-count sweep")
    p.add_argument("--replicas", default="1,2,4")
    p.set_defaults(fn=cmd_sweep)
    p = sub.add_parser("frontier", parents=[common],
                       help="admission-rate frontier")
    p.add_argument("--rates", default="10,20,50,100")
    p.add_argument("--slo-ms", type=float, default=None)
    p.add_argument("--n-requests", type=int, default=32)
    p.set_defaults(fn=cmd_frontier)
    p = sub.add_parser("headroom", parents=[common],
                       help="KV-pool headroom search")
    p.add_argument("--tolerance", type=float, default=0.1)
    p.set_defaults(fn=cmd_headroom)

    args = ap.parse_args(argv)
    try:
        with open(args.trace) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"plan_report: cannot read {args.trace}: {e}")
        return 1
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
    try:
        return args.fn(args, events)
    except ValueError as e:
        print(f"plan_report: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
