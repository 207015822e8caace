"""What-if capacity queries over the calibrated workload model (a copy of
``repro.planner.capacity``).

Each query here is a pure function of (:class:`WorkloadModel`, request
trace, knob range): it re-runs the deterministic simulator under varied
geometry or load and reports the latency/occupancy consequences —
questions the live engine can only answer by being rebuilt and
re-benched per point:

  * :func:`sweep_replicas` — shard a trace across N model replicas and
    report per-N TTFT p95 / TPOT / pool pressure (the fleet-sizing
    question);
  * :func:`admission_frontier` — synthesize open-loop arrivals at
    increasing request rates and find where TTFT blows through the SLO
    (the admission-control question);
  * :func:`pool_headroom` — binary-search the smallest KV pool that
    still meets a latency tolerance (the memory-provisioning question).

``python -m repro_torch.launch.plan_report`` fronts all three as CLI
subcommands.
"""

from __future__ import annotations

import copy
import dataclasses

from repro_torch.planner.calibrate import Calibration
from repro_torch.planner.model import RequestSpec, WorkloadModel


def _with_pool(model: WorkloadModel, kv_blocks: int) -> WorkloadModel:
    """Shallow clone of ``model`` with a resized KV pool.  Dispatch
    costs are pool-size-independent, so the clone shares the (already
    explored) cycle tables and only swaps the geometry."""
    clone = copy.copy(model)
    clone.geom = dataclasses.replace(model.geom, kv_blocks=kv_blocks)
    return clone


def _summary(res) -> dict:
    return {"p95_ttft_us": res.p95_ttft_us(),
            "p95_ttft_steps": res.p95_ttft_steps(),
            "mean_tpot_us": res.mean_tpot_us(),
            "total_us": res.total_us,
            "avg_pool_util": res.avg_pool_util,
            "peak_blocks": res.peak_blocks,
            "dispatches": res.dispatches}


def sweep_replicas(model: WorkloadModel, requests: list[RequestSpec],
                   replica_counts: list[int], *,
                   calibration: Calibration | None = None,
                   accept_len: float = 1.0) -> list[dict]:
    """Shard ``requests`` round-robin across N identical replicas for
    each N in ``replica_counts`` and simulate each shard; a sweep row
    reports the WORST replica's TTFT p95 (the fleet's p95 is bounded by
    its slowest shard) and the mean pool utilization."""
    rows = []
    for n in replica_counts:
        if n < 1:
            raise ValueError(f"replica count must be >= 1, got {n}")
        shards = [requests[i::n] for i in range(n)]
        results = [model.simulate(s, calibration=calibration,
                                  accept_len=accept_len)
                   for s in shards if s]
        row = {"replicas": n,
               "requests": len(requests),
               "p95_ttft_us": max(r.p95_ttft_us() for r in results),
               "p95_ttft_steps": max(r.p95_ttft_steps() for r in results),
               "mean_tpot_us": max(r.mean_tpot_us() for r in results),
               "makespan_us": max(r.total_us for r in results),
               "avg_pool_util": (sum(r.avg_pool_util for r in results)
                                 / len(results)),
               "peak_blocks": max(r.peak_blocks for r in results)}
        rows.append(row)
    return rows


def admission_frontier(model: WorkloadModel, shapes: list[RequestSpec],
                       rates_per_s: list[float], *,
                       n_requests: int = 32,
                       slo_us: float | None = None,
                       calibration: Calibration | None = None,
                       accept_len: float = 1.0) -> list[dict]:
    """Open-loop load sweep: for each arrival rate, synthesize
    ``n_requests`` arrivals at exactly that rate (request shapes cycled
    from ``shapes`` — deterministic, no sampling) and simulate.  With
    ``slo_us`` set, each row carries ``slo_met`` (TTFT p95 under the
    budget); the admission frontier is the last rate that still meets
    it."""
    if not shapes:
        raise ValueError("admission_frontier needs at least one "
                         "request shape (e.g. from requests_from_trace)")
    rows = []
    for rate in rates_per_s:
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        gap_us = 1e6 / rate
        reqs = [dataclasses.replace(shapes[i % len(shapes)], rid=i,
                                    arrival_us=i * gap_us)
                for i in range(n_requests)]
        res = model.simulate(reqs, calibration=calibration,
                             accept_len=accept_len)
        row = {"rate_per_s": rate, "n_requests": n_requests,
               **_summary(res)}
        if slo_us is not None:
            row["slo_us"] = slo_us
            row["slo_met"] = bool(row["p95_ttft_us"] <= slo_us)
        rows.append(row)
    return rows


def pool_headroom(model: WorkloadModel, requests: list[RequestSpec], *,
                  tolerance: float = 0.1,
                  calibration: Calibration | None = None,
                  accept_len: float = 1.0) -> dict:
    """Binary-search the smallest KV pool (in blocks) whose simulated
    TTFT p95 stays within ``tolerance`` of the current pool's, and
    report the headroom the current provisioning carries.

    The search space is [blocks_per_slot + 2, current pool]: below one
    slot's span plus the reserved block nothing admits at all."""
    base = model.simulate(requests, calibration=calibration,
                          accept_len=accept_len)
    budget = base.p95_ttft_us() * (1.0 + tolerance)
    hi = model.geom.pool_blocks
    lo = model.geom.blocks_per_slot + 2
    best = hi
    lo_b, hi_b = lo, hi
    while lo_b <= hi_b:
        mid = (lo_b + hi_b) // 2
        res = _with_pool(model, mid).simulate(
            requests, calibration=calibration, accept_len=accept_len)
        if res.p95_ttft_us() <= budget:
            best = mid
            hi_b = mid - 1
        else:
            lo_b = mid + 1
    return {"pool_blocks": hi,
            "peak_blocks": base.peak_blocks,
            "baseline_p95_ttft_us": base.p95_ttft_us(),
            "tolerance": tolerance,
            "min_blocks": best,
            "headroom_blocks": hi - best,
            "headroom_frac": (hi - best) / max(hi, 1)}
