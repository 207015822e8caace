"""Analytical capacity planner: one calibrated cost model from kernel to
fleet (a port of ``repro.planner``).

Three cost views of the same serving system meet here: the paper-§5
:class:`~repro_torch.core.scheduler.ScheduleCache` cycle and traffic
estimates per GEMM, the flops/bytes of ``launch.step_cost``, and the
wall times the dispatch profiler measures.  The package composes the
first two into per-request workload DAGs and anchors them to the third
with a fitted calibration, so one model answers "N replicas of config C
under trace T -> TTFT p95 / TPOT / pool pressure", and the same model
drives the ``model_fit`` / ``model_preempt`` policies
(``serving.policy``).

  * :mod:`repro_torch.planner.model`: workload DAG and deterministic
    engine replay (dispatch counts, TTFT/TPOT, pool occupancy);
  * :mod:`repro_torch.planner.calibrate`: ns/cycle and per-dispatch
    overhead fitted from a profiled Chrome trace, kept as JSON;
  * :mod:`repro_torch.planner.capacity`: what-if queries (replica
    sweeps, admission-rate frontiers, pool headroom) behind
    ``python -m repro_torch.launch.plan_report``.
"""

from repro_torch.planner.calibrate import (Calibration,  # noqa: F401
                                           calibration_from_events,
                                           dispatch_spans, fit_ns_per_cycle)
from repro_torch.planner.capacity import (admission_frontier,  # noqa: F401
                                          pool_headroom, sweep_replicas)
from repro_torch.planner.model import (EngineGeometry,  # noqa: F401
                                       PlanResult, RequestSpec, StepCosts,
                                       WorkloadModel, requests_from_trace)
