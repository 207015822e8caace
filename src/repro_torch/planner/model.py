"""Workload-DAG cost model over the paper-§5 schedule estimates (a port
of ``repro.planner.model``).

One request's serving life is a small DAG of engine dispatches:

    prefill chunk 1 -> ... -> prefill chunk C -> first token
        -> decode/verify step 1 -> ... -> decode/verify step D

The node costs come from the SAME sources the live engine schedules
with — :meth:`ScheduleCache.modeled_cycles` summed over the GEMM shapes
each dispatch executes (``obs.profile.dispatch_gemm_shapes``, the
attribution the drift table already uses) plus, optionally, the exact
flops/bytes of ``launch.step_cost`` — and the edges are the
engine's own interleaving rules: at most one chunk batch per step, one
batched decode/verify dispatch over the decoding slots, admission
before and after the decode dispatch, blocks reserved up front and
released at finish.

:meth:`WorkloadModel.simulate` replays those rules deterministically
over a request trace, so the dispatch counts it predicts (``steps``,
``chunk_steps``, per-request ``ttft_steps``) are the engine's own
deterministic proxies — tests pin them against a live
:class:`~repro_torch.serving.engine.ContinuousEngine` run exactly.
Wall-time predictions (TTFT, TPOT) come from composing those counts with
a :class:`~repro_torch.planner.calibrate.Calibration`; the reference's
serve_bench gates the composition within ±30% of measured.

Deliberate approximations (documented, conservative):

  * no prefix sharing — every admission reserves its full block span,
    so modeled pool pressure upper-bounds the real pool's;
  * speculative decode advances by a caller-supplied expected accept
    length (measure it: ``spec_stats()['avg_accept_len']``) instead of
    replaying token content;
  * greedy-to-budget decode (``eos=-1`` traces are exact; early-eos
    requests should pass served lengths, e.g. via
    :func:`requests_from_trace`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from repro_torch.core.scheduler import ScheduleCache
from repro_torch.planner.calibrate import Calibration

#: dispatch names as emitted by obs.profile
CHUNK = "prefill_paged_chunk"
DECODE = "decode_step"
VERIFY = "verify_paged_chunk"


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One request as the planner sees it (content-free: lengths only)."""

    rid: int
    prompt_len: int
    max_new: int
    arrival_us: float = 0.0
    ttft_slo: float | None = None
    priority: int = 0


@dataclasses.dataclass(frozen=True)
class EngineGeometry:
    """The engine-shape knobs the model's dispatch costs depend on."""

    slots: int
    max_len: int
    prefill_chunk: int = 32
    block_size: int = 16
    kv_blocks: int | None = None
    spec: bool = False
    spec_k: int = 4
    precision: str = "FP32"

    @property
    def blocks_per_slot(self) -> int:
        return -(-self.max_len // self.block_size)

    @property
    def pool_blocks(self) -> int:
        """Total pool blocks, mirroring the engine's default sizing
        (~3/4 of the dense ceiling) when ``kv_blocks`` is None."""
        if self.kv_blocks is not None:
            return self.kv_blocks
        per_slot = self.blocks_per_slot
        return max(per_slot + 1,
                   1 + (3 * self.slots * per_slot + 3) // 4)

    @classmethod
    def from_engine(cls, eng) -> "EngineGeometry":
        """Snapshot a live paged engine's geometry."""
        return cls(slots=eng.slots, max_len=eng.max_len,
                   prefill_chunk=eng.prefill_chunk,
                   block_size=eng.pool.block_size,
                   kv_blocks=eng.pool.num_blocks,
                   spec=eng.spec is not None, spec_k=eng.spec_k,
                   precision=eng._prec)


@dataclasses.dataclass(frozen=True)
class StepCosts:
    """Relative per-dispatch costs — the minimal model the scheduling
    policies consume (``serving.policy`` model_fit / model_preempt).

    Units are whatever the producer used (cycles uncalibrated, us
    calibrated); policies only ever compare ratios, so the unit cancels.
    The default construction is a sane shape-free prior (a chunk batch
    costs a few decode steps) so string-registered policies work
    without an engine in hand; :meth:`WorkloadModel.step_costs` builds
    the real thing.
    """

    chunk_cost: float = 3.0     # one prefill-chunk batch dispatch
    decode_cost: float = 1.0    # one batched decode/verify dispatch
    prefill_chunk: int = 32     # tokens per chunk dispatch

    def prefill_dispatches(self, prompt_len: int) -> int:
        """Chunk batches a prompt needs before its first token."""
        return max(1, -(-int(prompt_len) // self.prefill_chunk))

    def ttft_cost(self, prompt_len: int) -> float:
        """Modeled cost from admission to first token."""
        return self.prefill_dispatches(prompt_len) * self.chunk_cost

    def service_cost(self, prompt_len: int, new_tokens: int) -> float:
        """Modeled cost of one request's full slot residency."""
        return (self.ttft_cost(prompt_len)
                + max(int(new_tokens) - 1, 0) * self.decode_cost)


@dataclasses.dataclass
class PlanResult:
    """Aggregate + per-request output of one :meth:`simulate` run."""

    steps: int
    chunk_steps: int
    total_us: float
    peak_blocks: int
    avg_pool_util: float
    #: per-dispatch pool-occupancy samples (used blocks), in step order
    occupancy: list[int]
    #: rid -> {ttft_steps, ttft_us, finish_us, tokens, tpot_us}
    per_request: dict[int, dict[str, Any]]

    @property
    def dispatches(self) -> int:
        return self.steps + self.chunk_steps

    def ttft_steps(self) -> list[int]:
        return [r["ttft_steps"] for r in self.per_request.values()]

    def p95_ttft_steps(self) -> float:
        return float(np.percentile(self.ttft_steps(), 95))

    def p95_ttft_us(self) -> float:
        return float(np.percentile(
            [r["ttft_us"] for r in self.per_request.values()], 95))

    def mean_tpot_us(self) -> float:
        """Mean per-token decode time over requests that decoded at all."""
        ts = [r["tpot_us"] for r in self.per_request.values()
              if r["tpot_us"] is not None]
        return float(np.mean(ts)) if ts else 0.0


@dataclasses.dataclass
class _SimSlot:
    spec: RequestSpec
    chunks: list[int]           # remaining chunk token counts
    blocks: int                 # pool blocks held
    produced: float = 0.0
    phase: str = "prefill"
    ttft_steps: int = -1
    ttft_us: float = -1.0


class WorkloadModel:
    """Per-dispatch cost model + deterministic engine replay (module
    docstring).  ``schedule`` may be a live engine's ScheduleCache —
    reads go through :meth:`~ScheduleCache.modeled_cycles`, which never
    mutates the hit/miss stats the serve_bench gates count."""

    def __init__(self, cfg, geom: EngineGeometry, *,
                 schedule: ScheduleCache | None = None,
                 jaxpr_costs: bool = False):
        from repro_torch.obs.profile import dispatch_gemm_shapes

        self.cfg = cfg
        self.geom = geom
        self.schedule = schedule or ScheduleCache()
        self.shapes = dispatch_gemm_shapes(
            cfg, slots=geom.slots, prefill_chunk=geom.prefill_chunk,
            spec_k=geom.spec_k, block_size=geom.block_size)
        self.dispatch_cycles: dict[str, float] = {}
        self.dispatch_traffic: dict[str, float] = {}
        for name, lst in self.shapes.items():
            cyc = traffic = 0.0
            for M, Nn, K, count in lst:
                ch = self.schedule.modeled_cycles(M, Nn, K, geom.precision)
                cyc += count * ch.cycles
                traffic += count * ch.traffic_bytes
            self.dispatch_cycles[name] = cyc
            self.dispatch_traffic[name] = traffic
        #: exact flops/bytes per dispatch (opt-in: running the dispatch
        #: programs on fake tensors is slow at construction time)
        self.dispatch_flops: dict[str, float] = {}
        self.dispatch_bytes: dict[str, float] = {}
        if jaxpr_costs:
            from repro_torch.launch.step_cost import dispatch_costs
            for name, flops, nbytes in dispatch_costs(
                    cfg, slots=geom.slots, max_len=geom.max_len,
                    block_size=geom.block_size,
                    prefill_chunk=geom.prefill_chunk,
                    spec_k=geom.spec_k):
                if name in self.dispatch_cycles:
                    self.dispatch_flops[name] = flops
                    self.dispatch_bytes[name] = nbytes

    # -- cost views -----------------------------------------------------------

    def dispatch_us(self, name: str, cal: Calibration | None) -> float:
        """Modeled wall of one dispatch; uncalibrated falls back to raw
        cycles (relative units — fine for comparisons, not for SLOs)."""
        cyc = self.dispatch_cycles.get(name, 0.0)
        if cal is None:
            return cyc
        return cal.dispatch_us(name, cyc) + cal.host_us_per_dispatch

    def step_costs(self, cal: Calibration | None = None) -> StepCosts:
        """The policy-facing relative cost summary."""
        decode = self.geom.spec and VERIFY or DECODE
        if decode not in self.dispatch_cycles:
            decode = DECODE
        return StepCosts(
            chunk_cost=self.dispatch_us(CHUNK, cal),
            decode_cost=self.dispatch_us(decode, cal),
            prefill_chunk=self.geom.prefill_chunk)

    def _blocks_for(self, n_tokens: float) -> int:
        return -(-int(math.ceil(n_tokens)) // self.geom.block_size)

    # -- deterministic replay -------------------------------------------------

    def simulate(self, requests: list[RequestSpec], *,
                 calibration: Calibration | None = None,
                 accept_len: float = 1.0) -> PlanResult:
        """Replay the engine's scheduling rules over ``requests`` (FIFO
        admission — the planner models capacity, not policy shuffling)
        and return dispatch counts, latency estimates and the pool-
        occupancy trajectory.  ``accept_len`` is the expected tokens
        emitted per verify dispatch when ``geom.spec`` (>= 1.0)."""
        geom = self.geom
        if geom.spec and accept_len < 1.0:
            raise ValueError(f"accept_len must be >= 1.0, got {accept_len}")
        cal = calibration
        chunk_us = self.dispatch_us(CHUNK, cal)
        decode_us = self.dispatch_us(VERIFY if geom.spec else DECODE, cal)
        adv = accept_len if geom.spec else 1.0

        usable = geom.pool_blocks - 1        # block 0 is reserved
        pending = sorted(requests, key=lambda r: (r.arrival_us, r.rid))
        pending = list(pending)
        slots: list[_SimSlot | None] = [None] * geom.slots
        # the clock starts past the fitted warm-up: requests submitted
        # at t=0 measurably wait through it before step 1
        clock = cal.startup_us if cal is not None else 0.0
        steps = chunk_steps = 0
        used = peak = 0
        occupancy: list[int] = []
        util_sum = 0.0
        per_request: dict[int, dict[str, Any]] = {}

        def admit() -> None:
            nonlocal used, peak
            while pending and pending[0].arrival_us <= clock:
                free = next((i for i, s in enumerate(slots) if s is None),
                            None)
                if free is None:
                    return
                r = pending[0]
                # reservation mirrors the engine: the full remaining
                # budget up front (decode never fails mid-flight), ONE
                # position under spec (lazy extend grows it below)
                horizon = 1 if geom.spec else r.max_new
                span = min(r.prompt_len + horizon, geom.max_len)
                need = self._blocks_for(span)
                if used + need > usable:
                    return                    # head-of-line: FIFO holds
                pending.pop(0)
                used += need
                peak = max(peak, used)
                L = geom.prefill_chunk
                n_chunks = max(1, -(-r.prompt_len // L))
                chunks = [L] * (n_chunks - 1)
                chunks.append(r.prompt_len - L * (n_chunks - 1))
                slots[free] = _SimSlot(spec=r, chunks=chunks, blocks=need)

        def finish(i: int) -> None:
            nonlocal used
            st = slots[i]
            tokens = st.spec.max_new
            decoded = max(tokens - 1, 0)
            tpot = (((clock - st.ttft_us) / decoded)
                    if decoded and st.ttft_us >= 0 else None)
            per_request[st.spec.rid] = {
                "ttft_steps": st.ttft_steps,
                "ttft_us": st.ttft_us - st.spec.arrival_us,
                "finish_us": clock - st.spec.arrival_us,
                "tokens": tokens, "tpot_us": tpot}
            used -= st.blocks
            slots[i] = None

        while pending or any(s is not None for s in slots):
            if (not any(s is not None for s in slots)
                    and pending and pending[0].arrival_us > clock):
                clock = pending[0].arrival_us     # idle until next arrival
            admit()
            pre = [i for i, s in enumerate(slots)
                   if s is not None and s.phase == "prefill"]
            if pre:
                chunk_steps += 1
                clock += chunk_us
                for i in pre:
                    st = slots[i]
                    st.chunks.pop(0)
                    if st.chunks:
                        continue
                    st.phase = "decode"
                    st.produced = 1.0
                    st.ttft_steps = steps + chunk_steps
                    st.ttft_us = clock
                    if st.produced >= st.spec.max_new:
                        finish(i)
            active = [i for i, s in enumerate(slots)
                      if s is not None and s.phase == "decode"]
            if active:
                steps += 1
                clock += decode_us
                for i in active:
                    st = slots[i]
                    st.produced = min(st.produced + adv,
                                      float(st.spec.max_new))
                    if geom.spec:
                        # lazy extend: grow the reservation to cover the
                        # next speculative span (prompt + produced + k+1)
                        span = min(st.spec.prompt_len + st.produced
                                   + geom.spec_k + 1, geom.max_len)
                        grow = self._blocks_for(span) - st.blocks
                        if grow > 0:
                            st.blocks += grow
                            used += grow
                            peak = max(peak, used)
                    if st.produced >= st.spec.max_new:
                        finish(i)
                admit()
            occupancy.append(used)
            util_sum += used / max(usable, 1)

        return PlanResult(
            steps=steps, chunk_steps=chunk_steps, total_us=clock,
            peak_blocks=peak, occupancy=occupancy,
            avg_pool_util=util_sum / max(len(occupancy), 1),
            per_request=per_request)


# ---------------------------------------------------------------------------
# trace adapters: requests + measured latencies from obs exports
# ---------------------------------------------------------------------------

def requests_from_trace(events: list[dict]) -> list[RequestSpec]:
    """Reconstruct the request trace from lifecycle events: ``submit``
    stamps arrival, the first ``admit`` carries ``prompt_len``, and
    ``finish`` carries the SERVED token count (early-eos exact)."""
    subs: dict[int, float] = {}
    plen: dict[int, int] = {}
    toks: dict[int, int] = {}
    for ev in events:
        if ev.get("ph") == "M" or ev.get("cat") != "lifecycle":
            continue
        rid = ev.get("args", {}).get("rid", -1)
        if rid is None or rid < 0:
            continue
        name, a = ev["name"], ev.get("args", {})
        if name == "submit":
            subs.setdefault(rid, ev["ts"])
        elif name in ("admit", "resume") and "prompt_len" in a:
            plen.setdefault(rid, int(a["prompt_len"]))
        elif name == "finish":
            toks[rid] = int(a.get("tokens", 0))
    t0 = min(subs.values(), default=0.0)
    out = []
    for rid in sorted(subs):
        if rid not in plen or toks.get(rid, 0) <= 0:
            continue                          # never admitted / no tokens
        out.append(RequestSpec(rid=rid, prompt_len=plen[rid],
                               max_new=toks[rid],
                               arrival_us=subs[rid] - t0))
    return out


def measured_latencies(events: list[dict]) -> dict[int, dict[str, float]]:
    """Measured per-request TTFT/TPOT (us) from lifecycle events —
    the observed side of the model-vs-measured drift report."""
    stamps: dict[int, dict[str, float]] = {}
    toks: dict[int, int] = {}
    for ev in events:
        if ev.get("ph") == "M" or ev.get("cat") != "lifecycle":
            continue
        rid = ev.get("args", {}).get("rid", -1)
        if rid is None or rid < 0:
            continue
        st = stamps.setdefault(rid, {})
        if ev["name"] in ("submit", "first_token", "finish"):
            st.setdefault(ev["name"], ev["ts"])
        if ev["name"] == "finish":
            toks[rid] = int(ev.get("args", {}).get("tokens", 0))
    out = {}
    for rid, st in stamps.items():
        if not {"submit", "first_token", "finish"} <= set(st):
            continue
        decoded = max(toks.get(rid, 0) - 1, 0)
        out[rid] = {
            "ttft_us": st["first_token"] - st["submit"],
            "latency_us": st["finish"] - st["submit"],
            "tokens": toks.get(rid, 0),
            "tpot_us": ((st["finish"] - st["first_token"]) / decoded
                        if decoded else None)}
    return out
