"""Serving engines (port of ``repro.serving.engine``): paged and dense
continuous batching (``ContinuousEngine``) and the wave baseline
(``WaveEngine``).

Requests are admitted per SLOT: when a slot finishes its request, the
next queued request is admitted into it while the other slots keep
decoding.  The design, as in the reference:

  * **Block-paged KV.**  Attention KV lives in a shared block pool
    (``serving.kv_pool``: free list, ref-counted blocks, per-slot block
    tables).  Identical full prompt blocks are stored once and their
    prefill is skipped; a pool that cannot host a request leaves it
    queued (clean backoff).
  * **Chunked prefill, batched admission.**  Prompts are prefilled in
    fixed-size chunks; each engine step runs at most one chunk batch (all
    admitting slots in one call) and then one decode step over the
    decoding slots, so resident slots never stall longer than one chunk.
  * **Dense stripes (``paged=False``).**  Every slot owns a (max_len)
    KV stripe.  A new prompt is right-padded to the next prefill bucket
    (16, 32, ... up to max_len) and prefilled alone at batch 1
    (``network.prefill_ragged``: logits of its last real token, masked
    recurrent update), then copied into its slot
    (``network.insert_slot_caches``) with its cursor at the true length.
    Every slot's cursor advances each decode step, idle ones too (their
    writes land in their own stripe, clamped to its last row).  No
    pool: no prefix sharing, preemption or speculation.
  * **Sampling.**  Each step's tokens come from ``sampling.sample`` on the
    engine's device: greedy where a request's temperature is 0, else a
    draw from ``softmax(logits / T)`` with the engine's
    ``torch.Generator`` (seeded by ``seed``).  One host sync a step: the
    readback of the tokens.
  * **Scheduling policies.**  Which queued request a free slot admits,
    and which decoding slot is preempted for a request at risk of its
    TTFT deadline, is decided by a ``serving.policy`` policy over
    immutable views (``fifo``, ``best_fit``, ``slo_preempt``,
    ``model_fit``, ``model_preempt``).  A preempted request's whole
    sequence is registered in the prefix cache before its slot is
    released, and it re-queues with its tokens: resumption skips the
    cached prefill, and greedy output equals a never-preempted run.
    Where prefixes are not shared (recurrent configs) resumption
    re-prefills the sequence, which rebuilds the recurrent state.
  * **Speculative decoding** (``spec=``, attention configs, greedy
    requests).  A ``serving.spec`` provider drafts up to ``spec_k`` tokens
    a slot, ONE ``network.verify_paged_chunk`` call a step scores them
    all, the longest prefix matching the target's argmax is accepted and
    the rest is rolled back (cursors with ``set_slot_pos``, blocks with
    ``KVPool.truncate``; admissions reserve lazily with ``KVPool.extend``).
    A slot whose span the pool cannot host is preempted.
  * **ScheduleCache.**  The step's projection GEMMs (and the paged-decode
    gather GEMMs, and the verify shapes under ``spec=``) are resolved
    through the paper-§5 schedule cache at construction, so the steady
    state is pure cache hits; with ``gemm_backend="scheduled"`` the
    engine adopts the per-config backend's cache, which the model's
    mpgemm launches consult.
  * **Quantized serving.**  Under ``cfg.quant_serving`` the weight tree is
    rewritten to int8 QuantTensors at construction (``quant_policy``; the
    tied embedding is never quantized) and, where ``cfg.quant_kv``, the
    KV pool holds int8 blocks with per-position scale sidecars.  Each
    GEMM shape is also resolved under INT8 and under the precision the
    §5 explorer picks (``precision_plan``), so a quantized run is pure
    cache hits too.

``WaveEngine`` is the seed baseline: waves of ``slots`` requests,
prompts right-aligned (left-padded with token 0) into one dense
``prefill``, then lockstep decode steps until the wave drains.

The reference's jitted programs become plain calls of the
``models.network`` serving functions; pools and stripes are updated in
place.

**Request lifecycle.**  ``submit`` queues from any thread (under a
condition variable); ``start`` pumps ``step()`` on a background thread,
which enters the engine's device and the stream of the thread that
called ``start``; ``get_result`` blocks for the next Result (and raises
``RuntimeError`` if that thread died); ``stop`` joins it.  ``run`` is
the synchronous wrapper.  Every submitted request ends in exactly one
Result whose ``status`` is ``ok``, ``cancelled``, ``timeout``, ``shed``
or ``failed`` (``Result.error`` classifies the failure):

  * **Guards** (``resilience=ResilienceConfig(...)``): ``cancel(rid)``,
    hard deadlines (``Request.ttft_deadline_s`` / ``deadline_s``), load
    shedding at ``max_pending`` (``backpressure()``), admission retries
    with exponential backoff up to ``max_admit_retries``, and adaptive
    ``spec_k`` (``spec_degrade``).  A default config changes nothing.
  * **Step watchdog.**  The chunk, decode and verify steps run under
    ``_dispatch_guarded``: a failing step is retried next step (up to
    ``dispatch_retries`` times), a request whose step keeps failing
    (poison) is failed alone, and ``EngineCrash``, ``PoolAuditError``
    and the device faults (``resilience.DEVICE_FAULTS``: a kernel that
    did not build or launch, a sticky CUDA error) propagate.  A step
    moves no host state (cursors, tokens, chunk queues, the sampler's
    generator) and assigns no cache tree before its token readback
    returned, so a retried step re-runs the same step and rewrites the
    same KV rows.  Recurrent (SSM) state is written in place layer by
    layer, so on a config with recurrent state a genuine (not injected)
    step failure fails the step's requests at once instead of
    retrying them.
  * **Fault injection** (``faults=FaultPlane(...)``): pool denials,
    step faults, poison, draft corruption and crashes at scheduled
    points (``serving.resilience``).
  * **Warm restart.**  ``snapshot()`` records every request in flight;
    ``restore`` on a fresh engine re-admits them through the prefix
    cache (``resilience.serve_with_restarts`` drives it).
  * **Dispatch profiler** (``telemetry=Telemetry.on(profile=True)``,
    paged engines): the paged step's three dispatches (``_fns``: the
    network call through the token readback) are wrapped with wall-clock
    timing and a calibration pass times all four drift-table dispatches
    at construction (``obs.profile``).
  * **Telemetry** (``telemetry=Telemetry.on()``): lifecycle events in
    the tracer's ring at the reference's points (host ``perf_counter``
    times; a decode, verify or chunk span closes after its token
    readback), the ``pool_util`` / ``batch_occupancy`` /
    ``pending_queue`` counter tracks, and every metric of the
    reference's engine in ``metrics``.  With ``Telemetry.off()`` (the
    default) each hook is one ``tracer.enabled`` check.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue as _queue
import threading
import time
from collections.abc import Sequence
from typing import Any

import numpy as np
import torch

from repro_torch.core.pgemm import PGEMM
from repro_torch.core.precision import INT8, precision_for_dtype
from repro_torch.core.scheduler import ScheduleCache
from repro_torch.device import resolve_device
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import network as N
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Telemetry
from repro_torch.quant.policy import (QuantPolicy, choose_precision,
                                      serving_quant_params)
from repro_torch.serving.kv_pool import KVPool, PoolAuditError, blocks_for
from repro_torch.serving.policy import (PendingView, SchedulerPolicy,
                                        SlotView, make_policy)
from repro_torch.serving.resilience import (DEVICE_FAULTS, EngineCrash,
                                            FaultPlane, InjectedFault,
                                            ResilienceConfig, classify_error)
from repro_torch.serving.sampling import sample
from repro_torch.serving.spec import DraftProvider, make_provider

#: histogram bucket bounds of wall-clock request latencies (seconds)
_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0    # 0 => greedy
    eos: int = 2
    #: TTFT deadline in seconds (None: best effort); the policies that
    #: preempt act on it
    ttft_slo: float | None = None
    #: higher admits first under best_fit and is never preempted for a
    #: lower one
    priority: int = 0
    #: hard deadlines in seconds from submit (None: none).  Unlike
    #: ``ttft_slo`` (a scheduling hint) they end the request: past
    #: ``deadline_s``, or past ``ttft_deadline_s`` without a first token,
    #: it finishes with ``status="timeout"`` and the tokens it has
    ttft_deadline_s: float | None = None
    deadline_s: float | None = None


@dataclasses.dataclass
class Result:
    rid: int
    tokens: np.ndarray
    prefill_s: float
    decode_s: float
    latency_s: float = 0.0      # submit -> finish
    ttft_s: float = 0.0         # submit -> first token
    #: engine dispatches (decode + chunk batches) before the first token
    ttft_steps: int = 0
    preemptions: int = 0        # times the request was evicted
    #: ok | cancelled | timeout | shed | failed; every submitted request
    #: gets exactly one Result, and a non-ok one carries its tokens
    status: str = "ok"
    #: the failure's label (``resilience.classify_error``), or a guard's
    #: reason
    error: str | None = None


@dataclasses.dataclass
class _Pending:
    """A request's lifecycle record: the queue entry, then (held by its
    ``_Slot``) the state kept across preemptions, re-queued as it is."""

    req: Request
    t_submit: float
    #: prompt plus the tokens produced before a preemption: what an
    #: admission prefills (the resident part skips via the prefix cache)
    #: and what prefix registration content-addresses
    full_prompt: np.ndarray = None  # type: ignore[assignment]
    resume_tokens: list[int] = dataclasses.field(default_factory=list)
    t_first: float = 0.0            # kept across preemptions
    ttft_steps: int = -1            # -1: no token yet
    preemptions: int = 0
    prefill_s: float = 0.0          # prefill time of earlier admissions
    admit_failures: int = 0         # admissions the pool denied
    retry_at: int = 0               # no admission before this tick

    def __post_init__(self):
        if self.full_prompt is None:
            self.full_prompt = np.asarray(self.req.prompt, np.int32)


@dataclasses.dataclass
class _Slot:
    """Host-side state of one admission of a request (``ent``)."""

    ent: _Pending
    produced: list[int]
    cur_tok: int
    t_admit: float
    t_prefill_done: float = 0.0
    phase: str = "prefill"      # "prefill" while chunks remain, then "decode"
    chunks: list[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def req(self) -> Request:
        return self.ent.req


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    return next(b for b in buckets if n <= b)


def _draw(logits: torch.Tensor, temps: np.ndarray,
          generator: torch.Generator) -> torch.Tensor:
    """A step's tokens on the device: argmax when every row is greedy,
    else ``sampling.sample`` with the engine's generator."""
    if (temps > 0).any():
        return sample(logits, torch.as_tensor(temps, device=logits.device),
                      generator)
    return logits.argmax(dim=-1)


def _check_params(params: Any, device: torch.device) -> None:
    table = params["embed"]["table"]
    if table.device.type != device.type:
        raise ValueError(f"params live on {table.device}, the engine runs "
                         f"on {device}")


class ContinuousEngine:
    """Slot-level continuous-batching engine over the paged KV pool, or
    over dense stripes with ``paged=False``.

    ``params`` must live on ``device`` (CUDA unless the caller names
    another; without a card and without ``device="cpu"`` construction
    raises).  ``seed`` seeds the sampler's generator; ``policy`` names a
    registered policy or is one; ``spec`` is ``"ngram"`` or a
    ``DraftProvider``, with ``spec_k`` drafts a step at most.
    ``audit=True`` checks the pool invariants after every step.  The
    pool's arguments and ``prefill_chunk`` are the paged path's; the
    dense path pads each prompt to the next of ``buckets`` (16, 32, ...
    below max_len, then max_len).  Speculation and the policies that
    reserve pool blocks need the pool and are refused with
    ``paged=False``.  ``telemetry`` (default ``Telemetry.off()``),
    ``faults`` and ``resilience`` (default ``ResilienceConfig()``) are
    the request lifecycle's (module docstring)."""

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 8,
                 max_len: int = 2048, seed: int = 0, block_size: int = 16,
                 kv_blocks: int | None = None,
                 prefill_chunk: int | None = None, paged: bool = True,
                 policy: str | SchedulerPolicy = "fifo",
                 spec: str | DraftProvider | None = None, spec_k: int = 4,
                 audit: bool = False,
                 telemetry: Telemetry | None = None,
                 faults: FaultPlane | None = None,
                 resilience: ResilienceConfig | None = None,
                 quant_policy: QuantPolicy | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if cfg.is_encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: no decode serving")
        _check_params(params, self.device)
        # the registry is always real (its counters back engine.steps and
        # the other properties); the tracer ring is the opt-in part
        self.obs = telemetry if telemetry is not None else Telemetry.off()
        self.metrics = m = self.obs.metrics
        self._tr = self.obs.tracer
        self.spec: DraftProvider | None = None
        if spec is not None:
            if not paged:
                raise ValueError(
                    "speculative decoding serves through the paged KV pool "
                    "(lazy extend + truncate rollback); the dense "
                    "(paged=False) engine has no pool -- drop spec= or use "
                    "paged=True")
            if cfg.has_recurrent_state:
                raise ValueError(
                    f"{cfg.name} is a hybrid (SSM) arch: the verify step "
                    f"rolls rejected tokens back by cursor truncation, and "
                    f"recurrent state cannot be rolled back -- spec= is "
                    f"attention-only")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            self.spec = make_provider(spec)
        self.spec_k = spec_k
        self._c_spec_emitted = m.counter("spec.tokens_emitted",
                                         "tokens emitted by verify steps")
        self._c_spec_drafted = m.counter("spec.drafted",
                                         "draft tokens proposed")
        self._c_spec_accepted = m.counter("spec.accepted",
                                          "draft tokens accepted")
        self._c_spec_verifies = m.counter("spec.slot_verifies",
                                          "(slot, verify-step) events")
        self.cfg = cfg
        if cfg.quant_serving:
            # idempotent: an already-quantized tree passes through
            params = serving_quant_params(cfg, params, quant_policy)
        self.params = params
        self.policy = (make_policy(policy) if isinstance(policy, str)
                       else policy)
        if self.policy.requires_pool and not paged:
            raise ValueError(
                f"policy {self.policy.name!r} schedules over KV-pool block "
                f"reservations; the dense (paged=False) engine has no pool "
                f"-- use policy='fifo'")
        self.paged = paged
        self.slots = slots
        self.max_len = max_len
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._audit = audit
        # scheduled configs share the per-config backend's cache, which the
        # model's mpgemm launches consult; otherwise the engine owns one
        backend = N.gemm_backend(cfg)
        self.schedule = (backend.schedule if backend is not None
                         else ScheduleCache())
        self.schedule.bind_metrics(m)
        self._prec = precision_for_dtype(cfg.compute_dtype,
                                         default="FP32").name
        #: (M, N, K) -> the §5 explorer's precision for that serving GEMM
        #: (memoized: explored at construction only)
        self.precision_plan: dict[tuple[int, int, int], str] = {}

        # the dense path's padded prompt lengths: every admissible prompt
        # has one, max_len the last
        self.buckets, b = [], 16
        while b < max_len:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(max_len)
        self.pool: KVPool | None = None
        if paged:
            self.prefill_chunk = min(prefill_chunk or 32, max_len)
            per_slot = blocks_for(max_len, block_size)
            if kv_blocks is None:
                # ~3/4 of the dense ceiling (the reference's default)
                kv_blocks = max(per_slot + 1,
                                1 + (3 * slots * per_slot + 3) // 4)
            if kv_blocks < per_slot + 1:
                raise ValueError(f"kv_blocks {kv_blocks} cannot host one "
                                 f"full-window request ({per_slot} blocks "
                                 f"of {block_size})")
            # prefix sharing skips the shared prefill; recurrent (SSM)
            # state cannot be rebuilt from shared KV blocks, so it would
            # drop the prefix from the recurrence: off for such configs
            self.pool = KVPool(kv_blocks, block_size, slots=slots,
                               max_len=max_len,
                               share_prefixes=not cfg.has_recurrent_state,
                               quantized=cfg.quant_kv, metrics=m)
            self.caches = N.expand_cache_pos(
                N.init_paged_caches(cfg, slots, kv_blocks, block_size,
                                    device=self.device), slots)
            self._bt = self._table_tensor()
            self._slot_ids = torch.arange(slots, dtype=torch.int32,
                                          device=self.device)
        else:
            self.caches = N.expand_cache_pos(
                N.init_caches(cfg, slots, max_len, device=self.device),
                slots)
        self._slots: list[_Slot | None] = [None] * slots
        self._pos = np.zeros(slots, np.int32)   # mirror of the cursors
        self._pending: collections.deque[_Pending] = collections.deque()
        self._results: _queue.Queue[Result] = _queue.Queue()
        self._cv = threading.Condition()
        self._stop = False
        self._thread: threading.Thread | None = None
        self._loop_error: BaseException | None = None

        # the resilience plane: with faults=None and a default config
        # every hook below is dormant
        self.resilience = resilience or ResilienceConfig()
        self.faults = faults
        self._cancels: set[int] = set()     # rids awaiting cancellation
        self._deadlines = False             # a live request has one
        # step() calls: advances when a step fails or runs nothing, so an
        # admission backoff can never hold the queue of an idle engine
        self._ticks = 0
        self._fail_streak: dict[str, int] = {}   # consecutive, per kind
        self._spec_k_live = spec_k          # degradable speculation depth
        self._spec_clean_steps = 0
        self.last_dispatch_error: BaseException | None = None
        self._c_res_faults = m.counter("resilience.faults_injected",
                                       "fault-plane firings")
        self._c_res_retries = m.counter("resilience.retries",
                                        "transient failures retried")
        self._c_res_cancelled = m.counter("resilience.cancelled",
                                          "requests cancelled")
        self._c_res_timeouts = m.counter("resilience.timeouts",
                                         "requests past a hard deadline")
        self._c_res_shed = m.counter(
            "resilience.shed", "submissions rejected at the queue bound")
        self._c_res_quarantined = m.counter(
            "resilience.quarantined", "requests failed by the step watchdog")
        self._c_res_admit_fail = m.counter("resilience.admit_failures",
                                           "failed admission attempts")
        self._c_res_degrades = m.counter("resilience.spec_degrades",
                                         "spec_k halvings under pressure")
        self._c_res_restores = m.counter("resilience.restored",
                                         "snapshot entries re-admitted")
        if faults is not None:
            faults.on_fire = self._note_fault
            if paged:
                faults.attach_pool(self.pool)

        self._c_steps = m.counter("engine.steps",
                                  "decode/verify dispatches executed")
        self._c_prefills = m.counter("engine.prefills",
                                     "prompts fully prefilled")
        self._c_chunk_steps = m.counter(
            "engine.chunk_steps", "prefill-chunk batches executed")
        self._c_preemptions = m.counter("engine.preemptions",
                                        "victim evictions")
        self._c_admissions = m.counter(
            "engine.admissions", "slot admissions (fresh + resumed)")
        self._c_resumes = m.counter(
            "engine.resumes", "re-admissions of preempted requests")
        self._c_tokens = m.counter("engine.tokens_emitted",
                                   "tokens delivered in Results")
        self._c_finished = m.counter("engine.requests_finished",
                                     "Results emitted")
        # one pool-utilisation sample (used / usable blocks) a step
        self._c_util_sum = m.counter("engine.pool_util_sum",
                                     "sum of per-step pool-util samples")
        self._c_util_samples = m.counter("engine.pool_util_samples",
                                         "pool-util samples taken")
        self._g_pool_util = m.gauge("engine.pool_util",
                                    "pool utilisation at the last step")
        self._g_occupancy = m.gauge("engine.batch_occupancy",
                                    "active slots at the last step")
        self._h_ttft_steps = m.histogram(
            "engine.ttft_steps",
            "engine dispatches before each request's first token")
        self._h_ttft_s = m.histogram("engine.ttft_s",
                                     "submit -> first token (s)",
                                     buckets=_LATENCY_BUCKETS)
        self._h_latency = m.histogram("engine.request_latency_s",
                                      "submit -> finish (s)",
                                      buckets=_LATENCY_BUCKETS)
        self._s_decode = m.series(
            "engine.decode_step_stamps",
            "perf_counter stamps of decode-step completions")
        self._s_chunk = m.series("engine.chunk_duration_s",
                                 "prefill-chunk batch wall times")

        # pre-resolve the steady-state shapes: decode (M = slots), the
        # chunk batch (M = slots * chunk), the gather GEMMs and, under
        # spec=, the verify family (slots * (k+1) rows, head included),
        # so the serving hot path never explores (a dense admission
        # registers its bucket when it first sees it)
        self._register_gemms(slots, slots)
        if paged:
            self._register_gemms(slots * self.prefill_chunk, slots)
            for M, Nn, K in PA.gather_gemm_shapes(cfg, block_size):
                self.schedule.resolve(M, Nn, K, self._prec)
        if self.spec is not None:
            L = self.spec_k + 1
            self._register_gemms(slots * L, slots * L)
            self.spec.bind(self)
        #: the paged step's three dispatches (:meth:`_engine_fns`); the
        #: dispatch profiler wraps them
        self._fns = self._engine_fns()
        if self.obs.profiler is not None:
            # times the hot dispatches (a sync each) and runs the
            # calibration pass over all four drift-table dispatches
            self.obs.profiler.attach(self)

    def _engine_fns(self) -> dict[str, Any]:
        """The paged step's dispatches, each from its inputs to the
        tokens on the host, as the reference's jitted programs run:
        ``decode_sample_paged`` and ``prefill_chunk`` (the network call,
        the head and the sampling, ``_pick``) and ``verify_chunk`` (the
        network call and the argmax).  Each returns (tokens (numpy),
        caches)."""
        cfg = self.cfg

        def decode_sample_paged(params, toks, caches, pos, bt, adv, temps):
            logits, caches = N.decode_step(params, cfg, toks, caches, pos,
                                           bt, adv)
            return self._pick(logits, temps), caches

        def prefill_chunk(params, toks, caches, slot_ids, bt, lens,
                          last_idx, temps):
            logits, caches = N.prefill_paged_chunk(
                params, cfg, toks, caches, slot_ids, bt, lens, last_idx)
            return self._pick(logits, temps), caches

        def verify_chunk(params, toks, caches, slot_ids, bt, lens):
            logits, caches = N.verify_paged_chunk(params, cfg, toks, caches,
                                                  slot_ids, bt, lens)
            return logits.argmax(dim=-1).cpu().numpy(), caches

        return {"decode_sample_paged": decode_sample_paged,
                "prefill_chunk": prefill_chunk,
                "verify_chunk": verify_chunk}

    # -- counters --------------------------------------------------------------

    @property
    def steps(self) -> int:
        return int(self._c_steps.value)

    @property
    def chunk_steps(self) -> int:
        return int(self._c_chunk_steps.value)

    @property
    def prefills(self) -> int:
        return int(self._c_prefills.value)

    @property
    def admissions(self) -> int:
        return int(self._c_admissions.value)

    @property
    def resumes(self) -> int:
        return int(self._c_resumes.value)

    @property
    def preemptions(self) -> int:
        return int(self._c_preemptions.value)

    @property
    def spec_emitted(self) -> int:
        return int(self._c_spec_emitted.value)

    @property
    def spec_drafted(self) -> int:
        return int(self._c_spec_drafted.value)

    @property
    def spec_accepted(self) -> int:
        return int(self._c_spec_accepted.value)

    @property
    def spec_slot_verifies(self) -> int:
        return int(self._c_spec_verifies.value)

    def avg_pool_util(self) -> float:
        """Mean fraction of usable pool blocks in use, one sample a step."""
        return self._c_util_sum.value / max(self._c_util_samples.value, 1)

    def avg_accept_len(self) -> float:
        """Mean tokens a slot emits a verify (1.0: nothing accepted)."""
        return self.spec_emitted / max(self.spec_slot_verifies, 1)

    def spec_stats(self) -> dict[str, Any]:
        """Speculation counters (zeros without ``spec=``)."""
        return {
            "provider": self.spec.name if self.spec else None,
            "k": self.spec_k if self.spec else 0,
            "verify_steps": self.steps if self.spec else 0,
            "tokens_emitted": self.spec_emitted,
            "drafted": self.spec_drafted,
            "accepted": self.spec_accepted,
            "avg_accept_len": round(self.avg_accept_len(), 4),
            "draft_steps": getattr(self.spec, "steps", 0),
            "draft_chunk_steps": getattr(self.spec, "chunk_steps", 0),
        }

    def _table_tensor(self) -> torch.Tensor:
        return torch.as_tensor(self.pool.tables, device=self.device)

    def _register_gemms(self, m_tokens: int, head_rows: int) -> None:
        """Resolve the step's projection p-GEMMs (memoized)."""
        cfg, d = self.cfg, self.cfg.d_model
        # an MoE config's FFN GEMMs run at the expert width
        d_ff = cfg.moe.d_ff_expert if cfg.moe is not None else cfg.d_ff
        shapes = [(m_tokens, cfg.n_heads * cfg.hd, d),
                  (m_tokens, cfg.n_kv_heads * cfg.hd, d),
                  (m_tokens, d, cfg.n_heads * cfg.hd),
                  (m_tokens, d_ff, d), (m_tokens, d, d_ff),
                  (head_rows, cfg.vocab, d)]
        for M, Nn, K in shapes:
            # attention-free configs zero out dims (mamba2: d_ff == 0, no
            # MLP); a degenerate GEMM has no schedule and the §5 cost
            # model cannot take K == 0, so it is skipped
            if M <= 0 or Nn <= 0 or K <= 0:
                continue
            self.schedule.resolve(M, Nn, K, self._prec)
            if cfg.quant_serving:
                # int8 leaves run ops.quant_matmul, which resolves under
                # INT8; float leaves and the head stay on the compute
                # precision
                if self._prec != "INT8":
                    self.schedule.resolve(M, Nn, K, "INT8")
                chosen = self._gemm_precision(M, Nn, K)
                if chosen not in (self._prec, "INT8"):
                    self.schedule.resolve(M, Nn, K, chosen)

    def _gemm_precision(self, M: int, N: int, K: int) -> str:
        """The §5 explorer's precision (``choose_precision``) for one
        serving GEMM, memoized per shape."""
        name = self.precision_plan.get((M, N, K))
        if name is None:
            name = choose_precision(
                PGEMM("serve", M=M, N=N, K=K, precision=INT8)).name
            self.precision_plan[(M, N, K)] = name
        return name

    # -- request API -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request (thread-safe); raises at once, in the caller's
        thread, on one that can never be served.  At the
        ``max_pending`` bound the request is shed: its terminal Result
        is queued now."""
        if len(req.prompt) > self.max_len:
            raise ValueError(
                f"prompt {len(req.prompt)} exceeds max_len {self.max_len}")
        if len(req.prompt) == 0:
            raise ValueError("empty prompt")
        if self.spec is not None and req.temperature > 0:
            raise ValueError(
                "speculative decoding is greedy-only (accept-longest-prefix "
                "against the target argmax) -- submit temperature=0 "
                "requests or serve without spec=")
        if req.ttft_deadline_s is not None or req.deadline_s is not None:
            self._deadlines = True
        bound = self.resilience.max_pending
        ent = _Pending(req=req, t_submit=time.perf_counter())
        with self._cv:
            shed = bound is not None and len(self._pending) >= bound
            if not shed:
                self._pending.append(ent)
                self._cv.notify()
        if shed:
            self._c_res_shed.inc()
            if self._tr.enabled:
                self._tr.event("shed", rid=req.rid,
                               step=self.steps + self.chunk_steps,
                               pending=bound)
            self._emit_terminal(ent, "shed",
                                f"pending queue at bound {bound}")
            return
        if self._tr.enabled:
            self._tr.event("submit", rid=req.rid,
                           step=self.steps + self.chunk_steps,
                           prompt_len=len(req.prompt),
                           max_new=req.max_new_tokens)

    def cancel(self, rid: int) -> bool:
        """Ask for ``rid``'s cancellation (thread-safe, idempotent).  The
        next step serves it: a queued request ends at once, a running
        one releases its slot and blocks (a decoding one registers its
        sequence in the prefix cache, as a preemption does), and the
        Result has ``status="cancelled"`` and the tokens so far.  False
        when ``rid`` is neither queued nor running."""
        with self._cv:
            known = any(e.req.rid == rid for e in self._pending) or any(
                s is not None and s.req.rid == rid for s in self._slots)
            if not known:
                return False
            self._cancels.add(rid)
            self._cv.notify()
        return True

    def backpressure(self) -> bool:
        """True when the queue is at ``ResilienceConfig.max_pending`` (a
        further submit is shed); always False without a bound."""
        bound = self.resilience.max_pending
        if bound is None:
            return False
        with self._cv:
            return len(self._pending) >= bound

    def drain_results(self) -> list[Result]:
        """Every Result finished so far (non-blocking)."""
        out: list[Result] = []
        while True:
            try:
                out.append(self._results.get_nowait())
            except _queue.Empty:
                return out

    def get_result(self, timeout: float | None = None) -> Result:
        """The next finished Result, in completion order; blocks up to
        ``timeout`` seconds (``queue.Empty`` past it).  Raises
        ``RuntimeError`` if the serve loop died, once the Results it
        finished are drained."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            wait = (0.1 if deadline is None else
                    min(0.1, max(0.0, deadline - time.perf_counter())))
            try:
                return self._results.get(timeout=wait)
            except _queue.Empty:
                if self._loop_error is not None:
                    raise RuntimeError(
                        "serve loop died") from self._loop_error
                if deadline is not None and time.perf_counter() >= deadline:
                    raise

    def start(self) -> None:
        """Pump ``step()`` on a background thread, on this thread's
        current CUDA stream (the one a synchronous ``step()`` here would
        use)."""
        if self._thread is not None:
            return
        self._stop = False
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._serve_loop,
                                        args=(stream,), name="engine-serve",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the serve loop and join its thread: afterwards no launch
        of the engine is in flight from it."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _serve_loop(self, stream: torch.cuda.Stream | None) -> None:
        with contextlib.ExitStack() as ctx:
            if stream is not None:
                ctx.enter_context(torch.cuda.device(self.device))
                ctx.enter_context(torch.cuda.stream(stream))
            while True:
                with self._cv:
                    if self._stop:
                        return
                    if not self._pending and all(
                            s is None for s in self._slots):
                        self._cv.wait(timeout=0.05)
                        continue
                try:
                    self.step()
                except BaseException as e:  # noqa: BLE001 - get_result raises
                    self._loop_error = e
                    raise

    def run(self, requests: Sequence[Request]) -> list[Result]:
        """Serve all requests; results in COMPLETION order.  Refused while
        the serve loop runs (one thread pumps an engine)."""
        if self._thread is not None:
            raise RuntimeError(
                "run() while the background serve loop is active; use "
                "submit()/get_result() instead (or stop() first)")
        for r in requests:
            self.submit(r)
        out: list[Result] = []
        while len(out) < len(requests):
            self.step()
            out += self.drain_results()
        return out

    # -- the engine step -------------------------------------------------------

    def step(self) -> int:
        """Serve the guards (cancels, deadlines), admit what the policy
        picks, preempt if it names a victim, run at most one
        prefill-chunk batch and one batched decode (or verify) step, then
        refill.  Returns the number of active slots.

        The chunk, decode and verify steps run under the step watchdog
        (``_dispatch_guarded``): a failing step is retried or its
        requests failed, and the engine lives on -- except for
        ``EngineCrash``, ``PoolAuditError`` and the device faults, which
        propagate."""
        self._ticks += 1
        if self._cancels or self._deadlines:
            self._service_guards()
        self._admit()
        if self.paged:
            self._maybe_preempt()
            pre = [i for i, s in enumerate(self._slots)
                   if s is not None and s.phase == "prefill"]
            if pre and not self._dispatch_guarded(
                    "chunk", pre, self._prefill_chunk_step):
                return self._end_step()     # the batch retries next step
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.phase == "decode"]
        if not active:
            return self._end_step()
        if self.spec is not None:
            self._dispatch_guarded("verify", active, self._spec_step)
        else:
            self._dispatch_guarded("decode", active, self._decode_step)
        self._admit()
        return self._end_step()

    # -- policy views ----------------------------------------------------------

    def _pending_view(self, index: int, ent: _Pending, now: float,
                      evictable_hint: int | None = None) -> PendingView:
        remaining = ent.req.max_new_tokens - len(ent.resume_tokens)
        probe = (self.pool.probe([int(t) for t in ent.full_prompt],
                                 self._reserve_horizon(remaining),
                                 evictable_hint=evictable_hint)
                 if self.paged and self.policy.needs_probes else None)
        return PendingView(index=index, rid=ent.req.rid,
                           prompt_len=len(ent.full_prompt),
                           new_tokens=remaining, priority=ent.req.priority,
                           ttft_slo=ent.req.ttft_slo,
                           waited_s=now - ent.t_submit,
                           resumed=bool(ent.resume_tokens),
                           preemptions=ent.preemptions, probe=probe)

    def _pending_views(self) -> tuple[list[PendingView], float]:
        now = time.perf_counter()
        hint = (self.pool.evictable_cached()
                if self.paged and self.policy.needs_probes else None)
        return [self._pending_view(i, e, now, hint)
                for i, e in enumerate(self._pending)], now

    def _slot_view(self, index: int) -> SlotView | None:
        st = self._slots[index]
        if st is None:
            return None
        return SlotView(index=index, rid=st.req.rid, phase=st.phase,
                        priority=st.req.priority, produced=len(st.produced),
                        remaining=st.req.max_new_tokens - len(st.produced),
                        reclaimable_blocks=self.pool.reclaimable_blocks(
                            index),
                        preemptions=st.ent.preemptions,
                        has_slo=st.req.ttft_slo is not None)

    # -- admission and preemption ----------------------------------------------

    def _reserve_horizon(self, remaining_new: int) -> int:
        """Decode positions an admission reserves: the whole remaining
        budget, or one under spec= (each verify extends and truncates the
        span, so rollback returns real blocks)."""
        return 1 if self.spec is not None else remaining_new

    def _admit(self) -> None:
        """Admit the policy's pick into each free slot; a request the pool
        cannot host goes back to its place in the queue (or, out of
        retries, fails: ``_admit_failed``)."""
        while True:
            slot = next((i for i, s in enumerate(self._slots) if s is None),
                        None)
            if slot is None:
                return
            with self._cv:
                if not self._pending:
                    return
                views, now = self._pending_views()
                idx = self.policy.select_admission(views, now)
                if idx is None:
                    return                  # the policy holds the queue
                ent = self._pending[idx]
                if ent.retry_at > self._ticks:
                    return                  # admission backoff
                del self._pending[idx]
            if not self.paged:
                self._admit_dense(slot, ent)
            elif not self._admit_one(slot, ent):
                if self._admit_failed(ent):
                    continue                # failed for good: next entry
                with self._cv:
                    self._pending.insert(idx, ent)
                return

    def _admit_failed(self, ent: _Pending) -> bool:
        """Book one admission the pool denied.  The default config retries
        every step, forever; with ``max_admit_retries`` the request fails
        for good past it (True: not re-queued), and with
        ``admit_backoff_steps`` the retries space out exponentially."""
        res = self.resilience
        ent.admit_failures += 1
        self._c_res_admit_fail.inc()
        if (res.max_admit_retries is not None
                and ent.admit_failures > res.max_admit_retries):
            self._c_res_quarantined.inc()
            if self._tr.enabled:
                self._tr.event("quarantine", rid=ent.req.rid,
                               step=self.steps + self.chunk_steps,
                               error="admission retries exhausted",
                               attempts=ent.admit_failures)
            self._emit_terminal(ent, "failed",
                                f"admission failed {ent.admit_failures}x "
                                f"(pool exhausted)")
            return True
        if res.admit_backoff_steps > 0:
            hold = res.admit_backoff_steps * (
                2 ** min(ent.admit_failures - 1, 6))
            ent.retry_at = self._ticks + hold
            self._c_res_retries.inc()
            if self._tr.enabled:
                self._tr.event("retry", rid=ent.req.rid,
                               step=self.steps + self.chunk_steps,
                               kind="admit", attempt=ent.admit_failures,
                               hold_steps=hold)
        return False

    def _admit_one(self, slot: int, ent: _Pending) -> bool:
        """Reserve blocks (a shared prefix is mapped in and its prefill
        skipped; for a preempted request the sequence includes its tokens)
        and queue the rest of the admission prompt as chunks."""
        req = ent.req
        remaining = req.max_new_tokens - len(ent.resume_tokens)
        plan = self.pool.admit(slot, [int(t) for t in ent.full_prompt],
                               self._reserve_horizon(remaining))
        if plan is None:
            return False
        t0 = time.perf_counter()
        self._bt = self._table_tensor()
        self.caches = N.reset_slot_state(self.caches, slot,
                                         plan.shared_tokens)
        if self.spec is not None:
            self.spec.on_reset_slot(self, slot, plan.shared_tokens)
        self._pos[slot] = plan.shared_tokens
        rest = np.asarray(ent.full_prompt[plan.shared_tokens:], np.int32)
        L = self.prefill_chunk
        chunks = [rest[j:j + L] for j in range(0, len(rest), L)]
        self._slots[slot] = _Slot(ent=ent, produced=list(ent.resume_tokens),
                                  cur_tok=-1, t_admit=t0, chunks=chunks)
        self._c_admissions.inc()
        resumed = bool(ent.resume_tokens)
        if resumed:
            self._c_resumes.inc()
        if self._tr.enabled:
            self._tr.event("resume" if resumed else "admit", rid=req.rid,
                           slot=slot, step=self.steps + self.chunk_steps,
                           ts=t0, prompt_len=len(ent.full_prompt),
                           shared_tokens=plan.shared_tokens,
                           chunks=len(chunks))
        return True

    def _admit_dense(self, slot: int, ent: _Pending) -> None:
        """Dense path: one bucketed ragged prefill at batch 1 into a fresh
        batch-1 tree, copied into the slot with its cursor at the prompt
        length; the first token comes with it."""
        req = ent.req
        plen = len(req.prompt)
        bucket = _bucket_for(plen, self.buckets)
        t0 = time.perf_counter()
        self._register_gemms(bucket, 1)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = req.prompt
        small = N.init_caches(self.cfg, 1, self.max_len, device=self.device)
        logits, small = N.prefill_ragged(
            self.params, self.cfg, {"tokens": self._tensor(toks)}, small,
            self._tensor(np.asarray([plen - 1], np.int32)))
        self.caches = N.insert_slot_caches(self.caches, small, slot, plen)
        tok = int(self._pick(logits, np.asarray([req.temperature],
                                                np.float32))[0])
        self._pos[slot] = plen
        self._c_prefills.inc()
        self._c_admissions.inc()
        now = time.perf_counter()
        ent.t_first = now
        ent.ttft_steps = self.steps + self.chunk_steps
        self._slots[slot] = _Slot(ent=ent, produced=[tok], cur_tok=tok,
                                  t_admit=t0, t_prefill_done=now,
                                  phase="decode")
        if self._tr.enabled:
            self._tr.event("admit", rid=req.rid, slot=slot,
                           step=ent.ttft_steps, ts=t0, prompt_len=plen)
            self._tr.event("first_token", rid=req.rid, slot=slot,
                           step=ent.ttft_steps, ts=now)
        # a prompt filling the stripe has no decode headroom: the next
        # write would clamp onto its last token, so it ends here
        if self._done(slot):
            self._finish(slot)

    def _maybe_preempt(self) -> None:
        """Ask the policy for a victim (at most one a step), evict it and
        admit again, so the freed slot and blocks serve the request at
        risk in this step."""
        if not self.policy.preempts:
            return
        with self._cv:
            if not self._pending:
                return
            pviews, now = self._pending_views()
        sviews = [self._slot_view(i) for i in range(self.slots)]
        victim = self.policy.select_victim(pviews, sviews, now)
        if victim is None:
            return
        self._preempt(victim)
        self._admit()

    def _preempt(self, slot: int) -> None:
        """Evict a decoding slot: register its whole sequence (prompt +
        produced) so its resident KV blocks stay in the prefix cache, drop
        the slot's refs and re-queue the request, at the tail, with its
        tokens.  The resumed prompt's last token is the victim's last
        produced one, whose logits seed the next step where it left off."""
        st = self._slots[slot]
        assert st is not None and st.phase == "decode", (slot, st and
                                                         st.phase)
        full_seq = ([int(t) for t in st.req.prompt]
                    + [int(t) for t in st.produced])
        # only FULL blocks among the resident positions [0, pos) are
        # registered; the tail is prefilled again on resume
        self.pool.release_slot(slot, prompt=full_seq)
        self._bt = self._table_tensor()
        self._slots[slot] = None
        self._c_preemptions.inc()
        if self._tr.enabled:
            self._tr.event("preempt", rid=st.req.rid, slot=slot,
                           step=self.steps + self.chunk_steps,
                           produced=len(st.produced))
        ent = st.ent
        ent.full_prompt = np.asarray(full_seq, np.int32)
        ent.resume_tokens = list(st.produced)
        ent.preemptions += 1
        ent.prefill_s += st.t_prefill_done - st.t_admit
        with self._cv:
            self._pending.append(ent)

    # -- resilience: guards, step watchdog, warm restart ---------------------

    def _note_fault(self, rec: dict) -> None:
        """``FaultPlane.on_fire``: count and trace every injection."""
        self._c_res_faults.inc()
        if self._tr.enabled:
            self._tr.event("fault_injected", rid=int(rec.get("rid", -1)),
                           step=self.steps + self.chunk_steps,
                           kind=rec.get("kind", "?"))

    def _emit_terminal(self, ent: _Pending, status: str,
                       error: str | None = None) -> None:
        """Terminal Result of a request that holds no slot: shed at
        submit, cancelled or timed out in the queue, or out of admission
        retries.  Tokens of admissions before a preemption are kept."""
        now = time.perf_counter()
        self._results.put(Result(
            rid=ent.req.rid, tokens=np.asarray(ent.resume_tokens, np.int32),
            prefill_s=ent.prefill_s, decode_s=0.0,
            latency_s=now - ent.t_submit,
            ttft_s=max(ent.t_first - ent.t_submit, 0.0) if ent.t_first
            else 0.0, ttft_steps=max(ent.ttft_steps, 0),
            preemptions=ent.preemptions, status=status, error=error))
        self._c_finished.inc()
        self._c_tokens.inc(len(ent.resume_tokens))
        self._h_latency.observe(now - ent.t_submit)

    def _finish_abnormal(self, slot: int, status: str,
                         error: str | None) -> None:
        """End a RUNNING request off the happy path (cancel, timeout,
        quarantine): ``_finish``'s accounting with the status set.  A
        decoding slot registers its whole sequence in the prefix cache,
        as ``_preempt`` does; a slot mid-prefill releases plainly (its
        tail blocks hold a partial prefill no request may share)."""
        st = self._slots[slot]
        ent = st.ent
        now = time.perf_counter()
        done = st.t_prefill_done
        self._results.put(Result(
            rid=ent.req.rid, tokens=np.asarray(st.produced, np.int32),
            prefill_s=ent.prefill_s + (max(done - st.t_admit, 0.0)
                                       if done else 0.0),
            decode_s=(now - done) if done else 0.0,
            latency_s=now - ent.t_submit,
            ttft_s=max(ent.t_first - ent.t_submit, 0.0) if ent.t_first
            else 0.0, ttft_steps=max(ent.ttft_steps, 0),
            preemptions=ent.preemptions, status=status, error=error))
        self._c_finished.inc()
        self._c_tokens.inc(len(st.produced))
        self._h_latency.observe(now - ent.t_submit)
        if self._tr.enabled:
            self._tr.event("finish", rid=ent.req.rid, slot=slot,
                           step=self.steps + self.chunk_steps, ts=now,
                           tokens=len(st.produced), status=status)
        self._slots[slot] = None
        if self.paged:
            if st.phase == "decode" and st.produced:
                self.pool.release_slot(slot, prompt=(
                    [int(t) for t in st.req.prompt]
                    + [int(t) for t in st.produced]))
            else:
                self.pool.release_slot(slot)
            self._bt = self._table_tensor()

    def _service_guards(self) -> None:
        """Start-of-step sweep: cancellations, then hard deadlines --
        queue entries first, then running slots.  ``step`` skips it while
        no cancel is queued and no live request has a deadline."""
        with self._cv:
            cancels, self._cancels = self._cancels, set()
        now = time.perf_counter()

        def verdict(ent: _Pending) -> tuple[str, str | None] | None:
            req = ent.req
            if req.rid in cancels:
                return "cancelled", None
            if (req.deadline_s is not None
                    and now - ent.t_submit > req.deadline_s):
                return "timeout", "deadline_s exceeded"
            if (req.ttft_deadline_s is not None and ent.ttft_steps < 0
                    and now - ent.t_submit > req.ttft_deadline_s):
                return "timeout", "ttft_deadline_s exceeded"
            return None

        drop: list[tuple[_Pending, str, str | None]] = []
        with self._cv:
            keep: collections.deque[_Pending] = collections.deque()
            for ent in self._pending:
                v = verdict(ent)
                if v is None:
                    keep.append(ent)
                else:
                    drop.append((ent, *v))
            self._pending = keep
        for ent, status, error in drop:
            self._note_guard(status, ent.req.rid, -1)
            self._emit_terminal(ent, status, error)
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            v = verdict(st.ent)
            if v is not None:
                self._note_guard(v[0], st.req.rid, i)
                self._finish_abnormal(i, *v)

    def _note_guard(self, status: str, rid: int, slot: int) -> None:
        if status == "cancelled":
            self._c_res_cancelled.inc()
        else:
            self._c_res_timeouts.inc()
        if self._tr.enabled:
            self._tr.event("cancel" if status == "cancelled" else "timeout",
                           rid=rid, slot=slot,
                           step=self.steps + self.chunk_steps)

    def _quarantine(self, slot: int, exc: BaseException) -> None:
        """Fail ONE running request whose step keeps failing; the engine
        lives on for the others."""
        st = self._slots[slot]
        self._c_res_quarantined.inc()
        if self._tr.enabled:
            self._tr.event("quarantine", rid=st.req.rid, slot=slot,
                           step=self.steps + self.chunk_steps,
                           error=classify_error(exc))
        self._finish_abnormal(slot, "failed", classify_error(exc))

    def _dispatch_guarded(self, kind: str, slots: list[int], fn) -> bool:
        """Run one step (``kind``: chunk, decode or verify) under the
        watchdog; True when it ran.

        The fault plane fires before the step (nothing has moved), and a
        step moves no host state before its token readback, so a retry
        re-runs the same step.  A fault aimed at one request (poison)
        fails that request; any other failure is retried up to
        ``ResilienceConfig.dispatch_retries`` consecutive times, then the
        step's requests fail.  ``EngineCrash``, ``PoolAuditError`` and
        the device faults (``DEVICE_FAULTS``) propagate."""
        if self.faults is not None:
            try:
                self.faults.before_dispatch(
                    kind, self.steps + self.chunk_steps,
                    [self._slots[i].req.rid for i in slots])
            except InjectedFault as e:
                self._on_dispatch_error(kind, slots, e)
                return False
        # a sampled step draws from the generator after its model call;
        # a failure after the draw must not leave it moved
        sampled = any(self._slots[i].req.temperature > 0 for i in slots)
        gen = self.generator.get_state() if sampled else None
        try:
            fn(slots)
        except (EngineCrash, PoolAuditError, KeyboardInterrupt,
                *DEVICE_FAULTS):
            raise
        except Exception as e:  # noqa: BLE001 - the watchdog isolates the step
            if gen is not None:
                self.generator.set_state(gen)
            self._on_dispatch_error(kind, slots, e)
            return False
        self._fail_streak.pop(kind, None)
        return True

    def _on_dispatch_error(self, kind: str, slots: list[int],
                           exc: BaseException) -> None:
        self.last_dispatch_error = exc
        rid = int(getattr(exc, "rid", -1))
        target = next((i for i in slots if self._slots[i] is not None
                       and self._slots[i].req.rid == rid), None)
        if target is not None:
            # poison: one request is at fault; the rest re-run next step
            self._resync_slots()
            self._quarantine(target, exc)
            self._fail_streak.pop(kind, None)
            return
        streak = self._fail_streak.get(kind, 0) + 1
        # recurrent state is written in place layer by layer: after a
        # genuine failure part way through a step it cannot be re-run
        partial = (self.cfg.has_recurrent_state
                   and not isinstance(exc, InjectedFault))
        if streak > self.resilience.dispatch_retries or partial:
            self._fail_streak.pop(kind, None)
            self._resync_slots()
            for i in list(slots):
                if self._slots[i] is not None:
                    self._quarantine(i, exc)
            return
        self._fail_streak[kind] = streak
        self._c_res_retries.inc()
        if self._tr.enabled:
            self._tr.event("retry", step=self.steps + self.chunk_steps,
                           kind=kind, attempt=streak,
                           error=classify_error(exc))
        self._resync_slots()

    def _resync_slots(self) -> None:
        """Bring the pool and the draft back to ``self._pos`` after a
        failed step.  The target's cache tree is safe (kept only after a
        step's readback), but a verify step may have grown tables (lazy
        extend) and moved the draft's cursors (propose) first.  Without
        spec= admissions reserve their whole span: nothing to undo."""
        if self.spec is None:
            return
        self.spec.on_rollback(self, self._pos)
        for i, st in enumerate(self._slots):
            if st is not None and st.phase == "decode":
                self.pool.truncate(i, int(self._pos[i]))

    def snapshot(self) -> dict:
        """Host-side warm-restart snapshot: every queued and running
        request with its tokens, and the pool's state
        (``KVPool.snapshot_state``).  Device KV is not kept: ``restore``
        re-admits each request through the prefix cache on a fresh
        engine, and prefill writes the KV decode would have, so greedy
        outputs equal an uncrashed run's."""

        def req_d(req: Request) -> dict:
            return {"rid": req.rid,
                    "prompt": [int(t) for t in req.prompt],
                    "max_new_tokens": req.max_new_tokens,
                    "temperature": req.temperature, "eos": req.eos,
                    "ttft_slo": req.ttft_slo, "priority": req.priority,
                    "ttft_deadline_s": req.ttft_deadline_s,
                    "deadline_s": req.deadline_s}

        entries = [{"req": req_d(st.req),
                    "full_prompt": [int(t) for t in st.ent.full_prompt],
                    "produced": [int(t) for t in st.produced],
                    "phase": st.phase,
                    "resume_len": len(st.ent.resume_tokens),
                    "preemptions": st.ent.preemptions,
                    "ttft_steps": st.ent.ttft_steps}
                   for st in self._slots if st is not None]
        with self._cv:
            entries += [{"req": req_d(e.req),
                         "full_prompt": [int(t) for t in e.full_prompt],
                         "produced": [int(t) for t in e.resume_tokens],
                         "phase": "queued",
                         "resume_len": len(e.resume_tokens),
                         "preemptions": e.preemptions,
                         "ttft_steps": e.ttft_steps} for e in self._pending]
        return {"version": 1, "in_flight": entries,
                "pool": self.pool.snapshot_state() if self.paged else None}

    def restore(self, snap: dict) -> int:
        """Re-queue a dead engine's :meth:`snapshot` on THIS fresh engine
        (same config and params).  A decoding entry comes back as
        prompt + tokens, as a preemption re-queues it, so its admission
        skips whatever KV the prefix cache holds and prefills the rest;
        queued and mid-prefill entries restart from their admission
        prompt.  Deadlines restart from now.  Returns the entries
        re-queued."""
        if self._pending or any(s is not None for s in self._slots):
            raise RuntimeError("restore() requires a fresh engine")
        now = time.perf_counter()
        n = 0
        for d in snap["in_flight"]:
            r = d["req"]
            req = Request(
                rid=int(r["rid"]), prompt=np.asarray(r["prompt"], np.int32),
                max_new_tokens=int(r["max_new_tokens"]),
                temperature=float(r["temperature"]), eos=int(r["eos"]),
                ttft_slo=r["ttft_slo"], priority=int(r["priority"]),
                ttft_deadline_s=r["ttft_deadline_s"],
                deadline_s=r["deadline_s"])
            produced = [int(t) for t in d["produced"]]
            if d["phase"] == "decode" and produced:
                full = np.asarray([int(t) for t in r["prompt"]] + produced,
                                  np.int32)
            else:
                # queued or mid-prefill: the tokens are the entry's resume
                # tokens, already inside its admission prompt
                full = np.asarray(d["full_prompt"], np.int32)
            if req.ttft_deadline_s is not None or req.deadline_s is not None:
                self._deadlines = True
            ent = _Pending(req=req, t_submit=now, full_prompt=full,
                           resume_tokens=produced,
                           ttft_steps=int(d["ttft_steps"]),
                           preemptions=int(d["preemptions"]))
            with self._cv:
                self._pending.append(ent)
                self._cv.notify()
            n += 1
        self._c_res_restores.inc(n)
        if self._tr.enabled:
            self._tr.event("restore", step=self.steps + self.chunk_steps,
                           entries=n)
        return n

    # -- dispatches ------------------------------------------------------------

    def _apply_cow(self) -> None:
        """Run pending copy-on-write forks on the device pools."""
        copies = self.pool.take_copies()
        if copies:
            src = torch.tensor([c[0] for c in copies], device=self.device)
            dst = torch.tensor([c[1] for c in copies], device=self.device)
            self.caches = N.copy_paged_blocks(self.caches, src, dst)
            if self.spec is not None:
                self.spec.on_apply_cow(self, src, dst)
            self._bt = self._table_tensor()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _pick(self, logits: torch.Tensor, temps: np.ndarray) -> np.ndarray:
        """The step's tokens (``_draw``), read back in one sync."""
        return _draw(logits, temps, self.generator).cpu().numpy()

    def _prefill_chunk_step(self, pre: list[int]) -> None:
        """One chunk for EVERY admitting slot in one call; other rows ride
        along masked (length 0).  The chunks are consumed, the cursors
        advanced and the new cache tree kept only after the token
        readback, so a failed step is re-run as it was."""
        L = self.prefill_chunk
        toks = np.zeros((self.slots, L), np.int32)
        lens = np.zeros(self.slots, np.int32)
        temps = np.zeros(self.slots, np.float32)
        for i in pre:
            st = self._slots[i]
            chunk = st.chunks[0]         # peeked: popped after the readback
            toks[i, :len(chunk)] = chunk
            lens[i] = len(chunk)
            temps[i] = st.req.temperature
            self.pool.ensure_writable(i, int(self._pos[i]),
                                      int(self._pos[i]) + L - 1)
        self._apply_cow()
        self._register_gemms(self.slots * L, self.slots)
        t0 = time.perf_counter()
        last_idx = np.maximum(lens - 1, 0)
        tok_np, caches = self._fns["prefill_chunk"](
            self.params, self._tensor(toks), self.caches, self._slot_ids,
            self._bt, self._tensor(lens), self._tensor(last_idx), temps)
        if self.spec is not None:
            # the draft prefills the same chunk through the same tables
            self.spec.on_prefill_chunk(self, toks, lens, last_idx)
        self.caches = caches
        self._c_chunk_steps.inc()
        now = time.perf_counter()
        self._s_chunk.append(now - t0)
        if self._tr.enabled:
            step = self.steps + self.chunk_steps
            self._tr.event("chunk_batch", step=step, ts=t0, dur=now - t0,
                           rows=len(pre))
            for i in pre:
                self._tr.event("prefill_chunk", rid=self._slots[i].req.rid,
                               slot=i, step=step, ts=t0, dur=now - t0,
                               tokens=int(lens[i]))
        for i in pre:
            st = self._slots[i]
            st.chunks.pop(0)
            self._pos[i] += int(lens[i])
            if st.chunks:
                continue
            self._c_prefills.inc()
            st.phase = "decode"
            st.t_prefill_done = now
            ent = st.ent
            if ent.t_first == 0.0:             # resumed slots keep theirs
                ent.t_first = now
            if ent.ttft_steps < 0:
                ent.ttft_steps = self.steps + self.chunk_steps
                if self._tr.enabled:
                    self._tr.event("first_token", rid=st.req.rid, slot=i,
                                   step=ent.ttft_steps, ts=now)
            # the prompt's KV is resident: content-address its full blocks
            n = int(self.pool.n_slot_blocks[i])
            self.pool.register_prefix(
                [int(t) for t in ent.full_prompt],
                [int(b) for b in self.pool.tables[i, :n]])
            st.cur_tok = int(tok_np[i])
            st.produced.append(st.cur_tok)
            if self._done(i):
                self._finish(i)

    def _decode_step(self, active: list[int]) -> None:
        """ONE batched single-token decode step over ``active``; host
        state moves only after the token readback."""
        t0 = time.perf_counter()
        self._register_gemms(self.slots, self.slots)
        toks = np.zeros((self.slots, 1), np.int32)
        adv = np.zeros(self.slots, np.int32)
        temps = np.zeros(self.slots, np.float32)
        for i in active:
            toks[i, 0] = self._slots[i].cur_tok
            temps[i] = self._slots[i].req.temperature
            adv[i] = 1
        if self.paged:
            for i in active:
                self.pool.ensure_writable(i, int(self._pos[i]),
                                          int(self._pos[i]))
            self._apply_cow()
            tok_np, caches = self._fns["decode_sample_paged"](
                self.params, self._tensor(toks), self.caches,
                self._tensor(self._pos), self._bt, self._tensor(adv), temps)
        else:
            logits, caches = N.decode_step(
                self.params, self.cfg, self._tensor(toks), self.caches,
                self._tensor(self._pos))
            tok_np = self._pick(logits, temps)
        self.caches = caches
        if self.paged:
            # the step above IS the application of the gather GEMMs
            PA.note_gather_applied(self.schedule, self.cfg,
                                   self.pool.block_size, self._prec)
            self._pos += adv
        else:
            # every slot's cursor advanced, idle ones too (they write in
            # their own stripe): the mirror follows
            self._pos += 1
        self._c_steps.inc()
        self._s_decode.append(time.perf_counter())
        if self._tr.enabled:
            self._tr.event("decode", step=self.steps + self.chunk_steps,
                           ts=t0, dur=time.perf_counter() - t0,
                           rows=len(active))
        for i in active:
            st = self._slots[i]
            st.cur_tok = int(tok_np[i])
            st.produced.append(st.cur_tok)
            if self._done(i):
                self._finish(i)

    def _note_spec_pressure(self, pressure: bool) -> None:
        """Adaptive speculation depth (``ResilienceConfig.spec_degrade``):
        halve the live depth when the pool denied an extend this step,
        and win one back after ``spec_recover_steps`` clean steps.  The
        tokens do not change (greedy acceptance does not depend on the
        depth) and the verify shape stays (slots, spec_k + 1)."""
        if not self.resilience.spec_degrade:
            return
        if pressure:
            self._spec_clean_steps = 0
            if self._spec_k_live > 1:
                self._spec_k_live = max(1, self._spec_k_live // 2)
                self._c_res_degrades.inc()
                if self._tr.enabled:
                    self._tr.event("degrade",
                                   step=self.steps + self.chunk_steps,
                                   spec_k=self._spec_k_live)
        else:
            self._spec_clean_steps += 1
            if (self._spec_k_live < self.spec_k and self._spec_clean_steps
                    >= self.resilience.spec_recover_steps):
                self._spec_clean_steps = 0
                self._spec_k_live += 1
                if self._tr.enabled:
                    self._tr.event("degrade",
                                   step=self.steps + self.chunk_steps,
                                   spec_k=self._spec_k_live)

    def _spec_step(self, active: list[int]) -> None:
        """One draft/verify round over the decoding slots: extend each
        table one span ahead (preempting a slot that cannot host even
        k = 0), fork what the span writes, propose, ONE verify call, accept
        the longest draft prefix matching the target's argmax, then roll
        the rest back (cursors, draft caches, pool blocks).  A failure
        before the readback leaves extended tables and draft cursors that
        ``_resync_slots`` rolls back."""
        L = self.spec_k + 1
        ks: dict[int, int] = {}
        run: list[int] = []
        grew = pressure = False
        for i in active:
            st = self._slots[i]
            remaining = st.req.max_new_tokens - len(st.produced)
            headroom = self.max_len - int(self._pos[i]) - 1
            k_i = max(0, min(self._spec_k_live, remaining - 1, headroom))
            nblk = int(self.pool.n_slot_blocks[i])
            while not self.pool.extend(i, int(self._pos[i]) + k_i + 1):
                pressure = True
                if k_i == 0:
                    k_i = -1
                    break
                k_i = 0
            if k_i < 0:
                self._preempt(i)
                continue
            grew |= int(self.pool.n_slot_blocks[i]) != nblk
            ks[i] = k_i
            run.append(i)
        # pressure is noted before the empty-run return: a step whose
        # every denied slot was preempted is pressure too
        self._note_spec_pressure(pressure)
        if not run:
            return
        # tables are shared with the draft: its speculative writes must
        # land in forked blocks too
        for i in run:
            self.pool.ensure_writable(i, int(self._pos[i]),
                                      int(self._pos[i]) + ks[i])
        self._apply_cow()
        if grew:
            self._bt = self._table_tensor()
        drafts = self.spec.propose(self, run, ks)
        if self.faults is not None:
            # garbage drafts cost acceptance only: verify rejects them
            drafts = {i: self.faults.corrupt_drafts(
                self.steps + self.chunk_steps, d, self.cfg.vocab)
                for i, d in drafts.items()}
        toks = np.zeros((self.slots, L), np.int32)
        lens = np.zeros(self.slots, np.int32)
        for i in run:
            d = [int(t) for t in drafts.get(i, [])][:ks[i]]
            drafts[i] = d
            toks[i, 0] = self._slots[i].cur_tok
            toks[i, 1:1 + len(d)] = d
            lens[i] = len(d) + 1
        self._register_gemms(self.slots * L, self.slots * L)
        t0 = time.perf_counter()
        tok_np, caches = self._fns["verify_chunk"](
            self.params, self._tensor(toks), self.caches, self._slot_ids,
            self._bt, self._tensor(lens))
        self.caches = caches
        self._c_steps.inc()
        self._s_decode.append(time.perf_counter())
        if self._tr.enabled:
            self._tr.event("verify", step=self.steps + self.chunk_steps,
                           ts=t0, dur=time.perf_counter() - t0,
                           rows=len(run))
        rejected = False
        for i in run:
            st = self._slots[i]
            d = drafts[i]
            emit: list[int] = []
            j = 0
            while True:
                # tok[j] is valid while inputs 0..j were right: input 0 is
                # cur_tok, input j+1 is draft j, checked before advancing
                t = int(tok_np[i, j])
                emit.append(t)
                if (t == st.req.eos or len(st.produced) + len(emit)
                        >= st.req.max_new_tokens):
                    break
                if j < len(d) and d[j] == t:
                    j += 1
                    continue
                break
            st.produced.extend(emit)
            st.cur_tok = emit[-1]
            self._pos[i] += len(emit)
            rejected |= len(emit) < int(lens[i])
            self._c_spec_emitted.inc(len(emit))
            self._c_spec_drafted.inc(len(d))
            self._c_spec_accepted.inc(len(emit) - 1)
            self._c_spec_verifies.inc()
        # rollback: cursors back to the accepted lengths (already there
        # when everything was accepted), rejected tail blocks to the pool
        if rejected:
            self.caches = N.set_slot_pos(self.caches,
                                         self._tensor(self._pos))
            self.spec.on_rollback(self, self._pos)
        for i in run:
            self.pool.truncate(i, int(self._pos[i]))
            if self._done(i):
                self._finish(i)

    def _done(self, slot: int) -> bool:
        st = self._slots[slot]
        return (st.cur_tok == st.req.eos
                or len(st.produced) >= st.req.max_new_tokens
                or self._pos[slot] >= self.max_len)

    def _finish(self, slot: int) -> None:
        st = self._slots[slot]
        ent = st.ent
        now = time.perf_counter()
        self._results.put(Result(
            rid=ent.req.rid, tokens=np.asarray(st.produced, np.int32),
            prefill_s=ent.prefill_s + (st.t_prefill_done - st.t_admit),
            decode_s=now - st.t_prefill_done,
            latency_s=now - ent.t_submit, ttft_s=ent.t_first - ent.t_submit,
            ttft_steps=max(ent.ttft_steps, 0), preemptions=ent.preemptions))
        self._c_finished.inc()
        self._c_tokens.inc(len(st.produced))
        self._h_ttft_steps.observe(max(ent.ttft_steps, 0))
        self._h_ttft_s.observe(ent.t_first - ent.t_submit)
        self._h_latency.observe(now - ent.t_submit)
        if self._tr.enabled:
            self._tr.event("finish", rid=ent.req.rid, slot=slot,
                           step=self.steps + self.chunk_steps, ts=now,
                           tokens=len(st.produced),
                           preemptions=ent.preemptions)
        self._slots[slot] = None
        if self.paged:
            # the admission prompt's full blocks stay in the prefix cache
            self.pool.release_slot(slot, prompt=[int(t) for t in
                                                 ent.full_prompt])
            self._bt = self._table_tensor()

    def _end_step(self) -> int:
        """The step's epilogue: the pool-utilisation sample, the audit
        (``audit=True``) and the tracer's counter tracks; returns the
        active-slot count."""
        active = sum(s is not None for s in self._slots)
        if self.paged:
            util = self.pool.used_blocks / (self.pool.num_blocks - 1)
            self._c_util_sum.inc(util)
            self._c_util_samples.inc()
            self._g_pool_util.set(util)
            if self._audit:
                self.pool.check(pending_op=self._audit_context())
        self._g_occupancy.set(active)
        if self._tr.enabled:
            step = self.steps + self.chunk_steps
            if self.paged:
                self._tr.counter("pool_util", util, step=step)
            self._tr.counter("batch_occupancy", active, step=step)
            self._tr.counter("pending_queue", len(self._pending), step=step)
        return active

    def _audit_context(self) -> dict:
        """The engine's half of a ``PoolAuditError`` reproducer: which
        request occupies which slot, and where it stands."""
        return {"op": "end_step", "spec": self.spec is not None,
                "slots": [None if s is None else
                          {"rid": s.req.rid, "phase": s.phase,
                           "pos": int(self._pos[i]),
                           "produced": len(s.produced),
                           "pool_blocks": int(self.pool.n_slot_blocks[i])}
                          for i, s in enumerate(self._slots)]}

    # -- reporting -------------------------------------------------------------

    def kv_bytes(self) -> dict[str, int]:
        """``allocated``: bytes of the KV leaves (pool or stripes);
        ``peak``: the high-watermark of blocks holding live data, in bytes
        (dense: the whole stripes, committed up front)."""
        alloc = N.kv_cache_bytes(self.caches)
        if not self.paged:
            return {"allocated": alloc, "peak": alloc}
        return {"allocated": alloc,
                "peak": alloc // self.pool.num_blocks * self.pool.peak_used}


class WaveEngine:
    """The seed's wave-level engine, kept as the baseline: each wave fills
    all slots, prefills once (prompts right-aligned, left-padded with
    token 0, in one dense ``prefill``; the pads are real inputs, as in
    the reference), then decodes in lockstep at the scalar position
    ``plen + step`` until the whole wave drains.  ``params`` and
    ``device`` as for ``ContinuousEngine``; ``seed`` seeds the sampler."""

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 8,
                 max_len: int = 2048, seed: int = 0,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        _check_params(params, self.device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0

    def run(self, requests: Sequence[Request]) -> list[Result]:
        """Serve all requests in waves of ``slots``."""
        out: list[Result] = []
        queue = list(requests)
        t_start = time.perf_counter()
        while queue:
            wave, queue = queue[:self.slots], queue[self.slots:]
            out.extend(self._run_wave(wave, t_start))
        return out

    def _run_wave(self, wave: Sequence[Request], t_start: float
                  ) -> list[Result]:
        B = len(wave)
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(wave):   # right-aligned: the last token is real
            toks[i, plen - len(r.prompt):] = r.prompt
        temps = np.array([r.temperature for r in wave], np.float32)
        max_new = max(r.max_new_tokens for r in wave)

        caches = N.init_caches(self.cfg, B, self.max_len, device=self.device)
        t0 = time.perf_counter()
        logits, caches = N.prefill(
            self.params, self.cfg,
            {"tokens": torch.as_tensor(toks, device=self.device)}, caches)
        if logits.is_cuda:
            torch.cuda.synchronize(logits.device)
        t1 = time.perf_counter()
        tok = _draw(logits, temps, self.generator)
        tok_np = tok.cpu().numpy()

        done = np.zeros(B, bool)
        produced: list[list[int]] = [[] for _ in range(B)]
        for step in range(max_new):
            for i, r in enumerate(wave):
                if not done[i]:
                    produced[i].append(int(tok_np[i]))
                    if (tok_np[i] == r.eos
                            or len(produced[i]) >= r.max_new_tokens):
                        done[i] = True
            if done.all():
                break
            if plen + step >= self.max_len:
                # the stripes are full: a further write would clamp onto
                # the last row, so the wave is truncated
                break
            pos = torch.tensor(plen + step, dtype=torch.int32,
                               device=self.device)
            logits, caches = N.decode_step(self.params, self.cfg,
                                           tok[:, None].to(torch.int32),
                                           caches, pos)
            self.steps += 1
            tok = _draw(logits, temps, self.generator)
            tok_np = tok.cpu().numpy()
        t2 = time.perf_counter()
        return [Result(r.rid, np.asarray(produced[i], np.int32), t1 - t0,
                       t2 - t1, latency_s=t2 - t_start, ttft_s=t1 - t_start)
                for i, r in enumerate(wave)]


#: the default engine: slot-level continuous batching
Engine = ContinuousEngine
