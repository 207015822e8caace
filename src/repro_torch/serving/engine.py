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
place.  The async API, hard deadlines and load shedding, the tracer and
the resilience layer are later slices (ROADMAP.md).
"""

from __future__ import annotations

import collections
import dataclasses
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
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.quant.policy import (QuantPolicy, choose_precision,
                                      serving_quant_params)
from repro_torch.serving.kv_pool import KVPool, blocks_for
from repro_torch.serving.policy import (PendingView, SchedulerPolicy,
                                        SlotView, make_policy)
from repro_torch.serving.sampling import sample
from repro_torch.serving.spec import DraftProvider, make_provider


#: clean spec steps after which a degraded speculation depth grows by one
#: (the reference's ``ResilienceConfig.spec_recover_steps`` default)
SPEC_RECOVER_STEPS = 8


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
    status: str = "ok"


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
    ``DraftProvider``, with ``spec_k`` drafts a step at most
    (``spec_degrade`` halves the live depth when the pool denies an
    extend and wins a step of it back after ``SPEC_RECOVER_STEPS`` clean
    steps).  ``audit=True`` checks the pool invariants after every
    step.  The pool's arguments and ``prefill_chunk`` are the paged
    path's; the dense path pads each prompt to the next of ``buckets``
    (16, 32, ... below max_len, then max_len).  Speculation and the
    policies that reserve pool blocks need the pool and are refused with
    ``paged=False``."""

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 8,
                 max_len: int = 2048, seed: int = 0, block_size: int = 16,
                 kv_blocks: int | None = None,
                 prefill_chunk: int | None = None, paged: bool = True,
                 policy: str | SchedulerPolicy = "fifo",
                 spec: str | DraftProvider | None = None, spec_k: int = 4,
                 spec_degrade: bool = False, audit: bool = False,
                 quant_policy: QuantPolicy | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if cfg.is_encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: no decode serving")
        _check_params(params, self.device)
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
        self._spec_k_live = spec_k
        self._spec_degrade = spec_degrade
        self._spec_clean_steps = 0
        self.cfg = cfg
        if cfg.quant_serving and cfg.has_recurrent_state:
            raise NotImplementedError(
                f"{cfg.name}: quantized serving of SSM configs is not "
                f"ported yet (ROADMAP.md, Queue 1 item 7)")
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
        self.metrics = m = MetricsRegistry()
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
        self._results: collections.deque[Result] = collections.deque()

        self._c_steps = m.counter("engine.steps",
                                  "decode/verify dispatches executed")
        self._c_chunk_steps = m.counter(
            "engine.chunk_steps", "prefill-chunk batches executed")
        self._c_prefills = m.counter("engine.prefills",
                                     "prompts fully prefilled")
        self._c_admissions = m.counter(
            "engine.admissions", "slot admissions (fresh + resumed)")
        self._c_resumes = m.counter(
            "engine.resumes", "re-admissions of preempted requests")
        self._c_preemptions = m.counter("engine.preemptions",
                                        "victim evictions")
        self._c_admit_fail = m.counter(
            "engine.admit_failures", "admissions the pool denied")
        # one pool-utilisation sample (used / usable blocks) a step
        self._c_util_sum = m.counter("engine.pool_util_sum",
                                     "sum of per-step pool-util samples")
        self._c_util_samples = m.counter("engine.pool_util_samples",
                                         "pool-util samples taken")
        self._g_pool_util = m.gauge("engine.pool_util",
                                    "pool utilisation at the last step")
        self._c_spec_emitted = m.counter("spec.tokens_emitted",
                                         "tokens emitted by verify steps")
        self._c_spec_drafted = m.counter("spec.drafted",
                                         "draft tokens proposed")
        self._c_spec_accepted = m.counter("spec.accepted",
                                          "draft tokens accepted")
        self._c_spec_verifies = m.counter("spec.slot_verifies",
                                          "(slot, verify-step) events")
        self._c_spec_degrades = m.counter("resilience.spec_degrades",
                                          "spec_k halvings under pressure")

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
        shapes = [(m_tokens, cfg.n_heads * cfg.hd, d),
                  (m_tokens, cfg.n_kv_heads * cfg.hd, d),
                  (m_tokens, d, cfg.n_heads * cfg.hd),
                  (m_tokens, cfg.d_ff, d), (m_tokens, d, cfg.d_ff),
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
        """Queue a request; raises at once on one that can never be
        served."""
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
        self._pending.append(_Pending(req=req, t_submit=time.perf_counter()))

    def run(self, requests: Sequence[Request]) -> list[Result]:
        """Serve all requests; results in COMPLETION order."""
        for r in requests:
            self.submit(r)
        out: list[Result] = []
        while len(out) < len(requests):
            self.step()
            while self._results:
                out.append(self._results.popleft())
        return out

    def drain_results(self) -> list[Result]:
        """The results finished since the last call."""
        out = list(self._results)
        self._results.clear()
        return out

    # -- the engine step -------------------------------------------------------

    def step(self) -> int:
        """Admit what the policy picks, preempt if it names a victim, run
        at most one prefill-chunk batch and one batched decode (or verify)
        step, then refill.  Returns the number of active slots."""
        self._admit()
        if self.paged:
            self._maybe_preempt()
            pre = [i for i, s in enumerate(self._slots)
                   if s is not None and s.phase == "prefill"]
            if pre:
                self._prefill_chunk_step(pre)
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.phase == "decode"]
        if active:
            if self.spec is not None:
                self._spec_step(active)
            else:
                self._decode_step(active)
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
        cannot host goes back to its place in the queue."""
        while self._pending:
            slot = next((i for i, s in enumerate(self._slots) if s is None),
                        None)
            if slot is None:
                return
            views, now = self._pending_views()
            idx = self.policy.select_admission(views, now)
            if idx is None:
                return                      # the policy holds the queue
            ent = self._pending[idx]
            del self._pending[idx]
            if not self.paged:
                self._admit_dense(slot, ent)
            elif not self._admit_one(slot, ent):
                self._c_admit_fail.inc()        # retried next step
                self._pending.insert(idx, ent)
                return

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
        self._bt = self._table_tensor()
        self.caches = N.reset_slot_state(self.caches, slot,
                                         plan.shared_tokens)
        if self.spec is not None:
            self.spec.on_reset_slot(self, slot, plan.shared_tokens)
        self._pos[slot] = plan.shared_tokens
        rest = np.asarray(ent.full_prompt[plan.shared_tokens:], np.int32)
        L = self.prefill_chunk
        self._slots[slot] = _Slot(
            ent=ent, produced=list(ent.resume_tokens), cur_tok=-1,
            t_admit=time.perf_counter(),
            chunks=[rest[j:j + L] for j in range(0, len(rest), L)])
        self._c_admissions.inc()
        if ent.resume_tokens:
            self._c_resumes.inc()
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
        # a prompt filling the stripe has no decode headroom: the next
        # write would clamp onto its last token, so it ends here
        if self._done(slot):
            self._finish(slot)

    def _maybe_preempt(self) -> None:
        """Ask the policy for a victim (at most one a step), evict it and
        admit again, so the freed slot and blocks serve the request at
        risk in this step."""
        if not self.policy.preempts or not self._pending:
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
        ent = st.ent
        ent.full_prompt = np.asarray(full_seq, np.int32)
        ent.resume_tokens = list(st.produced)
        ent.preemptions += 1
        ent.prefill_s += st.t_prefill_done - st.t_admit
        self._pending.append(ent)

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
        along masked (length 0)."""
        L = self.prefill_chunk
        toks = np.zeros((self.slots, L), np.int32)
        lens = np.zeros(self.slots, np.int32)
        temps = np.zeros(self.slots, np.float32)
        for i in pre:
            st = self._slots[i]
            chunk = st.chunks[0]
            toks[i, :len(chunk)] = chunk
            lens[i] = len(chunk)
            temps[i] = st.req.temperature
            self.pool.ensure_writable(i, int(self._pos[i]),
                                      int(self._pos[i]) + L - 1)
        self._apply_cow()
        self._register_gemms(self.slots * L, self.slots)
        last_idx = np.maximum(lens - 1, 0)
        logits, self.caches = N.prefill_paged_chunk(
            self.params, self.cfg, self._tensor(toks), self.caches,
            self._slot_ids, self._bt, self._tensor(lens),
            self._tensor(last_idx))
        if self.spec is not None:
            # the draft prefills the same chunk through the same tables
            self.spec.on_prefill_chunk(self, toks, lens, last_idx)
        tok_np = self._pick(logits, temps)
        self._c_chunk_steps.inc()
        now = time.perf_counter()
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
        """ONE batched single-token decode step over ``active``."""
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
            logits, self.caches = N.decode_step(
                self.params, self.cfg, self._tensor(toks), self.caches,
                self._tensor(self._pos), self._bt, self._tensor(adv))
            # the step above IS the application of the gather GEMMs
            PA.note_gather_applied(self.schedule, self.cfg,
                                   self.pool.block_size, self._prec)
            self._pos += adv
        else:
            logits, self.caches = N.decode_step(
                self.params, self.cfg, self._tensor(toks), self.caches,
                self._tensor(self._pos))
            # every slot's cursor advanced, idle ones too (they write in
            # their own stripe): the mirror follows
            self._pos += 1
        self._c_steps.inc()
        tok_np = self._pick(logits, temps)
        for i in active:
            st = self._slots[i]
            st.cur_tok = int(tok_np[i])
            st.produced.append(st.cur_tok)
            if self._done(i):
                self._finish(i)

    def _note_spec_pressure(self, pressure: bool) -> None:
        """Adaptive speculation depth (``spec_degrade``): halve the live
        depth when the pool denied an extend this step, and win one back
        after ``SPEC_RECOVER_STEPS`` clean steps.  The tokens do not
        change (greedy acceptance does not depend on the depth) and the
        verify shape stays (slots, spec_k + 1)."""
        if not self._spec_degrade:
            return
        if pressure:
            self._spec_clean_steps = 0
            if self._spec_k_live > 1:
                self._spec_k_live = max(1, self._spec_k_live // 2)
                self._c_spec_degrades.inc()
        else:
            self._spec_clean_steps += 1
            if (self._spec_k_live < self.spec_k and self._spec_clean_steps
                    >= SPEC_RECOVER_STEPS):
                self._spec_clean_steps = 0
                self._spec_k_live += 1

    def _spec_step(self, active: list[int]) -> None:
        """One draft/verify round over the decoding slots: extend each
        table one span ahead (preempting a slot that cannot host even
        k = 0), fork what the span writes, propose, ONE verify call, accept
        the longest draft prefix matching the target's argmax, then roll
        the rest back (cursors, draft caches, pool blocks)."""
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
        toks = np.zeros((self.slots, L), np.int32)
        lens = np.zeros(self.slots, np.int32)
        for i in run:
            d = [int(t) for t in drafts.get(i, [])][:ks[i]]
            drafts[i] = d
            toks[i, 0] = self._slots[i].cur_tok
            toks[i, 1:1 + len(d)] = d
            lens[i] = len(d) + 1
        self._register_gemms(self.slots * L, self.slots * L)
        logits, self.caches = N.verify_paged_chunk(
            self.params, self.cfg, self._tensor(toks), self.caches,
            self._slot_ids, self._bt, self._tensor(lens))
        tok_np = logits.argmax(dim=-1).cpu().numpy()
        self._c_steps.inc()
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
        self._results.append(Result(
            rid=ent.req.rid, tokens=np.asarray(st.produced, np.int32),
            prefill_s=ent.prefill_s + (st.t_prefill_done - st.t_admit),
            decode_s=now - st.t_prefill_done,
            latency_s=now - ent.t_submit, ttft_s=ent.t_first - ent.t_submit,
            ttft_steps=max(ent.ttft_steps, 0), preemptions=ent.preemptions))
        self._slots[slot] = None
        if self.paged:
            # the admission prompt's full blocks stay in the prefix cache
            self.pool.release_slot(slot, prompt=[int(t) for t in
                                                 ent.full_prompt])
            self._bt = self._table_tensor()

    def _end_step(self) -> int:
        if not self.paged:
            return sum(s is not None for s in self._slots)
        util = self.pool.used_blocks / (self.pool.num_blocks - 1)
        self._c_util_sum.inc(util)
        self._c_util_samples.inc()
        self._g_pool_util.set(util)
        if self._audit:
            self.pool.check(pending_op={
                "op": "end_step", "spec": self.spec is not None,
                "slots": [None if s is None else
                          {"rid": s.req.rid, "phase": s.phase,
                           "pos": int(self._pos[i]),
                           "produced": len(s.produced),
                           "pool_blocks": int(self.pool.n_slot_blocks[i])}
                          for i, s in enumerate(self._slots)]})
        return sum(s is not None for s in self._slots)

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
