"""Paged continuous-batching serving engine (port of the paged, greedy,
``fifo`` path of ``repro.serving.engine.ContinuousEngine``).

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
  * **ScheduleCache.**  The step's projection GEMMs (and the paged-decode
    gather GEMMs) are resolved through the paper-§5 schedule cache at
    construction, so the steady state is pure cache hits; with
    ``gemm_backend="scheduled"`` the engine adopts the per-config
    backend's cache, which the model's mpgemm launches consult.
  * **Quantized serving.**  Under ``cfg.quant_serving`` the weight tree is
    rewritten to int8 QuantTensors at construction (``quant_policy``; the
    tied embedding is never quantized) and, where ``cfg.quant_kv``, the
    KV pool holds int8 blocks with per-position scale sidecars.  Each
    GEMM shape is also resolved under INT8 and under the precision the
    §5 explorer picks (``precision_plan``), so a quantized run is pure
    cache hits too.

The reference's ten jitted programs become plain calls of the
``models.network`` serving functions; the pools are updated in place.
Admission is in arrival order and decoding is greedy (argmax on the
card).  Sampling, the dense engine, other admission policies,
speculation and the resilience layer are later slices (ROADMAP.md).
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


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0    # 0 => greedy (the only mode ported)
    eos: int = 2


@dataclasses.dataclass
class Result:
    rid: int
    tokens: np.ndarray
    prefill_s: float
    decode_s: float
    latency_s: float = 0.0      # submit -> finish
    ttft_s: float = 0.0         # submit -> first token
    status: str = "ok"


@dataclasses.dataclass
class _Slot:
    """Host-side state of one in-flight request."""

    req: Request
    produced: list[int]
    cur_tok: int
    t_submit: float
    t_admit: float
    t_prefill_done: float = 0.0
    t_first: float = 0.0
    phase: str = "prefill"      # "prefill" while chunks remain, then "decode"
    chunks: list[np.ndarray] = dataclasses.field(default_factory=list)


class ContinuousEngine:
    """Slot-level continuous-batching engine over the paged KV pool.

    ``params`` must live on ``device`` (CUDA unless the caller names
    another; without a card and without ``device="cpu"`` construction
    raises).  ``audit=True`` checks the pool invariants after every
    step."""

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 8,
                 max_len: int = 2048, block_size: int = 16,
                 kv_blocks: int | None = None,
                 prefill_chunk: int | None = None, audit: bool = False,
                 quant_policy: QuantPolicy | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if cfg.is_encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: no decode serving")
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine "
                             f"runs on {self.device}")
        self.cfg = cfg
        if cfg.quant_serving and cfg.has_recurrent_state:
            raise NotImplementedError(
                f"{cfg.name}: quantized serving of SSM configs is not "
                f"ported yet (ROADMAP.md, Queue 1 item 8)")
        if cfg.quant_serving:
            # idempotent: an already-quantized tree passes through
            params = serving_quant_params(cfg, params, quant_policy)
        self.params = params
        self.slots = slots
        self.max_len = max_len
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

        self.prefill_chunk = min(prefill_chunk or 32, max_len)
        per_slot = blocks_for(max_len, block_size)
        if kv_blocks is None:
            # ~3/4 of the dense ceiling (the reference's default)
            kv_blocks = max(per_slot + 1, 1 + (3 * slots * per_slot + 3) // 4)
        if kv_blocks < per_slot + 1:
            raise ValueError(f"kv_blocks {kv_blocks} cannot host one "
                             f"full-window request ({per_slot} blocks of "
                             f"{block_size})")
        # prefix sharing skips the shared prefill; recurrent (SSM) state
        # cannot be rebuilt from shared KV blocks, so it would drop the
        # prefix from the recurrence: off for such configs
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
        self._slots: list[_Slot | None] = [None] * slots
        self._pos = np.zeros(slots, np.int32)   # mirror of the cursors
        self._pending: collections.deque[tuple[Request, float]] = (
            collections.deque())
        self._results: collections.deque[Result] = collections.deque()

        self._c_steps = m.counter("engine.steps", "decode steps executed")
        self._c_chunk_steps = m.counter(
            "engine.chunk_steps", "prefill-chunk batches executed")

        # pre-resolve the steady-state shapes: decode (M = slots), the
        # chunk batch (M = slots * chunk) and the gather GEMMs, so the
        # serving hot path never explores
        self._register_gemms(slots, slots)
        self._register_gemms(slots * self.prefill_chunk, slots)
        for M, Nn, K in PA.gather_gemm_shapes(cfg, block_size):
            self.schedule.resolve(M, Nn, K, self._prec)

    @property
    def steps(self) -> int:
        return int(self._c_steps.value)

    @property
    def chunk_steps(self) -> int:
        return int(self._c_chunk_steps.value)

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
        if req.temperature > 0:
            raise ValueError("sampled decoding (temperature > 0) is not "
                             "ported yet: submit greedy requests "
                             "(temperature=0)")
        self._pending.append((req, time.perf_counter()))

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

    # -- the engine step -------------------------------------------------------

    def step(self) -> int:
        """Admit, run at most one prefill-chunk batch and one batched decode
        step, then refill.  Returns the number of active slots."""
        self._admit()
        pre = [i for i, s in enumerate(self._slots)
               if s is not None and s.phase == "prefill"]
        if pre:
            self._prefill_chunk_step(pre)
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.phase == "decode"]
        if active:
            self._decode_step(active)
            self._admit()
        return self._end_step()

    def _admit(self) -> None:
        """FIFO admission into free slots; a request the pool cannot host
        stays at the head of the queue."""
        while self._pending:
            slot = next((i for i, s in enumerate(self._slots) if s is None),
                        None)
            if slot is None or not self._admit_one(slot,
                                                   *self._pending[0]):
                return
            self._pending.popleft()

    def _admit_one(self, slot: int, req: Request, t_submit: float) -> bool:
        """Reserve blocks (a shared prefix is mapped in and its prefill
        skipped) and queue the rest of the prompt as chunks."""
        prompt = np.asarray(req.prompt, np.int32)
        plan = self.pool.admit(slot, [int(t) for t in prompt],
                               req.max_new_tokens)
        if plan is None:
            return False
        self._bt = self._table_tensor()
        self.caches = N.reset_slot_state(self.caches, slot,
                                         plan.shared_tokens)
        self._pos[slot] = plan.shared_tokens
        rest = prompt[plan.shared_tokens:]
        L = self.prefill_chunk
        self._slots[slot] = _Slot(
            req=req, produced=[], cur_tok=-1, t_submit=t_submit,
            t_admit=time.perf_counter(),
            chunks=[rest[j:j + L] for j in range(0, len(rest), L)])
        return True

    def _apply_cow(self) -> None:
        """Run pending copy-on-write forks on the device pools."""
        copies = self.pool.take_copies()
        if copies:
            src = torch.tensor([c[0] for c in copies], device=self.device)
            dst = torch.tensor([c[1] for c in copies], device=self.device)
            self.caches = N.copy_paged_blocks(self.caches, src, dst)
            self._bt = self._table_tensor()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _prefill_chunk_step(self, pre: list[int]) -> None:
        """One chunk for EVERY admitting slot in one call; other rows ride
        along masked (length 0)."""
        L = self.prefill_chunk
        toks = np.zeros((self.slots, L), np.int32)
        lens = np.zeros(self.slots, np.int32)
        for i in pre:
            chunk = self._slots[i].chunks[0]
            toks[i, :len(chunk)] = chunk
            lens[i] = len(chunk)
            self.pool.ensure_writable(i, int(self._pos[i]),
                                      int(self._pos[i]) + L - 1)
        self._apply_cow()
        self._register_gemms(self.slots * L, self.slots)
        last_idx = np.maximum(lens - 1, 0)
        logits, self.caches = N.prefill_paged_chunk(
            self.params, self.cfg, self._tensor(toks), self.caches,
            self._slot_ids, self._bt, self._tensor(lens),
            self._tensor(last_idx))
        tok_np = logits.argmax(dim=-1).cpu().numpy()
        self._c_chunk_steps.inc()
        now = time.perf_counter()
        for i in pre:
            st = self._slots[i]
            st.chunks.pop(0)
            self._pos[i] += int(lens[i])
            if st.chunks:
                continue
            st.phase = "decode"
            st.t_prefill_done = st.t_first = now
            # the prompt's KV is resident: content-address its full blocks
            n = int(self.pool.n_slot_blocks[i])
            self.pool.register_prefix(
                [int(t) for t in st.req.prompt],
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
        for i in active:
            toks[i, 0] = self._slots[i].cur_tok
            adv[i] = 1
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
        self._c_steps.inc()
        tok_np = logits.argmax(dim=-1).cpu().numpy()
        for i in active:
            st = self._slots[i]
            st.cur_tok = int(tok_np[i])
            st.produced.append(st.cur_tok)
            if self._done(i):
                self._finish(i)

    def _done(self, slot: int) -> bool:
        st = self._slots[slot]
        return (st.cur_tok == st.req.eos
                or len(st.produced) >= st.req.max_new_tokens
                or self._pos[slot] >= self.max_len)

    def _finish(self, slot: int) -> None:
        st = self._slots[slot]
        now = time.perf_counter()
        self._results.append(Result(
            rid=st.req.rid, tokens=np.asarray(st.produced, np.int32),
            prefill_s=st.t_prefill_done - st.t_admit,
            decode_s=now - st.t_prefill_done,
            latency_s=now - st.t_submit, ttft_s=st.t_first - st.t_submit))
        self._slots[slot] = None
        # full prompt blocks stay content-addressed in the prefix cache
        self.pool.release_slot(slot, prompt=[int(t) for t in st.req.prompt])
        self._bt = self._table_tensor()

    def _end_step(self) -> int:
        if self._audit:
            self.pool.check(pending_op={
                "op": "end_step",
                "slots": [None if s is None else
                          {"rid": s.req.rid, "phase": s.phase,
                           "pos": int(self._pos[i])}
                          for i, s in enumerate(self._slots)]})
        return sum(s is not None for s in self._slots)

    # -- reporting -------------------------------------------------------------

    def kv_bytes(self) -> dict[str, int]:
        """``allocated``: bytes of the pool leaves; ``peak``: the
        high-watermark of blocks holding live data, in bytes."""
        alloc = N.kv_cache_bytes(self.caches)
        return {"allocated": alloc,
                "peak": alloc // self.pool.num_blocks * self.pool.peak_used}
