"""Speculative decoding: draft providers for the engine's verify step
(port of ``repro.serving.spec``).

A provider proposes up to k next tokens a slot; the target scores
``[cur_tok, draft_1 .. draft_k]`` of every slot in ONE
``network.verify_paged_chunk`` call and the engine accepts the longest
draft prefix that matches its own argmax, so the output equals greedy
decoding while a step may emit up to k + 1 tokens.  The rejected tail is
rolled back on the host: cursors with ``network.set_slot_pos``, blocks
with ``KVPool.truncate`` (spec admissions reserve their span lazily with
``KVPool.extend``).

  * :class:`NgramDraft` -- prompt lookup: the continuation that followed
    the most recent earlier occurrence of the slot's tail n-gram in its
    own history; no model, no launch.
  * :class:`ModelDraft` -- a draft model with its own paged caches,
    addressed through the SAME block tables as the target (one allocator
    for both), proposing by k + 1 batched greedy decode steps; after a
    rollback it re-proposes from the accepted position.

Recurrent (SSM) targets and drafts are refused: their state has no
truncate.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import network as N
from repro_torch.models.config import ModelConfig
from repro_torch.obs.metrics import Counter


class DraftProvider:
    """The protocol the engine drives: ``propose`` is the one required
    method; the ``on_*`` hooks mirror engine events that touch the shared
    block tables (no-ops for a provider without device state)."""

    name = "base"

    def bind(self, engine) -> None:
        """Called once at engine construction (pool and caches exist)."""

    def propose(self, engine, slots: list[int],
                ks: dict[int, int]) -> dict[int, list[int]]:
        """Up to ``ks[i]`` draft tokens for each decoding slot in
        ``slots``; fewer, or none, is legal."""
        raise NotImplementedError

    def on_prefill_chunk(self, engine, toks: np.ndarray, lens: np.ndarray,
                         last_idx: np.ndarray) -> None:
        """A target prefill-chunk batch just ran (same layout, tables)."""

    def on_reset_slot(self, engine, slot: int, pos_value: int) -> None:
        """A slot was (re-)admitted with ``pos_value`` resident tokens."""

    def on_apply_cow(self, engine, src: torch.Tensor,
                     dst: torch.Tensor) -> None:
        """Copy-on-write forks were applied to the target pool."""

    def on_rollback(self, engine, pos: np.ndarray) -> None:
        """After a verify: every slot's accepted resident length."""


class NgramDraft(DraftProvider):
    """Prompt lookup: the tokens that followed the most recent earlier
    occurrence of the slot's current tail n-gram, the longest gram
    (``n`` down to 1) first; no match proposes nothing."""

    name = "ngram"

    def __init__(self, n: int = 3, window: int = 1024):
        if n < 1:
            raise ValueError("ngram n must be >= 1")
        self.n = n
        #: history tokens searched
        self.window = window

    def propose(self, engine, slots, ks):
        out: dict[int, list[int]] = {}
        for i in slots:
            st = engine._slots[i]
            hist = ([int(t) for t in st.req.prompt]
                    + [int(t) for t in st.produced])
            out[i] = self.lookup(hist[-self.window:], ks[i])
        return out

    def lookup(self, hist: list[int], k: int) -> list[int]:
        L = len(hist)
        if k <= 0 or L < 2:
            return []
        for g in range(min(self.n, L - 1), 0, -1):
            pat = hist[L - g:]
            for idx in range(L - g - 1, -1, -1):   # most recent first
                if hist[idx:idx + g] == pat:
                    return hist[idx + g: idx + g + k]
        return []


class ModelDraft(DraftProvider):
    """Draft model over the shared block tables: its own paged caches
    (its layers, the target's pool geometry), k + 1 batched greedy decode
    steps a proposal -- the last one writes the last draft's KV, so after
    a rollback both models hold exactly the accepted tokens.  The drafts
    stay on the device between its steps; one readback a proposal."""

    name = "model"

    def __init__(self, cfg: ModelConfig, params):
        if cfg.has_recurrent_state:
            raise ValueError(
                f"draft {cfg.name} is a hybrid (SSM) arch: draft state "
                f"rolls back every verify step, and recurrent state "
                f"cannot (KVPool.truncate is attention-side only)")
        if cfg.is_encoder_only:
            raise ValueError(f"draft {cfg.name} is encoder-only")
        self.cfg = cfg
        self.params = params
        self.caches = None
        self._c_steps: Counter | None = None    # the engine's, from bind
        self._c_chunks: Counter | None = None

    @property
    def steps(self) -> int:
        """Draft decode steps (0 before ``bind``)."""
        return int(self._c_steps.value) if self._c_steps else 0

    @property
    def chunk_steps(self) -> int:
        """Draft prefill-chunk batches (0 before ``bind``)."""
        return int(self._c_chunks.value) if self._c_chunks else 0

    def bind(self, engine) -> None:
        if self.cfg.vocab != engine.cfg.vocab:
            raise ValueError(
                f"draft vocab {self.cfg.vocab} != target vocab "
                f"{engine.cfg.vocab}: drafted ids would be meaningless")
        if self.params["embed"]["table"].device.type != engine.device.type:
            raise ValueError(f"draft params live on "
                             f"{self.params['embed']['table'].device}, the "
                             f"engine runs on {engine.device}")
        self._c_steps = engine.metrics.counter(
            "spec.draft_steps", "draft-model decode steps")
        self._c_chunks = engine.metrics.counter(
            "spec.draft_chunk_steps", "draft-model prefill-chunk batches")
        self.caches = N.expand_cache_pos(
            N.init_paged_caches(self.cfg, engine.slots,
                                engine.pool.num_blocks,
                                engine.pool.block_size,
                                device=engine.device), engine.slots)

    def on_prefill_chunk(self, engine, toks, lens, last_idx) -> None:
        _, self.caches = N.prefill_paged_chunk(
            self.params, self.cfg, engine._tensor(toks), self.caches,
            engine._slot_ids, engine._bt, engine._tensor(lens),
            engine._tensor(last_idx))
        self._c_chunks.inc()

    def on_reset_slot(self, engine, slot, pos_value) -> None:
        self.caches = N.reset_slot_state(self.caches, slot, pos_value)

    def on_apply_cow(self, engine, src, dst) -> None:
        self.caches = N.copy_paged_blocks(self.caches, src, dst)

    def on_rollback(self, engine, pos) -> None:
        self.caches = N.set_slot_pos(self.caches, engine._tensor(pos))

    def propose(self, engine, slots, ks):
        out: dict[int, list[int]] = {i: [] for i in slots}
        if not slots:
            return out
        kmax = max(ks[i] for i in slots)
        S = engine.slots
        toks = np.zeros((S, 1), np.int32)
        for i in slots:
            toks[i, 0] = engine._slots[i].cur_tok
        tok = engine._tensor(toks)
        pos = engine._pos.copy()
        drafts = []
        # k_i + 1 steps a slot: the last writes the last draft's KV; rows
        # past their budget ride along with adv == 0
        for j in range(kmax + 1):
            adv = np.zeros(S, np.int32)
            for i in slots:
                if j <= ks[i]:
                    adv[i] = 1
            logits, self.caches = N.decode_step(
                self.params, self.cfg, tok, self.caches,
                engine._tensor(pos), engine._bt, engine._tensor(adv))
            self._c_steps.inc()
            pos += adv
            if j < kmax:
                tok = logits.argmax(dim=-1).to(torch.int32)[:, None]
                drafts.append(tok)
        if drafts:
            got = torch.cat(drafts, dim=1).cpu().numpy()
            for i in slots:
                out[i] = [int(t) for t in got[i, :ks[i]]]
        return out


def make_provider(spec) -> DraftProvider:
    """The engine's ``spec=``: a provider passes through; ``"ngram"``
    builds the model-free default.  A draft model needs its config and
    weights: construct :class:`ModelDraft`."""
    if isinstance(spec, DraftProvider):
        return spec
    if spec == "ngram":
        return NgramDraft()
    raise ValueError(
        f"unknown spec provider {spec!r}: pass 'ngram' or a DraftProvider "
        f"instance (e.g. spec.ModelDraft(draft_cfg, draft_params))")
