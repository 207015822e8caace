"""Block-paged KV pool: allocator, block tables, prefix sharing, COW.

Host-side bookkeeping (numpy only) of the paged KV cache -- a copy of
``repro.serving.kv_pool``.  Device
storage keeps every attention layer's K/V as one pool tensor
``(num_blocks, block_size, n_kv_heads, head_dim)``; a slot's logical
sequence is scattered across pool blocks named by its row of

    tables : int32 (slots, blocks_per_slot)

so token ``p`` of slot ``s`` lives at flat pool index
``tables[s, p // block_size] * block_size + p % block_size``.

Invariants:

  * **Block 0 is the null/trash block**: never handed out; unallocated
    table entries are 0 and out-of-range writes land there.  Reads are
    masked by each slot's validity length.
  * **Ref counts**: ``ref[b]`` counts the slots mapping ``b``, plus one if
    the prefix cache holds it, plus one per pending COW copy reading it.
    A block returns to the free list only at ref == 0.
  * **Prefix sharing**: full prompt blocks are content-addressed by their
    whole chained prefix; an admission maps every cached hit into the new
    slot and skips its prefill.
  * **Copy-on-write**: writes touch only blocks with ref == 1;
    ``ensure_writable`` forks a shared block and queues the (src, dst)
    device copy for the engine.
  * **Eviction**: when a reservation cannot be met, least-recently-used
    cached blocks nobody else maps are evicted; if that still falls short
    the reservation returns None and the engine backs off.
  * **Lazy growth and rollback** (speculative decoding): ``extend`` grows
    a slot's table on demand; ``truncate`` drops the table past the
    accepted tokens, freeing exclusively-owned tail blocks, unpinning
    shared ones and scrubbing pending copies into them.  Entries past a
    slot's ``n_slot_blocks`` are always the null block.
  * **Probes** (scheduling policies): ``probe`` answers whether an
    admission would fit now without changing anything; ``evictable_cached``
    and ``reclaimable_blocks`` count what eviction and a release would
    return.
  * **Quantized blocks** (``quantized=True``, for ``cfg.quant_kv``): the
    device blocks are int8 with per-position scale sidecars, and
    ``scale_written[b]`` records which blocks own live dequant state.
    Mapped, cached and pending blocks must; a freed block must not (a
    stale flag would let a re-allocation dequantize a previous owner's
    scales).  COW destinations inherit the source's flag; the flag
    clears when the ref count reaches 0.
"""

from __future__ import annotations

import collections
import dataclasses
from collections.abc import Sequence

import numpy as np

from repro_torch.obs.metrics import NULL_METRIC, MetricsRegistry

#: the reserved null/trash block id
NULL_BLOCK = 0


class PoolAuditError(AssertionError):
    """A pool invariant audit failed; ``report`` carries the violations,
    the serialized pool state and the operation in flight."""

    def __init__(self, violations: Sequence[str], pool_state: dict,
                 pending_op: dict | None = None):
        self.violations = list(violations)
        self.report = {"violations": self.violations, "pool": pool_state,
                       "pending_op": pending_op}
        lines = "\n  ".join(self.violations)
        op = f"\nduring op: {pending_op!r}" if pending_op else ""
        super().__init__(
            f"KV pool audit failed ({len(self.violations)} violation(s)):"
            f"\n  {lines}{op}\nreproducer: {self.report!r}")


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Number of blocks covering ``n_tokens`` positions."""
    return -(-max(0, int(n_tokens)) // block_size)


def _hash_to_json(h: tuple) -> list:
    return [_hash_to_json(x) if isinstance(x, tuple) else int(x) for x in h]


def _hash_from_json(v: list) -> tuple:
    """Inverse of :func:`_hash_to_json` (lists back to nested tuples)."""
    return tuple(_hash_from_json(x) if isinstance(x, list) else int(x)
                 for x in v)


@dataclasses.dataclass
class AdmitPlan:
    """Result of a successful admission reservation."""

    slot: int
    shared_tokens: int          # prefix length already resident
    shared_blocks: tuple[int, ...]
    new_blocks: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ProbeReport:
    """Whether an admission would fit right now (:meth:`KVPool.probe`):
    ``shared`` blocks come from the prefix cache, ``need_new`` must be
    allocated from the free list or from the cached blocks ``reserve``
    may evict (those the match itself would pin excluded).  A True
    ``fits_now`` means an ``admit`` straight after it succeeds."""

    total: int                  # blocks the reservation spans
    shared: int                 # covered by cached prefix blocks
    need_new: int               # fresh blocks to allocate
    free: int                   # free-list size at probe time
    evictable: int              # cached blocks reserve() could evict

    @property
    def fits_now(self) -> bool:
        return self.need_new <= self.free + self.evictable


class KVPool:
    """Host-side bookkeeping for the paged KV cache (see module docstring).
    It never touches device memory: it hands the engine block ids, table
    rows and pending (src, dst) copies."""

    _m_shared = _m_cow = _m_evict = _m_backoff = NULL_METRIC
    _m_peak = _m_used = NULL_METRIC

    def __init__(self, num_blocks: int, block_size: int, *, slots: int,
                 max_len: int, share_prefixes: bool = True,
                 quantized: bool = False,
                 metrics: MetricsRegistry | None = None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        if block_size < 1:
            raise ValueError("block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.slots = slots
        self.max_len = max_len
        self.blocks_per_slot = blocks_for(max_len, block_size)
        self.share_prefixes = share_prefixes
        self.quantized = quantized
        self.scale_written = np.zeros(num_blocks, bool)
        self._free: collections.deque[int] = collections.deque(
            range(1, num_blocks))
        self.ref = np.zeros(num_blocks, np.int32)
        self.ref[NULL_BLOCK] = 1                       # pinned forever
        self.tables = np.full((slots, self.blocks_per_slot), NULL_BLOCK,
                              np.int32)
        self.n_slot_blocks = np.zeros(slots, np.int32)
        # prefix cache: chained key -> block id, LRU-ordered for eviction
        self._prefix: collections.OrderedDict[tuple, int] = (
            collections.OrderedDict())
        self._hash_of: dict[int, tuple] = {}
        #: (src, dst) copies the engine must apply on-device (COW forks)
        self.pending_copies: list[tuple[int, int]] = []
        self.peak_used = 0
        self.shared_token_hits = 0
        self.cow_forks = 0
        self.evictions = 0
        self.backoffs = 0
        if metrics is not None:
            self.bind_metrics(metrics)

    def bind_metrics(self, metrics: MetricsRegistry) -> None:
        """Mirror pool telemetry into ``kv_pool.*`` registry metrics."""
        self._m_shared = metrics.counter(
            "kv_pool.shared_token_hits",
            "prompt tokens skip-prefilled via the prefix cache")
        self._m_cow = metrics.counter(
            "kv_pool.cow_forks", "copy-on-write block forks")
        self._m_evict = metrics.counter(
            "kv_pool.evictions", "cached prefix blocks evicted")
        self._m_backoff = metrics.counter(
            "kv_pool.backoffs", "reservations denied (pool exhausted)")
        self._m_peak = metrics.gauge(
            "kv_pool.peak_used_blocks", "high-watermark of used blocks")
        self._m_used = metrics.gauge(
            "kv_pool.used_blocks", "blocks currently in use")

    # -- accounting ----------------------------------------------------------

    @property
    def used_blocks(self) -> int:
        """Blocks out of the free list (excluding the null block)."""
        return self.num_blocks - 1 - len(self._free)

    def _note_usage(self) -> None:
        self.peak_used = max(self.peak_used, self.used_blocks)
        self._m_peak.set(self.peak_used)
        self._m_used.set(self.used_blocks)

    # -- raw allocation ------------------------------------------------------

    def _alloc_one(self) -> int | None:
        if not self._free:
            return None
        bid = self._free.popleft()
        assert self.ref[bid] == 0, (bid, self.ref[bid])
        self.ref[bid] = 1
        self._note_usage()
        return bid

    def _release_one(self, bid: int) -> None:
        if bid == NULL_BLOCK:
            return
        assert self.ref[bid] > 0, bid
        self.ref[bid] -= 1
        if self.ref[bid] == 0:
            assert bid not in self._hash_of, bid
            # the dequant state dies with the last ref
            self.scale_written[bid] = False
            self._free.append(bid)

    def _mark_written(self, bids) -> None:
        """Record live scale sidecars for mapped blocks (quantized pools
        only: an fp pool's flags stay all False)."""
        if not self.quantized:
            return
        for bid in bids:
            if bid != NULL_BLOCK:
                self.scale_written[int(bid)] = True

    def _evict_cached(self, need: int) -> None:
        """Unregister LRU prefix blocks nobody else maps until ``need``
        free blocks exist (or the cache is exhausted)."""
        if need <= len(self._free):
            return
        for h in list(self._prefix):
            bid = self._prefix[h]
            if self.ref[bid] == 1:          # only the map holds it
                del self._prefix[h]
                del self._hash_of[bid]
                self._release_one(bid)
                self.evictions += 1
                self._m_evict.inc()
                if len(self._free) >= need:
                    return

    def reserve(self, n: int) -> list[int] | None:
        """Allocate ``n`` blocks atomically (evicting cached prefix blocks
        if needed); None and a recorded backoff when the pool cannot."""
        self._evict_cached(n)
        if len(self._free) < n:
            self.backoffs += 1
            self._m_backoff.inc()
            return None
        return [self._alloc_one() for _ in range(n)]

    # -- prefix sharing ------------------------------------------------------

    @staticmethod
    def _chain_hashes(tokens: Sequence[int], block_size: int,
                      n_blocks: int) -> list[tuple]:
        """Chained content keys, one per full block: block j's key is
        (parent key, block-j tokens) -- the full chain, so two prefixes
        can never alias a block."""
        hs: list[tuple] = []
        h: tuple = ()
        toks = [int(t) for t in tokens[:n_blocks * block_size]]
        for j in range(n_blocks):
            h = (h, tuple(toks[j * block_size:(j + 1) * block_size]))
            hs.append(h)
        return hs

    def match_prefix(self, prompt: Sequence[int]) -> list[int]:
        """Longest run of cached full prompt blocks, each ref'd for the
        caller.  The last prompt token is never shared: its logits seed
        decode."""
        if not self.share_prefixes:
            return []
        nfull = (len(prompt) - 1) // self.block_size
        out: list[int] = []
        for h in self._chain_hashes(prompt, self.block_size, nfull):
            bid = self._prefix.get(h)
            if bid is None:
                break
            self._prefix.move_to_end(h)                # LRU touch
            self.ref[bid] += 1
            out.append(bid)
        return out

    def register_prefix(self, prompt: Sequence[int],
                        blocks: Sequence[int]) -> None:
        """Content-address the prompt's full blocks; a newly registered
        block gains the map's pinning ref."""
        if not self.share_prefixes:
            return
        nfull = min((len(prompt) - 1) // self.block_size, len(blocks))
        for j, h in enumerate(self._chain_hashes(prompt, self.block_size,
                                                 nfull)):
            bid = int(blocks[j])
            if h in self._prefix or bid in self._hash_of:
                continue
            self._prefix[h] = bid
            self._hash_of[bid] = h
            self.ref[bid] += 1

    # -- probes and reclaim accounting ---------------------------------------

    def evictable_cached(self) -> int:
        """Cached prefix blocks ``reserve`` could evict now (the map's pin
        is their only ref).  O(cached blocks): a caller probing a whole
        queue computes it once and passes it to :meth:`probe`."""
        return sum(1 for bid in self._hash_of if self.ref[bid] == 1)

    def probe(self, prompt: Sequence[int], max_new_tokens: int,
              evictable_hint: int | None = None) -> ProbeReport:
        """Would ``admit(prompt, max_new_tokens)`` succeed now?  Changes
        nothing: no ref taken, no LRU touch, no backoff counted."""
        plen = len(prompt)
        total = min(blocks_for(plen + max_new_tokens, self.block_size),
                    self.blocks_per_slot)
        matched: list[int] = []
        if self.share_prefixes and plen > 0:
            nfull = (plen - 1) // self.block_size
            for h in self._chain_hashes(prompt, self.block_size, nfull):
                bid = self._prefix.get(h)
                if bid is None:
                    break
                matched.append(bid)
        matched = matched[:total]
        # admit() pins the matched blocks before it reserves, so they are
        # not up for eviction in the reservation being probed
        if evictable_hint is None:
            evictable_hint = self.evictable_cached()
        evictable = evictable_hint - sum(1 for bid in matched
                                         if self.ref[bid] == 1)
        return ProbeReport(total=total, shared=len(matched),
                           need_new=total - len(matched),
                           free=len(self._free), evictable=evictable)

    def reclaimable_blocks(self, slot: int) -> int:
        """Blocks that return to the free list outright if the slot is
        released: its exclusively-owned entries (ref == 1).  Blocks
        another slot or the prefix cache holds stay with them."""
        n = int(self.n_slot_blocks[slot])
        return sum(1 for b in self.tables[slot, :n]
                   if self.ref[int(b)] == 1)

    # -- admission / release -------------------------------------------------

    def admit(self, slot: int, prompt: Sequence[int],
              max_new_tokens: int) -> AdmitPlan | None:
        """Reserve everything the request can touch in ``slot``: shared
        prefix blocks are mapped in, the rest is allocated up front so
        decode never fails mid-flight.  None = clean backoff."""
        assert self.n_slot_blocks[slot] == 0, f"slot {slot} not released"
        total = min(blocks_for(len(prompt) + max_new_tokens,
                               self.block_size), self.blocks_per_slot)
        shared = self.match_prefix(prompt)
        if len(shared) > total:
            for bid in shared[total:]:
                self._release_one(bid)
            shared = shared[:total]
        fresh = self.reserve(total - len(shared))
        if fresh is None:
            for bid in shared:
                self._release_one(bid)
            return None
        row = list(shared) + fresh
        self.tables[slot, :len(row)] = row
        self.tables[slot, len(row):] = NULL_BLOCK
        self.n_slot_blocks[slot] = len(row)
        self._mark_written(row)
        self.shared_token_hits += len(shared) * self.block_size
        self._m_shared.inc(len(shared) * self.block_size)
        self._note_usage()
        return AdmitPlan(slot=slot,
                         shared_tokens=len(shared) * self.block_size,
                         shared_blocks=tuple(shared),
                         new_blocks=tuple(fresh))

    def extend(self, slot: int, total_tokens: int) -> bool:
        """Grow the slot's table to cover ``total_tokens`` positions
        (evicting cached prefix blocks under pressure).  False, and a
        counted backoff, when the pool cannot."""
        need = min(blocks_for(total_tokens, self.block_size),
                   self.blocks_per_slot)
        cur = int(self.n_slot_blocks[slot])
        if need <= cur:
            return True
        fresh = self.reserve(need - cur)
        if fresh is None:
            return False
        self.tables[slot, cur:need] = fresh
        self.n_slot_blocks[slot] = need
        self._mark_written(fresh)
        self._note_usage()
        return True

    def truncate(self, slot: int, n_keep: int) -> int:
        """KV rollback: keep the first ``blocks_for(n_keep)`` blocks of the
        slot and release the rest, as :meth:`release_slot` releases
        (exclusive blocks freed, shared ones unpinned, pending copies into
        them scrubbed).  Returns the number of entries dropped."""
        keep = min(blocks_for(max(0, int(n_keep)), self.block_size),
                   self.blocks_per_slot)
        cur = int(self.n_slot_blocks[slot])
        if keep >= cur:
            return 0
        dropped = [int(b) for b in self.tables[slot, keep:cur]]
        self._scrub_pending(set(dropped))
        for bid in dropped:
            self._release_one(bid)
        self.tables[slot, keep:cur] = NULL_BLOCK
        self.n_slot_blocks[slot] = keep
        return cur - keep

    def release_slot(self, slot: int, *, prompt: Sequence[int] | None
                     = None) -> None:
        """Drop the slot's refs; with ``prompt`` its full blocks are first
        registered in the prefix cache so they survive the release."""
        n = int(self.n_slot_blocks[slot])
        row = [int(b) for b in self.tables[slot, :n]]
        if prompt is not None:
            self.register_prefix(prompt, row)
        self._scrub_pending(set(row))
        for bid in row:
            self._release_one(bid)
        self.tables[slot, :] = NULL_BLOCK
        self.n_slot_blocks[slot] = 0

    # -- copy-on-write -------------------------------------------------------

    def ensure_writable(self, slot: int, first_pos: int, last_pos: int
                        ) -> None:
        """Fork any shared block the write span [first_pos, last_pos]
        touches.  The slot's ref on the source moves to the pending-copy
        entry and is released by :meth:`take_copies`, so the source cannot
        be freed and re-allocated before the device copy runs."""
        j0 = first_pos // self.block_size
        j1 = min(last_pos // self.block_size, self.blocks_per_slot - 1)
        for j in range(j0, j1 + 1):
            bid = int(self.tables[slot, j])
            if bid == NULL_BLOCK or self.ref[bid] <= 1:
                continue
            fresh = self._alloc_one()
            if fresh is None:
                self._evict_cached(1)
                fresh = self._alloc_one()
                if fresh is None:
                    raise MemoryError("KV pool exhausted during COW fork")
            self.pending_copies.append((bid, fresh))
            self.cow_forks += 1
            self._m_cow.inc()
            if self.quantized:
                # the queued copy moves payload and sidecar alike
                self.scale_written[fresh] = self.scale_written[bid]
            self.tables[slot, j] = fresh

    def take_copies(self) -> list[tuple[int, int]]:
        """Pop the queued (src, dst) COW copies for on-device execution,
        releasing each source's pending pin."""
        out, self.pending_copies = self.pending_copies, []
        for src, _dst in out:
            self._release_one(src)
        return out

    def _scrub_pending(self, dropped: set[int]) -> None:
        """Drop queued copies into released blocks (and their pins)."""
        if not self.pending_copies:
            return
        keep: list[tuple[int, int]] = []
        for src, dst in self.pending_copies:
            if dst in dropped:
                self._release_one(src)
            else:
                keep.append((src, dst))
        self.pending_copies = keep

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict[str, int]:
        return {"num_blocks": self.num_blocks - 1,
                "block_size": self.block_size,
                "quantized": int(self.quantized),
                "used": self.used_blocks,
                "peak_used": self.peak_used,
                "cached_prefix_blocks": len(self._prefix),
                "shared_token_hits": self.shared_token_hits,
                "cow_forks": self.cow_forks,
                "evictions": self.evictions,
                "backoffs": self.backoffs}

    def snapshot_state(self) -> dict:
        """JSON-serializable dump of the pool state: audit reproducers and
        the engine's warm-restart snapshots.  ``prefix`` keeps the
        cache's LRU order (front = coldest), so :meth:`from_snapshot`
        rebuilds its eviction order."""
        return {
            "num_blocks": int(self.num_blocks),
            "block_size": int(self.block_size),
            "slots": int(self.slots),
            "max_len": int(self.max_len),
            "share_prefixes": bool(self.share_prefixes),
            "quantized": bool(self.quantized),
            "scale_written": [int(b) for b
                              in np.flatnonzero(self.scale_written)],
            "free": [int(b) for b in self._free],
            "ref": [int(r) for r in self.ref],
            "tables": self.tables.tolist(),
            "n_slot_blocks": [int(n) for n in self.n_slot_blocks],
            "prefix": [[_hash_to_json(h), int(b)]
                       for h, b in self._prefix.items()],
            "pending_copies": [[int(s), int(d)]
                               for s, d in self.pending_copies],
        }

    @classmethod
    def from_snapshot(cls, state: dict) -> "KVPool":
        """Rebuild a pool from :meth:`snapshot_state` output: the same
        allocator order, ref counts, tables, prefix cache (LRU order) and
        pending copies; the telemetry counters start at zero."""
        pool = cls(int(state["num_blocks"]), int(state["block_size"]),
                   slots=int(state["slots"]), max_len=int(state["max_len"]),
                   share_prefixes=bool(state.get("share_prefixes", True)),
                   quantized=bool(state.get("quantized", False)))
        for bid in state.get("scale_written", []):
            pool.scale_written[int(bid)] = True
        pool._free = collections.deque(int(b) for b in state["free"])
        pool.ref = np.asarray(state["ref"], np.int32)
        pool.tables = np.asarray(state["tables"], np.int32)
        pool.n_slot_blocks = np.asarray(state["n_slot_blocks"], np.int32)
        pool._prefix = collections.OrderedDict(
            (_hash_from_json(h), int(b))
            for h, b in state.get("prefix", []))
        pool._hash_of = {b: h for h, b in pool._prefix.items()}
        pool.pending_copies = [(int(s), int(d))
                               for s, d in state["pending_copies"]]
        return pool

    def audit_violations(self) -> list[str]:
        """Every broken invariant (empty when consistent): ref
        conservation, the free list holding exactly the ref == 0 blocks
        once each, pending copies between live blocks into a block a slot
        maps, table rows null past their length (``extend``/``truncate``),
        and (quantized pools) scale flags on exactly the live blocks."""
        out: list[str] = []
        mapped: set[int] = set()
        for s in range(self.slots):
            n = int(self.n_slot_blocks[s])
            if not 0 <= n <= self.blocks_per_slot:
                out.append(f"slot {s} maps {n} blocks, outside [0, "
                           f"{self.blocks_per_slot}]")
                continue
            mapped.update(int(b) for b in self.tables[s, :n])
            tail = [int(b) for b in self.tables[s, n:] if b != NULL_BLOCK]
            if tail:
                out.append(f"slot {s}: stale table entries {tail} past its "
                           f"{n} mapped blocks")
        for _src, dst in self.pending_copies:
            if int(dst) not in mapped:
                out.append(f"pending COW copy into block {int(dst)}, which "
                           f"no slot maps (a scrub was missed)")
        counts = np.zeros(self.num_blocks, np.int64)
        counts[NULL_BLOCK] += 1
        for s in range(self.slots):
            for b in self.tables[s, :self.n_slot_blocks[s]]:
                counts[int(b)] += 1
        for bid in self._hash_of:
            counts[bid] += 1
        for src, _dst in self.pending_copies:
            counts[int(src)] += 1
        free_list = [int(b) for b in self._free]
        free = set(free_list)
        if len(free) != len(free_list):
            dupes = sorted(b for b in free if free_list.count(b) > 1)
            out.append(f"double free: blocks {dupes} appear more than "
                       f"once on the free list")
        if NULL_BLOCK in free:
            out.append("null block on the free list")
        for bid in range(self.num_blocks):
            c, r = int(counts[bid]), int(self.ref[bid])
            if c != r:
                kind = ("leak (ref outlives users)" if r > c
                        else "dangling use (users outnumber ref)")
                out.append(f"refcount: block {bid} has {c} user(s) but "
                           f"ref {r} — {kind}")
            if r > 0 and bid in free:
                out.append(f"block {bid} on the free list with ref {r} "
                           f"(use-after-free window)")
            if r == 0 and bid not in free:
                out.append(f"block {bid} has ref 0 but is not on the "
                           f"free list (leaked)")
            if r == 0 and bid in self._hash_of:
                out.append(f"prefix cache maps freed block {bid}")
        for src, dst in self.pending_copies:
            if self.ref[int(src)] <= 0:
                out.append(f"pending COW copy reads freed source block "
                           f"{int(src)}")
            if self.ref[int(dst)] <= 0:
                out.append(f"pending COW copy writes freed destination "
                           f"block {int(dst)}")
        if self.quantized:
            # live blocks own live dequant state, freed blocks own none
            if self.scale_written[NULL_BLOCK]:
                out.append("null block marked scale-written")
            for bid in range(1, self.num_blocks):
                r, w = int(self.ref[bid]), bool(self.scale_written[bid])
                if r == 0 and w:
                    out.append(f"stale scale sidecar: freed block {bid} "
                               f"still marked written")
                if r > 0 and int(counts[bid]) > 0 and not w:
                    out.append(f"block {bid} is live with no scale "
                               f"sidecar recorded -- dequant state lost")
        return out

    def check(self, pending_op: dict | None = None) -> None:
        """Raise :class:`PoolAuditError` when any invariant is broken."""
        violations = self.audit_violations()
        if violations:
            raise PoolAuditError(violations, self.snapshot_state(),
                                 pending_op)
