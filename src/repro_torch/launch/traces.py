"""Request traces of the reference's serving benchmark
(``benchmarks/serve_bench.py``), copied so that the port's scripts need
nothing of the reference: the same generators, draws, lengths, budgets,
``eos=-1`` (every budget decoded in full) and TTFT SLOs, and the pool and
window sizes the reference serves them with.  Token values are drawn in
``[3, vocab)``, so a trace at another vocabulary has the same shape.
"""

from __future__ import annotations

import numpy as np

from repro_torch.serving.engine import Request

#: the overload trace's window and pool: one oversized reservation cannot
#: fit behind the two hogs (10 blocks of 16 a slot, 20 in all)
POLICY_MAX_LEN = 160
OVERLOAD_KV_BLOCKS = 20
#: the repetition trace's window (26-token prompts + 24 new tokens)
SPEC_MAX_LEN = 96
#: the mixed trace's shared system-prompt prefix, window and slots
#: (serve_bench's defaults) and request count (its ``--dry`` run's)
MIXED_PREFIX_LEN = 32
MIXED_MAX_LEN = 160
MIXED_SLOTS = 4
MIXED_REQUESTS = 8


def mixed_trace(n_requests: int, slots: int, vocab: int, seed: int = 0
                ) -> list[Request]:
    """The engine comparison's trace: requests in groups of 4 sharing a
    system-prompt prefix, mostly short chat turns, and one long-prompt
    straggler with a long decode per slots-worth (what wave batching is
    worst at)."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(3, vocab, MIXED_PREFIX_LEN).astype(np.int32)
                for _ in range(-(-n_requests // 4))]
    reqs = []
    for i in range(n_requests):
        straggler = (i % slots) == (slots - 1)
        tail_len = int(rng.integers(48, 64) if straggler
                       else rng.integers(4, 16))
        max_new = int(rng.integers(24, 32) if straggler
                      else rng.integers(2, 8))
        prompt = np.concatenate([prefixes[i // 4],
                                 rng.integers(3, vocab, tail_len
                                              ).astype(np.int32)])
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=max_new,
                            eos=-1))
    return reqs


def overload_trace(n_requests: int, vocab: int, seed: int = 1
                   ) -> list[Request]:
    """Head-of-line overload: two long-decode hogs, an oversized
    100-token head that blocks FIFO against the tight pool, short chat
    turns and mediums with (effectively immediate) 1e-4 s TTFT SLOs."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        if i < 2:                       # hogs: long decode, no SLO
            plen = int(rng.integers(56, 72))
            mnew, slo = int(rng.integers(40, 48)), None
        elif i == 2:                    # oversized head-of-line blocker
            plen, mnew, slo = 100, 30, None
        elif i % 3 == 0:                # mediums
            plen = int(rng.integers(24, 40))
            mnew, slo = int(rng.integers(6, 10)), 1e-4
        else:                           # short SLO'd chat turns
            plen = int(rng.integers(4, 12))
            mnew, slo = int(rng.integers(2, 6)), 1e-4
        reqs.append(Request(rid=i,
                            prompt=rng.integers(3, vocab, plen
                                                ).astype(np.int32),
                            max_new_tokens=mnew, eos=-1, ttft_slo=slo))
    return reqs


def rep_trace(n_requests: int, vocab: int, seed: int = 2,
              max_new: int = 24) -> list[Request]:
    """Repetition-heavy prompts (a 6-token phrase looped four times after
    a 2-token salt), the traffic prompt-lookup drafting is for."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        phrase = rng.integers(3, vocab, 6).astype(np.int32)
        salt = rng.integers(3, vocab, 2).astype(np.int32)
        prompt = np.concatenate([salt] + [phrase] * 4)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=max_new,
                            eos=-1))
    return reqs
