"""Port parity: the KV pool's probes, lazy growth and rollback, and the
scheduling policies, against ``repro.serving.kv_pool`` and
``repro.serving.policy``.

  * Both ``KVPool`` classes run the same seeded random op streams --
    admit, release (with and without prefix registration), copy-on-write
    forks and their take, ``extend``, ``truncate``, prefix registration --
    and after every op give the same answers (``probe``,
    ``evictable_cached``, ``reclaimable_blocks``, the ops' own results)
    and the same serialized state; both audits stay clean, the port's
    with its checks of the new states (rows null past their length,
    pending copies into mapped blocks).  ``probe`` changes nothing.
  * Every policy's ``select_admission`` and ``select_victim`` equal the
    reference's on the same seeded views, call after call (``model_*``
    keep a bypass ledger between calls).
"""

import dataclasses

import numpy as np
import pytest

from repro.serving import kv_pool as JKV
from repro.serving import policy as JPOL
from repro_torch.serving import kv_pool as TKV
from repro_torch.serving import policy as TPOL

NB, BS, SLOTS, MAX_LEN = 24, 4, 4, 40


def _prompt(rng, prefixes):
    base = prefixes[int(rng.integers(len(prefixes)))]
    tail = rng.integers(3, 9, int(rng.integers(1, 9))).tolist()
    return base[:int(rng.integers(0, len(base) + 1))] + tail


def _state(pool):
    s = pool.snapshot_state()
    s.pop("prefix_blocks", None)
    return s


def _op_stream(seed, pools, n_ops=300, quantized=False):
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(3, 9, 12).tolist() for _ in range(3)]
    prompts = [None] * SLOTS
    counts = dict.fromkeys(("admit", "extend", "truncate", "cow",
                            "release"), 0)
    for _ in range(n_ops):
        slot = int(rng.integers(SLOTS))
        live = prompts[slot] is not None
        r = rng.random()
        if not live:
            prompt = _prompt(rng, prefixes)
            new = int(rng.integers(0, 12))
            probes = [p.probe(prompt, new) for p in pools]
            assert dataclasses.asdict(probes[0]) == dataclasses.asdict(
                probes[1])
            plans = [p.admit(slot, prompt, new) for p in pools]
            assert (plans[0] is None) == (plans[1] is None)
            if plans[1] is not None:
                # a True probe promises the admission; a False one that
                # the pool cannot host it
                assert probes[1].fits_now
                assert (plans[0].shared_blocks, plans[0].new_blocks) == (
                    plans[1].shared_blocks, plans[1].new_blocks)
                prompts[slot] = prompt
                counts["admit"] += 1
            else:
                assert not probes[1].fits_now
        elif r < 0.2:
            n = int(rng.integers(1, MAX_LEN + 1))
            assert pools[0].extend(slot, n) == pools[1].extend(slot, n)
            counts["extend"] += 1
        elif r < 0.4:
            n = int(rng.integers(0, MAX_LEN))
            assert pools[0].truncate(slot, n) == pools[1].truncate(slot, n)
            counts["truncate"] += 1
        elif r < 0.6:
            p0 = int(rng.integers(0, MAX_LEN))
            p1 = min(MAX_LEN - 1, p0 + int(rng.integers(0, 2 * BS)))
            raised = []
            for p in pools:
                try:
                    p.ensure_writable(slot, p0, p1)
                except MemoryError:
                    raised.append(p)
            assert len(raised) in (0, 2)
            counts["cow"] += bool(pools[1].pending_copies)
        elif r < 0.7:
            assert pools[0].take_copies() == pools[1].take_copies()
        elif r < 0.8:
            n = int(pools[1].n_slot_blocks[slot])
            for p in pools:
                p.register_prefix(prompts[slot],
                                  [int(b) for b in p.tables[slot, :n]])
        else:
            keep = rng.random() < 0.5
            for p in pools:
                p.release_slot(slot, prompt=prompts[slot] if keep else None)
            prompts[slot] = None
            counts["release"] += 1
        assert pools[0].evictable_cached() == pools[1].evictable_cached()
        assert [pools[0].reclaimable_blocks(s) for s in range(SLOTS)] == \
            [pools[1].reclaimable_blocks(s) for s in range(SLOTS)]
        assert _state(pools[0]) == _state(pools[1])
        assert pools[0].audit_violations() == []
        assert pools[1].audit_violations() == []
    return counts


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("quantized", [False, True])
def test_pool_differential_random_streams(seed, quantized):
    pools = [cls(NB, BS, slots=SLOTS, max_len=MAX_LEN, quantized=quantized)
             for cls in (JKV.KVPool, TKV.KVPool)]
    counts = _op_stream(seed, pools, quantized=quantized)
    assert min(counts.values()) > 0, counts
    assert pools[1].stats() == pools[0].stats()


def test_probe_has_no_side_effects():
    pool = TKV.KVPool(NB, BS, slots=SLOTS, max_len=MAX_LEN)
    prompt = list(range(3, 16))
    assert pool.admit(0, prompt, 4) is not None
    pool.release_slot(0, prompt=prompt)
    before = (_state(pool), pool.stats())
    rep = pool.probe(prompt, 4)
    assert rep.shared == 3 and rep.need_new == rep.total - 3
    assert (_state(pool), pool.stats()) == before
    assert pool.evictable_cached() == 3


def test_audit_sees_the_new_states():
    """A stale table entry past a slot's length and a pending copy into a
    block nobody maps are both reported."""
    pool = TKV.KVPool(NB, BS, slots=SLOTS, max_len=MAX_LEN)
    assert pool.admit(0, list(range(3, 12)), 8) is not None
    assert pool.audit_violations() == []
    pool.n_slot_blocks[0] -= 1
    bad = pool.audit_violations()
    assert any("stale table entries" in v for v in bad)
    pool.n_slot_blocks[0] += 1
    assert pool.audit_violations() == []
    pool.pending_copies.append((int(pool.tables[0, 0]), 23))
    pool.ref[int(pool.tables[0, 0])] += 1
    assert any("which no slot maps" in v for v in pool.audit_violations())


def test_extend_and_truncate_return_blocks():
    pool = TKV.KVPool(8, 4, slots=2, max_len=28)             # 7 usable
    assert pool.admit(0, [3, 4, 5], 1) is not None          # 1 block
    assert pool.extend(0, 20) and pool.n_slot_blocks[0] == 5
    assert pool.extend(0, 12) and pool.used_blocks == 5     # no shrink
    assert pool.truncate(0, 6) == 3 and pool.used_blocks == 2
    assert pool.truncate(0, 6) == 0
    assert pool.admit(1, [7] * 5, 15) is not None           # the other 5
    assert not pool.extend(0, 16)                           # denied
    assert pool.stats()["backoffs"] == 1
    assert pool.n_slot_blocks[0] == 2
    pool.check()


# -- policies ------------------------------------------------------------------

def _views(rng, pkg, n_pending, slots):
    probe_cls = pkg["kv"].ProbeReport
    pending = []
    for i in range(n_pending):
        total = int(rng.integers(1, 8))
        shared = int(rng.integers(0, total + 1))
        probe = (None if rng.random() < 0.1 else
                 probe_cls(total=total, shared=shared,
                           need_new=total - shared,
                           free=int(rng.integers(0, 6)),
                           evictable=int(rng.integers(0, 3))))
        pending.append(pkg["pol"].PendingView(
            index=i, rid=int(rng.integers(0, 4)) if i == 0 else 100 + i,
            prompt_len=int(rng.integers(1, 200)),
            new_tokens=int(rng.integers(1, 40)),
            priority=int(rng.integers(0, 2)),
            ttft_slo=None if rng.random() < 0.4 else float(rng.random()),
            waited_s=float(rng.random() * 2), resumed=rng.random() < 0.2,
            preemptions=int(rng.integers(0, 3)), probe=probe))
    views = []
    for i in range(slots):
        if rng.random() < 0.25:
            views.append(None)
            continue
        views.append(pkg["pol"].SlotView(
            index=i, rid=200 + i,
            phase="decode" if rng.random() < 0.8 else "prefill",
            priority=int(rng.integers(0, 2)),
            produced=int(rng.integers(0, 20)),
            remaining=int(rng.integers(0, 20)),
            reclaimable_blocks=int(rng.integers(0, 6)),
            preemptions=int(rng.integers(0, 3)),
            has_slo=rng.random() < 0.5))
    return pending, views


_PKGS = {"ref": {"kv": JKV, "pol": JPOL}, "port": {"kv": TKV, "pol": TPOL}}


@pytest.mark.parametrize("name", TPOL.POLICY_NAMES)
def test_policy_decisions_match_reference(name):
    assert TPOL.POLICY_NAMES == JPOL.POLICY_NAMES
    ref, port = JPOL.make_policy(name), TPOL.make_policy(name)
    for attr in ("requires_pool", "needs_probes", "preempts"):
        assert getattr(port, attr) == getattr(ref, attr)
    decisions = set()
    for seed in range(400):
        picks = []
        for pkg, pol in (("ref", ref), ("port", port)):
            rng = np.random.default_rng(seed)
            n = int(rng.integers(0, 6))
            pending, slots = _views(rng, _PKGS[pkg], n, 4)
            picks.append((pol.select_admission(pending, 1.0),
                          pol.select_victim(pending, slots, 1.0)))
        assert picks[0] == picks[1], (name, seed)
        decisions.add(picks[1])
    # the streams reach holds, admissions past the head and evictions
    assert len(decisions) >= (2 if name == "fifo" else 4)
    assert any(v is not None for _a, v in decisions) == port.preempts


def test_step_costs_are_the_reference_prior():
    from repro.planner.model import StepCosts
    ref, port = StepCosts(), TPOL.StepCosts()
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    for plen, new in ((1, 1), (33, 7), (200, 40)):
        assert port.ttft_cost(plen) == ref.ttft_cost(plen)
        assert port.service_cost(plen, new) == ref.service_cost(plen, new)


def test_make_policy_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        TPOL.make_policy("lifo")
    with pytest.raises(ValueError, match="risk_frac"):
        TPOL.make_policy("slo_preempt", risk_frac=0.0)
