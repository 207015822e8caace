"""Port parity: scheduling policies with preemption and speculative
decoding in the paged engine, end to end.

Traces and geometry are serve_bench's (``benchmarks/serve_bench.py``):
the overload trace (12 requests: two long-decode hogs, an oversized FIFO
head and SLO'd chat turns; 4 slots, max_len 160, the 20-block pool that
makes the head block) and the repetition trace (8 looped prompts, 24 new
tokens; max_len 96, ``spec_k`` 4), on scaled-down qwen2 at weights x4.

  * Every policy's tokens equal the reference engine's FIFO tokens and an
    unconstrained pool's; ``fifo`` and ``slo_preempt`` also match the
    reference's steps, preemptions, TTFT in steps, pool utilisation and
    backoffs, and ``slo_preempt``'s resumed requests skip their cached
    prefill.
  * Vanilla, ``ngram`` and self-drafting ``ModelDraft`` runs give the
    reference's vanilla tokens and the reference's ``spec_stats``, with no
    schedule-cache miss.  A divergent draft (other weights) is rejected
    part of the time (accepted < drafted) and rolled back exactly.
  * mamba2 under ``slo_preempt`` preempts and resumes by re-prefilling,
    with the tokens of a never-preempted run.
  * ``network.verify_paged_chunk`` gives the reference's logits at every
    position within 1e-4 under both GEMM backends.

The reference engines run in one fresh process, with one change to how
they are driven: every dispatch gets a copy of the host
arrays it reads.  The reference hands its numpy cursors and block tables
to its asynchronous dispatches through ``jnp.asarray``, which on the CPU
may alias them, and then updates them in place (``self._pos += adv``,
the pool's tables) while a dispatch can still be reading them: a race
that changes its tokens from run to run, most often single-threaded or
under load (ROADMAP.md, Queue 3).  With the copies its runs repeat, and
the port matches them token for token.
"""

import dataclasses
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import serve_bench as SB
from repro.models import network as JN
from repro_torch import configs as TC
from repro_torch.launch import traces as TR
from repro_torch.launch.traces import (OVERLOAD_KV_BLOCKS, POLICY_MAX_LEN,
                                       SPEC_MAX_LEN)
from repro_torch.models import bridge
from repro_torch.models import network as TN
from repro_torch.serving.engine import ContinuousEngine, Request
from repro_torch.serving.policy import POLICY_NAMES
from repro_torch.serving.resilience import ResilienceConfig
from repro_torch.serving.spec import ModelDraft
from _torch_port import reference_params, run_reference, with_backend

SLOTS, SPEC_K = 4, 4
ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = """
from benchmarks.serve_bench import (OVERLOAD_KV_BLOCKS, POLICY_MAX_LEN,
                                    SPEC_MAX_LEN, _overload_trace,
                                    _rep_trace)
from repro.serving.engine import ContinuousEngine
from repro.serving.spec import ModelDraft
from _torch_port import reference_params
jcfg, params, _ = reference_params()
params = jax.tree.map(jnp.asarray, params)
out = {{}}
for kind in ("fifo", "slo_preempt", "vanilla", "ngram", "self"):
    if kind in ("fifo", "slo_preempt"):
        eng = ContinuousEngine(jcfg, params, slots={slots},
                               max_len=POLICY_MAX_LEN,
                               kv_blocks=OVERLOAD_KV_BLOCKS, policy=kind,
                               audit=True)
        reqs = _overload_trace(12, jcfg.vocab)
        for r in reqs:
            eng.submit(r)
        time.sleep(0.01)    # every 1e-4 s SLO is at risk from step 1 on
        res = []
        while len(res) < len(reqs):
            eng.step()
            res += eng.drain_results()
    else:
        spec = {{"vanilla": None, "ngram": "ngram",
                 "self": ModelDraft(jcfg, params)}}[kind]
        eng = ContinuousEngine(jcfg, params, slots={slots},
                               max_len=SPEC_MAX_LEN, spec=spec, spec_k={k},
                               audit=True)
        res = eng.run(_rep_trace(8, jcfg.vocab))
    out[kind] = {{
        "tokens": {{r.rid: r.tokens.tolist() for r in res}},
        "ttft_steps": {{r.rid: r.ttft_steps for r in res}},
        "steps": [eng.steps, eng.chunk_steps],
        "preemptions": eng.preemptions,
        "resumed": sorted(r.rid for r in res if r.preemptions),
        "util": eng.avg_pool_util(), "pool": eng.pool.stats(),
        "spec": eng.spec_stats()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_runs():
    code = _REFERENCE.format(slots=SLOTS, k=SPEC_K)
    runs = run_reference(code, ROOT, one_thread=False)
    for ref in runs.values():
        for key in ("tokens", "ttft_steps"):
            ref[key] = {int(k): v for k, v in ref[key].items()}
    return runs


@pytest.fixture(scope="module")
def qwen():
    jcfg, params, tcfg = reference_params()
    return jcfg, params, tcfg, bridge.from_jax_params(params, tcfg, "cpu")


def _tokens(results):
    return {r.rid: r.tokens.tolist() for r in results}


def _run_overload(eng, reqs):
    """Submit the whole trace, wait until every 1e-4 s TTFT SLO is past
    half its deadline (the policies read waited time off the clock, so a
    first step within 50 us of a submit would decide otherwise), then
    serve it."""
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    time.sleep(0.01)
    res = []
    while len(res) < len(reqs):
        eng.step()
        res += eng.drain_results()
    return res


@pytest.mark.parametrize("vocab", [512, 151936])
def test_traces_are_serve_benchs(vocab):
    assert (TR.POLICY_MAX_LEN, TR.OVERLOAD_KV_BLOCKS, TR.SPEC_MAX_LEN) == (
        SB.POLICY_MAX_LEN, SB.OVERLOAD_KV_BLOCKS, SB.SPEC_MAX_LEN)
    for port, ref in ((TR.overload_trace(12, vocab),
                       SB._overload_trace(12, vocab)),
                      (TR.rep_trace(8, vocab), SB._rep_trace(8, vocab))):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            assert (a.rid, a.max_new_tokens, a.eos, a.ttft_slo,
                    a.priority, a.temperature) == (
                b.rid, b.max_new_tokens, b.eos, b.ttft_slo, b.priority,
                b.temperature)
            np.testing.assert_array_equal(a.prompt, b.prompt)
            assert a.prompt.dtype == b.prompt.dtype


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_overload_policies_match_reference(reference_runs, qwen, policy):
    _jcfg, _params, cfg, tp = qwen
    reqs = TR.overload_trace(12, cfg.vocab)
    eng = ContinuousEngine(cfg, tp, slots=SLOTS, max_len=POLICY_MAX_LEN,
                           kv_blocks=OVERLOAD_KV_BLOCKS, policy=policy,
                           audit=True, device="cpu")
    res = _run_overload(eng, reqs)
    got = _tokens(res)
    assert got == reference_runs["fifo"]["tokens"]
    assert len({t for v in got.values() for t in v}) > 8          # varied
    assert eng.admissions == len(reqs) + eng.resumes
    assert eng.resumes == sum(r.preemptions for r in res)
    assert all(r.status == "ok" for r in res)
    if policy in reference_runs:
        ref = reference_runs[policy]
        assert [eng.steps, eng.chunk_steps] == ref["steps"]
        assert eng.preemptions == ref["preemptions"]
        assert sorted(r.rid for r in res if r.preemptions) == ref["resumed"]
        assert {r.rid: r.ttft_steps for r in res} == ref["ttft_steps"]
        assert eng.avg_pool_util() == pytest.approx(ref["util"], rel=1e-9)
        assert eng.pool.stats() == ref["pool"]
    if policy in ("slo_preempt", "model_preempt"):
        assert eng.preemptions > 0 and eng.resumes == eng.preemptions
    if policy == "fifo":
        assert eng.pool.stats()["backoffs"] > 0       # the pool is tight
        roomy = ContinuousEngine(cfg, tp, slots=SLOTS,
                                 max_len=POLICY_MAX_LEN, device="cpu")
        assert _tokens(roomy.run([dataclasses.replace(r)
                                  for r in reqs])) == got


def test_slo_preempt_resume_skips_cached_prefill(reference_runs, qwen):
    """In the 20-block pool the at-risk admission itself evicts the
    victim's freshly cached blocks (the reference's pool stats, equal to
    the port's, show no shared hit).  In a 32-block pool the preemption
    is for a slot, not for blocks: the victim's sequence stays cached and
    its resumption maps those blocks instead of prefilling them."""
    _jcfg, _params, cfg, tp = qwen
    reqs = TR.overload_trace(12, cfg.vocab)
    eng = ContinuousEngine(cfg, tp, slots=SLOTS, max_len=POLICY_MAX_LEN,
                           kv_blocks=32, policy="slo_preempt", audit=True,
                           device="cpu")
    got = _tokens(_run_overload(eng, reqs))
    assert eng.preemptions > 0 and eng.resumes == eng.preemptions
    assert eng.pool.stats()["shared_token_hits"] > 0
    assert got == reference_runs["fifo"]["tokens"]


@pytest.mark.parametrize("kind,backend", [("vanilla", "xla"),
                                          ("ngram", "xla"),
                                          ("self", "xla"),
                                          ("self", "scheduled")])
def test_repetition_trace_matches_reference(reference_runs, qwen, kind,
                                            backend):
    _jcfg, _params, tcfg, tp = qwen
    cfg = with_backend(tcfg, backend)
    spec = {"vanilla": None, "ngram": "ngram",
            "self": ModelDraft(cfg, tp)}[kind]
    eng = ContinuousEngine(cfg, tp, slots=SLOTS, max_len=SPEC_MAX_LEN,
                           spec=spec, spec_k=SPEC_K, audit=True,
                           device="cpu")
    eng.schedule.reset()
    res = eng.run(TR.rep_trace(8, cfg.vocab))
    ref = reference_runs[kind]
    assert _tokens(res) == reference_runs["vanilla"]["tokens"]
    assert eng.spec_stats() == ref["spec"]
    assert [eng.steps, eng.chunk_steps] == ref["steps"]
    st = eng.schedule.stats()
    assert st["misses"] == 0 and st["hits"] > 0
    if kind != "vanilla":
        assert eng.spec_accepted > 0
        assert eng.steps < reference_runs["vanilla"]["steps"][0]


def test_divergent_draft_is_rejected_and_rolled_back(reference_runs, qwen):
    """A draft with other weights (seed 1 at the same x4 scale) disagrees
    with the target: rejections must happen, and the rolled-back cursors,
    draft caches and blocks still give the vanilla tokens."""
    _jcfg, _params, cfg, tp = qwen
    _j, other, _t = reference_params(seed=1)
    draft = ModelDraft(cfg, bridge.from_jax_params(other, cfg, "cpu"))
    eng = ContinuousEngine(cfg, tp, slots=SLOTS, max_len=SPEC_MAX_LEN,
                           spec=draft, spec_k=SPEC_K, audit=True,
                           device="cpu")
    res = eng.run(TR.rep_trace(8, cfg.vocab))
    assert _tokens(res) == reference_runs["vanilla"]["tokens"]
    st = eng.spec_stats()
    assert 0 < st["accepted"] < st["drafted"]
    # every token but each request's first (its prefill's) is a verify's
    assert st["tokens_emitted"] == sum(len(r.tokens) - 1 for r in res)
    assert eng.pool.used_blocks == len(eng.pool._hash_of)   # all returned


def test_spec_under_pool_pressure_preempts_and_degrades(reference_runs,
                                                        qwen):
    """Seven blocks for four slots: extends are denied, the live depth
    halves, slots that cannot host even k = 0 are preempted and resume;
    the tokens stay the vanilla ones."""
    _jcfg, _params, cfg, tp = qwen
    eng = ContinuousEngine(cfg, tp, slots=SLOTS, max_len=SPEC_MAX_LEN,
                           kv_blocks=7, spec="ngram", spec_k=SPEC_K,
                           resilience=ResilienceConfig(spec_degrade=True),
                           audit=True, device="cpu")
    res = eng.run(TR.rep_trace(8, cfg.vocab))
    assert _tokens(res) == reference_runs["vanilla"]["tokens"]
    assert eng.metrics.counter("resilience.spec_degrades").value > 0
    assert eng.preemptions > 0 and eng.resumes == eng.preemptions


def test_mamba2_preempted_run_equals_never_preempted():
    _jcfg, params, cfg = reference_params(scale=1.0, arch="mamba2_2_7b")
    tp = bridge.from_jax_params(params, cfg, "cpu")
    reqs = TR.overload_trace(12, cfg.vocab)

    def run(**kw):
        eng = ContinuousEngine(cfg, tp, slots=SLOTS, max_len=POLICY_MAX_LEN,
                               audit=True, device="cpu", **kw)
        return eng, _tokens(_run_overload(eng, reqs))

    pre, got = run(kv_blocks=OVERLOAD_KV_BLOCKS, policy="slo_preempt")
    _, fifo = run(kv_blocks=OVERLOAD_KV_BLOCKS)
    _, roomy = run()
    assert pre.preemptions > 0 and pre.resumes == pre.preemptions
    assert not pre.pool.share_prefixes            # resume re-prefills
    assert got == fifo == roomy
    assert len({t for v in got.values() for t in v}) > 8


def test_spec_refusals(qwen):
    _jcfg, _params, cfg, tp = qwen
    mcfg = TC.get("mamba2_2_7b").scaled_down()
    mp = TN.init(mcfg, device="cpu")
    with pytest.raises(ValueError, match="hybrid"):
        ContinuousEngine(mcfg, mp, slots=2, max_len=64, spec="ngram",
                         device="cpu")
    with pytest.raises(ValueError, match="hybrid"):
        ModelDraft(mcfg, mp)
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousEngine(cfg, tp, slots=2, max_len=64, spec="ngram",
                         spec_k=0, device="cpu")
    with pytest.raises(ValueError, match="unknown spec provider"):
        ContinuousEngine(cfg, tp, slots=2, max_len=64, spec="medusa",
                         device="cpu")
    eng = ContinuousEngine(cfg, tp, slots=2, max_len=64, spec="ngram",
                           device="cpu")
    with pytest.raises(ValueError, match="greedy-only"):
        eng.submit(Request(0, np.arange(3, 9, dtype=np.int32),
                           temperature=0.5))


@pytest.mark.parametrize("backend", ["xla", "scheduled"])
def test_verify_chunk_matches_reference(qwen, backend):
    jcfg, params, tcfg, _ = qwen
    cfg = with_backend(tcfg, backend)
    tp = bridge.from_jax_params(params, cfg, "cpu")
    B, NB, BS, L = 3, 24, 8, SPEC_K + 1
    rng = np.random.default_rng(9)
    tables = np.zeros((B, 6), np.int32)
    tables[0, :3] = [3, 7, 1]
    tables[1, :2] = [5, 2]
    pos = np.asarray([13, 6, 0], np.int32)
    toks = rng.integers(3, jcfg.vocab, (B, L)).astype(np.int32)
    lens = np.asarray([L, 3, 0], np.int32)
    ids = np.arange(B, dtype=np.int32)
    kv = rng.standard_normal((jcfg.n_layers, NB, BS, jcfg.n_kv_heads,
                              jcfg.hd)).astype(np.float32)
    jc = JN.set_slot_pos(JN.expand_cache_pos(
        JN.init_paged_caches(jcfg, B, NB, BS), B), jnp.asarray(pos))
    jc = {"groups": ({**jc["groups"][0], "k": jnp.asarray(kv),
                      "v": jnp.asarray(-kv)},)}
    tc = TN.set_slot_pos(TN.expand_cache_pos(
        TN.init_paged_caches(cfg, B, NB, BS, device="cpu"), B),
        torch.from_numpy(pos))
    tc["groups"][0]["k"].copy_(torch.from_numpy(kv))
    tc["groups"][0]["v"].copy_(torch.from_numpy(-kv))
    jlog, jc = JN.verify_paged_chunk(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(toks), jc,
        jnp.asarray(ids), jnp.asarray(tables), jnp.asarray(lens))
    t = torch.from_numpy
    tlog, tc = TN.verify_paged_chunk(tp, cfg, t(toks), tc, t(ids),
                                     t(tables), t(lens))
    assert tuple(tlog.shape) == (B, L, jcfg.vocab)
    for b in range(B):
        n = int(lens[b])
        np.testing.assert_allclose(tlog.numpy()[b, :n],
                                   np.asarray(jlog)[b, :n], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tlog.numpy()[b, :n].argmax(-1),
                                      np.asarray(jlog)[b, :n].argmax(-1))
    np.testing.assert_array_equal(tc["groups"][0]["pos"].numpy(),
                                  np.asarray(jc["groups"][0]["pos"]))
    np.testing.assert_array_equal(tc["groups"][0]["pos"].numpy()[0],
                                  pos + lens)
