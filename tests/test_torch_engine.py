"""Port parity: the paged continuous-batching engine end to end.

On serve_bench's shared-prefix trace (``benchmarks/serve_bench.py``
``_trace``), cut to 4 requests of at most 8 new tokens, the port's greedy
tokens under BOTH GEMM backends must equal those of the reference's
``ContinuousEngine`` on its default ``xla`` backend, with the pool audit
clean after every step and the same prefix-sharing and step counts.  (The
reference pins its own scheduled backend to its xla backend in
``tests/test_gemm_backend.py``.)
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks.serve_bench import _trace
from repro_torch.models import bridge
from repro_torch.models import network as TN
from repro_torch.serving import kv_pool
from repro_torch.serving.engine import ContinuousEngine, Request
from _torch_port import reference_params, run_reference, with_backend

SLOTS, MAX_LEN, MAX_NEW = 2, 128, 8
ROOT = Path(__file__).resolve().parents[1]


_REFERENCE = """
from benchmarks.serve_bench import _trace
from repro.serving.engine import ContinuousEngine
from _torch_port import reference_params
jcfg, params, _ = reference_params()
reqs = _trace(4, {slots}, jcfg.vocab)
for r in reqs:
    r.max_new_tokens = min(r.max_new_tokens, {max_new})
eng = ContinuousEngine(jcfg, jax.tree.map(jnp.asarray, params),
                       slots={slots}, max_len={max_len}, audit=True)
res = eng.run(reqs)
print(json.dumps({{"tokens": {{r.rid: r.tokens.tolist() for r in res}},
                  "steps": [eng.steps, eng.chunk_steps],
                  "shared": eng.pool.stats()["shared_token_hits"]}}))
"""


@pytest.fixture(scope="module")
def reference_run():
    """The reference engine's run, in a fresh process: the reference's
    XLA:CPU rounding depends on what ran before it in the same process
    (an earlier spec/profiled engine changes it), and greedy decoding of
    a random model turns a last-bit difference into another token."""
    code = _REFERENCE.format(slots=SLOTS, max_new=MAX_NEW, max_len=MAX_LEN)
    ref = run_reference(code, ROOT, one_thread=False)
    _jcfg, params, tcfg = reference_params()
    reqs = _trace(4, SLOTS, tcfg.vocab)
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, MAX_NEW)
    tokens = {int(k): np.asarray(v) for k, v in ref["tokens"].items()}
    return params, tcfg, reqs, tokens, ref


@pytest.mark.parametrize("backend", ["xla", "scheduled"])
def test_greedy_tokens_match_reference_engine(reference_run, backend):
    params, tcfg, reqs, want, ref = reference_run
    cfg = with_backend(tcfg, backend)
    eng = ContinuousEngine(cfg, bridge.from_jax_params(params, cfg, "cpu"),
                           slots=SLOTS, max_len=MAX_LEN, audit=True,
                           device="cpu")
    eng.schedule.reset()
    results = eng.run([Request(r.rid, r.prompt, r.max_new_tokens, eos=r.eos)
                       for r in reqs])
    got = {r.rid: r.tokens for r in results}
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert all(r.status == "ok" for r in results)
    assert len({int(t) for v in got.values() for t in v}) > 4  # varied
    assert [eng.steps, eng.chunk_steps] == ref["steps"]
    assert eng.pool.stats()["shared_token_hits"] == ref["shared"] > 0
    st = eng.schedule.stats()
    assert st["misses"] == 0 and st["hits"] > 0   # pre-resolved shapes


def test_engine_rejects_what_is_not_ported(reference_run):
    params, tcfg, *_ = reference_run
    tp = bridge.from_jax_params(params, tcfg, "cpu")
    eng = ContinuousEngine(tcfg, tp, slots=SLOTS, max_len=MAX_LEN,
                           device="cpu")
    # speculative decoding of a recurrent config: the reference refuses it
    # too (its state cannot be rolled back)
    from repro_torch import configs as TC
    mcfg = TC.get("mamba2_2_7b").scaled_down()
    with pytest.raises(ValueError, match="hybrid"):
        ContinuousEngine(mcfg, TN.init(mcfg, device="cpu"), slots=SLOTS,
                         max_len=MAX_LEN, spec="ngram", device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(1, np.ones(MAX_LEN + 1, np.int32)))


def test_pool_cow_fork_and_engine_block_copy():
    """A write into a shared block forks it (the source's ref moves to the
    pending copy until the engine takes it) and the engine's copy moves
    the block's bytes in every layer's pool."""
    pool = kv_pool.KVPool(8, 4, slots=2, max_len=16)
    prompt = list(range(3, 12))                 # 2 full blocks + 1 token
    assert pool.admit(0, prompt, 4) is not None
    pool.register_prefix(prompt, list(pool.tables[0, :2]))
    plan = pool.admit(1, prompt, 4)
    assert plan.shared_tokens == 8
    shared = int(pool.tables[1, 1])
    pool.ensure_writable(1, 5, 5)
    (src, dst), = pool.pending_copies
    assert src == shared and int(pool.tables[1, 1]) == dst
    pool.check()
    copies = pool.take_copies()
    pool.check()
    assert pool.stats()["cow_forks"] == 1
    from repro_torch import configs as TC
    cfg = TC.get("qwen2_0_5b").scaled_down()
    caches = TN.init_paged_caches(cfg, 2, 8, 4, device="cpu")
    caches["groups"][0]["k"][:, src] = 1.5
    TN.copy_paged_blocks(caches, torch.tensor([c[0] for c in copies]),
                         torch.tensor([c[1] for c in copies]))
    assert float(caches["groups"][0]["k"][:, dst].min()) == 1.5
