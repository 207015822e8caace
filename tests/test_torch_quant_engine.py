"""Port parity: the quantized paged engine end to end.

Scaled-down qwen2 (fp32) at the x4 weights of the other engine tests,
``quant_serving=True`` with ``QuantPolicy(min_size=0)`` (at this width
the default floor would leave the attention projections float), on
serve_bench's shared-prefix trace cut to 4 requests of at most 8 new
tokens: the port's greedy tokens under BOTH GEMM backends -- and from a
tree the reference quantized itself, carried over by the bridge -- must
equal those of the reference's quantized ``ContinuousEngine``, with the
pool audit clean after every step, the same step and prefix-sharing
counts and the same KV pool bytes.  The reference engine runs in a fresh
process, as in ``tests/test_torch_engine.py``, with XLA's CPU matmuls on
one thread: multi-threaded, their sums split by thread and the reference
gives other greedy tokens from run to run under load, and quantizing the
KV on write turns a last-bit difference into a whole int8 step.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.serve_bench import _trace
from repro.quant import policy as JQ
from repro_torch.models import attention as TA
from repro_torch.models import bridge
from repro_torch.quant.policy import QuantPolicy, QuantTensor
from repro_torch.serving.engine import ContinuousEngine, Request
from _torch_port import reference_params, run_reference, with_backend

SLOTS, MAX_LEN, MAX_NEW = 2, 128, 8
ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = """
from benchmarks.serve_bench import _trace
from repro.quant import QuantPolicy
from repro.serving.engine import ContinuousEngine
from _torch_port import reference_params
jcfg, params, _ = reference_params()
qcfg = dataclasses.replace(jcfg, quant_serving=True).validate()
reqs = _trace(4, {slots}, jcfg.vocab)
for r in reqs:
    r.max_new_tokens = min(r.max_new_tokens, {max_new})
eng = ContinuousEngine(qcfg, jax.tree.map(jnp.asarray, params),
                       slots={slots}, max_len={max_len}, audit=True,
                       quant_policy=QuantPolicy(min_size=0))
res = eng.run(reqs)
print(json.dumps({{"tokens": {{r.rid: r.tokens.tolist() for r in res}},
                  "steps": [eng.steps, eng.chunk_steps],
                  "shared": eng.pool.stats()["shared_token_hits"],
                  "quantized": eng.pool.stats()["quantized"],
                  "kv_allocated": eng.kv_bytes()["allocated"]}}))
"""


@pytest.fixture(scope="module")
def reference_run():
    code = _REFERENCE.format(slots=SLOTS, max_new=MAX_NEW, max_len=MAX_LEN)
    ref = run_reference(code, ROOT)
    jcfg, params, tcfg = reference_params()
    reqs = _trace(4, SLOTS, tcfg.vocab)
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, MAX_NEW)
    ref["tokens"] = {int(k): np.asarray(v) for k, v in ref["tokens"].items()}
    return jcfg, params, tcfg, reqs, ref


def _serve(cfg, tree, reqs):
    eng = ContinuousEngine(cfg, tree, slots=SLOTS, max_len=MAX_LEN,
                           audit=True, quant_policy=QuantPolicy(min_size=0),
                           device="cpu")
    eng.schedule.reset()
    res = eng.run([Request(r.rid, r.prompt, r.max_new_tokens, eos=r.eos)
                   for r in reqs])
    return eng, {r.rid: r for r in res}


@pytest.mark.parametrize("backend,weights", [("xla", "float"),
                                             ("scheduled", "float"),
                                             ("xla", "reference-quantized")])
def test_quant_tokens_match_reference_engine(reference_run, backend,
                                             weights):
    jcfg, params, tcfg, reqs, ref = reference_run
    cfg = dataclasses.replace(with_backend(tcfg, backend),
                              quant_serving=True)
    if weights == "float":
        tree = bridge.from_jax_params(params, cfg, "cpu")
    else:
        qcfg = dataclasses.replace(jcfg, quant_serving=True)
        tree = bridge.from_jax_params(jax.tree.map(
            np.asarray, JQ.serving_quant_params(
                qcfg, jax.tree.map(jnp.asarray, params),
                JQ.QuantPolicy(min_size=0))), cfg, "cpu")
    eng, got = _serve(cfg, tree, reqs)
    assert isinstance(eng.params["blocks"][0]["attn"]["wq"], QuantTensor)
    assert sorted(got) == sorted(ref["tokens"])
    for rid, want in ref["tokens"].items():
        np.testing.assert_array_equal(got[rid].tokens, want)
        assert got[rid].status == "ok"
    assert len({int(t) for r in got.values() for t in r.tokens}) > 4
    assert [eng.steps, eng.chunk_steps] == ref["steps"]
    assert eng.pool.stats()["shared_token_hits"] == ref["shared"] > 0
    assert eng.pool.stats()["quantized"] == ref["quantized"] == 1
    assert eng.kv_bytes()["allocated"] == ref["kv_allocated"]
    st = eng.schedule.stats()
    assert st["misses"] == 0 and st["hits"] > 0   # pre-resolved shapes
    if backend == "scheduled":                    # K3 ran, logged as INT8
        assert any(key[3] == "INT8" for key, _ in eng.schedule.applied)


def test_quant_kv_bytes_and_duplicate_writes(reference_run, monkeypatch):
    """The int8 pool holds (hd + 4) / (4 hd) of the fp32 pool's bytes, and
    every scatter index that more than one row of a step writes lies in
    the NULL block 0 (rows riding along write there): duplicate indices
    of ``index_copy_`` are nondeterministic on CUDA for payload and
    sidecar alike, harmless only in the trash block."""
    _jcfg, params, tcfg, reqs, _ref = reference_run
    seen = []
    real = TA.paged_flat_index

    def spy(block_table, pos, block_size):
        idx = real(block_table, pos, block_size)
        seen.append((idx.reshape(-1).clone(), block_size))
        return idx
    monkeypatch.setattr(TA, "paged_flat_index", spy)
    cfg = dataclasses.replace(tcfg, quant_serving=True)
    eng, got = _serve(cfg, bridge.from_jax_params(params, cfg, "cpu"),
                      reqs[:3])
    assert all(r.status == "ok" for r in got.values())
    dupes = 0
    for idx, bs in seen:
        vals, counts = torch.unique(idx, return_counts=True)
        rep = vals[counts > 1]
        dupes += len(rep)
        assert (rep < bs).all(), rep
    assert dupes > 0                  # the trace does exercise stray rows
    fp = ContinuousEngine(tcfg, bridge.from_jax_params(params, tcfg, "cpu"),
                          slots=SLOTS, max_len=MAX_LEN, device="cpu")
    hd = tcfg.hd
    assert eng.kv_bytes()["allocated"] * 4 * hd == \
        fp.kv_bytes()["allocated"] * (hd + 4)
