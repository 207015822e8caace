"""Port parity: mamba2 (attention-free, SSD blocks) through the paged
serving functions and the paged engine.

Scaled-down ``mamba2_2_7b`` (2 layers, d 128, d_state 16, head_dim 16,
chunk 32, vocab 512, fp32) at the reference's own init scale, where its
greedy streams already vary.  The network's prefill chunk and decode step
must give the reference's logits within 1e-4 (the GEMM bound of
``tests/test_torch_network.py``) and its recurrent state within the same
bound; the engine's greedy tokens must equal the reference's paged
``ContinuousEngine`` at ``prefill_chunk`` 32 and 64 (at 64,
``ssd_chunked`` runs two chunks and the inter-chunk scan) under both GEMM
backends, with prefix sharing off and the pool audit clean after every
step.  The reference engine runs once, in a fresh single-threaded
process, as in ``tests/test_torch_quant_engine.py``.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import network as JN
from repro_torch.models import bridge
from repro_torch.models import network as TN
from repro_torch.models.layers import tree_map
from repro_torch.serving.engine import ContinuousEngine, Request
from _torch_port import reference_params, run_reference, with_backend

TOL = dict(rtol=1e-4, atol=1e-4)
SLOTS, MAX_LEN, MAX_NEW = 2, 128, 8
PROMPT_LENS = (5, 40, 70)
CHUNKS = (32, 64)
ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = """
from repro.serving.engine import ContinuousEngine, Request
from _torch_port import reference_params
jcfg, params, _ = reference_params(scale=1.0, arch="mamba2_2_7b")
rng = np.random.default_rng(0)
prompts = [rng.integers(3, jcfg.vocab, n).astype(np.int32)
           for n in {lens!r}]
out = {{}}
for chunk in {chunks!r}:
    eng = ContinuousEngine(jcfg, jax.tree.map(jnp.asarray, params),
                           slots={slots}, max_len={max_len},
                           prefill_chunk=chunk, audit=True)
    res = eng.run([Request(i, p, {max_new}, eos=-1)
                   for i, p in enumerate(prompts)])
    out[chunk] = {{"tokens": {{r.rid: r.tokens.tolist() for r in res}},
                  "steps": [eng.steps, eng.chunk_steps],
                  "share_prefixes": eng.pool.share_prefixes}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mamba():
    return reference_params(scale=1.0, arch="mamba2_2_7b")


@pytest.fixture(scope="module")
def reference_run():
    code = _REFERENCE.format(lens=PROMPT_LENS, chunks=CHUNKS, slots=SLOTS,
                             max_len=MAX_LEN, max_new=MAX_NEW)
    return {int(k): v for k, v in run_reference(code, ROOT).items()}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in PROMPT_LENS]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("backend", ["xla", "scheduled"])
def test_greedy_tokens_match_reference_engine(mamba, reference_run, backend,
                                              chunk):
    _jcfg, params, tcfg = mamba
    cfg = with_backend(tcfg, backend)
    eng = ContinuousEngine(cfg, bridge.from_jax_params(params, cfg, "cpu"),
                           slots=SLOTS, max_len=MAX_LEN, prefill_chunk=chunk,
                           audit=True, device="cpu")
    res = eng.run([Request(i, p, MAX_NEW, eos=-1)
                   for i, p in enumerate(_prompts(cfg.vocab))])
    ref = reference_run[chunk]
    got = {r.rid: r.tokens.tolist() for r in res}
    assert got == {int(k): v for k, v in ref["tokens"].items()}
    assert all(r.status == "ok" for r in res)
    for toks in got.values():               # every stream varies
        assert len(set(toks)) > 4
    assert [eng.steps, eng.chunk_steps] == ref["steps"]
    assert eng.pool.share_prefixes is False is ref["share_prefixes"]
    assert eng.pool.stats()["shared_token_hits"] == 0
    assert eng.kv_bytes()["allocated"] == 0


def _caches(mod, cfg, **kw):
    return mod.expand_cache_pos(mod.init_paged_caches(cfg, 3, 12, 8, **kw),
                                3)


@pytest.mark.parametrize("backend", ["xla", "scheduled"])
def test_prefill_chunk_then_decode_match_reference(mamba, backend):
    jcfg, params, tcfg = mamba
    tcfg = with_backend(tcfg, backend)
    tp = bridge.from_jax_params(params, tcfg, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    rng = np.random.default_rng(4)
    tables = np.zeros((3, 6), np.int32)
    tables[0, :5], tables[1, :3] = [3, 7, 1, 10, 2], [5, 4, 9]
    L = 40                       # > the chunk of 32: two SSD chunks
    toks = rng.integers(3, jcfg.vocab, (3, L)).astype(np.int32)
    lens = np.asarray([40, 21, 0], np.int32)   # slot 2 rides along empty
    last, ids = np.maximum(lens - 1, 0), np.arange(3, dtype=np.int32)
    t = torch.from_numpy
    jc = _caches(JN, jcfg)
    jlog, jc = JN.prefill_paged_chunk(
        jp, jcfg, jnp.asarray(toks), jc, jnp.asarray(ids),
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(last))
    tc = _caches(TN, tcfg, device="cpu")
    tlog, tc = TN.prefill_paged_chunk(tp, tcfg, t(toks), tc, t(ids),
                                      t(tables), t(lens), t(last))

    def same_state(tc, jc):
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tc["groups"][0][k].numpy(),
                                       np.asarray(jc["groups"][0][k]), **TOL)

    live = lens > 0
    np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live],
                               **TOL)
    same_state(tc, jc)
    assert not tc["groups"][0]["ssm"][:, 2].any()   # the empty row's state

    pos = np.asarray(jc["pos"]).astype(np.int32)
    adv = np.asarray([1, 0, 1], np.int32)          # slot 1 rides along
    dtok = rng.integers(3, jcfg.vocab, (3, 1)).astype(np.int32)
    kept = tc["groups"][0]["ssm"][:, 1].clone()
    jlog, jc = JN.decode_step(jp, jcfg, jnp.asarray(dtok), jc,
                              jnp.asarray(pos), block_table=jnp.asarray(
                                  tables), pos_advance=jnp.asarray(adv))
    tlog, tc = TN.decode_step(tp, tcfg, t(dtok), tc, t(pos), t(tables),
                              t(adv))
    live = adv > 0
    np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live],
                               **TOL)
    np.testing.assert_array_equal(tlog.numpy()[live].argmax(-1),
                                  np.asarray(jlog)[live].argmax(-1))
    same_state(tc, jc)
    assert torch.equal(tc["groups"][0]["ssm"][:, 1], kept)


def test_cache_utilities_match_reference(mamba):
    jcfg, _params, tcfg = mamba
    rng = np.random.default_rng(6)
    tc = _caches(TN, tcfg, device="cpu")
    jc = _caches(JN, jcfg)
    assert TN.kv_cache_bytes(tc) == JN.kv_cache_bytes(jc) == 0
    g = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
         for k, v in tc["groups"][0].items()}
    pos = np.asarray([5, 9, 2], np.int32)
    jc = {"groups": ({k: jnp.asarray(v) for k, v in g.items()},),
          "pos": jnp.asarray(pos)}
    tc = {"groups": ({k: torch.from_numpy(v.copy()) for k, v in g.items()},),
          "pos": torch.from_numpy(pos.copy())}

    def same(t, j):
        np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
        for k in g:
            np.testing.assert_array_equal(t["groups"][0][k].numpy(),
                                          np.asarray(j["groups"][0][k]))

    assert tree_map(lambda _p, a: a.shape, tc) == jax.tree.map(
        lambda a: a.shape, jc, is_leaf=lambda a: hasattr(a, "shape"))
    src, dst = np.asarray([3, 5], np.int32), np.asarray([9, 3], np.int32)
    tc = TN.copy_paged_blocks(tc, torch.from_numpy(src),
                              torch.from_numpy(dst))
    same(tc, JN.copy_paged_blocks(jc, jnp.asarray(src), jnp.asarray(dst)))
    jc, tc = JN.reset_slot_state(jc, 1, 0), TN.reset_slot_state(tc, 1, 0)
    same(tc, jc)
    ids = np.asarray([2, 0], np.int32)
    jv = JN.gather_slot_view(jc, jnp.asarray(ids))
    tv = TN.gather_slot_view(tc, torch.from_numpy(ids))
    same(tv, jv)
    jv = jax.tree.map(lambda a: a + 1, jv)
    tv = tree_map(lambda _p, a: a + 1, tv)
    same(TN.scatter_slot_view(tc, tv, torch.from_numpy(ids)),
         JN.scatter_slot_view(jc, jv, jnp.asarray(ids)))
    assert TN._first_pos_leaf(tv).tolist() == [3, 6]


def test_bridge_maps_every_mamba_leaf(mamba):
    _jcfg, params, tcfg = mamba
    tp = bridge.from_jax_params(params, tcfg, device="cpu")
    flat_ref = jax.tree_util.tree_leaves(params)
    flat_port = []
    tree_map(lambda _p, a: flat_port.append(a), tp)
    assert len(flat_port) == len(flat_ref)
    m = tp["blocks"][0]["mamba"]
    assert sorted(m) == ["A_log", "D", "conv_b", "conv_w", "dt_bias",
                         "in_proj", "norm", "out_proj"]
    np.testing.assert_array_equal(m["in_proj"].numpy(),
                                  params["blocks"][0]["mamba"]["in_proj"])
    assert set(tp) == {"embed", "final_norm", "lm_head", "blocks"}
    extra = dict(params, blocks=({**params["blocks"][0],
                                  "ln2": params["blocks"][0]["ln1"]},))
    with pytest.raises(KeyError, match="no port counterpart"):
        bridge.from_jax_params(extra, tcfg, device="cpu")


def test_scheduled_engine_serves_with_degenerate_dims(mamba):
    """d_ff == 0 (the full-width config's, no MLP): the engine skips the
    MLP GEMM shapes instead of handing K = 0 to the §5 cost model, and
    serves under the scheduled backend."""
    _jcfg, _params, tcfg = mamba
    cfg = with_backend(dataclasses.replace(tcfg, d_ff=0), "scheduled")
    eng = ContinuousEngine(cfg, TN.init(cfg, 0, "cpu"), slots=2,
                           max_len=64, audit=True, device="cpu")
    res = eng.run([Request(i, np.arange(3, 3 + n, dtype=np.int32), 3,
                           eos=-1) for i, n in enumerate((4, 37))])
    assert [len(r.tokens) for r in res] == [3, 3]
    assert all(r.status == "ok" for r in res)
    assert all(min(key[:3]) > 0 for key in eng.schedule._entries)
