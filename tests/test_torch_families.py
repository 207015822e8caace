"""Port parity: qwen1.5-4b, chatglm3-6b, gemma2-9b, llava-next (its text
path) and zamba2-7b through the paged serving functions and the paged
engine, against the reference with the same weights (its
``network.init`` through ``bridge.from_jax_params``).

Each arch runs at ``scaled_down()`` in fp32.  gemma2 and llava run with
``local_window`` 16, so that the window bites in chunks and in decode;
``FAMILY_SCALES`` (``tests/_family_scales.py``, shared with
``chip_smoke.py``) gives the weight scale at which each arch's greedy
streams vary (as ``WEIGHT_SCALE`` does for qwen2).

  * Two prefill chunks, two decode steps and a verify call give the
    reference's fp32 logits within 1e-4 (the GEMM bound of
    ``tests/test_torch_network.py``) with the same argmax, its cursors
    exactly and its recurrent state within the same bound, under both
    GEMM backends of the port.
  * The paged engine's greedy tokens equal the reference engine's for
    every arch; all five reference engines run in one fresh process, with
    a copy of the host arrays for each dispatch (the reference's race,
    ``tests/test_torch_serving_paths.py``).
  * gemma2 under ngram speculation gives its vanilla tokens; a zamba2
    request preempted and resumed (re-prefilled from token 0) gives the
    tokens of a run that never preempts.
  * Every reference leaf maps through the bridge; the cache utilities
    match the reference's on zamba2's hybrid tree, tail leaves included;
    K1's window rule and ``_flash``'s agree where the window first bites.
"""

import dataclasses
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import network as JN
from repro_torch import configs as TC
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import attention as TA
from repro_torch.models import bridge
from repro_torch.models import network as TN
from repro_torch.models.config import MLAConfig, MoEConfig
from repro_torch.models.layers import tree_map
from repro_torch.serving.engine import ContinuousEngine, Request
from _family_scales import ARCHS, FAMILY_SCALES, WINDOW, family_config
from _torch_port import run_reference, with_backend

TOL = dict(rtol=1e-4, atol=1e-4)
SLOTS, NB, BS = 3, 24, 8
ENGINE = dict(slots=2, max_len=64, prefill_chunk=16)
PROMPT_LENS, MAX_NEW = (7, 30, 45), 10
ROOT = Path(__file__).resolve().parents[1]


def family_params(arch: str):
    """(jax config, numpy params, port config) of the scaled-down arch,
    the reference's init at ``FAMILY_SCALES``."""
    jcfg = family_config(JC, arch)
    emb, rest = FAMILY_SCALES[arch]
    raw = JN.init(jcfg, jax.random.PRNGKey(0))
    params = {k: jax.tree.map(lambda a, s=(emb if k == "embed" else rest):
                              np.asarray(a) * np.float32(s), v)
              for k, v in raw.items()}
    return jcfg, params, family_config(TC, arch)


_REFERENCE = """
from repro.serving.engine import ContinuousEngine, Request
from test_torch_families import ARCHS, ENGINE, MAX_NEW, family_params, prompts
out = {}
for arch in ARCHS:
    jcfg, params, _ = family_params(arch)
    eng = ContinuousEngine(jcfg, jax.tree.map(jnp.asarray, params),
                           audit=True, **ENGINE)
    res = eng.run([Request(i, p, MAX_NEW, eos=-1)
                   for i, p in enumerate(prompts(jcfg.vocab))])
    out[arch] = {"tokens": {r.rid: r.tokens.tolist() for r in res},
                 "steps": [eng.steps, eng.chunk_steps]}
print(json.dumps(out))
"""


def prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def reference_runs():
    runs = run_reference(_REFERENCE, ROOT, one_thread=False)
    for ref in runs.values():
        ref["tokens"] = {int(k): v for k, v in ref["tokens"].items()}
    return runs


_FAMILIES: dict = {}


def family(arch):
    """(jax config, numpy params, port config, port params), built once."""
    if arch not in _FAMILIES:
        jcfg, params, tcfg = family_params(arch)
        _FAMILIES[arch] = (jcfg, params, tcfg,
                           bridge.from_jax_params(params, tcfg, "cpu"))
    return _FAMILIES[arch]


def _np(x):
    return np.asarray(x, np.float32)


def test_registry_and_supported_families():
    for arch in ARCHS:
        cfg = TC.get(arch)
        assert arch in TC.ARCH_IDS
        assert TC.get(cfg.name) == cfg               # the dashed alias
        TN.param_defs(cfg)                           # supported
    base = TC.get("qwen2_0_5b")
    # the frames frontend (hubert, trained by tests/test_torch_train.py)
    # has no embedding table: frame_proj and an untied head
    frames = TN.param_defs(dataclasses.replace(base, frontend="frames"))
    assert "embed" not in frames
    assert frames["lm_head"].shape == (base.vocab, base.d_model)
    assert frames["frame_proj"]["w"].shape == (base.d_model, base.d_model)
    # MLA and a dense first layer are served (tests/test_torch_mla.py)
    mla = TN.param_defs(dataclasses.replace(base, mla=MLAConfig(),
                                            first_layer_dense_ff=256))
    assert "wkv_a" in mla["blocks"][0]["attn"]
    assert mla["first_block"]["mlp"]["wi_up"].shape == (base.d_model, 256)
    # MoE blocks are served (tests/test_torch_moe.py)
    moe = TN.param_defs(dataclasses.replace(base, moe=MoEConfig(8, 2, 128)))
    assert "moe" in moe["blocks"][0] and "mlp" not in moe["blocks"][0]


@pytest.mark.parametrize("arch", ARCHS + ("llama4_scout_17b_a16e",
                                          "deepseek_v2_236b"))
def test_serve_cli_serves_each_arch(arch, capsys):
    """``launch/serve.py --arch <dashed id> --scaled-down --device cpu``
    serves every request; so does ``--quant`` on zamba2 (SSM state, int8
    KV at its shared attention), on llama4 (MoE) and on deepseek-v2 (its
    latent pool stays in the compute dtype), under both backends."""
    from repro_torch.launch import serve
    argv = ["--arch", TC.get(arch).name, "--scaled-down", "--device",
            "cpu", "--requests", "3", "--prompt-len", "24", "--max-new",
            "4", "--slots", "2", "--max-len", "64"]
    report = serve.main(argv)
    assert report["ok"] == report["requests"] == 3
    assert f"[serve:{TC.get(arch).name} xla on cpu]" in capsys.readouterr().out
    if arch in ("zamba2_7b", "llama4_scout_17b_a16e", "deepseek_v2_236b"):
        mla = arch == "deepseek_v2_236b"
        for backend in ("xla", "scheduled"):
            report = serve.main(argv + ["--quant", "--gemm-backend",
                                        backend])
            assert report["ok"] == report["requests"] == 3
            assert report["kv_quantized"] == int(not mla)
            out = capsys.readouterr().out
            assert ("int8 KV blocks" in out) is not mla
            assert ("+ fp KV" in out) is mla
            assert f"[serve:{TC.get(arch).name}+int8 {backend} on cpu]" in out


def test_port_configs_equal_reference_field_for_field():
    for arch in ARCHS:
        j, t = JC.get(arch), TC.get(arch)
        for f in dataclasses.fields(j):
            a, b = getattr(j, f.name), getattr(t, f.name)
            if hasattr(a, "value"):                  # enums: by value
                a, b = a.value, b.value
            elif isinstance(a, tuple):
                a = tuple(getattr(x, "value", x) for x in a)
                b = tuple(getattr(x, "value", x) for x in b)
            elif dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (arch, f.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_maps_every_leaf(arch):
    _jcfg, params, tcfg, tp = family(arch)
    ref, port = _leaves(params), _leaves(tp)
    assert set(port) == set(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(port[path], leaf)
    want = {"qwen1_5_4b": ["lm_head"], "chatglm3_6b": ["lm_head"],
            "gemma2_9b": [("blocks", 0, "post_ln1"),
                          ("blocks", 1, "post_ln2")],
            "llava_next_mistral_7b": ["lm_head", ("vision_proj", "w")],
            "zamba2_7b": [("shared_attn", "attn", "wq"),
                          ("tail_blocks", 2, "mamba", "in_proj"),
                          ("blocks", 5, "ln1")]}[arch]
    for p in want:
        assert (p if isinstance(p, tuple) else (p,)) in port


def _paged_run(mod, params, cfg, t, *, verify_len=4):
    """Two ragged prefill chunks, two decode steps and one verify call
    over the same tables; returns the logits and caches after each."""
    rng = np.random.default_rng(4)
    tables = np.zeros((SLOTS, 7), np.int32)
    tables[0, :7] = [3, 7, 1, 12, 4, 6, 10]
    tables[1, :4] = [5, 2, 9, 11]         # slot 2 rides along empty (NULL)
    L = 20
    lens = np.asarray([20, 11, 0], np.int32)
    ids = np.arange(SLOTS, dtype=np.int32)
    caches = mod.expand_cache_pos(
        mod.init_paged_caches(cfg, SLOTS, NB, BS, **(
            {"device": "cpu"} if mod is TN else {})), SLOTS)
    out = []
    for _ in range(2):
        toks = rng.integers(3, cfg.vocab, (SLOTS, L)).astype(np.int32)
        logits, caches = mod.prefill_paged_chunk(
            params, cfg, t(toks), caches, t(ids), t(tables), t(lens),
            t(np.maximum(lens - 1, 0)))
        out.append(("chunk", _np(logits), lens > 0))
    pos = np.asarray(mod._first_pos_leaf(caches)).astype(np.int32)
    adv = np.asarray([1, 1, 0], np.int32)
    for _ in range(2):
        toks = rng.integers(3, cfg.vocab, (SLOTS, 1)).astype(np.int32)
        logits, caches = mod.decode_step(params, cfg, t(toks), caches,
                                         t(pos), t(tables), t(adv))
        pos = pos + adv
        out.append(("decode", _np(logits), adv > 0))
    toks = rng.integers(3, cfg.vocab, (SLOTS, verify_len)).astype(np.int32)
    vlens = np.asarray([verify_len, 2, 0], np.int32)
    logits, caches = mod.verify_paged_chunk(params, cfg, t(toks), caches,
                                            t(ids), t(tables), t(vlens))
    out.append(("verify", _np(logits), vlens > 0))
    return out, caches


def _leaves(caches):
    """{path: numpy leaf} of a port (torch) or a reference (jax) tree."""
    if isinstance(jax.tree_util.tree_leaves(caches)[0], torch.Tensor):
        flat = {}
        tree_map(lambda path, a: flat.__setitem__(path, a.numpy()), caches)
        return flat
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(caches)}


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_functions_match_reference(arch):
    jcfg, params, tcfg, _tp = family(arch)
    ref, jc = _paged_run(JN, jax.tree.map(jnp.asarray, params), jcfg,
                         jnp.asarray)
    jflat = _leaves(jc)
    for backend in ("xla", "scheduled"):
        cfg = with_backend(tcfg, backend)
        got, tc = _paged_run(TN, bridge.from_jax_params(params, cfg, "cpu"),
                             cfg, torch.from_numpy)
        for (kind, tl, live), (_k, jl, _l) in zip(got, ref):
            np.testing.assert_allclose(tl[live], jl[live], **TOL,
                                       err_msg=f"{backend} {kind}")
            np.testing.assert_array_equal(tl[live].argmax(-1),
                                          jl[live].argmax(-1))
        tflat = _leaves(tc)
        assert set(tflat) == set(jflat)
        for path, a in tflat.items():
            b = jflat[path]
            if "pos" in path:
                np.testing.assert_array_equal(a, b)
            elif path[-1] in ("conv", "ssm"):
                np.testing.assert_allclose(a, b, **TOL, err_msg=str(path))
            else:                   # pools: the NULL block 0 holds pads
                ax = 1 if path[0] == "groups" else 0
                np.testing.assert_allclose(
                    np.take(a, range(1, NB), ax), np.take(b, range(1, NB), ax),
                    **TOL, err_msg=str(path))


def test_qwen1_5_int8_matches_reference():
    """qwen1.5 quantized for serving (every projection and the untied
    head int8, int8 KV blocks): the head's payload crosses the bridge bit
    for bit and is stored once, as the (D, V) array K3 takes, and the
    paged functions give the reference's logits under both backends (the
    scheduled head runs K3's plain version on it, the scale folded into
    x; xla reads its transposed view)."""
    from repro.quant import policy as JQ
    from repro_torch.quant import policy as TQ
    jcfg, params, tcfg, tp = family("qwen1_5_4b")
    jcfg = dataclasses.replace(jcfg, quant_serving=True)
    jtree = JQ.serving_quant_params(jcfg, jax.tree.map(jnp.asarray, params),
                                    JQ.QuantPolicy(min_size=0))
    ref, _ = _paged_run(JN, jtree, jcfg, jnp.asarray)
    jhead = jtree["lm_head"]
    for backend in ("xla", "scheduled"):
        cfg = dataclasses.replace(with_backend(tcfg, backend),
                                  quant_serving=True)
        qp = TQ.serving_quant_params(cfg, tp, TQ.QuantPolicy(min_size=0))
        head = qp["lm_head"]
        np.testing.assert_array_equal(head.q.numpy(), np.asarray(jhead.q))
        np.testing.assert_array_equal(head.scale.numpy(),
                                      np.asarray(jhead.scale))
        # one payload, stored as the contiguous (D, V) array K3 takes
        assert isinstance(head, TQ.QuantHead) and head.q.t().is_contiguous()
        assert torch.equal(head.unit, torch.ones(head.q.shape[0]))
        bridged = TQ.serving_quant_params(cfg, bridge.from_jax_params(
            jax.tree.map(np.asarray, jtree), cfg, "cpu"))["lm_head"]
        assert bridged.q.t().is_contiguous()
        assert torch.equal(bridged.q, head.q)
        got, _ = _paged_run(TN, qp, cfg, torch.from_numpy)
        for (kind, tl, live), (_k, jl, _l) in zip(got, ref):
            np.testing.assert_allclose(tl[live], jl[live], **TOL,
                                       err_msg=f"{backend} {kind}")
            np.testing.assert_array_equal(tl[live].argmax(-1),
                                          jl[live].argmax(-1))


def test_hybrid_cache_utilities_match_reference():
    """zamba2's tree: MAMBA2 groups (slot axis 1), SHARED_ATTN pools and
    cursors, and the tail's per-slot state (slot axis 0)."""
    jcfg, _params, tcfg, _tp = family("zamba2_7b")
    rng = np.random.default_rng(6)
    jc = JN.expand_cache_pos(JN.init_paged_caches(jcfg, SLOTS, NB, BS),
                             SLOTS)
    filled = jax.tree.map(
        lambda a: (rng.integers(0, 40, a.shape) if a.dtype == jnp.int32
                   else rng.standard_normal(a.shape)).astype(a.dtype), jc)
    jc = jax.tree.map(jnp.asarray, filled)
    tc = tree_map(lambda _p, a: torch.from_numpy(np.array(a)),
                  jax.tree.map(np.asarray, filled))
    assert tc["tail"][0]["ssm"].shape[0] == SLOTS

    def same(t, j):
        tf, jf = _leaves(t), _leaves(j)
        assert set(tf) == set(jf)
        for path in tf:
            np.testing.assert_array_equal(tf[path], jf[path], str(path))

    src, dst = np.asarray([3, 5], np.int32), np.asarray([9, 3], np.int32)
    jc = JN.copy_paged_blocks(jc, jnp.asarray(src), jnp.asarray(dst))
    tc = TN.copy_paged_blocks(tc, torch.from_numpy(src),
                              torch.from_numpy(dst))
    same(tc, jc)
    jc, tc = JN.reset_slot_state(jc, 1, 16), TN.reset_slot_state(tc, 1, 16)
    same(tc, jc)
    assert not tc["tail"][2]["conv"][1].any()
    ids = np.asarray([2, 0], np.int32)
    jv = JN.gather_slot_view(jc, jnp.asarray(ids))
    tv = TN.gather_slot_view(tc, torch.from_numpy(ids))
    same(tv, jv)
    np.testing.assert_array_equal(TN._first_pos_leaf(tv).numpy(),
                                  np.asarray(JN._first_pos_leaf(jv)))
    jv = jax.tree.map(lambda a: a + 1, jv)
    tv = tree_map(lambda _p, a: a + 1, tv)
    same(TN.scatter_slot_view(tc, tv, torch.from_numpy(ids)),
         JN.scatter_slot_view(jc, jv, jnp.asarray(ids)))
    assert TN.kv_cache_bytes(tc) == JN.kv_cache_bytes(jc) > 0


@pytest.mark.parametrize("window", [WINDOW - 1, WINDOW, WINDOW + 1])
def test_decode_window_agrees_with_flash(window):
    """K1's rule ``(len - 1) - pos < window`` and ``_flash``'s ``qpos -
    kvpos < window`` at a query in position len - 1, for lengths on both
    sides of the window (the first position it drops is 0 at len =
    window + 1)."""
    rng = np.random.default_rng(2)
    B, KV, G, hd, bs = 3, 2, 2, 16, 8
    nbs = 4
    k = torch.from_numpy(rng.standard_normal((9, bs, KV, hd))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((9, bs, KV, hd))
                         .astype(np.float32))
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [2, 4, 6, 8]],
                         dtype=torch.int32)
    lens = torch.tensor([WINDOW, WINDOW + 1, 2 * WINDOW],
                        dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((B, KV, G, hd))
                         .astype(np.float32))
    dec = PA.gather_fallback(q, k, v, table, lens, scale=0.25,
                             window=window, logit_cap=50.0)
    fl = TA._flash(q[:, None], PA.gather_pool_blocks(k, table),
                   PA.gather_pool_blocks(v, table), scale=0.25,
                   causal=True, window=window, q_offset=lens - 1,
                   kv_valid=lens, logit_cap=50.0, block=bs)[:, 0]
    np.testing.assert_allclose(dec.numpy(), fl.numpy(), rtol=1e-5,
                               atol=1e-6)
    split = PA.split_decode_plain(q, k, v, table, lens, scale=0.25,
                                  blocks_per_split=1, window=window,
                                  logit_cap=50.0)
    np.testing.assert_allclose(split.numpy(), dec.numpy(), rtol=1e-5,
                               atol=1e-6)
    whole = PA.gather_fallback(q, k, v, table, lens, scale=0.25,
                               logit_cap=50.0)
    # the window drops position 0 exactly where len exceeds it
    bites = (lens > window).numpy()
    assert bites.any()
    differs = ~np.isclose(dec.numpy(), whole.numpy()).all(axis=(1, 2, 3))
    np.testing.assert_array_equal(differs, bites)
    assert nbs * bs >= int(lens.max())


def _engine_tokens(cfg, tp, **kw):
    eng = ContinuousEngine(cfg, tp, audit=True, device="cpu",
                           **{**ENGINE, **kw})
    res = eng.run([Request(i, p, MAX_NEW, eos=-1)
                   for i, p in enumerate(prompts(cfg.vocab))])
    assert all(r.status == "ok" for r in res)
    return eng, {r.rid: r.tokens.tolist() for r in res}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_reference(reference_runs, arch):
    _jcfg, _params, cfg, tp = family(arch)
    eng, got = _engine_tokens(cfg, tp)
    ref = reference_runs[arch]
    assert got == ref["tokens"]
    assert [eng.steps, eng.chunk_steps] == ref["steps"]
    for toks in got.values():               # every stream varies
        assert len(set(toks)) > 3, got
    assert eng.pool.share_prefixes is (arch != "zamba2_7b")


def test_gemma2_ngram_spec_matches_vanilla(reference_runs):
    _jcfg, _params, cfg, tp = family("gemma2_9b")
    eng, got = _engine_tokens(cfg, tp, spec="ngram", spec_k=4)
    assert got == reference_runs["gemma2_9b"]["tokens"]
    assert eng.spec_drafted > 0


def test_zamba2_preempted_request_matches_unpreempted():
    """Two decoders hold both slots (the pool hosts both); an SLO'd
    request arrives and slo_preempt evicts one.  The victim resumes by
    re-prefilling its whole sequence (prompt and produced tokens) from
    token 0, which rebuilds its SSM state and its shared-attention KV."""
    _jcfg, _params, cfg, tp = family("zamba2_7b")
    ps = prompts(cfg.vocab)
    reqs = [Request(0, ps[1], 12, eos=-1), Request(1, ps[2], 12, eos=-1),
            Request(2, ps[0], 4, eos=-1, ttft_slo=1e-4)]

    def run(policy):
        eng = ContinuousEngine(cfg, tp, policy=policy, kv_blocks=16,
                               audit=True, device="cpu", **ENGINE)
        for r in reqs[:2]:
            eng.submit(dataclasses.replace(r))
        eng.step()
        eng.step()
        eng.submit(dataclasses.replace(reqs[2]))
        time.sleep(0.01)
        res = []
        while len(res) < len(reqs):
            eng.step()
            res += eng.drain_results()
        return eng, {r.rid: r.tokens.tolist() for r in res}

    pre, got = run("slo_preempt")
    fifo, want = run("fifo")
    assert pre.preemptions > 0 and pre.resumes == pre.preemptions
    assert fifo.preemptions == 0
    assert pre.pool.stats()["shared_token_hits"] == 0    # re-prefilled
    assert got == want
    assert len({t for v in got.values() for t in v}) > 8
