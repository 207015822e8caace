"""Port parity: MLA (``repro_torch.models.attention.mla_attention``), the
dense first block and deepseek-v2 through the paged, dense and wave
engines, against ``repro.models`` and the reference's engines with the
same weights.

deepseek-v2 runs at ``scaled_down()`` (MLA r 32, rope 16, nope 32, v 32;
8 experts top-2 with 2 shared; a dense first block of 256; 2 MoE layers)
in fp32, its init weights times ``SCALE``.

  * The config equals the reference's field for field, ``scaled_down()``
    included; ``param_defs`` yields the reference's leaf paths and shapes
    (``first_block`` included) and the bridge carries every leaf, also of
    a tree the reference has already quantized.  Cache trees (``"first"``
    unstacked, latent leaves), the tree utilities and ``kv_cache_bytes``
    equal the reference's.
  * ``mla_attention`` on each layout (the full sequence, dense stripes,
    the paged pool) gives the reference's outputs and cache leaves within
    1e-4; the absorbed decode gives the decompressed forward's output at
    the same position.  ``forward``, two prefill chunks, two decode steps
    and a verify call give the reference's logits within 1e-4 with the
    same argmax, fp and int8, under both GEMM backends.
  * The paged, dense and wave engines give the reference engines' greedy
    tokens, fp and int8 (int8 against int8), under both backends; the
    paged trace shares a prompt prefix (shared-token hits equal the
    reference's), and ngram speculation, a preempted and resumed request,
    a snapshot restored on a fresh engine and a copy-on-write fork forced
    at admission (the copy must move the latent blocks of every layer)
    give the same tokens.  The schedule statistics of an engine equal
    the reference's.
  * ``step_cost`` of deepseek's dispatches, ``dispatch_gemm_shapes`` and
    the planner's ``WorkloadModel`` against the reference's jaxpr count,
    shapes and model.

The reference's half runs in ONE fresh process (engines, with a copy of
the host arrays for each dispatch and XLA's CPU matmuls on one thread,
and the jitted paged functions), started by the file's first test and
running beside the in-process tests; it reads the weights this process
built and writes its arrays to an ``.npz``.
"""

import dataclasses
import json
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
from repro_torch.models import attention as TA
from repro_torch.models import bridge
from repro_torch.models import network as TN
from repro_torch.models.layers import tree_map
from repro_torch.quant import policy as TQ
from repro_torch.serving.engine import ContinuousEngine, Request, WaveEngine
from _cow_fork import forced_forks
from _family_scales import FAMILY_SCALES
from _torch_port import int8_paths, reference_process, with_backend
from test_torch_families import _leaves, _paged_run

ARCH = "deepseek_v2_236b"
#: x4 (``FAMILY_SCALES``, which chip_smoke.py reads too): every greedy
#: stream varies (9-10 distinct tokens of 10)
SCALE = FAMILY_SCALES[ARCH][1]
TOL = dict(rtol=1e-4, atol=1e-4)
#: 16 blocks: the shared prefix stays cached until rid 2 admits
ENGINE = dict(slots=2, max_len=64, prefill_chunk=16, kv_blocks=16)
MAX_NEW = 10
ROOT = Path(__file__).resolve().parents[1]


def mla_params():
    """(jax config, numpy params, port config): the scaled-down arch at
    the reference's init (jitted: a third of the eager init's time, other
    draws) times ``SCALE``."""
    jcfg = JC.get(ARCH).scaled_down()
    init = jax.jit(JN.init, static_argnums=0)
    params = jax.tree.map(lambda a: np.asarray(a) * np.float32(SCALE),
                          init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, params, TC.get(ARCH).scaled_down()


def prompts(vocab):
    """rid 0 and rid 2 share a 20-token prefix (one full block of 16);
    rid 2 admits after rid 0's first token, so the block is shared."""
    rng = np.random.default_rng(0)
    pre = rng.integers(3, vocab, 20)
    tails = [rng.integers(3, vocab, n) for n in (5, 30, 17, 7)]
    out = [np.concatenate([pre, tails[0]]), tails[1],
           np.concatenate([pre, tails[2]]), tails[3]]
    return [p.astype(np.int32) for p in out]


def requests(vocab):
    return [Request(i, p, MAX_NEW, eos=-1)
            for i, p in enumerate(prompts(vocab))]


def attn_case(cfg, seed: int = 3):
    """(x (2, 12, D), decode x (2, 1, D)) for the layer-level cases."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    return x, xd


#: the paged layout of the layer-level case: 2 rows, pool of 6 blocks of 8
ATTN_TABLE = np.asarray([[3, 1, 5], [2, 4, 0]], np.int32)


def mla_layouts(A, p, cfg, t, x, xd, make_pool, make_stripes):
    """``mla_attention`` (module ``A``) on the three layouts: the full
    sequence, dense stripes (prefill of x, then a decode step of xd) and
    the paged pool (the same, through ``ATTN_TABLE``).  Returns
    {name: array-like}."""
    out = {}
    full, _ = A.mla_attention(p, t(x), cfg)
    out["full"] = full
    cache = make_stripes()
    y, cache = A.mla_attention(p, t(x), cfg, pos_offset=0, cache=cache)
    out["stripes_prefill"] = y
    y, cache = A.mla_attention(p, t(xd), cfg, pos_offset=cache["pos"],
                               cache=cache)
    out["stripes_decode"] = y
    out["stripes_c_kv"], out["stripes_k_pe"] = cache["c_kv"], cache["k_pe"]
    pool = make_pool()
    bt = t(ATTN_TABLE)
    lens = np.asarray([12, 9], np.int32)
    y, pool = A.mla_attention(p, t(x), cfg, pos_offset=t(np.zeros(2,
                              np.int32)), cache=pool, block_table=bt,
                              pos_advance=t(lens))
    out["paged_prefill"] = y
    y, pool = A.mla_attention(p, t(xd), cfg, pos_offset=t(lens),
                              cache=pool, block_table=bt,
                              pos_advance=t(np.ones(2, np.int32)))
    out["paged_decode"] = y
    out["paged_c_kv"], out["paged_k_pe"] = pool["c_kv"], pool["k_pe"]
    return out


_REFERENCE = """
from repro.models import attention as JA
from repro.models import network as JN
from repro.quant import QuantPolicy
from repro.quant import policy as JQ
from repro.serving.engine import ContinuousEngine, Request, WaveEngine
from test_torch_mla import (ENGINE, attn_case, mla_layouts, requests)
from test_torch_families import _leaves, _paged_run
from repro import configs as JC
jcfg = JC.get("deepseek_v2_236b").scaled_down()
z = np.load({params!r})
flat = [z[f"a{{i}}"] for i in range(len(z.files))]
tdef = jax.tree_util.tree_structure(JN.param_defs(jcfg),
                                    is_leaf=lambda d: hasattr(d, "axes"))
params = jax.tree.map(jnp.asarray, jax.tree_util.tree_unflatten(tdef, flat))
arrays, out = {{}}, {{}}
for quant in (False, True):
    cfg = dataclasses.replace(jcfg, quant_serving=quant).validate()
    tag = "int8" if quant else "fp"
    paged = ContinuousEngine(cfg, params, audit=True,
                             quant_policy=QuantPolicy(min_size=0), **ENGINE)
    res = paged.run(requests(cfg.vocab))
    dense = ContinuousEngine(cfg, params, paged=False,
                             quant_policy=QuantPolicy(min_size=0), **{{
                                 k: v for k, v in ENGINE.items()
                                 if k in ("slots", "max_len")}})
    dres = dense.run(requests(cfg.vocab))
    if not quant:   # the wave quantizes nothing: its int8 run is this one
        wave = WaveEngine(cfg, params, slots=ENGINE["slots"],
                          max_len=ENGINE["max_len"])
        wres = wave.run(requests(cfg.vocab))
    st = paged.pool.stats()
    out[tag] = {{
        "paged": {{r.rid: r.tokens.tolist() for r in res}},
        "steps": [paged.steps, paged.chunk_steps],
        "kv_allocated": paged.kv_bytes()["allocated"],
        "pool": {{k: st[k] for k in ("shared_token_hits", "cow_forks")}},
        "schedule": paged.schedule.stats(),
        "keys": sorted([list(k[:3]) + [k[3], v["hits"], v["misses"]]
                        for k, v in paged.schedule.key_stats().items()]),
        "dense": {{r.rid: r.tokens.tolist() for r in dres}},
        "dense_steps": dense.steps,
        "dense_kv": dense.kv_bytes()["allocated"],
        "wave": {{r.rid: r.tokens.tolist() for r in wres}},
        "wave_steps": wave.steps}}
# the paged functions, jitted
mod = types.SimpleNamespace(
    expand_cache_pos=JN.expand_cache_pos,
    init_paged_caches=JN.init_paged_caches,
    _first_pos_leaf=JN._first_pos_leaf,
    prefill_paged_chunk=jax.jit(JN.prefill_paged_chunk, static_argnums=1),
    decode_step=jax.jit(JN.decode_step, static_argnums=1),
    verify_paged_chunk=jax.jit(JN.verify_paged_chunk, static_argnums=1))
for quant in (False, True):
    cfg = dataclasses.replace(jcfg, quant_serving=quant)
    tree = params
    if quant:
        tree = JQ.serving_quant_params(cfg, tree, QuantPolicy(min_size=0))
    got, caches = _paged_run(mod, tree, cfg, jnp.asarray)
    tag = "int8" if quant else "fp"
    for i, (_kind, logits, _live) in enumerate(got):
        arrays[f"paged_{{tag}}_{{i}}"] = logits
    for path, a in _leaves(caches).items():
        arrays[f"cache_{{tag}}_" + "/".join(map(str, path))] = a
arrays["forward"] = np.asarray(jax.jit(JN.forward, static_argnums=1)(
    params, jcfg, {{"tokens": jnp.asarray(
        np.random.default_rng(5).integers(3, jcfg.vocab, (2, 24))
        .astype(np.int32))}})[0])
# mla_attention on each layout (layer 0 of the groups), jitted
p0 = jax.tree.map(lambda a: a[0], params["blocks"][0]["attn"])
x, xd = attn_case(jcfg)
JAJ = types.SimpleNamespace(
    mla_attention=jax.jit(JA.mla_attention, static_argnums=2))
lay = mla_layouts(JAJ, p0, jcfg, jnp.asarray, x, xd,
                  lambda: dict(JA.make_paged_kv_cache(jcfg, 6, 8,
                               jnp.float32), pos=jnp.zeros(2, jnp.int32)),
                  lambda: JA.make_kv_cache(jcfg, 2, 16, jnp.float32))
for k, v in lay.items():
    arrays["attn_" + k] = np.asarray(v)
np.savez({result!r}, **arrays)
print(json.dumps(out))
"""


_MODEL: list = []


def model():
    """(jax config, numpy params, port config, port params), built once."""
    if not _MODEL:
        jcfg, params, tcfg = mla_params()
        _MODEL.extend([jcfg, params, tcfg,
                       bridge.from_jax_params(params, tcfg, "cpu")])
    return tuple(_MODEL)


@pytest.fixture(scope="module", autouse=True)
def reference_proc(tmp_path_factory):
    """The reference's process, started with the file's first test on the
    weights built here (saved in tree order), running beside the
    in-process tests."""
    jcfg, params, _tcfg, _tp = model()
    tmp = tmp_path_factory.mktemp("mla")
    leaves = jax.tree_util.tree_leaves(params)
    np.savez(tmp / "params.npz", **{f"a{i}": a for i, a in
                                     enumerate(leaves)})
    code = _REFERENCE.format(params=str(tmp / "params.npz"),
                             result=str(tmp / "result.npz"))
    for proc in reference_process(code, ROOT):
        proc.result_path = tmp / "result.npz"
        yield proc


_RUNS: dict = {}


def reference(proc):
    """(engine runs by "fp" / "int8", arrays of the reference's half)."""
    if not _RUNS:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        runs = json.loads(out.strip().splitlines()[-1])
        for run in runs.values():
            for key in ("paged", "dense", "wave"):
                run[key] = {int(k): v for k, v in run[key].items()}
        _RUNS["runs"] = runs
        with np.load(proc.result_path) as z:
            _RUNS["arrays"] = {k: z[k] for k in z.files}
    return _RUNS["runs"], _RUNS["arrays"]


def _fields_equal(j, t):
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if hasattr(a, "value"):
            a, b = a.value, b.value
        elif isinstance(a, tuple):
            a = tuple(getattr(x, "value", x) for x in a)
            b = tuple(getattr(x, "value", x) for x in b)
        elif dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name


def test_config_equals_reference_field_for_field():
    j, t = JC.get(ARCH), TC.get(ARCH)
    assert ARCH in TC.ARCH_IDS and TC.get("deepseek-v2-236b") == t
    _fields_equal(j, t)
    _fields_equal(j.scaled_down(), t.scaled_down())
    assert t.mla.kv_lora_rank + t.mla.qk_rope_head_dim == 576
    assert not t.quant_kv and not dataclasses.replace(
        t, quant_serving=True).quant_kv


def _def_shapes(defs):
    out = {}
    tree_map(lambda path, d: out.__setitem__(path, d.shape), defs)
    return out


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "full"])
def test_param_defs_match_reference(scaled):
    j, t = JC.get(ARCH), TC.get(ARCH)
    if scaled:
        j, t = j.scaled_down(), t.scaled_down()
    ref = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
           d.shape for path, d in jax.tree_util.tree_leaves_with_path(
               JN.param_defs(j), is_leaf=lambda d: hasattr(d, "axes"))}
    port = _def_shapes(TN.param_defs(t))
    assert port == ref
    first = TN.param_defs(t)["first_block"]
    assert set(first) == {"ln1", "ln2", "attn", "mlp"}
    assert first["mlp"]["wi_gate"].shape == (t.d_model,
                                             t.first_layer_dense_ff)
    assert set(first["attn"]) == {"wq_a", "q_norm", "wq_b", "wkv_a",
                                  "kv_norm", "wk_b", "wv_b", "wo"}


def test_bridge_carries_first_block_and_latent_leaves():
    _jcfg, params, tcfg, tp = model()
    ref, port = _leaves(params), _leaves(tp)
    assert set(port) == set(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(port[path], leaf)
    for path in (("first_block", "mlp", "wi_up"),
                 ("first_block", "attn", "wkv_a"),
                 ("blocks", 0, "attn", "kv_norm"),
                 ("blocks", 0, "moe", "shared", "wo"), ("lm_head",)):
        assert path in port


def test_bridge_carries_a_reference_quantized_tree():
    """``serving_quant_params`` on the reference's side: wq_b, wk_b, wv_b,
    wo, the shared experts and the first block's MLP cross as the port's
    QuantTensors bit for bit, and the port's own rewrite picks the same
    leaves with the same payloads."""
    from repro.quant import policy as JQ
    jcfg, params, tcfg, tp = model()
    jcfg = dataclasses.replace(jcfg, quant_serving=True)
    tcfg = dataclasses.replace(tcfg, quant_serving=True)
    jq = JQ.serving_quant_params(jcfg, jax.tree.map(jnp.asarray, params),
                                 JQ.QuantPolicy(min_size=0))
    carried = bridge.from_jax_params(jax.tree.map(np.asarray, jq), tcfg,
                                     "cpu")
    own = TQ.serving_quant_params(tcfg, tp, TQ.QuantPolicy(min_size=0))
    want = int8_paths(jq, JQ.QuantTensor)
    assert int8_paths(carried, TQ.QuantTensor) == want
    assert int8_paths(own, TQ.QuantTensor) == want
    attn = ("blocks", 0, "attn")
    assert {attn + (k,) for k in ("wq_b", "wk_b", "wv_b", "wo")} <= want
    assert ("first_block", "mlp", "wi_gate") in want
    assert attn + ("wq_a",) not in want and attn + ("wkv_a",) not in want
    for k in ("router", "wi_gate"):
        assert ("blocks", 0, "moe", k) not in want
    for path in want:
        a = carried
        b = own
        for key in path:
            a, b = a[key], b[key]
        np.testing.assert_array_equal(a.q.numpy(), b.q.numpy())
        np.testing.assert_array_equal(a.scale.numpy(), b.scale.numpy())


def _filled(jc, seed):
    """The reference cache tree ``jc`` filled with random values, as
    (jax tree, port tree)."""
    rng = np.random.default_rng(seed)
    filled = jax.tree.map(
        lambda a: (rng.integers(0, 40, a.shape) if a.dtype == jnp.int32
                   else rng.standard_normal(a.shape)).astype(a.dtype), jc)
    return (jax.tree.map(jnp.asarray, filled),
            tree_map(lambda _p, a: torch.from_numpy(np.array(a)),
                     jax.tree.map(np.asarray, filled)))


def _same(t, j):
    tf, jf = _leaves(t), _leaves(j)
    assert set(tf) == set(jf)
    for path in tf:
        np.testing.assert_array_equal(tf[path], jf[path], str(path))


def test_cache_utilities_match_reference():
    """The paged tree (``"first"`` unstacked, latent pools) through
    ``copy_paged_blocks`` (the COW fork), ``reset_slot_state``, the slot
    views, ``_first_pos_leaf`` and ``kv_cache_bytes``; the dense tree
    through ``insert_slot_caches``."""
    jcfg, _params, tcfg, _tp = model()
    slots, nb, bs = 3, 12, 8
    jc = JN.expand_cache_pos(JN.init_paged_caches(jcfg, slots, nb, bs),
                             slots)
    tc0 = TN.expand_cache_pos(TN.init_paged_caches(tcfg, slots, nb, bs,
                                                   device="cpu"), slots)
    assert {p: a.shape for p, a in _leaves(tc0).items()} \
        == {p: a.shape for p, a in _leaves(jc).items()}
    assert tc0["first"]["c_kv"].shape == (nb, bs, 32)
    assert tc0["first"]["pos"].shape == (slots,)
    assert TN.kv_cache_bytes(tc0) == JN.kv_cache_bytes(jc) \
        == (1 + tcfg.n_groups_scan) * nb * bs * (32 + 16) * 4
    jc, tc = _filled(jc, 6)
    src, dst = np.asarray([3, 5], np.int32), np.asarray([9, 3], np.int32)
    jc = JN.copy_paged_blocks(jc, jnp.asarray(src), jnp.asarray(dst))
    tc = TN.copy_paged_blocks(tc, torch.from_numpy(src),
                              torch.from_numpy(dst))
    _same(tc, jc)
    jc, tc = JN.reset_slot_state(jc, 1, 16), TN.reset_slot_state(tc, 1, 16)
    _same(tc, jc)
    ids = np.asarray([2, 0], np.int32)
    jv = JN.gather_slot_view(jc, jnp.asarray(ids))
    tv = TN.gather_slot_view(tc, torch.from_numpy(ids))
    _same(tv, jv)
    np.testing.assert_array_equal(TN._first_pos_leaf(tv).numpy(),
                                  np.asarray(JN._first_pos_leaf(jv)))
    jv = jax.tree.map(lambda a: a + 1, jv)
    tv = tree_map(lambda _p, a: a + 1, tv)
    _same(TN.scatter_slot_view(tc, tv, torch.from_numpy(ids)),
          JN.scatter_slot_view(jc, jv, jnp.asarray(ids)))
    _same(TN.set_slot_pos(tc, torch.tensor([4, 5, 6], dtype=torch.int32)),
          JN.set_slot_pos(jc, jnp.asarray([4, 5, 6], jnp.int32)))
    # dense stripes: a batch-1 tree into slot 1
    jd = JN.expand_cache_pos(JN.init_caches(jcfg, slots, 16), slots)
    jd, td = _filled(jd, 7)
    j1, t1 = _filled(JN.init_caches(jcfg, 1, 16), 8)
    assert TN.kv_cache_bytes(td) == JN.kv_cache_bytes(jd)
    _same(TN.insert_slot_caches(td, t1, 1, 9),
          JN.insert_slot_caches(jd, j1, 1, 9))


def test_gather_gemm_shapes_and_dispatch_shapes_match_reference():
    from repro.kernels import paged_attention as JPA
    from repro.obs import profile as JPROF
    from repro_torch.kernels import paged_attention as TPA
    from repro_torch.obs import profile as TPROF
    for scaled in (True, False):
        jcfg, tcfg = JC.get(ARCH), TC.get(ARCH)
        if scaled:
            jcfg, tcfg = jcfg.scaled_down(), tcfg.scaled_down()
        for bs in (8, 16):
            assert TPA.gather_gemm_shapes(tcfg, bs) \
                == JPA.gather_gemm_shapes(jcfg, bs)
        for geom in (dict(slots=2, prefill_chunk=32, spec_k=4,
                          block_size=16),
                     dict(slots=8, prefill_chunk=256, spec_k=2,
                          block_size=32)):
            assert (TPROF.dispatch_gemm_shapes(tcfg, **geom)
                    == JPROF.dispatch_gemm_shapes(jcfg, **geom))
    full = TC.get(ARCH)
    assert TPA.gather_gemm_shapes(full, 16) == [(128, 16, 576),
                                                (128, 512, 16)]


GEOM = dict(slots=2, max_len=96, block_size=16, prefill_chunk=32, spec_k=4)


@pytest.mark.parametrize("backend", ["xla", "scheduled"])
def test_step_cost_matches_reference(backend):
    """deepseek's dispatches priced on fake tensors: the absorbed
    einsums, the decompression and the expert ``bmm``s are dots; flops
    within 1% of the reference's jaxpr count (its xla count).  Bytes: the
    head within 6%; a block dispatch within 6% of the reference's count
    less the two terms its scans charge on top of the dots (the port runs
    both as loops of views): the second read of the group weights (the
    first block lies outside the scan and is charged once) and, in each
    attention layer's ``_flash``, the KV blocks it scans over, padded to
    a block multiple (decompressed k and v in a chunk or verify step,
    ``[c_kv ; k_pe]`` and ``c_kv`` in the absorbed decode).  Raw, the
    ratio sits at 0.75-0.80."""
    from repro.analysis.jaxpr_lint import hot_dispatches as j_hot
    from repro.launch.jaxpr_cost import step_cost as j_cost
    from repro_torch.launch.step_cost import hot_dispatches, step_cost
    jcfg = JC.get(ARCH).scaled_down()
    ref = {name: j_cost(fn, *args)
           for name, fn, args in j_hot(jcfg, **GEOM)}
    cfg = with_backend(TC.get(ARCH).scaled_down(), backend)
    port = {name: step_cost(fn, *args)
            for name, fn, args in hot_dispatches(cfg, **GEOM)}
    assert set(port) == set(ref)
    blocks = sum(int(np.prod(d.shape)) * 4 for d in jax.tree.leaves(
        JN.param_defs(jcfg)["blocks"], is_leaf=lambda x: hasattr(x, "axes")))
    m, H = cfg.mla, cfg.n_heads
    block = cfg.attn_block_kv
    t_pad = -(-GEOM["max_len"] // block) * block     # the table, padded
    layers = 1 + cfg.n_groups_scan
    per_row = {"decode_step": 2 * m.kv_lora_rank + m.qk_rope_head_dim,
               "prefill_paged_chunk": H * (m.qk_nope_head_dim
                                          + m.qk_rope_head_dim
                                          + m.v_head_dim)}
    per_row["verify_paged_chunk"] = per_row["prefill_paged_chunk"]
    for name, c in port.items():
        assert c["flops"] == pytest.approx(ref[name]["flops"], rel=0.01), \
            name
        raw = c["bytes"] / ref[name]["bytes"]
        if name == "head_apply":
            assert 0.94 <= raw <= 1.06, name
            continue
        assert 0.74 <= raw <= 0.81, (name, raw)
        flash = layers * GEOM["slots"] * t_pad * per_row[name] * 4
        assert 0.94 <= c["bytes"] / (ref[name]["bytes"] - blocks - flash) \
            <= 1.06, (name, raw)


@pytest.mark.parametrize("precision", ["FP32", "BP16", "INT8"])
def test_workload_model_matches_reference(precision):
    """The planner's ``WorkloadModel`` on deepseek (its dispatches' GEMMs,
    the latent gather GEMMs among them): shapes, modeled cycles and
    traffic, and step costs equal the reference's, scaled down and (in
    bf16) at full width."""
    from repro.planner import model as JM
    from repro_torch.planner import model as TM
    cases = [(JC.get(ARCH).scaled_down(), TC.get(ARCH).scaled_down())]
    if precision == "BP16":
        cases.append((JC.get(ARCH), TC.get(ARCH)))
    for jcfg, tcfg in cases:
        geom = dict(slots=4, max_len=160, precision=precision, spec=True)
        ref = JM.WorkloadModel(jcfg, JM.EngineGeometry(**geom))
        port = TM.WorkloadModel(tcfg, TM.EngineGeometry(**geom))
        assert port.shapes == ref.shapes
        assert port.dispatch_cycles == ref.dispatch_cycles
        assert port.dispatch_traffic == ref.dispatch_traffic
        assert (dataclasses.asdict(port.step_costs())
                == dataclasses.asdict(ref.step_costs()))
        assert port.geom.pool_blocks == ref.geom.pool_blocks


# ---------------------------------------------------------------------------
# Against the reference process
# ---------------------------------------------------------------------------

def _port_layouts():
    _jcfg, _params, tcfg, tp = model()
    p0 = tree_map(lambda _p, a: a[0], tp["blocks"][0]["attn"])
    x, xd = attn_case(tcfg)
    return mla_layouts(
        TA, p0, tcfg, torch.from_numpy, x, xd,
        lambda: dict(TA.make_paged_kv_cache(tcfg, 6, 8, torch.float32,
                                            torch.device("cpu")),
                     pos=torch.zeros(2, dtype=torch.int32)),
        lambda: TA.make_kv_cache(tcfg, 2, 16, torch.float32,
                                 torch.device("cpu"))), tcfg, tp, x, xd


def test_mla_attention_layouts_match_reference(reference_proc):
    got, *_ = _port_layouts()
    _runs, arrays = reference(reference_proc)
    for k, v in got.items():
        want = arrays["attn_" + k]
        a = v.numpy()
        if k.startswith("paged_c") or k.startswith("paged_k"):
            a, want = a[1:], want[1:]          # block 0 holds pads
        np.testing.assert_allclose(a, want, **TOL, err_msg=k)


def test_absorbed_decode_equals_decompressed():
    """The absorbed decode step at position 12 (latent scores through
    wk_b, output through wv_b) against the decompressing full-sequence
    path over the 13 tokens, on stripes and on the pool."""
    got, tcfg, tp, x, xd = _port_layouts()
    p0 = tree_map(lambda _p, a: a[0], tp["blocks"][0]["attn"])
    whole = np.concatenate([x, xd], axis=1)
    full, _ = TA.mla_attention(p0, torch.from_numpy(whole), tcfg)
    np.testing.assert_allclose(got["stripes_decode"].numpy()[:, 0],
                               full.numpy()[:, 12], **TOL)
    np.testing.assert_allclose(got["paged_decode"].numpy()[0, 0],
                               full.numpy()[0, 12], **TOL)
    # row 1 holds 9 tokens: its decode is position 9 after x[:, :9]
    short = np.concatenate([x[1:, :9], xd[1:]], axis=1)
    full1, _ = TA.mla_attention(p0, torch.from_numpy(short), tcfg)
    np.testing.assert_allclose(got["paged_decode"].numpy()[1, 0],
                               full1.numpy()[0, 9], **TOL)


def test_forward_matches_reference(reference_proc):
    _jcfg, _params, tcfg, tp = model()
    toks = np.random.default_rng(5).integers(3, tcfg.vocab, (2, 24)) \
        .astype(np.int32)
    got = TN.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _runs, arrays = reference(reference_proc)
    np.testing.assert_allclose(got.numpy(), arrays["forward"], **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_functions_match_reference(reference_proc, quant):
    _jcfg, _params, tcfg, tp = model()
    _runs, arrays = reference(reference_proc)
    tag = "int8" if quant else "fp"
    for backend in ("xla", "scheduled"):
        cfg = dataclasses.replace(with_backend(tcfg, backend),
                                  quant_serving=quant)
        tree = (TQ.serving_quant_params(cfg, tp, TQ.QuantPolicy(min_size=0))
                if quant else tp)
        got, tc = _paged_run(TN, tree, cfg, torch.from_numpy)
        for i, (kind, tl, live) in enumerate(got):
            jl = arrays[f"paged_{tag}_{i}"]
            np.testing.assert_allclose(tl[live], jl[live], **TOL,
                                       err_msg=f"{backend} {kind}")
            np.testing.assert_array_equal(tl[live].argmax(-1),
                                          jl[live].argmax(-1))
        for path, a in _leaves(tc).items():
            b = arrays[f"cache_{tag}_" + "/".join(map(str, path))]
            if "pos" in path:
                np.testing.assert_array_equal(a, b)
            else:                   # the NULL block 0 holds pads
                ax = 1 if path[0] == "groups" else 0
                np.testing.assert_allclose(
                    np.take(a, range(1, a.shape[ax]), ax),
                    np.take(b, range(1, b.shape[ax]), ax), **TOL,
                    err_msg=str(path))


def _engine(cfg, tp, **kw):
    return ContinuousEngine(cfg, tp, audit=True, device="cpu",
                            quant_policy=TQ.QuantPolicy(min_size=0),
                            **{**ENGINE, **kw})


def _tokens(res):
    assert all(r.status == "ok" for r in res)
    return {r.rid: r.tokens.tolist() for r in res}


@pytest.mark.parametrize("backend", ["xla", "scheduled"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_engine_tokens_match_reference(reference_proc, quant, backend):
    """The paged engine (shared prefix, ngram speculation), the dense
    engine and the wave: the reference's greedy tokens and steps."""
    _jcfg, _params, tcfg, tp = model()
    runs, _arrays = reference(reference_proc)
    ref = runs["int8" if quant else "fp"]
    cfg = dataclasses.replace(with_backend(tcfg, backend),
                              quant_serving=quant)
    eng = _engine(cfg, tp)
    got = _tokens(eng.run(requests(cfg.vocab)))
    assert got == ref["paged"]
    assert [eng.steps, eng.chunk_steps] == ref["steps"]
    assert eng.kv_bytes()["allocated"] == ref["kv_allocated"]
    st = eng.pool.stats()
    assert {k: st[k] for k in ref["pool"]} == ref["pool"]
    assert st["shared_token_hits"] > 0 and st["quantized"] == 0
    for toks in got.values():               # every stream varies
        assert len(set(toks)) > 3, got
    spec = _engine(cfg, tp, spec="ngram", spec_k=4)
    assert _tokens(spec.run(requests(cfg.vocab))) == ref["paged"]
    assert spec.spec_drafted > 0
    dense = ContinuousEngine(cfg, tp, paged=False, device="cpu",
                             quant_policy=TQ.QuantPolicy(min_size=0),
                             slots=ENGINE["slots"],
                             max_len=ENGINE["max_len"])
    assert _tokens(dense.run(requests(cfg.vocab))) == ref["dense"]
    assert dense.steps == ref["dense_steps"]
    assert dense.kv_bytes()["allocated"] == ref["dense_kv"]
    wave = WaveEngine(cfg, tp, slots=ENGINE["slots"],
                      max_len=ENGINE["max_len"], device="cpu")
    assert _tokens(wave.run(requests(cfg.vocab))) == ref["wave"]
    assert wave.steps == ref["wave_steps"]


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_schedule_statistics_match_reference(reference_proc, quant):
    """The xla engine's schedule cache: the reference's registered shapes
    (its GQA-shaped projections, as its ``_register_gemms`` lists them
    for MLA too, and the latent gather GEMMs), hits and misses."""
    _jcfg, _params, tcfg, tp = model()
    runs, _arrays = reference(reference_proc)
    ref = runs["int8" if quant else "fp"]
    eng = _engine(dataclasses.replace(tcfg, quant_serving=quant), tp)
    eng.run(requests(tcfg.vocab))
    keys = sorted([list(k[:3]) + [k[3], v["hits"], v["misses"]]
                   for k, v in eng.schedule.key_stats().items()])
    assert keys == ref["keys"]
    assert eng.schedule.stats() == ref["schedule"]


def test_preempted_request_and_restore_match_reference(reference_proc):
    """A request preempted by ``slo_preempt`` resumes (re-prefilled from
    token 0) to its tokens, and a snapshot taken mid-run and restored on
    a fresh engine finishes every request with the reference's tokens."""
    _jcfg, _params, cfg, tp = model()
    runs, _arrays = reference(reference_proc)
    want = runs["fp"]["paged"]
    ps = prompts(cfg.vocab)
    reqs = [Request(1, ps[1], MAX_NEW, eos=-1),
            Request(3, ps[3], MAX_NEW, eos=-1),
            Request(0, ps[0], 4, eos=-1, ttft_slo=1e-4)]
    eng = _engine(cfg, tp, policy="slo_preempt", kv_blocks=9)
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
    got = _tokens(res)
    assert eng.preemptions > 0 and eng.resumes == eng.preemptions
    assert got[1] == want[1] and got[3] == want[3]
    assert got[0] == want[0][:4]
    # snapshot after a few steps, restore on a fresh engine
    eng = _engine(cfg, tp)
    for r in requests(cfg.vocab):
        eng.submit(r)
    for _ in range(5):
        eng.step()
    done = eng.drain_results()
    snap = eng.snapshot()
    fresh = _engine(cfg, tp)
    assert fresh.restore(snap) > 0
    res = list(done)
    while len(res) < 4:
        fresh.step()
        res += fresh.drain_results()
    assert _tokens(res) == want


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_engine_cow_fork_moves_latent_blocks(reference_proc, quant):
    """rid 2 reads its shared prefix block from a forked copy: the copy
    must move the latent rows of every layer, the first block's pool
    included (without ``c_kv`` / ``k_pe`` in ``_POOL_KEYS`` the copy is
    empty and the tokens part)."""
    _jcfg, _params, tcfg, tp = model()
    runs, _arrays = reference(reference_proc)
    cfg = dataclasses.replace(tcfg, quant_serving=quant)
    eng = forced_forks(_engine(cfg, tp))
    got = _tokens(eng.run(requests(cfg.vocab)))
    st = eng.pool.stats()
    assert st["cow_forks"] == 1 and st["shared_token_hits"] == 16
    assert got == runs["int8" if quant else "fp"]["paged"]
