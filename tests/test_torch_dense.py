"""Port parity: the dense serving layout against the reference, on the CPU.

Dense KV stripes (``attention._cache_write``, ``make_kv_cache``), the
full-sequence ``network.forward`` with llava's patch prefix, the dense
``prefill`` / ``prefill_ragged`` / ``decode_step`` and
``insert_slot_caches``, ``ContinuousEngine(paged=False)``,
``WaveEngine`` and ``launch/serve.py --engine``.  Every arch runs at
``scaled_down()`` in fp32 with the reference's ``network.init`` weights
(qwen2 x4, mamba2 at the init scale, zamba2, gemma2 and llava at
``FAMILY_SCALES``, gemma2 and llava with window 16).

  * Cache trees match the reference's leaf for leaf; ``_cache_write``
    equals the reference's bit for bit, a clamped start included (the
    reference's ``dynamic_update_slice`` clamps it to ``T - S``).
  * ``forward`` is within 1e-4 of the reference (llava with 8 stub patch
    positions); dense prefill then teacher-forced decode steps give
    ``forward``'s logits; ``prefill_ragged`` + ``insert_slot_caches``
    give the reference's logits and leaves.
  * The dense and the wave engine give the reference's greedy tokens and
    steps for qwen2, mamba2, zamba2 and gemma2, and the port's paged
    engine gives the dense engine's tokens.  The trace drives an idle
    slot past ``max_len`` (its writes clamp onto its last row) and
    truncates a wave at ``max_len``.  All reference engines run in ONE
    fresh process, with a copy of the host arrays for each dispatch (the
    reference's race, ``tests/test_torch_serving_paths.py``); it starts
    with the first test of this file and runs beside the others.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import attention as JA
from repro.models import network as JN
from repro.serving.engine import ContinuousEngine as JEngine
from repro_torch import configs as TC
from repro_torch.models import attention as TA
from repro_torch.models import bridge
from repro_torch.models import network as TN
from repro_torch.models.layers import tree_map
from repro_torch.serving.engine import ContinuousEngine, Request, WaveEngine
from _dense_trace import MAX_LEN, SLOTS, arch_params, trace
from _family_scales import FAMILY_SCALES, family_config
from _torch_port import WEIGHT_SCALE, reference_process, with_backend

TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2_0_5b", "mamba2_2_7b", "zamba2_7b", "gemma2_9b",
         "llava_next_mistral_7b")
ENGINE_ARCHS = ARCHS[:4]


def scales(arch):
    """(embedding scale, scale of every other weight)."""
    if arch == "qwen2_0_5b":
        return WEIGHT_SCALE, WEIGHT_SCALE
    return FAMILY_SCALES.get(arch, (1.0, 1.0))


_REFERENCE = """
from repro.serving.engine import ContinuousEngine, Request, WaveEngine
from _dense_trace import MAX_LEN, SLOTS, arch_params, trace
out = {{}}
for arch, scales in {scales!r}.items():
    jcfg, params = arch_params(arch, scales)
    params = jax.tree.map(jnp.asarray, params)
    reqs = [Request(i, p, m, eos=-1) for i, (p, m) in
            enumerate(trace(jcfg.vocab))]
    dense = ContinuousEngine(jcfg, params, slots=SLOTS, max_len=MAX_LEN,
                             paged=False)
    got = dense.run(reqs)
    wave = WaveEngine(jcfg, params, slots=SLOTS, max_len=MAX_LEN)
    waved = wave.run(reqs)
    out[arch] = {{"dense": {{r.rid: r.tokens.tolist() for r in got}},
                 "dense_steps": dense.steps,
                 "dense_pos": dense._pos.tolist(),
                 "kv_bytes": dense.kv_bytes(),
                 "wave": {{r.rid: r.tokens.tolist() for r in waved}},
                 "wave_steps": wave.steps}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def reference_proc():
    """The reference engines' process, started with the file's first test
    so that it runs beside the in-process tests (which take half the
    cores meanwhile: the tiny torch ops slow down many times over when
    their threads contend with the reference's compiles)."""
    code = _REFERENCE.format(scales={a: scales(a) for a in ENGINE_ARCHS})
    yield from reference_process(code, ROOT, one_thread=False)


_RUNS: dict = {}


def reference_runs(proc):
    if not _RUNS:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-2000:]
        for arch, run in json.loads(out.strip().splitlines()[-1]).items():
            for key in ("dense", "wave"):
                run[key] = {int(k): v for k, v in run[key].items()}
            _RUNS[arch] = run
    return _RUNS


_ARCHS: dict = {}


def arch(name):
    """(jax config, numpy params, port config, port params), built once."""
    if name not in _ARCHS:
        jcfg, params = arch_params(name, scales(name))
        tcfg = family_config(TC, name)
        _ARCHS[name] = (jcfg, params, tcfg,
                        bridge.from_jax_params(params, tcfg, "cpu"))
    return _ARCHS[name]


def _leaves(tree):
    """{path: (shape, dtype name)} of a port or a reference tree."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        flat = {}
        tree_map(lambda path, a: flat.__setitem__(
            path, (tuple(a.shape), str(a.dtype).split(".")[-1])), tree)
        return flat
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            (tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(toks, patches=None):
    b = {"tokens": toks}
    if patches is not None:
        b["patches"] = patches
    return b


def _inputs(jcfg, B=2, S=24, seed=0):
    """Tokens (B, S) and, for llava, stub patch embeddings (B, P, D) of
    normal x 0.02 (the reference's own stub, tests/test_models.py)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, jcfg.vocab, (B, S)).astype(np.int32)
    patches = None
    if jcfg.frontend == "patches":
        patches = (0.02 * rng.standard_normal(
            (B, jcfg.frontend_prefix_len, jcfg.d_model))).astype(np.float32)
    return toks, patches


@pytest.mark.parametrize("name", ARCHS)
def test_init_caches_match_reference(name):
    jcfg, tcfg = family_config(JC, name), family_config(TC, name)
    for expand in (False, True):
        jt = JN.init_caches(jcfg, 2, 32, jnp.float32)
        tt = TN.init_caches(tcfg, 2, 32, torch.float32, "cpu")
        if expand:
            jt, tt = JN.expand_cache_pos(jt, 2), TN.expand_cache_pos(tt, 2)
        assert _leaves(tt) == _leaves(jt)
        assert TN.kv_cache_bytes(tt) == JN.kv_cache_bytes(jt)


@pytest.mark.parametrize("S,pos", [(1, 3), (3, 2), (3, 7), (3, 40),
                                   (1, [0, 7, 8]), (3, [1, 5, 9]),
                                   (8, [0, 2, 30])])
def test_cache_write_matches_reference_bit_for_bit(S, pos):
    """A scalar and a (B,) position, starts past T - S clamped."""
    rng = np.random.default_rng(S)
    buf = rng.standard_normal((3, 8, 2, 4)).astype(np.float32)
    upd = rng.standard_normal((3, S, 2, 4)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    want = np.asarray(JA._cache_write(jnp.asarray(buf), jnp.asarray(upd),
                                      jnp.asarray(p)))
    got = TA._cache_write(torch.from_numpy(buf.copy()),
                          torch.from_numpy(upd), torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name):
    jcfg, params, tcfg, tp = arch(name)
    toks, patches = _inputs(jcfg)
    jb = {k: jnp.asarray(v) for k, v in _batch(toks, patches).items()}
    want, _ = jax.jit(lambda p, b: JN.forward(p, jcfg, b))(
        jax.tree.map(jnp.asarray, params), jb)
    got = TN.forward(tp, tcfg, {k: torch.from_numpy(np.array(v))
                                for k, v in jb.items()})
    P = 0 if patches is None else jcfg.frontend_prefix_len
    assert tuple(got.shape) == (2, P + toks.shape[1], jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if patches is not None:
        # the prefix reaches the text: zero patches give other logits
        other = TN.forward(tp, tcfg, {"tokens": torch.from_numpy(toks),
                                      "patches": torch.zeros(patches.shape)})
        assert not torch.allclose(other[:, P], got[:, P], **TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_then_decode_reproduce_forward(name):
    """Teacher-forced dense decode at a scalar position reproduces the
    full forward (the reference's tests/test_models.py contract), llava's
    text positions after its patch prefix."""
    jcfg, _params, tcfg, tp = arch(name)
    toks, patches = _inputs(jcfg, S=20, seed=1)
    t = torch.from_numpy(toks)
    pt = None if patches is None else torch.from_numpy(patches)
    full = TN.forward(tp, tcfg, _batch(t, pt))
    P = 0 if patches is None else jcfg.frontend_prefix_len
    caches = TN.init_caches(tcfg, 2, 64, torch.float32, "cpu")
    split = 10
    lg, caches = TN.prefill(tp, tcfg, _batch(t[:, :split], pt), caches)
    np.testing.assert_allclose(lg.numpy(), full[:, P + split - 1].numpy(),
                               **TOL)
    for i in range(split, t.shape[1]):
        lg, caches = TN.decode_step(tp, tcfg, t[:, i:i + 1], caches,
                                    torch.tensor(P + i, dtype=torch.int32))
        np.testing.assert_allclose(lg.numpy(), full[:, P + i].numpy(), **TOL)


@pytest.mark.parametrize("name", ("qwen2_0_5b", "zamba2_7b"))
def test_prefill_ragged_and_insert_match_reference(name):
    """A padded batch-1 prefill (bucket 16, 9 real tokens) inserted into
    slot 1 of a 2-slot tree: the reference's logits and every leaf."""
    jcfg, params, tcfg, tp = arch(name)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :9] = _inputs(jcfg, B=1, S=9, seed=2)[0]
    idx = np.asarray([8], np.int32)

    def ref(p, tk, i):
        small = JN.init_caches(jcfg, 1, 32, jnp.float32)
        lg, small = JN.prefill_ragged(p, jcfg, {"tokens": tk}, small, i)
        big = JN.expand_cache_pos(JN.init_caches(jcfg, 2, 32, jnp.float32),
                                  2)
        return lg, JN.insert_slot_caches(big, small, 1, 9)
    jl, jt = jax.jit(ref)(jax.tree.map(jnp.asarray, params),
                          jnp.asarray(toks), jnp.asarray(idx))
    small = TN.init_caches(tcfg, 1, 32, torch.float32, "cpu")
    tl, small = TN.prefill_ragged(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                                  small, torch.from_numpy(idx))
    big = TN.expand_cache_pos(TN.init_caches(tcfg, 2, 32, torch.float32,
                                             "cpu"), 2)
    tt = TN.insert_slot_caches(big, small, 1, 9)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jflat = {path: np.asarray(a)
             for path, a in jax.tree_util.tree_leaves_with_path(jt)}
    got: dict = {}
    tree_map(lambda path, a: got.__setitem__(path, a.numpy()), tt)
    for path, a in jflat.items():
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        if key[-1] == "pos":
            np.testing.assert_array_equal(got[key], a)
        else:
            np.testing.assert_allclose(got[key], a, **TOL)
    assert got[("groups", 0, "pos") if name == "qwen2_0_5b"
               else ("tail", 0, "conv")] is not None


def _serve(tcfg, tp, reqs, **kw):
    eng = ContinuousEngine(tcfg, tp, slots=SLOTS, max_len=MAX_LEN,
                           device="cpu", **kw)
    return eng, {r.rid: r.tokens.tolist() for r in eng.run(reqs)}


_DENSE: dict = {}


def dense_run(name):
    """The port's dense engine on the trace, run once per arch."""
    if name not in _DENSE:
        jcfg, _params, tcfg, tp = arch(name)
        _DENSE[name] = _serve(tcfg, tp, _requests(jcfg.vocab), paged=False)
    return _DENSE[name]


def _requests(vocab):
    return [Request(i, p, m, eos=-1)
            for i, (p, m) in enumerate(trace(vocab))]


@pytest.mark.parametrize("name", ENGINE_ARCHS)
def test_paged_equals_dense_token_for_token(name):
    jcfg, _params, tcfg, tp = arch(name)
    dense, want = dense_run(name)
    paged, got = _serve(tcfg, tp, _requests(jcfg.vocab), prefill_chunk=16,
                        audit=True)
    assert got == want
    peak = paged.kv_bytes()["peak"], dense.kv_bytes()["peak"]
    assert peak[0] < peak[1] or tcfg.attention_free and peak == (0, 0)


def test_dense_engine_under_scheduled_backend_and_buckets():
    """The scheduled backend's dense engine gives the xla backend's tokens
    with the admission buckets registered (cache hits after the first
    sight of a bucket); a terminal bucket that is not an SSD chunk
    multiple (the reference's regression case) serves mamba2."""
    jcfg, params, tcfg, _tp = arch("qwen2_0_5b")
    _eng, want = dense_run("qwen2_0_5b")
    cfg = with_backend(tcfg, "scheduled")
    eng, got = _serve(cfg, bridge.from_jax_params(params, cfg, "cpu"),
                      _requests(jcfg.vocab), paged=False)
    assert got == want and eng.buckets == [16, 32, 48]
    eng.schedule.reset()
    eng.run(_requests(jcfg.vocab))
    assert eng.schedule.stats()["misses"] == 0

    mcfg, _p, m_tcfg, mp = arch("mamba2_2_7b")
    assert mcfg.ssm.chunk == 32
    m = ContinuousEngine(m_tcfg, mp, slots=1, max_len=40, paged=False,
                         device="cpu")
    res = m.run([Request(0, np.random.default_rng(11).integers(
        3, mcfg.vocab, 36).astype(np.int32), 3, eos=-1)])   # bucket 40
    assert len(res) == 1 and len(res[0].tokens) == 3


def test_mixed_trace_engine_gates():
    """serve_bench's engine gates on its mixed trace at its ``--dry``
    geometry (8 requests, 4 slots, max_len 160; ``launch/traces.py``'s
    copy, equal to serve_bench's): the dense engine takes fewer decode
    steps than the wave for as many tokens, and the paged engine gives the
    dense engine's tokens with less peak KV."""
    from benchmarks import serve_bench as SB
    from repro_torch.launch import traces as TR
    jcfg, _params, tcfg, tp = arch("qwen2_0_5b")
    n = TR.MIXED_REQUESTS
    reqs = TR.mixed_trace(n, TR.MIXED_SLOTS, jcfg.vocab)
    for a, b in zip(reqs, SB._trace(n, TR.MIXED_SLOTS, jcfg.vocab)):
        assert a.prompt.tolist() == b.prompt.tolist()
        assert a.max_new_tokens == b.max_new_tokens
    kw = dict(slots=TR.MIXED_SLOTS, max_len=TR.MIXED_MAX_LEN, device="cpu")
    runs = {}
    for name, eng in (("dense", ContinuousEngine(tcfg, tp, paged=False,
                                                 **kw)),
                      ("paged", ContinuousEngine(tcfg, tp, **kw)),
                      ("wave", WaveEngine(tcfg, tp, **kw))):
        runs[name] = (eng, {r.rid: r.tokens.tolist() for r in eng.run(reqs)})
    (dense, d_tok), (paged, p_tok), (wave, w_tok) = runs.values()
    assert dense.steps < wave.steps
    assert sum(map(len, w_tok.values())) == sum(map(len, d_tok.values()))
    assert p_tok == d_tok
    assert paged.kv_bytes()["peak"] < dense.kv_bytes()["peak"]


def test_full_window_prompt_and_sampling_on_dense():
    """A prompt filling the stripe returns exactly its prefill token (the
    forward's argmax); sampled dense runs repeat under one seed and move
    under another."""
    jcfg, _params, tcfg, tp = arch("qwen2_0_5b")
    rng = np.random.default_rng(7)
    prompt = rng.integers(3, jcfg.vocab, 32).astype(np.int32)
    eng = ContinuousEngine(tcfg, tp, slots=2, max_len=32, paged=False,
                           device="cpu")
    (res,) = eng.run([Request(0, prompt, 8, eos=-1)])
    want = TN.forward(tp, tcfg, {"tokens": torch.from_numpy(prompt)[None]})
    assert res.tokens.tolist() == [int(want[0, -1].argmax())]
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(Request(1, np.ones(33, np.int32)))

    def sampled(seed):
        e = ContinuousEngine(tcfg, tp, slots=2, max_len=64, paged=False,
                             seed=seed, device="cpu")
        reqs = [Request(i, rng_p, 8, temperature=1.0, eos=-1)
                for i, rng_p in enumerate((prompt[:9], prompt[:20]))]
        return {r.rid: r.tokens.tolist() for r in e.run(reqs)}
    assert sampled(1) == sampled(1) != sampled(2)


def test_refusals_match_reference():
    """spec= and a pool policy need the pool: both engines refuse them on
    dense stripes, and the wave and dense engines refuse the CPU unless
    asked."""
    jcfg, params, tcfg, tp = arch("qwen2_0_5b")
    jp = jax.tree.map(jnp.asarray, params)
    for kw, match in ((dict(spec="ngram"), "paged KV pool"),
                      (dict(policy="best_fit"), "no pool")):
        with pytest.raises(ValueError, match=match):
            JEngine(jcfg, jp, slots=2, max_len=64, paged=False, **kw)
        with pytest.raises(ValueError, match=match):
            ContinuousEngine(tcfg, tp, slots=2, max_len=64, paged=False,
                             device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            WaveEngine(tcfg, tp, slots=2, max_len=64)
        with pytest.raises(RuntimeError, match="CUDA"):
            ContinuousEngine(tcfg, tp, slots=2, max_len=64, paged=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            TN.init_caches(tcfg, 2, 64)


@pytest.mark.parametrize("engine", ("continuous", "dense", "wave"))
def test_serve_cli_engines(engine, capsys):
    from repro_torch.launch import serve
    argv = ["--arch", "qwen2_0_5b", "--scaled-down", "--device", "cpu",
            "--engine", engine, "--requests", "3", "--prompt-len", "24",
            "--max-new", "4", "--slots", "2", "--max-len", "64"]
    report = serve.main(argv)
    assert report["ok"] == report["requests"] == 3 and report["new_tokens"]
    out = capsys.readouterr().out
    assert f"[serve:{engine}] 3 requests" in out
    if engine == "dense":
        assert report["kv_peak_bytes"] == report["kv_allocated_bytes"]
        with pytest.raises(SystemExit, match="paged engine"):
            serve.main(argv + ["--spec", "ngram"])
        with pytest.raises(ValueError, match="no pool"):
            serve.main(argv + ["--policy", "best_fit"])
    if engine == "wave":
        with pytest.raises(SystemExit, match="paged engine"):
            serve.main(argv + ["--spec", "ngram"])
        # the wave's --quant is the weights-only rewrite on the fp config
        assert serve.main(argv + ["--quant"])["ok"] == 3


# the reference engines last: their process runs beside the tests above

@pytest.mark.parametrize("name", ENGINE_ARCHS)
def test_dense_engine_matches_reference(name, reference_proc):
    ref = reference_runs(reference_proc)[name]
    eng, got = dense_run(name)
    assert got == ref["dense"]
    assert eng.steps == ref["dense_steps"]
    # the idle slot's cursor went past max_len (clamped writes)
    assert eng._pos.tolist() == ref["dense_pos"] and max(eng._pos) > MAX_LEN
    assert eng.kv_bytes() == ref["kv_bytes"]


@pytest.mark.parametrize("name", ENGINE_ARCHS)
def test_wave_engine_matches_reference(name, reference_proc):
    jcfg, _params, tcfg, tp = arch(name)
    ref = reference_runs(reference_proc)[name]
    wave = WaveEngine(tcfg, tp, slots=SLOTS, max_len=MAX_LEN, device="cpu")
    got = {r.rid: r.tokens.tolist() for r in wave.run(_requests(jcfg.vocab))}
    assert got == ref["wave"] and wave.steps == ref["wave_steps"]
    # both waves were cut at max_len
    assert [len(got[i]) for i in range(4)] == [16, 8, 5, 16]
