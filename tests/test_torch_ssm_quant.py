"""Port parity: int8 serving of the SSM configs, mamba2 and zamba2.

Both run at ``scaled_down()`` in fp32 at the init scale (their greedy
streams vary there), ``quant_serving=True`` with
``QuantPolicy(min_size=0)``: ``in_proj``, ``out_proj``, the untied head
and zamba2's shared attention projections int8, and zamba2's shared
attention on int8 KV blocks.

  * The paged and the dense engine give the greedy tokens of the
    reference's int8 engines under both GEMM backends, with the same
    step counts and KV bytes; the reference's four engines run in one
    fresh process with a copy of the host arrays for each dispatch and
    XLA's CPU matmuls on one thread (``tests/test_torch_quant_engine.py``).
  * The set of int8 leaves and ``quant_fraction`` equal the reference's;
    zamba2's paged tree has the reference's leaves, dtypes and shapes
    (int8 pools and fp32 scale sidecars at its shared-attention
    positions, fp32 recurrent state elsewhere).
  * A chunk step and a decode step leave the recurrent state (``conv``,
    ``ssm``) and the logits bit-equal between the two backends.
  * A step that fails part way through a K3 call fails that step's
    requests and is not retried (state is written in place, layer by
    layer), and the engine serves on.
  * ``launch/serve.py --quant`` serves both on each engine.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import network as JN
from repro_torch import configs as TC
from repro_torch.kernels import ops as OPS
from repro_torch.models import bridge
from repro_torch.models import network as TN
from repro_torch.models.layers import tree_map
from repro_torch.quant import policy as TQ
from repro_torch.serving.engine import ContinuousEngine, Request
from _torch_port import (int8_paths, reference_process,
                         reference_results, with_backend)

ARCHS = ("mamba2_2_7b", "zamba2_7b")
ENGINE = dict(slots=2, max_len=64)
PROMPT_LENS, MAX_NEW = (7, 12, 30), 8
ROOT = Path(__file__).resolve().parents[1]


def ssm_params(arch: str):
    """(jax config, numpy params, port config) of the scaled-down arch at
    the reference's init scale."""
    jcfg = JC.get(arch).scaled_down()
    params = jax.tree.map(np.asarray, JN.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, params, TC.get(arch).scaled_down()


def prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in PROMPT_LENS]


_REFERENCE = """
from repro.quant import QuantPolicy
from repro.serving.engine import ContinuousEngine, Request
from test_torch_ssm_quant import ARCHS, ENGINE, MAX_NEW, prompts, ssm_params
out = {}
for arch in ARCHS:
    jcfg, params, _ = ssm_params(arch)
    cfg = dataclasses.replace(jcfg, quant_serving=True).validate()
    for paged in (True, False):
        eng = ContinuousEngine(cfg, jax.tree.map(jnp.asarray, params),
                               paged=paged, audit=paged,
                               quant_policy=QuantPolicy(min_size=0),
                               **ENGINE)
        res = eng.run([Request(i, p, MAX_NEW, eos=-1)
                       for i, p in enumerate(prompts(cfg.vocab))])
        out[arch + ("/paged" if paged else "/dense")] = {
            "tokens": {r.rid: r.tokens.tolist() for r in res},
            "status": [r.status for r in res],
            "steps": [eng.steps, eng.chunk_steps],
            "kv": eng.kv_bytes()["allocated"],
            "quantized": (eng.pool.stats()["quantized"] if paged
                          else None)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def reference_proc():
    """The reference engines' process, started with the file's first
    test so that it runs beside the in-process tests."""
    yield from reference_process(_REFERENCE, ROOT)


@pytest.fixture(scope="module")
def reference_runs(reference_proc):
    return reference_results(reference_proc)


_MODELS: dict = {}


def model(arch: str):
    """(jax config, numpy params, port config, port params), built once."""
    if arch not in _MODELS:
        jcfg, params, tcfg = ssm_params(arch)
        _MODELS[arch] = (jcfg, params, tcfg,
                         bridge.from_jax_params(params, tcfg, "cpu"))
    return _MODELS[arch]


def _qcfg(tcfg, backend: str):
    return dataclasses.replace(with_backend(tcfg, backend),
                               quant_serving=True).validate()


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_leaves_match_reference(arch):
    from repro.quant import policy as JQ
    jcfg, params, tcfg, tp = model(arch)
    jq = JQ.serving_quant_params(
        dataclasses.replace(jcfg, quant_serving=True),
        jax.tree.map(jnp.asarray, params), JQ.QuantPolicy(min_size=0))
    tq = TQ.serving_quant_params(_qcfg(tcfg, "xla"), tp,
                                 TQ.QuantPolicy(min_size=0))
    want = int8_paths(jq, JQ.QuantTensor)
    assert int8_paths(tq, TQ.QuantTensor) == want
    assert ("lm_head",) in want and ("blocks", 0, "mamba", "in_proj") in want
    assert TQ.quant_fraction(tq) == pytest.approx(JQ.quant_fraction(jq),
                                                  rel=1e-12)
    assert TQ.quant_fraction(tq) == pytest.approx(
        {"mamba2_2_7b": 0.497, "zamba2_7b": 0.811}[arch], abs=1e-3)


def test_zamba2_paged_tree_matches_reference():
    """The int8 pool at zamba2's shared-attention positions and fp32
    recurrent state at its MAMBA2 positions, leaf for leaf."""
    jcfg, _params, tcfg, _tp = model("zamba2_7b")
    jcfg = dataclasses.replace(jcfg, quant_serving=True)
    tcfg = _qcfg(tcfg, "xla")
    jc = JN.expand_cache_pos(JN.init_paged_caches(jcfg, 3, 24, 8), 3)
    tc = TN.expand_cache_pos(TN.init_paged_caches(tcfg, 3, 24, 8,
                                                  device="cpu"), 3)
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            (tuple(a.shape), np.dtype(a.dtype).name)
            for path, a in jax.tree_util.tree_leaves_with_path(jc)}
    got = {}
    tree_map(lambda path, a: got.__setitem__(
        path, (tuple(a.shape), str(a.dtype).removeprefix("torch."))), tc)
    assert got == want
    kinds = {v[1] for p, v in got.items() if p[-1] in ("k", "v")}
    assert kinds == {"int8"}
    assert any(p[-1] == "k_scale" for p in got)
    assert TN.kv_cache_bytes(tc) == JN.kv_cache_bytes(jc) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_state_bit_equal_across_backends(arch):
    """One chunk step and one decode step under each backend: the slot
    state written in place and the logits are bit-equal (K3's plain
    version and ``layers.dense`` round alike in fp32)."""
    _jcfg, _params, tcfg, tp = model(arch)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(3, tcfg.vocab, (3, 20))
                            .astype(np.int32))
    tables = torch.zeros((3, 7), dtype=torch.int32)
    tables[0] = torch.tensor([3, 7, 1, 12, 4, 6, 10])
    tables[1, :4] = torch.tensor([5, 2, 9, 11])
    lens = torch.tensor([20, 11, 0], dtype=torch.int32)
    ids = torch.arange(3, dtype=torch.int32)
    adv = torch.tensor([1, 1, 0], dtype=torch.int32)
    runs = {}
    for backend in ("xla", "scheduled"):
        cfg = _qcfg(tcfg, backend)
        p = TQ.serving_quant_params(cfg, tp, TQ.QuantPolicy(min_size=0))
        caches = TN.expand_cache_pos(
            TN.init_paged_caches(cfg, 3, 24, 8, device="cpu"), 3)
        chunk, caches = TN.prefill_paged_chunk(
            p, cfg, toks, caches, ids, tables, lens, (lens - 1).clamp_min(0))
        dec, caches = TN.decode_step(p, cfg, toks[:, :1], caches,
                                     TN._first_pos_leaf(caches), tables, adv)
        state = {}
        tree_map(lambda path, a: state.__setitem__(path, a.clone())
                 if path[-1] in TN._SLOT_STATE_KEYS else None, caches)
        runs[backend] = (state, chunk, dec)
    (sx, cx, dx), (ss, cs, ds) = runs["xla"], runs["scheduled"]
    assert sx and set(sx) == set(ss)
    for path in sx:
        assert torch.equal(sx[path], ss[path]), path
    assert torch.equal(cx, cs) and torch.equal(dx, ds)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_step_failure_fails_the_step(arch, monkeypatch):
    """A K3 call that raises part way through a scheduled int8 decode
    step: the step's requests fail (a re-run would apply the layers
    before it twice), nothing is retried, and the rest are served."""
    _jcfg, _params, tcfg, tp = model(arch)
    real = OPS.quant_matmul
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == failing:
            raise RuntimeError("mid-step failure")
        return real(*a, **k)

    eng = ContinuousEngine(_qcfg(tcfg, "scheduled"), tp, audit=True,
                           quant_policy=TQ.QuantPolicy(min_size=0),
                           device="cpu", **ENGINE)
    # the prompts' chunk steps and a few decode steps run first; then
    # the failure lands inside a step, after its first layer's K3 calls
    failing = 10 ** 9
    eng.run([Request(99, prompts(tcfg.vocab)[0], 2, eos=-1)])
    failing = calls["n"] + 5
    monkeypatch.setattr(OPS, "quant_matmul", flaky)
    out = {r.rid: r for r in eng.run([
        Request(i, p, 4, eos=-1)
        for i, p in enumerate(prompts(tcfg.vocab))])}
    failed = {rid for rid, r in out.items() if r.status == "failed"}
    assert failed and all(out[rid].error == "RuntimeError" for rid in failed)
    assert all(r.status == "ok" for rid, r in out.items()
               if rid not in failed)
    assert eng.metrics.value("resilience.retries") == 0
    assert eng.metrics.value("resilience.quarantined") == len(failed)


@pytest.mark.parametrize("engine", ["continuous", "dense", "wave"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_quant_on_each_engine(arch, engine, capsys):
    """``launch/serve.py --quant`` serves every request of an SSM config
    on each engine (the wave takes the weights-only rewrite, as in the
    reference; the dense engine keeps fp stripes)."""
    from repro_torch.launch import serve
    report = serve.main(["--arch", arch, "--scaled-down", "--device", "cpu",
                         "--requests", "3", "--prompt-len", "24",
                         "--max-new", "4", "--slots", "2", "--max-len", "64",
                         "--quant", "--engine", engine,
                         "--gemm-backend", "scheduled"])
    assert report["ok"] == report["requests"] == 3 and report["quant"]
    kv = "no KV pool" if arch == "mamba2_2_7b" else (
        "int8 KV blocks" if engine == "continuous" else "fp KV")
    assert f"QuantTensor weights + {kv}" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["xla", "scheduled"])
@pytest.mark.parametrize("engine", ["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_int8_engine_tokens_match_reference(reference_runs, arch, engine,
                                            backend):
    _jcfg, _params, tcfg, tp = model(arch)
    cfg = _qcfg(tcfg, backend)
    paged = engine == "paged"
    eng = ContinuousEngine(cfg, tp, paged=paged, audit=paged,
                           quant_policy=TQ.QuantPolicy(min_size=0),
                           device="cpu", **ENGINE)
    res = eng.run([Request(i, p, MAX_NEW, eos=-1)
                   for i, p in enumerate(prompts(cfg.vocab))])
    ref = reference_runs[f"{arch}/{engine}"]
    assert [r.status for r in res] == ref["status"] == ["ok"] * 3
    got = {r.rid: r.tokens.tolist() for r in res}
    assert got == ref["tokens"]
    assert [eng.steps, eng.chunk_steps] == ref["steps"]
    assert eng.kv_bytes()["allocated"] == ref["kv"]
    if paged:
        assert eng.pool.stats()["quantized"] == ref["quantized"] \
            == int(arch == "zamba2_7b")
    for toks in got.values():               # every stream varies
        assert len(set(toks)) > 3, got
    assert isinstance(eng.params["lm_head"], TQ.QuantTensor)
