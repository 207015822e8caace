"""Port parity: int8 quantization, K3 (quant_matmul) and K1-int8.

Held against the reference on inputs made with numpy:

  * ``quantize_tensor`` / ``quantize_params`` / ``serving_quant_params``
    and the KV quantize-on-write ``_paged_write_quant`` are bit-identical
    (same q, same scale), for fp32 and bf16 inputs;
  * ``choose_precision`` gives the reference's verdict on a grid of
    serving GEMM shapes;
  * K3's plain version is within 1e-5 of the reference's Pallas
    ``quant_matmul`` in interpret mode (fp32 and bf16 x: int8 and bf16
    are exact in fp32, so only the order of the fp32 sums differs; x is
    drawn N(0, 1/K), as after a norm, so outputs are of order 1), and
    ``ops.quant_matmul`` logs its application as the reference does
    (INT8, OS, fold 1);
  * K1-int8's plain version is within 1e-5 (fp32) and 1e-2 (bf16: one
    bf16 rounding of the output, 2^-8 relative, plus order effects) of
    the reference's Pallas ``paged_decode_kernel`` with scales in
    interpret mode, on ragged lengths with NULL-block entries;
  * the quantized ``dense`` rounds like the reference's in bf16;
  * the KV pool's scale-sidecar bookkeeping (COW inherits, release
    clears, the audit catches a stale flag).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pgemm import PGEMM as JPGEMM
from repro.core.precision import INT8 as JINT8
from repro.core.scheduler import ScheduleCache as JCache
from repro.kernels import ops as JOPS
from repro.kernels import paged_attention as JPA
from repro.kernels import quant_matmul as JQM
from repro.models import attention as JA
from repro.models import layers as JL
from repro.quant import policy as JQ
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.pgemm import PGEMM
from repro_torch.core.precision import INT8
from repro_torch.core.scheduler import ScheduleCache
from repro_torch.core.tiling import MAX_CLUSTER
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import quant_matmul as TQM
from repro_torch.models import attention as TA
from repro_torch.models import bridge
from repro_torch.models import layers as TL
from repro_torch.quant import policy as TQ
from repro_torch.serving.kv_pool import KVPool
from _torch_port import reference_params

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16)}


def _weights(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[..., 3] = 0.0                    # an all-zero channel: scale 1.0
    jw = jnp.asarray(w).astype(DTYPES[dtype][1])
    return jw, _t(jw, dtype)


def _t(jarr, dtype):
    """A jax float array as a torch tensor of the same values in
    ``dtype``."""
    return torch.from_numpy(np.array(jarr.astype(jnp.float32))).to(
        DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(896, 128), (3, 256, 96)])
def test_quantize_tensor_bit_identical(shape, dtype):
    jw, tw = _weights(shape, sum(shape), dtype)
    jq = JQ.quantize_tensor(jw)
    tq = TQ.quantize_tensor(tw)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.scale[..., 3].eq(1.0).all()
    q2, s2 = TOPS.quantize_weights(tw if len(shape) == 2 else tw[0])
    jq2, js2 = JOPS.quantize_weights(jw if len(shape) == 2 else jw[0])
    np.testing.assert_array_equal(q2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(js2))


def test_quantize_params_bit_identical_and_bridged():
    """The serving rewrite of the scaled-down qwen2 tree matches the
    reference leaf for leaf; the reference's quantized tree crosses the
    bridge bit for bit; a second application is the identity; the tied
    table stays float."""
    jcfg, params, tcfg = reference_params(scale=1.0)
    pol = TQ.QuantPolicy(min_size=0)
    jtree = jax.tree.map(np.asarray, JQ.serving_quant_params(
        jcfg, jax.tree.map(jnp.asarray, params),
        JQ.QuantPolicy(min_size=0)))
    ttree = TQ.serving_quant_params(
        tcfg, bridge.from_jax_params(params, tcfg, "cpu"), pol)
    bridged = bridge.from_jax_params(jtree, tcfg, "cpu")
    jblk, tblk, bblk = (t["blocks"][0] for t in (jtree, ttree, bridged))
    for grp, names in (("attn", ("wq", "wk", "wv", "wo")),
                       ("mlp", ("wi_gate", "wi_up", "wo"))):
        for name in names:
            j, t, b = jblk[grp][name], tblk[grp][name], bblk[grp][name]
            assert isinstance(t, TQ.QuantTensor) and isinstance(
                b, TQ.QuantTensor)
            for field in ("q", "scale"):
                want = np.asarray(getattr(j, field))
                np.testing.assert_array_equal(getattr(t, field).numpy(),
                                              want)
                np.testing.assert_array_equal(getattr(b, field).numpy(),
                                              want)
    assert not isinstance(ttree["embed"]["table"], TQ.QuantTensor)
    again = TQ.serving_quant_params(tcfg, ttree, pol)
    assert again["blocks"][0]["attn"]["wq"] is tblk["attn"]["wq"]
    assert TQ.quant_fraction(ttree) == pytest.approx(
        float(JQ.quant_fraction(jtree)), rel=1e-12)
    # the default floor (65536 elements, counted over the layer stack)
    # takes only the MLP weights at this width, in both packages
    dflt = TQ.serving_quant_params(tcfg, bridge.from_jax_params(
        params, tcfg, "cpu"))
    jdflt = JQ.serving_quant_params(jcfg, jax.tree.map(jnp.asarray, params))
    assert 0 < TQ.quant_fraction(dflt) < TQ.quant_fraction(ttree)
    assert TQ.quant_fraction(dflt) == pytest.approx(
        float(JQ.quant_fraction(jdflt)), rel=1e-12)
    # one layer of a stacked QuantTensor slices payload and scale alike,
    # and dequantizes as the reference's does
    layer = tblk["mlp"]["wo"][1]
    assert layer.shape == (tcfg.d_ff, tcfg.d_model)
    assert layer.scale.shape == (tcfg.d_model,)
    jlayer = JQ.QuantTensor(jnp.asarray(jblk["mlp"]["wo"].q[1]),
                            jnp.asarray(jblk["mlp"]["wo"].scale[1]))
    np.testing.assert_array_equal(layer.dequant(torch.float32).numpy(),
                                  np.asarray(jlayer.dequant(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_write_quant_bit_identical(dtype):
    rng = np.random.default_rng(5)
    nb, bs, KV, hd, B, S = 6, 4, 2, 32, 3, 5
    upd = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    upd[1, 2] = 0.0                              # zero rows: scale 1.0
    pos = np.array([0, 3, 7], np.int32)
    bt = np.array([[1, 2, 0], [3, 4, 0], [5, 0, 0]], np.int32)  # NULL tails
    jupd = jnp.asarray(upd).astype(DTYPES[dtype][1])
    jq, js = JA._paged_write_quant(
        jnp.zeros((nb, bs, KV, hd), jnp.int8),
        jnp.ones((nb, bs, KV), jnp.float32), jupd, jnp.asarray(pos),
        jnp.asarray(bt))
    tq, ts = TA._paged_write_quant(
        torch.zeros(nb, bs, KV, hd, dtype=torch.int8),
        torch.ones(nb, bs, KV), _t(jupd, dtype),
        torch.from_numpy(pos), torch.from_numpy(bt))
    # block 0 takes the colliding stray writes: compare the real blocks
    np.testing.assert_array_equal(tq[1:].numpy(), np.asarray(jq)[1:])
    np.testing.assert_array_equal(ts[1:].numpy(), np.asarray(js)[1:])


def test_choose_precision_matches_reference():
    shapes = [(M, N, K) for M in (1, 8, 256)
              for N, K in ((896, 896), (128, 896), (4864, 896),
                           (896, 4864), (151936, 896), (128, 128),
                           (32, 128), (256, 128), (128, 256))]
    for M, N, K in shapes:
        want = JQ.choose_precision(JPGEMM("s", M=M, N=N, K=K,
                                          precision=JINT8)).name
        got = TQ.choose_precision(PGEMM("s", M=M, N=N, K=K,
                                        precision=INT8)).name
        assert got == want, (M, N, K, got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_plain_matches_reference_kernel(dtype):
    rng = np.random.default_rng(7)
    M, N, K = 16, 256, 384
    x = rng.standard_normal((M, K)).astype(np.float32) * K ** -0.5
    jx = jnp.asarray(x).astype(DTYPES[dtype][1])
    wq, sc = JOPS.quantize_weights(jnp.asarray(
        rng.standard_normal((K, N)).astype(np.float32)))
    want = np.asarray(JQM.quant_matmul(jx, wq, sc, bm=16, bn=128, bk=128,
                                       interpret=True))
    tx = _t(jx, dtype)
    tw, ts = torch.from_numpy(np.array(wq)), torch.from_numpy(np.array(sc))
    got = TQM.quant_matmul(tx, tw, ts)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(),
                                  TQM.quant_matmul_ref(tx, tw, ts).numpy())


def test_ops_quant_matmul_logs_like_reference():
    rng = np.random.default_rng(8)
    M, N, K = 8, 96, 160                  # not a multiple of any tile
    x = rng.standard_normal((M, K)).astype(np.float32) * K ** -0.5
    w = rng.standard_normal((K, N)).astype(np.float32)
    jc, tc = JCache(), ScheduleCache()
    jq, js = JOPS.quantize_weights(jnp.asarray(w))
    want = np.asarray(JOPS.quant_matmul(jnp.asarray(x), jq, js,
                                        schedule=jc, interpret=True))
    tq, ts = TOPS.quantize_weights(torch.from_numpy(w))
    got = TOPS.quant_matmul(torch.from_numpy(x), tq, ts, schedule=tc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    (jkey, jch), = list(jc.applied)
    (tkey, tch), = list(tc.applied)
    assert tkey == jkey == (M, N, K, "INT8")
    assert tch.dataflow is Dataflow.OS and tch.k_fold == 1
    assert jch.dataflow.value == "OS" and jch.k_fold == 1


def test_k3_tile_choice_fills_the_card():
    """Decode GEMMs (M = 8) take the 8-row Hopper tile and split K over a
    cluster until about two CTAs an SM stream the weight; chunk GEMMs
    take a chunk tile with at least 56 CTAs; the CUDA-core route's decode
    tile is 16 weight columns wide."""
    for N, K in ((896, 896), (896, 4864), (4864, 896)):
        p = TQM.quant_plan(8, N, K)
        assert p.tile == (8, 64) and 100 <= p.ctas <= 2 * 132
        assert TQM.quant_plan(8, N, K, "cuda_core").tile == (8, 16)
    assert TQM.quant_plan(8, 128, 896).ranks == MAX_CLUSTER
    for N, K in ((896, 896), (896, 4864), (4864, 896)):
        p = TQM.quant_plan(256, N, K)
        assert p.tile[0] >= 64 and p.ctas >= 56


def _int8_pools(seed, B=5, KV=2, G=3, hd=32, nb=20, bs=8, nbs=6,
                lens=(0, 1, 8, 48, 19)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32)
    k = rng.integers(-127, 128, (nb, bs, KV, hd)).astype(np.int8)
    v = rng.integers(-127, 128, (nb, bs, KV, hd)).astype(np.int8)
    ks = rng.uniform(0.001, 0.03, (nb, bs, KV)).astype(np.float32)
    vs = rng.uniform(0.001, 0.03, (nb, bs, KV)).astype(np.float32)
    bt = rng.integers(1, nb, (B, nbs)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for b in range(B):                      # unallocated tail -> NULL block
        bt[b, -(-int(lens[b]) // bs):] = 0
    return q, k, v, bt, lens, ks, vs


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize("window,cap", [(None, None), (9, 30.0)])
def test_k1_int8_plain_matches_reference_kernel(dtype, tol, window, cap):
    q, k, v, bt, lens, ks, vs = _int8_pools(3)
    jq = jnp.asarray(q).astype(DTYPES[dtype][1])
    want = np.asarray(JPA.paged_decode_kernel(
        jq, *(jnp.asarray(a) for a in (k, v, bt, lens)), scale=0.17,
        window=window, logit_cap=cap, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)
    ).astype(jnp.float32))
    tq = _t(jq, dtype)
    targs = [torch.from_numpy(a) for a in (k, v, bt, lens)]
    got = TPA.paged_decode(tq, *targs, scale=0.17, window=window,
                           logit_cap=cap, k_scale=torch.from_numpy(ks),
                           v_scale=torch.from_numpy(vs))
    assert got.dtype == DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)
    assert not got[0].any()                         # length-0 row: zeros


def test_k1_int8_refuses_missing_or_stray_scales():
    q, k, v, bt, lens, ks, vs = (torch.from_numpy(a)
                                 for a in _int8_pools(4))
    with pytest.raises(TypeError, match="int8 pools need"):
        TPA.paged_decode(q, k, v, bt, lens, scale=1.0)
    with pytest.raises(TypeError, match="int8 pools need"):
        TPA.paged_decode(q, k.float(), v.float(), bt, lens, scale=1.0,
                         k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="scales must be"):
        TPA.paged_decode(q, k, v, bt, lens, scale=1.0, k_scale=ks[:, :2],
                         v_scale=vs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_dense_rounds_like_reference(dtype):
    """Each backend mirrors its own reference path: the xla dense rounds
    the product and then the scaled product in the compute dtype; the
    scheduled dense emits fp32 (scale applied) and casts once."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jx = jnp.asarray(x).astype(DTYPES[dtype][1])
    jw = JQ.quantize_tensor(jnp.asarray(
        rng.standard_normal((64, 48)).astype(np.float32)))
    tx = _t(jx, dtype)
    tw = TQ.QuantTensor(torch.from_numpy(np.array(jw.q)),
                        torch.from_numpy(np.array(jw.scale)))
    tol = 1e-5 if dtype == "float32" else 1e-2
    for backend, tback in ((None, None),
                           (JOPS.GemmBackend(interpret=True),
                            TOPS.GemmBackend())):
        want = np.asarray(JL.dense(jx, jw, jnp.asarray(b), backend=backend)
                          .astype(jnp.float32))
        got = TL.dense(tx, tw, torch.from_numpy(b), backend=tback)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)


def test_quant_head_folds_scale_like_reference():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    jw = JQ.quantize_tensor(jnp.asarray(
        rng.standard_normal((50, 32)).astype(np.float32)))
    want = np.asarray(JL.head_apply(jw, jnp.asarray(x)))
    tw = TQ.QuantTensor(torch.from_numpy(np.array(jw.q)),
                        torch.from_numpy(np.array(jw.scale)))
    got = TL.head_apply(tw, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pool_scale_sidecar_bookkeeping():
    """COW destinations inherit the source's flag, release at ref 0
    clears it, fp pools never set it, and the audit catches a stale flag
    on a freed block and a live block without one."""
    pool = KVPool(10, 4, slots=2, max_len=16, quantized=True)
    prompt = list(range(3, 12))                 # 2 full blocks + 1 token
    pool.admit(0, prompt, 4)
    row0 = [int(b) for b in pool.tables[0, :pool.n_slot_blocks[0]]]
    assert pool.scale_written[row0].all() and not pool.scale_written[0]
    pool.register_prefix(prompt, row0[:2])
    assert pool.admit(1, prompt, 4).shared_tokens == 8
    pool.ensure_writable(1, 5, 5)               # fork the shared block 1
    (src, dst), = pool.pending_copies
    assert pool.scale_written[dst] and pool.scale_written[src]
    pool.check()
    pool.take_copies()
    pool.release_slot(1)
    pool.check()
    freed = [b for b in range(1, 10) if pool.ref[b] == 0]
    assert dst in freed and not pool.scale_written[freed].any()
    stats = pool.stats()
    assert stats["quantized"] == 1
    assert pool.snapshot_state()["scale_written"] == sorted(
        int(b) for b in np.flatnonzero(pool.scale_written))
    pool.scale_written[freed[0]] = True
    with pytest.raises(AssertionError, match="stale scale sidecar"):
        pool.check()
    pool.scale_written[freed[0]] = False
    pool.scale_written[row0[-1]] = False
    with pytest.raises(AssertionError, match="dequant state lost"):
        pool.check()
    fp = KVPool(10, 4, slots=1, max_len=16)
    fp.admit(0, prompt, 4)
    assert not fp.scale_written.any() and fp.stats()["quantized"] == 0


def test_quant_cache_layout_and_kv_bytes():
    """Int8 pools with fp32 sidecars of ones; COW copies and the byte
    count cover the sidecars."""
    from repro_torch import configs as TC
    from repro_torch.models import network as TN
    base = TC.get("qwen2_0_5b").scaled_down()
    qcfg = dataclasses.replace(base, quant_serving=True)
    assert qcfg.quant_kv and not base.quant_kv
    caches = TN.init_paged_caches(qcfg, 2, 8, 4, device="cpu")
    g = caches["groups"][0]
    assert g["k"].dtype == torch.int8 and g["k_scale"].dtype == torch.float32
    assert g["k_scale"].shape == g["k"].shape[:4] and g["v_scale"].eq(1).all()
    fp = TN.init_paged_caches(base, 2, 8, 4, device="cpu")
    hd = base.hd
    assert TN.kv_cache_bytes(caches) * 4 * hd == \
        TN.kv_cache_bytes(fp) * (hd + 4)
    g["k_scale"][:, 3] = 2.5
    TN.copy_paged_blocks(caches, torch.tensor([3]), torch.tensor([5]))
    assert g["k_scale"][:, 5].eq(2.5).all()
