"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one;
the file imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: fp32 results to 1e-4 (the reference's GEMM bound; the kernel
and the plain version sum in different orders), bf16 outputs to 2e-2
(one bf16 rounding of values of order 1, 2^-7, plus order effects).
K3 (quant_matmul) writes fp32 for either input type and is held to
|err| / (1 + |ref|) <= 1e-4.  K6 (the spill planes) is held to 1e-4
plane by plane and to bit equality across two runs.  K4 (limb_gemm,
both entries) and ``limb_matmul`` are integer and held bit-exact
(``torch.equal``).  K5 (ssd_intra and its
grouped entry) is held to 2e-4, the reference kernel test's tolerance,
and to bit equality across two launches; ``ssd_chunked`` with K5 inside
to a sequential fp64 recurrence within 2e-3, the reference model test's
tolerance (``tests/test_models.py``).
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch import configs as TC
from repro_torch.core import tiling
from repro_torch.core.dataflow import Dataflow
from repro_torch.core.scheduler import ScheduleCache
from repro_torch.kernels import limb_gemm as TLG
from repro_torch.kernels import mpgemm as TMP
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import quant_matmul as TQM
from repro_torch.kernels import ssd as TSSD
from repro_torch.kernels.ref import int_matmul_mod64_ref
from repro_torch.models import network as TN
from repro_torch.models.config import BlockKind
from repro_torch.models import ssm as TS
from repro_torch.serving.engine import ContinuousEngine, Request
from _torch_port import cuda  # noqa: F401  (fixture)

pytestmark = pytest.mark.gpu


def _decode_inputs(dev, dtype, B=8, KV=2, G=7, hd=64, bs=16, nbs=8,
                   lens=(0, 1, 16, 128, 77, 33, 5, 100)):
    gen = torch.Generator().manual_seed(3)
    nb = 1 + B * nbs
    q = torch.randn(B, KV, G, hd, generator=gen)
    k = torch.randn(nb, bs, KV, hd, generator=gen)
    v = torch.randn(nb, bs, KV, hd, generator=gen)
    table = (1 + torch.randperm(nb - 1, generator=gen)[:B * nbs]
             ).reshape(B, nbs).int()
    lens = torch.tensor(lens, dtype=torch.int32)
    for b in range(B):
        table[b, -(-int(lens[b]) // bs):] = 0        # NULL past the length
    return [t.to(dev, dtype) for t in (q, k, v)] + [table.to(dev),
                                                   lens.to(dev)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_decode_kernel_matches_plain(cuda, dtype, tol):
    args = _decode_inputs(cuda, dtype)
    before = TPA.launches.count
    for window, cap in ((None, None), (24, 30.0)):
        got = TPA.paged_decode(*args, scale=0.125, window=window,
                               logit_cap=cap)
        want = TPA.gather_fallback(*args, scale=0.125, window=window,
                                   logit_cap=cap)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert not got[0].any()                       # length-0 row: zeros
    assert TPA.launches.count == before + 2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_decode_int8_kernel_matches_plain(cuda, dtype, tol):
    q, k, v, table, lens = _decode_inputs(cuda, dtype)
    gen = torch.Generator().manual_seed(6)
    k8 = torch.randint(-127, 128, k.shape, generator=gen,
                       dtype=torch.int8).to(cuda)
    v8 = torch.randint(-127, 128, v.shape, generator=gen,
                       dtype=torch.int8).to(cuda)
    ks = (torch.rand(k.shape[:3], generator=gen) * 0.03).to(cuda)
    vs = (torch.rand(v.shape[:3], generator=gen) * 0.03).to(cuda)
    before, before_fp = TPA.launches_int8.count, TPA.launches.count
    for window, cap in ((None, None), (24, 30.0)):
        got = TPA.paged_decode(q, k8, v8, table, lens, scale=0.125,
                               window=window, logit_cap=cap, k_scale=ks,
                               v_scale=vs)
        want = TPA.gather_fallback(q, k8, v8, table, lens, scale=0.125,
                                   window=window, logit_cap=cap, k_scale=ks,
                                   v_scale=vs)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert not got[0].any()                       # length-0 row: zeros
    assert TPA.launches_int8.count == before + 2
    assert TPA.launches.count == before_fp            # the fp kernel: idle


#: K1's split-KV grid at its edges: (B, KV, G, hd, bs, nbs, lengths,
#: window, softcap).  qwen2 splits 64 positions (4 blocks of 16); B = 1
#: splits 32; nbs = 1 gives one split; hd 128 with G = 1 and 16 and hd
#: 112 with G = 1 are qwen1.5's, chatglm3's and zamba2's heads.
SPLIT_CASES = {
    "split_edges": (8, 2, 7, 64, 16, 64,
                    (63, 64, 65, 127, 128, 129, 0, 1024), None, None),
    "window_over_splits": (8, 2, 7, 64, 16, 64,
                           (1024, 700, 300, 129, 64, 5, 0, 1000), 200, None),
    "B1": (1, 2, 7, 64, 16, 64, (777,), None, 30.0),
    "nbs1": (8, 2, 7, 64, 16, 1, (0, 1, 15, 16, 8, 3, 2, 16), None, None),
    "bs8": (8, 2, 7, 64, 8, 32, (0, 1, 31, 32, 33, 256, 100, 7), 50, None),
    "hd128_G1": (8, 4, 1, 128, 16, 64, (0, 1, 63, 64, 65, 1024, 500, 9),
                 None, None),
    "hd128_G16": (8, 2, 16, 128, 16, 64, (0, 1, 63, 64, 65, 1024, 500, 9),
                  None, None),
    "hd112_G1": (4, 2, 1, 112, 16, 32, (0, 33, 64, 512), 100, None),
    # 36 bf16 = 72-byte rows: not 16-byte aligned, staged by byte copies
    "hd36_bytes": (3, 2, 5, 36, 16, 8, (0, 40, 128), None, None),
    # gemma2's local layers: hd 256 (MAX_HEAD_DIM), G 2, window 4096 and
    # softcap 50, lengths on both sides of the window
    "hd256_G2_gemma2": (8, 8, 2, 256, 16, 272,
                        (0, 1, 4095, 4096, 4097, 4200, 100, 4352), 4096,
                        50.0),
    # llava's (mistral's) sliding window: hd 128, G 4
    "hd128_G4_window": (8, 8, 4, 128, 16, 64,
                        (0, 1, 299, 300, 301, 1024, 700, 9), 300, None),
    # llama4-scout's heads: 40 over 8 KV heads (G 5), hd 128
    "hd128_G5_llama4": (8, 8, 5, 128, 16, 64,
                        (0, 1, 63, 64, 65, 1024, 500, 9), None, None),
    # zamba2's shared attention: 32 KV heads, G 1, hd 112
    "hd112_G1_zamba2": (8, 32, 1, 112, 16, 64,
                        (0, 1, 63, 64, 65, 1024, 500, 9), None, None),
}


def _split_inputs(dev, dtype, quant, B, KV, G, hd, bs, nbs, lens, seed=5):
    gen = torch.Generator().manual_seed(seed)
    nb = 1 + B * nbs
    q = torch.randn(B, KV, G, hd, generator=gen).to(dev, dtype)
    kw = {}
    if quant:
        k, v = (torch.randint(-127, 128, (nb, bs, KV, hd), generator=gen,
                              dtype=torch.int8).to(dev) for _ in range(2))
        kw = {n: (0.001 + 0.03 * torch.rand(nb, bs, KV, generator=gen)
                  ).to(dev) for n in ("k_scale", "v_scale")}
    else:
        k, v = (torch.randn(nb, bs, KV, hd, generator=gen).to(dev, dtype)
                for _ in range(2))
    table = (1 + torch.randperm(nb - 1, generator=gen)[:B * nbs]
             ).reshape(B, nbs).int()
    for b in range(B):
        table[b, -(-lens[b] // bs):] = 0             # NULL past the length
    lens_t = torch.tensor(lens, dtype=torch.int32)
    return [q, k, v, table.to(dev), lens_t.to(dev)], kw


@pytest.mark.parametrize("case", list(SPLIT_CASES))
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_decode_split_grid_matches_plain(cuda, dtype, tol, quant,
                                               case):
    """K1 / K1-int8 on the split grid ``split_plan`` gives: within the
    tolerance of the plain version, zeros for length-0 rows, and a
    repeated call bit-equal (a fixed-order combine, no atomics)."""
    B, KV, G, hd, bs, nbs, lens, window, cap = SPLIT_CASES[case]
    args, kw = _split_inputs(cuda, dtype, quant, B, KV, G, hd, bs, nbs,
                             lens)
    kw.update(scale=hd ** -0.5, window=window, logit_cap=cap)
    counter = TPA.launches_int8 if quant else TPA.launches
    before = counter.count
    got = TPA.paged_decode(*args, **kw)
    again = TPA.paged_decode(*args, **kw)
    want = TPA.gather_fallback(*args, **kw)
    torch.cuda.synchronize()
    assert counter.count == before + 2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    assert torch.equal(got, again)
    for b, n in enumerate(lens):
        if n == 0:
            assert not got[b].any()


def test_paged_decode_reads_no_device_value(cuda):
    """The wrapper sizes its grid from shapes alone: no host sync, for
    both pool types (what capturing the decode step in a graph needs)."""
    calls = [_split_inputs(cuda, torch.bfloat16, quant, 8, 2, 7, 64, 16, 64,
                           (0, 1, 63, 64, 65, 127, 128, 1024))
             for quant in (False, True)]
    for args, kw in calls:                  # build and load first
        TPA.paged_decode(*args, scale=0.125, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for args, kw in calls:
            TPA.paged_decode(*args, scale=0.125, window=300, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_kernel_matches_plain(cuda, dtype):
    """Both routes (fp32 x: CUDA cores; bf16 x: Hopper where TMA takes the
    layout) at M = 1 .. 2048 on the path's shapes, ragged M, N and K,
    odd N/K that take the scalar-copy path; bf16 repeats bit-equal, no
    device read, and each launch counted on its route."""
    gen = torch.Generator().manual_seed(5)
    shapes = [(M, N, K) for M in (1, 8, 64, 65, 256, 2048)
              for N, K in ((896, 896), (128, 896), (896, 4864))]
    shapes += [(5, 100, 200), (256, 4864, 896), (37, 1000, 900),
               (37, 1008, 904), (300, 131, 77)]
    TQM.reset_launches()
    want_routes = {r: 0 for r in TQM.ROUTES}
    for M, N, K in shapes:
        x = (torch.randn(M, K, generator=gen) * K ** -0.5).to(cuda, dtype)
        w = torch.randint(-127, 128, (K, N), generator=gen,
                          dtype=torch.int8).to(cuda)
        sc = (torch.rand(N, generator=gen) * 0.02).to(cuda)
        route = TQM.quant_matmul_route(x, w)
        tma = dtype == torch.bfloat16 and N % 16 == 0 and K % 8 == 0
        assert route == ("hopper" if tma else "cuda_core"), (M, N, K)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = TQM.quant_matmul(x, w, sc)
            again = TQM.quant_matmul(x, w, sc)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want_routes[route] += 2
        want = TQM.quant_matmul_ref(x, w, sc)
        torch.cuda.synchronize()
        rel = ((got - want).abs() / (1 + want.abs())).max().item()
        assert got.dtype == torch.float32 and rel <= 1e-4, (M, N, K, rel)
        assert torch.equal(got, again), (M, N, K)
    assert TQM.launches_by_route == want_routes
    assert TQM.launches.count == 2 * len(shapes)
    if dtype == torch.bfloat16:     # every chunk tile, asked for
        x = (torch.randn(300, 904, generator=gen) / 30).to(cuda, dtype)
        w = torch.randint(-127, 128, (904, 1008), generator=gen,
                          dtype=torch.int8).to(cuda)
        sc = (torch.rand(1008, generator=gen) * 0.02).to(cuda)
        want = TQM.quant_matmul_ref(x, w, sc)
        for tile in [t for t in TQM.QUANT_TILES if t[0] >= 64]:
            got = TQM.quant_matmul(x, w, sc, tile=tile)
            rel = ((got - want).abs() / (1 + want.abs())).max().item()
            assert rel <= 1e-4, (tile, rel)
            assert torch.equal(got, TQM.quant_matmul(x, w, sc, tile=tile))


@pytest.mark.parametrize("df", [Dataflow.OS, Dataflow.WS, Dataflow.IS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mpgemm_kernel_matches_plain(cuda, df, dtype):
    gen = torch.Generator().manual_seed(4)
    a = torch.randn(100, 200, generator=gen).to(cuda, dtype)
    b = torch.randn(200, 150, generator=gen).to(cuda, dtype)
    for (bm, bn), bk, f in itertools.product(tiling.KERNEL_TILES,
                                             (32, 64, 128), (1, 2)):
        for out_dtype in (torch.float32, dtype):
            got = TMP.mpgemm(a, b, dataflow=df, bm=bm, bn=bn, bk=bk,
                             k_fold=f, out_dtype=out_dtype)
            want = TMP.mpgemm_plain(a, b, bk=bk, k_fold=f,
                                    out_dtype=out_dtype)
            torch.cuda.synchronize()
            tol = 1e-4 if out_dtype == torch.float32 else 2e-2
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
    # a transposed operand (the LM head's table view) takes the strided path
    got = TMP.mpgemm(a, b.t().contiguous().t(), dataflow=df, bm=16, bn=64,
                     bk=32)
    torch.testing.assert_close(got, TMP.mpgemm_plain(a, b, bk=32, k_fold=1,
                                                     out_dtype=torch.float32),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("df", [Dataflow.OS, Dataflow.WS, Dataflow.IS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mpgemm_spill_kernel_matches_plain(cuda, df, dtype):
    """K6 plane by plane against its plain version: every tile, bk 32 to
    128, folds 1 to 3 on a K whose block count 6 divides at every bk (763:
    ragged), a transposed operand, and a repeat that must be bit-equal."""
    gen = torch.Generator().manual_seed(8)
    a = torch.randn(100, 763, generator=gen).to(cuda, dtype)
    b = torch.randn(763, 150, generator=gen).to(cuda, dtype)
    TMP.reset_launches()
    launched = 0
    for (bm, bn), bk, f in itertools.product(tiling.KERNEL_TILES,
                                             (32, 64, 128), (1, 2, 3)):
        got = TMP.mpgemm_spill(a, b, dataflow=df, bm=bm, bn=bn, bk=bk,
                               k_fold=f)
        want = TMP.mpgemm_spill_plain(a, b, dataflow=df, bk=bk, k_fold=f)
        torch.cuda.synchronize()
        launched += 1
        assert got.shape == want.shape == (
            TMP.spill_planes(763, bk, df, f), 100, 150)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    bt = b.t().contiguous().t()
    got = TMP.mpgemm_spill(a, bt, dataflow=df, bm=16, bn=64, bk=64, k_fold=2)
    again = TMP.mpgemm_spill(a, bt, dataflow=df, bm=16, bn=64, bk=64,
                             k_fold=2)
    torch.testing.assert_close(got, TMP.mpgemm_spill_plain(
        a, b, dataflow=df, bk=64, k_fold=2), rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)
    assert TMP.spill_launches.count == launched + 2
    assert TMP.launches.count == 0


@pytest.mark.parametrize("df", [Dataflow.OS, Dataflow.WS, Dataflow.IS])
def test_spill_matmul_matches_fused_on_card(cuda, df):
    """``ops.matmul(epilogue="spill")`` equals the fused path within 1e-4
    (the reference's GEMM bound: K2 sums the bands in registers, the spill
    path sums them with a torch reduction, and with N(0, 1) operands the
    two fp32 orders differ by up to 3e-5); OS with an effective fold of 1
    launches K2 and no K6, as the reference dispatches it."""
    gen = torch.Generator().manual_seed(2)
    a = torch.randn(64, 384, generator=gen).to(cuda)
    b = torch.randn(384, 256, generator=gen).to(cuda)
    fused = TOPS.matmul(a, b, dataflow=df, k_fold=3)
    TMP.reset_launches()
    spill = TOPS.matmul(a, b, dataflow=df, k_fold=3, epilogue="spill")
    torch.testing.assert_close(spill, fused, rtol=1e-4, atol=1e-4)
    assert (TMP.spill_launches.count, TMP.launches.count) == (1, 0)
    TMP.reset_launches()
    one = TOPS.matmul(a, b, dataflow=df, blocks=(16, 64, 128), k_fold=2,
                      epilogue="spill")                   # gk 3: f 2 -> 1
    torch.testing.assert_close(one, fused, rtol=1e-4, atol=1e-4)
    want = (0, 1) if df is Dataflow.OS else (1, 0)
    assert (TMP.spill_launches.count, TMP.launches.count) == want


def test_engine_backends_agree_on_card(cuda):
    """Scaled-down fp32: greedy tokens identical under both backends (the
    reference's paged_sched contract), every request finished."""
    base = TC.get("qwen2_0_5b").scaled_down()
    params = TN.init(base, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(3, base.vocab, int(rng.integers(5, 60))
                                    ).astype(np.int32), 8, eos=-1)
            for i in range(4)]
    tokens = {}
    for backend in ("xla", "scheduled"):
        cfg = dataclasses.replace(base, gemm_backend=backend)
        eng = ContinuousEngine(cfg, params, slots=2, max_len=128,
                               audit=True, device=cuda)
        res = eng.run(reqs)
        assert all(r.status == "ok" and len(r.tokens) == 8 for r in res)
        tokens[backend] = {r.rid: r.tokens.tolist() for r in res}
    assert tokens["xla"] == tokens["scheduled"]


def test_quant_engine_backends_agree_on_card(cuda):
    """Quantized scaled-down fp32 (weights x5, every projection int8):
    greedy tokens identical under both backends, K3 only under
    scheduled, K1-int8 on every decode step of both."""
    from repro_torch.models.layers import tree_map
    from repro_torch.quant.policy import QuantPolicy
    base = dataclasses.replace(TC.get("qwen2_0_5b").scaled_down(),
                               quant_serving=True)
    params = tree_map(lambda _p, a: a * 5.0,
                      TN.init(base, seed=0, device=cuda))
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(3, base.vocab, int(rng.integers(5, 60))
                                    ).astype(np.int32), 8, eos=-1)
            for i in range(4)]
    tokens = {}
    for backend in ("xla", "scheduled"):
        cfg = dataclasses.replace(base, gemm_backend=backend)
        eng = ContinuousEngine(cfg, params, slots=2, max_len=128,
                               audit=True, quant_policy=QuantPolicy(
                                   min_size=0), device=cuda)
        TQM.launches.reset()
        TPA.launches_int8.reset()
        res = eng.run(reqs)
        assert all(r.status == "ok" and len(r.tokens) == 8 for r in res)
        assert TPA.launches_int8.count == base.n_layers * eng.steps
        assert (TQM.launches.count > 0) == (backend == "scheduled")
        tokens[backend] = {r.rid: r.tokens.tolist() for r in res}
    assert tokens["xla"] == tokens["scheduled"]


@pytest.mark.parametrize("la,lb", [(2, 2), (3, 3), (5, 5), (2, 5)])
def test_limb_gemm_kernel_matches_plain(cuda, la, lb):
    """K4's planes entry bit-exact against its plain version on ragged
    shapes (M or N of 1 and 2, K of 1, 7 and 129, rows not 16-byte
    aligned), every tile of the digit count, limbs over the whole int8
    range; each launch repeated bit-equal."""
    gen = torch.Generator().manual_seed(la * 10 + lb)
    before = TLG.launches.count
    shapes = [(65, 130, 100), (33, 257, 129), (1, 70, 64), (70, 1, 33),
              (2, 45, 7), (300, 2, 1), (37, 45, 83)]
    tiles = (None,) + TLG.tiles_for(max(la, lb))
    launched = 0
    for (M, N, K), blocks in itertools.product(shapes, tiles):
        a = torch.randint(-128, 128, (la, M, K), generator=gen,
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (lb, K, N), generator=gen,
                          dtype=torch.int8)
        got = TLG.limb_gemm_diagonals(a.to(cuda), b.to(cuda), blocks=blocks)
        again = TLG.limb_gemm_diagonals(a.to(cuda), b.to(cuda),
                                        blocks=blocks)
        want = TLG.limb_gemm_diagonals_ref(a, b)
        torch.cuda.synchronize()
        launched += 2
        assert torch.equal(got.cpu(), want), (M, N, K, blocks)
        assert torch.equal(got, again), (M, N, K, blocks)
    assert TLG.launches.count - before == launched


def test_limb_matmul_int8_at_max_k(cuda):
    """int8 at K = 2^17, every value -128: each output is 2^17 * 2^14 =
    2^31, one CTA summing the whole K (1024 x 1024 fills the card without
    a split).  A single int8 digit would wrap its int32 plane there; the
    plan takes two digits and the result equals the plain version and the
    closed form."""
    K = TLG.MAX_K
    a = torch.full((1024, K), -128, dtype=torch.int8, device=cuda)
    b = torch.full((K, 1024), -128, dtype=torch.int8, device=cuda)
    assert TLG.limb_plan(1024, 1024, K, 2, 2).ranks == 1
    hi, lo = TOPS.limb_matmul(a, b)
    whi, wlo = TLG.limb_matmul_fused_ref(a, b, 2, 2)
    assert torch.equal(hi, whi) and torch.equal(lo, wlo)
    assert hi.eq(0).all() and lo.eq(-2 ** 31).all()


def test_limb_matmul_int32_at_max_k(cuda):
    """int32 at K = 2^17, every value -135274560 (digits -64, -64, -64,
    -64, 0): plane 3 sums 4 x 4096 a k, 2^31 over the whole K, one past
    int32.  1024 x 1024 fills the card without a split, so the plan takes
    two cluster ranks to stay exact; every output equals the mod-2^64
    oracle of one row (all rows are alike) and the plain version."""
    K, v = TLG.MAX_K, -135274560
    assert TLG.limb_plan(1024, 1024, K, 5, 5, 4, 4).ranks >= 2
    a = torch.full((1024, K), v, dtype=torch.int32, device=cuda)
    b = torch.full((K, 1024), v, dtype=torch.int32, device=cuda)
    before = TLG.launches.count
    hi, lo = TOPS.limb_matmul(a, b)
    torch.cuda.synchronize()
    assert TLG.launches.count - before == 1
    row = np.full((1, K), v, np.int32)
    whi, wlo = int_matmul_mod64_ref(row, row.T)
    assert ((int(whi[0, 0]) << 32) | (int(wlo[0, 0]) & 0xFFFFFFFF)
            == 436875690109829120)
    assert hi.eq(int(whi[0, 0])).all() and lo.eq(int(wlo[0, 0])).all()
    phi, plo = TLG.limb_matmul_fused_ref(a[:2], b[:, :3], 5, 5)
    assert torch.equal(hi[:2, :3], phi) and torch.equal(lo[:2, :3], plo)


def _raw(gen, dtype, shape, lo=None, hi=None):
    info = torch.iinfo(dtype)
    lo = info.min if lo is None else lo
    hi = info.max if hi is None else hi
    x = torch.randint(lo, hi + 1, shape, generator=gen,
                      dtype=torch.int64).to(dtype)
    x.view(-1)[0], x.view(-1)[-1] = lo, hi
    return x


@pytest.mark.parametrize("dtype,nl", [(torch.int8, 2), (torch.int16, 3),
                                      (torch.int32, 5)])
def test_limb_matmul_fused_matches_plain(cuda, dtype, nl):
    """K4's fused entry bit-exact against its plain version (the unfused
    composition) at the dtype's extremes, on ragged shapes and every tile
    of its digit count, each launch repeated bit-equal; one launch a
    call."""
    gen = torch.Generator().manual_seed(nl)
    shapes = [(47, 33, 96), (1, 70, 64), (70, 1, 33), (2, 45, 7),
              (300, 2, 1), (33, 17, 129), (32, 300, 2000)]
    tiles = (None,) + TLG.tiles_for(TLG.digits_for(dtype.itemsize * 8, nl, 1))
    before = TLG.launches.count
    launched = 0
    for (M, N, K), blocks in itertools.product(shapes, tiles):
        a, b = _raw(gen, dtype, (M, K)), _raw(gen, dtype, (K, N))
        got = TOPS.limb_matmul(a.to(cuda), b.to(cuda), blocks=blocks)
        again = TOPS.limb_matmul(a.to(cuda), b.to(cuda), blocks=blocks)
        want = TLG.limb_matmul_fused_ref(a, b, nl, nl)
        torch.cuda.synchronize()
        launched += 2
        for g, w, r in zip(got, want, again):
            assert torch.equal(g.cpu(), w), (M, N, K, blocks)
            assert torch.equal(g, r), (M, N, K, blocks)
    assert TLG.launches.count - before == launched


@pytest.mark.parametrize("over", [dict(ranks=1), dict(ranks=2, stages=1),
                                  dict(ranks=3, stages=2), dict(stages=4),
                                  dict(qs=2), dict(qs=4)], ids=str)
def test_limb_plans_forced(cuda, monkeypatch, over):
    """Both entries under forced K splits, ring depths and sub-tile walks,
    on the B route by TMA (int8, N % 16 == 0) and by cp.async, bit-equal
    to the plain versions."""
    gen = torch.Generator().manual_seed(11)
    plan = TLG.limb_plan

    def forced(*a, **k):
        try:
            return plan(*a, **{**k, **over})
        except ValueError:                 # a ring too deep for int32
            return plan(*a, **{**k, **over, "stages": 1})
    monkeypatch.setattr(TLG, "limb_plan", forced)
    one_stage = "qs" in over
    cases = [(torch.int8, 2, 32, 512, 100 if one_stage else 1000),
             (torch.int8, 2, 20, 200, 100 if one_stage else 700),
             (torch.int16, 3, 70, 40, 100 if one_stage else 515),
             (torch.int32, 5, 96, 64, 64 if one_stage else 300)]
    for dt, nl, M, N, K in cases:
        a, b = _raw(gen, dt, (M, K)), _raw(gen, dt, (K, N))
        hi, lo = TOPS.limb_matmul(a.to(cuda), b.to(cuda))
        whi, wlo = TLG.limb_matmul_fused_ref(a, b, nl, nl)
        assert torch.equal(hi.cpu(), whi) and torch.equal(lo.cpu(), wlo), \
            (dt, M, N, K)
        al, bl = TLG.limb_decompose(a, nl), TLG.limb_decompose(b, nl)
        got = TLG.limb_gemm_diagonals(al.to(cuda), bl.to(cuda))
        assert torch.equal(got.cpu(), TLG.limb_gemm_diagonals_ref(al, bl)), \
            (dt, M, N, K)


@pytest.mark.parametrize("ta,tb,in_bits,rng", [
    (torch.int32, torch.int16, 16, (-2 ** 15, 2 ** 15 - 1)),
    (torch.int8, torch.int32, 32, None), (torch.int32, torch.int8, 8, None),
    (torch.int32, torch.int32, 8, None), (torch.int32, torch.int32, 20, None),
    (torch.int8, torch.int8, 7, None)])
def test_limb_matmul_fused_mixed_in_bits(cuda, ta, tb, in_bits, rng):
    """Mixed dtypes with ``in_bits``, and values wider than ``in_bits``
    (the remainder dropped as the composition drops it)."""
    gen = torch.Generator().manual_seed(in_bits)
    nl = -(-in_bits // 7)
    a = _raw(gen, ta, (50, 70), *(rng or (None, None)))
    b = _raw(gen, tb, (70, 33))
    hi, lo = TOPS.limb_matmul(a.to(cuda), b.to(cuda), in_bits=in_bits)
    whi, wlo = TLG.limb_matmul_fused_ref(a, b, nl, nl)
    assert torch.equal(hi.cpu(), whi) and torch.equal(lo.cpu(), wlo)


def test_limb_matmul_one_kernel_a_call(cuda):
    """One CUDA kernel a ``limb_matmul`` call, by the launch counter and by
    ``torch.profiler``, and no device value read by the wrapper."""
    gen = torch.Generator().manual_seed(4)
    pairs = [(_raw(gen, dt, (M, K)).to(cuda), _raw(gen, dt, (K, N)).to(cuda))
             for dt, M, N, K in ((torch.int32, 96, 64, 160),
                                 (torch.int16, 300, 2, 128),
                                 (torch.int8, 32, 500, 3000))]
    torch.cuda.synchronize()
    before = TLG.launches.count
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for a, b in pairs:
            TOPS.limb_matmul(a, b)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    assert TLG.launches.count - before == len(pairs)
    assert kernels == len(pairs)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for a, b in pairs:
            TOPS.limb_matmul(a, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_limb_matmul_exact_on_card(cuda, dtype):
    """ops.limb_matmul on the card equals the numpy mod-2^64 oracle, with
    the dtype's extremes in the operands."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(7)
    a = rng.integers(info.min, info.max, (47, 96), dtype=dtype,
                     endpoint=True)
    b = rng.integers(info.min, info.max, (96, 33), dtype=dtype,
                     endpoint=True)
    a[0, :], b[:, 0] = info.min, info.max
    hi, lo = TOPS.limb_matmul(torch.from_numpy(a).to(cuda),
                              torch.from_numpy(b).to(cuda))
    rhi, rlo = int_matmul_mod64_ref(a, b)
    assert np.array_equal(hi.cpu().numpy(), rhi)
    assert np.array_equal(lo.cpu().numpy(), rlo)


def test_multiprecision_entry_point_on_card(cuda, capsys):
    """``python -m repro_torch.launch.multiprecision_gemm`` on the card:
    exact, through K4."""
    from repro_torch.launch import multiprecision_gemm
    before = TLG.launches.count
    assert multiprecision_gemm.main([]) is True
    assert TLG.launches.count == before + 1
    assert "exact INT32 matmul mod 2^64: True" in capsys.readouterr().out


@pytest.mark.parametrize("Q", [32, 256])
def test_ssd_intra_kernel_matches_plain(cuda, Q):
    """K5 at the engine's default chunk (32) and the published one (256),
    P = 64, N = 128, dt ~ softplus(N(0, 1)): cums fall by about 200 over
    256 steps, so every masked exponent above the diagonal overflows."""
    gen = torch.Generator().manual_seed(Q)
    G, P, N = 24, 64, 128
    dt = torch.nn.functional.softplus(torch.randn(G, Q, generator=gen))
    args = [torch.randn(G, Q, P, generator=gen), dt,
            torch.cumsum(-dt, dim=1), torch.randn(G, Q, N, generator=gen),
            torch.randn(G, Q, N, generator=gen)]
    args = [a.to(cuda) for a in args]
    before = TSSD.launches.count
    got = TSSD.ssd_intra(*args)
    want = TSSD.ssd_intra_ref(*args)
    torch.cuda.synchronize()
    assert TSSD.launches.count == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def _grouped_ssd_inputs(dev, B, nc, Q, H, G, P, N, seed, fall=None, pad=0,
                        strided=False):
    """K5's grouped operands: dt = softplus(N(0, 1)) (cums fall by about
    200 over 256 rows), ``fall`` a linear fall of cums over the chunk,
    ``pad`` dt = 0 on the last rows, ``strided`` x, B and C as slices of
    one wider tensor (the conv output's layout)."""
    gen = torch.Generator().manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn(B, nc, Q, H, generator=gen))
    if pad:
        dt[:, :, Q - pad:] = 0.0
    cums = torch.cumsum(-dt, dim=2)
    if fall is not None:
        cums = torch.linspace(0.0, -fall, Q)[None, None, :, None].expand(
            B, nc, Q, H).contiguous()
    wide = torch.randn(B, nc, Q, H * P + 2 * G * N + 4, generator=gen)
    if strided:
        x = wide[..., :H * P].view(B, nc, Q, H, P)
        b = wide[..., H * P:H * P + G * N].view(B, nc, Q, G, N)
        c = wide[..., H * P + G * N:H * P + 2 * G * N].view(B, nc, Q, G, N)
    else:
        x = wide[..., :H * P].reshape(B, nc, Q, H, P).contiguous()
        b = torch.randn(B, nc, Q, G, N, generator=gen)
        c = torch.randn(B, nc, Q, G, N, generator=gen)
    return [t.to(dev) for t in (x, dt, cums, b, c)]


@pytest.mark.parametrize("shape,kw", [
    ((8, 1, 256, 80, 1, 64, 128), {}),
    ((8, 1, 32, 80, 1, 64, 128), {}),
    ((8, 2, 256, 26, 2, 64, 128), {}),
    ((2, 1, 100, 8, 2, 24, 40), {}),
    ((2, 1, 100, 8, 2, 18, 10), {}),
    ((2, 2, 256, 16, 1, 64, 128), {"strided": True}),
    ((2, 1, 256, 16, 1, 64, 128), {"fall": 300.0}),
    ((2, 1, 256, 16, 1, 64, 128), {"pad": 100}),
    # zamba2's SSD: H 112, P 64, N 64 at the published chunk and at 32
    ((8, 1, 256, 112, 1, 64, 64), {}),
    ((8, 1, 32, 112, 1, 64, 64), {}),
], ids=["full-width", "Q32", "G2-ragged-head-block", "ragged-Q",
        "scalar-copies", "strided-views", "cums-fall-300", "dt0-pad-100",
        "zamba2", "zamba2-Q32"])
def test_ssd_intra_chunked_kernel_matches_plain(cuda, shape, kw):
    """K5's grouped entry against its plain version (2e-4), finite where
    every masked exponent overflows, and two launches bit-equal."""
    B, nc, Q, H, G, P, N = shape
    args = _grouped_ssd_inputs(cuda, *shape, seed=sum(shape), **kw)
    plan = TSSD.ssd_plan(B, nc, Q, H, G)
    if shape[2:5] == (256, 26, 2):
        assert (H // G) % plan.head_block != 0
    before = TSSD.launches.count
    got = TSSD.ssd_intra_chunked(*args)
    again = TSSD.ssd_intra_chunked(*args)
    want = TSSD.ssd_intra_chunked_ref(*args)
    torch.cuda.synchronize()
    assert TSSD.launches.count == before + 2
    assert got.shape == (B, nc, Q, H, P)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert torch.equal(got, again)


def test_ssd_intra_reads_no_device_value(cuda):
    """The wrapper sizes its grid from shapes alone: no host sync."""
    calls = [_grouped_ssd_inputs(cuda, 8, 1, 256, 80, 1, 64, 128, seed=5),
             _grouped_ssd_inputs(cuda, 2, 1, 100, 8, 2, 18, 10, seed=6)]
    for args in calls:                      # build and load first
        TSSD.ssd_intra_chunked(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for args in calls:
            TSSD.ssd_intra_chunked(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_ssd_chunked_matches_recurrence_on_card(cuda):
    """``ssd_chunked`` (K5 inside) over two chunks of 256 with an initial
    state, against h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t
    stepped one token at a time in fp64."""
    gen = torch.Generator().manual_seed(1)
    B, S, H, P, G, N = 1, 512, 8, 64, 1, 128
    x = torch.randn(B, S, H, P, generator=gen)
    dt = 0.01 + 0.19 * torch.rand(B, S, H, generator=gen)
    A = -(0.5 + 1.5 * torch.rand(H, generator=gen))
    Bm = torch.randn(B, S, G, N, generator=gen)
    Cm = torch.randn(B, S, G, N, generator=gen)
    h0 = torch.randn(B, H, P, N, generator=gen)
    before = TSSD.launches.count
    y, h = TS.ssd_chunked(*(t.to(cuda) for t in (x, dt, A, Bm, Cm)), 256,
                          h0.to(cuda))
    assert TSSD.launches.count == before + 1
    hr, ys = h0.double().to(cuda), []
    xd, dtd, Ad, Bd, Cd = (t.double().to(cuda) for t in (x, dt, A, Bm, Cm))
    for t in range(S):
        hr = hr * torch.exp(dtd[:, t] * Ad)[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", xd[:, t] * dtd[:, t, :, None], Bd[:, t, 0])
        ys.append(torch.einsum("bn,bhpn->bhp", Cd[:, t, 0], hr))
    torch.testing.assert_close(y.double(), torch.stack(ys, 1), rtol=2e-3,
                               atol=2e-3)
    torch.testing.assert_close(h.double(), hr, rtol=2e-3, atol=2e-3)


def test_mamba_engine_backends_agree_on_card(cuda):
    """Scaled-down fp32 mamba2 at prefill_chunk 32 and 64: greedy tokens
    identical under both backends, K5 launched once a layer a chunk step
    and never in decode, K2 only under scheduled."""
    base = TC.get("mamba2_2_7b").scaled_down()
    params = TN.init(base, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(3, base.vocab, int(n)).astype(np.int32),
                    8, eos=-1) for i, n in enumerate((5, 40, 70, 33))]
    for chunk in (32, 64):
        tokens = {}
        for backend in ("xla", "scheduled"):
            cfg = dataclasses.replace(base, gemm_backend=backend)
            eng = ContinuousEngine(cfg, params, slots=2, max_len=128,
                                   prefill_chunk=chunk, audit=True,
                                   device=cuda)
            TSSD.launches.reset()
            TMP.reset_launches()
            res = eng.run(reqs)
            assert all(r.status == "ok" and len(r.tokens) == 8 for r in res)
            assert TSSD.launches.count == base.n_layers * eng.chunk_steps
            assert (TMP.launches.count > 0) == (backend == "scheduled")
            tokens[backend] = {r.rid: r.tokens.tolist() for r in res}
        assert tokens["xla"] == tokens["scheduled"]


# ---------------------------------------------------------------------------
# K2 / K6 on the Hopper route (bf16 wgmma fed by TMA)
# ---------------------------------------------------------------------------

def _bf16_operands(dev, M, N, K, seed, b_layout="kn"):
    """a (M, K) ~ N(0, 1/K) and b (K, N) ~ N(0, 1) in bf16; ``b_layout``
    "kn" is a (K, N) weight (N contiguous), "nk" the transposed view of a
    (N, K) table (K contiguous, as the tied LM head)."""
    gen = torch.Generator().manual_seed(seed)
    a = (torch.randn(M, K, generator=gen) * K ** -0.5).to(dev, torch.bfloat16)
    if b_layout == "kn":
        b = torch.randn(K, N, generator=gen).to(dev, torch.bfloat16)
    else:
        b = torch.randn(N, K, generator=gen).to(dev, torch.bfloat16).t()
    return a, b


#: (M, N, K): qwen2-0.5b's decode and chunk rows, its head, mamba2's
#: in_proj and out_proj at decode and chunk rows, a ragged shape TMA can
#: still describe, and the swapped tiles n = 8 .. 64
HOPPER_SHAPES = [(8, 896, 896), (8, 128, 896), (8, 896, 4864),
                 (8, 151936, 896), (8, 10576, 2560), (8, 2560, 5120),
                 (37, 1000, 904), (16, 640, 512), (30, 320, 1024),
                 (64, 512, 640), (256, 896, 896), (200, 600, 1000),
                 (2048, 10576, 2560), (2048, 2560, 5120)]


@pytest.mark.parametrize("b_layout", ["kn", "nk"])
@pytest.mark.parametrize("df", [Dataflow.OS, Dataflow.WS, Dataflow.IS])
def test_mpgemm_hopper_route_matches_plain(cuda, df, b_layout):
    """K2 on the Hopper route against its plain version at the tile
    ``plan_blocks`` picks and at every Hopper tile: fp32 out within 1e-4
    and bf16 out within 1e-2 of 1 + |ref| (the bf16 rounding of values of
    order 1); every launch takes the Hopper route; a repeat is
    bit-equal."""
    TMP.reset_launches()
    n = 0
    for M, N, K in HOPPER_SHAPES:
        a, b = _bf16_operands(cuda, M, N, K, M + N + K, b_layout)
        assert TMP.mpgemm_route(a, b, 128) == "hopper"
        tiles = {TOPS.plan_blocks(M, N, K, 2, df, 1)[:2]}
        if (M, N, K) == (37, 1000, 904):
            tiles |= set(tiling.HOPPER_TILES)
        for (bm, bn), out_dtype in itertools.product(
                sorted(tiles), (torch.float32, torch.bfloat16)):
            got = TMP.mpgemm(a, b, dataflow=df, bm=bm, bn=bn, bk=128,
                             out_dtype=out_dtype)
            want = TMP.mpgemm_plain(a, b, bk=128, k_fold=1,
                                    out_dtype=out_dtype)
            again = TMP.mpgemm(a, b, dataflow=df, bm=bm, bn=bn, bk=128,
                               out_dtype=out_dtype)
            torch.cuda.synchronize()
            n += 2
            tol = 1e-4 if out_dtype == torch.float32 else 1e-2
            rel = ((got.float() - want.float()).abs()
                   / (1 + want.float().abs())).max().item()
            assert got.dtype == out_dtype and rel <= tol, \
                (M, N, K, bm, bn, str(out_dtype), rel)
            assert torch.equal(got, again), (M, N, K, bm, bn)
    assert TMP.launches_by_route == {"hopper": n, "cuda_core": 0}


#: (M, N, K, b_layout) at decode rows (8 slots) of the families served
#: since qwen1.5: each one's q, k/v, o, gate/up and down projections (or
#: zamba2's mamba in_proj and out_proj) and its head; "nk" heads are the
#: transposed (V, D) table
FAMILY_SHAPES = {
    "qwen1_5_4b": [(8, 2560, 2560, "kn"), (8, 6912, 2560, "kn"),
                   (8, 2560, 6912, "kn"), (8, 151936, 2560, "nk")],
    "chatglm3_6b": [(8, 4096, 4096, "kn"), (8, 256, 4096, "kn"),
                    (8, 13696, 4096, "kn"), (8, 4096, 13696, "kn"),
                    (8, 65024, 4096, "nk")],
    "gemma2_9b": [(8, 4096, 3584, "kn"), (8, 2048, 3584, "kn"),
                  (8, 3584, 4096, "kn"), (8, 14336, 3584, "kn"),
                  (8, 3584, 14336, "kn"), (8, 256000, 3584, "nk")],
    "llava_next_mistral_7b": [(8, 1024, 4096, "kn"), (8, 14336, 4096, "kn"),
                              (8, 4096, 14336, "kn"),
                              (8, 32000, 4096, "nk")],
    "zamba2_7b": [(8, 3584, 3584, "kn"), (8, 14576, 3584, "kn"),
                  (8, 3584, 7168, "kn"), (8, 32000, 3584, "nk")],
    # llama4-scout: q/o, k/v, the router (N = 16) at decode and chunk
    # rows, the shared expert and the head
    "llama4_scout_17b_a16e": [(8, 5120, 5120, "kn"), (8, 1024, 5120, "kn"),
                              (8, 16, 5120, "kn"), (2048, 16, 5120, "kn"),
                              (8, 8192, 5120, "kn"), (8, 5120, 8192, "kn"),
                              (8, 202048, 5120, "nk")],
    # deepseek-v2: wq_a, wq_b, wkv_a and wo at decode rows, a wk_b / wv_b
    # decompression over 2048 gathered rows, the router (N = 160), the
    # shared experts' gate, the first block's MLP gate and the head
    "deepseek_v2_236b": [(8, 1536, 5120, "kn"), (8, 24576, 1536, "kn"),
                         (8, 576, 5120, "kn"), (8, 5120, 16384, "kn"),
                         (2048, 16384, 512, "kn"), (8, 160, 5120, "kn"),
                         (8, 3072, 5120, "kn"), (8, 12288, 5120, "kn"),
                         (8, 102400, 5120, "nk")],
}


@pytest.mark.parametrize("arch", list(FAMILY_SHAPES))
def test_mpgemm_hopper_family_shapes(cuda, arch):
    """K2 at each family's decode GEMMs through ``ops.matmul`` under the
    schedule cache (the engine's call: its dataflow and fold), fp32 and
    bf16 out, against the plain version (the tolerances of
    ``test_mpgemm_hopper_route_matches_plain``), every launch on the
    Hopper route, a repeat bit-equal."""
    schedule = ScheduleCache()
    TMP.reset_launches()
    n = 0
    for M, N, K, layout in FAMILY_SHAPES[arch]:
        a, b = _bf16_operands(cuda, M, N, K, M + N + K, layout)
        for out_dtype in (torch.float32, torch.bfloat16):
            got = TOPS.matmul(a, b, out_dtype=out_dtype, schedule=schedule)
            again = TOPS.matmul(a, b, out_dtype=out_dtype,
                                schedule=schedule)
            want = TMP.mpgemm_plain(a, b, bk=128, k_fold=1,
                                    out_dtype=out_dtype)
            torch.cuda.synchronize()
            n += 2
            tol = 1e-4 if out_dtype == torch.float32 else 1e-2
            rel = ((got.float() - want.float()).abs()
                   / (1 + want.float().abs())).max().item()
            assert got.dtype == out_dtype and rel <= tol, \
                (M, N, K, str(out_dtype), rel)
            assert torch.equal(got, again), (M, N, K)
    assert TMP.launches_by_route == {"hopper": n, "cuda_core": 0}


#: the dense path's K2 calls: qwen2-0.5b's q, k/v, o, gate/up and down at
#: a dense admission (batch 1, a bucket of rows) with its head over the
#: one last row, and llava's vision_proj over four rows of 1152 patches
DENSE_SHAPES = {
    **{f"qwen2-admission-{M}": [(M, 896, 896, "kn"), (M, 128, 896, "kn"),
                                (M, 4864, 896, "kn"), (M, 896, 4864, "kn"),
                                (1, 151936, 896, "nk")]
       for M in (16, 512, 1024)},
    "llava-vision-proj": [(4608, 4096, 4096, "kn")],
}


@pytest.mark.parametrize("case", list(DENSE_SHAPES))
def test_mpgemm_hopper_dense_path_shapes(cuda, case):
    """K2 at the dense engine's admission rows and llava's vision_proj
    through ``ops.matmul`` under a schedule cache (the engine's call),
    against the plain version with the tolerances of
    ``test_mpgemm_hopper_family_shapes``; every launch on the Hopper
    route, a repeat bit-equal."""
    schedule = ScheduleCache()
    TMP.reset_launches()
    n = 0
    for M, N, K, layout in DENSE_SHAPES[case]:
        a, b = _bf16_operands(cuda, M, N, K, M + N + K, layout)
        out_dtype = torch.float32 if layout == "nk" else torch.bfloat16
        got = TOPS.matmul(a, b, out_dtype=out_dtype, schedule=schedule)
        again = TOPS.matmul(a, b, out_dtype=out_dtype, schedule=schedule)
        want = TMP.mpgemm_plain(a, b, bk=128, k_fold=1, out_dtype=out_dtype)
        torch.cuda.synchronize()
        n += 2
        tol = 1e-4 if out_dtype == torch.float32 else 1e-2
        rel = ((got.float() - want.float()).abs()
               / (1 + want.float().abs())).max().item()
        assert got.dtype == out_dtype and rel <= tol, (M, N, K, rel)
        assert torch.equal(got, again), (M, N, K)
    assert TMP.launches_by_route == {"hopper": n, "cuda_core": 0}


@pytest.mark.parametrize("shape,tail", [
    ((1, 2, 256, 80, 1, 64, 128), 150),
    ((1, 4, 256, 112, 1, 64, 64), 40),
    ((1, 1, 64, 80, 1, 64, 128), 20),
], ids=["mamba2-bucket-512", "zamba2-bucket-1024", "mamba2-bucket-64"])
def test_ssd_intra_chunked_dense_admission(cuda, shape, tail):
    """K5's grouped entry at a dense admission: batch 1, the bucket's
    chunks, and the prompt's pad tail (dt = 0, the masked update) on the
    last ``tail`` rows of the last chunk only; 2e-4 of the plain version,
    two launches bit-equal."""
    B, nc, Q, H, G, P, N = shape
    x, dt, _cums, b, c = _grouped_ssd_inputs(cuda, *shape, seed=sum(shape))
    dt[:, -1, Q - tail:] = 0.0
    cums = torch.cumsum(-dt, dim=2)
    args = (x, dt, cums, b, c)
    before = TSSD.launches.count
    got = TSSD.ssd_intra_chunked(*args)
    again = TSSD.ssd_intra_chunked(*args)
    want = TSSD.ssd_intra_chunked_ref(*args)
    torch.cuda.synchronize()
    assert TSSD.launches.count == before + 2
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert torch.equal(got, again)


@pytest.mark.parametrize("fold", [2, 3, 4, 8])
def test_mpgemm_hopper_fold_bands_on_a_cluster(cuda, fold):
    """OS with k_fold 2, 3, 4 and 8 (bands over a cluster of at most 8
    ranks, and more bands than ranks where the tiles leave fewer than
    eight CTAs a tile), fused and spilled, against the plain versions."""
    TMP.reset_launches()
    for M, N, K in ((8, 896, 3072), (256, 896, 3072), (2048, 2560, 3072)):
        a, b = _bf16_operands(cuda, M, N, K, fold)
        bm, bn = tiling.hopper_tile(M, N)
        f = TMP.effective_fold(K, 128, fold)
        assert f == fold
        got = TMP.mpgemm(a, b, dataflow=Dataflow.OS, bm=bm, bn=bn, bk=128,
                         k_fold=f)
        want = TMP.mpgemm_plain(a, b, bk=128, k_fold=f,
                                out_dtype=torch.float32)
        planes = TMP.mpgemm_spill(a, b, dataflow=Dataflow.OS, bm=bm, bn=bn,
                                  bk=128, k_fold=f)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(planes, TMP.mpgemm_spill_plain(
            a, b, dataflow=Dataflow.OS, bk=128, k_fold=f), rtol=1e-4,
            atol=1e-4)
        assert torch.equal(got, TMP.mpgemm(a, b, dataflow=Dataflow.OS, bm=bm,
                                           bn=bn, bk=128, k_fold=f))
    assert TMP.launches_by_route["cuda_core"] == 0
    assert TMP.spill_launches_by_route == {"hopper": 3, "cuda_core": 0}


@pytest.mark.parametrize("b_layout", ["kn", "nk"])
@pytest.mark.parametrize("df", [Dataflow.WS, Dataflow.IS])
def test_mpgemm_hopper_spill_planes(cuda, df, b_layout):
    """K6 on the Hopper route under WS/IS: one plane per K block (bk 64
    and 128, a ragged last block), each within 1e-4 of the plain plane,
    and a repeat bit-equal."""
    TMP.reset_launches()
    for (M, N, K), bk in itertools.product(((8, 896, 904), (256, 896, 1024),
                                            (37, 1000, 904)), (64, 128)):
        a, b = _bf16_operands(cuda, M, N, K, bk, b_layout)
        bm, bn = tiling.hopper_tile(M, N)
        got = TMP.mpgemm_spill(a, b, dataflow=df, bm=bm, bn=bn, bk=bk)
        want = TMP.mpgemm_spill_plain(a, b, dataflow=df, bk=bk, k_fold=1)
        again = TMP.mpgemm_spill(a, b, dataflow=df, bm=bm, bn=bn, bk=bk)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (-(-K // bk), M, N)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        assert torch.equal(got, again)
    assert TMP.spill_launches_by_route == {"hopper": 12, "cuda_core": 0}


def test_mpgemm_route_rule_on_card(cuda):
    """fp32 and bf16 operands TMA refuses (K = 763: a row of 1526 bytes)
    take the CUDA-core route and still match the plain version."""
    TMP.reset_launches()
    a, b = _bf16_operands(cuda, 100, 150, 763, 1)
    for x, y in ((a, b), (a.float(), b.float())):
        assert TMP.mpgemm_route(x, y, 64) == "cuda_core"
        got = TMP.mpgemm(x, y, dataflow=Dataflow.IS, bm=8, bn=64, bk=64)
        torch.testing.assert_close(got, TMP.mpgemm_plain(
            x, y, bk=64, k_fold=1, out_dtype=torch.float32), rtol=1e-4,
            atol=1e-4)
    assert TMP.launches_by_route == {"hopper": 0, "cuda_core": 2}


def test_gemm_tiles_entry_point_on_card(cuda, capsys):
    """``launch.gemm_tiles`` times every candidate tile of a decode and a
    chunk shape and the host cost of a call."""
    from repro_torch.launch import gemm_tiles
    gemm_tiles.main(["--shapes", "8x256x128,256x512x128"])
    out = capsys.readouterr().out
    assert "(8, 256, 128)" in out and "(256, 512, 128)" in out
    assert "8x64" in out and "128x256" in out and "host time" in out


def _serving_requests(vocab, n=4, new=8):
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(3, vocab, int(rng.integers(5, 60))
                                    ).astype(np.int32), new, eos=-1)
            for i in range(n)]


def test_serve_thread_launch_counts_on_card(cuda):
    """The serve loop's thread launches as ``run()`` does: K1 once an
    attention layer a decode step, K2 once a GEMM a step (seven
    projections a layer and the head), the same fp32 tokens."""
    cfg = dataclasses.replace(TC.get("qwen2_0_5b").scaled_down(),
                              gemm_backend="scheduled")
    params = TN.init(cfg, seed=0, device=cuda)
    reqs = _serving_requests(cfg.vocab)
    out = {}
    for mode in ("run", "thread"):
        eng = ContinuousEngine(cfg, params, slots=2, max_len=128,
                               audit=True, device=cuda)
        torch.cuda.synchronize()
        TPA.launches.reset()
        TMP.reset_launches()
        if mode == "run":
            res = eng.run(reqs)
        else:
            eng.start()
            for r in reqs:
                eng.submit(r)
            res = [eng.get_result(timeout=120) for _ in reqs]
            eng.stop()
        torch.cuda.synchronize()
        assert all(r.status == "ok" for r in res)
        out[mode] = ({r.rid: r.tokens.tolist() for r in res},
                     TPA.launches.count / eng.steps,
                     TMP.launches.count / (eng.steps + eng.chunk_steps))
    assert out["run"] == out["thread"]
    assert out["run"][1:] == (cfg.n_layers, 7 * cfg.n_layers + 1)


def test_retried_decode_step_on_card(cuda, monkeypatch):
    """A transient fault before a step and a genuine failure after a
    decode step's launches both retry to the fault-free tokens; a kernel
    launch the CUDA driver refuses (``KernelError``) leaves ``step()``."""
    from repro_torch.kernels import _build
    from repro_torch.serving.resilience import (FaultPlane, FaultSpec,
                                                ResilienceConfig)
    cfg = dataclasses.replace(TC.get("qwen2_0_5b").scaled_down(),
                              gemm_backend="scheduled")
    params = TN.init(cfg, seed=0, device=cuda)
    reqs = _serving_requests(cfg.vocab)

    def engine(**kw):
        return ContinuousEngine(cfg, params, slots=2, max_len=128,
                                audit=True, device=cuda, **kw)

    want = {r.rid: r.tokens.tolist() for r in engine().run(reqs)}
    real, calls = TN.decode_step, {"n": 0}

    def flaky(*a, **k):
        out = real(*a, **k)
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("mid-step failure")
        return out

    monkeypatch.setattr(TN, "decode_step", flaky)
    eng = engine(faults=FaultPlane([FaultSpec("dispatch", at=6)]),
                 resilience=ResilienceConfig(dispatch_retries=2))
    res = eng.run(reqs)
    assert {r.rid: r.tokens.tolist() for r in res} == want
    assert {r.status for r in res} == {"ok"}
    assert eng.metrics.value("resilience.retries") == 2
    monkeypatch.undo()

    def refuse(rc, what):
        raise _build.KernelError(f"{what}: refused")

    eng = engine()
    eng.submit(reqs[0])
    monkeypatch.setattr(_build, "check_launch", refuse)
    with pytest.raises(_build.KernelError):
        for _ in range(8):
            eng.step()
    assert eng.drain_results() == []
    assert eng.metrics.value("resilience.quarantined") == 0


def test_profiler_on_card_spans_and_bit_identical_attach(cuda):
    """The dispatch profiler on a small CUDA engine: attached mid-flight
    it leaves the caches, tables, cursors, pool, sampler and schedule
    statistics bit-identical, gives calibration spans of all four
    dispatches and serve spans of the steps that follow, and the run's
    fp32 tokens stay those of an unprofiled run."""
    from repro_torch.models.layers import tree_map
    from repro_torch.obs import DISPATCH_NAMES, DispatchProfiler, Telemetry
    cfg = dataclasses.replace(TC.get("qwen2_0_5b").scaled_down(),
                              gemm_backend="scheduled")
    params = TN.init(cfg, seed=0, device=cuda)
    reqs = _serving_requests(cfg.vocab)
    want = {r.rid: r.tokens.tolist() for r in ContinuousEngine(
        cfg, params, slots=2, max_len=128, device=cuda).run(reqs)}
    eng = ContinuousEngine(cfg, params, slots=2, max_len=128, device=cuda,
                           telemetry=Telemetry.on())
    for r in _serving_requests(cfg.vocab):
        eng.submit(r)
    for _ in range(3):
        eng.step()

    def state():
        leaves = []
        tree_map(lambda _p, a: leaves.append(a.clone()), eng.caches)
        st = eng.schedule.stats()
        return (leaves, eng._bt.clone(), eng._pos.copy(),
                eng.pool.snapshot_state(), eng.generator.get_state(),
                (st["hits"], st["misses"], eng.schedule.key_stats()))

    torch.cuda.synchronize()
    before = state()
    prof = DispatchProfiler(reps=2)
    eng.obs.profiler = prof
    prof.attach(eng)
    torch.cuda.synchronize()
    after = state()
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    assert torch.equal(before[1], after[1])
    assert np.array_equal(before[2], after[2])
    assert before[3] == after[3]
    assert torch.equal(before[4], after[4]) and before[5] == after[5]
    got = {}
    while len(got) < len(reqs):
        eng.step()
        got.update({r.rid: r.tokens.tolist() for r in eng.drain_results()})
    assert got == want
    cal = {s["name"] for s in prof.spans if s["kind"] == "calibration"}
    assert cal == set(DISPATCH_NAMES)
    assert any(s["kind"] == "serve" for s in prof.spans)
    assert all(s["dur_s"] > 0 for s in prof.spans)


def test_step_cost_full_width_allocates_and_launches_nothing(cuda):
    """``step_cost`` at full qwen2 width runs on fake CPU tensors: no
    device memory, no kernel launch, no schedule statistic moves."""
    from repro_torch.launch.step_cost import hot_dispatches, step_cost
    cfg = dataclasses.replace(TC.get("qwen2_0_5b"),
                              gemm_backend="scheduled")
    sched = TOPS.backend_for(cfg).schedule

    def counters():
        return (TPA.launches.count, TPA.launches_int8.count,
                TMP.launches.count, TMP.spill_launches.count,
                TQM.launches.count, TSSD.launches.count,
                TLG.launches.count, sched.stats())

    torch.cuda.synchronize()
    mem, before = torch.cuda.memory_allocated(), counters()
    costs = {name: step_cost(fn, *args) for name, fn, args in
             hot_dispatches(cfg, slots=8, max_len=1024)}
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == mem
    assert counters() == before
    assert costs["head_apply"]["flops"] == 2 * 8 * cfg.vocab * cfg.d_model
    assert costs["prefill_paged_chunk"]["flops"] > costs["decode_step"][
        "flops"] > 0


def _ssm_quant_shapes(arch: str) -> list[tuple[int, int, int, str]]:
    """(M, N, K, route) of every int8 GEMM an SSM config runs: in_proj and
    out_proj at decode (8) and chunk (8 x 256) rows, zamba2's shared
    attention q/k/v/o likewise, and the untied head's (D, V) payload at 8
    rows.  bf16 x takes the Hopper route where TMA takes the weight's rows
    (N a multiple of 16): mamba2's head (V = 50280) runs on the CUDA
    cores."""
    cfg = TC.get(arch)
    defs = TS.mamba2_defs(cfg)
    nk = [defs[k].shape[::-1] for k in ("in_proj", "out_proj")]
    if BlockKind.SHARED_ATTN in cfg.pattern:
        nk.append((cfg.n_heads * cfg.hd, cfg.d_model))
    shapes = [(M, N, K) for N, K in nk for M in (8, 2048)]
    shapes.append((8, cfg.vocab, cfg.d_model))
    return [(M, N, K, "hopper" if N % 16 == 0 else "cuda_core")
            for M, N, K in shapes]


#: K3's int8 projections beside the SSM ones: llama4's q/o, k/v, shared
#: expert and head payload (D, V) at decode rows
QUANT_SHAPES = {
    "mamba2_2_7b": _ssm_quant_shapes("mamba2_2_7b"),
    "zamba2_7b": _ssm_quant_shapes("zamba2_7b"),
    "llama4_scout_17b_a16e": [(8, 5120, 5120, "hopper"),
                              (8, 1024, 5120, "hopper"),
                              (8, 8192, 5120, "hopper"),
                              (8, 5120, 8192, "hopper"),
                              (8, 202048, 5120, "hopper")],
    # deepseek-v2 at the shapes of FAMILY_SHAPES (wq_a and wkv_a stay
    # float on the path) and the head's (D, V) payload
    "deepseek_v2_236b": [(8, 1536, 5120, "hopper"),
                         (8, 24576, 1536, "hopper"),
                         (8, 576, 5120, "hopper"),
                         (8, 5120, 16384, "hopper"),
                         (2048, 16384, 512, "hopper"),
                         (8, 3072, 5120, "hopper"),
                         (8, 12288, 5120, "hopper"),
                         (8, 102400, 5120, "hopper")],
}


def test_quant_shapes_name_the_path():
    """The SSM cases hold mamba2's CUDA-core head and zamba2's shared
    attention and head, each on the route the path gives it."""
    assert (8, 50280, 2560, "cuda_core") in QUANT_SHAPES["mamba2_2_7b"]
    z = QUANT_SHAPES["zamba2_7b"]
    assert {(8, 3584, 3584, "hopper"), (2048, 3584, 3584, "hopper"),
            (8, 32000, 3584, "hopper")} <= set(z)


@pytest.mark.parametrize("arch", list(QUANT_SHAPES))
def test_quant_matmul_path_shapes(cuda, arch):
    """K3 at the int8 path's shapes of mamba2, zamba2 and llama4 (bf16 x)
    against its plain version on the route each shape takes,
    |err| / (1 + |ref|) <= 1e-4, a repeat bit-equal."""
    gen = torch.Generator().manual_seed(11)
    TQM.reset_launches()
    want_routes = {r: 0 for r in TQM.ROUTES}
    for M, N, K, route in QUANT_SHAPES[arch]:
        x = (torch.randn(M, K, generator=gen) * K ** -0.5).to(
            cuda, torch.bfloat16)
        w = torch.randint(-127, 128, (K, N), generator=gen,
                          dtype=torch.int8).to(cuda)
        sc = (torch.rand(N, generator=gen) * 0.02).to(cuda)
        assert TQM.quant_matmul_route(x, w) == route, (M, N, K)
        got = TQM.quant_matmul(x, w, sc)
        again = TQM.quant_matmul(x, w, sc)
        want = TQM.quant_matmul_ref(x, w, sc)
        torch.cuda.synchronize()
        rel = ((got - want).abs() / (1 + want.abs())).max().item()
        assert rel <= 1e-4, (M, N, K, rel)
        assert torch.equal(got, again), (M, N, K)
        want_routes[route] += 2
    assert TQM.launches_by_route == want_routes


@pytest.mark.parametrize("backend", ["xla", "scheduled"])
def test_moe_apply_on_card_matches_cpu(cuda, backend):
    """Scaled-down llama4's MoE layer (fp32) on the card against the same
    call on the CPU, at capacity factor 1 on a batch that drops slots:
    the dispatch (stable sort, ``scatter_``, ``index_add_``) drops the
    same slots, the output agrees within 1e-4, and no call syncs."""
    from repro_torch.kernels.ops import GemmBackend
    from repro_torch.models import moe as TMOE
    cfg = TC.get("llama4_scout_17b_a16e").scaled_down()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))
    params = TN.init(cfg, 0, "cpu")
    p = {k: (v[0] if isinstance(v, torch.Tensor) else
             {kk: vv[0] for kk, vv in v.items()})
         for k, v in params["blocks"][0]["moe"].items()}
    x = torch.randn(4, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    with TMOE.record_drops() as drops_cpu:
        want, want_aux = TMOE.moe_apply(p, x, cfg)
    pc = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else
              {kk: vv.to(cuda) for kk, vv in v.items()})
          for k, v in p.items()}
    be = GemmBackend() if backend == "scheduled" else None
    xc = x.to(cuda)
    TMOE.moe_apply(pc, xc, cfg, backend=be)             # build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with TMOE.record_drops() as drops:
            got, aux = TMOE.moe_apply(pc, xc, cfg, backend=be)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(drops[0][2]) == int(drops_cpu[0][2]) > 0
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def test_moe_apply_top6_on_card_matches_cpu(cuda):
    """deepseek-v2's top-6 routing (16 experts, fp32) on the card against
    the same call on the CPU within 1e-4, and bit-equal on a repeat: each
    token sums its six outputs in a fixed order (``index_add_``'s
    atomics did not fix it)."""
    from repro_torch.models import moe as TMOE
    cfg = TC.get("deepseek_v2_236b").scaled_down()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=16, top_k=6))
    gen = torch.Generator().manual_seed(4)
    D, F = cfg.d_model, cfg.moe.d_ff_expert
    p = {"router": torch.randn(D, 16, generator=gen) * 0.1,
         "wi_gate": torch.randn(16, D, F, generator=gen) * 0.05,
         "wi_up": torch.randn(16, D, F, generator=gen) * 0.05,
         "wo": torch.randn(16, F, D, generator=gen) * 0.05}
    x = torch.randn(4, 16, D, generator=gen)
    want, _aux = TMOE.moe_apply(p, x, cfg)
    pc = {k: v.to(cuda) for k, v in p.items()}
    got, _aux = TMOE.moe_apply(pc, x.to(cuda), cfg)
    again, _aux = TMOE.moe_apply(pc, x.to(cuda), cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.parametrize("backend", ["xla", "scheduled"])
def test_mla_attention_on_card_matches_cpu(cuda, backend):
    """Scaled-down deepseek-v2's MLA layer (fp32) on the card against the
    CPU: a paged chunk (decompressed k / v over the gathered table,
    through K2 under scheduled) and an absorbed decode step, within 1e-4,
    with K1 never launched."""
    from repro_torch.kernels.ops import GemmBackend
    from repro_torch.models import attention as TA
    cfg = TC.get("deepseek_v2_236b").scaled_down()
    params = TN.init(cfg, 0, "cpu")
    p = {k: v[0] for k, v in params["blocks"][0]["attn"].items()}
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 12, cfg.d_model, generator=gen)
    xd = torch.randn(2, 1, cfg.d_model, generator=gen)
    table = torch.tensor([[3, 1, 5], [2, 4, 0]], dtype=torch.int32)
    lens = torch.tensor([12, 9], dtype=torch.int32)

    def run(dev, be):
        pool = dict(TA.make_paged_kv_cache(cfg, 6, 8, torch.float32,
                                           torch.device(dev)),
                    pos=torch.zeros(2, dtype=torch.int32, device=dev))
        pp = {k: v.to(dev) for k, v in p.items()}
        bt = table.to(dev)
        y1, pool = TA.mla_attention(pp, x.to(dev), cfg,
                                    pos_offset=pool["pos"], cache=pool,
                                    block_table=bt,
                                    pos_advance=lens.to(dev), backend=be)
        y2, pool = TA.mla_attention(pp, xd.to(dev), cfg,
                                    pos_offset=lens.to(dev), cache=pool,
                                    block_table=bt,
                                    pos_advance=torch.ones(
                                        2, dtype=torch.int32, device=dev),
                                    backend=be)
        return y1.cpu(), y2.cpu()
    want = run("cpu", None)
    TPA.launches.reset()
    got = run("cuda", GemmBackend() if backend == "scheduled" else None)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert TPA.launches.count == 0


# -- K5-bwd (the SSD intra-chunk backward) and training on the card ---------

@pytest.mark.parametrize("shape,kw", [
    ((4, 4, 256, 80, 1, 64, 128), {}),
    ((4, 4, 256, 112, 1, 64, 64), {}),
    ((8, 4, 256, 26, 2, 64, 128), {}),
    ((8, 1, 32, 80, 1, 64, 128), {}),
    ((2, 1, 100, 8, 2, 24, 40), {}),
    ((2, 2, 256, 16, 1, 64, 128), {"strided": True}),
    ((2, 1, 100, 8, 2, 18, 10), {"unaligned": True}),
    ((2, 1, 256, 16, 1, 64, 128), {"fall": 300.0}),
], ids=["mamba2-train", "zamba2-train", "G2-ragged-head-block", "Q32",
        "ragged-Q", "strided-views", "unaligned", "cums-fall-300"])
def test_ssd_intra_bwd_matches_plain(cuda, shape, kw):
    """K5-bwd against ``ssd_intra_chunked_bwd_ref``: each output within
    2e-4 of its max |.|, finite, and two launches bit-equal."""
    B, nc, Q, H, G, P, N = shape
    unaligned = kw.pop("unaligned", False)
    args = _grouped_ssd_inputs(cuda, *shape, seed=sum(shape) + 1, **kw)
    gen = torch.Generator().manual_seed(sum(shape))
    dy = torch.randn(B, nc, Q, H, P, generator=gen).to(cuda)
    if kw.get("strided"):
        dy = dy.transpose(3, 4).contiguous().transpose(3, 4)
    if unaligned:
        def shift(t):
            buf = torch.empty(t.numel() + 1, device=cuda)
            return buf[1:].view(t.shape).copy_(t)
        args[0], dy = shift(args[0]), shift(dy)
    plan = TSSD.ssd_bwd_plan(B, nc, Q, H, G, P)
    if shape[:5] == (8, 4, 256, 26, 2):
        assert (H // G) % plan.head_block != 0
    before = TSSD.bwd_launches.count
    got = TSSD.ssd_intra_chunked_bwd(*args, dy)
    again = TSSD.ssd_intra_chunked_bwd(*args, dy)
    want = TSSD.ssd_intra_chunked_bwd_ref(*args, dy)
    torch.cuda.synchronize()
    assert TSSD.bwd_launches.count == before + 2
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert (g - w).abs().max() <= 2e-4 * w.abs().max()
        assert torch.equal(g, a)


def test_ssd_intra_bwd_reads_no_device_value(cuda):
    """K5-bwd's wrapper sizes its launch from shapes alone: no host sync."""
    args = _grouped_ssd_inputs(cuda, 4, 4, 256, 80, 1, 64, 128, seed=8)
    dy = torch.randn(4, 4, 256, 80, 64, device=cuda)
    TSSD.ssd_intra_chunked_bwd(*args, dy)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TSSD.ssd_intra_chunked_bwd(*args, dy)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_mamba2_loss_backward_on_card_matches_cpu(cuda):
    """Scaled-down mamba2 (fp32) ``loss_fn`` and ``loss.backward()`` on the
    card (K5 forward, K5-bwd backward, once a layer) against the CPU:
    the loss within 1e-5 relative, each gradient leaf within 1e-4 of its
    max |g|."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.layers import tree_map
    from repro_torch.optim.adamw import leaves
    cfg = TC.get("mamba2_2_7b").scaled_down()
    params = TN.init(cfg, 0, "cpu")
    batch = make_batch(cfg, DataConfig(vocab=cfg.vocab, seq_len=64,
                                       global_batch=2, seed=1), 0)

    def run(dev):
        p = tree_map(lambda _p, a: a.detach().to(dev).requires_grad_(),
                     params)
        ps = leaves(p)
        loss, _ = TN.loss_fn(p, cfg, {k: torch.from_numpy(v).to(dev)
                                      for k, v in batch.items()})
        loss.backward()
        return loss.item(), [t.grad.cpu() for t in ps]
    want_loss, want = run("cpu")
    TSSD.launches.reset()
    TSSD.bwd_launches.reset()
    got_loss, got = run(cuda)
    torch.cuda.synchronize()
    assert TSSD.launches.count == cfg.n_layers
    assert TSSD.bwd_launches.count == cfg.n_layers
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max().clamp_min(1e-30)
