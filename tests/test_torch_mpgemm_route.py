"""The two routes of K2 / K6 and the Hopper route's geometry, on the CPU.

``mpgemm_route`` is a pure function of the operands' type, strides and
addresses (and of bk), so the rule is checked here on CPU tensors:
aligned bf16 takes the Hopper route in both weight layouts; fp32, odd
strides, unaligned bases and a K block that is not whole ring stages
take the CUDA-core route.  The Hopper tiles must fit the 227 KB a block
may use; the OS fold bands -- and the runs of whole K blocks when the
output has few tiles -- are split over the cluster ranks as the kernel
walks them; ``dispatch_plan``'s reference keys stay the reference's on
the Hopper route too.  No kernel runs here: these are seconds.
"""

import itertools

import pytest
import torch

from repro.core.dataflow import Dataflow as JDataflow
from repro.kernels import mpgemm as JMP
from repro_torch.core import tiling
from repro_torch.core.dataflow import Dataflow
from repro_torch.kernels import mpgemm as TMP
from repro_torch.kernels import ops as TOPS

PLAN_KEYS = ("dataflow", "epilogue", "k_fold_requested", "k_fold_effective",
             "intermediate_hbm_bytes", "acc_bytes_per_instance")


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def _offset_view(rows, cols, dtype=torch.bfloat16):
    """A (rows, cols) row-major view whose base is one element past an
    allocation's start: 2 (bf16) bytes off 16-byte alignment."""
    return torch.zeros(rows * cols + 1, dtype=dtype)[1:].view(rows, cols)


def test_route_takes_aligned_bf16_in_both_weight_layouts():
    a = _bf16(8, 896)
    assert TMP.mpgemm_route(a, _bf16(896, 4864), 128) == "hopper"   # (K, N)
    assert TMP.mpgemm_route(a, _bf16(151936, 896).t(), 128) == "hopper"
    # ragged shapes are fine while the strides stay 16-byte multiples
    assert TMP.mpgemm_route(_bf16(37, 904), _bf16(904, 1000), 64) == "hopper"


@pytest.mark.parametrize("case", ["fp32", "odd_stride_a", "odd_stride_b",
                                  "unaligned_a", "unaligned_b", "a_m_major",
                                  "bk32", "mixed"])
def test_route_sends_the_rest_to_cuda_cores(case):
    a, b, bk = _bf16(100, 896), _bf16(896, 160), 128
    if case == "fp32":
        a, b = a.float(), b.float()
    elif case == "odd_stride_a":
        a = _bf16(100, 763)                       # 1526-byte rows
        b = _bf16(763, 160)
    elif case == "odd_stride_b":
        b = _bf16(896, 150)                       # 300-byte rows
    elif case == "unaligned_a":
        a = _offset_view(100, 896)
    elif case == "unaligned_b":
        b = _offset_view(896, 160)
    elif case == "a_m_major":
        a = _bf16(896, 100).t()                   # M contiguous
    elif case == "bk32":
        bk = 32                                   # half a ring stage
    elif case == "mixed":
        b = b.float()
    assert TMP.mpgemm_route(a, b, bk) == "cuda_core"


def test_hopper_tiles_fit_the_card():
    """Every Hopper tile's ring, barriers and DSMEM reduction tile fit the
    227 KB of shared memory a block may use; the ring is bf16 bytes x
    stages; the CUDA-core set is inside the Hopper set (so either route
    takes a tile ``_check`` accepts)."""
    for bm, bn in tiling.HOPPER_TILES:
        swap = bm <= 64
        tp, tq = (bn, bm) if swap else (bm, bn)
        stages = tiling.hopper_stages(bm, bn)
        assert 4 <= stages <= 8
        ring = stages * (tp + tq) * tiling.HOPPER_STAGE_K * 2
        assert tiling.hopper_smem_bytes(bm, bn, reduce=False) == \
            1024 + ring + 256
        assert tiling.hopper_smem_bytes(bm, bn) <= tiling.SMEM_BYTES
    assert set(tiling.KERNEL_TILES) <= set(tiling.HOPPER_TILES)
    assert tiling.HOPPER_BK % tiling.HOPPER_STAGE_K == 0
    assert tiling.FOLD_GRAIN % tiling.HOPPER_BK == 0


@pytest.mark.parametrize("M,N,want", [
    (1, 896, (8, 64)), (8, 151936, (8, 64)), (9, 896, (16, 64)),
    (37, 1000, (64, 64)), (64, 896, (64, 64)),
    (256, 896, (64, 64)), (256, 4864, (64, 64)),      # 14 / 76 wide tiles
    (256, 151936, (128, 256)), (2048, 10576, (128, 256)),
    (2048, 2560, (128, 256)), (1024, 2560, (128, 128)),  # 80 / 160 tiles
    (512, 2560, (64, 64))])
def test_plan_blocks_gives_hopper_tiles_for_bf16(M, N, want):
    assert tiling.hopper_tile(M, N) == want
    for df in (Dataflow.OS, Dataflow.WS, Dataflow.IS):
        assert TOPS.plan_blocks(M, N, 4864, 2, df, 1) == \
            (*want, tiling.HOPPER_BK)
    # fp32 keeps the CUDA-core chooser
    assert TOPS.plan_blocks(M, N, 4864, 4, Dataflow.OS, 1)[:2] in \
        tiling.KERNEL_TILES


def test_core_tile_covers_hopper_only_tiles():
    assert tiling.core_tile(8, 64) == (16, 64)
    assert tiling.core_tile(32, 64) == (64, 64)
    assert tiling.core_tile(128, 256) == (128, 128)
    for t in tiling.KERNEL_TILES:
        assert tiling.core_tile(*t) == t


@pytest.mark.parametrize("M,N,K,f,ranks", [
    (8, 896, 3072, 2, 2), (8, 896, 3072, 8, 8),       # f <= c: a band a rank
    (8, 2560, 3072, 4, 3), (8, 2560, 3072, 8, 3),      # f > c: 40 tiles
    (2048, 2560, 5120, 4, 1)])                         # >= 132 tiles
def test_fold_bands_split_over_cluster_ranks(M, N, K, f, ranks):
    """OS with f bands: the f bands are the K units, split over c =
    min(8, f, 132 // tiles) cluster ranks (the kernel walks band fi on
    rank fi mod c, in order), and f divides the K blocks, so every band
    is a run of gk / f whole blocks."""
    bm, bn = tiling.hopper_tile(M, N)
    g = tiling.hopper_launch(M, N, K, Dataflow.OS, bm, bn, 128, f, False)
    assert (g.units, g.zsplit) == (f, ranks)
    assert g.cluster == (1, 1, ranks) and g.mc == 0
    assert ranks == min(tiling.MAX_CLUSTER, f, max(
        1, tiling.NUM_SMS // (g.tiles_p * g.tiles_q)))
    assert (-(-K // 128)) % f == 0


@pytest.mark.parametrize("M,N,K,ranks", [(8, 896, 896, 7), (8, 128, 896, 7),
                                         (8, 896, 4864, 8),
                                         (256, 896, 4864, 2),
                                         (8, 2560, 5120, 3),
                                         (2048, 2560, 5120, 1)])
def test_k_split_runs_of_whole_blocks(M, N, K, ranks):
    """OS at f = 1 with fewer output tiles than SMs: the K blocks cut
    into ``ranks`` consecutive runs of whole blocks (sizes differ by at
    most one), one a rank; at 132 tiles or more, no split."""
    bm, bn = tiling.hopper_tile(M, N)
    g = tiling.hopper_launch(M, N, K, Dataflow.OS, bm, bn, 128, 1, False)
    assert (g.units, g.zsplit) == (ranks, ranks)
    assert g.tiles_p * g.tiles_q * ranks <= max(tiling.NUM_SMS,
                                                g.tiles_p * g.tiles_q)
    gk = -(-K // 128)
    starts = [u * gk // ranks for u in range(ranks + 1)]   # unit_block
    sizes = [b - a for a, b in zip(starts, starts[1:])]
    assert sum(sizes) == gk and max(sizes) - min(sizes) <= 1 and \
        min(sizes) >= 1


def test_stationary_operand_shared_by_a_cluster():
    """WS shares B and IS shares A over a cluster of 2 CTAs along the
    other dimension (padded to whole clusters), or of 1 when that
    dimension has one tile; spilled, one unit a K block, no K split."""
    g = tiling.hopper_launch(8, 896, 4864, Dataflow.WS, 8, 64, 128, 1, False)
    assert (g.csize, g.mc, g.cluster) == (1, 0, (1, 1, 1))    # one M tile
    g = tiling.hopper_launch(256, 4864, 896, Dataflow.IS, 128, 128, 128, 1,
                             False)                # A (P) shared along N (q)
    assert (g.mc, g.cluster, g.grid) == (2, (1, 2, 1), (2, 38, 1))
    g = tiling.hopper_launch(2048, 10576, 2560, Dataflow.IS, 128, 128, 128,
                             1, False)             # 83 N tiles, padded to 84
    assert (g.tiles_q, g.grid_q, g.cluster) == (83, 84, (1, 2, 1))
    g = tiling.hopper_launch(8, 151936, 896, Dataflow.IS, 8, 64, 128, 1,
                             False)                # swapped: A is Q, along p
    assert (g.mc, g.cluster) == (1, (2, 1, 1))
    g = tiling.hopper_launch(256, 896, 4864, Dataflow.WS, 128, 128, 128, 1,
                             True)
    assert (g.units, g.zsplit, g.cluster) == (38, 1, (2, 1, 1))
    g = tiling.hopper_launch(256, 896, 4864, Dataflow.OS, 128, 128, 128, 2,
                             True)                 # a band a CTA, no cluster
    assert (g.units, g.zsplit, g.cluster) == (2, 2, (1, 1, 1))
    with pytest.raises(ValueError, match="Hopper tile"):
        tiling.hopper_launch(8, 64, 64, Dataflow.OS, 8, 128, 128, 1, False)
    # 128 x 256 has no room for the DSMEM tile: one rank walks the bands
    assert tiling.hopper_reduce_bytes(128, 256) == 0
    g = tiling.hopper_launch(256, 512, 4096, Dataflow.OS, 128, 256, 64, 4,
                             False)
    assert (g.units, g.zsplit, g.cluster) == (4, 1, (1, 1, 1))


@pytest.mark.parametrize("df", ["OS", "WS", "IS"])
@pytest.mark.parametrize("ep", ["fused", "spill"])
def test_dispatch_plan_on_the_hopper_route(df, ep):
    """The reference's keys equal the reference's at Hopper tiles with
    bf16 operands; the port's keys describe the Hopper launch: its grid
    and cluster, the output written once when fused."""
    for (M, N, K), f in itertools.product(
            ((8, 896, 4864), (256, 4864, 896), (2048, 2560, 5120)), (1, 2)):
        bm, bn, bk = TOPS.plan_blocks(M, N, K, 2, Dataflow(df), f)
        kw = dict(bm=bm, bn=bn, bk=bk, k_fold=f, epilogue=ep, abytes=2,
                  bbytes=2)
        ours = TMP.dispatch_plan(M, N, K, dataflow=Dataflow(df), **kw)
        ref = JMP.dispatch_plan(M, N, K, dataflow=JDataflow(df), **kw)
        assert {k: ours[k] for k in PLAN_KEYS} == \
            {k: ref[k] for k in PLAN_KEYS}
        g = tiling.hopper_launch(M, N, K, Dataflow(df), bm, bn, bk,
                                 ours["k_fold_effective"],
                                 ours["intermediate_hbm_bytes"] > 0)
        assert ours["route"] == "hopper"
        assert ours["grid"] == g.grid and ours["cluster"] == g.cluster
        if ep == "fused":
            assert ours["out_traffic_bytes"] == M * N * 4
        operands = 2 * (M * K + K * N)
        assert ours["hbm_traffic_bytes"] >= operands + \
            ours["out_traffic_bytes"]
    # fp32 operands: the CUDA-core launch, as before
    plan = TMP.dispatch_plan(8, 896, 4864, dataflow=Dataflow(df), bm=16,
                             bn=64, bk=32)
    assert plan["route"] == "cuda_core" and "cluster" not in plan


def test_check_accepts_both_tile_sets():
    """Any tile of either set runs the plain version on CPU tensors; a
    tile of neither raises."""
    a, b = torch.randn(10, 128), torch.randn(128, 20)
    want = TMP.mpgemm_plain(a, b, bk=64, k_fold=1, out_dtype=torch.float32)
    for bm, bn in set(tiling.HOPPER_TILES) | set(tiling.KERNEL_TILES):
        got = TMP.mpgemm(a, b, bm=bm, bn=bn, bk=64)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unsupported tile"):
        TMP.mpgemm(a, b, bm=8, bn=128, bk=64)


def test_route_counts_reset():
    TMP.launches_by_route["hopper"] = 3
    TMP.spill_launches_by_route["cuda_core"] = 2
    TMP.reset_launches()
    assert TMP.launches_by_route == {"hopper": 0, "cuda_core": 0}
    assert TMP.spill_launches_by_route == {"hopper": 0, "cuda_core": 0}
