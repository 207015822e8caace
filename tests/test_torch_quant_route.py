"""The two routes of K3 (the int8-weight GEMM), its launch plan and the
build digest, on the CPU.

``quant_matmul_route`` is a pure function of the operands' type, strides
and addresses, so the rule is checked here on CPU tensors: bf16 x and an
int8 weight that TMA can describe take the Hopper route; fp32 x, rows
that are not 16-byte multiples, unaligned bases and transposed operands
take the CUDA-core route.  ``quant_plan`` fixes the tile and the cluster
split from the shapes alone: checked at the int8 serving path's shapes
for the CTA count, the cluster ranks (<= 8, each rank a non-empty run of
K stages) and the tile family by M, and every Hopper plan must fit the
227 KB a block may use.  The library name must follow every header a
source includes.  No kernel runs here: these are milliseconds.
"""

import shutil

import pytest
import torch

from repro_torch.core.tiling import (HOPPER_STAGE_K, MAX_CLUSTER, NUM_SMS,
                                     SMEM_BYTES)
from repro_torch.kernels import _build
from repro_torch.kernels import quant_matmul as TQM

#: (N, K) of qwen2-0.5b's int8 projections: q/o, k/v, gate/up, down
PATH_NK = ((896, 896), (128, 896), (4864, 896), (896, 4864))
ROWS = (1, 8, 16, 64, 65, 256, 2048)


def _x(M, K, dtype=torch.bfloat16):
    return torch.zeros(M, K, dtype=dtype)


def _w(K, N):
    return torch.zeros(K, N, dtype=torch.int8)


def _offset(rows, cols, dtype):
    """A contiguous (rows, cols) view whose base is one element past an
    allocation's start: off 16-byte alignment."""
    return torch.zeros(rows * cols + 1, dtype=dtype)[1:].view(rows, cols)


def test_route_takes_bf16_that_tma_describes():
    for N, K in PATH_NK:
        assert TQM.quant_matmul_route(_x(8, K), _w(K, N)) == "hopper"
    # ragged shapes are fine while the rows stay 16-byte multiples
    assert TQM.quant_matmul_route(_x(37, 904), _w(904, 1008)) == "hopper"
    assert TQM.quant_matmul_route(_x(1, 8), _w(8, 16)) == "hopper"
    # a row stride wider than the row (a slice of a wider buffer)
    x = torch.zeros(8, 1024, dtype=torch.bfloat16)[:, :896]
    assert TQM.quant_matmul_route(x, _w(896, 896)) == "hopper"


@pytest.mark.parametrize("case", ["fp32_x", "n_not_16", "k_not_8",
                                  "unaligned_x", "unaligned_w",
                                  "x_transposed", "w_transposed",
                                  "w_not_int8"])
def test_route_sends_the_rest_to_cuda_cores(case):
    x, w = _x(8, 896), _w(896, 896)
    if case == "fp32_x":
        x = x.float()
    elif case == "n_not_16":
        w = _w(896, 1000)                         # 1000-byte rows
    elif case == "k_not_8":
        x, w = _x(8, 900), _w(900, 896)           # 1800-byte rows of x
    elif case == "unaligned_x":
        x = _offset(8, 896, torch.bfloat16)
    elif case == "unaligned_w":
        w = _offset(896, 896, torch.int8)
    elif case == "x_transposed":
        x = _x(896, 8).t()                        # M contiguous
    elif case == "w_transposed":
        w = _w(896, 896).t()                      # K contiguous
    elif case == "w_not_int8":
        w = w.to(torch.bfloat16)
    assert TQM.quant_matmul_route(x, w) == "cuda_core"


def _runs(stages, ranks):
    """The kernels' K runs: rank z takes stages [z s / r, (z + 1) s / r)."""
    return [(z * stages // ranks, (z + 1) * stages // ranks)
            for z in range(ranks)]


@pytest.mark.parametrize("M", ROWS)
def test_hopper_plan_at_the_path_shapes(M):
    for N, K in PATH_NK:
        p = TQM.quant_plan(M, N, K)
        bm, bn = p.tile
        assert p.route == "hopper" and p.tile in TQM.QUANT_TILES
        if M <= TQM.DECODE_M:         # the smallest decode tile covering M
            assert bn == 64 and bm == min(t[0] for t in TQM.QUANT_TILES
                                          if t[0] >= M)
        else:
            assert p.tile in ((64, 64), (128, 128), (256, 128))
            assert p.tile == (64, 64) or 2 * p.tiles >= NUM_SMS
        assert p.grid[:2] == (-(-N // bn), -(-M // bm))
        assert 1 <= p.ranks <= MAX_CLUSTER
        if p.ranks > 1:               # split only where SMs would idle
            assert p.tiles < NUM_SMS and p.tile != (256, 128)
            assert p.ctas <= 2 * NUM_SMS
            stages = -(-K // HOPPER_STAGE_K)
            assert all(b > a for a, b in _runs(stages, p.ranks))
        assert TQM.hopper_smem_bytes(bm, bn, p.ranks) <= SMEM_BYTES


def test_hopper_plan_fills_the_card_at_decode():
    """M = 8: the down and q/o projections (14 tiles) take 8 ranks, gate/up
    (76 tiles) 3 -- about two CTAs an SM, which shared memory holds."""
    got = {(N, K): (TQM.quant_plan(8, N, K).ranks,
                    TQM.quant_plan(8, N, K).ctas) for N, K in PATH_NK}
    assert got == {(896, 896): (8, 112), (128, 896): (8, 16),
                   (4864, 896): (3, 228), (896, 4864): (8, 112)}
    assert TQM.resident_ctas(8, 64, ranks=2) >= 2
    # chunk rows: two 64 x 64 CTAs an SM hold the reduction tile
    assert TQM.quant_plan(256, 896, 4864).ctas == 224
    assert TQM.quant_plan(256, 4864, 896).ranks == 1
    assert TQM.quant_plan(2048, 4864, 896).tile == (256, 128)
    # a wide tile wherever it gives half the SMs a tile
    assert TQM.quant_plan(256, 4864, 896).tile == (128, 128)
    assert TQM.quant_plan(2048, 896, 896).tile == (128, 128)
    assert TQM.quant_plan(2048, 896, 4864).tile == (128, 128)
    assert TQM.quant_plan(1024, 896, 4864).tile == (64, 64)
    assert TQM.quant_plan(2048, 128, 896).tile == (64, 64)


@pytest.mark.parametrize("M", ROWS)
def test_core_plan_at_the_path_shapes(M):
    for N, K in PATH_NK:
        p = TQM.quant_plan(M, N, K, "cuda_core")
        assert p.route == "cuda_core" and p.tile in TQM.CORE_TILES
        assert p.tile[1] >= 16               # whole 16-byte weight rows
        assert (p.tile == (8, 16)) == (M <= TQM.NARROW_M)
        assert p.ranks == 1 and p.ctas == p.tiles   # each CTA: all of K
        assert p.grid[:2] == (-(-N // p.tile[1]), -(-M // p.tile[0]))


@pytest.mark.parametrize("tile", [(64, 64), (128, 128), (256, 128)])
def test_plan_takes_a_chunk_tile_that_is_asked_for(tile):
    """The tile timings run every chunk tile: the grid follows the tile,
    and the K split follows the same rule as for the rule's own tile."""
    for N, K in PATH_NK:
        p = TQM.quant_plan(2048, N, K, "hopper", tile)
        assert p.tile == tile
        assert p.grid[:2] == (-(-N // tile[1]), -(-2048 // tile[0]))
        assert p.ranks == 1 or (p.tiles < NUM_SMS and tile != (256, 128))
    assert TQM.quant_plan(2048, 4864, 896, "hopper", None) \
        == TQM.quant_plan(2048, 4864, 896)


def test_plan_rejects_what_it_cannot_launch():
    with pytest.raises(ValueError):
        TQM.quant_plan(0, 896, 896)
    with pytest.raises(ValueError):
        TQM.quant_plan(8, 896, 896, "tensor_cores")
    with pytest.raises(ValueError):                 # not a CUDA-core tile
        TQM.quant_plan(8, 896, 896, "cuda_core", (8, 64))


def test_hopper_shared_memory_and_residency():
    """Every tile fits a block's 227 KB; the 4-stage ring leaves room for
    three 64 x 64 chunk CTAs an SM, and the 256 x 128 tile has no room
    for a reduction tile (it is never split)."""
    for bm, bn in TQM.QUANT_TILES:
        assert TQM.hopper_smem_bytes(bm, bn) <= SMEM_BYTES
    assert TQM.resident_ctas(64, 64) == 3
    assert TQM.resident_ctas(8, 64, ranks=2) >= 2
    assert TQM.hopper_smem_bytes(256, 128, ranks=2) > SMEM_BYTES
    assert TQM.hopper_smem_bytes(128, 128, ranks=2) <= SMEM_BYTES


def test_wrapper_runs_the_plain_version_on_cpu_without_launching():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(5, 40, generator=g).bfloat16()
    w = torch.randint(-127, 128, (40, 24), generator=g, dtype=torch.int8)
    sc = torch.rand(24, generator=g)
    TQM.reset_launches()
    got = TQM.quant_matmul(x, w, sc)
    assert torch.equal(got, TQM.quant_matmul_ref(x, w, sc))
    assert TQM.launches.count == 0 and set(TQM.launches_by_route.values()) \
        == {0}
    with pytest.raises(ValueError):
        TQM.quant_matmul(x.to("meta"), w.to("meta"), sc.to("meta"))


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.source_files("quant_matmul")] \
        == ["quant_matmul.cu", "hopper.cuh"]
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    for name in _build.SOURCES:
        uses = "hopper.cuh" in [p.name for p in _build.source_files(name)]
        assert (after[name] != before[name]) == uses, name
    assert after["quant_matmul"] != before["quant_matmul"]
    assert after["mpgemm"] != before["mpgemm"]
    # a header reached through another header counts too
    (csrc / "extra.cuh").write_text("// first\n")
    with open(csrc / "hopper.cuh", "a") as f:
        f.write('#include "extra.cuh"\n')
    nested = _build.library_path("quant_matmul")
    (csrc / "extra.cuh").write_text("// second\n")
    assert _build.library_path("quant_matmul") != nested
