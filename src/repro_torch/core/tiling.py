"""GTA scheduling -> Hopper kernel tiling.

The reference maps the paper's schedule onto TPU Pallas blocks (a 128x128
MXU, 16 MiB of VMEM).  On an H100 the same decision is which tile shape
the hand-written mpgemm kernels (``kernels/csrc/mpgemm.cu``) launch with
and how the work is spread over the 132 SMs.  The kernel has two routes
(``kernels.mpgemm.mpgemm_route``), and each has its tiles here.

The Hopper route (bf16 operands TMA can describe) has a fixed tile set,
``HOPPER_TILES``, picked by ``hopper_tile``: the swapped C^T tiles for
M <= 64 (and for more rows when 128 x 128 would leave SMs idle), 128 x
256 or 128 x 128 above, with ``HOPPER_BK`` (one ring stage) as the K
block.  ``hopper_smem_bytes`` is its shared-memory model (bf16 ring
stages, barriers, the DSMEM reduction tile) and ``hopper_launch`` its
launch geometry: the padded grid, the multicast cluster of WS/IS, and
the K units (fold bands or runs of whole K blocks) split over a cluster
of ranks under OS.

The CUDA-core route (fp32, and bf16 whose layout TMA refuses) keeps the
reference's method -- enumerate candidates, cost each one, normalize,
least sum of squares -- over its candidate space:

  * tiles: the (bm, bn) pairs the CUDA source instantiates
    (``KERNEL_TILES``), and a K block ``bk`` in multiples of the kernels'
    shared-memory stage ``KSTEP``;
  * shared memory: each candidate's staged tiles (fp32, padded rows) must
    fit the 227 KB a block may use;
  * compute term: SM waves x the MACs one CTA owns (padded tiles count),
    so candidates that leave SMs idle or waste tile area lose;
  * traffic term: the device-memory bytes the stationarity implies, the
    same structure as the reference (WS/IS re-read the streamed operand
    per stationary tile and read-modify-write the fp32 output once per
    K step; OS re-reads both operands and writes once).

``FOLD_GRAIN`` stays 128, the reference's K granularity for fold bands,
so the schedule cache's realizable-fold filter -- and hence its
(dataflow, k_fold) choice -- is the reference's exactly.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.core.dataflow import Dataflow

#: K granularity of fold bands (the reference's MXU_DIM)
FOLD_GRAIN = 128
#: shared memory one thread block may use on an H100 (227 KB)
SMEM_BYTES = 232_448
#: streaming multiprocessors of an H100 SXM
NUM_SMS = 132
#: CTAs the WS/IS split of the streamed dimension aims for (two waves)
TARGET_CTAS = 2 * NUM_SMS
#: K sub-step the kernels stage in shared memory per pass
KSTEP = 32
#: (bm, bn) tiles of the CUDA-core route (256 threads, 16 x 16)
KERNEL_TILES = ((16, 64), (64, 64), (128, 128))
BK_CANDIDATES = (32, 64, 128)

#: (bm, bn) tiles of the Hopper route, in C's orientation.  bm <= 64 is
#: the swapped tile: C^T, 64 rows of N (wgmma's M) by bm rows of M (its
#: n); (128, bn) is two consumer warpgroups of m64n{bn}.
HOPPER_TILES = ((8, 64), (16, 64), (32, 64), (64, 64), (128, 128),
                (128, 256))
#: K elements one ring stage holds: a 128-byte swizzled bf16 row
HOPPER_STAGE_K = 64
#: K block of the Hopper route: one ring stage (any fold the scheduler
#: realizes at FOLD_GRAIN, a multiple of it, executes as scheduled)
HOPPER_BK = HOPPER_STAGE_K
#: ring bytes of a swapped tile: 8 stages at n = 8 down to 4 at n = 64,
#: so three CTAs fit an SM
SWAP_RING_BYTES = 72 * 1024
#: largest cluster (portable size) over which OS splits its K units
MAX_CLUSTER = 8
#: CTAs a WS/IS cluster shares its stationary operand among (multicast)
MULTICAST = 2


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """A concrete kernel tiling: tile shape and the two cost terms the
    chooser weighed."""

    bm: int
    bn: int
    bk: int
    compute: float = 0.0
    hbm_bytes: float = 0.0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(bm: int, bn: int, bk: int, dataflow: Dataflow) -> int:
    """Shared memory a launch stages (fp32 tiles, rows padded by one to
    avoid bank conflicts): OS stages one KSTEP slice of A and B; WS keeps
    the whole bk x bn B tile and streams A slices; IS the converse."""
    a_slice = bm * (KSTEP + 1)
    b_slice = KSTEP * (bn + 1)
    if dataflow is Dataflow.WS:
        return 4 * (bk * (bn + 1) + a_slice)
    if dataflow is Dataflow.IS:
        return 4 * (bm * (bk + 1) + b_slice)
    return 4 * (a_slice + b_slice)


def hopper_tile(M: int, N: int) -> tuple[int, int]:
    """The Hopper route's tile for an (M, N) output: the smallest swapped
    tile whose n (= bm) covers M.  Above 64 rows the widest tile that
    still gives every SM a tile: 128 x 256 (half the operand traffic per
    product of 128 x 128: mamba2's in_proj and heads), else 128 x 128,
    else -- where even 128 x 128 leaves SMs idle, as at qwen2-0.5b's
    chunk rows (M = 256: 14-76 tiles) -- the swapped 64 x 64 tile, four
    times the CTAs."""
    for bm, bn in HOPPER_TILES[:4]:
        if M <= bm:
            return bm, bn
    for bm, bn in ((128, 256), (128, 128)):
        if _ceil(M, bm) * _ceil(N, bn) >= NUM_SMS:
            return bm, bn
    return 64, 64


def core_tile(bm: int, bn: int) -> tuple[int, int]:
    """The CUDA-core tile that runs a Hopper tile handed to operands the
    Hopper route does not take: the tile itself when the CUDA-core route
    has it, else the smallest of ``KERNEL_TILES`` covering it, else the
    largest (128 x 128 for 128 x 256).  The tile changes no result: the
    sums depend on bk only."""
    cover = [t for t in KERNEL_TILES if t[0] >= bm and t[1] >= bn]
    if (bm, bn) in KERNEL_TILES:
        return bm, bn
    if not cover:
        return KERNEL_TILES[-1]
    return min(cover, key=lambda t: t[0] * t[1])


def hopper_stages(bm: int, bn: int) -> int:
    """Ring stages of a Hopper tile (the kernel's ``Shape::kStages``): as
    many as ``SWAP_RING_BYTES`` holds, 4 to 8, for the byte-bound swapped
    tiles; 4 for 128 x 128."""
    if bm > 64:
        return 4
    stage = (bn + bm) * HOPPER_STAGE_K * 2
    return max(4, min(8, SWAP_RING_BYTES // stage))


def hopper_reduce_bytes(bm: int, bn: int) -> int:
    """The fp32 tile the K-split ranks reduce through DSMEM, or 0 where it
    does not fit beside the ring (128 x 256: its K is never split)."""
    ring = hopper_stages(bm, bn) * (bm + bn) * HOPPER_STAGE_K * 2
    red = bm * bn * 4
    return red if 1024 + ring + 256 + red <= SMEM_BYTES else 0


def hopper_smem_bytes(bm: int, bn: int, reduce: bool = True) -> int:
    """Dynamic shared memory of a Hopper-route launch: 1024 B of alignment
    slack, the ring (stages x (P rows + Q rows) x 128 B of bf16), 256 B
    of mbarriers and, when the K units are split over a cluster, the fp32
    tile the ranks reduce through DSMEM."""
    ring = hopper_stages(bm, bn) * (bm + bn) * HOPPER_STAGE_K * 2
    return 1024 + ring + 256 + (hopper_reduce_bytes(bm, bn) if reduce
                                else 0)


@dataclasses.dataclass(frozen=True)
class HopperLaunch:
    """Geometry of one Hopper-route launch (``csrc/mpgemm.cu``).

    P and Q are the wgmma operands: (A, B), or (B^T, A^T) under the swap.
    The grid is (grid_p, grid_q, zsplit); grid_p / grid_q pad tiles_p /
    tiles_q to whole multicast clusters.  Rank z of the K split walks
    units z, z + zsplit, ...; fused, the zsplit ranks form a cluster and
    sum their tiles through DSMEM; spilled, each stores its units'
    planes."""

    swap: bool
    tp: int
    tq: int
    tiles_p: int
    tiles_q: int
    grid_p: int
    grid_q: int
    units: int
    zsplit: int
    mc: int            # 0 none, 1 cluster along p (Q shared), 2 along q
    csize: int
    cluster: tuple[int, int, int]

    @property
    def grid(self) -> tuple[int, int, int]:
        return self.grid_p, self.grid_q, self.zsplit


@functools.lru_cache(maxsize=4096)
def hopper_launch(M: int, N: int, K: int, dataflow: Dataflow, bm: int,
                  bn: int, bk: int, f: int, spill: bool) -> HopperLaunch:
    """The Hopper route's launch for one dispatch (f: the executed fold).

    OS fused: the K units are the f fold bands (f > 1) or c consecutive
    runs of whole bk blocks (f == 1), split over a cluster of c ranks, c
    the most (<= ``MAX_CLUSTER``, <= the units available) that keeps the
    tiles x c CTAs within the 132 SMs.  OS spilled: one band per CTA, f
    CTAs a tile, no cluster.  WS / IS: every CTA owns its tile
    over all of K (one unit; one per K block when spilled); the
    stationary operand -- B under WS, A under IS -- is multicast to a
    cluster of ``MULTICAST`` CTAs along the other dimension, or of 1 when
    that dimension has one tile."""
    if (bm, bn) not in HOPPER_TILES:
        raise ValueError(f"({bm}, {bn}) is not a Hopper tile; tiles are "
                         f"{HOPPER_TILES}")
    swap = bm <= 64
    tp, tq = (bn, bm) if swap else (bm, bn)
    rows_p, rows_q = (N, M) if swap else (M, N)
    tiles_p, tiles_q = _ceil(rows_p, tp), _ceil(rows_q, tq)
    gk = max(1, _ceil(K, bk))
    grid_p, grid_q, mc, csize = tiles_p, tiles_q, 0, 1
    if dataflow in (Dataflow.WS, Dataflow.IS):
        units, zsplit = (gk if spill else 1), 1
        # the shared operand is P (A normally, B swapped) or Q
        shares_p = (dataflow is Dataflow.IS) != swap
        along = tiles_q if shares_p else tiles_p
        csize = MULTICAST if along > 1 else 1
        if csize > 1:
            mc = 2 if shares_p else 1
            if shares_p:
                grid_q = _ceil(tiles_q, csize) * csize
            else:
                grid_p = _ceil(tiles_p, csize) * csize
        cluster = (csize if mc == 1 else 1, csize if mc == 2 else 1, 1)
    elif spill:
        units = zsplit = f      # plane fi = band fi (f == 1: one plane)
        cluster = (1, 1, 1)
    else:
        avail = f if f > 1 else gk
        if not hopper_reduce_bytes(bm, bn):
            avail = 1           # one rank walks every band, in order
        zsplit = max(1, min(MAX_CLUSTER, avail,
                            NUM_SMS // (tiles_p * tiles_q)))
        units = f if f > 1 else zsplit
        cluster = (1, 1, zsplit)
    return HopperLaunch(swap, tp, tq, tiles_p, tiles_q, grid_p, grid_q,
                        units, zsplit, mc, csize, cluster)


def stream_split(M: int, N: int, bm: int, bn: int,
                 dataflow: Dataflow) -> tuple[int, int]:
    """(CTAs, streamed tiles per CTA) of a launch.  OS owns one output
    tile per CTA.  WS/IS own one stationary tile row (B tile column for
    WS, A tile row for IS) and split the streamed dimension into chunks
    so that about ``TARGET_CTAS`` CTAs are in flight."""
    gm, gn = _ceil(M, bm), _ceil(N, bn)
    if dataflow is Dataflow.WS:
        stat, streamed = gn, gm
    elif dataflow is Dataflow.IS:
        stat, streamed = gm, gn
    else:
        return gm * gn, 1
    chunks = min(streamed, _ceil(TARGET_CTAS, stat))
    per = _ceil(streamed, chunks)
    return stat * _ceil(streamed, per), per


def candidate_block_configs(M: int, N: int, K: int, dataflow: Dataflow, *,
                            ebytes: int = 2, obytes: int = 4
                            ) -> list[BlockConfig]:
    """Enumerate (bm, bn, bk) candidates for one dataflow, with costs."""
    df = dataflow
    out: list[BlockConfig] = []
    for bm, bn in KERNEL_TILES:
        gm, gn = _ceil(M, bm), _ceil(N, bn)
        for bk in BK_CANDIDATES:
            if smem_bytes(bm, bn, bk, df) > SMEM_BYTES:
                continue
            gk = _ceil(K, bk)
            ctas, per = stream_split(M, N, bm, bn, df)
            compute = _ceil(ctas, NUM_SMS) * per * bm * bn * gk * bk
            if df is Dataflow.WS:
                a = M * K * gn * ebytes
                b = K * N * ebytes
                o = M * N * 4 * (2 * gk - 1)
            elif df is Dataflow.IS:
                a = M * K * ebytes
                b = K * N * gm * ebytes
                o = M * N * 4 * (2 * gk - 1)
            else:
                a = M * K * gn * ebytes
                b = K * N * gm * ebytes
                o = M * N * obytes
            out.append(BlockConfig(bm, bn, bk, float(compute),
                                   float(a + b + o)))
    return out


def choose_block_config(M: int, N: int, K: int, dataflow: Dataflow, *,
                        ebytes: int = 2, obytes: int = 4) -> BlockConfig:
    """The paper's priority rule over the Hopper tilings of one dataflow
    (the schedule cache has already chosen the dataflow)."""
    cands = candidate_block_configs(M, N, K, dataflow, ebytes=ebytes,
                                    obytes=obytes)
    if not cands:
        raise ValueError(f"no feasible block config for {(M, N, K)}")
    min_c = max(min(c.compute for c in cands), 1e-9)
    min_h = max(min(c.hbm_bytes for c in cands), 1e-9)
    return min(cands, key=lambda c: (c.compute / min_c) ** 2
               + (c.hbm_bytes / min_h) ** 2)
