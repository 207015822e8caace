"""GTA scheduling -> Hopper kernel tiling.

The reference maps the paper's schedule onto TPU Pallas blocks (a 128x128
MXU, 16 MiB of VMEM).  On an H100 the same decision is which tile shape
the hand-written mpgemm kernels (``kernels/csrc/mpgemm.cu``) launch with
and how the streamed dimension is split over the 132 SMs.  This module
keeps the reference's method -- enumerate candidates, cost each one,
normalize, least sum of squares -- over the Hopper candidate space:

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
#: (bm, bn) tiles compiled into csrc/mpgemm.cu (256 threads, 16 x 16)
KERNEL_TILES = ((16, 64), (64, 64), (128, 128))
BK_CANDIDATES = (32, 64, 128)


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
