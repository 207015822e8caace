"""Time K2 on the Hopper route at every candidate tile, beside one
``torch.matmul`` of the same product, and the host time of a call.

    python -m repro_torch.launch.gemm_tiles [--shapes 256x896x896,...]

For each (M, N, K) -- by default qwen2-0.5b's and mamba2-2.7b's GEMMs at
chunk rows (256 and 2048) and two row counts between -- the scheduled
dataflow is resolved as
the serving backend resolves it, and K2 runs at the tile
``ops.plan_blocks`` picks and at the other Hopper tiles of its regime
(the swapped tiles for M <= 64, 64 x 64, 128 x 128 and 128 x 256 above).
Each time is the median of CUDA-event timed single launches with the L2
cache flushed between them.  Then the host cost: back-to-back
``ops.matmul`` calls at a decode shape, whose device time is shorter
than their enqueue, against back-to-back ``torch.matmul``.  Needs the
card; prints the card's name and one line a shape.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.scheduler import ScheduleCache
from repro_torch.core.tiling import HOPPER_STAGE_K, HOPPER_TILES
from repro_torch.device import resolve_device
from repro_torch.kernels import mpgemm as MP
from repro_torch.kernels import ops as OPS
from repro_torch.launch.timing import host_us, time_ms

SHAPES = ((256, 896, 896), (256, 4864, 896), (256, 896, 4864),
          (512, 2560, 5120), (1024, 10576, 2560), (2048, 10576, 2560),
          (2048, 2560, 5120), (2048, 50280, 2560))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=None,
                    help="comma-separated MxNxK (default: the serving "
                         "GEMMs at chunk rows)")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    shapes = SHAPES if args.shapes is None else [
        tuple(int(x) for x in s.split("x")) for s in args.shapes.split(",")]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    sched = ScheduleCache()
    gen = torch.Generator(device=dev).manual_seed(7)
    print(torch.cuda.get_device_name(0))
    for M, N, K in shapes:
        a = (torch.randn(M, K, generator=gen, device=dev) / K ** 0.5
             ).bfloat16()
        b = torch.randn(K, N, generator=gen, device=dev).bfloat16()
        df = sched.resolve(M, N, K, "BP16").dataflow
        picked = OPS.plan_blocks(M, N, K, 2, df, 1)[:2]
        tiles = [t for t in HOPPER_TILES if M <= t[0] <= 64] if M <= 64 \
            else [t for t in HOPPER_TILES if t[0] >= 64]
        cells = []
        for bm, bn in tiles:
            us = time_ms(lambda: MP.mpgemm(
                a, b, dataflow=df, bm=bm, bn=bn, bk=HOPPER_STAGE_K,
                out_dtype=torch.bfloat16), 20, flush) * 1e3
            cells.append(f"{bm}x{bn}{'*' if (bm, bn) == picked else ''} "
                         f"{us:.1f}")
        lib = time_ms(lambda: torch.matmul(a, b), 20, flush) * 1e3
        print(f"({M}, {N}, {K}) {df.value}: " + ", ".join(cells)
              + f" us; torch.matmul {lib:.1f} us  (* = plan_blocks)")
    a = torch.randn(8, 896, device=dev).bfloat16()
    b = torch.randn(896, 896, device=dev).bfloat16()
    k2 = host_us(lambda: OPS.matmul(a, b, out_dtype=torch.bfloat16,
                                    schedule=sched))
    lib = host_us(lambda: torch.matmul(a, b))
    print(f"host time a call at (8, 896, 896), back to back: ops.matmul "
          f"(K2) {k2:.1f} us, torch.matmul {lib:.1f} us")


if __name__ == "__main__":
    main()
