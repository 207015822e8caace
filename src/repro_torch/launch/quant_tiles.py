"""Time K3 (the int8-weight GEMM) at qwen2-0.5b's int8 projections, beside
its bound, its plain version and two PyTorch calls, and the host time of
a call.

    python -m repro_torch.launch.quant_tiles [--shapes MxNxK,...] [--tiles] [--out f.json]

For each (M, N, K) -- by default the eight of the int8 serving path: q/o,
k/v, gate/up and down at M = 8 (decode, 8 slots) and 256 (8 slots x 32
chunk rows) -- bf16 x and a per-channel int8 weight are drawn from a
seed; each time is the median of CUDA-event timed single calls with the
L2 cache flushed between them (``launch/timing.py``).  Beside the kernel:
the bound (the int8 weight, x, the scale and the fp32 output moved once
at 3.35 TB/s, or the products at 989 TFLOP/s bf16, whichever is longer),
the plain version, ``torch._weight_int8pack_mm`` (one PyTorch call
computing the same function) and ``torch.mm`` over a pre-dequantized
bf16 weight (context); at M <= 16 also the same call with fp32 x, which
takes the CUDA-core route (fp32 FMAs).  With ``--tiles``, shapes above
64 rows are also timed at every chunk tile of the Hopper route.  Then
the floor of the timing method (a one-element ``add_`` timed the same
way) and the host cost: back-to-back calls at (8, 896, 896), whose
device time is shorter than their enqueue, against back-to-back
``torch.matmul``.

The script reads only ``quant_matmul``'s public wrapper, so it also
times an older tree's kernel: copy this file and ``timing.py`` into that
tree's ``launch/`` and run it there; columns that tree lacks (route,
plan, tiles) print as "-".  Needs the card; prints the card's name and
one line a shape.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from repro_torch.core.scheduler import ScheduleCache
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import quant_matmul as QM
from repro_torch.launch.timing import bound_ms, card_line, host_us, time_ms

#: (N, K) of qwen2-0.5b's int8 projections: q/o, k/v, gate/up, down
PATH_NK = ((896, 896), (128, 896), (4864, 896), (896, 4864))
SHAPES = tuple((M, N, K) for M in (8, 256) for N, K in PATH_NK)


def inputs(M: int, N: int, K: int, dtype: torch.dtype, seed: int,
           dev: torch.device):
    """x ~ N(0, 1/K) as after RMSNorm, and a weight ~ N(0, 0.02^2)
    quantized per output channel: (x, w_q int8 (K, N), scale fp32 (N,))."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(M, K, generator=gen, device=dev) / K ** 0.5).to(dtype)
    w8, sc = OPS.quantize_weights(
        0.02 * torch.randn(K, N, generator=gen, device=dev))
    return x, w8, sc


def k3_bound_ms(M: int, N: int, K: int) -> tuple[float, str]:
    """The least time for a bf16-x call: bytes (x, the int8 weight and
    the scale read once, the fp32 output written once) or operations."""
    return bound_ms(2 * M * K + K * N + 4 * N + 4 * M * N, 2 * M * N * K,
                    "bfloat16")


def plan_of(M: int, N: int, K: int, x: torch.Tensor, w8: torch.Tensor
            ) -> dict:
    """The route and plan the tree's wrapper takes ("-" where it has
    none)."""
    route_fn = getattr(QM, "quant_matmul_route", None)
    plan_fn = getattr(QM, "quant_plan", None)
    if route_fn is None or plan_fn is None:
        return {"route": "-", "tile": "-", "ranks": "-"}
    p = plan_fn(M, N, K, route_fn(x, w8))
    return {"route": p.route, "tile": list(p.tile), "ranks": p.ranks}


def measure(shapes, dev: torch.device, flush: torch.Tensor,
            iters: int = 100, tiles: bool = False) -> list[dict]:
    """One row a shape: plan, kernel, bound, plain, library and context
    times (ms); with ``tiles``, above 64 rows the kernel at every chunk
    tile too (``tiles_ms``, keyed "BMxBN")."""
    lib_fn = getattr(torch, "_weight_int8pack_mm", None)
    rows = []
    for M, N, K in shapes:
        x, w8, sc = inputs(M, N, K, torch.bfloat16, 11, dev)
        kern = time_ms(lambda: QM.quant_matmul(x, w8, sc), iters, flush)
        plain = time_ms(lambda: QM.quant_matmul_ref(x, w8, sc),
                        max(5, iters // 4), flush)
        lib, lib_name = None, "none"
        if lib_fn is not None:
            # one call taking the int8 weight and a bf16 activation
            wt, sb = w8.t().contiguous(), sc.to(torch.bfloat16)
            try:
                got = lib_fn(x, wt, sb).float()
                want = QM.quant_matmul_ref(x, w8, sc)
                if ((got - want).abs() / (1 + want.abs())).max() < 2e-2:
                    lib = time_ms(lambda: lib_fn(x, wt, sb), iters, flush)
                    lib_name = "torch._weight_int8pack_mm"
                else:
                    lib_name = "none (_weight_int8pack_mm disagrees)"
            except (RuntimeError, NotImplementedError) as e:
                lib_name = f"none (_weight_int8pack_mm: {str(e)[:80]})"
        wd = (w8.to(torch.bfloat16) * sc.to(torch.bfloat16)).contiguous()
        ctx = time_ms(lambda: torch.mm(x, wd), iters, flush)
        core = None
        if M <= 16:
            xf = x.float()
            core = time_ms(lambda: QM.quant_matmul(xf, w8, sc), iters, flush)
        by_tile = None
        if tiles and M > 64 and hasattr(QM, "quant_plan"):
            by_tile = {f"{bm}x{bn}": time_ms(lambda: QM.quant_matmul(
                x, w8, sc, tile=(bm, bn)), iters, flush)
                for bm, bn in QM.QUANT_TILES if bm >= 64}
        b_ms, b_by = k3_bound_ms(M, N, K)
        rows.append({"M": M, "N": N, "K": K, **plan_of(M, N, K, x, w8),
                     "ms": kern, "plain_ms": plain, "library_ms": lib,
                     "library": lib_name, "context_ms": ctx,
                     "context": "torch.mm over a pre-dequantized bf16 "
                                "weight",
                     "fp32_x_cuda_core_ms": core, "tiles_ms": by_tile,
                     "bound_ms": b_ms, "bound_by": b_by})
        del x, w8, sc, wd
    return rows


def host_row(dev: torch.device) -> dict:
    """Host time a call (us) at (8, 896, 896), back to back: the wrapper
    with bf16 x and with fp32 x (the same Python path, the CUDA-core
    route's plain launch: no tensor maps, no cluster), ``ops.quant_matmul``
    as the scheduled backend calls it, and ``torch.matmul`` over the
    dequantized bf16 weight."""
    x, w8, sc = inputs(8, 896, 896, torch.bfloat16, 3, dev)
    xf = x.float()
    wd = (w8.to(torch.bfloat16) * sc.to(torch.bfloat16)).contiguous()
    sched = ScheduleCache()
    return {"shape": [8, 896, 896],
            "quant_matmul_us": host_us(lambda: QM.quant_matmul(x, w8, sc)),
            "quant_matmul_fp32_x_us": host_us(
                lambda: QM.quant_matmul(xf, w8, sc)),
            "ops_quant_matmul_us": host_us(
                lambda: OPS.quant_matmul(x, w8, sc, schedule=sched)),
            "torch_matmul_us": host_us(lambda: torch.matmul(x, wd))}


def floor_ms(dev: torch.device, flush: torch.Tensor, iters: int = 100
             ) -> float:
    """The timing method's own floor: a one-element ``add_`` timed as the
    kernel is.  A kernel shorter than this reads as this."""
    one = torch.zeros(1, device=dev)
    return time_ms(lambda: one.add_(1), iters, flush)


def describe(r: dict) -> str:
    lib = "-" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.1f} us"
    tile = r["tile"] if r["tile"] == "-" else f"{r['tile'][0]}x{r['tile'][1]}"
    return (f"K3 bf16 ({r['M']}, {r['N']}, {r['K']}) {r['route']} tile "
            f"{tile} x {r['ranks']} ranks: kernel {r['ms'] * 1e3:.1f} us, "
            f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), plain "
            f"{r['plain_ms'] * 1e3:.1f} us, {r['library']} {lib}, torch.mm "
            f"dequantized {r['context_ms'] * 1e3:.1f} us"
            + ("" if r["fp32_x_cuda_core_ms"] is None else
               f", fp32 x (CUDA cores) {r['fp32_x_cuda_core_ms'] * 1e3:.1f}"
               f" us")
            + ("" if not r["tiles_ms"] else "; by tile " + ", ".join(
                f"{t} {ms * 1e3:.1f} us" for t, ms in r["tiles_ms"].items())))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=None,
                    help="comma-separated MxNxK (default: the serving "
                         "path's eight)")
    ap.add_argument("--tiles", action="store_true",
                    help="above 64 rows, also time every chunk tile")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("quant_tiles: needs a CUDA card")
    dev = torch.device("cuda")
    shapes = SHAPES if args.shapes is None else [
        tuple(int(v) for v in s.split("x")) for s in args.shapes.split(",")]
    card = card_line()
    print(card)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = measure(shapes, dev, flush, tiles=args.tiles)
    for r in rows:
        print(describe(r))
    floor = floor_ms(dev, flush)
    print(f"timing floor (one-element add_, same method): "
          f"{floor * 1e3:.1f} us")
    host = host_row(dev)
    print(f"host time a call at (8, 896, 896), back to back: quant_matmul "
          f"{host['quant_matmul_us']:.1f} us (fp32 x, CUDA-core route: "
          f"{host['quant_matmul_fp32_x_us']:.1f} us), ops.quant_matmul "
          f"(scheduled) "
          f"{host['ops_quant_matmul_us']:.1f} us, torch.matmul "
          f"{host['torch_matmul_us']:.1f} us")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "tree": str(Path(QM.__file__).parents[3]),
             "rows": rows, "floor_ms": floor, "host": host}, indent=1)
            + "\n")


if __name__ == "__main__":
    main()
