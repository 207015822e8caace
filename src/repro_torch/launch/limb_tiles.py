"""Time the exact integer GEMM (``ops.limb_matmul``) on the card.

    python -m repro_torch.launch.limb_tiles [--json PATH] [--tag NAME]

At md.update960 (960 x 960 x 64, INT32), ffe.fir (48000 x 2 x 128,
INT16) and alexnet.fc6 (32 x 4096 x 9216, INT8), operands drawn over the
whole range of their type from a seed: the device time of a
``limb_matmul`` call (median of CUDA events, L2 flushed, a long device
sleep ahead of each call so that a call of many launches is timed on the
device and not on the host), the host wall of back-to-back calls, K4's
planes entry (``limb_gemm.limb_gemm_diagonals`` on the digits), the
parts of the unfused composition (``limb_decompose`` of both operands,
``combine_diagonals``) and the plain composition, with the timing
method's floor (a one-element ``add_``) and the card's name and power
limit.  Only the public calls of ``ops``, ``limb_gemm`` and
``accumulator`` are used, so a copy of this file and ``timing.py`` times
an older tree of the port the same way (the before / after of PERF.md).
``chip_smoke.py``'s ``timing`` phase takes its K4 rows from
:func:`measure`.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import accumulator as ACC
from repro_torch.kernels import limb_gemm as LG
from repro_torch.kernels import ops as OPS
from repro_torch.kernels.ref import LIMB_BITS, n_limbs_for
from repro_torch.launch.timing import card_line, host_us, time_ms

#: (name, M, N, K, bits) of the timed p-GEMMs
SHAPES = (("md.update960", 960, 960, 64, 32), ("ffe.fir", 48000, 2, 128, 16),
          ("alexnet.fc6", 32, 4096, 9216, 8))
#: device cycles slept ahead of each timed call: covers the enqueue of the
#: unfused composition's ~120 launches
SLEEP = 20_000_000
#: seed of the operands
SEED = 5


def operands(M: int, N: int, K: int, bits: int, seed: int, dev):
    dt = {8: np.int8, 16: np.int16, 32: np.int32}[bits]
    info = np.iinfo(dt)
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(info.min, info.max, shape,
                                               dtype=dt, endpoint=True))
                 .to(dev) for shape in ((M, K), (K, N)))


def measure(dev: torch.device, flush: torch.Tensor) -> list[dict]:
    """One row a shape of :data:`SHAPES`: the times in the module's
    docstring, in ms (the host wall in us)."""
    rows = []
    for name, M, N, K, bits in SHAPES:
        a, b = operands(M, N, K, bits, SEED, dev)
        nl = n_limbs_for(bits, LIMB_BITS)
        al, bl = LG.limb_decompose(a, nl), LG.limb_decompose(b, nl)
        diags = LG.limb_gemm_diagonals(al, bl)
        rows.append({
            "name": name, "M": M, "N": N, "K": K, "bits": bits, "limbs": nl,
            "limb_matmul_ms": time_ms(lambda: OPS.limb_matmul(a, b), 30,
                                      flush, SLEEP),
            "limb_matmul_host_us": host_us(lambda: OPS.limb_matmul(a, b),
                                           100, 5),
            "planes_ms": time_ms(lambda: LG.limb_gemm_diagonals(al, bl), 30,
                                 flush, SLEEP),
            "decompose_ms": time_ms(lambda: (LG.limb_decompose(a, nl),
                                             LG.limb_decompose(b, nl)),
                                    20, flush, SLEEP),
            "combine_ms": time_ms(lambda: ACC.combine_diagonals(
                diags, LIMB_BITS), 20, flush, SLEEP),
            "plain_ms": time_ms(lambda: ACC.combine_diagonals(
                LG.limb_gemm_diagonals_ref(LG.limb_decompose(a, nl),
                                           LG.limb_decompose(b, nl)),
                LIMB_BITS), 10, flush, SLEEP)})
    return rows


def describe(r: dict) -> str:
    return (f"{r['name']} ({r['M']}, {r['N']}, {r['K']}) INT{r['bits']}: "
            f"limb_matmul {r['limb_matmul_ms'] * 1e3:.2f} us device, "
            f"{r['limb_matmul_host_us']:.1f} us host a call; planes entry "
            f"{r['planes_ms'] * 1e3:.2f} us; decompose "
            f"{r['decompose_ms'] * 1e3:.1f} us, combine "
            f"{r['combine_ms'] * 1e3:.1f} us; plain composition "
            f"{r['plain_ms'] * 1e3:.1f} us")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--tag", default="", help="label of this tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("limb_tiles needs a CUDA card")
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    one = torch.zeros(1, device=dev)
    card = card_line()
    floor = time_ms(lambda: one.add_(1), 50, flush)
    rows = measure(dev, flush)
    for r in rows:
        print(f"[{card}] {args.tag} {describe(r)}", flush=True)
    print(f"[{card}] {args.tag} timing floor (one-element add_): "
          f"{floor * 1e3:.2f} us")
    out = {"card": card, "tag": args.tag, "floor_ms": floor, "rows": rows}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1) + "\n")
    return out


if __name__ == "__main__":
    main()
