"""The paper's core technique end to end: an exact INT32 matrix product run
as int8 limb GEMMs (K4 on the card), recombined by the Fig.-3
multi-precision accumulator, beside the schedule the GTA explorer picks
for the same p-GEMM.

    python -m repro_torch.launch.multiprecision_gemm [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given (then the limb
GEMM's plain version runs).  Same seed, shape and output lines as the
reference's ``examples/multiprecision_gemm.py``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.pgemm import PGEMM
from repro_torch.core.precision import INT32
from repro_torch.core.scheduler import GTAConfig, explore
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(7)
    M, K, N = 96, 160, 64
    a = rng.integers(-2**31, 2**31 - 1, (M, K), dtype=np.int32)
    b = rng.integers(-2**31, 2**31 - 1, (K, N), dtype=np.int32)

    hi, lo = ops.limb_matmul(torch.from_numpy(a).to(dev),
                             torch.from_numpy(b).to(dev))
    rhi, rlo = ref.int_matmul_mod64_ref(a, b)
    exact = (np.array_equal(hi.cpu().numpy(), rhi)
             and np.array_equal(lo.cpu().numpy(), rlo))
    print(f"[limb_gemm] exact INT32 matmul mod 2^64: {exact}")

    choice = explore(PGEMM("demo", M=M, N=N, K=K, precision=INT32),
                     GTAConfig(lanes=4))
    s = choice.best.schedule
    print(f"[scheduler] best: {s.dataflow.value} array "
          f"{s.array.rows}x{s.array.cols} k_fold={s.k_fold} "
          f"({choice.cycles:.0f} cycles, "
          f"{choice.traffic_bytes/1e3:.1f} KB traffic, "
          f"util {choice.best.utilization:.2f})")
    print(f"[scheduler] explored {len(choice.space)} schedules")
    return exact


if __name__ == "__main__":
    raise SystemExit(0 if main() else 1)
