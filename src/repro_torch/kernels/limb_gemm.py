"""Limb GEMM (K4): anti-diagonal sums of int8 limb products, the paper's
§3.1 "matrix multiplication is precision multiplication".

An exact INT16/INT32 GEMM runs as ``la * lb`` int8 x int8 -> int32 limb
GEMMs, grouped by output anti-diagonal ``d = i + j`` and recombined by the
multi-precision accumulator (``kernels.accumulator``).  Operands are cut
into balanced base-128 signed digits (:func:`limb_decompose`), so every
digit fits int8 and every anti-diagonal sum stays exact in int32 for K up
to 2^17 (at most four full-range digit pairs, 4 * 64 * 64 = 2^14, meet
on one diagonal: the top digit of an int32 lies in [-8, 8]).

:func:`limb_gemm_diagonals` wraps ``csrc/limb_gemm.cu`` (the port of the
reference's Pallas ``limb_gemm_diagonals``): on CUDA tensors it launches
the kernel or raises; on CPU tensors it runs
:func:`limb_gemm_diagonals_ref`, the plain version.  Any M, N, K is
taken: the kernel masks its edges, where the reference pads to block
multiples (zero limbs add nothing).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.tiling import NUM_SMS
from repro_torch.kernels import _build

#: launches of the CUDA kernel (reset before a run, read after it)
launches = _build.LaunchCounter()

#: (bm, bn, bk) of the tiles compiled into csrc/limb_gemm.cu, in the order
#: of its ``tile`` argument: three general tiles, one for N <= 2 and one
#: for M <= 2; K is staged 32 deep in every tile
TILES = ((32, 64, 32), (32, 32, 32), (32, 16, 32), (128, 2, 32),
         (2, 128, 32))
#: most limbs of one operand the kernel holds (int32 needs 5 digits of 7
#: bits)
MAX_LIMBS = 5

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"limb_gemm_launch": ([_I] + [_P] * 3 + [_I] * 5 + [_P], _I)}


def tile_for(M: int, N: int) -> int:
    """Index into :data:`TILES` of the launch for an (M, N) output: the
    narrow tile of a skinny side, else the first general tile that puts
    at least one CTA on each of the 132 SMs, else the smallest."""
    if N <= 2:
        return 3
    if M <= 2:
        return 4
    for t in (0, 1, 2):
        bm, bn, _ = TILES[t]
        if -(-M // bm) * -(-N // bn) >= NUM_SMS:
            return t
    return 2


def limb_decompose(x: torch.Tensor, n_limbs: int, limb_bits: int = 7
                   ) -> torch.Tensor:
    """Balanced signed digits in int32 arithmetic, bit-equal to
    ``ref.limb_decompose_ref``: x (any integer type, cast to int32 first)
    -> (n_limbs, *x.shape) int8."""
    base = 1 << limb_bits
    half = base >> 1
    rem = x.to(torch.int32)
    digits = []
    for _ in range(n_limbs):
        r = rem & (base - 1)                       # low digit, 0..base-1
        d = ((r + half) & (base - 1)) - half       # balanced: -half..half-1
        digits.append(d.to(torch.int8))
        # rem_next = (rem - d) / base without overflow: (r - d) is 0 or
        # base, so its carry joins the arithmetic shift
        rem = (rem >> limb_bits) + ((r - d) >> limb_bits)
    return torch.stack(digits, dim=0)


def limb_gemm_diagonals_ref(a_limbs: torch.Tensor, b_limbs: torch.Tensor
                            ) -> torch.Tensor:
    """Plain version: S_d = sum_{i+j=d} A_i @ B_j as (la+lb-1, M, N)
    int32.  The la*lb limb products are taken in float64 and cast once:
    every partial sum is an integer below 2^31 for K <= 2^17, far inside
    float64's 2^53, so the result is exact on either device (PyTorch has
    no integer matmul on CUDA)."""
    la, lb = a_limbs.shape[0], b_limbs.shape[0]
    a64, b64 = a_limbs.double(), b_limbs.double()
    out = a64.new_zeros((la + lb - 1, a_limbs.shape[1], b_limbs.shape[2]))
    for i in range(la):
        for j in range(lb):
            out[i + j] += a64[i] @ b64[j]
    return out.to(torch.int32)


def _check(a_limbs: torch.Tensor, b_limbs: torch.Tensor) -> None:
    if a_limbs.dim() != 3 or b_limbs.dim() != 3 \
            or a_limbs.shape[2] != b_limbs.shape[1]:
        raise ValueError(f"limb_gemm_diagonals needs a_limbs (la, M, K) and "
                         f"b_limbs (lb, K, N), got {tuple(a_limbs.shape)} "
                         f"and {tuple(b_limbs.shape)}")
    if a_limbs.dtype != torch.int8 or b_limbs.dtype != torch.int8:
        raise TypeError(f"limb_gemm_diagonals takes int8 limbs, got "
                        f"{a_limbs.dtype} and {b_limbs.dtype}")
    if a_limbs.device != b_limbs.device:
        raise ValueError(f"limb operands on several devices: "
                         f"{a_limbs.device}, {b_limbs.device}")


def limb_gemm_diagonals(a_limbs: torch.Tensor, b_limbs: torch.Tensor, *,
                        tile: int | None = None) -> torch.Tensor:
    """Anti-diagonal sums of the limb GEMM: a_limbs (la, M, K) int8,
    b_limbs (lb, K, N) int8 -> (la+lb-1, M, N) int32, the CUDA kernel on
    CUDA tensors (``tile`` indexes :data:`TILES`, default
    :func:`tile_for`; at most :data:`MAX_LIMBS` limbs a side), the plain
    version on CPU tensors."""
    _check(a_limbs, b_limbs)
    if a_limbs.device.type == "cpu":
        return limb_gemm_diagonals_ref(a_limbs, b_limbs)
    if a_limbs.device.type != "cuda":
        raise ValueError(f"limb_gemm_diagonals runs on cuda or cpu, not "
                         f"{a_limbs.device}")
    la, M, K = a_limbs.shape
    lb, _, N = b_limbs.shape
    if min(la, lb, M, N, K) == 0 or max(la, lb) > MAX_LIMBS:
        raise ValueError(f"limb GEMM {(la, M, K)} x {(lb, K, N)}: empty, or "
                         f"more than {MAX_LIMBS} limbs a side")
    if not (a_limbs.is_contiguous() and b_limbs.is_contiguous()):
        raise ValueError("limb_gemm_diagonals needs contiguous limbs")
    t = tile_for(M, N) if tile is None else tile
    if not 0 <= t < len(TILES):
        raise ValueError(f"no limb GEMM tile {t}; tiles are {TILES}")
    out = torch.empty((la + lb - 1, M, N), dtype=torch.int32,
                      device=a_limbs.device)
    lib = _build.load("limb_gemm", _SIGNATURES)
    rc = lib.limb_gemm_launch(
        t, a_limbs.data_ptr(), b_limbs.data_ptr(), out.data_ptr(), la, lb,
        M, N, K, torch.cuda.current_stream(a_limbs.device).cuda_stream)
    _build.check_launch(rc, f"limb_gemm {(la, lb, M, N, K)}")
    launches.count += 1
    return out
