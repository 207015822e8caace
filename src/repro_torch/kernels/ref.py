"""Numpy oracles of the exact multi-precision integer GEMM (a copy of the
limb part of ``repro.kernels.ref``, paper §3.1).

Integer results are taken modulo 2^64 through numpy's uint64 wraparound:
exactly the semantics of the (hi, lo) int32-pair output of the
multi-precision accumulator.  The float oracles of the other kernels live
beside their wrappers.
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 7  # balanced base-128 digits: every digit fits signed int8


def n_limbs_for(bits: int, limb_bits: int = LIMB_BITS) -> int:
    """Digits of a signed balanced decomposition: ceil(bits/limb_bits)
    (the balanced form absorbs the sign without an extra digit)."""
    return -(-bits // limb_bits)


def limb_decompose_ref(x: np.ndarray, n_limbs: int,
                       limb_bits: int = LIMB_BITS) -> np.ndarray:
    """Balanced signed digits: x = sum_i d_i * (2^limb_bits)^i with every
    d_i in [-2^(b-1), 2^(b-1)).  Returns int8 (n_limbs,) + x.shape."""
    base = 1 << limb_bits
    half = base >> 1
    rem = x.astype(np.int64)
    digits = []
    for _ in range(n_limbs):
        d = ((rem + half) & (base - 1)) - half
        digits.append(d.astype(np.int8))
        rem = (rem - d) >> limb_bits
    if np.any(rem != 0):
        raise ValueError("value does not fit in the requested limbs")
    return np.stack(digits, axis=0)


def limb_recompose_ref(digits: np.ndarray, limb_bits: int = LIMB_BITS
                       ) -> np.ndarray:
    """Inverse of :func:`limb_decompose_ref` (int64, exact for values of
    at most 63 bits)."""
    acc = np.zeros(digits.shape[1:], dtype=np.int64)
    for i in range(digits.shape[0] - 1, -1, -1):
        acc = (acc << limb_bits) + digits[i].astype(np.int64)
    return acc


def int_matmul_mod64_ref(a: np.ndarray, b: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Exact integer matmul modulo 2^64 as (hi, lo) int32 pairs (two's
    complement), the multi-precision accumulator's output format."""
    au = a.astype(np.int64).astype(np.uint64)
    bu = b.astype(np.int64).astype(np.uint64)
    with np.errstate(over="ignore"):
        out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint64)
        for k in range(a.shape[1]):  # explicit loop: uint64 matmul exact
            out += au[:, k:k + 1] * bu[k:k + 1, :]
    lo = (out & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (out >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return hi, lo


def diagonal_sums_ref(a_limbs: np.ndarray, b_limbs: np.ndarray
                      ) -> np.ndarray:
    """The limb GEMM's intermediate: S_d = sum_{i+j=d} A_i @ B_j, int32.
    a_limbs (la, M, K) int8, b_limbs (lb, K, N) int8 -> (la+lb-1, M, N)."""
    la, lb = a_limbs.shape[0], b_limbs.shape[0]
    M, N = a_limbs.shape[1], b_limbs.shape[2]
    out = np.zeros((la + lb - 1, M, N), dtype=np.int32)
    for i in range(la):
        for j in range(lb):
            out[i + j] += (a_limbs[i].astype(np.int32)
                           @ b_limbs[j].astype(np.int32))
    return out
