"""The multi-precision accumulator (paper Fig. 3).

The limb GEMM (K4) produces per-anti-diagonal sums S_d = sum_{i+j=d}
A_i @ B_j in int32; the accumulator recombines them with shift-adds into
the exact result modulo 2^64.  The reference emulates 64 bits with uint32
pairs because its TPU has no int64; PyTorch has int64, whose ``<<`` and
``+`` wrap modulo 2^64, so the sum is taken there and split into the
reference's (hi, lo) int32 pair at the end (``& 0xFFFFFFFF`` and the
truncating cast to int32 give the low word in two's complement).  Plain
tensor code on either device, as the reference's is ``jnp``.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


def combine_diagonals(diags: torch.Tensor, limb_bits: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Recombine anti-diagonal sums into the exact 64-bit result.

    diags: (D, ...) int32.  Returns (hi, lo) int32 of shape
    diags.shape[1:] with sum_d diags[d] * 2^(d * limb_bits) modulo 2^64
    = hi * 2^32 + (lo as unsigned), in two's complement.  Diagonals
    shifted by 64 bits or more add nothing and are skipped."""
    if diags.dtype != torch.int32:
        raise TypeError(f"diagonal sums must be int32, got {diags.dtype}")
    return combine_wide_diagonals(diags.to(torch.int64), limb_bits)


def combine_wide_diagonals(diags: torch.Tensor, limb_bits: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`combine_diagonals` for int64 sums: the exact fold of
    diagonals that an int32 plane could not hold (a sum of 2^31 at
    K = 2^17, ``limb_gemm.limb_matmul_fused_ref``)."""
    if diags.dtype != torch.int64:
        raise TypeError(f"wide diagonal sums must be int64, got "
                        f"{diags.dtype}")
    acc = diags[0]
    for d in range(1, diags.shape[0]):
        s = d * limb_bits
        if s >= 64:
            break
        acc = acc + (diags[d] << s)
    return (acc >> 32).to(torch.int32), (acc & _MASK32).to(torch.int32)


def pair_to_int32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The pair truncated to int32 (the wrap a caller wants when it knows
    the result fits: int8/int16 operands, short K)."""
    del hi
    return lo


def pair_to_float(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Approximate value as float32 (for inspection)."""
    return hi.float() * 2.0 ** 32 + (lo.to(torch.int64) & _MASK32).float()
