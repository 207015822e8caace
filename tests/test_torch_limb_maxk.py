"""``ops.limb_matmul`` at the longest K it takes, K = 2^17, on the CPU.

Balanced base-128 digits lie in [-64, 63], and four full-range digit
pairs meet on plane 3 when both operands have four or more digits (int32,
or ``in_bits`` >= 22): 4 * 64 * 64 = 2^14 a k, so 2^31 at K = 2^17, one
past int32.  ``limb_matmul`` must stay exact there: its plain version
folds the planes in int64, and ``limb_plan`` gives the fused entry two
cluster ranks (each summing at most 2^30, added in 64-bit on the card).
The planes entry keeps the reference's int32 planes and wraps, as the
reference's kernel does.  Every result is compared bit for bit with the
numpy mod-2^64 oracle; the card's twin is in
``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import limb_gemm as TLG
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels.ref import int_matmul_mod64_ref

K = TLG.MAX_K
#: digits -64, -64, -64, -64, 0: every plane-3 product is (-64)^2
WORST = -135274560


def _value(hi, lo) -> int:
    return (int(hi) << 32) | (int(lo) & 0xFFFFFFFF)


def test_limb_matmul_exact_at_max_k():
    """The input of the fault: a = (1, 2^17) of ``WORST``, b = a.T."""
    a = np.full((1, K), WORST, np.int32)
    hi, lo = TOPS.limb_matmul(torch.from_numpy(a),
                              torch.from_numpy(a.T.copy()))
    whi, wlo = int_matmul_mod64_ref(a, a.T)
    np.testing.assert_array_equal(hi.numpy(), whi)
    np.testing.assert_array_equal(lo.numpy(), wlo)
    assert _value(hi[0, 0], lo[0, 0]) == 436875690109829120


@pytest.mark.parametrize("in_bits", [22, 28, 32])
def test_limb_matmul_in_bits_at_max_k(in_bits):
    """Four and five digits a side at K = 2^17: random values the digits
    hold beside the worst case (four digits of -64 hold it too), against
    the oracle."""
    rng = np.random.default_rng(in_bits)
    lim = 1 << (in_bits - 2)
    a = rng.integers(-lim, lim, (2, K)).astype(np.int32)
    if in_bits >= 28:
        a[0] = WORST
    b = rng.integers(-lim, lim, (K, 3)).astype(np.int32)
    b[:, 0] = a[0]
    hi, lo = TOPS.limb_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              in_bits=in_bits)
    whi, wlo = int_matmul_mod64_ref(a, b)
    np.testing.assert_array_equal(hi.numpy(), whi)
    np.testing.assert_array_equal(lo.numpy(), wlo)


@pytest.mark.parametrize("digits,want_split", [((5, 5), True),
                                               ((4, 5), True),
                                               ((4, 4), True),
                                               ((3, 5), False),
                                               ((2, 2), False)])
def test_plan_splits_k_where_a_plane_could_wrap(digits, want_split):
    """1024 x 1024 fills the card without a K split; at K = 2^17 the
    fused entry still takes two ranks when both sides have >= 4 digits,
    so no rank sums more than 2^16 k; one rank below 2^17 or with fewer
    pairs a plane."""
    plan = TLG.limb_plan(1024, 1024, K, *digits, 4, 4)
    assert (plan.ranks >= 2) == want_split
    assert plan.k_split(K) <= (K // 2 if want_split else K)
    assert TLG.limb_plan(1024, 1024, K - 1, *digits, 4, 4).ranks == 1
    assert TLG.limb_plan(1024, 1024, K, *digits, 1, 1, limbs=True,
                         fused=False).ranks == 1


def test_plan_refuses_one_rank_where_a_plane_would_wrap():
    with pytest.raises(ValueError, match="2\\^31"):
        TLG.limb_plan(1024, 1024, K, 5, 5, 4, 4, ranks=1)
    assert TLG.limb_plan(1024, 1024, K, 5, 5, 4, 4, ranks=3).ranks == 3


def test_planes_entry_wraps_as_the_reference():
    """The planes keep the reference's int32 contract: plane 3 of the
    worst input is 2^31 and reads -2^31; the wide sums behind
    ``limb_matmul`` hold 2^31."""
    a = torch.full((1, K), WORST, dtype=torch.int32)
    al = TLG.limb_decompose(a, 5)
    bl = TLG.limb_decompose(a.T.contiguous(), 5)
    planes = TLG.limb_gemm_diagonals_ref(al, bl)
    wide = TLG._diagonal_sums64(al, bl)
    assert int(wide[3, 0, 0]) == 1 << 31
    assert int(planes[3, 0, 0]) == -(1 << 31)
    assert torch.equal(planes[[0, 1, 2, 4]], wide[[0, 1, 2, 4]].int())
