"""K4's fused entry and its plan, on the CPU.

``limb_gemm.limb_matmul_fused`` is ``ops.limb_matmul`` on the card: the
raw operands cut into digits in shared memory, the planes folded into
(hi, lo) in registers, one launch.  Here, where there is no card:

  * ``limb_plan`` on all 22 p-GEMMs of the port's integer path (MD, FFE,
    ALI's fully connected layers, the example and kernels_bench's two):
    a compiled kernel, SMs filled as far as the K stages allow, no K
    split above 2^17, accumulator registers and shared memory within the
    card's limits;
  * the fused entry's plain version on CPU tensors against the numpy
    mod-2^64 oracle and the reference's interpret-mode ``limb_matmul``:
    int8, int16 and int32 at their extremes, mixed dtypes with
    ``in_bits``, values wider than ``in_bits`` (the remainder dropped, as
    the unfused composition drops it), and the K split the plan makes
    (the ranks' sums added mod 2^64 give the whole);
  * the single-digit rule for int8 values (``digits_for``): one product
    gives what four gave, and only for K below 2^17.

Every result is an integer and is compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro_torch.core import workloads as WL
from repro_torch.core.pgemm import PGEMM, split_paths
from repro_torch.core.precision import INT16, INT32
from repro_torch.core.tiling import NUM_SMS
from repro_torch.kernels import limb_gemm as TLG
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF


def _limb_path():
    ops = []
    for name in ("MD", "FFE", "ALI"):
        gemms, _ = split_paths(WL.workload(name))
        ops += [g for g in gemms if name != "ALI" or ".fc" in g.name]
    ops.append(PGEMM("example", M=96, N=64, K=160, precision=INT32))
    ops += [PGEMM(f"kernels_bench.{p.name}", M=128, N=128, K=256,
                  precision=p) for p in (INT16, INT32)]
    return ops


LIMB_PATH = _limb_path()


def _ints(rng, dtype, shape):
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)
    x.flat[:2] = info.min, info.max
    x.flat[-1] = info.min
    return x


def _pair(hi, lo):
    return (hi.numpy(), lo.numpy())


def test_limb_path_has_22_pgemms():
    assert len(LIMB_PATH) == 22


@pytest.mark.parametrize("op", LIMB_PATH, ids=lambda op: op.name)
@pytest.mark.parametrize("entry", ["fused", "planes"])
def test_limb_plan_on_the_limb_path(op, entry):
    bits = op.precision.bits
    nl = TREF.n_limbs_for(bits)
    if entry == "fused":
        d = TLG.digits_for(bits, nl, op.K)
        plan = TLG.limb_plan(op.M, op.N, op.K, d, d, bits // 8, bits // 8)
        assert plan.a_digits == plan.b_digits == (1 if bits == 8 else nl)
    else:
        plan = TLG.limb_plan(op.M, op.N, op.K, nl, nl, limbs=True,
                             fused=False)
    L, wg, tq, ks = plan.config
    assert plan.config in TLG.CONFIGS and L >= plan.a_digits
    assert plan.swap == (op.M < 64 and op.N > op.M)
    bk = 32 * ks
    nk = -(-op.K // bk)
    # fills the SMs, or splits K as far as it goes (8 ranks, one stage each)
    assert plan.ctas >= NUM_SMS or plan.ranks == min(8, nk)
    assert plan.k_split(op.K) <= TLG.MAX_K
    assert 1 <= plan.stages <= 4
    # registers: 2L - 1 planes of tq / 2 and, fused, the int64 sums; the
    # rest of a thread's 255 is left for addresses and the digit loop
    assert plan.acc_registers + (tq if entry == "fused" else 0) <= 112
    assert plan.smem <= TLG.MAX_SMEM
    assert plan.off_raw + plan.stages * plan.stage + 1024 <= plan.smem
    assert plan.off_raw % 1024 == 0 and plan.stage % 1024 == 0
    assert plan.raw_a % 1024 == 0


def test_limb_plan_raises_outside_its_range():
    with pytest.raises(ValueError, match="2\\^17"):
        TLG.limb_plan(4, 4, (1 << 17) + 1, 5, 5, 4, 4)
    with pytest.raises(ValueError, match="empty"):
        TLG.limb_plan(0, 4, 4, 5, 5, 4, 4)
    with pytest.raises(ValueError, match="not a limb GEMM tile"):
        TLG.limb_plan(64, 64, 64, 5, 5, 4, 4, blocks=(128, 32, 128))


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_fused_plain_equals_oracle_at_the_extremes(dtype):
    rng = np.random.default_rng(np.iinfo(dtype).bits)
    a, b = _ints(rng, dtype, (13, 37)), _ints(rng, dtype, (37, 11))
    nl = TREF.n_limbs_for(np.iinfo(dtype).bits)
    got = _pair(*TLG.limb_matmul_fused(torch.from_numpy(a),
                                       torch.from_numpy(b), nl, nl))
    want = TREF.int_matmul_mod64_ref(a, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the same through ops.limb_matmul, its caller
    for g, w in zip(_pair(*TOPS.limb_matmul(torch.from_numpy(a),
                                            torch.from_numpy(b))), want):
        np.testing.assert_array_equal(g, w)


def test_fused_plain_equals_the_reference_limb_matmul():
    rng = np.random.default_rng(11)
    a, b = _ints(rng, np.int32, (24, 40)), _ints(rng, np.int32, (40, 9))
    jhi, jlo = JOPS.limb_matmul(jnp.asarray(a), jnp.asarray(b))
    hi, lo = TLG.limb_matmul_fused(torch.from_numpy(a), torch.from_numpy(b),
                                   5, 5)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


@pytest.mark.parametrize("ta,tb,in_bits", [
    (np.int32, np.int16, 16), (np.int16, np.int8, 8), (np.int8, np.int32, 32),
    (np.int32, np.int8, 12)])
def test_fused_plain_mixed_dtypes(ta, tb, in_bits):
    rng = np.random.default_rng(in_bits)
    lim = 1 << (min(in_bits, np.iinfo(ta).bits, np.iinfo(tb).bits) - 1)
    a = rng.integers(-lim, lim, (9, 21)).astype(ta)
    b = rng.integers(-lim, lim, (21, 6)).astype(tb)
    hi, lo = TOPS.limb_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              in_bits=in_bits)
    for g, w in zip((hi.numpy(), lo.numpy()),
                    TREF.int_matmul_mod64_ref(a, b)):
        np.testing.assert_array_equal(g, w)


def test_fused_plain_drops_what_in_bits_cannot_hold():
    """int32 values far wider than in_bits = 8 (two digits): the fused
    entry gives the unfused composition's bits -- the digits of each value
    recomposed, the remainder dropped -- not the exact product."""
    rng = np.random.default_rng(3)
    a = rng.integers(-2 ** 31, 2 ** 31 - 1, (7, 15)).astype(np.int32)
    b = rng.integers(-2 ** 31, 2 ** 31 - 1, (15, 5)).astype(np.int32)
    hi, lo = TOPS.limb_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              in_bits=8)
    # what two digits keep of each value: x mod 2^14, centred
    ta, tb = (TREF.limb_recompose_ref(
        TLG.limb_decompose(torch.from_numpy(x), 2).numpy()) for x in (a, b))
    assert np.array_equal((ta - a) % (1 << 14), np.zeros_like(ta))
    whi, wlo = TREF.int_matmul_mod64_ref(ta, tb)
    np.testing.assert_array_equal(hi.numpy(), whi)
    np.testing.assert_array_equal(lo.numpy(), wlo)
    assert not np.array_equal(lo.numpy(),
                              TREF.int_matmul_mod64_ref(a, b)[1])


def test_fused_plain_k_split_sums_mod_2_64():
    """The plan's K split (alexnet.fc6: 7 ranks): each rank's (hi, lo),
    added mod 2^64 in rank order, is the whole product -- what the ranks'
    DSMEM sum relies on."""
    M, N, K = 3, 5, 9216
    plan = TLG.limb_plan(32, 4096, K, 1, 1, 1, 1)
    assert plan.ranks == 7 and plan.ranks * plan.grid[0] <= TLG.CLUSTER_SLOTS
    rng = np.random.default_rng(9)
    a, b = _ints(rng, np.int8, (M, K)), _ints(rng, np.int8, (K, N))
    bk, nk = 32 * plan.config[3], -(-K // (32 * plan.config[3]))
    total = np.zeros((M, N), np.uint64)
    for z in range(plan.ranks):
        k0, k1 = z * nk // plan.ranks * bk, (z + 1) * nk // plan.ranks * bk
        hi, lo = TLG.limb_matmul_fused(torch.from_numpy(a[:, k0:k1].copy()),
                                       torch.from_numpy(b[k0:k1].copy()),
                                       2, 2)
        part = (hi.numpy().astype(np.int64).astype(np.uint64) << np.uint64(32)
                ) | lo.numpy().view(np.uint32).astype(np.uint64)
        with np.errstate(over="ignore"):
            total += part
    whi, wlo = TREF.int_matmul_mod64_ref(a, b)
    np.testing.assert_array_equal(
        (total >> np.uint64(32)).astype(np.uint32).view(np.int32), whi)
    np.testing.assert_array_equal(
        (total & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32), wlo)


def test_an_int8_value_is_its_own_digit():
    rng = np.random.default_rng(8)
    a, b = _ints(rng, np.int8, (6, 300)), _ints(rng, np.int8, (300, 4))
    assert TLG.digits_for(8, 2, 300) == 1 and TLG.digits_for(8, 1, 300) == 1
    assert TLG.digits_for(16, 3, 300) == 3 and TLG.digits_for(32, 5, 300) == 5
    single = TLG.limb_gemm_diagonals_ref(
        torch.from_numpy(a)[None], torch.from_numpy(b)[None])
    four = TLG.limb_gemm_diagonals_ref(TLG.limb_decompose(torch.from_numpy(a),
                                                          2),
                                       TLG.limb_decompose(torch.from_numpy(b),
                                                          2))
    folded = four[0].long() + (four[1].long() << 7) + (four[2].long() << 14)
    assert torch.equal(single[0].long(), folded)


def test_fused_wrapper_checks_its_operands():
    a = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        TLG.limb_matmul_fused(a.float(), a.T.contiguous(), 5, 5)
    with pytest.raises(ValueError, match="limb_matmul_fused needs"):
        TLG.limb_matmul_fused(a, torch.zeros(7, 3, dtype=torch.int32), 5, 5)


@pytest.mark.parametrize("K", [TLG.MAX_K - 1, TLG.MAX_K])
def test_int8_single_digit_only_below_max_k(K):
    """An int8 value is its own digit only while K < 2^17: at K = 2^17 a
    CTA summing every product of -128 * -128 would reach 2^31 in its int32
    plane, so the plan takes the two balanced digits there, whose sums stay
    exact.  The plan at 1024 x 1024 fills the card without a K split (one
    CTA sums the whole K), and the plain version at the extreme equals the
    oracle: K 2^14 is 2^31 - 2^14 or 2^31, lo's sign bit."""
    d = TLG.digits_for(8, 2, K)
    assert d == (1 if K < TLG.MAX_K else 2)
    plan = TLG.limb_plan(1024, 1024, K, d, d)
    assert plan.ranks == 1 and plan.config[0] == d
    a = np.full((1, K), -128, np.int8)
    b = np.full((K, 2), -128, np.int8)
    hi, lo = TLG.limb_matmul_fused(torch.from_numpy(a), torch.from_numpy(b),
                                   2, 2)
    want = a.astype(np.int64) @ b.astype(np.int64)      # exact: <= 2^31
    np.testing.assert_array_equal(hi.numpy(), want >> 32)
    np.testing.assert_array_equal(
        lo.numpy(), (want & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
    assert want[0, 0] == K << 14
