"""Port parity: the exact multi-precision integer GEMM (paper §3.1).

The same numpy-seeded inputs go through the reference (its Pallas
``limb_gemm_diagonals`` in interpret mode, as ``tests/test_kernels.py``
runs it) and the port (the plain versions the wrappers run on CPU
tensors).  Every result is an integer and is compared with
``array_equal``:

  * ``limb_decompose`` against the reference's and the numpy oracle, for
    int8, int16 and int32 with the extremes;
  * the limb GEMM's plain version against the reference's kernel on
    ``tests/test_kernels.py``'s shapes, at 2, 3 and 5 limbs and la != lb;
  * ``combine_diagonals`` against the reference and Python big integers;
  * ``ops.limb_matmul`` / ``limb_matmul_i32`` against the reference's
    ``ops.limb_matmul`` and ``int_matmul_mod64_ref``;
  * ``python -m repro_torch.launch.multiprecision_gemm --device cpu``
    prints what the reference's example prints.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:              # offline container: vendored shim
    from _hypothesis_stub import given, settings, strategies as st

from repro.kernels import accumulator as JACC
from repro.kernels import limb_gemm as JLG
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro_torch.kernels import accumulator as TACC
from repro_torch.kernels import limb_gemm as TLG
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.launch import multiprecision_gemm as TMPG

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(8, 16, 8), (65, 130, 75), (128, 128, 128), (33, 257, 129)]
DTYPES = {"int8": np.int8, "int16": np.int16, "int32": np.int32}


def _ints(rng, dtype, shape):
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)
    x.flat[:2] = info.min, info.max          # the extremes, every time
    return x


def test_oracles_match_reference():
    rng = np.random.default_rng(0)
    x = _ints(rng, np.int32, (40,))
    for nl in (5, 6):
        d = TREF.limb_decompose_ref(x, nl)
        np.testing.assert_array_equal(d, JREF.limb_decompose_ref(x, nl))
        np.testing.assert_array_equal(TREF.limb_recompose_ref(d), x)
    a, b = _ints(rng, np.int32, (9, 17)), _ints(rng, np.int32, (17, 5))
    for t, j in zip(TREF.int_matmul_mod64_ref(a, b),
                    JREF.int_matmul_mod64_ref(a, b)):
        np.testing.assert_array_equal(t, j)
    assert [TREF.n_limbs_for(b) for b in (8, 16, 32, 33)] == \
        [JREF.n_limbs_for(b) for b in (8, 16, 32, 33)] == [2, 3, 5, 5]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_limb_decompose_matches_reference(dtype):
    dt = DTYPES[dtype]
    x = _ints(np.random.default_rng(1), dt, (6, 50))
    x[0, :4] = [0, -1, 1, np.iinfo(dt).min + 1]
    nl = TREF.n_limbs_for(np.iinfo(dt).bits)
    got = TLG.limb_decompose(torch.from_numpy(x), nl).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JLG.limb_decompose(jnp.asarray(x), nl)))
    np.testing.assert_array_equal(got, TREF.limb_decompose_ref(x, nl))
    assert got.dtype == np.int8 and got.shape == (nl,) + x.shape


@pytest.mark.parametrize("la,lb", [(2, 2), (3, 3), (5, 5), (2, 5)])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_limb_gemm_plain_matches_reference_kernel(shape, la, lb):
    M, K, N = shape
    rng = np.random.default_rng(M * K + N + la * lb)
    a = rng.integers(-64, 64, (la, M, K), dtype=np.int8)
    b = rng.integers(-64, 64, (lb, K, N), dtype=np.int8)
    got = TLG.limb_gemm_diagonals(torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy()
    # the reference kernel takes block multiples: pad to multiples of 8
    # and run one block (one interpret-mode grid step)
    bm, bk, bn = (-(-x // 8) * 8 for x in (M, K, N))
    pa = np.pad(a, ((0, 0), (0, bm - M), (0, bk - K)))
    pb = np.pad(b, ((0, 0), (0, bk - K), (0, bn - N)))
    want = np.asarray(JLG.limb_gemm_diagonals(
        jnp.asarray(pa), jnp.asarray(pb), bm=bm, bn=bn, bk=bk,
        interpret=True))[:, :M, :N]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, TREF.diagonal_sums_ref(a, b))


def test_limb_gemm_wrapper_checks_its_operands():
    a = torch.zeros(2, 4, 8, dtype=torch.int8)
    with pytest.raises(TypeError):
        TLG.limb_gemm_diagonals(a.int(), torch.zeros(2, 8, 3,
                                                     dtype=torch.int8))
    with pytest.raises(ValueError, match="limb_gemm_diagonals needs"):
        TLG.limb_gemm_diagonals(a, torch.zeros(2, 7, 3, dtype=torch.int8))


@given(st.lists(st.integers(-2**31, 2**31 - 1), min_size=1, max_size=9))
@settings(max_examples=200, deadline=None)
def test_combine_matches_bigint_and_reference(diag_vals):
    diags = np.asarray(diag_vals, np.int32)[:, None, None]
    hi, lo = TACC.combine_diagonals(torch.from_numpy(diags), 7)
    want = sum(int(v) << (7 * d) for d, v in enumerate(diag_vals))
    want &= (1 << 64) - 1
    got = ((int(hi[0, 0]) & 0xFFFFFFFF) << 32) | (int(lo[0, 0]) & 0xFFFFFFFF)
    assert got == want
    jhi, jlo = JACC.combine_diagonals(jnp.asarray(diags), 7)
    assert int(hi[0, 0]) == int(np.asarray(jhi)[0, 0])
    assert int(lo[0, 0]) == int(np.asarray(jlo)[0, 0])


def test_combine_planes_and_pair_helpers_match_reference():
    rng = np.random.default_rng(3)
    diags = rng.integers(-2**31, 2**31 - 1, (12, 7, 9), dtype=np.int32,
                         endpoint=True)      # shifts 77 > 64: skipped
    diags[:, 0, 0] = np.iinfo(np.int32).min
    for limb_bits in (7, 8, 16):
        hi, lo = TACC.combine_diagonals(torch.from_numpy(diags), limb_bits)
        jhi, jlo = JACC.combine_diagonals(jnp.asarray(diags), limb_bits)
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(
            TACC.pair_to_int32(hi, lo).numpy(),
            np.asarray(JACC.pair_to_int32(jhi, jlo)))
        np.testing.assert_array_equal(
            TACC.pair_to_float(hi, lo).numpy(),
            np.asarray(JACC.pair_to_float(jhi, jlo)))


def test_combine_rejects_non_int32():
    with pytest.raises(TypeError):
        TACC.combine_diagonals(torch.zeros(3, 2, 2), 7)
    with pytest.raises(TypeError):
        TACC.combine_diagonals(torch.zeros(3, 2, 2, dtype=torch.int64), 7)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_limb_matmul_matches_reference(shape, dtype):
    M, K, N = shape
    dt = DTYPES[dtype]
    rng = np.random.default_rng(M + K + N)
    a, b = _ints(rng, dt, (M, K)), _ints(rng, dt, (K, N))
    hi, lo = TOPS.limb_matmul(torch.from_numpy(a), torch.from_numpy(b))
    rhi, rlo = TREF.int_matmul_mod64_ref(a, b)
    np.testing.assert_array_equal(hi.numpy(), rhi)
    np.testing.assert_array_equal(lo.numpy(), rlo)
    np.testing.assert_array_equal(
        TOPS.limb_matmul_i32(torch.from_numpy(a), torch.from_numpy(b))
        .numpy(), rlo)
    if shape == SHAPES[1]:       # one interpret-mode run of the reference
        jhi, jlo = JOPS.limb_matmul(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


def test_limb_matmul_in_bits_and_blocks():
    rng = np.random.default_rng(5)
    a = rng.integers(-1000, 1000, (20, 30)).astype(np.int32)
    b = rng.integers(-1000, 1000, (30, 10)).astype(np.int16)
    with pytest.raises(ValueError, match="in_bits"):
        TOPS.limb_matmul(torch.from_numpy(a), torch.from_numpy(b))
    with pytest.raises(ValueError, match="in_bits"):
        JOPS.limb_matmul(jnp.asarray(a), jnp.asarray(b))
    # in_bits 16: three digits a side, so a tile of the 3-digit kernels
    hi, lo = TOPS.limb_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              in_bits=16, blocks=(128, 32, 128))
    rhi, rlo = TREF.int_matmul_mod64_ref(a, b)
    np.testing.assert_array_equal(hi.numpy(), rhi)
    np.testing.assert_array_equal(lo.numpy(), rlo)
    assert (128, 32, 128) in TLG.TILES
    for bad in ((128, 128, 128), (64, 16, 64)):  # no tile; a 5-digit tile
        with pytest.raises(ValueError, match="not a limb GEMM tile"):
            TOPS.limb_matmul(torch.from_numpy(a), torch.from_numpy(b),
                             in_bits=16, blocks=bad)


def test_tile_choice_fills_the_card():
    def plan(M, N, K, bits):
        d = TLG.digits_for(bits, TREF.n_limbs_for(bits), K)
        return TLG.limb_plan(M, N, K, d, d, bits // 8, bits // 8)
    assert plan(960, 960, 64, 32).tile == (64, 16, 64)
    assert plan(48000, 2, 128, 16).tile == (128, 8, 128)
    fc6 = plan(32, 4096, 9216, 8)
    assert fc6.swap and fc6.tile == (32, 128, 128) and fc6.ranks == 7
    assert fc6.config[0] == 1                # an int8 value is its digit
    assert plan(1, 300, 96, 32).tile == (8, 128, 128)
    for M, N, K, bits in ((960, 960, 64, 32), (48000, 2, 128, 16),
                          (32, 4096, 9216, 8), (512, 512, 64, 32)):
        assert plan(M, N, K, bits).ctas >= 132


def test_example_prints_what_the_reference_prints(capsys):
    spec = importlib.util.spec_from_file_location(
        "reference_multiprecision_gemm",
        ROOT / "examples" / "multiprecision_gemm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main()
    want = capsys.readouterr().out
    assert TMPG.main(["--device", "cpu"]) is True
    got = capsys.readouterr().out
    assert got == want
    assert "exact INT32 matmul mod 2^64: True" in got
