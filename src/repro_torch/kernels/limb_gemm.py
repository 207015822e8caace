"""Limb GEMM (K4): anti-diagonal sums of int8 limb products, the paper's
§3.1 "matrix multiplication is precision multiplication".

An exact INT16/INT32 GEMM runs as ``la * lb`` int8 x int8 -> int32 limb
GEMMs, grouped by output anti-diagonal ``d = i + j`` and recombined by the
multi-precision accumulator (``kernels.accumulator``).  Operands are cut
into balanced base-128 signed digits (:func:`limb_decompose`), so every
digit fits int8.  At most four full-range digit pairs meet on one
diagonal (the top digit of an int32 lies in [-8, 8]): 4 * 64 * 64 = 2^14
a k, so an anti-diagonal sum stays inside int32 for K < 2^17 and reaches
2^31 at K = 2^17 only when both sides have four or more digits.  There
the planes entry wraps, as the reference's kernel does, while
``limb_matmul`` stays exact: the fused entry splits such a K over two
cluster ranks (each sum at most 2^30, added in 64-bit) and its plain
version folds the planes in int64.

``csrc/limb_gemm.cu`` (the port of the reference's Pallas
``limb_gemm_diagonals``) is one int8 tensor-core mainloop with two
entries, which differ only in what they read and their epilogue:

  :func:`limb_gemm_diagonals`  the reference's K4: int8 limbs in, the
                               (la+lb-1, M, N) int32 planes out;
  :func:`limb_matmul_fused`    the raw int8/int16/int32 operands in, cut
                               into digits in shared memory, the planes
                               folded into (hi, lo) int32 mod 2^64 in
                               registers -- ``ops.limb_matmul`` on the card
                               in one launch.

:func:`limb_plan` fixes the tile, the digit counts, the K split over a
cluster and the shared-memory layout from the shapes alone.  On CUDA
tensors each wrapper launches the kernel or raises; on CPU tensors it
runs its plain version (:func:`limb_gemm_diagonals_ref`,
:func:`limb_matmul_fused_ref`).  Any M, N and K <= 2^17 is taken: the
kernel masks its edges, where the reference pads to block multiples
(zero limbs add nothing).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.tiling import MAX_CLUSTER, NUM_SMS
from repro_torch.kernels import _build
from repro_torch.kernels.accumulator import combine_wide_diagonals
from repro_torch.kernels.ref import LIMB_BITS

#: launches of the CUDA kernel, both entries (reset before a run, read
#: after it)
launches = _build.LaunchCounter()

#: kernels compiled into csrc/limb_gemm.cu, in the order of its dispatch:
#: (L, wg, tq, ks) = at most L digits a side, wg consumer warpgroups (64
#: rows each on wgmma's M), tq columns on wgmma's n, ks k32 steps a K
#: stage.  The accumulators are (2L - 1) planes of tq / 2 registers.
CONFIGS = ((1, 2, 8, 4), (1, 2, 32, 4), (2, 2, 8, 4), (2, 2, 32, 4),
           (3, 2, 8, 4), (3, 2, 32, 4), (5, 2, 8, 4), (5, 2, 16, 4),
           (5, 1, 16, 2))
#: digit caps of the kernels: an operand's digits are rounded up to one
DIGIT_CAPS = (1, 2, 3, 5)
#: (bm, bn, bk) output tiles the kernels compute, in the output's
#: orientation: (64 wg, tq, 32 ks) with A's rows on wgmma's M, or (tq,
#: 64 wg, 32 ks) with A's rows on its n (``swap``, for M < 64)
TILES = tuple(sorted({t for L, wg, tq, ks in CONFIGS
                      for t in ((64 * wg, tq, 32 * ks),
                                (tq, 64 * wg, 32 * ks))}))
#: CTAs the K-split clusters may fill at once: two an SM, less an eighth
CLUSTER_SLOTS = 2 * NUM_SMS * 7 // 8
#: longest K: every plane of every K split must stay exact in int32
MAX_K = 1 << 17
#: largest dynamic shared memory a block can ask for
MAX_SMEM = 232_448
#: bytes of a digit row: 128 k, one 128-byte swizzle span
ROW = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"limb_gemm_launch": ([_I] * 10 + [_P] * 4 + [_I] * 17 + [_P],
                                    _I)}
_INT_TYPES = (torch.int8, torch.int16, torch.int32)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class LimbPlan:
    """One launch of K4: the compiled kernel ``config`` (L, wg, tq, ks),
    whether A's rows sit on wgmma's n (``swap``), the grid (P tiles, Q
    tiles, ranks) -- P is wgmma's M side (A's rows, or B's columns when
    swapped), Q its n side; ``ranks`` CTAs of one cluster split a tile's
    K stages in consecutive runs and sum in rank order -- the depth of
    the raw-operand ring and the shared-memory layout."""

    config: tuple[int, int, int, int]
    swap: bool
    grid: tuple[int, int, int]
    a_digits: int
    b_digits: int
    stages: int
    qs: int         # tq sub-tiles a CTA walks (K one stage, no split)
    ra_row: int     # bytes of one A row of a ring stage
    rb_row: int     # bytes of one B row (k) of a ring stage
    raw_a: int      # A bytes of a ring stage (B follows); 0: A's limbs
                    # are copied straight into the digit planes
    stage: int      # bytes of a ring stage
    off_raw: int    # the ring's offset; the digit planes are at 0
    smem: int       # dynamic shared memory of a CTA, alignment slack in

    @property
    def tile(self) -> tuple[int, int, int]:
        """(bm, bn, bk) in the output's orientation."""
        L, wg, tq, ks = self.config
        return ((tq, 64 * wg, 32 * ks) if self.swap
                else (64 * wg, tq, 32 * ks))

    @property
    def ranks(self) -> int:
        return self.grid[2]

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def acc_registers(self) -> int:
        """Accumulator registers a consumer thread holds: 2L - 1 planes
        of tq / 2."""
        L, _, tq, _ = self.config
        return (2 * L - 1) * tq // 2

    def k_split(self, K: int) -> int:
        """The most K one rank sums."""
        bk = 32 * self.config[3]
        nk = _ceil(K, bk)
        return _ceil(nk, self.ranks) * bk


def digits_for(dtype_bits: int, n_limbs: int, K: int) -> int:
    """Digits the fused entry cuts from an operand stored in
    ``dtype_bits`` and decomposed into ``n_limbs`` digits, in a product
    of depth ``K``: ``n_limbs``, except that an int8 value that two or
    more digits hold exactly is its own single digit -- one product where
    there were four, the same sum -- while K < 2^17.  Such a product
    reaches 2^14 ((-128)^2), so 2^17 of them could reach 2^31, past int32;
    the balanced digits' products stay below that at any K <= 2^17."""
    return 1 if dtype_bits == 8 and n_limbs >= 2 and K < MAX_K else n_limbs


def tiles_for(digits: int) -> tuple[tuple[int, int, int], ...]:
    """The (bm, bn, bk) of :data:`TILES` whose kernel holds ``digits``
    digits a side (the kernels of the smallest cap that does)."""
    L = next(c for c in DIGIT_CAPS if c >= digits)
    return tuple(sorted({t for c in CONFIGS if c[0] == L
                         for t in ((64 * c[1], c[2], 32 * c[3]),
                                   (c[2], 64 * c[1], 32 * c[3]))}))


def _config(L: int, qlen: int, K: int) -> tuple[int, int, int, int]:
    if L == 5 and qlen > 8 and K <= 64:
        return (5, 1, 16, 2)
    return next(c for c in CONFIGS if c[0] == L and c[3] == 4
                and (c[2] == 8) == (qlen <= 8))


@functools.lru_cache(maxsize=1024)
def limb_plan(M: int, N: int, K: int, a_digits: int, b_digits: int,
              a_bytes: int = 1, b_bytes: int = 1, *, limbs: bool = False,
              blocks: tuple[int, int, int] | None = None,
              fused: bool = True, ranks: int | None = None,
              qs: int | None = None, stages: int | None = None) -> LimbPlan:
    """The launch of K4 for an (M, K) x (K, N) product whose operands
    give ``a_digits`` and ``b_digits`` digits, stored in ``a_bytes`` and
    ``b_bytes`` a value (``limbs``: the operands are int8 limb planes,
    one digit each).  From the shapes alone:

      * the digit cap L, the smallest of :data:`DIGIT_CAPS` that holds
        both sides (missing digits are zero planes);
      * ``swap`` when M < 64 and N > M: B's columns take wgmma's 64-row
        side, A's rows its n;
      * the widest n of L's kernels (8 when that side is at most 8), and
        for L = 5 with K <= 64 the 64-row, 64-deep kernel (more CTAs an
        SM);
      * where the tiles leave SMs idle, the K stages split over up to 8
        cluster ranks, filling :data:`CLUSTER_SLOTS`; where K is one
        stage and the tiles are many, ``qs`` (4 or 2) n sub-tiles a CTA,
        whose digits are cut once for all of them, as long as the CTAs
        still cover the SMs;
      * the ring as deep as shared memory allows, at most 4 stages.

    ``blocks`` forces one of :data:`TILES` (it must be one of L's
    kernels); any other value raises.  ``ranks``, ``qs`` and ``stages``
    force the K split, the sub-tiles and the ring's depth (tests and tile
    sweeps)."""
    if min(M, N, K) <= 0 or not 1 <= max(a_digits, b_digits) <= 5:
        raise ValueError(f"limb GEMM {(M, N, K)} with {a_digits} and "
                         f"{b_digits} digits: empty, or more than 5 digits")
    if K > MAX_K:
        raise ValueError(f"K = {K} > 2^17: the int32 planes would not be "
                         f"exact")
    L = next(c for c in DIGIT_CAPS if c >= max(a_digits, b_digits))
    if blocks is None:
        swap = M < 64 and N > M
        cfg = _config(L, M if swap else N, K)
    else:
        blocks = tuple(blocks)
        found = [(c, sw) for c in CONFIGS if c[0] == L for sw in (False, True)
                 if blocks == ((c[2], 64 * c[1], 32 * c[3]) if sw
                               else (64 * c[1], c[2], 32 * c[3]))]
        if not found:
            raise ValueError(f"blocks {blocks} is not a limb GEMM tile for "
                             f"{L} digits; tiles are {tiles_for(L)}")
        cfg, swap = found[0]
    _, wg, tq, ks = cfg
    tp, bk = 64 * wg, 32 * ks
    plen, qlen = (N, M) if swap else (M, N)
    nk = _ceil(K, bk)
    ptiles = _ceil(plen, tp)
    auto_ranks, auto_qs = 1, 1
    if ptiles * _ceil(qlen, tq) < NUM_SMS:
        # two CTAs an SM, less an eighth: a cluster's CTAs must share one
        # GPC, and whole clusters of 8 do not pack the GPCs' SMs (one wave
        # of 7-rank clusters at alexnet.fc6 against two waves of 8)
        auto_ranks = max(1, min(MAX_CLUSTER, nk,
                                CLUSTER_SLOTS // (ptiles * _ceil(qlen, tq))))
    elif nk == 1:
        # one K stage: a CTA keeps its digits and walks qs sub-tiles, so
        # the P side is cut into digits once per qs tiles, while the tiles
        # still cover the SMs
        auto_qs = next(q for q in (4, 2, 1) if q == 1 or (
            q <= _ceil(qlen, tq) and ptiles * _ceil(qlen, q * tq) >= NUM_SMS))
    # four full-range digit pairs on plane 3 reach 2^31 in one CTA's
    # int32 plane at K = 2^17: the fused entry, which adds its ranks'
    # sums in 64-bit, needs two ranks there to stay exact
    wide = fused and not limbs and min(a_digits, b_digits) >= 4 \
        and K >= MAX_K
    if wide:
        auto_ranks, auto_qs = max(auto_ranks, 2), 1
    ranks = auto_ranks if ranks is None else ranks
    qs = auto_qs if qs is None else qs
    if not 1 <= ranks <= min(MAX_CLUSTER, nk) or qs not in (1, 2, 4) \
            or (qs > 1 and (nk > 1 or ranks > 1)):
        raise ValueError(f"limb GEMM {(M, N, K)}: {ranks} ranks and {qs} "
                         f"sub-tiles do not fit {nk} K stages")
    if wide and ranks < 2:
        raise ValueError(f"limb GEMM {(M, N, K)} with {a_digits} and "
                         f"{b_digits} digits in one rank: a plane would "
                         f"reach 2^31")
    rows_a, cols_b = (qs * tq, tp) if swap else (tp, qs * tq)
    a_planes = a_digits if limbs else 1
    b_planes = b_digits if limbs else 1
    ra_row = bk * a_bytes
    rb_row = max(16, cols_b * b_bytes)
    # slots in 1024-byte multiples: a TMA box with the 128-byte swizzle
    # lands on 1024-byte boundaries.  One stage of limbs: A's go straight
    # into the digit planes, no slot
    raw_a = 0 if limbs and nk == 1 else \
        _ceil(a_planes * rows_a * ra_row, 1024) * 1024
    stage = raw_a + _ceil(b_planes * bk * rb_row, 1024) * 1024
    off_raw = L * (tp + qs * tq) * ROW
    threads = 128 * wg
    scratch = 0
    if ranks > 1:
        scratch = (threads * tq // 2 * 8 if fused
                   else (2 * L - 1) * threads * tq // 2 * 4)
    per_rank = _ceil(nk, ranks)
    # after the ring, where B's stage may come by TMA (int8 B, 128 of its
    # columns a 128-byte row): one 8-byte mbarrier a slot
    bars = 64 if (swap and wg == 2 and ks == 4 and b_bytes == 1
                  and N % 16 == 0) else 0
    if stages is None:
        stages = next((s for s in range(min(4, per_rank), 1, -1)
                       if 1024 + max(off_raw + s * stage + bars, scratch)
                       <= MAX_SMEM), 1)
    elif not 1 <= stages <= 4:
        raise ValueError(f"{stages} ring stages: 1 to 4")
    smem = 1024 + max(off_raw + stages * stage + bars, scratch)
    if smem > MAX_SMEM:
        raise ValueError(f"limb GEMM {(M, N, K)}: {smem} bytes of shared "
                         f"memory for one stage")
    return LimbPlan(cfg, swap, (ptiles, _ceil(qlen, qs * tq), ranks),
                    a_digits, b_digits, stages, qs, ra_row, rb_row, raw_a,
                    stage, off_raw, smem)


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


def _diagonal_sums64(a_limbs: torch.Tensor, b_limbs: torch.Tensor
                     ) -> torch.Tensor:
    """S_d = sum_{i+j=d} A_i @ B_j as (la+lb-1, M, N) int64, exact.  The
    la*lb limb products are taken in float64: every partial sum is an
    integer of magnitude at most 2^31 for K <= 2^17, far inside float64's
    2^53, on either device (PyTorch has no integer matmul on CUDA)."""
    la, lb = a_limbs.shape[0], b_limbs.shape[0]
    a64, b64 = a_limbs.double(), b_limbs.double()
    out = a64.new_zeros((la + lb - 1, a_limbs.shape[1], b_limbs.shape[2]))
    for i in range(la):
        for j in range(lb):
            out[i + j] += a64[i] @ b64[j]
    return out.to(torch.int64)


def limb_gemm_diagonals_ref(a_limbs: torch.Tensor, b_limbs: torch.Tensor
                            ) -> torch.Tensor:
    """Plain version: S_d = sum_{i+j=d} A_i @ B_j as (la+lb-1, M, N)
    int32.  Exact for K < 2^17; at K = 2^17 a sum of four full-range
    digit pairs a k can reach 2^31 and wraps to -2^31, as the kernel's
    (and the reference's) int32 planes do -- ``limb_matmul`` does not go
    through these planes."""
    return _diagonal_sums64(a_limbs, b_limbs).to(torch.int32)


def limb_matmul_fused_ref(a: torch.Tensor, b: torch.Tensor, nla: int,
                          nlb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused entry: the composition it replaces,
    ``combine_diagonals(limb_gemm_diagonals_ref(limb_decompose(a, nla),
    limb_decompose(b, nlb)))``, with the planes folded in int64 so that
    a plane of 2^31 (K = 2^17) stays exact -- values wider than their
    digits lose the remainder, as the decomposition drops it."""
    return combine_wide_diagonals(
        _diagonal_sums64(limb_decompose(a, nla, LIMB_BITS),
                         limb_decompose(b, nlb, LIMB_BITS)),
        LIMB_BITS)


def _check_pair(a: torch.Tensor, b: torch.Tensor, what: str,
                ndim: int) -> None:
    if a.dim() != ndim or b.dim() != ndim or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"{what} needs a ({'la, ' if ndim == 3 else ''}M, "
                         f"K) and b ({'lb, ' if ndim == 3 else ''}K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"{what}: operands on several devices: "
                         f"{a.device}, {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {a.device}")


def _launch(plan: LimbPlan, a: torch.Tensor, b: torch.Tensor,
            out0: torch.Tensor, out1: torch.Tensor | None, *, fused: bool,
            nplanes: int, a_digits: int, b_digits: int, a_ident: bool,
            b_ident: bool, limbs: bool) -> None:
    L, wg, tq, ks = plan.config
    M, K = a.shape[-2], a.shape[-1]
    N = b.shape[-1]
    lib = _build.load("limb_gemm", _SIGNATURES)
    rc = lib.limb_gemm_launch(
        L, wg, tq, ks, plan.ranks, plan.stages, plan.qs, int(plan.swap),
        int(fused),
        nplanes, a.data_ptr(), b.data_ptr(), out0.data_ptr(),
        0 if out1 is None else out1.data_ptr(), M, N, K,
        a.element_size(), a.shape[0] if limbs else 1,
        1 if limbs else a_digits, int(a_ident),
        b.element_size(), b.shape[0] if limbs else 1,
        1 if limbs else b_digits, int(b_ident),
        plan.ra_row, plan.rb_row, plan.raw_a, plan.stage, plan.off_raw,
        plan.smem, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check_launch(rc, f"limb_gemm {plan.config} {(M, N, K)}")
    launches.count += 1


def limb_gemm_diagonals(a_limbs: torch.Tensor, b_limbs: torch.Tensor, *,
                        blocks: tuple[int, int, int] | None = None
                        ) -> torch.Tensor:
    """Anti-diagonal sums of the limb GEMM: a_limbs (la, M, K) int8,
    b_limbs (lb, K, N) int8 -> (la+lb-1, M, N) int32; on CUDA tensors the
    kernel's planes entry (at most 5 limbs a side, contiguous, ``blocks``
    one of :data:`TILES`, default :func:`limb_plan`'s), the plain version
    on CPU tensors."""
    _check_pair(a_limbs, b_limbs, "limb_gemm_diagonals", 3)
    if a_limbs.dtype != torch.int8 or b_limbs.dtype != torch.int8:
        raise TypeError(f"limb_gemm_diagonals takes int8 limbs, got "
                        f"{a_limbs.dtype} and {b_limbs.dtype}")
    if a_limbs.device.type == "cpu":
        return limb_gemm_diagonals_ref(a_limbs, b_limbs)
    la, M, K = a_limbs.shape
    lb, _, N = b_limbs.shape
    if not (a_limbs.is_contiguous() and b_limbs.is_contiguous()):
        raise ValueError("limb_gemm_diagonals needs contiguous limbs")
    plan = limb_plan(M, N, K, la, lb, limbs=True, fused=False,
                     blocks=None if blocks is None else tuple(blocks))
    out = torch.empty((la + lb - 1, M, N), dtype=torch.int32,
                      device=a_limbs.device)
    _launch(plan, a_limbs, b_limbs, out, None, fused=False,
            nplanes=la + lb - 1, a_digits=la, b_digits=lb, a_ident=True,
            b_ident=True, limbs=True)
    return out


def limb_matmul_fused(a: torch.Tensor, b: torch.Tensor, nla: int, nlb: int,
                      *, blocks: tuple[int, int, int] | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(a @ b) mod 2^64 as (hi, lo) int32 (M, N), each operand cut into
    ``nla`` / ``nlb`` balanced base-128 digits: a (M, K) and b (K, N)
    int8, int16 or int32, each its own type.  On CUDA tensors one launch
    of the kernel's fused entry (contiguous operands; ``blocks`` one of
    :data:`TILES`), on CPU tensors :func:`limb_matmul_fused_ref`; equal
    to it bit for bit."""
    _check_pair(a, b, "limb_matmul_fused", 2)
    if a.dtype not in _INT_TYPES or b.dtype not in _INT_TYPES:
        raise TypeError(f"limb_matmul_fused takes int8, int16 or int32, got "
                        f"{a.dtype} and {b.dtype}")
    M, K = a.shape
    N = b.shape[1]
    da = digits_for(a.element_size() * 8, nla, K)
    db = digits_for(b.element_size() * 8, nlb, K)
    if a.device.type == "cpu":
        if blocks is not None:               # the same check as the card's
            limb_plan(M, N, K, da, db, a.element_size(), b.element_size(),
                      blocks=tuple(blocks))
        return limb_matmul_fused_ref(a, b, nla, nlb)
    plan = limb_plan(M, N, K, da, db, a.element_size(), b.element_size(),
                     blocks=None if blocks is None else tuple(blocks))
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("limb_matmul_fused needs contiguous operands")
    hi = torch.empty((M, N), dtype=torch.int32, device=a.device)
    lo = torch.empty((M, N), dtype=torch.int32, device=a.device)
    _launch(plan, a, b, hi, lo, fused=True, nplanes=0, a_digits=da,
            b_digits=db, a_ident=da < nla, b_ident=db < nlb, limbs=False)
    return hi, lo
